#!/usr/bin/env python
"""Production-serving patterns with dct_tpu_torch (the PyTorch/CUDA port):
the codec as a data-plane component on the card.

Three shapes (examples/serving.py shows them on the JAX package and
prints the same numbers, the ingest rate aside):

  1. ingest   — a stream of frames arriving one at a time, encoded with
                static tables (kernel B: one fused encode launch per
                frame), timed by CUDA events on the card.
  2. feed     — containers decoded straight onto the card
                (decode_to_device: kernels D and C) and consumed by a
                torch.nn.Module under inference_mode, the pixels never
                landing on the host: the decompressed-dataloader pattern
                for training/inference input pipelines.
  3. archive  — a long recorded stack encoded as one chunked batch
                (bounded device memory, batch-global tables), then
                spot-checked with the per-stripe integrity scan.

Usage: python examples/torch_serving.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os as _os
import sys as _sys

_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO not in _sys.path:
    _sys.path.insert(0, _REPO)

import numpy as np
import torch

from dct_tpu_torch import container as cont
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec, recovery
from dct_tpu_torch.models.video import VideoCodec
from dct_tpu_torch.utils import image_io, metrics


def ingest_stream(frames: np.ndarray, device) -> list[bytes]:
    """Frame-at-a-time encode: static tables = one kernel B per frame."""
    cfg = CodecConfig(
        quality=60, static_tables=True, coded_runs=True, dc_prediction=True,
    )
    ic = codec.ImageCodec(cfg, device)
    ic.encode(frames[0])  # warmup: kernels built once, outside the timing
    out = []

    def run():
        for f in frames:
            out.append(ic.encode(f))

    # CUDA events on the card, the host clock on the CPU
    dt = metrics.seconds_per_call(run, 1, ic.device.type == "cuda")
    raw = frames.size
    enc = sum(len(d) for d in out)
    print(f"ingest : {len(out)} frames, {raw / enc:5.2f}:1, "
          f"{raw / dt / 1e6:6.1f} Mpix/s wall")
    return out


class ToyModel(torch.nn.Module):
    """Stand-in for a real network's first layers: per-frame mean and
    population std of the pixels scaled to [0, 1]."""

    def forward(self, batch: torch.Tensor):
        x = batch.to(torch.float32) / 255.0
        return x.mean(dim=(1, 2)), x.std(dim=(1, 2), correction=0)


def feed_model(streams: list[bytes], device) -> None:
    """Decode-to-device feeding a model on the same device: pixels never
    touch the host between the container bytes and the model."""
    vc = VideoCodec(cont.deserialize(streams[0]).config, device=device)
    model = ToyModel().to(vc.device)

    with torch.inference_mode():
        dev_frames = vc.decode_to_device(streams)  # (F, H, W) u8 ON DEVICE
        means, stds = model(dev_frames)
    print(f"feed   : {tuple(dev_frames.shape)} u8 device batch -> model "
          f"stats mean[0]={float(means[0]):.4f} std[0]={float(stds[0]):.4f}")


def archive_batch(frames: np.ndarray, device) -> None:
    """Chunked batch encode of a long recording + integrity spot-check."""
    cfg = CodecConfig(quality=55, coded_runs=True, dc_prediction=True)
    vc = VideoCodec(cfg, device=device)  # chunk size from the pixel budget
    streams = vc.encode(frames)
    total = sum(len(s) for s in streams)
    bad = [i for i, s in enumerate(streams) if recovery.verify(s)]
    rec = vc.decode(streams[:2])
    print(f"archive: {len(streams)} containers, {total / 1e3:.0f} kB, "
          f"corrupt={bad or 'none'}, spot PSNR "
          f"{metrics.psnr(rec, frames[:2]):.2f} dB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, the card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    # None takes the card and raises without one, as the entry points do
    device = None if args.device == "cuda" else args.device
    dev = torch.device(device) if device is not None else codec._default_device()
    print(f"backend: {dev.type}")
    frames = np.stack(
        [image_io.synthetic_image(240, 320, "photo", seed=s) for s in range(8)]
    )
    streams = ingest_stream(frames, device)
    feed_model(streams, device)
    archive_batch(frames, device)
    return 0


if __name__ == "__main__":
    _sys.exit(main())
