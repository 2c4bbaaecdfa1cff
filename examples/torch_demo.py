#!/usr/bin/env python
"""End-to-end tour of the dct_tpu_torch API (the PyTorch/CUDA port).

Runs on the card by default (raising where there is none); ``--device
cpu`` runs every kernel's plain version. The containers are the same
bytes either way, and the JAX package's (examples/demo.py prints the same
numbers). Covers:

  1. one-liner encode/decode (grayscale + RGB)
  2. config knobs (quality, adaptive, static tables, stripe size)
  3. per-stripe recovery: corrupt -> verify -> repair -> byte-identical
  4. random-access region decode
  5. sharded encode over a device mesh (mesh-invariant bytes)
  6. batched video-style encode
  7. rate control

Usage: python examples/torch_demo.py [--device cpu]
       torchrun --nproc-per-node 2 examples/torch_demo.py --device cpu
       (section 5 runs over the ranks, gloo on the CPU, NCCL on cards)
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os as _os
import sys as _sys

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, the card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from dct_tpu_torch.models import codec

    # None takes the card and raises without one, as the entry points do
    device = None if args.device == "cuda" else args.device
    dev = torch.device(device) if device is not None else codec._default_device()
    joined = False
    if not dist.is_initialized() and int(_os.environ.get("WORLD_SIZE", 1)) > 1:
        # launched by torchrun: join its process group (env://)
        if dev.type == "cuda":
            torch.cuda.set_device(int(_os.environ.get("LOCAL_RANK", 0)))
            device = dev = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        joined = True
    world = dist.get_world_size() if dist.is_initialized() else 1
    quiet = world > 1 and dist.get_rank() != 0  # one rank prints
    try:
        with (contextlib.redirect_stdout(io.StringIO()) if quiet
              else contextlib.nullcontext()):
            return _tour(device, dev, world)
    finally:
        if joined:
            dist.destroy_process_group()


def _tour(device, dev, world: int) -> int:
    """Sections 1-7 on ``device`` (None: the card); section 5 over the
    ``world`` ranks of the default process group."""
    import torch

    import dct_tpu_torch
    from dct_tpu_torch.models import codec, recovery
    from dct_tpu_torch.models.video import VideoCodec
    from dct_tpu_torch.utils import image_io, metrics

    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"backend: {dev.type}, devices: {max(n_dev, world)}")

    # -- 1. one-liners ------------------------------------------------------
    gray = image_io.synthetic_image(240, 320, "photo", seed=0)
    data = dct_tpu_torch.encode(gray, device=device)  # q50, gray by rank
    rec = dct_tpu_torch.decode(data, device=device)
    print(f"gray 320x240  -> {len(data):6d} B "
          f"({gray.size / len(data):5.2f}:1)  PSNR {metrics.psnr(gray, rec):5.2f} dB")

    rgb = np.stack([gray, np.roll(gray, 7, 0), np.roll(gray, 13, 1)], -1)
    data = dct_tpu_torch.encode(
        rgb, dct_tpu_torch.CodecConfig(quality=75, chroma="420"), device)
    rec = dct_tpu_torch.decode(data, device=device)
    print(f"rgb  320x240  -> {len(data):6d} B "
          f"({rgb.size / len(data):5.2f}:1)  PSNR {metrics.psnr(rgb, rec):5.2f} dB")

    # -- 2. knobs ------------------------------------------------------------
    for cfg in (
        dct_tpu_torch.CodecConfig(quality=10),
        dct_tpu_torch.CodecConfig(quality=90, adaptive=True),
        dct_tpu_torch.CodecConfig(quality=50, static_tables=True),  # kernel B
        dct_tpu_torch.CodecConfig(quality=50, coded_runs=True),
        dct_tpu_torch.CodecConfig(  # smallest files: coded runs + DC DPCM
            quality=50, coded_runs=True, dc_prediction=True
        ),
    ):
        d = dct_tpu_torch.encode(gray, cfg, device)
        r = dct_tpu_torch.decode(d, device=device)
        print(f"  q={cfg.quality:3d} adaptive={int(cfg.adaptive)} "
              f"static={int(cfg.static_tables)} coded_runs="
              f"{int(cfg.coded_runs)} dc_pred={int(cfg.dc_prediction)}: "
              f"{len(d):6d} B, PSNR {metrics.psnr(gray, r):5.2f} dB")

    # -- 3. recovery ----------------------------------------------------------
    cfg = dct_tpu_torch.CodecConfig(quality=60, static_tables=True)
    pristine = codec.ImageCodec(cfg, device).encode(gray)
    damaged = bytearray(pristine)
    damaged[-30:-22] = b"\xa5" * 8  # clobber part of the last stripe
    bad = recovery.verify(bytes(damaged))
    fixed = recovery.repair(bytes(damaged), gray, device=device)
    print(f"recovery: corrupt stripes {bad} -> repaired == pristine: "
          f"{fixed == pristine}")

    # -- 4. random access ------------------------------------------------------
    band = recovery.decode_region(pristine, 100, 140, device=device)
    full = codec.ImageCodec(cfg, device).decode(pristine)
    print(f"region decode rows [100,140): matches full decode: "
          f"{np.array_equal(band, full[100:140])}")

    # -- 5. sharded encode ------------------------------------------------------
    if world > 1:
        from dct_tpu_torch.parallel import mesh as meshlib
        from dct_tpu_torch.parallel import shard_encode

        mesh = meshlib.make_mesh(n_data=1, n_stripe=world,
                                 device_type=dev.type)
        sharded = shard_encode.encode_image_sharded(gray, cfg, mesh)
        single = codec.ImageCodec(cfg, meshlib.device(mesh)).encode(gray)
        print(f"sharded over {world} devices == single-device "
              f"bytes: {sharded == single}")
    else:
        print("sharded encode: skipped (1 device; tests use an 8-way CPU mesh)")

    # -- 6. video -------------------------------------------------------------
    frames = np.stack([
        image_io.synthetic_image(120, 160, "photo", seed=s) for s in range(4)
    ])
    streams = VideoCodec(dct_tpu_torch.CodecConfig(quality=70),
                         device=device).encode(frames)
    recs = VideoCodec(dct_tpu_torch.CodecConfig(quality=70),
                      device=device).decode(streams)
    print(f"video: 4 frames -> {sum(len(s) for s in streams)} B total, "
          f"PSNR {metrics.psnr(frames, recs):5.2f} dB")

    # -- 7. rate control --------------------------------------------------------
    from dct_tpu_torch.models import rate_control

    budget = 12_000
    capped, q = rate_control.encode_to_size(
        gray, budget, dct_tpu_torch.CodecConfig(adaptive=True), device=device
    )
    rec = dct_tpu_torch.decode(capped, device=device)
    print(f"rate control: <= {budget} B -> quality {q}, {len(capped)} B, "
          f"PSNR {metrics.psnr(gray, rec):5.2f} dB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
