"""Time kernels A and B and encode_step of the dct_tpu_torch package under
ROOT on one NVIDIA GPU.

    python3 time_encode.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example the parent of a
change unpacked beside it); its package is imported in a process of its
own and builds its own kernels. For each ROOT in the order given (name a
root twice to take turns, e.g. parent, change, change, parent) it prints
one JSON line: the card's name and power limit, and in milliseconds by CUDA
events (20 calls after warm-up, as chip_smoke.py times them), each keyed
by config:
  - kernel B on 8 frames of 1088x1920 "photo" (seeds 0-7) at static q50
    8x8 (the batch of encode_step), and at the other configs chip_smoke.py
    phase 3 times: 20 calls (b_ms) and the card's work alone
    (b_device_ms: a spin kernel queued first, so the host's enqueue stays
    outside the events), and at static q50 the host's enqueue cost a call
    (host clock around the calls queued behind it);
  - kernel B reading the batch's planes themselves (the route encode_step
    takes) at the same configs, the same three times (b_plane_*; null for
    a tree without that route);
  - kernel A (the encode transform) on the same frames at the configs of
    A_CONFIGS, its card work alone at each, its coefficients rescued by
    the float32 chain a call, and at static q50 its host enqueue cost;
  - encode_step on the batch at the configs of STEP_CONFIGS: 20 calls, the
    card's work alone and the host's enqueue a call.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

FRAMES, H, W = 8, 1088, 1920

CONFIGS = {  # name: CodecConfig keywords (chip_smoke.py phase 3's)
    "n8 static q50": dict(quality=50, static_tables=True),
    "n8 dynamic q50": dict(quality=50),
    "n8 adaptive+dc+coded_runs": dict(quality=50, adaptive=True,
                                      dc_prediction=True, coded_runs=True),
    "n4 category dynamic": dict(block_size=4),
    "n4 direct": dict(block_size=4, huffman_mode="direct"),
    "n4 none": dict(block_size=4, use_huffman=False),
    "n8 direct q90": dict(quality=90, huffman_mode="direct"),
    "n8 none": dict(use_huffman=False),
    "n8 direct adaptive+dc+coded_runs": dict(
        quality=50, huffman_mode="direct", adaptive=True, dc_prediction=True,
        coded_runs=True),
    "n16 category q90": dict(block_size=16, quality=90),
    "n16 direct": dict(block_size=16, huffman_mode="direct"),
    "n16 none": dict(block_size=16, use_huffman=False),
}


A_CONFIGS = {  # name: CodecConfig keywords (chip_smoke.py phase 1's and more)
    "n8 static q50": dict(quality=50, static_tables=True),
    "n8 static q100": dict(quality=100, static_tables=True),
    "n8 adaptive q50": dict(quality=50, adaptive=True),
    "n4 q50": dict(block_size=4, quality=50),
    "n16 adaptive q50": dict(block_size=16, quality=50, adaptive=True),
}


STEP_CONFIGS = {  # name: CodecConfig keywords of encode_step (static)
    "n8 static q50": dict(quality=50),
    "n4 static q50": dict(block_size=4, quality=50),
    "n16 static q50": dict(block_size=16, quality=50),
    "n8 static adaptive q50": dict(quality=50, adaptive=True),
}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> tuple[float, float]:
    """(the card's work a call, the host's enqueue a call) in ms: the calls
    are queued behind a spin kernel, so the events time the card alone and
    the host clock around the loop times the enqueue alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def run(root: str) -> dict:
    """Time the package under root in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from dct_tpu_torch import CodecConfig, tables
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import _build, blocks, fused_encode_cuda
    from dct_tpu_torch.ops import transform, transform_cuda
    from dct_tpu_torch.utils import image_io

    if not _build.__file__.startswith(root.rstrip("/") + "/"):
        raise RuntimeError(f"{root} holds no dct_tpu_torch package: imported "
                           f"{_build.__file__}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    frames = np.stack([image_io.synthetic_image(H, W, "photo", seed=s)
                       for s in range(FRAMES)])
    frames_d = torch.from_numpy(frames).to(dev)
    out = {"root": root, "card": smi, "build_s": round(build_s, 1)}
    for key in ("b_ms", "b_device_ms", "b_plane_ms", "b_plane_device_ms"):
        out[key] = {}
    route = getattr(fused_encode_cuda, "encode_plane_stripes_fused", None)
    px_of = {}
    for name, kw in CONFIGS.items():
        cfg = CodecConfig(**kw)
        n = cfg.block_size
        if n not in px_of:
            px_of[n] = blocks.image_to_blocks(frames_d, n).reshape(-1, n * n)
        px, ns = px_of[n], FRAMES * H // n
        _, scale = codec._adaptive(px, cfg)
        # B's adaptive operand in the tree's form: the reciprocal where its
        # entries take only that, else the scale
        b_kw = {}
        if scale is not None:
            b_kw = ({"adaptive_recip": transform.reciprocal_scale(scale)}
                    if "adaptive_recip" in inspect.signature(
                        fused_encode_cuda.encode_stripes_fused).parameters
                    else {"adaptive_scale": scale})
        ops = tables.build(cfg, device=dev)
        if not cfg.static_tables:  # the batch's own tables, as the codec does
            _, _, hist, run_hist = codec.encode_analyze(frames_d, cfg, ops)
            ops = ops.with_tables(
                codec._build_table(cfg, hist.cpu().numpy()),
                codec._build_run_table(cfg, run_hist.cpu().numpy()))

        def call():
            fused_encode_cuda.encode_stripes_fused(px, cfg, ns, ops, **b_kw)

        def call_plane():
            route(frames_d, cfg, ns, ops, **b_kw)

        out["b_ms"][name] = round(cuda_ms(call), 4)
        card, host = device_ms(call)
        out["b_device_ms"][name] = round(card, 4)
        if name == "n8 static q50":
            out["b_enqueue_ms"] = round(host, 4)
        out["b_plane_ms"][name] = out["b_plane_device_ms"][name] = None
        if route is not None:
            out["b_plane_ms"][name] = round(cuda_ms(call_plane), 4)
            card, host = device_ms(call_plane)
            out["b_plane_device_ms"][name] = round(card, 4)
            if name == "n8 static q50":
                out["b_plane_enqueue_ms"] = round(host, 4)
    out["a_ms"], out["a_device_ms"], out["a_rescued"] = {}, {}, {}
    for name, kw in A_CONFIGS.items():
        cfg = CodecConfig(**kw)
        n = cfg.block_size
        if n not in px_of:
            px_of[n] = blocks.image_to_blocks(frames_d, n).reshape(-1, n * n)
        px = px_of[n]
        _, scale = codec._adaptive(px, cfg)
        ops = tables.build(cfg, device=dev)

        def call_a():
            transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)

        _build.reset_rescued()
        call_a()
        out["a_rescued"][name] = _build.rescued("encode_blocks")
        out["a_ms"][name] = round(cuda_ms(call_a), 4)
        card, host = device_ms(call_a)
        out["a_device_ms"][name] = round(card, 4)
        if name == "n8 static q50":
            out["a_enqueue_ms"] = round(host, 4)
    for key in ("encode_step_ms", "encode_step_device_ms",
                "encode_step_enqueue_ms"):
        out[key] = {}
    for name, kw in STEP_CONFIGS.items():
        cfg = CodecConfig(static_tables=True, use_pallas=True, **kw)

        def step():
            codec.encode_step(frames_d, cfg, H // cfg.block_size)

        out["encode_step_ms"][name] = round(cuda_ms(step), 4)
        card, host = device_ms(step)
        out["encode_step_device_ms"][name] = round(card, 4)
        out["encode_step_enqueue_ms"][name] = round(host, 4)
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        import torch

        if not torch.cuda.is_available():
            print("time_encode: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(run(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        rc = subprocess.run([sys.executable, __file__, "--one", root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
