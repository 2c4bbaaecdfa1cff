"""Smoke run of the PyTorch/CUDA port (dct_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds the port's kernels from csrc/ into build/torch_kernels/,
then:

  1. kernel A (encode transform) against its plain version on 8 frames of
     1088 x 1920, adaptive quantization off and on;
  2. kernel C (decode transform) against its plain version on those
     coefficients;
  3. kernel B (fused stripe encode) against the plain staged pipeline fed
     kernel A's integers — exactly equal units, stripe bits and block bits
     — at static q50, dynamic-table q50, and adaptive + DC prediction +
     coded runs;
  4. the main path: ImageCodec(cfg, device="cuda") encodes a 1080p frame
     at static and at dynamic tables, decodes it (decode and
     decode_to_device), and encode_step encodes the 8-frame batch, with
     the kernels' launch counters zeroed before and read after. The
     containers must equal the CPU path's byte for byte, or differ only
     in tie coefficients; pixels must agree within 1;
  5. times of each kernel and its plain version at those shapes (CUDA
     events), end-to-end encode_step and decode rates.

A and C may differ from their plain versions only at ties: at most 1
apart, where the float64 value lies within 1e-6 (encode) or 1e-3 (decode)
of a .5 boundary (the two sum float32 products in different orders;
dct_tpu_torch.testing). Any failed check raises.
The last line is the JSON status; the line before it the kernel table, and
the one before that the card's name and power limit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

FRAMES, H, W = 8, 1088, 1920  # 1080p on the 8-px grid: 136 x 240 blocks


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
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


def host_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the host clock (fn synchronises)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def tie_check(name, got, want, values_of, tol):
    """got/want: equal-shape (B, n2) tensors; values_of(block_idx) gives
    the float64 values of those blocks. Returns (mismatches, max |diff|)."""
    import torch
    from dct_tpu_torch import testing

    diff = got.to(torch.int32) - want.to(torch.int32)
    blocks = diff.ne(0).any(dim=1).nonzero().flatten().cpu().numpy()
    max_err = int(diff.abs().max().item())
    n_mis = n_bad = 0
    if blocks.size:
        n_mis, n_bad = testing.tie_mismatches(
            got[blocks].cpu().numpy(), want[blocks].cpu().numpy(),
            values_of(blocks), tol)
    log(f"{name}: {n_mis} mismatches of {got.numel()} ({n_bad} non-ties), "
        f"max |diff| {max_err}")
    check(n_bad == 0, f"{name}: non-tie mismatches")
    return n_mis, max_err


def coefficients(data: bytes, cfg):
    """Entropy-decoded (NB, 64) zigzag coefficients of a gray container."""
    from dct_tpu_torch.models import codec

    p = codec.cont.deserialize(data).planes[0]
    bh, bw, n_stripes = codec._padded_grid(p.height, p.width, cfg)
    zz = codec._decode_stripes(
        p, cfg, codec.hf.CanonicalTable(p.table_lengths), "category",
        n_stripes, bh // n_stripes * bw)
    return codec.dc_reconstruct(zz, n_stripes) if cfg.dc_prediction else zz


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from dct_tpu_torch import CodecConfig, tables, testing
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import _build, blocks, bitstream as bs, rle
    from dct_tpu_torch.ops import fused_encode_cuda, transform, transform_cuda
    from dct_tpu_torch.utils import image_io

    # The plain versions run on the card here, as the kernels' references:
    # their float32 products must not drop to TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build_s {time.perf_counter() - t0:.2f} (built: "
        f"{', '.join(logs) or 'cached'})")
    for name, text in logs.items():  # ptxas -v: registers, spills
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", text))
        log(f"  {name}: {len(regs)} kernels, registers <= {max(regs)}, "
            f"spill bytes {spills}")

    static = CodecConfig(quality=50, static_tables=True, use_pallas=True)
    dynamic = CodecConfig(quality=50)
    rich = CodecConfig(quality=50, adaptive=True, dc_prediction=True,
                       coded_runs=True)
    n_stripes = H // 8
    frames = np.stack([image_io.synthetic_image(H, W, "photo", seed=s)
                       for s in range(FRAMES)])
    frames_d = torch.from_numpy(frames).to(dev)
    frame = image_io.synthetic_image(1080, 1920, "photo", seed=7)

    # ---- 4. the main path, counted -------------------------------------
    _build.reset_launch_counts()
    containers, recs = {}, {}
    for name, cfg in (("static", static), ("dynamic", dynamic)):
        gpu = codec.ImageCodec(cfg, device=dev)
        containers[name] = gpu.encode(frame)
        recs[name] = (gpu.decode(containers[name]),
                      gpu.decode_to_device(containers[name]))
    packed, _, _ = codec.encode_step(frames_d, static, n_stripes)
    batch_bits = packed.bit_lengths.sum().item()  # waits for the batch
    launches = dict(_build.LAUNCHES)
    log(f"main path launches {launches}; batch payload {batch_bits} bits")
    for k in ("encode_blocks", "encode_stripes", "decode_blocks"):
        check(launches[k] > 0, f"{k} not launched on the main path")

    log(f"host entropy decoder: {codec.host_decoder()}")
    for name, cfg in (("static", static), ("dynamic", dynamic)):
        data = containers[name]
        cpu_data = codec.ImageCodec(cfg, device="cpu").encode(frame)
        same = data == cpu_data
        log(f"e2e {name}: {len(data)} B, container v"
            f"{data[4]}, equal to CPU path: {same}")
        if not same:  # every differing coefficient must be a tie
            zz = [coefficients(c, cfg) for c in (data, cpu_data)]
            px = blocks.image_to_blocks(codec.pad_plane_for_encode(
                torch.from_numpy(frame), cfg), 8).numpy()
            tie_check(f"e2e {name} coefficients", torch.from_numpy(zz[0]),
                      torch.from_numpy(zz[1]),
                      lambda b: testing.encode_values_f64(px[b], cfg),
                      testing.ENCODE_TIE_TOL)
        ref = codec.ImageCodec(cfg, device="cpu").decode(data)
        rec, rec_d = recs[name]
        check(rec_d.device.type == "cuda", "decode_to_device left the card")
        check(np.array_equal(rec, rec_d.cpu().numpy()),
              "decode and decode_to_device disagree")
        err = int(np.abs(rec.astype(int) - ref).max())
        mse = float(np.mean((rec.astype(np.float64) - frame) ** 2))
        log(f"e2e {name}: decode max |diff| vs CPU {err}, PSNR "
            f"{10 * np.log10(255.0 ** 2 / mse):.2f} dB")
        check(err <= 1, f"e2e {name}: decoded pixels differ by {err}")

    # ---- 1-3. kernels against their plain versions at 8 x 1080p --------
    px = blocks.image_to_blocks(frames_d, 8).reshape(-1, 64)
    px_h = px.cpu().numpy()
    results = {}
    zz_main = None
    for cfg in (static, rich):
        ops = tables.build(cfg, device=dev)
        _, scale = codec._adaptive(px, cfg)
        recip = None if scale is None else transform.reciprocal_scale(scale)
        recip_h = None if recip is None else recip.cpu().numpy()
        got = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
        want = transform.encode_blocks(px, cfg, ops, scale)
        res_a = tie_check(
            f"A adaptive={cfg.adaptive}", got, want,
            lambda b: testing.encode_values_f64(
                px_h[b], cfg, None if recip_h is None else recip_h[b]),
            testing.ENCODE_TIE_TOL)
        dec = transform_cuda.decode_blocks_kernel(got, cfg, ops, scale)
        dref = transform.decode_blocks(got, cfg, ops, scale)
        zz_h = got.cpu().numpy()
        scale_h = None if scale is None else scale.cpu().numpy()
        res_c = tie_check(
            f"C adaptive={cfg.adaptive}", dec, dref,
            lambda b: testing.decode_values_f64(
                zz_h[b], cfg, None if scale_h is None else scale_h[b]),
            testing.DECODE_TIE_TOL)
        if cfg is static:
            results["encode_blocks"], results["decode_blocks"] = res_a, res_c
            zz_main = got
    s_all = FRAMES * n_stripes
    for name, cfg in (("static", static), ("dynamic", dynamic),
                      ("adaptive+dc+coded_runs", rich)):
        ops = tables.build(cfg, device=dev)
        _, scale = codec._adaptive(px, cfg)
        zz = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
        if cfg.dc_prediction:
            zz = codec.dc_predict(zz, s_all)
        if not cfg.static_tables:  # tables from the batch's histograms
            sym = rle.rle_encode_positional(zz)
            ops = ops.with_tables(
                codec._build_table(cfg, codec.hf.category_histogram_masked(
                    sym.values, sym.is_sym).cpu().numpy()),
                codec._build_run_table(cfg, codec.hf.run_histogram_masked(
                    sym.runs, sym.is_sym).cpu().numpy()))
        got, got_bb = fused_encode_cuda.encode_stripes_fused(
            px, cfg, s_all, ops, scale)
        ref, ref_bb = codec.encode_pack(rle.rle_encode_positional(zz), cfg,
                                        s_all, ops)
        g, r = bs.fetch_packed(got), bs.fetch_packed(ref)
        same = (np.array_equal(g.bit_lengths, r.bit_lengths)
                and np.array_equal(g.units, r.units)
                and torch.equal(got_bb, ref_bb))
        log(f"B {name}: {int(g.bit_lengths.sum())} bits, units/stripe bits/"
            f"block bits equal to the staged pipeline: {same}")
        check(same, f"B {name} differs from the staged pipeline")
        if cfg is static:
            err = int(np.abs(g.units.astype(np.int64) - r.units).max())
            results["encode_stripes"] = (0, err)

    # ---- 5. times --------------------------------------------------------
    ops = tables.build(static, device=dev)
    times = {
        "encode_blocks": (
            cuda_ms(lambda: transform_cuda.encode_blocks_kernel(
                px, static, ops), 20),
            cuda_ms(lambda: transform.encode_blocks(px, static, ops), 20)),
        "encode_stripes": (
            cuda_ms(lambda: fused_encode_cuda.encode_stripes_fused(
                px, static, s_all, ops), 20),
            cuda_ms(lambda: fused_encode_cuda.encode_stripes_plain(
                px, static, s_all, ops), 5)),
        "decode_blocks": (
            cuda_ms(lambda: transform_cuda.decode_blocks_kernel(
                zz_main, static, ops), 20),
            cuda_ms(lambda: transform.decode_blocks(zz_main, static, ops), 20)),
    }
    for k, (ms, plain) in times.items():
        log(f"time {k}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"(8 x {H}x{W})")
    step_ms = cuda_ms(lambda: codec.encode_step(frames_d, static, n_stripes),
                      20)
    log(f"encode_step 8 x {H}x{W} static q50: {step_ms:.4f} ms = "
        f"{FRAMES * H * W / step_ms / 1e3:.1f} Mpix/s")
    gpu = codec.ImageCodec(static, device=dev)
    dec_ms = host_ms(lambda: gpu.decode(containers["static"]), 10)
    dev_ms = host_ms(lambda: (gpu.decode_to_device(containers["static"]),
                              torch.cuda.synchronize()), 10)
    enc_ms = host_ms(lambda: gpu.encode(frame), 10)
    mpx = 1080 * 1920 / 1e3
    log(f"ImageCodec 1080p static q50: encode {enc_ms:.3f} ms "
        f"({mpx / enc_ms:.1f} Mpix/s), decode {dec_ms:.3f} ms "
        f"({mpx / dec_ms:.1f} Mpix/s), decode_to_device {dev_ms:.3f} ms "
        f"({mpx / dev_ms:.1f} Mpix/s)")
    # where one frame's decode and encode go (host clock, synchronised)
    zz1 = coefficients(containers["static"], static)
    zz1_d = torch.from_numpy(zz1).to(dev)
    bh1, bw1, ns1 = codec._padded_grid(*frame.shape, static)
    rec_d = codec.blk.blocks_to_image(transform_cuda.decode_blocks_kernel(
        zz1_d, static, ops), bh1 * 8, bw1 * 8, 8)[:frame.shape[0]]
    px1 = blocks.image_to_blocks(codec.pad_plane_for_encode(
        torch.from_numpy(frame).to(dev), static), 8)
    stages = {
        "parse+entropy decode": host_ms(
            lambda: coefficients(containers["static"], static), 10),
        "upload coefficients": host_ms(
            lambda: (zz1_d.copy_(torch.from_numpy(zz1)),
                     torch.cuda.synchronize()), 10),
        "kernel C": cuda_ms(lambda: transform_cuda.decode_blocks_kernel(
            zz1_d, static, ops), 20),
        "download pixels": host_ms(lambda: rec_d.cpu(), 10),
        "encode kernel B": cuda_ms(lambda: fused_encode_cuda.encode_stripes_fused(
            px1, static, ns1, ops), 20),
    }
    log("1080p stages: " + ", ".join(f"{k} {v:.4f} ms"
                                     for k, v in stages.items()))

    sources = {
        "encode_blocks": ("dct_tpu_torch/csrc/transform.cu",
                          "dct_tpu/ops/transform_pallas.py:106"),
        "encode_stripes": ("dct_tpu_torch/csrc/fused_encode.cu",
                           "dct_tpu/ops/fused_encode_pallas.py:218"),
        "decode_blocks": ("dct_tpu_torch/csrc/transform.cu",
                          "dct_tpu/ops/transform_pallas.py:126"),
    }
    table = [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1], "launches": launches[k],
         "max_abs_err": results[k][1], "ms": round(times[k][0], 4),
         "plain_ms": round(times[k][1], 4)}
        for k in ("encode_blocks", "encode_stripes", "decode_blocks")
    ]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
