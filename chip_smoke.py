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
     events), end-to-end encode_step and decode rates;
  6. the indexed decode (kernel D), the main path of the second slice:
     ImageCodec(CodecConfig(quality=90), device="cuda") encodes the 1080p
     frame to a v2 container (kernels A and B), decodes it (decode and
     decode_to_device: kernels D and C), counted as in 4; the pixels must
     equal the host route's (host decoder, then kernel C) on the same
     container exactly, and the CPU path's within 1;
  7. kernel D against its plain version and the host decoder, bit-exact,
     on the 8-frame batch (1,088 stripes, 261,120 blocks in one launch)
     encoded by kernel B at static q90 and at adaptive + DC prediction +
     coded runs, and on 1080p streams in the modes the card cannot encode
     yet ("none" from the CPU encoder, "direct" packed from kernel A's
     coefficients by the plain packer);
  8. times of D and its plain version at the batch, its bound, and the
     1080p q90 decode on both routes, stage by stage.

A and C may differ from their plain versions only at ties: at most 1
apart, where the float64 value lies within 1e-6 (encode) or 1e-3 (decode)
of a .5 boundary (the two sum float32 products in different orders;
dct_tpu_torch.testing). B and D are held bit-exact. Any failed check
raises. Each kernel's bound is the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and its
operations over the H100's peak for their type (989 TFLOP/s bf16 for A
and B, whose u8 x bf16 products are exact there; 67 TFLOP/s float32 for
C, whose coefficients need float32), computed from this run's inputs.
The last line is the JSON status; the line before it the card's name and
power limit, and the one before that the kernel table.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

FRAMES, H, W = 8, 1088, 1920  # 1080p on the 8-px grid: 136 x 240 blocks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


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


def bound_ms(n_bytes: float, flops: float = 0.0, peak: float = 1.0):
    """(least milliseconds, what bounds them): bytes over the memory rate
    or operations over the peak rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def batch_tables(cfg, px, scale, n_stripes, ops):
    """Per-batch canonical tables from the histograms of kernel A's
    coefficients (static tables: the defaults): (ops, table, run_table)."""
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import huffman as hf
    from dct_tpu_torch.ops import rle, transform_cuda

    if cfg.static_tables:
        return (ops, hf.default_category_table(cfg.quality),
                codec._build_run_table(cfg, None))
    zz = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
    if cfg.dc_prediction:
        zz = codec.dc_predict(zz, n_stripes)
    sym = rle.rle_encode_positional(zz)
    table = codec._build_table(cfg, hf.category_histogram_masked(
        sym.values, sym.is_sym).cpu().numpy())
    run_table = codec._build_run_table(cfg, hf.run_histogram_masked(
        sym.runs, sym.is_sym).cpu().numpy())
    return ops.with_tables(table, run_table), table, run_table


def coefficients(data: bytes, cfg):
    """Entropy-decoded (NB, 64) zigzag coefficients of a gray container."""
    import torch
    from dct_tpu_torch.models import codec

    p = codec.cont.deserialize(data).planes[0]
    bh, bw, n_stripes = codec._padded_grid(p.height, p.width, cfg)
    zz = codec._decode_stripes(
        p, cfg, codec.hf.CanonicalTable(p.table_lengths), "category",
        n_stripes, bh // n_stripes * bw)
    if cfg.dc_prediction:
        zz = codec.dc_reconstruct(torch.from_numpy(zz), n_stripes).numpy()
    return zz


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import dataclasses

    from dct_tpu_torch import CodecConfig, native, tables, testing
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import _build, blocks, bitstream as bs, rle
    from dct_tpu_torch.ops import entropy_decode as ed
    from dct_tpu_torch.ops import entropy_decode_cuda, fused_encode_cuda
    from dct_tpu_torch.ops import transform, transform_cuda
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
        _, scale = codec._adaptive(px, cfg)
        ops, _, _ = batch_tables(cfg, px, scale, s_all,
                                 tables.build(cfg, device=dev))
        zz = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
        if cfg.dc_prediction:
            zz = codec.dc_predict(zz, s_all)
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

    # ---- 6. the indexed decode's main path, counted -------------------
    q90 = CodecConfig(quality=90)
    gpu90 = codec.ImageCodec(q90, device=dev)
    _build.reset_launch_counts()
    data90 = gpu90.encode(frame)
    rec90 = gpu90.decode(data90)
    rec90_d = gpu90.decode_to_device(data90)
    torch.cuda.synchronize()
    launches90 = dict(_build.LAUNCHES)
    log(f"main path q90 launches {launches90}")
    check(data90[4] == 2, f"the q90 1080p container is v{data90[4]}, not v2")
    for k in launches90:
        check(launches90[k] > 0, f"{k} not launched on the q90 main path")
    cpu_data90 = codec.ImageCodec(q90, device="cpu").encode(frame)
    log(f"e2e q90: {len(data90)} B, container v{data90[4]}, equal to CPU "
        f"path: {data90 == cpu_data90}")
    if data90 != cpu_data90:  # every differing coefficient must be a tie
        zz = [coefficients(c, q90) for c in (data90, cpu_data90)]
        px90 = blocks.image_to_blocks(codec.pad_plane_for_encode(
            torch.from_numpy(frame), q90), 8).numpy()
        tie_check("e2e q90 coefficients", torch.from_numpy(zz[0]),
                  torch.from_numpy(zz[1]),
                  lambda b: testing.encode_values_f64(px90[b], q90),
                  testing.ENCODE_TIE_TOL)

    def host_route(data):
        """The same container through the host decoder, then kernel C."""
        c = cont.deserialize(data)
        return codec.decode_plane_device(
            dataclasses.replace(c.planes[0], block_bits=None), c.config, dev)

    host90 = host_route(data90).cpu().numpy()
    check(np.array_equal(rec90, rec90_d.cpu().numpy()),
          "q90 decode and decode_to_device disagree")
    check(np.array_equal(rec90, host90),
          "q90 indexed decode differs from the host route")
    err = int(np.abs(rec90.astype(int)
                     - codec.ImageCodec(q90, device="cpu").decode(data90)).max())
    mse = float(np.mean((rec90.astype(np.float64) - frame) ** 2))
    log(f"e2e q90: pixels equal to the host route's: True; max |diff| vs "
        f"CPU {err}, PSNR {10 * np.log10(255.0 ** 2 / mse):.2f} dB")
    check(err <= 1, f"e2e q90: decoded pixels differ by {err}")

    # ---- 7. kernel D against its plain version and the host decoder ----
    def check_d(name, stripes, bits, table, run_table, mode, n2):
        operands = codec.indexed_operands(stripes, bits, table, run_table,
                                            mode, n2, dev)
        got = entropy_decode_cuda.decode_blocks_kernel(**operands)
        want = ed.decode_blocks_plain(**operands)
        host = native.unpack_stripes(stripes, len(bits) // len(stripes), n2,
                                     mode, table, codec.DIRECT_VMIN,
                                     run_table=run_table)
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        same = torch.equal(got, want)
        same_host = np.array_equal(got.cpu().numpy(), host)
        log(f"D {name}: {len(bits)} blocks, {len(stripes)} stripes, "
            f"{sum(map(len, stripes))} B; equal to plain: {same}, to the "
            f"host decoder: {same_host}")
        check(same and same_host, f"D {name} differs")
        return operands, err

    d_operands = {}
    for name, cfg in (
            ("static q90", CodecConfig(quality=90, static_tables=True,
                                       decode_index=True)),
            ("adaptive+dc+coded_runs", rich.replace(decode_index=True))):
        _, scale = codec._adaptive(px, cfg)
        ops, table, run_table = batch_tables(cfg, px, scale, s_all,
                                             tables.build(cfg, device=dev))
        packed, bb = fused_encode_cuda.encode_stripes_fused(
            px, cfg, s_all, ops, scale)
        d_operands[name] = check_d(
            f"batch {name}", bs.stripes_to_bytes(bs.fetch_packed(packed)),
            bb.cpu().numpy().reshape(-1).astype(np.uint16), table, run_table,
            "category", 64)
    results["entropy_decode"] = (0, d_operands["static q90"][1])
    data_none = codec.ImageCodec(CodecConfig(use_huffman=False,
                                             decode_index=True),
                                 device="cpu").encode(frame)
    p_none = cont.deserialize(data_none).planes[0]
    check_d("1080p none", p_none.stripes, p_none.block_bits, None, None,
            "none", 64)
    direct = CodecConfig(quality=90, huffman_mode="direct", decode_index=True)
    px1 = blocks.image_to_blocks(codec.pad_plane_for_encode(
        torch.from_numpy(frame).to(dev), direct), 8)
    zz_direct = transform_cuda.encode_blocks_kernel(
        px1, direct, tables.build(direct, device=dev))
    check_d("1080p direct", *testing.indexed_stream(
        zz_direct, direct, -(-frame.shape[0] // 8)),
            "direct", 64)

    # ---- 8. times of the indexed decode ---------------------------------
    ops_d = d_operands["static q90"][0]
    times["entropy_decode"] = (
        cuda_ms(lambda: entropy_decode_cuda.decode_blocks_kernel(**ops_d),
                20),
        cuda_ms(lambda: ed.decode_blocks_plain(**ops_d), 3))
    log(f"time entropy_decode: kernel {times['entropy_decode'][0]:.4f} ms, "
        f"plain {times['entropy_decode'][1]:.4f} ms (8 x {H}x{W}, static "
        f"q90, {ops_d['block_start'].numel()} blocks)")
    routes = {
        "decode": host_ms(lambda: gpu90.decode(data90), 10),
        "decode_to_device": host_ms(lambda: (gpu90.decode_to_device(data90),
                                             torch.cuda.synchronize()), 10),
        "host route decode": host_ms(lambda: host_route(data90).cpu(), 10),
        "host route decode_to_device": host_ms(
            lambda: (host_route(data90), torch.cuda.synchronize()), 10),
    }
    log("ImageCodec 1080p q90 (v2): " + ", ".join(
        f"{k} {v:.3f} ms ({mpx / v:.1f} Mpix/s)" for k, v in routes.items()))
    c90 = cont.deserialize(data90)
    p90 = c90.planes[0]
    table90 = codec.hf.CanonicalTable(p90.table_lengths)
    host_in = [np.frombuffer(b"".join(p90.stripes), np.uint8),
               np.asarray(p90.block_bits, np.uint16),
               ed.table_inputs(table90, None, "category", codec.DIRECT_VMIN)]
    ops90 = codec.indexed_operands(p90.stripes, p90.block_bits, table90,
                                     None, "category", 64, dev)
    zz90 = entropy_decode_cuda.decode_blocks_kernel(**ops90)
    zz90_h = coefficients(data90, q90)
    ops_q90 = tables.build(q90, device=dev)
    stages90 = {
        "parse": host_ms(lambda: cont.deserialize(data90), 10),
        "upload payload+index+tables": host_ms(
            lambda: (codec._upload(host_in, dev), torch.cuda.synchronize()),
            10),
        "block starts": cuda_ms(lambda: ed.block_starts(
            ops90["block_bits"].reshape(len(p90.stripes), -1)), 20),
        "kernel D": cuda_ms(lambda: entropy_decode_cuda.decode_blocks_kernel(
            **ops90), 20),
        "kernel C": cuda_ms(lambda: transform_cuda.decode_blocks_kernel(
            zz90, q90, ops_q90), 20),
        "download pixels": host_ms(lambda: rec90_d.cpu(), 10),
        "host route: parse+entropy decode": host_ms(
            lambda: coefficients(data90, q90), 10),
        "host route: upload coefficients": host_ms(
            lambda: (torch.from_numpy(zz90_h).to(dev),
                     torch.cuda.synchronize()), 10),
    }
    log("1080p q90 stages: " + ", ".join(f"{k} {v:.4f} ms"
                                         for k, v in stages90.items()))

    sources = {
        "encode_blocks": ("dct_tpu_torch/csrc/transform.cu",
                          "dct_tpu/ops/transform_pallas.py:106"),
        "encode_stripes": ("dct_tpu_torch/csrc/fused_encode.cu",
                           "dct_tpu/ops/fused_encode_pallas.py:218"),
        "decode_blocks": ("dct_tpu_torch/csrc/transform.cu",
                          "dct_tpu/ops/transform_pallas.py:126"),
        "entropy_decode": ("dct_tpu_torch/csrc/entropy_decode.cu",
                           "dct_tpu/ops/entropy_decode_pallas.py:124"),
    }
    # bounds at the shapes timed above: 8 x 1088x1920, static q50 for A,
    # B, C and static q90 for D; operators and tables count as inputs
    nb = px.shape[0]
    op_bytes = 4 * 128 * 128
    mm_flops = 2 * nb * 64 * 64  # one (NB, 64) x (64, 64) product
    bounds = {
        "encode_blocks": bound_ms(nb * 64 + nb * 64 * 4 + 3 * op_bytes,
                                  3 * mm_flops, BF16_FLOPS),
        "encode_stripes": bound_ms(
            nb * 64 + 3 * op_bytes + batch_bits / 8 + 4 * s_all + 4 * nb,
            3 * mm_flops, BF16_FLOPS),
        "decode_blocks": bound_ms(nb * 64 * 2 + nb * 64 + op_bytes,
                                  mm_flops, F32_FLOPS),
        "entropy_decode": bound_ms(
            sum(t.numel() * t.element_size() for t in ops_d.values()
                if isinstance(t, torch.Tensor))
            + ops_d["block_start"].numel() * 64 * 2),
    }
    for k, (b_ms, by) in bounds.items():
        log(f"bound {k}: {b_ms:.5f} ms ({by}); kernel at "
            f"{100 * b_ms / times[k][0]:.1f} % of it")
    table = [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1],
         "launches": launches[k] + launches90[k],
         "max_abs_err": results[k][1], "ms": round(times[k][0], 4),
         "plain_ms": round(times[k][1], 4),
         "bound_ms": round(bounds[k][0], 5), "bound_by": bounds[k][1],
         "library_ms": None}
        for k in sources
    ]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
