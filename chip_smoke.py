"""Smoke run of the PyTorch/CUDA port (dct_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds the port's kernels from csrc/ into build/torch_kernels/
(printing each kernel function's registers and spills from ptxas -v),
counts the integer tensor-core instructions (IMMA, from cuobjdump -sass)
in kernels A's and B's functions (each must have some), prints kernel
B's launch shape (warps a CTA, registers, CTAs an SM, SMs, shared memory,
spilled bytes, which must be 0, and the batch's stripes a CTA, most and
mean), holds the
tensor-core tile's integer products (transform_cuda.mma_products) equal
to int64 products at n2 4, 16, 64 and 256, then:

  1. kernel A (encode transform: the tensor-core tile, the rounding
     certificate and the rescue of csrc/transform_core.cuh) on 8 frames
     of 1088 x 1920, adaptive quantization off and on and static q100
     (timed: ~2 % of its coefficients rescued), in 8x8 blocks and in
     16x16 blocks: bit-exact against the float32 chain it promises
     (testing.encode_fma_chain), ties only against its plain version,
     with the share of coefficients its chain rescued, which must equal
     the count the certificate's model (testing.certify) leaves open on
     the same blocks; its library time
     is one cuBLAS call computing its products only (the pixels as bf16
     times the four byte planes as bf16, float32 out: exact, every partial
     sum an integer below 2^24), checked equal to the tile's products;
  2. kernel C (decode transform) on those coefficients: against
     testing.decode_fma_chain (ties only, expected 0 mismatches) and its
     plain version (ties only); its library time is one cuBLAS float32
     call computing its products only (the coefficients as float32 times
     the 64 x 64 decode operator: no dequant scale, rounding or clamp);
  3. kernel B (fused stripe encode) against the plain staged pipeline
     (codec.encode_pack_plain) fed kernel A's integers — exactly equal
     units (the whole worst-case buffer, zeros included), stripe bits and
     block bits, with B's rescue share (equal to the model's, as in 1),
     and B reading the frames' planes themselves (the route encode_step
     takes) equal to B on the blocks, whole buffer and rescues too — on
     the
     batch at static q50,
     dynamic-table q50, adaptive + DC prediction + coded runs, and at the
     other configs B takes: 4x4 blocks in category (dynamic),
     direct and "none" modes; 8x8 in direct q90, "none", and direct with
     adaptive + DC prediction + coded runs; 16x16 in category q90, direct
     and "none"; each timed beside its plain version and its bound; then
     the adaptive encode's variance kernel against its plain version run
     on the CPU's copy of the planes (codes byte-equal, reciprocals
     bit-equal, one launch a call) on the batch and on 32 planes at 8x8
     and on the batch at 4x4 and 16x16, timed over shifted copies in turn
     (past the L2) beside its plain version and its byte bound;
  4. the main path: ImageCodec(cfg, device="cuda") encodes a 1080p frame
     at static and at dynamic tables, decodes it (decode and
     decode_to_device), and encode_step encodes the 8-frame batch
     (static, and adaptive: one variance kernel and one B), with
     the kernels' launch counters zeroed before and read after. The
     containers must equal the CPU path's byte for byte, or differ only
     in tie coefficients; pixels must agree within 1;
  5. times of each kernel and its plain version at those shapes (CUDA
     events), end-to-end encode_step and decode rates; kernels A's and
     B's card work alone at the batch (a spin kernel queued first) beside
     the host's enqueue time a call and 20 back-to-back calls, and their
     rescue counts a call against the certificate's model; B from the
     planes likewise; encode_step's card work alone beside its host
     enqueue a call;
  6. the indexed decode (kernel D), the main path of the second slice:
     ImageCodec(CodecConfig(quality=90), device="cuda") encodes the 1080p
     frame to a v2 container (kernels A and B), decodes it (decode and
     decode_to_device: kernels D and C), counted as in 4; the pixels must
     equal the host route's (host decoder, then kernel C) on the same
     container exactly, and the CPU path's within 1;
  7. kernel D against its plain version and the host decoder, bit-exact,
     on the 8-frame batch (1,088 stripes, 261,120 blocks in one launch)
     encoded by kernel B at static q90 and at adaptive + DC prediction +
     coded runs, and on 1080p "none" and "direct" streams from the card's
     staged encoder (kernels A and E);
  8. times of D and its plain version at the batch, its bound, and the
     1080p q90 decode on both routes, stage by stage (D's operands as the
     decode path builds them: the stripe starts, the tables and the zeros
     of D's status on the host, one upload; D scans the index into block
     starts itself), D alone on the 1080p frame among them (the latency
     case); D at the batch with its status and without, each also as the
     card's work alone (a spin kernel queued first, so the host's launch
     cost stays outside the events) beside the host's enqueue time a call;
  9. kernel E (chunk packer) against its plain version, bit-exact (units
     and stripe bits), on the chunks of the 8-frame batch (1,088 stripes,
     50 M chunks) from kernel A's coefficients at static q50 and at
     adaptive + DC prediction + coded runs, and on random chunks (many
     dead, stripes of uneven length, one filled to the capacity and one
     past it); E's and its plain version's times;
 10. the other image configs, counted: ImageCodec(cfg, device="cuda")
     encodes the 1080p frame at block_size 4 (category, dynamic tables),
     in "none" mode and in direct mode at q90, then decodes it (decode and
     decode_to_device); each encode runs kernel A once (the analyze pass)
     and kernel B once, and kernel E not at all; the containers must equal
     the CPU path's (ties excepted) and the pixels agree with it within 1.
     Then 16x16 blocks at q90 with the decode index (a v2 container): A
     and B once to encode, D once to decode (the 16x16 decode transform is
     the float32 product), C and E not at all. Then the frame at
     stripe_rows=4 (960 blocks a stripe, more than kernel B's shared
     memory could hold whole) through A and B, equal to the CPU path;
 11. video at full width: VideoCodec(cfg, device="cuda") encodes 32 frames
     of 1080p (one chunk: one A and one E launch, no B) at q50 and q90,
     and decodes them (the q90 stack of v2 containers in one D and one C
     launch; D is also timed alone on the q90 stack's operands), counted;
     the streams must equal those of chunk_frames=8
     (whose pass 2 runs kernel B), the decoded stack per-frame
     ImageCodec decode and the host route exactly, and a 2-frame stack the
     CPU path's (ties excepted; pixels within 1). Times of encode, decode
     and decode_to_device, and peak device memory. Then 8 frames of 1080p
     in 16x16 blocks at q50: one chunk (analyze + E) and chunk_frames=2
     (pass 2 through B) must give the same streams;
 12. dense streams: the 1080p frame at q97 and q100 and a "noise" frame at
     q100, in each mode with the decode index: kernel B bit-exact against
     the plain staged pipeline fed kernel A's integers, from the blocks
     and from the padded plane, and kernel D on
     B's stream against its plain version and the host decoder. This
     drives direct mode's ESC, the 16-bit code cap and B's worst-case
     buffer (the fullest stripe's share of it is printed). Then the
     densest stream real pixels give (testing.densest_stream: a 1080p
     noise frame at q100 in direct mode, every code 16 bits long, coded
     runs at n2 <= 64) at 4x4, 8x8 and 16x16, through B and D alike;
 13. color at full width: the 1080p frame as RGB (the frame and two
     shifted copies), its Y/Cb/Cr planes on the card equal to the CPU's
     bit for bit; kernels A, B and C with the chrominance operators on
     the Cb plane against the float32 chains and the staged pipeline;
     ColorImageCodec(cfg, device="cuda") at 4:4:4 and 4:2:0, static q50
     (v1) and q90 with the decode index (v2), encoding (one B a plane, and
     one A a plane with dynamic tables) and decoding (decode and
     decode_to_device: one C a plane, and one D a plane for v2), counted;
     containers equal to the CPU path's (ties excepted), pixels within 1
     of it and equal to the host route's; times. Then 32 RGB frames of
     1080p (seeds 0..31) at 4:2:0 q50 through VideoCodec: one chunk (one A
     and one E a plane) equal to chunk_frames=8 (pass 2 through B), a
     2-frame stack equal to the CPU path's; times and peak memory;
 14. recovery: the 4:2:0 q90 container of phase 13 with one corrupt
     stripe a plane: verify reports exactly those, repair and rebuild
     (one A and one E launch a plane) give the from-scratch bytes, and
     decode_region of rows 500-700 (host entropy decode, then C) the full
     decode's rows; counted and timed;
 15. rate control: on the RGB frame and on 8 gray 1080p frames, on the
     ladder q30/50/70/90/97, container_size and video_container_sizes
     equal to len() of the real containers and psnr_at_quality (RGB, and
     the first gray frame) to the PSNR of the real encode and decode;
     encode_to_size, encode_to_psnr and encode_video_to_size meet targets
     set between two rungs; counted and timed.

 16. sharding at world size 1 over NCCL, in this process:
     make_mesh() on the card; encode_batch_step on the 8 x 1088x1920
     batch (units and bit lengths equal to encode_step's, both timed by
     CUDA events); encode_image_sharded of a 7680x4320 gray "photo" frame
     (518,400 blocks, 540 stripes) at dynamic q50 and at q90 with the
     index, and of the 1080p RGB frame at 4:2:0 q90 with the index;
     decode_image_sharded of the 8K v1 and v2 containers (kernel D) and
     of the 4:2:0 one; VideoCodec(mesh=...) on 8 frames of 1080p (one
     chunk: A and E); container_size and psnr_at_quality with mesh= on
     the RGB frame. Every container equals the unsharded card path's
     byte for byte, every pixel its decode's, every probe its value;
     counted (A-E all launched) and timed beside the unsharded paths
     (host clock, synchronised). At the 8K shapes (960 blocks a stripe)
     the kernels are held against their plain versions too: A (its
     float32 chain, and encode ties) and C (decode ties) on the frame, B
     (the staged pipeline fed A's integers) on its 540 stripes and on
     the top 270, a (1, 2) rank's band, at both 8K configs, D (its plain
     version and the host decoder) on the v2 container;
 17. world size 2 over gloo, two spawned processes sharing the card
     (NCCL refuses two ranks on one GPU), at meshes (1, 2) and (2, 1):
     the 8K dynamic encode, the 4:2:0 frame, the 8-frame video and the
     probes again; every rank's bytes and values equal phase 16's, and
     its launches join the counts. A rank that fails, or hangs past its
     timeout, fails the run.
 18. the CLI on the card: dct_tpu_torch.cli.main(argv) in this process,
     with no --device (the card): the four real PGMs of tests/data
     (hopper 600x512, dem 344x403, mri 256x256, topobathy 91x120)
     encoded at static q50 (B), dynamic q50 (A then B) and q90 with
     --decode-index on, each container equal to the same command's with
     --device cpu (ties excepted), decode's pixels equal to the card
     library's decode (v2 through D, then C) and within 1 of the CPU's,
     roundtrip's PSNR that of that decode, and the library's encode and
     decode timed; hopper's q90 container with one stripe's bytes
     flipped: verify reports exactly that stripe (rc 1), repair writes
     the from-scratch bytes, info parses them; encode-video of 8 frames
     of 1080p (seeds 0..7, q50, a .npy) equal to VideoCodec's stream,
     decode-video equal to its decode, and --max-total-bytes between the
     q50 and q60 rungs choosing q50's stream; bench --size 1920x1088
     --frames 8 beside phase 5's encode_step; then python -m
     dct_tpu_torch.cli encode in a fresh process, equal to this one's.
     Kernels A-D must each launch through the CLI.
 19. the examples and damaged containers: examples/torch_demo.py and
     examples/torch_serving.py in this process with their default device
     (the card), counted, every line they print equal to their --device
     cpu run's (the backend and ingest's Mpix/s aside), kernels A-E all
     launched; then damaged v2 containers (testing.damaged_containers, 40
     a case) of 48x72 "photo" images, gray and 4:2:0, at seven configs
     (q50; q50 coded runs; q80 direct; q50 "none"; q30 16x16; q90 with
     the index; q50 adaptive + DC prediction + coded runs with the
     index): on each v2 plane kernel D's coefficients and per-stripe
     status equal its plain version's bit for bit, and each container's
     fate on the card (pixels, or ValueError) equals its --device cpu
     fate. codec.HOST_REDECODES (planes the host decoder decoded again
     because D flagged them) must be 0 over phases 4-18 and at least 1
     here; the counts (containers, flagged, rejected) are printed.

Phases 4, 6, 10, 11 and 13-19 are the main paths: each zeroes the
kernels' launch counters just before it and reads them just after, and
the kernel table's launch counts are their sums. A and C may differ from their plain versions
only at ties: at most 1 apart, where the float64 value lies within 1e-6
(encode) or 1e-3 (decode) of a .5 boundary (the two sum float32 products
in different orders; dct_tpu_torch.testing). B, D and E are held
bit-exact. Any failed check raises. Each kernel's bound is the larger of
the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and its operations over the H100's peak for their type
(1,979 TOP/s int8 for A and B, four u8 x u8/s8 products of n2 x n2 a
block on the tensor cores; 67 TFLOP/s float32 for C, whose coefficients
need float32; D and E do no arithmetic worth a bound), computed from this
run's inputs; each kernel's launches x (time - bound), the order of the
redesign queue, is printed beside it.
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
VIDEO_FRAMES, VH, VW = 32, 1080, 1920  # the video phase: 66 Mpix, one chunk
BIG_H, BIG_W = 4320, 7680  # the sharded phase's 8K frame (BASELINE config 4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS = 1979e12
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


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of the card's work alone: a spin kernel
    queued first keeps the card busy while the host enqueues the calls,
    so the events bracket their device time, not the host's launch cost.
    -> (device ms, host ms to enqueue one call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of cycles, longer than the enqueue
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


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


def a_b_ops(nb: int, n2: int) -> float:
    """Operations of A's and B's transform: four (n2, n2) int8 plane
    products a block, two operations a multiply-add."""
    return 4 * 2 * nb * n2 * n2


def b_bytes(nb: int, n2: int, cfg, ops, n_stripes: int) -> int:
    """The bytes kernel B must move: its pixels and operands in; out, the
    whole worst-case unit buffer (what the JAX kernel returns, zeros past
    each payload included), the stripe bits and the block bits."""
    from dct_tpu_torch.ops import bitstream as bs

    units = nb * bs.units_per_block_worst(n2, cfg.coded_runs) * 2
    return nb * n2 + operator_bytes(ops) + units + 4 * n_stripes + 4 * nb


def operator_bytes(ops) -> int:
    """The operands A and B read for the transform: the byte planes, the
    certificate constants, the float32 parts, the bias."""
    return sum(t.numel() * t.element_size() for t in (
        ops.int_planes, ops.int_cert, ops.parts, ops.bias))


def rescue_share(kernel: str, px, cfg, ops, scale) -> str:
    """The coefficients kernel A ("encode_blocks") or B ("encode_stripes")
    rescued since reset_rescued(), beside the count the certificate's
    model (testing.certify, run here on the same blocks) leaves open;
    checks that the two are equal."""
    from dct_tpu_torch import testing
    from dct_tpu_torch.ops import _build, transform

    n = _build.rescued(kernel)
    recip = None if scale is None else transform.reciprocal_scale(scale)
    _, ok = testing.certify(testing.certified_products(px, cfg, ops),
                            ops.int_cert[:cfg.n2], recip)
    model = int((~ok).sum())
    check(n == model, f"{kernel} rescued {n} coefficients, the "
          f"certificate's model leaves {model} open")
    return (f"{n} rescued ({100 * n / px.numel():.4f} %; the certificate's "
            f"model: {model})")


def imma_counts(names) -> dict:
    """{kernel function: IMMA instructions} in the built libraries, from
    cuobjdump -sass (next to nvcc)."""
    import pathlib
    from dct_tpu_torch.ops import _build

    cuobjdump = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    counts = {}
    for name in names:
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        for fn, body in re.findall(r"Function : (\S+)(.*?)(?=Function :|\Z)",
                                   sass, re.S):
            counts[fn] = len(re.findall(r"\bIMMA\b", body))
    return counts


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
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    hist = None
    if mode == "category":
        hist = hf.category_histogram_masked(sym.values, sym.is_sym)
    elif mode == "direct":
        hist = hf.value_histogram_masked(sym.values, sym.is_sym,
                                         codec.DIRECT_VMIN, -codec.DIRECT_VMIN)
    table = codec._build_table(cfg, None if hist is None
                               else hist.cpu().numpy())
    run_table = codec._build_run_table(cfg, hf.run_histogram_masked(
        sym.runs, sym.is_sym).cpu().numpy())
    return ops.with_tables(table, run_table), table, run_table


def check_b(name, cfg, px, scale, n_stripes, ops, plane=None):
    """Kernel B against the plain staged pipeline fed kernel A's integers
    (exactly equal units, stripe bits and block bits) -> (B's packed
    stripes, block bits, max |unit difference|). plane: the padded planes
    px was cut from; B reading them (the route encode_step takes) must
    give the same whole buffer, bits and block bits as B on px, and
    rescue as many coefficients."""
    import torch
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import bitstream as bs
    from dct_tpu_torch.ops import fused_encode_cuda, rle, transform
    from dct_tpu_torch.ops import transform_cuda

    from dct_tpu_torch.ops import _build

    zz = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
    if cfg.dc_prediction:
        zz = codec.dc_predict(zz, n_stripes)
    recip = None if scale is None else transform.reciprocal_scale(scale)
    _build.reset_rescued()
    got, got_bb = fused_encode_cuda.encode_stripes_fused(
        px, cfg, n_stripes, ops, adaptive_recip=recip)
    share = rescue_share("encode_stripes", px, cfg, ops, scale)
    ref, ref_bb = codec.encode_pack_plain(rle.rle_encode_positional(zz),
                                          cfg, n_stripes, ops)
    g, r = bs.fetch_packed(got), bs.fetch_packed(ref)
    # the whole buffer too: B writes the zeros past each payload itself
    same = (np.array_equal(g.bit_lengths, r.bit_lengths)
            and np.array_equal(g.units, r.units)
            and torch.equal(got.units.to(torch.int32) & 0xFFFF,
                            ref.units.to(torch.int32) & 0xFFFF)
            and torch.equal(got_bb, ref_bb))
    if plane is not None:
        _build.reset_rescued()
        from_plane, plane_bb = fused_encode_cuda.encode_plane_stripes_fused(
            plane, cfg, n_stripes, ops, adaptive_recip=recip)
        plane_share = rescue_share("encode_stripes", px, cfg, ops, scale)
        plane_same = (torch.equal(from_plane.units, got.units)
                      and torch.equal(from_plane.bit_lengths,
                                      got.bit_lengths)
                      and torch.equal(plane_bb, got_bb))
        log(f"B {name} from the planes: whole buffer, stripe bits and "
            f"block bits equal to B on the blocks: {plane_same}; "
            f"{plane_share}")
        check(plane_same, f"B {name} from the planes differs from B on "
              f"the blocks")
    capacity_bits = 16 * got.units.shape[1]
    log(f"B {name}: {px.shape[0]} blocks, {n_stripes} stripes, "
        f"{int(g.bit_lengths.sum())} bits, fullest stripe "
        f"{100 * int(g.bit_lengths.max()) / capacity_bits:.1f} % of its "
        f"worst-case buffer; {share}; units/stripe bits/block bits equal "
        f"to the staged pipeline: {same}")
    check(same, f"B {name} differs from the staged pipeline")
    err = int(np.abs(g.units.astype(np.int64) - r.units).max())
    return got, got_bb, err


def check_variance(name, batches, cfg) -> tuple:
    """The adaptive encode's variance kernel
    (fused_encode_cuda.plane_variance_codes) on padded planes against its
    plain version run on the CPU's copy of them: codes byte-equal,
    reciprocals bit-equal, one launch a call. Timed over ``batches`` in
    turn (together past the 50 MB L2, as the benchmark cycles its
    batches) beside its plain version on the card and its byte bound
    (pixels in; a code byte and a float32 reciprocal a block out). The
    plain version on the card (quant.py's chain, which the blocks route
    and the dynamic tables' analyze pass run) must give the same codes.
    -> (kernel ms, plain ms, (bound ms, by), max |diff|)."""
    import torch
    from dct_tpu_torch.ops import _build, fused_encode_cuda

    planes = batches[0]
    _build.reset_launch_counts()
    codes, recip = fused_encode_cuda.plane_variance_codes(planes, cfg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    want_codes, want_recip = fused_encode_cuda.variance_codes_plain(
        planes.cpu(), cfg)
    same = (torch.equal(codes.cpu(), want_codes)
            and torch.equal(recip.cpu().view(torch.int32),
                            want_recip.view(torch.int32)))
    on_card = fused_encode_cuda.variance_codes_plain(planes, cfg)[0].cpu()
    nb = codes.numel()
    turn = iter(range(1 << 30))

    def call(fn):
        return lambda: fn(batches[next(turn) % len(batches)], cfg)

    ms = cuda_ms(call(fused_encode_cuda.plane_variance_codes), 40)
    dev_ms, enq_ms = device_ms(call(fused_encode_cuda.plane_variance_codes),
                               40)
    plain_ms = cuda_ms(call(fused_encode_cuda.variance_codes_plain), 5)
    bound = bound_ms(planes.numel() + nb * 5)
    at0 = float((want_codes == 0).float().mean())
    log(f"variance_codes {name}: {tuple(planes.shape)}, {nb} blocks; codes "
        f"and reciprocals equal to the plain version's on the CPU: {same}; "
        f"launches {launches}; codes at 0 {100 * at0:.2f} %, largest "
        f"{int(want_codes.max())}; the plain version on the card differs in "
        f"{int((on_card != want_codes).sum())} codes")
    log(f"time variance_codes {name}: kernel {ms:.4f} ms ({len(batches)} "
        f"batches in turn; the card's work alone {dev_ms:.4f} ms, host "
        f"enqueue {enq_ms:.4f} ms a call), plain {plain_ms:.4f} ms, bound "
        f"{bound[0]:.5f} ms ({bound[1]}; the card's work at "
        f"{100 * bound[0] / dev_ms:.1f} % of it)")
    check(same, f"variance_codes {name} differs from its plain version")
    check(torch.equal(on_card, want_codes), f"variance_codes {name}: the "
          f"plain version on the card differs from the CPU's")
    check(launches == {"variance_codes": 1},
          f"variance_codes {name} launched {launches}")
    err = int((codes.cpu().to(torch.int32) - want_codes.to(torch.int32))
              .abs().max())
    return dev_ms, plain_ms, bound, err


def check_d(name, stripes, bits, table, run_table, mode, n2, dev):
    """Kernel D on an indexed stream against its plain version and the
    host decoder (exactly equal coefficients) -> (D's operands, max |diff|
    against the plain version)."""
    import torch
    from dct_tpu_torch import native
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import entropy_decode as ed
    from dct_tpu_torch.ops import entropy_decode_cuda

    operands = codec.indexed_operands(stripes, bits, table, run_table,
                                      mode, n2, dev, status=True)
    got, status = entropy_decode_cuda.decode_blocks_kernel(**operands)
    want, want_status = ed.decode_blocks_plain(**dict(
        operands, status=torch.zeros_like(operands["status"])))
    host = native.unpack_stripes(stripes, len(bits) // len(stripes), n2,
                                 mode, table, codec.DIRECT_VMIN,
                                 run_table=run_table)
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    same = torch.equal(got, want) and torch.equal(status, want_status)
    same_host = np.array_equal(got.cpu().numpy(), host)
    flagged = int(status.count_nonzero())
    log(f"D {name}: {len(bits)} blocks, {len(stripes)} stripes, "
        f"{sum(map(len, stripes))} B; coefficients and status equal to "
        f"plain: {same}, to the host decoder: {same_host}; stripes flagged "
        f"{flagged}")
    check(same and same_host and flagged == 0, f"D {name} differs")
    return operands, err


def same_or_ties(name: str, data: bytes, cpu_data: bytes, image) -> None:
    """A card container against the CPU path's for the same image: equal,
    or every differing coefficient is an encode tie."""
    from dct_tpu_torch import testing

    same = data == cpu_data
    log(f"{name}: {len(data)} B, container v{data[4]}, equal to CPU path: "
        f"{same}")
    if not same:
        n_mis, n_bad = testing.encode_mismatches(data, cpu_data, image)
        log(f"{name} coefficients: {n_mis} mismatches ({n_bad} non-ties)")
        check(n_bad == 0, f"{name}: non-tie mismatches")


def encode_stages(cfg, frame, dev) -> dict:
    """Milliseconds of each stage of a dynamic-table ImageCodec encode of
    one frame on the card (host clock, synchronised; kernel B by CUDA
    events), beside the staged pack (symbol chunks + kernel E) that these
    configs ran before kernel B took them."""
    import torch
    from dct_tpu_torch import container as cont
    from dct_tpu_torch import tables
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import bitstream as bs

    def synced(fn):
        def run():
            out = fn()
            torch.cuda.synchronize()
            return out
        return run

    h, w = frame.shape
    n_stripes = codec._padded_grid(h, w, cfg)[2]
    ops = tables.build(cfg, device=dev)
    upload = synced(lambda: codec.pad_plane_for_encode(
        torch.from_numpy(frame).to(dev), cfg))
    img = upload()
    analyze = synced(lambda: codec.encode_analyze(img, cfg, ops))
    sym, _, hist, run_hist = analyze()
    hist_h, run_h = hist.cpu().numpy(), run_hist.cpu().numpy()

    def build_tables():
        return (codec._build_table(cfg, hist_h),
                codec._build_run_table(cfg, run_h))

    table, run_table = build_tables()
    ops_t = ops.with_tables(table, run_table)
    packed, _, _ = codec.encode_fused_step(img, cfg, n_stripes, ops_t)
    fetched = bs.fetch_packed(packed)
    plane = codec.encode_plane(frame, cfg, dev)
    return {
        "upload + pad": host_ms(upload, 10),
        "analyze (A, RLE, histogram)": host_ms(analyze, 10),
        "histogram fetch + tables (host)": host_ms(
            lambda: (hist.cpu(), run_hist.cpu(), build_tables()), 10),
        "B (encode_fused_step)": cuda_ms(lambda: codec.encode_fused_step(
            img, cfg, n_stripes, ops_t), 10),
        "fetch units": host_ms(lambda: bs.fetch_packed(packed), 10),
        "stripe bytes": host_ms(lambda: bs.stripes_to_bytes(fetched), 10),
        "serialize": host_ms(lambda: cont.serialize(cont.Container(
            config=cfg, width=w, height=h, planes=[plane])), 10),
        "instead: symbol chunks + E": host_ms(synced(
            lambda: codec.pack_frames(sym, cfg, (), n_stripes, ops_t)), 10),
    }


def counted(fn, main_runs):
    """fn() with the kernels' launch counters zeroed before and read after
    (synchronised): a main-path run, its counts appended to main_runs.
    -> (fn's result, the counts)."""
    import torch
    from dct_tpu_torch.ops import _build

    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    main_runs.append(counts)
    return out, counts


def rgb_of(gray):
    """RGB from a gray frame (or stack), as the repo's tests build it."""
    return np.stack([gray, np.roll(gray, 3, -2), np.roll(gray, 5, -1)], -1)


def check_chroma_kernels(dev, rgb) -> None:
    """Kernels A, B and C with the chrominance operators (the Cb plane of
    the 1080p frame at 4:4:4): A bit-exact to the float32 chain it
    promises, with its rescue share (the certificate on the chroma
    operator's integer form); B equal to the staged pipeline fed A's
    integers; C to decode_fma_chain within decode ties."""
    import torch
    from dct_tpu_torch import CodecConfig, tables, testing
    from dct_tpu_torch.models import codec, color
    from dct_tpu_torch.ops import _build, blocks, transform, transform_cuda

    cb = color._to_planes(torch.from_numpy(rgb).to(dev), "444")[1]
    img = codec.pad_plane_for_encode(cb, CodecConfig())
    for name, cfg in (("static q50", CodecConfig(quality=50,
                                                 static_tables=True)),
                      ("adaptive q90", CodecConfig(quality=90,
                                                   adaptive=True))):
        ops = tables.build(cfg, chroma=True, device=dev)
        px = blocks.image_to_blocks(img, 8).reshape(-1, 64)
        _, scale = codec._adaptive(px, cfg)
        recip = None if scale is None else transform.reciprocal_scale(scale)
        _build.reset_rescued()
        got = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
        share = rescue_share("encode_blocks", px, cfg, ops, scale)
        n_chain = int((got != testing.encode_fma_chain(px, cfg, ops,
                                                       recip)).sum())
        log(f"A chroma {name}: {n_chain} mismatches of {got.numel()} "
            f"against encode_fma_chain; {share}")
        check(n_chain == 0, "A with the chroma operator differs from its "
              "float32 chain")
        ns = img.shape[0] // 8
        ops_t, _, _ = batch_tables(cfg, px, scale, ns, ops)
        check_b(f"chroma {name}", cfg, px, scale, ns, ops_t)
        zz_h = got.cpu().numpy()
        scale_h = None if scale is None else scale.cpu().numpy()
        tie_check(f"C chroma {name} vs decode_fma_chain",
                  transform_cuda.decode_blocks_kernel(got, cfg, ops, scale),
                  testing.decode_fma_chain(got, cfg, ops, scale),
                  lambda b: testing.decode_values_f64(
                      zz_h[b], cfg, None if scale_h is None else scale_h[b],
                      chroma=True),
                  testing.DECODE_TIE_TOL)


def phase_color(dev, frame, vframes, main_runs) -> dict:
    """Phase 13: ColorImageCodec at full width (444 and 420, static q50
    and the default q90) and 32 RGB frames of 1080p through VideoCodec,
    counted. -> {"420 q90": its container} for phase 14."""
    import dataclasses

    import torch
    from dct_tpu_torch import CodecConfig
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models import codec, color, video

    rgb = rgb_of(frame)
    h, w = frame.shape
    mpx = h * w / 1e3
    for mode in ("444", "420"):
        gpu_planes = color._to_planes(torch.from_numpy(rgb).to(dev), mode)
        cpu_planes = color._to_planes(torch.from_numpy(rgb), mode)
        same = all(torch.equal(g.cpu(), c)
                   for g, c in zip(gpu_planes, cpu_planes))
        back = color.planes_to_rgb(*gpu_planes, mode, h, w)
        same_rgb = torch.equal(back.cpu(), color.planes_to_rgb(
            *cpu_planes, mode, h, w))
        log(f"color {mode}: planes on the card equal the CPU's: {same}; "
            f"planes_to_rgb too: {same_rgb}")
        check(same and same_rgb, f"color {mode}: conversions differ")
    check_chroma_kernels(dev, rgb)
    kept = {}
    # q90 with the decode index: "auto" leaves it out of a 1080p color
    # container (the chroma planes' index costs more than 6 % of their
    # payload), and kernel D decodes only indexed planes
    for mode in ("444", "420"):
        for q, kw in ((50, dict(static_tables=True)),
                      (90, dict(decode_index=True))):
            name = f"{mode} q{q} {'static' if q == 50 else 'index'}"
            cfg = CodecConfig(quality=q, chroma=mode, **kw)
            gpu = color.ColorImageCodec(cfg, device=dev)
            data, enc = counted(lambda: gpu.encode(rgb), main_runs)
            rec, dec = counted(lambda: gpu.decode(data), main_runs)
            rec_d, dec_d = counted(lambda: gpu.decode_to_device(data),
                                   main_runs)
            log(f"color {name}: {len(data)} B, v{data[4]}; encode launches "
                f"{enc}, decode {dec}, decode_to_device {dec_d}")
            check(enc["encode_stripes"] == 3 and enc["pack_chunks"] == 0
                  and enc["encode_blocks"] == (0 if cfg.static_tables else 3),
                  f"color {name}: not one B (and one A with dynamic tables) "
                  "a plane")
            v2 = data[4] == 2
            check(v2 == (q == 90), f"color {name}: container v{data[4]}")
            for counts in (dec, dec_d):
                check(counts["decode_blocks"] == 3
                      and counts["entropy_decode"] == (3 if v2 else 0),
                      f"color {name}: decode launches {counts}")
            cpu = color.ColorImageCodec(cfg, device="cpu")
            same_or_ties(f"color {name}", data, cpu.encode(rgb), rgb)
            check(rec_d.device.type == "cuda"
                  and np.array_equal(rec, rec_d.cpu().numpy()),
                  f"color {name}: decode and decode_to_device disagree")
            err = int(np.abs(rec.astype(int) - cpu.decode(data)).max())
            c = cont.deserialize(data)
            host = color.planes_to_rgb(*(codec.decode_plane_device(
                dataclasses.replace(p, block_bits=None), cfg, dev,
                chroma=i > 0) for i, p in enumerate(c.planes)), mode, h, w)
            same_host = np.array_equal(host.cpu().numpy(), rec)
            mse = float(np.mean((rec.astype(np.float64) - rgb) ** 2))
            log(f"color {name}: decode max |diff| vs CPU {err}, equal to the "
                f"host route: {same_host}, PSNR "
                f"{10 * np.log10(255.0 ** 2 / mse):.2f} dB")
            check(err <= 1, f"color {name}: pixels differ by {err}")
            check(same_host, f"color {name}: differs from the host route")
            c_ms = {"encode": host_ms(lambda: gpu.encode(rgb), 10),
                    "decode": host_ms(lambda: gpu.decode(data), 10),
                    "decode_to_device": host_ms(
                        lambda: (gpu.decode_to_device(data),
                                 torch.cuda.synchronize()), 10)}
            log(f"ColorImageCodec 1080p {name} (v{data[4]}): " + ", ".join(
                f"{k} {v:.3f} ms ({mpx / v:.1f} Mpix/s)"
                for k, v in c_ms.items()))
            kept[f"{mode} q{q}"] = data

    # 32 RGB frames of 1080p at 420 q50, one chunk (3 A, 3 E) against
    # chunk_frames=8 (pass 2 through B)
    vrgb = rgb_of(vframes)
    nf, vh, vw = vrgb.shape[:3]
    vmpx = nf * vh * vw / 1e3
    cfg = CodecConfig(quality=50, chroma="420")
    vc = video.VideoCodec(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    streams, enc = counted(lambda: vc.encode(vrgb), main_runs)
    enc_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec_d, dec = counted(lambda: vc.decode_to_device(streams), main_runs)
    dec_peak = torch.cuda.max_memory_allocated()
    log(f"color video 420 q50: {nf} x {vh}x{vw}, {sum(map(len, streams))} B; "
        f"encode launches {enc}, peak {enc_peak / 2**30:.3f} GiB; "
        f"decode_to_device launches {dec}, peak {dec_peak / 2**30:.3f} GiB")
    check(enc["encode_blocks"] == enc["pack_chunks"] == 3
          and enc["encode_stripes"] == 0,
          "color video: not one A and one E launch a plane")
    check(dec["decode_blocks"] == 3, "color video: not one C a plane")
    chunked, c8 = counted(lambda: video.VideoCodec(
        cfg, chunk_frames=8, device=dev).encode(vrgb), main_runs)
    log(f"color video: chunk_frames=8 launches {c8}; streams equal to one "
        f"chunk's: {chunked == streams}")
    check(c8["encode_stripes"] == 3 * nf // 8,
          "color video: chunked pass 2 did not run kernel B")
    check(chunked == streams, "color video: bytes depend on chunking")
    rec = vc.decode(streams)
    check(np.array_equal(rec, rec_d.cpu().numpy()),
          "color video: decode and decode_to_device disagree")
    single = color.ColorImageCodec(cfg, device=dev)
    check(all(np.array_equal(rec[i], single.decode(streams[i]))
              for i in (0, nf // 2, nf - 1)),
          "color video: the stack differs from per-frame decode")
    two = video.VideoCodec(cfg, device=dev).encode(vrgb[:2])
    two_cpu = video.VideoCodec(cfg, device="cpu").encode(vrgb[:2])
    for i in range(2):
        same_or_ties(f"color video 2-frame stack, frame {i}", two[i],
                     two_cpu[i], vrgb[i])
    v_ms = {"encode": host_ms(lambda: vc.encode(vrgb), 3),
            "decode": host_ms(lambda: vc.decode(streams), 3),
            "decode_to_device": host_ms(lambda: (vc.decode_to_device(streams),
                                                 torch.cuda.synchronize()), 3)}
    log(f"color video 420 q50 {nf} x {vh}x{vw}: " + ", ".join(
        f"{k} {v:.3f} ms ({vmpx / v:.1f} Mpix/s)" for k, v in v_ms.items()))
    color_stages(dev, rgb, kept["420 q50"], vrgb, cfg)
    return kept


def color_stages(dev, rgb, data, vrgb, cfg) -> None:
    """Where the 1080p 420 q50 (v1) decode and the 32-frame RGB video
    encode go, stage by stage (host clock, synchronised)."""
    import os

    import torch
    from dct_tpu_torch import container as cont
    from dct_tpu_torch import native
    from dct_tpu_torch.models import codec, color, video

    def synced(fn):
        def run():
            out = fn()
            torch.cuda.synchronize()
            return out
        return run

    c = cont.deserialize(data)
    h, w = rgb.shape[:2]
    planes = [codec.decode_plane_device(p, c.config, dev, chroma=i > 0)
              for i, p in enumerate(c.planes)]
    rec = color.planes_to_rgb(*planes, "420", h, w)
    threads = len(os.sched_getaffinity(0))
    log(f"host: os.cpu_count() {os.cpu_count()}, cores this process may run "
        f"on {threads}; the native decoder takes os.cpu_count() threads")

    def host_decode(p, n_threads=None):
        bh, bw, ns = codec._padded_grid(p.height, p.width, c.config)
        table = codec.hf.CanonicalTable(p.table_lengths)
        return native.unpack_stripes(p.stripes, bh // ns * bw, 64,
                                     "category", table, codec.DIRECT_VMIN,
                                     n_threads=n_threads)

    stages = {"parse": host_ms(lambda: cont.deserialize(data), 5)}
    for name, p in zip(("Y", "Cb", "Cr"), c.planes):
        stages[f"host entropy decode {name}"] = host_ms(
            lambda: host_decode(p), 5)
        stages[f"host entropy decode {name}, {threads} threads"] = host_ms(
            lambda: host_decode(p, threads), 5)
    for name, (i, p) in zip(("Y", "Cb", "Cr"), enumerate(c.planes)):
        stages[f"decode_plane_device {name}"] = host_ms(synced(
            lambda: codec.decode_plane_device(p, c.config, dev,
                                              chroma=i > 0)), 5)
    stages["planes_to_rgb"] = host_ms(synced(
        lambda: color.planes_to_rgb(*planes, "420", h, w)), 5)
    stages["download RGB"] = host_ms(lambda: rec.cpu(), 5)
    log("1080p 420 q50 decode stages: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items()))

    batches = video.rgb_planes(vrgb, "420", None, dev)
    h, w = vrgb.shape[1:3]
    place = codec.Placement(dev)
    per_plane = [video._encode_plane_batch(b, cfg, None, place, chroma=i > 0)
                 for i, b in enumerate(batches)]
    v_stages = {"RGB -> planes (upload, convert, download)": host_ms(
        lambda: video.rgb_planes(vrgb, "420", None, dev), 3)}
    for name, (i, b) in zip(("Y", "Cb", "Cr"), enumerate(batches)):
        v_stages[f"plane stack {name}"] = host_ms(
            lambda: video._encode_plane_batch(b, cfg, None, place,
                                              chroma=i > 0), 3)
    v_stages["serialize"] = host_ms(lambda: [cont.serialize(cont.Container(
        config=cfg, width=w, height=h, planes=list(p)))
        for p in zip(*per_plane)], 3)
    log(f"color video 420 q50 {vrgb.shape[0]} x {h}x{w} encode stages: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in v_stages.items()))


def phase_recovery(dev, frame, data, main_runs) -> None:
    """Phase 14: the 1080p 420 q90 container with one corrupt stripe a
    plane: verify finds exactly those, repair and rebuild (kernels A and
    E) give the from-scratch bytes (kernel B's), decode_region (host
    entropy decode, kernel C) the full decode's rows; counted and timed."""
    import torch
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models import codec, recovery

    rgb = rgb_of(frame)
    hit = [(0, 40), (1, 20), (2, 50)]
    c = cont.deserialize(data)
    for pi, st in hit:
        s = bytearray(c.planes[pi].stripes[st])
        for i in range(8):
            s[i] ^= 0xA5
        c.planes[pi].stripes[st] = bytes(s)
    bad = cont.serialize(c)
    found = recovery.verify(bad)
    log(f"recovery 420 q90: corrupted {hit}, verify reports {found}")
    check(found == hit, "verify did not report exactly the corrupt stripes")
    check(recovery.verify(data) == [], "verify flags a clean container")
    fixed, rep = counted(lambda: recovery.repair(bad, rgb, device=dev),
                         main_runs)
    rebuilt, reb = counted(lambda: recovery.rebuild(data, rgb, device=dev),
                           main_runs)
    log(f"recovery: repair launches {rep}, equal to the from-scratch bytes: "
        f"{fixed == data}; rebuild launches {reb}, equal: {rebuilt == data}")
    check(fixed == data, "repair differs from the from-scratch encode")
    check(rebuilt == data, "rebuild differs from the from-scratch encode")
    check(rep["encode_blocks"] == rep["pack_chunks"] == 3
          and rep["encode_stripes"] == 0,
          "repair: not one A and one E launch a damaged plane")
    full = codec.decode(data, dev)
    region, reg = counted(lambda: recovery.decode_region(data, 500, 700,
                                                          device=dev),
                          main_runs)
    log(f"recovery: decode_region rows 500-700 launches {reg}, equal to the "
        f"full decode's rows: {np.array_equal(region, full[500:700])}")
    check(np.array_equal(region, full[500:700]),
          "decode_region differs from the full decode")
    r_ms = {"verify": host_ms(lambda: recovery.verify(bad), 5),
            "repair (3 stripes, verify's)": host_ms(
                lambda: recovery.repair(bad, rgb, device=dev), 5),
            "repair (the 3 stripes named)": host_ms(
                lambda: recovery.repair(bad, rgb, stripes=hit, device=dev),
                5),
            "rebuild (271 stripes)": host_ms(
                lambda: recovery.rebuild(data, rgb, device=dev), 5),
            "decode_region 500-700": host_ms(
                lambda: recovery.decode_region(data, 500, 700, device=dev),
                5),
            "full decode": host_ms(lambda: codec.decode(data, dev), 5)}
    torch.cuda.synchronize()
    log("recovery 1080p 420 q90: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in r_ms.items()))


def phase_rate_control(dev, frame, vframes, main_runs) -> None:
    """Phase 15: size and PSNR probes on the 1080p RGB frame and on 8 gray
    1080p frames against real encodes on a 5-rung ladder, the encode_to_*
    fronts against their targets; counted and timed."""
    from dct_tpu_torch import CodecConfig
    from dct_tpu_torch.models import codec, rate_control as rc, video

    rgb = rgb_of(frame)
    stack = vframes[:8]
    ladder = (30, 50, 70, 90, 97)
    sizes, psnrs, vsizes = {}, {}, {}
    for q in ladder:
        cfg = CodecConfig(quality=q)
        sizes[q], c1 = counted(lambda: rc.container_size(rgb, cfg, dev),
                               main_runs)
        psnrs[q], c2 = counted(lambda: rc.psnr_at_quality(rgb, cfg, dev),
                               main_runs)
        vsizes[q], c3 = counted(lambda: rc.video_container_sizes(
            stack, cfg, device=dev), main_runs)
        data = codec.encode(rgb, cfg, dev)
        rec = codec.decode(data, dev).astype(np.float64)
        real_psnr = float(10.0 * np.log10(255.0 * 255.0
                                          / np.mean((rec - rgb) ** 2)))
        streams = video.VideoCodec(cfg, device=dev).encode(stack)
        gray_psnr = rc.psnr_at_quality(stack[0], cfg, dev)
        rec0 = codec.decode(streams[0], dev).astype(np.float64)
        real_gray = float(10.0 * np.log10(255.0 * 255.0
                                          / np.mean((rec0 - stack[0]) ** 2)))
        log(f"rate control q{q}: RGB probe {sizes[q]} B, container "
            f"{len(data)} B (v{data[4]}); PSNR probe {psnrs[q]!r}, real "
            f"{real_psnr!r}; 8-frame gray probe {int(vsizes[q].sum())} B, "
            f"streams {sum(map(len, streams))} B; gray frame PSNR probe "
            f"{gray_psnr!r}, real {real_gray!r}; probe launches {c1}, {c2}, "
            f"{c3}")
        check(sizes[q] == len(data), f"q{q}: RGB size probe is not exact")
        check(psnrs[q] == real_psnr, f"q{q}: RGB PSNR probe is not exact")
        check(vsizes[q].tolist() == [len(s) for s in streams],
              f"q{q}: video size probe is not exact")
        check(gray_psnr == real_gray, f"q{q}: gray PSNR probe is not exact")
        check(c1["encode_blocks"] == 3 and c2["encode_blocks"] == 3
              and c2["decode_blocks"] == 3 and c1["encode_stripes"] == 0,
              f"q{q}: the probes did not run kernels A and C")
    budget = (sizes[50] + sizes[70]) // 2
    (data, q), c4 = counted(lambda: rc.encode_to_size(
        rgb, budget, qualities=ladder, device=dev), main_runs)
    log(f"encode_to_size budget {budget} B: q{q}, {len(data)} B; launches "
        f"{c4}")
    check(q == 50 and len(data) <= budget, "encode_to_size missed its target")
    target = (psnrs[50] + psnrs[70]) / 2
    (data, q), c5 = counted(lambda: rc.encode_to_psnr(
        rgb, target, qualities=ladder, device=dev), main_runs)
    rec = codec.decode(data, dev).astype(np.float64)
    got = float(10.0 * np.log10(255.0 * 255.0 / np.mean((rec - rgb) ** 2)))
    log(f"encode_to_psnr target {target:.4f} dB: q{q}, {got:.4f} dB; "
        f"launches {c5}")
    check(q == 70 and got >= target, "encode_to_psnr missed its target")
    total = (int(vsizes[70].sum()) + int(vsizes[90].sum())) // 2
    (streams, q), c6 = counted(lambda: rc.encode_video_to_size(
        stack, total, qualities=ladder, device=dev), main_runs)
    log(f"encode_video_to_size budget {total} B: q{q}, "
        f"{sum(map(len, streams))} B; launches {c6}")
    check(q == 70 and sum(map(len, streams)) <= total,
          "encode_video_to_size missed its target")
    cfg = CodecConfig(quality=90)
    t_ms = {"container_size RGB": host_ms(
                lambda: rc.container_size(rgb, cfg, dev), 5),
            "RGB encode (for comparison)": host_ms(
                lambda: codec.encode(rgb, cfg, dev), 5),
            "psnr_at_quality RGB": host_ms(
                lambda: rc.psnr_at_quality(rgb, cfg, dev), 5),
            "video_container_sizes 8 gray": host_ms(
                lambda: rc.video_container_sizes(stack, cfg, device=dev), 3),
            "8-frame video encode (for comparison)": host_ms(
                lambda: video.VideoCodec(cfg, device=dev).encode(stack), 3),
            "encode_to_size RGB (5 rungs)": host_ms(
                lambda: rc.encode_to_size(rgb, budget, qualities=ladder,
                                          device=dev), 3),
            "encode_to_psnr RGB (5 rungs)": host_ms(
                lambda: rc.encode_to_psnr(rgb, target, qualities=ladder,
                                          device=dev), 3)}
    log("rate control 1080p q90: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in t_ms.items()))


def sharded_plane_stages(mesh, plane, cfg, dev) -> dict:
    """Milliseconds of each stage of a sharded dynamic-table plane encode
    (codec.encode_plane over a shard_encode.MeshPlacement; host clock,
    synchronised), beside the whole call and the unsharded
    codec.encode_plane."""
    import torch
    from dct_tpu_torch import tables
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.parallel import shard_encode as se

    def synced(fn):
        def run():
            out = fn()
            torch.cuda.synchronize()
            return out
        return run

    h, w = plane.shape
    place = se.MeshPlacement(mesh)
    grid = place.grid(h, w, cfg)
    band = synced(lambda: place.upload(plane, grid))
    img = band()
    ops = tables.build(cfg, device=dev)
    analyze = synced(lambda: codec.encode_analyze(img, cfg, ops))
    sym, _, hist, run_hist = analyze()

    def build_tables():
        return codec.build_tables(cfg, ops, *place.histograms(
            sym, hist, run_hist, cfg, grid))

    table, run_table, ops_t = build_tables()
    fused = synced(lambda: codec.encode_fused_step(img, cfg, grid.n_loc,
                                                   ops_t))
    packed, var, bb = fused()

    def gather():
        return place.outputs(packed, var, bb, grid)

    packed_h, var_h, bb_h = gather()
    return {
        "band upload + pad": host_ms(band, 10),
        "analyze (A, RLE)": host_ms(analyze, 10),
        "masked histograms + all-reduce + tables": host_ms(build_tables, 10),
        "B": host_ms(fused, 10),
        "gathers (bits, units, block bits) to the host": host_ms(gather, 10),
        "PlaneData (stripe bytes)": host_ms(lambda: codec.plane_data(
            packed_h, w, h, table, run_table, var_h, bb_h), 10),
        "encode_plane over the mesh": host_ms(
            lambda: codec.encode_plane(plane, cfg, placement=place), 10),
        "encode_plane (unsharded)": host_ms(
            lambda: codec.encode_plane(plane, cfg, dev), 10),
    }


def check_kernels_8k(dev, big, containers) -> dict:
    """Kernels A, B, C and D at the 8K frame's shapes (518,400 blocks, 540
    stripes of 960 blocks; B also on the top 270 stripes, the band a rank
    of phase 17's (1, 2) mesh encodes), at the two 8K configs of phase 16:
    A bit-exact to its float32 chain and within encode ties of its plain
    version, B equal to the staged pipeline fed A's integers, C within
    decode ties of its plain version, D on the sharded v2 container equal
    to its plain version and the host decoder. -> {kernel: max |diff|}."""
    import torch
    from dct_tpu_torch import CodecConfig, container as cont, tables, testing
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import blocks, transform, transform_cuda

    errs = dict.fromkeys(("encode_blocks", "encode_stripes", "decode_blocks",
                          "entropy_decode"), 0)
    img = torch.from_numpy(big).to(dev)
    px = blocks.image_to_blocks(img, 8).reshape(-1, 64)
    px_h = px.cpu().numpy()
    n_stripes = BIG_H // 8
    band = n_stripes // 2
    for name, cfg in (("8K q50", CodecConfig(quality=50, decode_index=False)),
                      ("8K q90 index", CodecConfig(quality=90,
                                                   decode_index=True))):
        ops = tables.build(cfg, device=dev)
        got = transform_cuda.encode_blocks_kernel(px, cfg, ops)
        n_chain = int((got != testing.encode_fma_chain(px, cfg, ops)).sum())
        log(f"A {name}: {n_chain} mismatches of {got.numel()} against "
            "encode_fma_chain")
        check(n_chain == 0, f"A {name} differs from its float32 chain")
        _, err_a = tie_check(
            f"A {name}", got, transform.encode_blocks(px, cfg, ops),
            lambda b: testing.encode_values_f64(px_h[b], cfg, None),
            testing.ENCODE_TIE_TOL)
        zz_h = got.cpu().numpy()
        _, err_c = tie_check(
            f"C {name}", transform_cuda.decode_blocks_kernel(got, cfg, ops),
            transform.decode_blocks(got, cfg, ops),
            lambda b: testing.decode_values_f64(zz_h[b], cfg, None),
            testing.DECODE_TIE_TOL)
        del got, zz_h
        ops_t, _, _ = batch_tables(cfg, px, None, n_stripes, ops)
        err_b = max(check_b(name, cfg, px, None, n_stripes, ops_t)[2],
                    check_b(f"{name} top {band} stripes", cfg,
                            px[:band * BIG_W // 8], None, band, ops_t)[2])
        for k, e in (("encode_blocks", err_a), ("decode_blocks", err_c),
                     ("encode_stripes", err_b)):
            errs[k] = max(errs[k], e)
    p = cont.deserialize(containers["8K q90 index"]).planes[0]
    _, errs["entropy_decode"] = check_d(
        "8K q90 index container", p.stripes, p.block_bits,
        codec.hf.CanonicalTable(p.table_lengths), None, "category", 64, dev)
    return errs


def phase_sharded(dev, frame, vframes, main_runs) -> dict:
    """Phase 16: the sharded paths at world size 1 over NCCL in this
    process, against the unsharded card path, counted and timed. -> the
    inputs and outputs phase 17 holds its ranks to."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from dct_tpu_torch import CodecConfig
    from dct_tpu_torch.models import codec, color, rate_control as rc, video
    from dct_tpu_torch.parallel import mesh as meshlib
    from dct_tpu_torch.parallel import shard_encode as se
    from dct_tpu_torch.utils import image_io

    init_dir = tempfile.TemporaryDirectory()
    dist.init_process_group(
        "nccl", init_method=f"file://{init_dir.name}/init", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    mesh = meshlib.make_mesh()
    log(f"sharded: NCCL world size {dist.get_world_size()}, mesh "
        f"{meshlib.shape(mesh)} on {meshlib.device(mesh)}")
    t_ms = {}

    def synced(fn):
        def run():
            out = fn()
            torch.cuda.synchronize()
            return out
        return run

    # the batch step against encode_step, bit for bit
    static = CodecConfig(quality=50, static_tables=True, use_pallas=True)
    frames_d = torch.from_numpy(np.stack([
        image_io.synthetic_image(H, W, "photo", seed=s)
        for s in range(FRAMES)])).to(dev)
    n_stripes = H // 8
    got, c = counted(lambda: se.encode_batch_step(frames_d, static, n_stripes,
                                                  mesh), main_runs)
    want = codec.encode_step(frames_d, static, n_stripes)[0]
    same = (torch.equal(got.units, want.units)
            and torch.equal(got.bit_lengths, want.bit_lengths))
    log(f"sharded encode_batch_step {FRAMES} x {H}x{W}: units and bits "
        f"equal to encode_step: {same}; launches {c}")
    check(same and c["encode_stripes"] == 1,
          "encode_batch_step differs from encode_step")
    t_ms["encode_batch_step (CUDA events)"] = cuda_ms(
        lambda: se.encode_batch_step(frames_d, static, n_stripes, mesh), 10)
    t_ms["encode_step (CUDA events)"] = cuda_ms(
        lambda: codec.encode_step(frames_d, static, n_stripes), 10)
    del frames_d, got, want

    # where a sharded plane encode's time goes, beside the unsharded one
    stages = sharded_plane_stages(mesh, frame, CodecConfig(
        quality=90, decode_index=True), dev)
    log("sharded 1080p q90 index plane encode stages: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items()))

    big = image_io.synthetic_image(BIG_H, BIG_W, "photo", seed=8)
    rgb = rgb_of(frame)
    stack = vframes[:8]
    out = {"big": big, "rgb": rgb, "stack": stack}
    cases = (("8K q50", CodecConfig(quality=50, decode_index=False), big),
             ("8K q90 index", CodecConfig(quality=90, decode_index=True), big),
             ("1080p 420 q90 index", CodecConfig(quality=90, chroma="420",
                                                 decode_index=True), rgb))
    for name, cfg, src in cases:
        data, c = counted(lambda: se.encode_image_sharded(src, cfg, mesh),
                          main_runs)
        want = codec.encode(src, cfg, dev)
        log(f"sharded encode {name}: {len(data)} B (v{data[4]}), equal to "
            f"the unsharded card path: {data == want}; launches {c}")
        check(data == want, f"sharded encode {name} differs")
        check(c["encode_stripes"] >= 1 and c["encode_blocks"] >= 1,
              f"sharded encode {name} did not run kernels A and B")
        rec, c = counted(lambda: se.decode_image_sharded(data, mesh),
                         main_runs)
        unsharded = (color.ColorImageCodec(cfg, dev) if src.ndim == 3
                     else codec.ImageCodec(cfg, dev))
        ref = unsharded.decode_to_device(data)
        log(f"sharded decode {name}: pixels equal to the unsharded "
            f"decode: {torch.equal(rec, ref)}; launches {c}")
        check(rec.device.type == "cuda" and torch.equal(rec, ref),
              f"sharded decode {name} differs")
        check(c["decode_blocks"] >= 1
              and (c["entropy_decode"] >= 1) == (data[4] == 2),
              f"sharded decode {name} did not run kernels C (and D)")
        out[name] = data
        t_ms[f"encode {name}: sharded"] = host_ms(
            lambda: se.encode_image_sharded(src, cfg, mesh), 3)
        t_ms[f"encode {name}: unsharded"] = host_ms(
            lambda: codec.encode(src, cfg, dev), 3)
        t_ms[f"decode {name}: sharded"] = host_ms(synced(
            lambda: se.decode_image_sharded(data, mesh)), 3)
        t_ms[f"decode {name}: unsharded"] = host_ms(synced(
            lambda: unsharded.decode_to_device(data)), 3)
        del rec, ref

    # the kernels at the 8K shapes these paths gave them, against their
    # plain versions (launches here are not counted)
    out["8K errors"] = check_kernels_8k(dev, big, out)

    cfg = CodecConfig()
    streams, c = counted(lambda: video.VideoCodec(cfg, mesh=mesh).encode(
        stack), main_runs)
    want = video.VideoCodec(cfg, device=dev).encode(stack)
    log(f"sharded VideoCodec 8 x 1080p q50: streams equal to the unsharded "
        f"card path: {streams == want}; launches {c}")
    check(streams == want, "sharded video differs")
    check(c["encode_blocks"] == 1 and c["pack_chunks"] == 1,
          "the sharded one-chunk video did not run one A and one E launch")
    out["video"] = streams
    t_ms["VideoCodec 8 x 1080p: sharded"] = host_ms(
        lambda: video.VideoCodec(cfg, mesh=mesh).encode(stack), 3)
    t_ms["VideoCodec 8 x 1080p: unsharded"] = host_ms(
        lambda: video.VideoCodec(cfg, device=dev).encode(stack), 3)

    cfg = CodecConfig(quality=70)
    for name, fn in (("container_size", rc.container_size),
                     ("psnr_at_quality", rc.psnr_at_quality)):
        val, c = counted(lambda: fn(rgb, cfg, mesh=mesh), main_runs)
        want = fn(rgb, cfg, dev)
        log(f"sharded {name} RGB q70: {val!r}, unsharded {want!r}; "
            f"launches {c}")
        check(val == want, f"sharded {name} differs")
        out[name] = val
        t_ms[f"{name} RGB: sharded"] = host_ms(
            lambda: fn(rgb, cfg, mesh=mesh), 3)
        t_ms[f"{name} RGB: unsharded"] = host_ms(lambda: fn(rgb, cfg, dev), 3)

    dist.destroy_process_group()
    init_dir.cleanup()
    log("sharded (NCCL, world size 1): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in t_ms.items()))
    return out


def phase_two_ranks(kept, main_runs) -> None:
    """Phase 17: world size 2 over gloo, two spawned processes on the one
    card, at meshes (1, 2) and (2, 1): every rank's bytes and probe values
    equal phase 16's; their launches join the counts."""
    import tempfile

    from dct_tpu_torch import CodecConfig, testing
    from dct_tpu_torch.models import rate_control as rc
    from dct_tpu_torch.parallel import shard_encode as se

    jobs = [
        ("8K q50", se.encode_image_sharded,
         (kept["big"], CodecConfig(quality=50, decode_index=False)), {}),
        ("1080p 420 q90 index", se.encode_image_sharded,
         (kept["rgb"], CodecConfig(quality=90, chroma="420",
                                   decode_index=True)), {}),
        ("video", se.encode_video_sharded, (kept["stack"], CodecConfig()),
         {}),
        ("container_size", rc.container_size,
         (kept["rgb"], CodecConfig(quality=70)), {}),
        ("psnr_at_quality", rc.psnr_at_quality,
         (kept["rgb"], CodecConfig(quality=70)), {}),
    ]
    for shape in ((1, 2), (2, 1)):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            ranks = testing.run_mesh_jobs(2, shape, jobs, d, backend="gloo",
                                          device_type="cuda", timeout=600)
            wall = time.perf_counter() - t0
        for rank, res in enumerate(ranks):
            for name, r in res.items():
                main_runs.append(r["launches"])
                check(r["value"] == kept[name],
                      f"gloo mesh {shape} rank {rank}: {name} differs from "
                      "phase 16")
            log(f"gloo mesh {shape} rank {rank} (coordinate "
                f"{res['8K q50']['coordinate']}): every output equal to "
                "phase 16's; " + ", ".join(
                    f"{k} {1e3 * r['seconds']:.3f} ms {r['launches']}"
                    for k, r in res.items()))
        log(f"gloo mesh {shape}: two ranks on the card, {wall:.1f} s with "
            "start-up")


def run_cli(argv) -> tuple[int, str]:
    """dct_tpu_torch.cli.main(argv) in this process -> (exit code, what it
    printed); the printed lines are logged."""
    import contextlib
    import io

    from dct_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    out = buf.getvalue()
    for line in out.splitlines()[:3]:
        log(f"  cli {argv[0]}: {line}")
    return rc, out


def phase_cli(dev, vframes, main_runs, step_ms: float) -> None:
    """Phase 18: python -m dct_tpu_torch.cli's subcommands in this process
    (no --device: the card), counted: the four real PGMs of tests/data
    encoded at static q50, dynamic q50 and q90 with the index, each
    container equal to --device cpu's (ties excepted), decoded to the card
    library's pixels (within 1 of the CPU's), roundtrip's PSNR that of
    the decode; verify and repair of one flipped stripe; encode-video and
    decode-video of 8 frames of 1080p against VideoCodec, and
    --max-total-bytes between two rungs; bench beside phase 5's
    encode_step; then encode in a fresh process (python -m)."""
    import os
    import pathlib
    import tempfile

    import torch
    from dct_tpu_torch import CodecConfig
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models import codec, rate_control, video
    from dct_tpu_torch.utils import image_io, metrics

    t_phase = time.perf_counter()
    repo = pathlib.Path(__file__).resolve().parent
    pgms = sorted((repo / "tests" / "data").glob("*.pgm"))
    check(len(pgms) == 4, f"expected the 4 PGMs of tests/data, got {pgms}")
    n_before = len(main_runs)
    configs = {
        "static q50": (CodecConfig(quality=50, static_tables=True),
                       ["--quality", "50", "--static-tables"]),
        "dynamic q50": (CodecConfig(quality=50), ["--quality", "50"]),
        "q90 index": (CodecConfig(quality=90, decode_index=True),
                      ["--quality", "90", "--decode-index", "on"]),
    }
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        kept = {}
        for pgm in pgms:
            img = image_io.read_image(pgm)
            for name, (cfg, flags) in configs.items():
                tag = f"cli {pgm.name} {name}"
                out, cpu_out = d / "card.tpdc", d / "cpu.tpdc"
                (rc, _), enc = counted(lambda: run_cli(
                    ["encode", pgm, out] + flags), main_runs)
                check(rc == 0, f"{tag}: encode rc {rc}")
                check(run_cli(["encode", pgm, cpu_out, "--device", "cpu"]
                              + flags)[0] == 0, f"{tag}: CPU encode failed")
                data = out.read_bytes()
                same_or_ties(tag, data, cpu_out.read_bytes(), img)
                rec_path = d / "rec.pgm"
                (rc, _), dec = counted(lambda: run_cli(
                    ["decode", out, rec_path]), main_runs)
                check(rc == 0, f"{tag}: decode rc {rc}")
                rec = image_io.read_image(rec_path)
                lib = codec.decode(data, dev)
                err = int(np.abs(rec.astype(int)
                                 - codec.decode(data, "cpu")).max())
                check(np.array_equal(rec, lib),
                      f"{tag}: decode differs from the library's")
                check(err <= 1, f"{tag}: decode {err} from the CPU's")
                (rc, text), rt = counted(lambda: run_cli(
                    ["roundtrip", pgm] + flags), main_runs)
                psnr = metrics.psnr(lib, img)
                check(rc == 0 and text.startswith(f"PSNR {psnr:.2f} dB"),
                      f"{tag}: roundtrip does not print {psnr:.2f} dB")
                enc_ms = host_ms(lambda: codec.encode(img, cfg, dev), 5)
                dec_ms = host_ms(lambda: codec.decode(data, dev), 5)
                log(f"{tag}: {img.shape[1]}x{img.shape[0]}, {len(data)} B "
                    f"v{data[4]}, encode launches {enc}, decode {dec}, "
                    f"roundtrip {rt}; decode max |diff| vs CPU {err}; "
                    f"library encode {enc_ms:.3f} ms, decode {dec_ms:.3f} "
                    "ms (host clock)")
                if pgm.name == "hopper.pgm" and name == "q90 index":
                    kept["hopper"] = (pgm, data)

        # verify and repair: one stripe's first 8 bytes flipped
        pgm, data = kept["hopper"]
        hit = 40
        c = cont.deserialize(data)
        s = bytearray(c.planes[0].stripes[hit])
        for i in range(8):
            s[i] ^= 0xA5
        c.planes[0].stripes[hit] = bytes(s)
        bad, fixed = d / "bad.tpdc", d / "fixed.tpdc"
        bad.write_bytes(cont.serialize(c))
        rc, text = run_cli(["verify", bad])
        check(rc == 1 and f"CORRUPT stripes [{hit}]" in text,
              f"verify did not report exactly stripe {hit}")
        (rc, _), rep = counted(lambda: run_cli(
            ["repair", bad, pgm, "-o", fixed]), main_runs)
        check(rc == 0 and fixed.read_bytes() == data,
              "repair differs from the from-scratch bytes")
        rc, text = run_cli(["info", fixed])
        check(rc == 0 and json.loads(text)["planes"][0]["stripes"]
              == len(c.planes[0].stripes), "info of the repair failed")
        log(f"cli verify/repair: stripe {hit} flipped, reported, repaired "
            f"to the from-scratch bytes (launches {rep}); info parses it")

        # video: 8 frames of 1080p (seeds 0..7), q50
        stack = vframes[:8]
        npy, tpdv, back = d / "v.npy", d / "v.tpdv", d / "back.npy"
        np.save(npy, stack)
        cfg = CodecConfig(quality=50)
        (rc, _), venc = counted(lambda: run_cli(
            ["encode-video", npy, tpdv, "--quality", "50"]), main_runs)
        want = cont.serialize_streams(video.VideoCodec(cfg, device=dev)
                                      .encode(stack))
        check(rc == 0 and tpdv.read_bytes() == want,
              "encode-video differs from VideoCodec")
        (rc, _), vdec = counted(lambda: run_cli(
            ["decode-video", tpdv, back]), main_runs)
        check(rc == 0 and np.array_equal(np.load(back), video.VideoCodec(
            cfg, device=dev).decode(cont.deserialize_streams(want))),
            "decode-video differs from VideoCodec")
        wrapper = 8 + 4 * len(stack)
        s50, s60 = (int(rate_control.video_container_sizes(
            stack, cfg.replace(quality=q), device=dev).sum()) for q in (50, 60))
        budget = wrapper + (s50 + s60) // 2
        capped = d / "capped.tpdv"
        (rc, text), vrc = counted(lambda: run_cli(
            ["encode-video", npy, capped, "--max-total-bytes", budget]),
            main_runs)
        check(rc == 0 and "rate control: quality 50" in text
              and capped.read_bytes() == want,
              "encode-video --max-total-bytes did not choose q50's stream")
        log(f"cli video 8 x 1080p q50: {len(want)} B equal to VideoCodec's "
            f"(launches {venc}), decode-video equal ({vdec}); budget {budget} "
            f"B between q50 {s50 + wrapper} and q60 {s60 + wrapper}: q50 "
            f"({vrc})")

        # bench, beside phase 5's encode_step
        (rc, text), bch = counted(lambda: run_cli(
            ["bench", "--size", "1920x1088", "--frames", "8"]), main_runs)
        rate = float(text.split(" Mpix/s")[0])
        check(rc == 0 and np.isfinite(rate) and rate > 0,
              f"bench printed no rate: {text!r}")
        log(f"cli bench 8 x 1920x1088 static q50: {rate:.1f} Mpix/s; "
            f"phase 5 encode_step {FRAMES * H * W / step_ms / 1e3:.1f} "
            f"Mpix/s ({step_ms:.4f} ms); launches {bch}")

        # a fresh process: python -m dct_tpu_torch.cli
        mri = repo / "tests" / "data" / "mri.pgm"
        sub_out, in_out = d / "sub.tpdc", d / "in.tpdc"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dct_tpu_torch.cli", "encode", str(mri),
             str(sub_out), "--static-tables"], cwd=repo, capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(repo)))
        check(proc.returncode == 0, f"python -m dct_tpu_torch.cli encode: "
              f"rc {proc.returncode}: {proc.stderr[-2000:]}")
        run_cli(["encode", mri, in_out, "--static-tables"])
        check(sub_out.read_bytes() == in_out.read_bytes(),
              "python -m dct_tpu_torch.cli encode differs in a fresh process")
        log(f"cli in a fresh process: {proc.stdout.strip()} "
            f"({time.perf_counter() - t0:.1f} s with start-up)")
    torch.cuda.synchronize()
    for k in ("encode_blocks", "encode_stripes", "decode_blocks",
              "entropy_decode"):
        check(any(run[k] for run in main_runs[n_before:]),
              f"{k} not launched through the CLI")
    log(f"phase 18 (the CLI): {time.perf_counter() - t_phase:.1f} s")


def example_lines(path, argv) -> tuple[list[str], list[str]]:
    """An example's main(argv) in this process -> (every line it printed,
    the lines held to the other device's run: the backend line and the
    ingest rate left out)."""
    import contextlib
    import io
    import runpy

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = runpy.run_path(str(path))["main"](argv)
    check(rc == 0, f"{path.name} {argv}: rc {rc}")
    lines = buf.getvalue().splitlines()
    return lines, [re.sub(r"\s*[\d.]+ Mpix/s wall$", " Mpix/s wall", line)
                   for line in lines if not line.startswith("backend:")]


# Phase 19's damaged containers: (config, gray and 4:2:0); the 4:2:0
# image is the gray one and two shifted copies (rgb_of's construction).
DAMAGE_CONFIGS = (
    dict(quality=50), dict(quality=50, coded_runs=True),
    dict(quality=80, huffman_mode="direct"), dict(quality=50, use_huffman=False),
    dict(quality=30, block_size=16), dict(quality=90, decode_index=True),
    dict(quality=50, adaptive=True, dc_prediction=True, coded_runs=True,
         decode_index=True))
DAMAGE_MUTATIONS = 40


def phase_examples(dev, main_runs) -> None:
    """Phase 19: the port's examples on the card against their --device
    cpu runs, counted; then damaged v2 containers: kernel D's
    coefficients and status against its plain version on every indexed
    plane, and each container's fate on the card against the CPU's."""
    import dataclasses
    import pathlib

    import torch
    from dct_tpu_torch import CodecConfig, testing
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import entropy_decode as ed
    from dct_tpu_torch.ops import entropy_decode_cuda
    from dct_tpu_torch.ops import huffman as hf
    from dct_tpu_torch.utils import image_io

    t_phase = time.perf_counter()
    repo = pathlib.Path(__file__).resolve().parent
    n_before = len(main_runs)
    for name in ("torch_demo.py", "torch_serving.py"):
        path = repo / "examples" / name
        (lines, card), counts = counted(lambda: example_lines(path, []),
                                        main_runs)
        _, cpu = example_lines(path, ["--device", "cpu"])
        for line in lines:
            log(f"  {name}: {line}")
        log(f"{name} on the card: launches {counts}; every line equal to "
            f"--device cpu's: {card == cpu}")
        check(card == cpu, f"{name} prints other numbers on the card than "
              f"on the CPU: {card} != {cpu}")
    for k in ("encode_blocks", "encode_stripes", "decode_blocks",
              "entropy_decode", "pack_chunks"):
        check(any(run[k] for run in main_runs[n_before:]),
              f"{k} not launched by the examples")

    n = {"containers": 0, "v2 planes": 0, "flagged": 0, "rejected": 0}
    redecodes = codec.HOST_REDECODES["planes"]
    for ci, kw in enumerate(DAMAGE_CONFIGS):
        rng = np.random.default_rng(ci)
        gray = image_io.synthetic_image(48, 72, "photo", seed=ci)
        for chroma, img in (("gray", gray), ("420", rgb_of(gray))):
            cfg = CodecConfig(**kw, **({} if chroma == "gray"
                                       else {"chroma": chroma}))
            data = codec.encode(img, cfg, dev)
            for m in testing.damaged_containers(data, rng, DAMAGE_MUTATIONS):
                n["containers"] += 1
                try:
                    c = cont.deserialize(m)
                    planes = [p for p in c.planes if p.block_bits is not None]
                except ValueError:
                    planes = []
                flagged = False
                for p in planes:
                    mode = (c.config.huffman_mode if c.config.use_huffman
                            else "none")
                    try:
                        table = (hf.CanonicalTable(p.table_lengths)
                                 if mode != "none" else None)
                        runs = (hf.CanonicalTable(p.run_table_lengths)
                                if c.config.coded_runs else None)
                    except ValueError:
                        continue
                    if not codec.indexed_decode_ok(p, c.config, table, runs):
                        continue
                    n["v2 planes"] += 1
                    args = (p.stripes, p.block_bits, table, runs, mode,
                            c.config.n2)
                    got = entropy_decode_cuda.decode_blocks_kernel(
                        **codec.indexed_operands(*args, dev, status=True))
                    want = ed.decode_blocks_plain(
                        **codec.indexed_operands(*args, "cpu", status=True))
                    check(all(torch.equal(g.cpu(), w)
                              for g, w in zip(got, want)),
                          f"D differs from its plain version on damaged "
                          f"container {n['containers']} ({ci}, {chroma})")
                    flagged |= bool(want[1].any())
                n["flagged"] += flagged
                card = testing.decode_fate(lambda: codec.decode(m, dev))
                cpu = testing.decode_fate(lambda: codec.decode(m, "cpu"))
                what = f"damaged container {n['containers']} ({ci}, {chroma})"
                check(card[0] == cpu[0],
                      f"{what}: card {card[0]}, cpu {cpu[0]}: {card[1]!s:.200}"
                      f" / {cpu[1]!s:.200}")
                if card[0] != "ok":
                    n["rejected"] += 1
                    continue
                # the card's pixels are its host route's (the host
                # decoder's coefficients, then kernel C) exactly, and the
                # CPU's within 1 (decode ties)
                v1 = cont.deserialize(m)
                v1 = dataclasses.replace(
                    v1, config=v1.config.replace(decode_index=False),
                    planes=[dataclasses.replace(p, block_bits=None)
                            for p in v1.planes])
                host = codec.decode(cont.serialize(v1), dev)
                err = int(np.abs(card[1].astype(int) - cpu[1]).max())
                check(np.array_equal(card[1], host) and err <= 1,
                      f"{what}: pixels differ from the card's host route or "
                      f"by {err} from the CPU's")
    redecodes = codec.HOST_REDECODES["planes"] - redecodes
    log(f"damaged containers: {n['containers']} containers, {n['v2 planes']} "
        f"indexed planes, {n['flagged']} flagged, {n['rejected']} rejected; "
        f"planes decoded again on the host {redecodes} (card and CPU runs)")
    check(redecodes >= 1, "no flagged plane went to the host decoder")
    log(f"phase 19 (examples, damaged containers): "
        f"{time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import dataclasses

    from dct_tpu_torch import CodecConfig, native, tables, testing
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models import codec, video
    from dct_tpu_torch.ops import _build, blocks, bitstream as bs, rle
    from dct_tpu_torch.ops import entropy_decode as ed
    from dct_tpu_torch.ops import entropy_decode_cuda, fused_encode_cuda
    from dct_tpu_torch.ops import pack_cuda, transform, transform_cuda
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
        if name == "transform":  # kernels A and C, one line a template
            for kind, n2, ad, spill, used in re.findall(
                    r"entry function '\w*?(encode|decode)_blocks_kernelILi"
                    r"(\d+)ELb(\d).*?(\d+) bytes spill stores.*?Used (\d+) "
                    r"registers", text, re.S):
                log(f"    {kind} n2={n2} adaptive={ad}: {used} registers, "
                    f"{spill} bytes spill stores")
        if name == "fused_encode":  # kernel B, one line a template
            for n2, spill, used in re.findall(
                    r"entry function '\w*?encode_stripes_kernelILi(\d+)E.*?"
                    r"(\d+) bytes spill stores.*?Used (\d+) registers", text,
                    re.S):
                log(f"    encode_stripes n2={n2}: {used} registers, {spill} "
                    f"bytes spill stores")

    imma = imma_counts(("transform", "fused_encode"))
    for fn, n in imma.items():
        # kernels A and B (C, D and the variance kernel do no integer
        # products on the tensor cores)
        if "encode_blocks" in fn or "encode_stripes" in fn:
            log(f"IMMA instructions in {fn}: {n}")
            check(n > 0, f"{fn} has no integer tensor-core instructions")
    for n2 in fused_encode_cuda.KERNEL_N2:  # kernel B's persistent grid
        info = fused_encode_cuda.kernel_info(n2, dev)
        stripes = FRAMES * H // {16: 4, 64: 8, 256: 16}[n2]  # the batch's
        most, mean = fused_encode_cuda.stripes_per_cta(stripes, info)
        log(f"B n2={n2}: {info['threads'] // 32} warps a CTA (each runs "
            f"the transform, then the entropy rounds), {info['registers']} "
            f"registers a thread, {info['ctas_per_sm']} CTAs an SM x "
            f"{info['sms']} SMs, {info['shared_bytes']} B shared memory a "
            f"CTA, tiles of {info['tile_blocks']} blocks, "
            f"{info['local_bytes']} B local (spills); at the batch's "
            f"{stripes} stripes {most} / {mean:.3f} stripes a CTA (most / "
            f"mean)")
        check(info["local_bytes"] == 0, f"B n2={n2} spills registers")
    # the tensor-core tile's integer products, before A and B rely on them
    for n in (2, 4, 8, 16):
        cfg = CodecConfig(block_size=n, quality=90)
        ops = tables.build(cfg, device=dev)
        p = tables.mma_width(cfg.n2)
        w, _ = tables.certificate_operator(
            *(m[:cfg.n2, :cfg.n2].cpu().numpy()
              for m in (ops.m0, ops.m1, ops.m2)))
        w_bd = torch.block_diag(*[torch.from_numpy(w)] * (p // cfg.n2))
        rows = torch.from_numpy(np.random.default_rng(n).integers(
            0, 256, (4097, p), dtype=np.uint8))
        rows[0] = 255
        got = transform_cuda.mma_products(rows.to(dev), ops, cfg.n2).cpu()
        same = torch.equal(got, rows.to(torch.int64) @ w_bd)
        log(f"tile products n2={cfg.n2} ({rows.shape[0]} rows of {p}): equal "
            f"to int64 x @ W: {same}")
        check(same, f"tile products differ at n2={cfg.n2}")

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
    codec.reset_host_redecodes()
    _build.reset_launch_counts()
    containers, recs = {}, {}
    for name, cfg in (("static", static), ("dynamic", dynamic)):
        gpu = codec.ImageCodec(cfg, device=dev)
        containers[name] = gpu.encode(frame)
        recs[name] = (gpu.decode(containers[name]),
                      gpu.decode_to_device(containers[name]))
    packed, _, _ = codec.encode_step(frames_d, static, n_stripes)
    batch_bits = packed.bit_lengths.sum().item()  # waits for the batch
    # the adaptive cell's entry: one variance pass and one B a call
    packed, _, _ = codec.encode_step(frames_d, dataclasses.replace(
        static, adaptive=True), n_stripes)
    adaptive_bits = packed.bit_lengths.sum().item()
    launches = dict(_build.LAUNCHES)
    main_runs = [launches]  # the launch counts of every main-path run
    log(f"main path launches {launches}; batch payload {batch_bits} bits, "
        f"adaptive {adaptive_bits}")
    for k in ("encode_blocks", "encode_stripes", "decode_blocks",
              "variance_codes"):
        check(launches[k] > 0, f"{k} not launched on the main path")

    log(f"host entropy decoder: {codec.host_decoder()}")
    for name, cfg in (("static", static), ("dynamic", dynamic)):
        data = containers[name]
        same_or_ties(f"e2e {name}", data,
                     codec.ImageCodec(cfg, device="cpu").encode(frame), frame)
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
    q100 = CodecConfig(quality=100, static_tables=True)
    for cfg in (static, rich, q100):
        ops = tables.build(cfg, device=dev)
        _, scale = codec._adaptive(px, cfg)
        recip = None if scale is None else transform.reciprocal_scale(scale)
        recip_h = None if recip is None else recip.cpu().numpy()
        _build.reset_rescued()
        got = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
        n_chain = int((got != testing.encode_fma_chain(px, cfg, ops,
                                                       recip)).sum())
        log(f"A adaptive={cfg.adaptive}: {n_chain} mismatches of "
            f"{got.numel()} against encode_fma_chain; "
            f"{rescue_share('encode_blocks', px, cfg, ops, scale)}")
        check(n_chain == 0, "A differs from the float32 chain it promises")
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

        def dvals(b):
            return testing.decode_values_f64(
                zz_h[b], cfg, None if scale_h is None else scale_h[b])

        tie_check(f"C adaptive={cfg.adaptive} vs decode_fma_chain", dec,
                  testing.decode_fma_chain(got, cfg, ops, scale), dvals,
                  testing.DECODE_TIE_TOL)
        res_c = tie_check(f"C adaptive={cfg.adaptive}", dec, dref, dvals,
                          testing.DECODE_TIE_TOL)
        if cfg is static:
            results["encode_blocks"], results["decode_blocks"] = res_a, res_c
            zz_main = got
        if cfg is q100:  # the rescue's cost: q50's blocks, ~60x the rescues
            a100_ms = cuda_ms(lambda: transform_cuda.encode_blocks_kernel(
                px, cfg, ops), 20)
            log(f"time encode_blocks static q100: kernel {a100_ms:.4f} ms")
    # kernel A at 16x16 blocks, on the n2 = 256 tile it shares with B (the
    # 16x16 decode has no kernel: the codec runs the float32 product)
    px16 = blocks.image_to_blocks(frames_d, 16).reshape(-1, 256)
    px16_h = px16.cpu().numpy()
    for cfg in (CodecConfig(block_size=16, quality=90),
                CodecConfig(block_size=16, quality=50, adaptive=True)):
        ops = tables.build(cfg, device=dev)
        _, scale = codec._adaptive(px16, cfg)
        recip = None if scale is None else transform.reciprocal_scale(scale)
        recip_h = None if recip is None else recip.cpu().numpy()
        _build.reset_rescued()
        got = transform_cuda.encode_blocks_kernel(px16, cfg, ops, scale)
        n_chain = int((got != testing.encode_fma_chain(px16, cfg, ops,
                                                       recip)).sum())
        log(f"A 16x16 q{cfg.quality} adaptive={cfg.adaptive}: {n_chain} "
            f"mismatches of {got.numel()} against encode_fma_chain; "
            f"{rescue_share('encode_blocks', px16, cfg, ops, scale)}")
        check(n_chain == 0, "A at 16x16 differs from the float32 chain")
        tie_check(f"A 16x16 adaptive={cfg.adaptive}", got,
                  transform.encode_blocks(px16, cfg, ops, scale),
                  lambda b: testing.encode_values_f64(
                      px16_h[b], cfg, None if recip_h is None else recip_h[b]),
                  testing.ENCODE_TIE_TOL)
    a16_ms = cuda_ms(lambda: transform_cuda.encode_blocks_kernel(
        px16, cfg, ops, scale), 20)
    a16_plain = cuda_ms(lambda: transform.encode_blocks(px16, cfg, ops,
                                                        scale), 20)
    nb16 = px16.shape[0]
    a16_bound = bound_ms(nb16 * (256 * 5 + 4) + operator_bytes(ops),
                         a_b_ops(nb16, 256), INT8_OPS)
    log(f"time encode_blocks 16x16 adaptive: kernel {a16_ms:.4f} ms, plain "
        f"{a16_plain:.4f} ms, bound {a16_bound[0]:.5f} ms ({a16_bound[1]}), "
        f"{nb16} blocks")
    del px16, px16_h
    s_all = FRAMES * n_stripes
    for name, cfg in (("static", static), ("dynamic", dynamic),
                      ("adaptive+dc+coded_runs", rich)):
        _, scale = codec._adaptive(px, cfg)
        ops, _, _ = batch_tables(cfg, px, scale, s_all,
                                 tables.build(cfg, device=dev))
        _, _, err = check_b(name, cfg, px, scale, s_all, ops, frames_d)
        if cfg is static:
            results["encode_stripes"] = (0, err)
    # the other configs B takes, each timed beside its plain version and
    # its bound (the B row of the kernel table stays static q50 at 8x8,
    # comparable with earlier measurements)
    b_configs = {
        "n4 category dynamic": CodecConfig(block_size=4),
        "n4 direct": CodecConfig(block_size=4, huffman_mode="direct"),
        "n4 none": CodecConfig(block_size=4, use_huffman=False),
        "n8 direct q90": CodecConfig(quality=90, huffman_mode="direct"),
        "n8 none": CodecConfig(use_huffman=False),
        "n8 direct adaptive+dc+coded_runs": CodecConfig(
            quality=50, huffman_mode="direct", adaptive=True,
            dc_prediction=True, coded_runs=True),
        "n16 category q90": CodecConfig(block_size=16, quality=90),
        "n16 direct": CodecConfig(block_size=16, huffman_mode="direct"),
        "n16 none": CodecConfig(block_size=16, use_huffman=False),
    }
    px_of = {8: px}
    for name, cfg in b_configs.items():
        n = cfg.block_size
        if n not in px_of:
            px_of[n] = blocks.image_to_blocks(frames_d, n).reshape(-1, n * n)
        pxn, ns = px_of[n], FRAMES * H // n
        _, scale = codec._adaptive(pxn, cfg)
        ops, _, _ = batch_tables(cfg, pxn, scale, ns,
                                 tables.build(cfg, device=dev))
        packed, _, _ = check_b(name, cfg, pxn, scale, ns, ops, frames_d)
        recip = None if scale is None else transform.reciprocal_scale(scale)
        b_ms = cuda_ms(lambda: fused_encode_cuda.encode_stripes_fused(
            pxn, cfg, ns, ops, adaptive_recip=recip), 10)
        plain_ms = cuda_ms(lambda: fused_encode_cuda.encode_stripes_plain(
            pxn, cfg, ns, ops, adaptive_recip=recip), 3)
        nb, n2 = pxn.shape
        b_bound = bound_ms(b_bytes(nb, n2, cfg, ops, ns), a_b_ops(nb, n2),
                           INT8_OPS)
        log(f"time encode_stripes {name}: kernel {b_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_bound[0]:.5f} ms ({b_bound[1]}; "
            f"kernel at {100 * b_bound[0] / b_ms:.1f} %), {nb} blocks of "
            f"{n2}, {ns} stripes")
        del packed
    del px_of
    # the adaptive encode's variance pass, one kernel: the 8-frame batch
    # and 32 planes (four shifted copies each), at 8x8 and the other sizes
    adaptive = CodecConfig(quality=50, static_tables=True, adaptive=True)
    shifted = [torch.roll(frames_d, 37 * k, -1) for k in range(4)]
    var_ms, var_plain_ms, var_bound, var_err = check_variance(
        "8 planes 8x8", shifted, adaptive)
    check_variance("32 planes 8x8", [torch.cat(shifted), torch.cat(
        [torch.roll(f, 11, -2) for f in shifted])], adaptive)
    for n in (4, 16):
        check_variance(f"8 planes {n}x{n}", shifted, dataclasses.replace(
            adaptive, block_size=n))
    del shifted

    # ---- 5. times --------------------------------------------------------
    ops = tables.build(static, device=dev)
    zz_main16 = zz_main.to(torch.int16)
    times = {
        "encode_blocks": (
            cuda_ms(lambda: transform_cuda.encode_blocks_kernel(
                px, static, ops), 20),
            cuda_ms(lambda: transform.encode_blocks(px, static, ops), 20)),
        # B from the planes, the route encode_step takes
        "encode_stripes": (
            cuda_ms(lambda: fused_encode_cuda.encode_plane_stripes_fused(
                frames_d, static, s_all, ops), 20),
            cuda_ms(lambda: fused_encode_cuda.encode_stripes_plain(
                px, static, s_all, ops), 5)),
        # int16, the coefficients' type on the decode path (kernel D and
        # the host decoder give it)
        "decode_blocks": (
            cuda_ms(lambda: transform_cuda.decode_blocks_kernel(
                zz_main16, static, ops), 20),
            cuda_ms(lambda: transform.decode_blocks(zz_main16, static, ops),
                    20)),
    }
    for k, (ms, plain) in times.items():
        log(f"time {k}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"(8 x {H}x{W})")
    # the card's work alone, the batches in turn (check_variance)
    times["variance_codes"] = (var_ms, var_plain_ms)
    results["variance_codes"] = (0, var_err)
    b_dev_ms, b_enq_ms = device_ms(
        lambda: fused_encode_cuda.encode_plane_stripes_fused(
            frames_d, static, s_all, ops), 50)
    log(f"time encode_stripes from the planes, the card's work alone: "
        f"{b_dev_ms:.4f} ms; host enqueue {b_enq_ms:.4f} ms a call; 20 "
        f"back-to-back calls {times['encode_stripes'][0]:.4f} ms a call")
    # B on the (NB, n2) blocks, the block-major entry
    block_ms = cuda_ms(lambda: fused_encode_cuda.encode_stripes_fused(
        px, static, s_all, ops), 20)
    block_dev_ms, block_enq_ms = device_ms(
        lambda: fused_encode_cuda.encode_stripes_fused(px, static, s_all, ops),
        50)
    log(f"time encode_stripes on the blocks: 20 back-to-back calls "
        f"{block_ms:.4f} ms a call, the card's work alone {block_dev_ms:.4f} "
        f"ms, host enqueue {block_enq_ms:.4f} ms a call")
    a_dev_ms, a_enq_ms = device_ms(
        lambda: transform_cuda.encode_blocks_kernel(px, static, ops), 50)
    log(f"time encode_blocks, the card's work alone: {a_dev_ms:.4f} ms; "
        f"host enqueue {a_enq_ms:.4f} ms a call; 20 back-to-back calls "
        f"{times['encode_blocks'][0]:.4f} ms a call")
    _build.reset_rescued()
    transform_cuda.encode_blocks_kernel(px, static, ops)
    log(f"rescue a call, static q50: A "
        f"{rescue_share('encode_blocks', px, static, ops, None)}")
    _build.reset_rescued()
    fused_encode_cuda.encode_stripes_fused(px, static, s_all, ops)
    log(f"rescue a call, static q50: B "
        f"{rescue_share('encode_stripes', px, static, ops, None)}")
    # A's library time: one cuBLAS call computing its products only, the
    # pixels as bf16 times the four byte planes side by side as bf16,
    # float32 out (exact: every partial sum is an integer below 2^24)
    w8, _ = tables.certificate_operator(*(m[:64, :64].cpu().numpy()
                                          for m in (ops.m0, ops.m1, ops.m2)))
    planes = torch.from_numpy(np.concatenate(list(tables.byte_planes(w8)),
                                             axis=1)).to(dev, torch.bfloat16)
    px_bf = px.to(torch.bfloat16)
    lib_prod = torch.mm(px_bf, planes, out_dtype=torch.float32)
    lib_s = sum(lib_prod[:, 64 * l:64 * (l + 1)].to(torch.int64) << 8 * l
                for l in range(4))
    tile_s = transform_cuda.mma_products(px.reshape(-1, 64), ops, 64)
    check(torch.equal(lib_s, tile_s),
          "the cuBLAS plane products differ from the tile's")
    a_library_ms = cuda_ms(lambda: torch.mm(px_bf, planes,
                                            out_dtype=torch.float32), 20)
    log(f"time encode_blocks library (cuBLAS bf16 ({px.shape[0]}, 64) @ "
        f"(64, 256), float32 out; products only, equal to the tile's): "
        f"{a_library_ms:.4f} ms")
    del lib_prod, lib_s, tile_s, px_bf
    # C's library time, on the same footing: one cuBLAS float32 product of
    # the coefficients (as float32) and the 64 x 64 decode operator, TF32
    # off; products only (no dequant scale, +128, rounding or clamp)
    zz_f32 = zz_main16.to(torch.float32)
    m_dec = ops.m_dec[:64, :64].contiguous()
    c_library_ms = cuda_ms(lambda: torch.mm(zz_f32, m_dec), 20)
    log(f"time decode_blocks library (cuBLAS float32 ({zz_f32.shape[0]}, 64) "
        f"@ (64, 64); products only): {c_library_ms:.4f} ms")
    del zz_f32
    c32_ms = cuda_ms(lambda: transform_cuda.decode_blocks_kernel(
        zz_main, static, ops), 20)
    log(f"time decode_blocks on A's int32 coefficients (the wrapper narrows "
        f"them to int16 first): {c32_ms:.4f} ms")
    step_ms = cuda_ms(lambda: codec.encode_step(frames_d, static, n_stripes),
                      20)
    step_dev_ms, step_enq_ms = device_ms(
        lambda: codec.encode_step(frames_d, static, n_stripes), 50)
    log(f"encode_step 8 x {H}x{W} static q50: {step_ms:.4f} ms = "
        f"{FRAMES * H * W / step_ms / 1e3:.1f} Mpix/s (20 back-to-back "
        f"calls); the card's work alone {step_dev_ms:.4f} ms, host enqueue "
        f"{step_enq_ms:.4f} ms a call")
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
    zz1 = testing.coefficients(containers["static"])
    zz1_d = torch.from_numpy(zz1).to(dev)
    bh1, bw1, ns1 = codec._padded_grid(*frame.shape, static)
    rec_d = codec.blk.blocks_to_image(transform_cuda.decode_blocks_kernel(
        zz1_d, static, ops), bh1 * 8, bw1 * 8, 8)[:frame.shape[0]]
    plane1 = codec.pad_plane_for_encode(torch.from_numpy(frame).to(dev),
                                        static)
    stages = {
        "parse+entropy decode": host_ms(
            lambda: testing.coefficients(containers["static"]), 10),
        "upload coefficients": host_ms(
            lambda: (zz1_d.copy_(torch.from_numpy(zz1)),
                     torch.cuda.synchronize()), 10),
        "kernel C": cuda_ms(lambda: transform_cuda.decode_blocks_kernel(
            zz1_d, static, ops), 20),
        "download pixels": host_ms(lambda: rec_d.cpu(), 10),
        "encode kernel B": cuda_ms(
            lambda: fused_encode_cuda.encode_plane_stripes_fused(
                plane1, static, ns1, ops), 20),
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
    main_runs.append(launches90)
    log(f"main path q90 launches {launches90}")
    check(data90[4] == 2, f"the q90 1080p container is v{data90[4]}, not v2")
    for k in ("encode_blocks", "encode_stripes", "decode_blocks",
              "entropy_decode"):
        check(launches90[k] > 0, f"{k} not launched on the q90 main path")
    same_or_ties("e2e q90", data90,
                 codec.ImageCodec(q90, device="cpu").encode(frame), frame)

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
    d_operands = {}
    for name, cfg in (
            ("static q90", CodecConfig(quality=90, static_tables=True,
                                       decode_index=True)),
            ("adaptive+dc+coded_runs", rich.replace(decode_index=True))):
        _, scale = codec._adaptive(px, cfg)
        ops, table, run_table = batch_tables(cfg, px, scale, s_all,
                                             tables.build(cfg, device=dev))
        packed, bb = fused_encode_cuda.encode_stripes_fused(
            px, cfg, s_all, ops, adaptive_recip=None if scale is None
            else transform.reciprocal_scale(scale))
        d_operands[name] = check_d(
            f"batch {name}", bs.stripes_to_bytes(bs.fetch_packed(packed)),
            bb.cpu().numpy().reshape(-1).astype(np.uint16), table, run_table,
            "category", 64, dev)
    results["entropy_decode"] = (0, d_operands["static q90"][1])
    # streams in the staged modes, from the card encoder (kernels A, E)
    for mode, cfg in (("none", CodecConfig(use_huffman=False,
                                           decode_index=True)),
                      ("direct", CodecConfig(quality=90, huffman_mode="direct",
                                             decode_index=True))):
        p_s = cont.deserialize(codec.ImageCodec(cfg, device=dev).encode(
            frame)).planes[0]
        check_d(f"1080p {mode}", p_s.stripes, p_s.block_bits,
                None if mode == "none" else codec.hf.CanonicalTable(
                    p_s.table_lengths), None, mode, 64, dev)

    # ---- 8. times of the indexed decode ---------------------------------
    ops_d = d_operands["static q90"][0]
    # with the status, as the decode path calls it (its zeros uploaded with
    # the operands); without it, the coefficients alone
    ops_d_bare = {k: v for k, v in ops_d.items() if k != "status"}
    times["entropy_decode"] = (
        cuda_ms(lambda: entropy_decode_cuda.decode_blocks_kernel(**ops_d), 20),
        cuda_ms(lambda: ed.decode_blocks_plain(**ops_d), 3))
    d_bare_ms = cuda_ms(lambda: entropy_decode_cuda.decode_blocks_kernel(
        **ops_d_bare), 20)
    log(f"time entropy_decode: kernel {times['entropy_decode'][0]:.4f} ms "
        f"with the status, {d_bare_ms:.4f} ms without; plain "
        f"{times['entropy_decode'][1]:.4f} ms (8 x {H}x{W}, static "
        f"q90, {ops_d['block_bits'].numel()} blocks)")
    for name, ops in (("with the status", ops_d), ("without", ops_d_bare)):
        dev_ms, enq_ms = device_ms(
            lambda: entropy_decode_cuda.decode_blocks_kernel(**ops), 50)
        log(f"time entropy_decode {name}, the card's work alone: "
            f"{dev_ms:.4f} ms; host enqueue {enq_ms:.4f} ms a call")
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
    ops90 = codec.indexed_operands(p90.stripes, p90.block_bits, table90,
                                     None, "category", 64, dev, status=True)
    zz90, _ = entropy_decode_cuda.decode_blocks_kernel(**ops90)
    zz90_h = testing.coefficients(data90)
    ops_q90 = tables.build(q90, device=dev)
    stages90 = {
        "parse": host_ms(lambda: cont.deserialize(data90), 10),
        # D's operands as the decode path builds them: the stripe starts and
        # the packed tables on the host, then one upload (D scans the
        # index into block starts itself)
        "operands (stripe starts, tables, upload)": host_ms(
            lambda: (codec.indexed_operands(
                p90.stripes, p90.block_bits, table90, None, "category", 64,
                dev, status=True), torch.cuda.synchronize()), 10),
        "kernel D (with the status)": cuda_ms(
            lambda: entropy_decode_cuda.decode_blocks_kernel(**ops90), 20),
        "kernel C": cuda_ms(lambda: transform_cuda.decode_blocks_kernel(
            zz90, q90, ops_q90), 20),
        "download pixels": host_ms(lambda: rec90_d.cpu(), 10),
        "host route: parse+entropy decode": host_ms(
            lambda: testing.coefficients(data90), 10),
        "host route: upload coefficients": host_ms(
            lambda: (torch.from_numpy(zz90_h).to(dev),
                     torch.cuda.synchronize()), 10),
    }
    log("1080p q90 stages: " + ", ".join(f"{k} {v:.4f} ms"
                                         for k, v in stages90.items()))

    # ---- 9. kernel E against its plain version -----------------------
    def check_e(name, cv, cl, capacity):
        got = pack_cuda.pack_chunks_kernel(cv, cl, capacity)
        want = bs.pack_chunks(cv, cl, capacity)
        diff = (got.units.to(torch.int32) & 0xFFFF) - want.units
        err = int(diff.abs().max()) if diff.numel() else 0
        same = err == 0 and torch.equal(got.bit_lengths, want.bit_lengths)
        log(f"E {name}: {cv.shape[0]} stripes x {cv.shape[1] * 3} chunks "
            f"{cv.dtype}, {int(want.bit_lengths.sum())} bits, capacity "
            f"{capacity} units; units and stripe bits equal to plain: {same}")
        check(same, f"E {name} differs from its plain version")
        return err

    e_inputs = None
    for name, cfg in (("static q50", static), ("adaptive+dc+coded_runs", rich)):
        _, scale = codec._adaptive(px, cfg)
        ops, _, _ = batch_tables(cfg, px, scale, s_all,
                                 tables.build(cfg, device=dev))
        zz = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
        if cfg.dc_prediction:
            zz = codec.dc_predict(zz, s_all)
        cv, cl, capacity, _ = codec._stripe_chunks(
            rle.rle_encode_positional(zz), cfg, s_all, ops)
        err = check_e(f"batch {name}", cv, cl, capacity)
        if cfg is static:
            e_inputs, results["pack_chunks"] = (cv, cl, capacity), (0, err)
        del zz, cv, cl
    # random chunks: 60 % dead (with junk values), stripes live over
    # uneven lengths, an all-dead stripe, one filled exactly to the (odd)
    # capacity and one past it
    rng = np.random.default_rng(9)
    rs, rc = 64, 1500
    cl_r = rng.integers(1, 17, (rs, rc, 3))
    cl_r[rng.random((rs, rc, 3)) < 0.6] = 0
    for st in range(rs):
        cl_r[st, rc * (st + 1) // rs:] = 0
    cap_r = rc * 3 - 7
    cl_r[0] = 0
    cl_r[1] = 16
    cl_r[2] = 0
    cl_r[2].reshape(-1)[:cap_r] = 16
    cv_r = rng.integers(0, 1 << 16, (rs, rc, 3))
    cv_r = np.where(cl_r > 0, cv_r & ((1 << cl_r) - 1), cv_r)
    cv_r, cl_r = (torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in (cv_r, cl_r))
    check_e("random", cv_r, cl_r, cap_r)
    times["pack_chunks"] = (
        cuda_ms(lambda: pack_cuda.pack_chunks_kernel(*e_inputs), 20),
        cuda_ms(lambda: bs.pack_chunks(*e_inputs), 5))
    log(f"time pack_chunks: kernel {times['pack_chunks'][0]:.4f} ms, plain "
        f"{times['pack_chunks'][1]:.4f} ms (8 x {H}x{W}, static q50, "
        f"{e_inputs[0].numel()} chunks)")

    # ---- 10. the other image configs, counted ---------------------------
    # (the staged path's configs until kernel B took them: now the analyze
    # pass, kernel A, then kernel B with the per-image table)
    staged = {"n4 category dynamic": CodecConfig(block_size=4),
              "none": CodecConfig(use_huffman=False),
              "direct q90": CodecConfig(quality=90, huffman_mode="direct"),
              "stripe_rows=4": CodecConfig(stripe_rows=4)}
    for name, cfg in staged.items():
        gpu_s = codec.ImageCodec(cfg, device=dev)
        _build.reset_launch_counts()
        data = gpu_s.encode(frame)
        rec = gpu_s.decode(data)
        rec_d = gpu_s.decode_to_device(data)
        torch.cuda.synchronize()
        counted = dict(_build.LAUNCHES)
        main_runs.append(counted)
        log(f"main path {name} launches {counted}")
        check(counted["encode_blocks"] == 1
              and counted["encode_stripes"] == 1
              and counted["pack_chunks"] == 0,
              f"{name}: the encode did not run one A and one B launch")
        same_or_ties(f"e2e {name}", data,
                     codec.ImageCodec(cfg, device="cpu").encode(frame), frame)
        check(rec_d.device.type == "cuda", "decode_to_device left the card")
        check(np.array_equal(rec, rec_d.cpu().numpy()),
              f"{name}: decode and decode_to_device disagree")
        err = int(np.abs(rec.astype(int) - codec.ImageCodec(
            cfg, device="cpu").decode(data)).max())
        log(f"e2e {name}: decode max |diff| vs CPU {err}")
        check(err <= 1, f"e2e {name}: decoded pixels differ by {err}")
        s_ms = {"encode": host_ms(lambda: gpu_s.encode(frame), 10),
                "decode": host_ms(lambda: gpu_s.decode(data), 10),
                "decode_to_device": host_ms(
                    lambda: (gpu_s.decode_to_device(data),
                             torch.cuda.synchronize()), 10)}
        log(f"ImageCodec 1080p {name} (v{data[4]}): " + ", ".join(
            f"{k} {v:.3f} ms ({mpx / v:.1f} Mpix/s)" for k, v in s_ms.items()))
        log(f"1080p {name} encode stages: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in encode_stages(cfg, frame,
                                                      dev).items()))
    # 16x16 blocks: kernels A and B encode; D decodes, and the decode
    # transform is the float32 product (codec.decode_transform)
    cfg16 = CodecConfig(block_size=16, quality=90, decode_index=True)
    gpu16 = codec.ImageCodec(cfg16, device=dev)
    _build.reset_launch_counts()
    data16 = gpu16.encode(frame)
    torch.cuda.synchronize()
    enc16 = dict(_build.LAUNCHES)
    _build.reset_launch_counts()
    rec16_d = gpu16.decode_to_device(data16)
    torch.cuda.synchronize()
    dec16 = dict(_build.LAUNCHES)
    main_runs += [enc16, dec16]
    log(f"main path 16x16 q90 launches: encode {enc16}, decode_to_device "
        f"{dec16}")
    check(data16[4] == 2, f"the 16x16 q90 container is v{data16[4]}, not v2")
    check(enc16["encode_blocks"] == enc16["encode_stripes"] == 1
          and dec16["entropy_decode"] == 1,
          "16x16: not one A and one B launch to encode and one D launch "
          "to decode")
    check(enc16["entropy_decode"] == enc16["decode_blocks"] == 0
          and enc16["pack_chunks"] == dec16["pack_chunks"] == 0
          and dec16["encode_blocks"] == dec16["encode_stripes"] == 0
          and dec16["decode_blocks"] == 0,
          "16x16: kernel C or E ran, or a decode kernel in the encode")
    same_or_ties("e2e 16x16 q90", data16,
                 codec.ImageCodec(cfg16, device="cpu").encode(frame), frame)
    rec16 = gpu16.decode(data16)
    check(rec16_d.device.type == "cuda"
          and np.array_equal(rec16, rec16_d.cpu().numpy()),
          "16x16: decode and decode_to_device disagree")
    err = int(np.abs(rec16.astype(int) - codec.ImageCodec(
        cfg16, device="cpu").decode(data16)).max())
    mse = float(np.mean((rec16.astype(np.float64) - frame) ** 2))
    log(f"e2e 16x16 q90: decode max |diff| vs CPU {err}, PSNR "
        f"{10 * np.log10(255.0 ** 2 / mse):.2f} dB")
    check(err <= 1, f"e2e 16x16 q90: decoded pixels differ by {err}")
    s_ms = {"encode": host_ms(lambda: gpu16.encode(frame), 10),
            "decode": host_ms(lambda: gpu16.decode(data16), 10),
            "decode_to_device": host_ms(
                lambda: (gpu16.decode_to_device(data16),
                         torch.cuda.synchronize()), 10)}
    log(f"ImageCodec 1080p 16x16 q90 (v{data16[4]}): " + ", ".join(
        f"{k} {v:.3f} ms ({mpx / v:.1f} Mpix/s)" for k, v in s_ms.items()))
    log("1080p 16x16 q90 encode stages: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in encode_stages(cfg16, frame,
                                                  dev).items()))

    # ---- 12. dense streams through B, then D ---------------------------
    noise = image_io.synthetic_image(1080, 1920, "noise", seed=3)
    for fname, img, q in (("photo q97", frame, 97), ("photo q100", frame, 100),
                          ("noise q100", noise, 100)):
        img_d = codec.pad_plane_for_encode(torch.from_numpy(img).to(dev),
                                           static)
        pxd = blocks.image_to_blocks(img_d, 8).reshape(-1, 64)
        nsd = img_d.shape[0] // 8
        for mode, kw in (("category", {}),
                         ("direct", dict(huffman_mode="direct")),
                         ("none", dict(use_huffman=False))):
            cfg = CodecConfig(quality=q, decode_index=True, **kw)
            ops, table, run_table = batch_tables(
                cfg, pxd, None, nsd, tables.build(cfg, device=dev))
            packed, bb, _ = check_b(f"dense {fname} {mode}", cfg, pxd, None,
                                    nsd, ops, img_d)
            check_d(f"dense {fname} {mode}",
                    bs.stripes_to_bytes(bs.fetch_packed(packed)),
                    bb.cpu().numpy().reshape(-1).astype(np.uint16), table,
                    run_table, mode, 64, dev)
    # the densest stream real pixels give (testing.densest_stream): q100
    # noise in direct mode, every code 16 bits, coded runs at n2 <= 64
    for n in (4, 8, 16):
        cfg, img, table, run_table = testing.densest_stream(n, 1080, 1920,
                                                            seed=n)
        img_d = codec.pad_plane_for_encode(torch.from_numpy(img).to(dev), cfg)
        pxd = blocks.image_to_blocks(img_d, n).reshape(-1, n * n)
        nsd = img_d.shape[0] // n
        ops = tables.build(cfg, device=dev).with_tables(table, run_table)
        packed, bb, _ = check_b(f"densest {n}x{n}", cfg, pxd, None, nsd, ops,
                                img_d)
        check_d(f"densest {n}x{n}",
                bs.stripes_to_bytes(bs.fetch_packed(packed)),
                bb.cpu().numpy().reshape(-1).astype(np.uint16), table,
                run_table, "direct", n * n, dev)

    # ---- 11. video at full width -----------------------------------------
    vframes = np.stack([image_io.synthetic_image(VH, VW, "photo", seed=s)
                        for s in range(VIDEO_FRAMES)])
    vmpx = VIDEO_FRAMES * VH * VW / 1e3
    for name, cfg in (("q50", CodecConfig()), ("q90", CodecConfig(quality=90))):
        vc = video.VideoCodec(cfg, device=dev)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        packs = dict(bs.PAYLOAD_PACKS)
        streams = vc.encode(vframes)
        torch.cuda.synchronize()
        enc_counts = dict(_build.LAUNCHES)
        check(bs.PAYLOAD_PACKS["native"] - packs["native"] == VIDEO_FRAMES
              and bs.PAYLOAD_PACKS["python"] == packs["python"],
              f"video {name}: the payload of {VIDEO_FRAMES} planes was not "
              f"written by the native pass ({bs.PAYLOAD_PACKS} from {packs})")
        enc_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        rec_d = vc.decode_to_device(streams)
        torch.cuda.synchronize()
        dec_counts = dict(_build.LAUNCHES)
        dec_peak = torch.cuda.max_memory_allocated()
        main_runs += [enc_counts, dec_counts]
        versions = sorted({d[4] for d in streams})
        log(f"video {name}: {VIDEO_FRAMES} x {VH}x{VW}, "
            f"{sum(map(len, streams))} B, container versions {versions}; "
            f"encode launches "
            f"{enc_counts}, peak {enc_peak / 2**30:.3f} GiB; decode_to_device "
            f"launches {dec_counts}, peak {dec_peak / 2**30:.3f} GiB")
        check(enc_counts["encode_blocks"] == 1
              and enc_counts["pack_chunks"] == 1
              and enc_counts["encode_stripes"] == 0,
              f"video {name}: encode did not run one A and one E launch")
        check(dec_counts["decode_blocks"] == 1,
              f"video {name}: decode ran {dec_counts['decode_blocks']} C "
              "launches")
        if cfg.quality == 90:
            check(versions == [2] and dec_counts["entropy_decode"] == 1,
                  f"video {name}: the v2 stack did not decode in one D launch")
            # kernel D alone on the stack's operands, as decode_planes_device
            # builds them (one launch over every frame's stripes)
            pv = [cont.deserialize(d).planes[0] for d in streams]
            ops_v90 = codec.indexed_operands(
                [s for p in pv for s in p.stripes],
                np.concatenate([p.block_bits for p in pv]),
                codec.hf.CanonicalTable(pv[0].table_lengths), None,
                "category", 64, dev, status=True)
            d_stack_ms = cuda_ms(
                lambda: entropy_decode_cuda.decode_blocks_kernel(**ops_v90), 10)
            log(f"time entropy_decode {name} {VIDEO_FRAMES}-frame stack: "
                f"kernel {d_stack_ms:.4f} ms with the status "
                f"({ops_v90['block_bits'].numel()} blocks, "
                f"{ops_v90['payload'].numel()} B)")
            del ops_v90
        _build.reset_launch_counts()
        chunked = video.VideoCodec(cfg, chunk_frames=8, device=dev).encode(
            vframes)
        log(f"video {name}: chunk_frames=8 launches {dict(_build.LAUNCHES)}; "
            f"streams equal to one chunk's: {chunked == streams}")
        check(_build.LAUNCHES["encode_stripes"] == VIDEO_FRAMES // 8,
              f"video {name}: chunked pass 2 did not run kernel B")
        check(chunked == streams, f"video {name}: bytes depend on chunking")
        rec = vc.decode(streams)
        check(np.array_equal(rec, rec_d.cpu().numpy()),
              f"video {name}: decode and decode_to_device disagree")
        gpu_f = codec.ImageCodec(cfg, device=dev)
        check(all(np.array_equal(rec[i], gpu_f.decode(streams[i]))
                  for i in range(VIDEO_FRAMES)),
              f"video {name}: the stack differs from per-frame decode")
        host = codec.decode_planes_device(
            [dataclasses.replace(cont.deserialize(d).planes[0],
                                 block_bits=None) for d in streams], cfg, dev)
        check(torch.equal(host, rec_d),
              f"video {name}: the stack differs from the host route")
        two = video.VideoCodec(cfg, device=dev).encode(vframes[:2])
        two_cpu = video.VideoCodec(cfg, device="cpu").encode(vframes[:2])
        for i in range(2):
            same_or_ties(f"video {name} 2-frame stack, frame {i}", two[i],
                         two_cpu[i], vframes[i])
        rec_cpu = video.VideoCodec(cfg, device="cpu").decode(two)
        err = int(np.abs(rec_cpu.astype(int) - video.VideoCodec(
            cfg, device=dev).decode(two)).max())
        check(err <= 1, f"video {name}: decoded pixels differ by {err}")
        v_ms = {
            "encode": host_ms(lambda: vc.encode(vframes), 3),
            "decode": host_ms(lambda: vc.decode(streams), 3),
            "decode_to_device": host_ms(lambda: (vc.decode_to_device(streams),
                                                 torch.cuda.synchronize()), 3),
        }
        log(f"video {name} {VIDEO_FRAMES} x {VH}x{VW}: " + ", ".join(
            f"{k} {v:.3f} ms ({vmpx / v:.1f} Mpix/s)" for k, v in v_ms.items())
            + f"; CPU vs card 2-frame decode max |diff| {err}")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            vc.encode(vframes)
            torch.cuda.synchronize()
            t_prof = (time.perf_counter() - t_prof) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        log(f"video {name} encode under torch.profiler: {t_prof:.3f} ms, "
            f"device busy {busy:.3f} ms ({100 * busy / t_prof:.1f} %)")
        del rec_d, host
    # where the q50 video encode goes, stage by stage (host clock,
    # synchronised; kernel E by CUDA events)
    cfg = CodecConfig()
    ns_v = codec._padded_grid(VH, VW, cfg)[2]
    ops_v = tables.build(cfg, device=dev)

    def upload():
        out = codec.pad_plane_for_encode(torch.from_numpy(vframes).to(dev), cfg)
        torch.cuda.synchronize()
        return out

    def analyze():
        out = codec.encode_analyze(img_v, cfg, ops_v)
        torch.cuda.synchronize()
        return out

    img_v = upload()
    sym_v, _, hist_v, _ = analyze()
    ops_v = ops_v.with_tables(codec._build_table(cfg, hist_v.cpu().numpy()))
    packed_v, _ = codec.pack_frames(sym_v, cfg, (VIDEO_FRAMES,), ns_v, ops_v)
    fetched_v = bs.fetch_packed(packed_v)
    conts_v = [cont.deserialize(d) for d in video.VideoCodec(
        cfg, device=dev).encode(vframes)]
    e_args = codec._stripe_chunks(sym_v, cfg, VIDEO_FRAMES * ns_v, ops_v)[:3]
    v_stages = {
        "upload + pad": host_ms(upload, 3),
        "analyze (A, RLE, histogram)": host_ms(analyze, 3),
        "table (host)": host_ms(lambda: codec._build_table(
            cfg, hist_v.cpu().numpy()), 3),
        "symbol chunks + E": host_ms(lambda: (codec.pack_frames(
            sym_v, cfg, (VIDEO_FRAMES,), ns_v, ops_v),
            torch.cuda.synchronize()), 3),
        "kernel E": cuda_ms(lambda: pack_cuda.pack_chunks_kernel(*e_args), 5),
        "fetch units": host_ms(lambda: bs.fetch_packed(packed_v), 3),
        "stripe bytes": host_ms(lambda: bs.plane_payloads(fetched_v), 3),
        "serialize": host_ms(lambda: [cont.serialize(c) for c in conts_v], 3),
    }
    log(f"video q50 {VIDEO_FRAMES} x {VH}x{VW} encode stages: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in v_stages.items()))
    del img_v, sym_v, packed_v, e_args
    # the largest chunk CHUNK_PIXEL_BUDGET allows at 1080p, in one dispatch
    big = np.concatenate([vframes, vframes])[:video.CHUNK_PIXEL_BUDGET
                                              // (VH * VW)]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    video.VideoCodec(cfg, device=dev).encode(big)
    torch.cuda.synchronize()
    log(f"video q50 {big.shape[0]} x {VH}x{VW} (one chunk at the budget): "
        f"launches {dict(_build.LAUNCHES)}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
    check(_build.LAUNCHES["pack_chunks"] == 1,
          "the budget-size stack did not encode in one chunk")
    # 16x16 blocks, 8 frames: one chunk (kernel A's analyze pass + E)
    # against chunk_frames=2 (pass 2 through kernel B): one float32 chain
    cfg16v = CodecConfig(block_size=16)
    counts16 = {}
    for chunk in (None, 2):
        _build.reset_launch_counts()
        counts16[chunk] = (video.VideoCodec(cfg16v, chunk_frames=chunk,
                                            device=dev).encode(vframes[:8]),
                           dict(_build.LAUNCHES))
        main_runs.append(counts16[chunk][1])
    (one16, c_one), (two16, c_two) = counts16[None], counts16[2]
    log(f"video 16x16 q50 8 x {VH}x{VW}: one chunk launches {c_one}, "
        f"chunk_frames=2 launches {c_two}; streams equal: {one16 == two16}")
    check(c_one["encode_blocks"] == c_one["pack_chunks"] == 1
          and c_one["encode_stripes"] == 0,
          "video 16x16: one chunk did not run one A and one E launch")
    check(c_two["encode_stripes"] == 4 and c_two["pack_chunks"] == 0,
          "video 16x16: chunked pass 2 did not run kernel B")
    check(one16 == two16, "video 16x16: bytes depend on chunking")

    # ---- 13-15. color, recovery and rate control, counted -------------
    kept = phase_color(dev, frame, vframes, main_runs)
    phase_recovery(dev, frame, kept["420 q90"], main_runs)
    phase_rate_control(dev, frame, vframes, main_runs)

    # ---- 16-17. the sharded paths, counted -----------------------------
    n_unsharded = len(main_runs)
    kept = phase_sharded(dev, frame, vframes, main_runs)
    for k, err in kept["8K errors"].items():
        results[k] = (results[k][0], max(results[k][1], err))
    phase_two_ranks(kept, main_runs)
    for k in ("encode_blocks", "encode_stripes", "decode_blocks",
              "entropy_decode", "pack_chunks"):
        check(any(run[k] for run in main_runs[n_unsharded:]),
              f"{k} not launched on the sharded paths")

    # ---- 18. the CLI on the card, counted -------------------------------
    phase_cli(dev, vframes, main_runs, step_ms)

    # ---- 19. the examples and damaged containers, counted --------------
    log(f"host re-decodes over phases 4-18: {codec.HOST_REDECODES['planes']}")
    check(codec.HOST_REDECODES["planes"] == 0,
          "a clean container of phases 4-18 went to the host decoder")
    phase_examples(dev, main_runs)

    sources = {
        "encode_blocks": ("dct_tpu_torch/csrc/transform.cu",
                          "dct_tpu/ops/transform_pallas.py:227"),
        "encode_stripes": ("dct_tpu_torch/csrc/fused_encode.cu",
                           "dct_tpu/ops/fused_encode_pallas.py:825"),
        "decode_blocks": ("dct_tpu_torch/csrc/transform.cu",
                          "dct_tpu/ops/transform_pallas.py:293"),
        "entropy_decode": ("dct_tpu_torch/csrc/entropy_decode.cu",
                           "dct_tpu/ops/entropy_decode_pallas.py:535"),
        "pack_chunks": ("dct_tpu_torch/csrc/pack.cu",
                        "dct_tpu/ops/pack_pallas.py:121"),
        "variance_codes": ("dct_tpu_torch/csrc/fused_encode.cu",
                           "none (XLA: dct_tpu/ops/quant.py)"),
    }
    # bounds at the shapes timed above: 8 x 1088x1920, static q50 for A,
    # B, C and static q90 for D; operators and tables count as inputs
    nb = px.shape[0]
    op_bytes = 4 * 128 * 128
    mm_flops = 2 * nb * 64 * 64  # one (NB, 64) x (64, 64) product
    ab_bytes = operator_bytes(tables.build(static, device=dev))
    bounds = {
        "encode_blocks": bound_ms(nb * 64 + nb * 64 * 4 + ab_bytes,
                                  a_b_ops(nb, 64), INT8_OPS),
        "encode_stripes": bound_ms(
            b_bytes(nb, 64, static, tables.build(static, device=dev), s_all),
            a_b_ops(nb, 64), INT8_OPS),
        "decode_blocks": bound_ms(nb * 64 * 2 + nb * 64 + op_bytes,
                                  mm_flops, F32_FLOPS),
        # payload, index, stripe starts, tables, status and coefficients,
        # once each
        "entropy_decode": bound_ms(
            sum(t.numel() * t.element_size() for t in ops_d.values()
                if isinstance(t, torch.Tensor))
            + ops_d["block_bits"].numel() * 64 * 2),
        # the int32 chunks as E reads them, the units and bits it writes
        "pack_chunks": bound_ms(
            2 * e_inputs[0].numel() * e_inputs[0].element_size()
            + s_all * (e_inputs[2] * 2 + 4)),
        # the adaptive 8x8 batch: pixels in, a code and a reciprocal out
        "variance_codes": var_bound,
    }
    counts = {k: sum(run[k] for run in main_runs) for k in sources}
    for k, (b_ms, by) in bounds.items():
        log(f"bound {k}: {b_ms:.5f} ms ({by}); kernel at "
            f"{100 * b_ms / times[k][0]:.1f} % of it; launches x (time - "
            f"bound) {counts[k] * (times[k][0] - b_ms):.3f} ms")
    table = [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1],
         "launches": counts[k],
         "max_abs_err": results[k][1], "ms": round(times[k][0], 4),
         "plain_ms": round(times[k][1], 4),
         "bound_ms": round(bounds[k][0], 5), "bound_by": bounds[k][1],
         "library_ms": ({"encode_blocks": round(a_library_ms, 4),
                         "decode_blocks": round(c_library_ms, 4)}.get(k))}
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
