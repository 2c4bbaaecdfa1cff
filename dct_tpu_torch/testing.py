"""Checking helpers shared by the tests and chip_smoke.py: the float64
values the codec rounds from, the tie criterion that decides whether two
roundings of them may differ, and indexed streams in every mode for kernel
D. No codec path uses this module.

Two float32 paths that sum the same exact products in different orders may
round a value that lies within a few ulp of a .5 boundary to neighbouring
integers. Such a mismatch is a tie: at most 1 apart, with the float64 value
within ``tol`` of the boundary. Encode holds ties to ENCODE_TIE_TOL (the
criterion of tests/test_parity.py), decode to DECODE_TIE_TOL, the color
conversions (models/color.py against the reference's XLA) to
PLANE_TIE_TOL. Color containers are compared plane by plane (``plane``:
0 for Y, 1 and 2 for Cb and Cr, against the chrominance quant table).

Kernels A and C also promise an exact float32 chain for every output
value; encode_fma_chain and decode_fma_chain compute that chain with torch
ops on any device, so a kernel can be held to it bit for bit.

Kernels A and B reach the encode chain's integers without running it for
most coefficients: they form the exact product on the integer tensor
cores, prove that the chain must round to round(Y*) for the float64 value
Y* (a rounding certificate), and run the chain itself only for the
coefficients the proof leaves open. encode_certified is that arithmetic in
torch: the float64 product, the same certificate, the rescue by
encode_fma_chain. The chain stays the contract; the certificate only
decides where it has to run.

run_mesh_jobs runs the sharded paths (parallel/) on every rank of a mesh
of spawned processes and brings back each rank's results, its kernel
launches and the collectives it called. It lives here, not in a test
file, because a spawned rank imports the module of its function, and the
test files import jax and the JAX package.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pathlib
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from dct_tpu_torch import container as cont
from dct_tpu_torch import tables as dct_tables
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import _build
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.ops import rle, transform
from dct_tpu_torch.parallel import mesh as meshlib
from dct_tpu_torch.parallel import shard_encode

ENCODE_TIE_TOL = 1e-6
DECODE_TIE_TOL = 1e-3
PLANE_TIE_TOL = 1e-4


def plane_values_f64(rgb: np.ndarray, mode: str) -> list[np.ndarray]:
    """The float64 values the Y, Cb and Cr planes of (..., H, W, 3) u8 RGB
    round from (models/color.py _to_planes, the 4:2:0 mean included)."""
    x = np.asarray(rgb, np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    if mode == "420":
        def sub(p):
            h, w = p.shape[-2:]
            pad = [(0, 0)] * (p.ndim - 2) + [(0, h & 1), (0, w & 1)]
            p = np.pad(p, pad, mode="edge")
            return (p[..., 0::2, 0::2] + p[..., 0::2, 1::2]
                    + p[..., 1::2, 0::2] + p[..., 1::2, 1::2]) / 4.0
        cb, cr = sub(cb), sub(cr)
    return [y, cb, cr]


def rgb_values_f64(y, cb, cr, mode: str, h: int, w: int) -> np.ndarray:
    """The float64 values the (..., h, w, 3) RGB of u8 planes rounds from
    (models/color.py planes_to_rgb)."""
    y, cb, cr = (np.asarray(p, np.float64) for p in (y, cb, cr))
    if mode == "420":
        cb, cr = (p.repeat(2, -2).repeat(2, -1)[..., :h, :w] for p in (cb, cr))
    cb, cr = cb - 128.0, cr - 128.0
    return np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr,
                     y + 1.772 * cb], axis=-1)


def _kron_zigzag_f64(cfg: CodecConfig, chroma: bool = False):
    """(D (x) D) rows in zigzag order and the zigzag quant steps, float64."""
    n = cfg.block_size
    d = dct_tables.dct_basis(n)
    perm = dct_tables.zigzag_permutation(n)
    qz = dct_tables.quant_matrix(n, cfg.quality, chroma=chroma).ravel()[perm]
    return np.kron(d, d)[perm, :], qz


def encode_values_f64(pixels: np.ndarray, cfg: CodecConfig,
                      recip: np.ndarray | None = None,
                      chroma: bool = False) -> np.ndarray:
    """The float64 value each encoded coefficient rounds from: (B, n2) u8
    blocks -> (B, n2) ``(x - 128) @ M_enc`` (times the reciprocal scale on
    AC)."""
    kz, qz = _kron_zigzag_f64(cfg, chroma)
    y = (np.asarray(pixels, np.float64) - 128.0) @ (kz / qz[:, None]).T
    if recip is not None:
        y[:, 1:] *= np.asarray(recip, np.float64)[:, None]
    return y


def decode_values_f64(zz: np.ndarray, cfg: CodecConfig,
                      scale: np.ndarray | None = None,
                      chroma: bool = False) -> np.ndarray:
    """The float64 pixel values decode rounds from: (B, n2) coefficients
    -> (B, n2) ``z * s @ M_dec + 128`` before rounding and clipping."""
    kz, qz = _kron_zigzag_f64(cfg, chroma)
    dq = 1.0 / qz if (cfg.compat_b1 and not cfg.adaptive) else qz
    z = np.asarray(zz, np.float64).copy()
    if scale is not None:
        z[:, 1:] *= np.asarray(scale, np.float64)[:, None]
    return z @ (dq[:, None] * kz) + 128.0


def tie_mismatches(got, want, values: np.ndarray, tol: float):
    """(mismatches, non-ties) between two roundings of the same float64
    ``values``: a mismatch is a tie when the two differ by at most 1 and
    the value lies within ``tol`` of a .5 boundary."""
    got = np.asarray(got, np.int64)
    want = np.asarray(want, np.int64)
    diff = got != want
    frac = np.abs(np.abs(np.asarray(values)[diff]) % 1.0 - 0.5)
    bad = (np.abs(got[diff] - want[diff]) > 1) | (frac >= tol)
    return int(diff.sum()), int(bad.sum())


def coefficients(data: bytes, plane: int = 0) -> np.ndarray:
    """A container plane's (NB, n2) zigzag coefficients, entropy-decoded on
    the host (any mode), DC prediction undone."""
    c = cont.deserialize(data)
    p, cfg = c.planes[plane], c.config
    bh, bw, n_stripes = codec._padded_grid(p.height, p.width, cfg)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    table = hf.CanonicalTable(p.table_lengths) if mode != "none" else None
    run_table = (hf.CanonicalTable(p.run_table_lengths) if cfg.coded_runs
                 else None)
    zz = torch.from_numpy(codec._decode_stripes(
        p, cfg, table, mode, n_stripes, bh // n_stripes * bw, run_table))
    if cfg.dc_prediction:
        zz = codec.dc_reconstruct(zz, n_stripes)
    return zz.numpy()


def _scale(p: cont.PlaneData) -> torch.Tensor:
    return codec.quant.scale_from_variance_code(
        torch.from_numpy(np.asarray(p.variance_codes, np.uint8)))


def plane_encode_mismatches(data: bytes, want: bytes, planes) -> tuple:
    """(mismatches, non-ties) between the coefficients of two containers
    of the same config whose planes were encoded from ``planes`` (one u8
    array per container plane), judged against the float64 values they
    round from at ENCODE_TIE_TOL."""
    c = cont.deserialize(want)
    cfg = c.config
    n_mis = n_bad = 0
    for i, (p, plane) in enumerate(zip(c.planes, planes)):
        px = codec.blk.image_to_blocks(codec.pad_plane_for_encode(
            torch.from_numpy(np.asarray(plane, np.uint8)), cfg),
            cfg.block_size).reshape(-1, cfg.n2).numpy()
        recip = (transform.reciprocal_scale(_scale(p)).numpy()
                 if cfg.adaptive else None)
        m, b = tie_mismatches(coefficients(data, i), coefficients(want, i),
                              encode_values_f64(px, cfg, recip, i > 0),
                              ENCODE_TIE_TOL)
        n_mis, n_bad = n_mis + m, n_bad + b
    return n_mis, n_bad


def encode_mismatches(data: bytes, want: bytes, image: np.ndarray):
    """plane_encode_mismatches of two containers of the same u8 image:
    the (H, W) gray image, or the (H, W, 3) RGB of a color container,
    split into planes by this package's models/color.py _to_planes."""
    chroma = cont.deserialize(want).config.chroma
    if chroma == "gray":
        return plane_encode_mismatches(data, want, [image])
    from dct_tpu_torch.models import color

    return plane_encode_mismatches(data, want, [p.numpy() for p in (
        color._to_planes(torch.from_numpy(np.asarray(image, np.uint8)),
                         chroma))])


def decode_mismatches(got, want, data: bytes, plane: int = 0):
    """(mismatches, non-ties) between two decodes of a container plane's
    pixels, judged against the float64 values of its coefficients (host
    decoder, any mode) at DECODE_TIE_TOL."""
    c = cont.deserialize(data)
    p, cfg = c.planes[plane], c.config
    n = cfg.block_size
    bh, bw, _ = codec._padded_grid(p.height, p.width, cfg)
    scale = _scale(p).numpy() if cfg.adaptive else None
    vals = codec.blk.blocks_to_image(
        torch.from_numpy(decode_values_f64(coefficients(data, plane), cfg,
                                           scale, plane > 0)),
        bh * n, bw * n, n)[: p.height, : p.width].numpy()
    return tie_mismatches(got, want, vals, DECODE_TIE_TOL)


def encode_fma_chain(pixels: torch.Tensor, cfg: CodecConfig,
                     ops: dct_tables.CodecOperators,
                     recip: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel A's arithmetic, value by value, on pixels' device: (B, n2) u8
    blocks -> (B, n2) int32; kernel B's too. Per coefficient three float32
    accumulators, one per bf16 operator part, each summed over j = 0 ..
    n2-1 in order, then ((a0 + a1) + a2) + bias. At n2 = 256 each part's
    sum is the reference's K = 128 split: lo over j = 0 .. 127 and hi over
    j = 128 .. 255, each in order, a_i = lo_i + hi_i. Then times recip on
    AC under adaptive quantization (one multiply), rounded half away from
    zero. The kernels accumulate by FMA; here each step is a multiply and
    then an add: a u8 pixel times a bf16 value is exact in float32, so the
    two round alike and the emulation is exact. recip: (B,) float32
    reciprocal scales, or None."""
    n2 = cfg.n2
    x = pixels.reshape(-1, n2).to(torch.float32)
    parts = [m[:n2, :n2] for m in (ops.m0, ops.m1, ops.m2)]
    halves = ((0, 128), (128, 256)) if n2 == 256 else ((0, n2),)
    acc = None
    for j0, j1 in halves:
        half = [x.new_zeros(x.shape) for _ in parts]
        for j in range(j0, j1):
            xj = x[:, j:j + 1]
            for a, m in zip(half, parts):
                a.add_(xj * m[j])
        acc = half if acc is None else [a + h for a, h in zip(acc, half)]
    y = (acc[0] + acc[1]) + acc[2] + ops.bias[:, :n2]
    if recip is not None:
        y[:, 1:] = y[:, 1:] * recip.reshape(-1, 1).to(torch.float32)
    return transform.round_half_away(y).to(torch.int32)


CERT_REL = 2 * dct_tables.U32 + 2.0 ** -40  # times |Y*| in the certificate


def certify(s: torch.Tensor, cert: torch.Tensor,
            recip: torch.Tensor | None = None):
    """The rounding certificate of csrc/transform_core.cuh (certify), in
    the same float64 operations: (B, n2) exact integer products s = x @ W
    (float64 or int64) and the (3, n2) int_cert constants -> (round(Y*) as
    int32, certified mask). Y* = s 2^-e + b (the scaling exact, the add
    rounded once), times the float32 recip on AC under adaptive
    quantization. A coefficient is certified when no .5 boundary lies
    within delta = E_k r + (2u + 2^-40) |Y*| + u of Y*: the chain then
    rounds to round(Y*) (the proof is at certify in transform_core.cuh)."""
    y = s.to(torch.float64) * cert[0] + cert[1]
    rr = torch.ones_like(y)
    if recip is not None:
        rr[:, 1:] = recip.reshape(-1, 1).to(torch.float64)
        y = y * rr
    delta = (cert[2] * rr + CERT_REL * y.abs()) + dct_tables.U32
    fl = torch.floor(y)
    frac = y - fl
    ok = (frac - 0.5).abs() > delta
    return (fl + (frac > 0.5).to(torch.float64)).to(torch.int32), ok


def encode_certified(pixels: torch.Tensor, cfg: CodecConfig,
                     ops: dct_tables.CodecOperators,
                     recip: torch.Tensor | None = None):
    """Kernels A's and B's transform arithmetic on pixels' device: (B, n2)
    u8 blocks -> ((B, n2) int32, (B, n2) bool rescued). The exact product
    x @ W (float64 holds it: |x @ W| < 2^47), the certificate, and
    encode_fma_chain's integer for every coefficient the certificate leaves
    open (the rescue). recip: (B,) float32 reciprocal scales, or None."""
    n2 = cfg.n2
    w, _ = dct_tables.integer_operator(
        *(m[:n2, :n2].cpu().numpy() for m in (ops.m0, ops.m1, ops.m2)))
    x = pixels.reshape(-1, n2).to(torch.float64)
    s = x @ torch.from_numpy(w).to(x.device, torch.float64)
    q, ok = certify(s, ops.int_cert[:, :n2].to(x.device), recip)
    chain = encode_fma_chain(pixels, cfg, ops, recip)
    return torch.where(ok, q, chain), ~ok


def decode_fma_chain(zz: torch.Tensor, cfg: CodecConfig,
                     ops: dct_tables.CodecOperators,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel C's arithmetic, value by value, on zz's device: (B, n2)
    zigzag coefficients -> (B, n2) u8 pixels. z_k is the coefficient as
    float32 (times the block's scale on AC under adaptive quantization, one
    multiply), y = fma(z_k, M[k, j], y) over k = 0 .. n2-1 from 0, then
    y + 128 rounded half away from zero and clamped to [0, 255]. Each FMA
    is taken as a float64 product and sum rounded to float32: that is the
    FMA's single rounding wherever the float64 sum is exact, which is all
    but pathological cases (a mismatch there is still a decode tie).
    scale: (B,) adaptive scales, or None."""
    n2 = cfg.n2
    z = zz.reshape(-1, n2).to(torch.float32)
    if scale is not None:
        z[:, 1:] = z[:, 1:] * scale.reshape(-1, 1).to(torch.float32)
    m = ops.m_dec[:n2, :n2].to(torch.float64)
    z64 = z.to(torch.float64)
    y = z.new_zeros(z.shape)
    for k in range(n2):
        y = (y.to(torch.float64) + z64[:, k:k + 1] * m[k]).to(torch.float32)
    p = transform.round_half_away(y + 128.0)
    return torch.clamp(p, 0.0, 255.0).to(torch.uint8)


def indexed_stream(zz: torch.Tensor, cfg: CodecConfig, n_stripes: int):
    """Pack (NB, n2) zigzag coefficients into an indexed stream with the
    plain staged packer (codec.encode_pack_plain), in cfg's mode
    (category, direct or none, fixed or coded runs), with canonical tables
    built from the coefficients' histograms: -> (stripe bytes, (NB,)
    uint16 block bits, table, run_table). A stream from plain code only,
    for holding kernel D to it."""
    sym = rle.rle_encode_positional(zz)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    table = None
    if mode == "category":
        table = hf.CanonicalTable.from_frequencies(
            hf.category_histogram_masked(sym.values, sym.is_sym).cpu().numpy())
    elif mode == "direct":
        table = hf.CanonicalTable.from_frequencies(hf.value_histogram_masked(
            sym.values, sym.is_sym, codec.DIRECT_VMIN,
            -codec.DIRECT_VMIN).cpu().numpy())
    run_table = codec._build_run_table(
        cfg, hf.run_histogram_masked(sym.runs, sym.is_sym).cpu().numpy())
    ops = dct_tables.build(cfg, device=zz.device).with_tables(table, run_table)
    packed, block_bits = codec.encode_pack_plain(sym, cfg, n_stripes, ops)
    stripes = bs.stripes_to_bytes(bs.fetch_packed(packed))
    return (stripes, block_bits.cpu().numpy().reshape(-1).astype(np.uint16),
            table, run_table)



# ---------------------------------------------------------------------------
# The ranks of a mesh
# ---------------------------------------------------------------------------


def run_mesh_jobs(world_size: int, mesh_shape: tuple[int, int], jobs,
                  out_dir, backend: str = "gloo", device_type: str = "cpu",
                  timeout: float = 240.0) -> list[dict]:
    """Run ``jobs`` on every rank of a (n_data, n_stripe) mesh of
    world_size spawned processes -> each rank's results, by rank.

    A job is (name, fn, args, kwargs): every rank calls
    fn(*args, mesh=mesh, **kwargs) in the jobs' order. A rank's results
    are {name: {"value": the result, tensors as host arrays, "launches":
    the kernels' launch counts, "collectives": the (kind, ..., dtype,
    shape) of each shard_encode._all_reduce / _all_gather call,
    "coordinate": the rank's (data, stripe) coordinate, "seconds": host
    clock, synchronised}}. The process group is initialised through a new
    file in out_dir (no port), with ``timeout``. A rank that fails, or
    that still runs ``timeout`` seconds after the start (a hang), fails
    the call at once: every rank still running is killed (the others may
    wait in a collective for the failed one), and RuntimeError raised."""
    out_dir = pathlib.Path(out_dir)
    init = out_dir / f"init-{os.getpid()}-{time.time_ns()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(
        rank, world_size, str(init), backend, device_type, tuple(mesh_shape),
        jobs, str(out_dir), timeout)) for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while (any(p.is_alive() for p in procs)
           and not any(p.exitcode for p in procs)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    codes = [p.exitcode for p in procs]
    killed = [p for p in procs if p.is_alive()]
    for p in killed:
        p.kill()
        p.join()
    if killed or any(codes):
        raise RuntimeError(
            f"mesh {mesh_shape} over {backend}: rank exit codes {codes}"
            + (f"; {len(killed)} killed" if killed else "")
            + ("" if any(codes) else f" after {timeout} s"))
    return [pickle.loads((out_dir / f"rank{rank}.pkl").read_bytes())
            for rank in range(world_size)]


def _mesh_rank(rank: int, world_size: int, init_file: str, backend: str,
               device_type: str, mesh_shape: tuple[int, int], jobs,
               out_dir: str, timeout: float) -> None:
    """One rank of run_mesh_jobs (a spawned process)."""
    torch.set_num_threads(1)
    # the ranks share this host: gloo pairs them over the loopback device
    # (the host name need not resolve where there is no network)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    mesh = meshlib.make_mesh(*mesh_shape, device_type=device_type)
    calls = []

    def counted(kind, fn):
        def collective(x, mesh, *args):
            calls.append((kind, *args, str(x.dtype), tuple(x.shape)))
            return fn(x, mesh, *args)
        return collective

    shard_encode._all_reduce = counted("all_reduce", shard_encode._all_reduce)
    shard_encode._all_gather = counted("all_gather", shard_encode._all_gather)
    results = {}
    for name, fn, args, kwargs in jobs:
        _build.reset_launch_counts()
        calls.clear()
        t0 = time.perf_counter()
        value = fn(*args, mesh=mesh, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        results[name] = dict(
            value=_host(value), launches=dict(_build.LAUNCHES),
            collectives=list(calls), coordinate=meshlib.coordinate(mesh),
            seconds=time.perf_counter() - t0)
    (pathlib.Path(out_dir) / f"rank{rank}.pkl").write_bytes(
        pickle.dumps(results))
    dist.destroy_process_group()


def _host(x):
    """A job's result with every tensor as a host array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_host, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(_host, x))
    return x


def rank_byte_offsets(bit_lengths: np.ndarray, mesh) -> np.ndarray:
    """shard_encode.stripe_byte_offsets of this rank's slice of every
    stripe's bit lengths (a job)."""
    part = bit_lengths[meshlib.row_slice(mesh, len(bit_lengths))]
    return shard_encode.stripe_byte_offsets(torch.from_numpy(part), mesh)


def rank_histograms(values: np.ndarray, live: np.ndarray, runs: np.ndarray,
                    mesh):
    """The global category and run histograms of every rank's slice of
    (B, S) symbols (a job)."""
    sl = meshlib.row_slice(mesh, len(values))
    v, l, r = (torch.from_numpy(a[sl]).to(meshlib.device(mesh))
               for a in (values, live, runs))
    return (shard_encode.global_category_histogram(v, l, mesh),
            shard_encode.global_run_histogram(r, l, mesh))


def fail_on_rank(rank: int, mesh) -> None:
    """Raise on ``rank`` while every other rank waits for it in an
    all-reduce (a job: the call must end without waiting out its
    timeout)."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails")
    shard_encode._all_reduce(torch.zeros(1), mesh, meshlib.STRIPE_AXIS)


def value_error(fn, *args, mesh=None, **kwargs) -> str | None:
    """The message of the ValueError fn(*args, mesh=mesh, **kwargs)
    raises, or None (a job)."""
    try:
        fn(*args, mesh=mesh, **kwargs)
    except ValueError as e:
        return str(e)
    return None


def mesh_shapes(sizes, mesh) -> list:
    """(n_data, n_stripe) of make_mesh(*size) on mesh's device type for
    each size, or the ValueError's message (a job)."""
    out = []
    for size in sizes:
        try:
            out.append(meshlib.shape(meshlib.make_mesh(
                *size, device_type=mesh.device_type)))
        except ValueError as e:
            out.append(str(e))
    return out
