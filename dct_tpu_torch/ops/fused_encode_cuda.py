"""Kernel B (csrc/fused_encode.cu): the fused stripe encode, the port's
counterpart of ``dct_tpu.ops.fused_encode_pallas.encode_stripes_fused``.

Pixels go in, packed stripe units, stripe bit lengths and per-block bit
lengths come out. The plain version is the staged composition the
reference's staged path runs — transform, DC prediction, positional RLE,
symbol chunks, the plain chunk packer (models/codec.py encode_pack_plain).
The kernel takes what the reference's kernel takes: 4x4, 8x8 and 16x16
blocks (KERNEL_N2) in the category, direct and "none" modes
(KERNEL_MODES), with the fixed run field or (n2 <= 64) the coded one,
adaptive quantization and DC prediction on or off, and stripes of any
width. 2x2 blocks raise NotImplementedError; the codec encodes them
through the staged path with kernel E (models/codec.py fused_kernel_ok),
as the reference does. The kernel's transform is kernel A's tensor-core
tile (csrc/transform_core.cuh), so its integers are A's, those of the
float32 chain testing.encode_fma_chain. A persistent grid of CTAs
(kernel_info gives its shape) walks the stripes in tiles of
TILE_BLOCKS[n2] blocks, each entropy-coded in rounds of 256 segments of
16 zigzag positions (32 at n2 256) a thread.

Two entries launch the same kernel: encode_stripes_fused takes (NB, n2)
blocks, encode_plane_stripes_fused the padded plane(s) (..., Hp, Wp)
themselves, which the kernel reads block by block (no blocking pass).

The same library holds the adaptive encode's variance pass
(plane_variance_codes): one kernel reads the padded u8 planes once and
writes each block's u8 variance code and the float32 reciprocal of its
scale. Kernel B and its plain version take that reciprocal as it is (the
keyword adaptive_recip of every entry); a caller holding scales converts
them once with transform.reciprocal_scale. The variance pass's plain
version, variance_codes_plain, is ops/quant.py's op chain and
transform.reciprocal_scale.
"""

from __future__ import annotations

import ctypes

import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.ops import _build, blocks, quant, rle, transform
from dct_tpu_torch.ops import transform_cuda
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.tables import CodecOperators
from dct_tpu_torch.utils import tracing

KERNEL_N2 = (16, 64, 256)
KERNEL_MODES = ("category", "direct", "none")
# value-table entries per mode: 16 categories; direct mode's alphabet
# [-255, 255] (models/codec.py DIRECT_VMIN) + ESC; no table in "none" mode
TABLE_ENTRIES = {"category": 16, "direct": 512, "none": 0}
RUN_TABLE_ENTRIES = 65
# blocks a tile (csrc/fused_encode.cu Shape::kTile), for tests of its edges
TILE_BLOCKS = {16: 256, 64: 128, 256: 64}


def encode_stripes_plain(
    pixels: torch.Tensor,
    cfg: CodecConfig,
    n_stripes: int,
    ops: CodecOperators,
    *,
    adaptive_recip: torch.Tensor | None = None,
):
    """Plain version of kernel B: (NB, n2) u8 blocks -> (PackedStripes,
    (n_stripes, bps) int32 block bits), through the staged pipeline."""
    from dct_tpu_torch.models import codec  # the staged pipeline's home

    zz = transform.encode_blocks_recip(pixels, cfg, ops, adaptive_recip)
    if cfg.dc_prediction:
        zz = codec.dc_predict(zz, n_stripes)
    return codec.encode_pack_plain(rle.rle_encode_positional(zz), cfg,
                                   n_stripes, ops)


def kernel_info(n2: int, device=None) -> dict:
    """The kernel's launch shape on a card: its SMs, CTAs an SM (the
    persistent grid is their product, or the stripe count if smaller),
    registers a thread, dynamic shared memory and local (spilled) bytes a
    thread, threads a CTA, blocks a tile."""
    if n2 not in KERNEL_N2:
        raise NotImplementedError(f"fused encode kernel takes n2 in "
                                  f"{KERNEL_N2}, got {n2}")
    lib = _build.library("fused_encode")
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        rc = lib.dct_encode_stripes_info(n2, ctypes.addressof(out))
    _build.check(lib, rc, f"encode_stripes info (n2={n2})")
    return dict(zip(("sms", "ctas_per_sm", "registers", "shared_bytes",
                     "local_bytes", "threads", "tile_blocks"), out))


def stripes_per_cta(n_stripes: int, info: dict) -> tuple[int, float]:
    """(most, mean) stripes a CTA of the persistent grid walks."""
    grid = min(n_stripes, info["sms"] * info["ctas_per_sm"])
    return -(-n_stripes // grid), n_stripes / grid


def _mode(cfg: CodecConfig) -> str:
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    if cfg.n2 not in KERNEL_N2 or mode not in KERNEL_MODES:
        raise NotImplementedError(
            f"fused encode kernel takes n2 in {KERNEL_N2} in modes "
            f"{KERNEL_MODES}, got n2={cfg.n2} in {mode!r}")
    return mode


def _check_tables(cfg: CodecConfig, ops: CodecOperators, mode: str) -> None:
    n_val = TABLE_ENTRIES[mode]
    if n_val and ops.cat_lengths.numel() != n_val:
        raise ValueError(f"{mode} mode requires a {n_val}-entry table, got "
                         f"{ops.cat_lengths.numel()} entries")
    if cfg.coded_runs and (ops.run_lengths is None
                           or ops.run_lengths.numel() != RUN_TABLE_ENTRIES):
        raise ValueError(f"coded_runs requires a {RUN_TABLE_ENTRIES}-entry "
                         "run table")


def _check_pixels(pixels: torch.Tensor, cfg: CodecConfig, n_stripes: int,
                  ops: CodecOperators) -> None:
    if pixels.dtype != torch.uint8 or pixels.dim() != 2 \
            or pixels.shape[1] != cfg.n2:
        raise ValueError(f"expected (NB, {cfg.n2}) uint8 blocks, got "
                         f"{tuple(pixels.shape)} {pixels.dtype}")
    if not pixels.is_contiguous():
        raise ValueError("pixels must be contiguous")
    if n_stripes <= 0 or pixels.shape[0] % n_stripes:
        raise ValueError(f"{pixels.shape[0]} blocks do not split into "
                         f"{n_stripes} stripes")
    if ops.device != pixels.device:
        raise ValueError(f"operators on {ops.device}, pixels on "
                         f"{pixels.device}")


def _check_plane(plane: torch.Tensor, cfg: CodecConfig, n_stripes: int,
                 ops: CodecOperators) -> int:
    """The blocks a stripe of padded plane(s) (..., Hp, Wp), checked."""
    n = cfg.block_size
    if plane.dtype != torch.uint8 or plane.dim() < 2:
        raise ValueError(f"expected (..., Hp, Wp) uint8 planes, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    hp, wp = plane.shape[-2], plane.shape[-1]
    rows = plane.numel() // wp // n if wp else 0  # every frame's block rows
    if hp % n or wp % n or rows == 0 or n_stripes <= 0 or rows % n_stripes:
        raise ValueError(f"planes {tuple(plane.shape)} do not split into "
                         f"{n_stripes} stripes of whole {n}x{n} block rows")
    if ops.device != plane.device:
        raise ValueError(f"operators on {ops.device}, planes on "
                         f"{plane.device}")
    return rows // n_stripes * (wp // n)


def encode_stripes_fused(
    pixels: torch.Tensor,
    cfg: CodecConfig,
    n_stripes: int,
    ops: CodecOperators,
    *,
    adaptive_recip: torch.Tensor | None = None,
):
    """(NB, n2) u8 blocks, NB = n_stripes * blocks per stripe (stripes of
    every frame stacked) -> (PackedStripes, (n_stripes, bps) int32 block
    bits); under cfg.adaptive adaptive_recip holds each block's float32
    1 / scale (transform.reciprocal_scale), taken as it is.
    encode_stripes_plain on the CPU, kernel B on CUDA: units come back as
    an (n_stripes, capacity) int16 view of the kernel's word buffer,
    capacity = bps * units_per_block_worst(n2, coded_runs). ops carries
    the mode's value table (cat_lengths / cat_codes: 16 entries in
    category mode, 512 in direct mode) and, under coded_runs, the run
    table."""
    if pixels.device.type == "cpu":
        return encode_stripes_plain(pixels, cfg, n_stripes, ops,
                                    adaptive_recip=adaptive_recip)
    _check_pixels(pixels, cfg, n_stripes, ops)
    if pixels.data_ptr() % 16:  # the kernel reads pixels 16 bytes a copy
        pixels = pixels.clone()
    return _launch(pixels, 0, pixels.shape[0] // n_stripes, cfg, n_stripes,
                   ops, adaptive_recip)


def encode_plane_stripes_fused(
    plane: torch.Tensor,
    cfg: CodecConfig,
    n_stripes: int,
    ops: CodecOperators,
    *,
    adaptive_recip: torch.Tensor | None = None,
):
    """encode_stripes_fused on the padded plane(s) (..., Hp, Wp) u8 as they
    are: n_stripes counts the stripes of every frame (each cfg.stripe_rows
    block rows), adaptive_recip holds each block's float32 1 / scale in
    raster order (plane_variance_codes' second output). The same outputs
    as encode_stripes_fused on blocks.image_to_blocks of the planes; on
    CUDA kernel B reads the blocks out of the planes itself, on the CPU
    the plain version runs on those blocks."""
    bps = _check_plane(plane, cfg, n_stripes, ops)
    if plane.device.type == "cpu":
        px = blocks.image_to_blocks(plane, cfg.block_size).reshape(-1, cfg.n2)
        return encode_stripes_plain(px, cfg, n_stripes, ops,
                                    adaptive_recip=adaptive_recip)
    plane = _aligned(plane)
    return _launch(plane, plane.shape[-1], bps, cfg, n_stripes, ops,
                   adaptive_recip)


def _aligned(plane: torch.Tensor) -> torch.Tensor:
    """The planes contiguous and 16-byte aligned, as the kernels read them
    (a copy only where they are not)."""
    if not plane.is_contiguous() or plane.data_ptr() % 16:
        return plane.clone(memory_format=torch.contiguous_format)
    return plane


def variance_codes_plain(plane: torch.Tensor, cfg: CodecConfig):
    """Plain version of plane_variance_codes: ops/quant.py's op chain on
    the planes' blocks, then transform.reciprocal_scale."""
    codes = quant.variance_code(quant.block_variance_flat(
        transform.level_shift(blocks.image_to_blocks(plane, cfg.block_size))))
    return codes, transform.reciprocal_scale(
        quant.scale_from_variance_code(codes).reshape(-1))


def plane_variance_codes(plane: torch.Tensor, cfg: CodecConfig):
    """The adaptive encode's variance pass on padded u8 plane(s) (..., Hp,
    Wp), n2 in KERNEL_N2 -> (u8 variance codes (..., NB), float32 1 / scale
    (frames * NB,) in raster block order over every plane: what
    encode_plane_stripes_fused's adaptive_recip takes). variance_codes_plain
    on the CPU; on CUDA one launch of the variance kernel over every plane,
    equal to it bit for bit."""
    if plane.device.type == "cpu":
        return variance_codes_plain(plane, cfg)
    n = cfg.block_size
    if cfg.n2 not in KERNEL_N2:
        raise NotImplementedError(f"the variance kernel takes n2 in "
                                  f"{KERNEL_N2}, got {cfg.n2}")
    if plane.dtype != torch.uint8 or plane.dim() < 2 \
            or plane.shape[-2] % n or plane.shape[-1] % n:
        raise ValueError(f"expected (..., Hp, Wp) uint8 planes of whole "
                         f"{n}x{n} blocks, got {tuple(plane.shape)} "
                         f"{plane.dtype}")
    plane = _aligned(plane)
    hp, wp = plane.shape[-2], plane.shape[-1]
    codes = torch.empty(*plane.shape[:-2], hp // n * (wp // n),
                        dtype=torch.uint8, device=plane.device)
    recip = torch.empty(codes.numel(), dtype=torch.float32,
                        device=plane.device)
    if codes.numel() == 0:
        return codes, recip
    lib = _build.library("fused_encode")
    args = (plane.data_ptr(), plane.numel() // wp // n, wp, cfg.n2,
            codes.data_ptr(), recip.data_ptr())
    with tracing.named_scope("kernel.variance_codes"):
        rc = _call(lib.dct_variance_codes, args, plane.device)
    _build.check(lib, rc, f"variance_codes (n2={cfg.n2})")
    _build.LAUNCHES["variance_codes"] += 1
    return codes, recip


def _call(fn, args, dev: torch.device) -> int:
    """A launcher of the library on dev's current stream."""
    if dev.index == torch.cuda.current_device():  # no device switch
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


class _Operands:
    """What one launch configuration passes unchanged from call to call:
    the checked operators and tables (their pointers), the shape, the
    rescue counter. Holds ops, so a cached entry's pointers stay valid."""

    def __init__(self, ops, cfg, n_stripes, bps, plane_width, dev):
        mode = _mode(cfg)
        _check_tables(cfg, ops, mode)
        n_val = TABLE_ENTRIES[mode]
        coded = cfg.coded_runs
        frag, cert, parts, bias = transform_cuda.integer_operands(
            ops, cfg.n2, dev, "encode_stripes")
        self.ops = ops
        self.mode = mode
        self.capacity = bps * bs.units_per_block_worst(cfg.n2, coded)
        self.n_words = -(-self.capacity // 2)
        self.shape = (n_stripes, bps)
        self.lib = _build.library("fused_encode")
        self.operators = (frag.data_ptr(), cert.data_ptr(),
                          parts.data_ptr(), bias.data_ptr())
        self.rest = (
            _build.ptr(ops.cat_lengths if n_val else None),
            _build.ptr(ops.cat_codes if n_val else None), n_val,
            _build.ptr(ops.run_lengths if coded else None),
            _build.ptr(ops.run_codes if coded else None),
            bs.run_field_bits(cfg.n2), KERNEL_MODES.index(mode),
            int(cfg.dc_prediction), cfg.n2, n_stripes, bps, plane_width)
        self.rescued = _build.rescue_counter("encode_stripes",
                                             dev).data_ptr()


# launch configurations by (id(ops), cfg, n_stripes, bps, plane_width,
# device): the last few, so a caller that encodes with the same operators
# again checks and packs them once
_OPERANDS: dict[tuple, _Operands] = {}
_OPERANDS_KEPT = 8


def _operands(ops, cfg, n_stripes, bps, plane_width, dev) -> _Operands:
    key = (id(ops), cfg, n_stripes, bps, plane_width, dev)
    hit = _OPERANDS.get(key)
    if hit is None or hit.ops is not ops:
        hit = _Operands(ops, cfg, n_stripes, bps, plane_width, dev)
        if len(_OPERANDS) >= _OPERANDS_KEPT:
            del _OPERANDS[next(iter(_OPERANDS))]
        _OPERANDS[key] = hit
    return hit


def _launch(px: torch.Tensor, plane_width: int, bps: int, cfg: CodecConfig,
            n_stripes: int, ops: CodecOperators, adaptive_recip):
    """Kernel B on checked pixels (blocks where plane_width is 0, else the
    planes' rows of plane_width bytes) -> (PackedStripes, block bits)."""
    dev = px.device
    op = _operands(ops, cfg, n_stripes, bps, plane_width, dev)
    recip = None
    if cfg.adaptive:
        if adaptive_recip is None:
            raise ValueError("adaptive fused encode requires adaptive_recip")
        recip = adaptive_recip.reshape(-1)
        if recip.shape[0] != n_stripes * bps or recip.device != dev \
                or recip.dtype != torch.float32 or not recip.is_contiguous():
            raise ValueError("adaptive_recip must hold one contiguous "
                             "float32 reciprocal per block")
    words = torch.empty(n_stripes, op.n_words, dtype=torch.int32, device=dev)
    bits = torch.empty(n_stripes, dtype=torch.int32, device=dev)
    block_bits = torch.empty(op.shape, dtype=torch.int32, device=dev)
    args = (px.data_ptr(), *op.operators, _build.ptr(recip), *op.rest,
            words.data_ptr(), op.n_words, bits.data_ptr(),
            block_bits.data_ptr(), op.rescued)
    with tracing.named_scope("kernel.encode_stripes"):
        rc = _call(op.lib.dct_encode_stripes, args, dev)
    _build.check(op.lib, rc, f"encode_stripes (n2={cfg.n2}, {op.mode})")
    _build.LAUNCHES["encode_stripes"] += 1
    units = words.view(torch.int16)[:, :op.capacity]
    return bs.PackedStripes(units=units, bit_lengths=bits), block_bits
