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
float32 chain testing.encode_fma_chain.
"""

from __future__ import annotations

import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.ops import _build, rle, transform, transform_cuda
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.tables import CodecOperators

KERNEL_N2 = (16, 64, 256)
KERNEL_MODES = ("category", "direct", "none")
# value-table entries per mode: 16 categories; direct mode's alphabet
# [-255, 255] (models/codec.py DIRECT_VMIN) + ESC; no table in "none" mode
TABLE_ENTRIES = {"category": 16, "direct": 512, "none": 0}
RUN_TABLE_ENTRIES = 65


def encode_stripes_plain(
    pixels: torch.Tensor,
    cfg: CodecConfig,
    n_stripes: int,
    ops: CodecOperators,
    adaptive_scale: torch.Tensor | None = None,
):
    """Plain version of kernel B: (NB, n2) u8 blocks -> (PackedStripes,
    (n_stripes, bps) int32 block bits), through the staged pipeline."""
    from dct_tpu_torch.models import codec  # the staged pipeline's home

    zz = transform.encode_blocks(pixels, cfg, ops, adaptive_scale)
    if cfg.dc_prediction:
        zz = codec.dc_predict(zz, n_stripes)
    return codec.encode_pack_plain(rle.rle_encode_positional(zz), cfg,
                                   n_stripes, ops)


def _check_operands(pixels: torch.Tensor, cfg: CodecConfig, n_stripes: int,
                    ops: CodecOperators, mode: str) -> None:
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
    n_val = TABLE_ENTRIES[mode]
    if n_val and ops.cat_lengths.numel() != n_val:
        raise ValueError(f"{mode} mode requires a {n_val}-entry table, got "
                         f"{ops.cat_lengths.numel()} entries")
    if cfg.coded_runs and (ops.run_lengths is None
                           or ops.run_lengths.numel() != RUN_TABLE_ENTRIES):
        raise ValueError(f"coded_runs requires a {RUN_TABLE_ENTRIES}-entry "
                         "run table")


def encode_stripes_fused(
    pixels: torch.Tensor,
    cfg: CodecConfig,
    n_stripes: int,
    ops: CodecOperators,
    adaptive_scale: torch.Tensor | None = None,
):
    """(NB, n2) u8 blocks, NB = n_stripes * blocks per stripe (stripes of
    every frame stacked) -> (PackedStripes, (n_stripes, bps) int32 block
    bits). encode_stripes_plain on the CPU, kernel B on CUDA: units come
    back as an (n_stripes, capacity) int16 view of the kernel's word
    buffer, capacity = bps * units_per_block_worst(n2, coded_runs). ops
    carries the mode's value table (cat_lengths / cat_codes: 16 entries
    in category mode, 512 in direct mode) and, under coded_runs, the run
    table."""
    if pixels.device.type == "cpu":
        return encode_stripes_plain(pixels, cfg, n_stripes, ops, adaptive_scale)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    if cfg.n2 not in KERNEL_N2 or mode not in KERNEL_MODES:
        raise NotImplementedError(
            f"fused encode kernel takes n2 in {KERNEL_N2} in modes "
            f"{KERNEL_MODES}, got n2={cfg.n2} in {mode!r}")
    _check_operands(pixels, cfg, n_stripes, ops, mode)
    if pixels.data_ptr() % 16:  # the kernel reads pixels 16 bytes a copy
        pixels = pixels.clone()
    bps = pixels.shape[0] // n_stripes
    recip = None
    if cfg.adaptive:
        if adaptive_scale is None:
            raise ValueError("adaptive fused encode requires adaptive_scale")
        recip = transform.reciprocal_scale(adaptive_scale.reshape(-1))
        if recip.shape[0] != pixels.shape[0] or recip.device != pixels.device:
            raise ValueError("adaptive_scale must hold one scale per block")

    capacity = bps * bs.units_per_block_worst(cfg.n2, cfg.coded_runs)
    n_words = -(-capacity // 2)
    dev = pixels.device
    words = torch.empty(n_stripes, n_words, dtype=torch.int32, device=dev)
    bits = torch.empty(n_stripes, dtype=torch.int32, device=dev)
    block_bits = torch.empty(n_stripes, bps, dtype=torch.int32, device=dev)
    n_val = TABLE_ENTRIES[mode]
    coded = cfg.coded_runs
    frag, cert, parts_t, bias = transform_cuda.integer_operands(
        ops, cfg.n2, dev, "encode_stripes")
    lib = _build.library("fused_encode")
    with torch.cuda.device(dev):
        rc = lib.dct_encode_stripes(
            pixels.data_ptr(), frag.data_ptr(), cert.data_ptr(),
            parts_t.data_ptr(), bias.data_ptr(), _build.ptr(recip),
            _build.ptr(ops.cat_lengths if n_val else None),
            _build.ptr(ops.cat_codes if n_val else None), n_val,
            _build.ptr(ops.run_lengths if coded else None),
            _build.ptr(ops.run_codes if coded else None),
            bs.run_field_bits(cfg.n2), KERNEL_MODES.index(mode),
            int(cfg.dc_prediction), cfg.n2, n_stripes, bps,
            words.data_ptr(), n_words, bits.data_ptr(),
            block_bits.data_ptr(),
            _build.rescue_counter("encode_stripes", dev).data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, f"encode_stripes (n2={cfg.n2}, {mode})")
    _build.LAUNCHES["encode_stripes"] += 1
    units = words.view(torch.int16)[:, :capacity]
    return bs.PackedStripes(units=units, bit_lengths=bits), block_bits
