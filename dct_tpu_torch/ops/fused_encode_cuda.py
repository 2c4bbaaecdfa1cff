"""Kernel B (csrc/fused_encode.cu): the fused stripe encode, the port's
counterpart of ``dct_tpu.ops.fused_encode_pallas.encode_stripes_fused``.

Pixels go in, packed stripe units, stripe bit lengths and per-block bit
lengths come out. The plain version is the staged composition the
reference's staged path runs — transform, DC prediction, positional RLE,
symbol chunks, the plain chunk packer (models/codec.py encode_pack_plain)
— and it covers every entropy mode. The kernel takes 8x8 blocks in
category mode, with fixed or coded runs, adaptive quantization and DC
prediction on or off; the codec sends every other config on the card
through the staged path with kernel E (models/codec.py fused_kernel_ok).
"""

from __future__ import annotations

import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.ops import _build, rle, transform
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.tables import CodecOperators

KERNEL_N2 = 64
KERNEL_MODE = "category"


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
    buffer, capacity = bps * units_per_block_worst(n2, coded_runs)."""
    if pixels.device.type == "cpu":
        return encode_stripes_plain(pixels, cfg, n_stripes, ops, adaptive_scale)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    if cfg.n2 != KERNEL_N2 or mode != KERNEL_MODE:
        raise NotImplementedError(
            f"fused encode kernel takes n2={KERNEL_N2} in {KERNEL_MODE!r} "
            f"mode, got n2={cfg.n2} in {mode!r}: not ported yet")
    if pixels.dtype != torch.uint8 or pixels.dim() != 2 \
            or pixels.shape[1] != cfg.n2:
        raise ValueError(f"expected (NB, {cfg.n2}) uint8 blocks, got "
                         f"{tuple(pixels.shape)} {pixels.dtype}")
    if not pixels.is_contiguous():
        raise ValueError("pixels must be contiguous")
    if pixels.shape[0] % n_stripes:
        raise ValueError(f"{pixels.shape[0]} blocks do not split into "
                         f"{n_stripes} stripes")
    if ops.device != pixels.device:
        raise ValueError(f"operators on {ops.device}, pixels on "
                         f"{pixels.device}")
    if cfg.coded_runs and (ops.run_lengths is None
                           or ops.run_lengths.numel() != 65):
        raise ValueError("coded_runs requires a 65-entry run table")
    if ops.cat_lengths.numel() != 16 or ops.m0.shape != (128, 128):
        raise ValueError("category mode on 8x8 blocks requires a 16-entry "
                         "table and the packed (128, 128) operators")
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
    coded = cfg.coded_runs
    lib = _build.library("fused_encode")
    with torch.cuda.device(dev):
        rc = lib.dct_encode_stripes(
            pixels.data_ptr(), ops.m0.data_ptr(), ops.m1.data_ptr(),
            ops.m2.data_ptr(), ops.bias.data_ptr(), ops.m0.shape[1],
            _build.ptr(recip), ops.cat_lengths.data_ptr(),
            ops.cat_codes.data_ptr(),
            _build.ptr(ops.run_lengths if coded else None),
            _build.ptr(ops.run_codes if coded else None),
            bs.run_field_bits(cfg.n2), int(cfg.dc_prediction),
            n_stripes, bps, words.data_ptr(), n_words, bits.data_ptr(),
            block_bits.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    # a stripe too wide for the card's opt-in shared memory fails here
    _build.check(lib, rc, f"encode_stripes ({bps} blocks per stripe)")
    _build.LAUNCHES["encode_stripes"] += 1
    units = words.view(torch.int16)[:, :capacity]
    return bs.PackedStripes(units=units, bit_lengths=bits), block_bits
