"""Kernels A and C (csrc/transform.cu): the port's counterpart of
``dct_tpu.ops.transform_pallas``.

``encode_blocks_kernel`` replaces ``encode_blocks_pallas`` and
``decode_blocks_kernel`` replaces ``decode_blocks_pallas``. For a tensor on
the CPU each wrapper runs the plain version (ops/transform.py); for a CUDA
tensor it checks its operands, launches the kernel and counts the launch,
and never falls back. The kernels take n2 in {4, 16, 64} (KERNEL_N2) and
raise NotImplementedError for any other: 16x16 blocks (n2 = 256) have no
TPU kernel either, and the codec sends them to the plain float32 products
(models/codec.py encode_transform / decode_transform), as the reference
sends them to XLA.
"""

from __future__ import annotations

import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.ops import _build, transform
from dct_tpu_torch.tables import PACKED_N2, CodecOperators

KERNEL_N2 = PACKED_N2


def _check_launch(x: torch.Tensor, cfg: CodecConfig, ops: CodecOperators,
                  dtypes: tuple, what: str) -> None:
    if cfg.n2 not in KERNEL_N2:
        raise NotImplementedError(
            f"{what} kernel takes n2 in {KERNEL_N2}, got {cfg.n2}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: expected {dtypes}, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != cfg.n2:
        raise ValueError(f"{what}: expected (..., B, {cfg.n2}), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if ops.device != x.device:
        raise ValueError(f"{what}: operators on {ops.device}, input on "
                         f"{x.device}")
    if ops.m0.shape != (128, 128) or ops.m_dec.shape != (128, 128):
        raise ValueError(f"{what}: operators are not the packed (128, 128) "
                         f"form of n2={cfg.n2}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where its data does not start on 16 bytes (the
    kernels read their input with 16-byte copies)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def encode_blocks_kernel(
    pixels: torch.Tensor,
    cfg: CodecConfig,
    ops: CodecOperators,
    adaptive_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., B, n2) u8 blocks -> (..., B, n2) int32 quantized zigzag
    coefficients; transform.encode_blocks on the CPU, kernel A on CUDA."""
    if pixels.device.type == "cpu":
        return transform.encode_blocks(pixels, cfg, ops, adaptive_scale)
    _check_launch(pixels, cfg, ops, (torch.uint8,), "encode_blocks")
    pixels = _aligned(pixels)
    n_blocks = pixels.numel() // cfg.n2
    recip = None
    if cfg.adaptive:
        if adaptive_scale is None:
            raise ValueError("adaptive quantization requires adaptive_scale")
        recip = transform.reciprocal_scale(adaptive_scale.reshape(-1))
        if recip.shape[0] != n_blocks or recip.device != pixels.device:
            raise ValueError("adaptive_scale must hold one scale per block")
    out = torch.empty(pixels.shape, dtype=torch.int32, device=pixels.device)
    if n_blocks == 0:
        return out
    lib = _build.library("transform")
    with torch.cuda.device(pixels.device):
        rc = lib.dct_encode_blocks(
            pixels.data_ptr(), ops.m0.data_ptr(), ops.m1.data_ptr(),
            ops.m2.data_ptr(), ops.bias.data_ptr(), ops.m0.shape[1],
            _build.ptr(recip), out.data_ptr(), n_blocks, cfg.n2,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "encode_blocks")
    _build.LAUNCHES["encode_blocks"] += 1
    return out


def decode_blocks_kernel(
    zz: torch.Tensor,
    cfg: CodecConfig,
    ops: CodecOperators,
    adaptive_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., B, n2) zigzag coefficients -> (..., B, n2) u8 pixel blocks;
    transform.decode_blocks on the CPU, kernel C on CUDA. The kernel reads
    int16, the wire's coefficient type; int32 input is narrowed to it."""
    if zz.device.type == "cpu":
        return transform.decode_blocks(zz, cfg, ops, adaptive_scale)
    _check_launch(zz, cfg, ops, (torch.int16, torch.int32), "decode_blocks")
    zz = _aligned(zz.to(torch.int16))
    n_blocks = zz.numel() // cfg.n2
    scale = None
    if cfg.adaptive:
        if adaptive_scale is None:
            raise ValueError("adaptive dequantization requires adaptive_scale")
        scale = adaptive_scale.reshape(-1).to(torch.float32).contiguous()
        if scale.shape[0] != n_blocks or scale.device != zz.device:
            raise ValueError("adaptive_scale must hold one scale per block")
    out = torch.empty(zz.shape, dtype=torch.uint8, device=zz.device)
    if n_blocks == 0:
        return out
    lib = _build.library("transform")
    with torch.cuda.device(zz.device):
        rc = lib.dct_decode_blocks(
            zz.data_ptr(), ops.m_dec.data_ptr(), ops.m_dec.shape[1],
            _build.ptr(scale), out.data_ptr(), n_blocks, cfg.n2,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "decode_blocks")
    _build.LAUNCHES["decode_blocks"] += 1
    return out
