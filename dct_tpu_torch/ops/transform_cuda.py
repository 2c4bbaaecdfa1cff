"""Kernels A and C (csrc/transform.cu): the port's counterpart of
``dct_tpu.ops.transform_pallas``.

``encode_blocks_kernel`` replaces ``encode_blocks_pallas`` and
``decode_blocks_kernel`` replaces ``decode_blocks_pallas``. For a tensor on
the CPU each wrapper runs the plain version (ops/transform.py); for a CUDA
tensor it checks its operands, launches the kernel and counts the launch,
and never falls back. Kernel A takes n2 in {4, 16, 64, 256} (ENCODE_N2):
at 256 it runs kernel B's 16x16 chain, so the analyze pass and B give the
same integers. Kernel C takes n2 in {4, 16, 64} (DECODE_N2): 16x16 decode
has no TPU kernel, and the codec sends it to the plain float32 product
(models/codec.py decode_transform), as the reference sends it to XLA.
Any other n2 raises NotImplementedError.
"""

from __future__ import annotations

import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.ops import _build, transform
from dct_tpu_torch.tables import PACKED_N2, CodecOperators

ENCODE_N2 = PACKED_N2 + (256,)
DECODE_N2 = PACKED_N2


def _check_launch(x: torch.Tensor, cfg: CodecConfig, operator: torch.Tensor,
                  dtypes: tuple, what: str, kernel_n2: tuple) -> None:
    if cfg.n2 not in kernel_n2:
        raise NotImplementedError(
            f"{what} kernel takes n2 in {kernel_n2}, got {cfg.n2}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: expected {dtypes}, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != cfg.n2:
        raise ValueError(f"{what}: expected (..., B, {cfg.n2}), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if operator.device != x.device:
        raise ValueError(f"{what}: operators on {operator.device}, input on "
                         f"{x.device}")
    p = 128 if cfg.n2 in PACKED_N2 else cfg.n2
    if operator.shape != (p, p):
        raise ValueError(f"{what}: n2={cfg.n2} requires the ({p}, {p}) "
                         f"operators, got {tuple(operator.shape)}")


def row_major(ops: CodecOperators) -> tuple:
    """The encode operator parts as the kernels read them, row-major: the
    packed forms already are; the (256, 256) parts of 16x16 blocks come
    transposed in memory from tables.encode_operator_split and are
    copied."""
    return tuple(m.contiguous() for m in (ops.m0, ops.m1, ops.m2))


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
    _check_launch(pixels, cfg, ops.m0, (torch.uint8,), "encode_blocks",
                  ENCODE_N2)
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
    m0, m1, m2 = row_major(ops)
    lib = _build.library("transform")
    with torch.cuda.device(pixels.device):
        rc = lib.dct_encode_blocks(
            pixels.data_ptr(), m0.data_ptr(), m1.data_ptr(),
            m2.data_ptr(), ops.bias.data_ptr(), m0.shape[1],
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
    _check_launch(zz, cfg, ops.m_dec, (torch.int16, torch.int32),
                  "decode_blocks", DECODE_N2)
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
