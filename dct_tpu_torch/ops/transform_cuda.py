"""Kernels A and C (csrc/transform.cu): the port's counterpart of
``dct_tpu.ops.transform_pallas``.

``encode_blocks_kernel`` replaces ``encode_blocks_pallas`` and
``decode_blocks_kernel`` replaces ``decode_blocks_pallas``. For a tensor on
the CPU each wrapper runs the plain version (ops/transform.py); for a CUDA
tensor it checks its operands, launches the kernel and counts the launch,
and never falls back. Kernel A takes n2 in {4, 16, 64, 256} (ENCODE_N2),
on kernel B's tensor-core tile (csrc/transform_core.cuh: integer products
over the operator's byte planes, a rounding certificate, the float32
chain for the coefficients it leaves open), so the analyze pass and B
give the same integers, those of testing.encode_fma_chain. Kernel C
takes n2 in {4, 16, 64} (DECODE_N2): 16x16 decode
has no TPU kernel, and the codec sends it to the plain float32 product
(models/codec.py decode_transform), as the reference sends it to XLA.
Any other n2 raises NotImplementedError.
"""

from __future__ import annotations

import torch

from dct_tpu_torch import tables
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


def integer_operands(ops: CodecOperators, n2: int, device,
                     what: str) -> tuple:
    """(int_planes, int_cert, parts, bias) as kernels A and B read them,
    each checked: on `device`, of its dtype and shape, contiguous, and
    16-byte aligned."""
    p = tables.mma_width(n2)
    want = {
        "int_planes": (ops.int_planes, torch.uint8, (p // 8, p // 32, 32, 32)),
        "int_cert": (ops.int_cert, torch.int32, (p, tables.CERT_FIELDS)),
        "parts": (ops.parts, torch.float32, (3, n2, n2)),
        "bias": (ops.bias, torch.float32, (1, ops.bias.shape[-1])),
    }
    for name, (t, dtype, shape) in want.items():
        if t is None:
            raise ValueError(f"{what}: operators carry no {name}")
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, input on "
                             f"{device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "16-byte aligned")
    if ops.bias.shape[-1] < n2:
        raise ValueError(f"{what}: the bias has fewer than {n2} entries")
    return ops.int_planes, ops.int_cert, ops.parts, ops.bias


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
    frag, cert, parts, bias = integer_operands(ops, cfg.n2, pixels.device,
                                                 "encode_blocks")
    out = torch.empty(pixels.shape, dtype=torch.int32, device=pixels.device)
    if n_blocks == 0:
        return out
    lib = _build.library("transform")
    with torch.cuda.device(pixels.device):
        rc = lib.dct_encode_blocks(
            pixels.data_ptr(), frag.data_ptr(), cert.data_ptr(),
            parts.data_ptr(), bias.data_ptr(), _build.ptr(recip),
            out.data_ptr(), n_blocks, cfg.n2,
            _build.rescue_counter("encode_blocks", pixels.device).data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "encode_blocks")
    _build.LAUNCHES["encode_blocks"] += 1
    return out


def mma_products(px: torch.Tensor, ops: CodecOperators,
                 n2: int) -> torch.Tensor:
    """The tensor-core tile's integer products alone, for testing it: (R,
    P) u8 packed rows on the card (P = tables.mma_width(n2)) -> (R, P)
    int64 x @ W over the block-diagonal integer operator (W of
    tables.certificate_operator). Not a codec path: nothing counts it."""
    p = tables.mma_width(n2)
    if px.dtype != torch.uint8 or px.dim() != 2 or px.shape[1] != p:
        raise ValueError(f"expected (R, {p}) uint8 rows, got "
                         f"{tuple(px.shape)} {px.dtype}")
    px = _aligned(px.contiguous())
    frag = integer_operands(ops, n2, px.device, "mma_products")[0]
    out = torch.empty(px.shape, dtype=torch.int64, device=px.device)
    lib = _build.library("transform")
    with torch.cuda.device(px.device):
        rc = lib.dct_mma_products(px.data_ptr(), frag.data_ptr(),
                                  out.data_ptr(), px.shape[0], p,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mma_products")
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
