"""Fused encode/decode front-ends in plain PyTorch (port of
``dct_tpu.ops.transform``): the plain versions of kernels A (encode) and C
(decode) in ops/transform_cuda.py.

Encode is ``round(x @ M_enc + b)`` with the operator split into three bf16
parts held as float32 (tables.CodecOperators): u8 pixels and bf16 values
multiply exactly in float32, so three float32 products summed left to
right — ``((x@m0 + x@m1) + x@m2) + b`` — are the reference's three bf16
passes with float32 accumulation (transform.split_operand_matmul). Decode
is an f32 product with the dequant + inverse zigzag + IDCT operator, +128,
round, clip. For n2 in PACKED_N2 both run in the reference's packed-row
block-diagonal form (128 // n2 blocks per 128-wide row), the same
contraction the reference's XLA path runs.

Rounding is half away from zero, ``trunc(y +- 0.5)``, as C's round():
torch.round rounds half to even and is never used on coefficients.

On a CUDA tensor the products must run in full float32: decode
coefficients reach +-2047 (12 bits), which TF32's 10-bit mantissa cannot
hold. This module sets no backend switch at import; a caller that runs
these plain versions on the card turns TF32 off itself (chip_smoke.py and
tests/test_torch_kernels.py do), or runs them inside full_float32() as the
codec's 16x16 route does.
"""

from __future__ import annotations

import contextlib

import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.tables import PACKED_N2, CodecOperators


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products on the card in full float32 (TF32 off) for
    the block; the caller's switch is restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C round(): trunc(x + 0.5) for x >= 0, trunc(x - 0.5) below."""
    half = torch.where(x >= 0, 0.5, -0.5).to(x.dtype)
    return torch.trunc(x + half)


def level_shift(pixels: torch.Tensor) -> torch.Tensor:
    """u8 pixels -> centered float32: x - 128 (dct.c:115)."""
    return pixels.to(torch.float32) - 128.0


def expand_block_scale(s: torch.Tensor, n2: int) -> torch.Tensor:
    """(rows, bpr) per-block scalar -> (rows, 128) lanewise."""
    return s.repeat_interleave(n2, dim=1)


def pack_rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(B, n2) -> ((ceil(B/bpr), 128) packed rows, original B)."""
    B, n2 = x.shape
    bpr = 128 // n2
    rows = -(-B // bpr)
    pad = rows * bpr - B
    if pad:
        x = torch.cat([x, x.new_zeros(pad, n2)])
    return x.reshape(rows, 128), B


def _pad_scale(s: torch.Tensor, rows: int, bpr: int) -> torch.Tensor:
    pad = rows * bpr - s.shape[0]
    if pad:
        s = torch.cat([s, s.new_ones(pad)])
    return s.reshape(rows, bpr)


def split_operand_matmul(x, m0, m1, m2, b) -> torch.Tensor:
    """((x@m0 + x@m1) + x@m2) + b in float32, x holding integers <= 255."""
    y = x @ m0
    y = y + x @ m1
    y = y + x @ m2
    return y + b


def reciprocal_scale(adaptive_scale: torch.Tensor) -> torch.Tensor:
    """1 / scale in float32, computed once per block and shared by every
    encode path (plain and kernels), as the reference does."""
    s = adaptive_scale.to(torch.float32)
    return torch.ones_like(s) / s


def encode_blocks(
    pixels: torch.Tensor,
    cfg: CodecConfig,
    ops: CodecOperators,
    adaptive_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., B, n2) u8 pixel blocks -> (..., B, n2) int32 quantized zigzag
    coefficients. adaptive_scale: (..., B) quantize-divisor scale, required
    under cfg.adaptive (AC coefficients are multiplied by its
    reciprocal)."""
    lead, n2 = pixels.shape[:-2], cfg.n2
    x = pixels.reshape(-1, n2).to(torch.float32)
    r = None
    if cfg.adaptive:
        if adaptive_scale is None:
            raise ValueError("adaptive quantization requires adaptive_scale")
        r = reciprocal_scale(adaptive_scale.reshape(-1))
    if n2 in PACKED_N2:
        bpr = 128 // n2
        x2, B = pack_rows(x)
        y = split_operand_matmul(x2, ops.m0, ops.m1, ops.m2, ops.bias)
        if r is not None:
            r2 = expand_block_scale(_pad_scale(r, y.shape[0], bpr), n2)
            y = torch.where(ops.ac_mask != 0, y * r2, y)
        y = y.reshape(-1, n2)[:B]
    elif n2 == 256:
        # explicit K=128 halves per part, the reference's 16x16 association
        xlo, xhi = x[:, :128], x[:, 128:]
        y = None
        for part in (ops.m0, ops.m1, ops.m2):
            t = xlo @ part[:128] + xhi @ part[128:]
            y = t if y is None else y + t
        y = y + ops.bias
        if r is not None:
            y = torch.where(ops.ac_mask != 0, y * r[:, None], y)
    else:
        y = split_operand_matmul(x, ops.m0, ops.m1, ops.m2, ops.bias)
        if r is not None:
            y = torch.where(ops.ac_mask != 0, y * r[:, None], y)
    return round_half_away(y).to(torch.int32).reshape(*lead, -1, n2)


def decode_blocks(
    zz: torch.Tensor,
    cfg: CodecConfig,
    ops: CodecOperators,
    adaptive_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., B, n2) integer zigzag coefficients -> (..., B, n2) u8 pixel
    blocks: clip(round(z * s @ M_dec + 128), 0, 255), s applied to AC
    only under cfg.adaptive."""
    lead, n2 = zz.shape[:-2], cfg.n2
    z = zz.reshape(-1, n2).to(torch.float32)
    s = None
    if cfg.adaptive:
        if adaptive_scale is None:
            raise ValueError("adaptive dequantization requires adaptive_scale")
        s = adaptive_scale.reshape(-1).to(torch.float32)
    B = z.shape[0]
    if n2 in PACKED_N2:
        bpr = 128 // n2
        z, _ = pack_rows(z)
        if s is not None:
            s2 = expand_block_scale(_pad_scale(s, z.shape[0], bpr), n2)
            z = torch.where(ops.ac_mask != 0, z * s2, z)
    elif s is not None:
        z = torch.where(ops.ac_mask != 0, z * s[:, None], z)
    y = z @ ops.m_dec + 128.0
    rec = torch.clamp(round_half_away(y), 0.0, 255.0).to(torch.uint8)
    return rec.reshape(-1, n2)[:B].reshape(*lead, -1, n2)
