"""Adaptive quantization: per-block variance and its u8 wire code (port of
``dct_tpu.ops.quant``: block_variance_flat, variance_code,
scale_from_variance_code).

Every step is the reference's f32 op sequence. The sums are exact (integer
pixels, |x - 128|^2 * n2 < 2^24), so the reduction order does not matter.
"""

from __future__ import annotations

import torch


def block_variance_flat(blocks: torch.Tensor) -> torch.Tensor:
    """Per-block variance E[x^2] - E[x]^2 over FLAT (..., n^2) rows
    (quantization.c:153-169). Returns (...,) float32."""
    x = blocks.to(torch.float32)
    n = x.shape[-1]
    # sum / n, as jnp.mean computes it (not a multiply by 1/n)
    mean = x.sum(-1) / n
    mean_sq = (x * x).sum(-1) / n
    return mean_sq - mean * mean


def variance_code(variance: torch.Tensor) -> torch.Tensor:
    """u8 wire code of clamp(var/1000, 0.1, 1.0): round((norm - 0.1) *
    255 / 0.9), rounding half to even like jnp.round. var / 1000 is a
    true float32 division on every device, as the variance kernel
    (csrc/fused_encode.cu) computes it: the divisor is a tensor on the
    variance's device, since CUDA multiplies by float32(1 / 1000) where it
    is a Python scalar, and that rounds some codes the other way."""
    unit = torch.full((), 1000.0, dtype=torch.float32, device=variance.device)
    norm = torch.clamp(variance / unit, 0.1, 1.0)
    return torch.round((norm - 0.1) * (255.0 / 0.9)).to(torch.uint8)


def scale_from_variance_code(code: torch.Tensor) -> torch.Tensor:
    """Wire code -> quantize-divisor scale in [1.0, 1.9]."""
    norm = 0.1 + code.to(torch.float32) * (0.9 / 255.0)
    return 2.0 - norm
