"""Per-block variance-adaptive quantization, in plain PyTorch in float64
on the CPU with TF32 off for every product: which u8 variance code a
block may carry and which zigzag coefficients it may hold.

The mode (erkinov-wtf/dct ``src/quantization.c:153-211``):

- a block's variance over its level-shifted samples x - 128,
  E[x^2] - E[x]^2;
- its normalised variance v = clamp(var / 1000, 0.1, 1);
- every AC quant step times 2 - v, in [1, 1.9]; the DC step unscaled.

Where this departs from ``quantization.c``:

- The scale comes from the u8 code the container carries,
  code = round((v - 0.1) * 255 / 0.9), half to even, and
  s = 2 - (0.1 + code * 0.9 / 255), not from v itself
  (``quantization.c:186-193``): the decoder reads only the code, so the
  encoder quantizes with the scale the decoder will use.
- ``quantization.c`` floors each scaled step at 1.0 (``:203-205``). That
  never binds: every step q >= 1 and s >= 1.

A value the codec rounds is accepted in [ceil(v - 0.5 - tol),
floor(v + 0.5 + tol)] (``judge.accepted``), v its float64 value and tol
the most the codec's float32 operations can move it, with u = 2^-24,
float32's unit roundoff, for each rounding:

- The code (``dct_tpu_torch/ops/quant.py``). The two sums are exact
  (integers, |x - 128|^2 * 64 < 2^24) and so are the means (a division
  by 64). Then mean^2 rounds (u mean^2), the subtraction rounds
  (u |var|) and /1000 rounds (u |var| / 1000, u |var| before it): at
  most u (mean^2 + 2 |var|) in the variance, times 255 / (0.9 * 1000)
  in code units, since the clamp moves no two values further apart.
  Then 0.1 in float32 and the subtraction (u 0.1 + u 0.9 = u, before
  the factor 255 / 0.9), the factor itself in float32 and the product
  (u c each, c <= 255): tol = u (0.2833 (mean^2 + 2 |var|) + 283.4 +
  510), 4.7e-5 to 8.8e-4.
- A DC coefficient: ``judge.encode_tolerance``, the transform's, as for
  static quantization.
- An AC coefficient: the codec multiplies the float32 transform y by
  fl(1 / s32), s32 = fl(2 - fl(fl(0.1) + fl(code * fl(0.9 / 255)))).
  s32 is off s by at most u (0.9 + 0.9 + 0.1 + 1 + 1.9) = 4.8 u (each
  rounding at the size of its result), so relatively by 4.8 u since
  s >= 1; the reciprocal and the product round once each: 6.8 u, taken
  as SCALE_ROUNDINGS = 7 units of |y / s|. The transform's error reaches
  the product divided by s: tol = encode_tolerance / s * (1 + 7 u) +
  7 u |y / s|.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench.reference import judge, tables

U = 2.0 ** -24
VARIANCE_UNIT = 1000.0
V_MIN, V_MAX = 0.1, 1.0
CODE_MAX = 255
CODE_STEP = (V_MAX - V_MIN) / CODE_MAX      # 0.9 / 255
SCALE_ROUNDINGS = 7.0


@contextlib.contextmanager
def exact():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def shifted_blocks(plane) -> torch.Tensor:
    """(NB, 64) float64 row-major 8x8 blocks of the plane, minus 128."""
    return torch.from_numpy(judge.blocks(np.asarray(plane, np.float64))
                            - 128.0)


def variances(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(var, mean^2), each (NB,), of (NB, 64) level-shifted blocks."""
    mean = x.mean(dim=1)
    mean2 = mean * mean
    return (x * x).mean(dim=1) - mean2, mean2


def normalized(var: torch.Tensor) -> torch.Tensor:
    """v = clamp(var / 1000, 0.1, 1)."""
    return torch.clamp(var / VARIANCE_UNIT, V_MIN, V_MAX)


def code_value(var: torch.Tensor) -> torch.Tensor:
    """The code before rounding: (v - 0.1) * 255 / 0.9."""
    return (normalized(var) - V_MIN) / CODE_STEP


def code_tolerance(var: torch.Tensor, mean2: torch.Tensor) -> torch.Tensor:
    """The most the codec's float32 steps move code_value (docstring)."""
    per_var = CODE_MAX / (V_MAX - V_MIN) / VARIANCE_UNIT
    return U * (per_var * (mean2 + 2.0 * var.abs())
                + CODE_MAX / (V_MAX - V_MIN) + 2.0 * CODE_MAX)


def scale(code) -> torch.Tensor:
    """The AC steps' factor a u8 code stands for: 2 - (0.1 + code *
    0.9 / 255), float64."""
    code = torch.as_tensor(np.asarray(code)).to(torch.float64)
    return 2.0 - (V_MIN + code * CODE_STEP)


class Plane:
    """What the reference accepts of one (H, W) u8 plane's blocks."""

    def __init__(self, plane, quality: int):
        with exact():
            x = shifted_blocks(plane)
            var, mean2 = variances(x)
            c = code_value(var)
            self.code_lo, self.code_hi = judge.accepted(
                c.numpy(), c.numpy(), code_tolerance(var, mean2).numpy(),
                (0, CODE_MAX))
            # round half to even, as the codec's torch.round
            self.nearest = torch.round(c).to(torch.int64).numpy()
            k = torch.from_numpy(tables.coefficient_operator(quality, False))
            self.y = x @ k
        self.tol = torch.from_numpy(judge.encode_tolerance(quality, False))
        self.var = var.numpy()

    def code_mismatches(self, codes) -> np.ndarray:
        """(NB,) bool: the codes outside their accepted interval."""
        codes = np.asarray(codes).astype(np.int64)
        return (codes < self.code_lo) | (codes > self.code_hi)

    def coefficient_bounds(self, codes):
        """Accepted (lo, hi) (NB, 64) zigzag coefficients quantized with
        the steps the (NB,) u8 ``codes`` stand for: DC as for static
        quantization, each AC the float64 coefficient over the code's
        scale."""
        s = scale(codes)[:, None]
        v = self.y.clone()
        v[:, 1:] = self.y[:, 1:] / s
        tol = self.tol.expand_as(v).clone()
        tol[:, 1:] = (self.tol[1:] / s * (1.0 + SCALE_ROUNDINGS * U)
                      + SCALE_ROUNDINGS * U * v[:, 1:].abs())
        v, tol = v.numpy(), tol.numpy()
        return judge.accepted(v, v, tol)

    def judged_codes(self, codes) -> np.ndarray:
        """The program's codes where accepted, the nearest elsewhere: the
        codes each block's coefficients are judged under."""
        codes = np.asarray(codes).astype(np.int64)
        return np.where(self.code_mismatches(codes), self.nearest, codes)
