"""Checking helpers shared by the tests and chip_smoke.py: the float64
values the codec rounds from, and the tie criterion that decides whether
two roundings of them may differ. No codec path uses this module.

Two float32 paths that sum the same exact products in different orders may
round a value that lies within a few ulp of a .5 boundary to neighbouring
integers. Such a mismatch is a tie: at most 1 apart, with the float64 value
within ``tol`` of the boundary. Encode holds ties to ENCODE_TIE_TOL (the
criterion of tests/test_parity.py), decode to DECODE_TIE_TOL.
"""

from __future__ import annotations

import numpy as np

from dct_tpu import tables as dct_tables
from dct_tpu.config import CodecConfig

ENCODE_TIE_TOL = 1e-6
DECODE_TIE_TOL = 1e-3


def _kron_zigzag_f64(cfg: CodecConfig, chroma: bool = False):
    """(D (x) D) rows in zigzag order and the zigzag quant steps, float64."""
    n = cfg.block_size
    d = dct_tables.dct_basis(n)
    perm = dct_tables.zigzag_permutation(n)
    qz = dct_tables.quant_matrix(n, cfg.quality, chroma=chroma).ravel()[perm]
    return np.kron(d, d)[perm, :], qz


def encode_values_f64(pixels: np.ndarray, cfg: CodecConfig,
                      recip: np.ndarray | None = None) -> np.ndarray:
    """The float64 value each encoded coefficient rounds from: (B, n2) u8
    blocks -> (B, n2) ``(x - 128) @ M_enc`` (times the reciprocal scale on
    AC)."""
    kz, qz = _kron_zigzag_f64(cfg)
    y = (np.asarray(pixels, np.float64) - 128.0) @ (kz / qz[:, None]).T
    if recip is not None:
        y[:, 1:] *= np.asarray(recip, np.float64)[:, None]
    return y


def decode_values_f64(zz: np.ndarray, cfg: CodecConfig,
                      scale: np.ndarray | None = None) -> np.ndarray:
    """The float64 pixel values decode rounds from: (B, n2) coefficients
    -> (B, n2) ``z * s @ M_dec + 128`` before rounding and clipping."""
    kz, qz = _kron_zigzag_f64(cfg)
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
