"""The codec's constant operators and Huffman tables as torch tensors.

The float64 operators come from ``dct_tpu.tables`` (numpy only). What this
module adds is the part of the reference that needs ``ml_dtypes``: the
three-way bf16 split of the f32 encode operator
(``dct_tpu.tables.fused_encode_operator_split``), done here with
``torch.bfloat16`` — round to nearest even, the same conversion, so the
parts are bit-identical — and the packed block-diagonal forms that
``dct_tpu.ops.transform`` builds for the Pallas kernels.

All of it is gathered in one :class:`CodecOperators` bundle per (config,
chroma, device): the codec's "parameters". The codec has no weights and no
randomness; the bundle is a pure function of the config and the tables.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from dct_tpu import tables as _ref
from dct_tpu.config import CodecConfig
from dct_tpu_torch.ops import huffman as hf

PACKED_N2 = (4, 16, 64)  # block sizes whose n2 divides the 128-lane row


@dataclasses.dataclass(frozen=True)
class CodecOperators:
    """Operators and entropy tables, all on one device.

    m0, m1, m2: (P, P) float32 holding bf16 values — the split encode
        operator; P = 128 (block-diagonal, 128 // n2 blocks per row) for
        n2 in PACKED_N2, else P = n2.
    bias: (1, P) float32 encode bias (the folded -128 level shift).
    m_dec: (P, P) float32 dequant + inverse zigzag + IDCT operator (+128 is
        added separately).
    ac_mask: (1, P) float32, 0 at each block's DC lane, 1 elsewhere.
    cat_lengths, cat_codes: int32 canonical table of the value symbols
        (16 categories, or the direct-mode alphabet); a zero stub in
        "none" mode.
    run_lengths, run_codes: (65,) int32 canonical run table under
        cfg.coded_runs, else None (fixed run field).
    """

    m0: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    bias: torch.Tensor
    m_dec: torch.Tensor
    ac_mask: torch.Tensor
    cat_lengths: torch.Tensor
    cat_codes: torch.Tensor
    run_lengths: torch.Tensor | None = None
    run_codes: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.m0.device

    def with_tables(
        self,
        table: hf.CanonicalTable | None,
        run_table: hf.CanonicalTable | None = None,
    ) -> "CodecOperators":
        """The same operators with other canonical tables (per-image
        tables of the dynamic-table encode)."""
        lengths, codes = _table_tensors(table, self.device)
        run_lengths = run_codes = None
        if run_table is not None:
            run_lengths, run_codes = _table_tensors(run_table, self.device)
        return dataclasses.replace(
            self, cat_lengths=lengths, cat_codes=codes,
            run_lengths=run_lengths, run_codes=run_codes,
        )


def _table_tensors(table: hf.CanonicalTable | None, device):
    if table is None:
        z = torch.zeros(1, dtype=torch.int32, device=device)
        return z, z.clone()
    return (
        torch.as_tensor(np.asarray(table.lengths, np.int32), device=device),
        torch.as_tensor(np.asarray(table.codes, np.int64).astype(np.int32),
                        device=device),
    )


def encode_operator_split(cfg: CodecConfig, chroma: bool = False):
    """(m0, m1, m2, b): float32 numpy arrays, m0 + m1 + m2 ~ M_enc.

    Each part is the bf16 rounding of what the earlier parts left over,
    computed with torch.bfloat16 — bit-identical to
    dct_tpu.tables.fused_encode_operator_split, without ml_dtypes."""
    m, b = _ref.fused_encode_operator(cfg, chroma=chroma)
    rem = torch.from_numpy(np.asarray(m, np.float32))
    parts = []
    for _ in range(3):
        p = rem.to(torch.bfloat16).float()
        parts.append(p.numpy())
        rem = rem - p
    return parts[0], parts[1], parts[2], np.asarray(b, np.float32)


def _block_diag(m: np.ndarray, copies: int) -> np.ndarray:
    """copies x copies block-diagonal tiling of m (n2 x n2) -> 128 x 128."""
    n2 = m.shape[0]
    out = np.zeros((copies * n2, copies * n2), m.dtype)
    for i in range(copies):
        out[i * n2:(i + 1) * n2, i * n2:(i + 1) * n2] = m
    return out


def packed_encode_operator_split(cfg: CodecConfig, chroma: bool = False):
    """Block-diagonal parts (three (P, P)) + (1, P) bias, as
    dct_tpu.ops.transform.packed_encode_operator_split gives them for
    n2 in PACKED_N2; the unpacked (n2, n2) parts otherwise."""
    m0, m1, m2, b = encode_operator_split(cfg, chroma=chroma)
    n2 = cfg.n2
    if n2 not in PACKED_N2:
        return m0, m1, m2, b[None, :]
    copies = 128 // n2
    parts = [_block_diag(p, copies) for p in (m0, m1, m2)]
    return parts[0], parts[1], parts[2], np.tile(b, copies)[None, :]


def packed_decode_operator(cfg: CodecConfig, chroma: bool = False):
    """(P, P) float32 decode operator (+128 bias scalar), block-diagonal
    for n2 in PACKED_N2."""
    m, b = _ref.fused_decode_operator(cfg, chroma=chroma)
    m = np.asarray(m, np.float32)
    if cfg.n2 in PACKED_N2:
        m = _block_diag(m, 128 // cfg.n2)
    return m, float(b)


def packed_ac_mask(n2: int) -> np.ndarray:
    """(1, P) mask: 0 at each block's DC lane, 1 elsewhere."""
    mask = np.ones((1, 128 if n2 in PACKED_N2 else n2), np.float32)
    mask[0, ::n2] = 0.0
    return mask


def from_numpy(
    m0, m1, m2, bias, m_dec, cat_lengths, cat_codes,
    run_lengths=None, run_codes=None, *, n2: int, device="cpu",
) -> CodecOperators:
    """Bundle numpy operators and tables — for example the reference's
    ``dct_tpu.ops.transform.packed_encode_operator_split(cfg)`` (bf16
    parts), ``packed_decode_operator(cfg)[0]`` and
    ``dct_tpu.ops.huffman.default_category_table(q)`` lengths/codes — as
    tensors on ``device``. n2: the block size (cfg.n2) the operators are
    for."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(
            np.asarray(a, np.int64).astype(np.int32), device=device
        )

    return CodecOperators(
        m0=f32(m0), m1=f32(m1), m2=f32(m2),
        bias=f32(np.asarray(bias, np.float32).reshape(1, -1)),
        m_dec=f32(m_dec),
        ac_mask=f32(packed_ac_mask(n2)),
        cat_lengths=i32(cat_lengths),
        cat_codes=i32(cat_codes),
        run_lengths=None if run_lengths is None else i32(run_lengths),
        run_codes=None if run_codes is None else i32(run_codes),
    )


@functools.lru_cache(maxsize=32)
def build(
    cfg: CodecConfig, chroma: bool = False, device: str | torch.device = "cpu"
) -> CodecOperators:
    """The port's own bundle for ``cfg``: operators plus the static
    tables (the default category table in category mode, a zero stub
    otherwise; the default run table under cfg.coded_runs). Per-image
    tables replace them through CodecOperators.with_tables."""
    m0, m1, m2, b = packed_encode_operator_split(cfg, chroma=chroma)
    m_dec, _ = packed_decode_operator(cfg, chroma=chroma)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    if mode == "category":
        t = hf.default_category_table(cfg.quality)
        lengths, codes = t.lengths, t.codes
    else:
        lengths = codes = np.zeros(1, np.int32)
    run_lengths = run_codes = None
    if cfg.coded_runs:
        rt = hf.default_run_table(cfg.quality)
        run_lengths, run_codes = rt.lengths, rt.codes
    return from_numpy(
        m0, m1, m2, b, m_dec, lengths, codes, run_lengths, run_codes,
        n2=cfg.n2, device=device,
    )
