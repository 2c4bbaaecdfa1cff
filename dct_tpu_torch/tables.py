"""The codec's constant operators and Huffman tables.

The float64 builders — DCT basis, quality-scaled quant matrix, zigzag
permutation, the fused encode and decode operators — are the port's copy
of ``dct_tpu.tables`` (numpy; the tests hold the two equal). Three things
are the port's own: the three-way bf16 split of the f32 encode operator,
done with ``torch.bfloat16`` (round to nearest even, the same conversion
as the reference's ``ml_dtypes`` one, so the parts are bit-identical); the
packed block-diagonal forms the reference's kernels take; and the torch
tensors on a device.

Beside the bf16 parts the bundle carries their exact integer form, which
kernels A and B multiply on the tensor cores: each column k of m0 + m1 +
m2 is an int32 column W[:, k] times 2^-e_k, split into four byte planes,
with the per-column constants of the rounding certificate
(integer_operator, byte_planes, mma_fragments, certificate_constants).

All of it is gathered in one :class:`CodecOperators` bundle per (config,
chroma, device): the codec's "parameters". The codec has no weights and no
randomness; the bundle is a pure function of the config and the tables.

Fused operators: for a block X (N x N) the 2D DCT is vec(D X D^T) =
(D (x) D) vec(X), so a batch of blocks is one (B, N^2) @ (N^2, N^2)
product. Folded into that one matrix, column by column: the zigzag
permutation, the quantization divide, and the -128 level shift as a bias.
Encode is ``round(x @ M_enc + b_enc)``; decode folds the dequantization
and the inverse zigzag into a second matrix with a +128 bias.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.ops import huffman as hf

# Standard JPEG luminance and chrominance quantization tables (ITU-T T.81
# Annex K.1, K.2).
JPEG_LUMA_QUANT = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float64,
)
JPEG_CHROMA_QUANT = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float64,
)


@functools.lru_cache(maxsize=None)
def dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis D (n x n), float64: D[i, j] = alpha(i) *
    cos(pi (2j + 1) i / 2n), alpha(0) = 1/sqrt(n), alpha(i > 0) =
    sqrt(2/n)."""
    i = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    alpha = np.where(i == 0, 1.0 / np.sqrt(n), np.sqrt(2.0 / n))
    return alpha * np.cos(np.pi * (2.0 * j + 1.0) * i / (2.0 * n))


def quality_scale_factor(quality: int) -> float:
    """JPEG quality -> quant-table scale: 5000/q / 100 below 50, (200 -
    2q) / 100 from 50 (0 at q100, where every entry clamps to 1)."""
    q = min(100, max(1, int(quality)))
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    return scale / 100.0


@functools.lru_cache(maxsize=None)
def quant_matrix(block_size: int, quality: int, chroma: bool = False) -> np.ndarray:
    """Quality-scaled quantization matrix, float64, clamped to [1, 255]:
    the JPEG table for 8x8 blocks, ``(1 + sqrt(i^2 + j^2)) * scale * 8``
    for other sizes."""
    scale = quality_scale_factor(quality)
    if block_size == 8:
        base = JPEG_CHROMA_QUANT if chroma else JPEG_LUMA_QUANT
        m = base * scale
    else:
        i = np.arange(block_size)[:, None].astype(np.float64)
        j = np.arange(block_size)[None, :].astype(np.float64)
        m = (1.0 + np.sqrt(i * i + j * j)) * scale * 8.0
    return np.clip(m, 1.0, 255.0)


@functools.lru_cache(maxsize=None)
def zigzag_permutation(n: int) -> np.ndarray:
    """Flat (row-major) indices in zigzag order, int32 (n*n,):
    ``zigzag[k] = block.ravel()[perm[k]]``. Even anti-diagonals walk
    up-right, odd ones down-left."""
    order = []
    for s in range(2 * (n - 1) + 1):
        if s % 2 == 0:
            i = min(s, n - 1)
            while i >= 0 and (s - i) < n:
                order.append(i * n + (s - i))
                i -= 1
        else:
            i = max(0, s - n + 1)
            while i < n and (s - i) >= 0:
                order.append(i * n + (s - i))
                i += 1
    return np.asarray(order, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def inverse_zigzag_permutation(n: int) -> np.ndarray:
    """Inverse permutation: ``block.ravel()[i] = zigzag[inv_perm[i]]``."""
    perm = zigzag_permutation(n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv


def _kron_dct(n: int) -> np.ndarray:
    """(D (x) D), float64 (n^2, n^2): the row-major-flattened 2D DCT."""
    d = dct_basis(n)
    return np.kron(d, d)


def _zigzag_quant(cfg: CodecConfig, chroma: bool = False) -> np.ndarray:
    """Quant table in zigzag order, float64 (n^2,)."""
    q = quant_matrix(cfg.block_size, cfg.quality, chroma=chroma).ravel()
    return q[zigzag_permutation(cfg.block_size)]


@functools.lru_cache(maxsize=None)
def fused_encode_operator(cfg: CodecConfig, chroma: bool = False):
    """(M_enc, b_enc), quantized zigzag coefficients = round(x @ M_enc +
    b_enc) for (B, n^2) raw u8 blocks: M_enc[:, k] = (D (x) D)[perm[k], :]
    / q_zz[k], b_enc[k] = -128 * sum_j (D (x) D)[perm[k], j] / q_zz[k].
    Built in float64, returned as cfg.dtype."""
    kp = _kron_dct(cfg.block_size)[zigzag_permutation(cfg.block_size), :]
    kp = kp / _zigzag_quant(cfg, chroma=chroma)[:, None]
    bias = -128.0 * kp.sum(axis=1)
    dtype = np.dtype(cfg.dtype)
    return kp.T.astype(dtype), bias.astype(dtype)


@functools.lru_cache(maxsize=None)
def fused_decode_operator(cfg: CodecConfig, chroma: bool = False):
    """(M_dec, b_dec), pixels = clip(round(z @ M_dec + b_dec), 0, 255) for
    (B, n^2) zigzag coefficients: M_dec[k, :] = dq[k] * (D (x) D)[perm[k],
    :], b_dec = 128. dq is q_zz, or 1/q_zz under cfg.compat_b1 without
    adaptive quantization (the C reference's bug B1 afflicts only its
    non-adaptive path)."""
    n = cfg.block_size
    qz = _zigzag_quant(cfg, chroma=chroma)
    dq = (1.0 / qz) if (cfg.compat_b1 and not cfg.adaptive) else qz
    m = dq[:, None] * _kron_dct(n)[zigzag_permutation(n), :]
    dtype = np.dtype(cfg.dtype)
    return m.astype(dtype), np.asarray(128.0, dtype=dtype)


@functools.lru_cache(maxsize=None)
def adaptive_scale_mask(cfg: CodecConfig) -> np.ndarray:
    """Per-zigzag-coefficient mask of the adaptive scale: 0 at DC, 1 on
    AC."""
    m = np.ones(cfg.n2, dtype=np.dtype(cfg.dtype))
    m[0] = 0.0
    return m


PACKED_N2 = (4, 16, 64)  # block sizes whose n2 divides the 128-lane row
MMA_N2 = (4, 16, 64, 256)  # block sizes kernels A and B take on the tensor cores
U32 = 2.0 ** -24  # float32's unit roundoff


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
    int_planes: (P/8, P/32, 32, 32) uint8, the integer operator's four
        byte planes in the B-fragment order of mma.m16n8k32 (mma_fragments);
        P = mma_width(n2). None for n2 outside MMA_N2.
    int_cert: (3, P) float64 per packed column: 2^-e_k, the bias, and the
        certificate's error constant (certificate_constants).
    parts_t: (3, n2, n2) float32, the bf16 parts transposed (row k =
        coefficient k): the rescue's operand, one coefficient's chain
        reading contiguous memory.
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
    int_planes: torch.Tensor | None = None
    int_cert: torch.Tensor | None = None
    parts_t: torch.Tensor | None = None

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
    computed with torch.bfloat16 — bit-identical to the reference's
    ml_dtypes split (``fused_encode_operator_split``)."""
    m, b = fused_encode_operator(cfg, chroma=chroma)
    rem = torch.from_numpy(np.asarray(m, np.float32))
    parts = []
    for _ in range(3):
        p = rem.to(torch.bfloat16).float()
        parts.append(p.numpy())
        rem = rem - p
    return parts[0], parts[1], parts[2], np.asarray(b, np.float32)


def _block_diag(m: np.ndarray, copies: int) -> np.ndarray:
    """copies x copies block-diagonal tiling of m (n2 x n2)."""
    n2 = m.shape[0]
    out = np.zeros((copies * n2, copies * n2), m.dtype)
    for i in range(copies):
        out[i * n2:(i + 1) * n2, i * n2:(i + 1) * n2] = m
    return out


def packed_encode_operator_split(cfg: CodecConfig, chroma: bool = False):
    """Block-diagonal parts (three (P, P)) + (1, P) bias, as the
    reference's ``packed_encode_operator_split`` gives them for n2 in
    PACKED_N2; the unpacked (n2, n2) parts otherwise."""
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
    m, b = fused_decode_operator(cfg, chroma=chroma)
    m = np.asarray(m, np.float32)
    if cfg.n2 in PACKED_N2:
        m = _block_diag(m, 128 // cfg.n2)
    return m, float(b)


def packed_ac_mask(n2: int) -> np.ndarray:
    """(1, P) mask: 0 at each block's DC lane, 1 elsewhere."""
    mask = np.ones((1, 128 if n2 in PACKED_N2 else n2), np.float32)
    mask[0, ::n2] = 0.0
    return mask


def mma_width(n2: int) -> int:
    """P, the packed row the tensor-core tile takes: n2, or 32 (the mma's
    K) for n2 below it, 32 // n2 blocks a row under a block-diagonal
    operator."""
    return max(n2, 32)


def _lowest_bit(a: np.ndarray) -> np.ndarray:
    """Exponent of the lowest set bit of each nonzero float64 value (a
    large sentinel for zeros): a == (odd integer) * 2^result."""
    mant, ex = np.frexp(a)
    mi = np.abs(np.ldexp(mant, 53).astype(np.int64))  # |a| = mi 2^(ex - 53)
    low = np.frexp((mi & -mi).astype(np.float64))[1] - 1
    return np.where(mi != 0, ex - 53 + low, np.iinfo(np.int32).max)


def integer_operator(m0, m1, m2):
    """(W, e): int64 (n2, n2) and (n2,) with W[:, k] * 2^-e[k] equal to
    m0 + m1 + m2 (the bf16 parts) exactly, e[k] the least exponent that
    makes every part's column k integral. Raises if a column needs more
    than 31 bits (two's complement int32)."""
    parts = [np.asarray(m, np.float64) for m in (m0, m1, m2)]
    lsb = np.min([_lowest_bit(p).min(axis=0) for p in parts], axis=0)
    e = -np.where(lsb == np.iinfo(np.int32).max, 0, lsb).astype(np.int64)
    w = sum(np.ldexp(p, e[None, :]).astype(np.int64) for p in parts)
    if np.abs(w).max() >= 2 ** 31:
        raise ValueError("an operator column spans more than 31 bits")
    return w, e


def byte_planes(w: np.ndarray) -> np.ndarray:
    """(4, ...) int64 planes of int32 values w: bits 0-7, 8-15 and 16-23
    unsigned, bits 24-31 signed (two's complement), so that w = sum_l
    2^(8 l) plane_l. A u8 pixel times a plane value is a u8 x u8 or u8 x s8
    product, and 255 * 255 * 256 < 2^31 keeps every int32 sum exact."""
    w = np.asarray(w, np.int64)
    return np.stack([(w >> 8 * l) & 0xFF for l in range(3)] + [w >> 24])


def mma_fragments(planes: np.ndarray) -> np.ndarray:
    """(4, P, P) planes (row j = input pixel, column k = output) in the
    order the tile reads them: (P/8, P/32, 32, 32) uint8, for n-tile nt,
    k-step ks and lane (group g = lane / 4, thread t = lane % 4) 32 bytes,
    plane l's two B-fragment registers of mma.m16n8k32 (rows ks*32 + 4t +
    i, then ks*32 + 16 + 4t + i, of column nt*8 + g; byte i little-endian),
    planes in order: one 16-byte load gives planes 0-1, the next 2-3."""
    p = planes.shape[1]
    nt = np.arange(p // 8)[:, None, None, None, None, None]
    ks = np.arange(p // 32)[None, :, None, None, None, None]
    lane = np.arange(32)[None, None, :, None, None, None]
    pl = np.arange(4)[None, None, None, :, None, None]
    h = np.arange(2)[None, None, None, None, :, None]
    i = np.arange(4)[None, None, None, None, None, :]
    rows = ks * 32 + 16 * h + 4 * (lane % 4) + i
    cols = nt * 8 + lane // 4
    frag = (np.asarray(planes, np.int64) & 0xFF)[pl, rows, cols]
    return frag.astype(np.uint8).reshape(p // 8, p // 32, 32, 32)


def certificate_constants(m0, m1, m2, b, e) -> np.ndarray:
    """(3, n2) float64 per coefficient k: 2^-e_k, the bias b_k, and E_k =
    gamma_{n2+3} (255 sum_i sum_j |m_i[j, k]| + |b_k|), with slack for this
    float64 arithmetic, gamma_n = n u / (1 - n u), u = 2^-24.

    E_k bounds how far the float32 chain (three part sums, each a
    sequential sum of n2 exact products from 0 — at n2 = 256 two halves
    of 128 and their sum —, then ((a0 + a1) + a2) + b) can lie from the
    exact value: every term passes at most n2 + 3 roundings of relative
    size u, so the chain is within gamma_{n2+3} of the sum of the terms'
    magnitudes, and a u8 pixel is at most 255. The certificate
    (csrc/transform_core.cuh certify, testing.encode_certified) adds the
    rounding of the adaptive multiply and of round_half_away's add."""
    n2 = np.asarray(m0).shape[0]
    absum = sum(np.abs(np.asarray(m, np.float64)).sum(axis=0)
                for m in (m0, m1, m2))
    gamma = (n2 + 3) * U32 / (1.0 - (n2 + 3) * U32)
    b = np.asarray(b, np.float64).reshape(-1)[:n2]
    err = (gamma * (255.0 * absum + np.abs(b)) * (1.0 + 3 * U32)
           * (1.0 + 2.0 ** -40))
    return np.stack([np.ldexp(1.0, -np.asarray(e)), b, err])


def integer_operands(m0, m1, m2, b, n2: int, device="cpu") -> dict:
    """The tensor-core operands of CodecOperators (int_planes, int_cert,
    parts_t) from the split parts (top-left n2 x n2 block of the packed
    forms) and the bias, or None each for n2 outside MMA_N2. The parts are
    read through a row-major copy: the (256, 256) ones come transposed in
    memory from encode_operator_split."""
    if n2 not in MMA_N2:
        return dict(int_planes=None, int_cert=None, parts_t=None)
    parts = [np.ascontiguousarray(np.asarray(m, np.float32)[:n2, :n2])
             for m in (m0, m1, m2)]
    w, e = integer_operator(*parts)
    cert = certificate_constants(*parts, b, e)
    copies = mma_width(n2) // n2
    planes = np.stack([_block_diag(p, copies) for p in byte_planes(w)])
    return dict(
        int_planes=torch.as_tensor(mma_fragments(planes), device=device),
        int_cert=torch.as_tensor(np.tile(cert, copies), device=device),
        parts_t=torch.as_tensor(np.ascontiguousarray(
            np.stack([p.T for p in parts])), device=device),
    )


def from_numpy(
    m0, m1, m2, bias, m_dec, cat_lengths, cat_codes,
    run_lengths=None, run_codes=None, *, n2: int, device="cpu",
) -> CodecOperators:
    """Bundle numpy operators and tables — for example the reference
    package's packed bf16 parts, packed decode operator and default
    category table — as tensors on ``device``. n2: the block size (cfg.n2)
    the operators are for."""
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
        **integer_operands(m0, m1, m2, bias, n2, device),
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
