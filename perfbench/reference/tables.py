"""Float64 transform constants and canonical Huffman tables, from the
codec's definition.

- The orthonormal DCT-II basis, the quality-scaled quant matrix (the JPEG
  tables of ITU-T T.81 Annex K.1 and K.2 times IJG's quality scale,
  clamped to [1, 255], not rounded) and the zigzag order.
- Canonical Huffman code lengths from frequencies (a heap keyed on
  (frequency, creation order), lengths over 16 folded by the JPEG Annex
  K.3 adjust-bits procedure), the canonical codes, and the static
  category tables: pseudo-frequencies for the quality bands <= 25,
  26..75 and >= 76.
"""

from __future__ import annotations

import heapq

import numpy as np

JPEG_LUMA_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float64)
JPEG_CHROMA_QUANT = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
] + [[99] * 8] * 4, np.float64)

MAX_CODE_LEN = 16
NUM_CATEGORIES = 16

_CATEGORY_PSEUDO_FREQS = (
    [10177, 15833, 6507, 3670, 2753, 1060, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [5642, 16727, 7749, 4086, 2494, 1647, 1082, 574, 1, 1, 1, 1, 1, 1, 1, 1],
    [1989, 9437, 7395, 11660, 4129, 1845, 1233, 858, 594, 463, 397, 1, 1, 1,
     1, 1],
)


def dct_basis(n: int) -> np.ndarray:
    """D[i, j] = alpha(i) cos(pi (2j + 1) i / 2n), alpha(0) = sqrt(1/n),
    else sqrt(2/n)."""
    i = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    alpha = np.where(i == 0, 1.0 / np.sqrt(n), np.sqrt(2.0 / n))
    return alpha * np.cos(np.pi * (2.0 * j + 1.0) * i / (2.0 * n))


def quant_matrix(quality: int, chroma: bool) -> np.ndarray:
    """8x8 quant steps: the Annex K table times 50/q (q < 50) or
    (200 - 2q)/100, clamped to [1, 255]."""
    q = min(100, max(1, int(quality)))
    scale = (5000.0 / q if q < 50 else 200.0 - 2.0 * q) / 100.0
    base = JPEG_CHROMA_QUANT if chroma else JPEG_LUMA_QUANT
    return np.clip(base * scale, 1.0, 255.0)


def zigzag(n: int) -> np.ndarray:
    """Row-major indices in zigzag order: even anti-diagonals walk up and
    to the right, odd ones down and to the left."""
    order = []
    for s in range(2 * n - 1):
        cells = [(i, s - i) for i in range(n) if 0 <= s - i < n]
        if s % 2 == 0:
            cells.reverse()
        order += [i * n + j for i, j in cells]
    return np.asarray(order, np.int64)


def coefficient_operator(quality: int, chroma: bool) -> np.ndarray:
    """(64, 64) float64 K with zigzag coefficients = (x - 128) @ K for
    row-major 8x8 blocks x, before rounding."""
    d = dct_basis(8)
    perm = zigzag(8)
    kz = np.kron(d, d)[perm, :]
    return (kz / quant_matrix(quality, chroma).ravel()[perm][:, None]).T


def pixel_operator(quality: int, chroma: bool) -> np.ndarray:
    """(64, 64) float64 with pixels = z @ P + 128 for zigzag coefficients
    z, before rounding and clipping."""
    d = dct_basis(8)
    perm = zigzag(8)
    qz = quant_matrix(quality, chroma).ravel()[perm]
    return qz[:, None] * np.kron(d, d)[perm, :]


def code_lengths(freqs, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Huffman code lengths; absent symbols get 0, a lone symbol 1."""
    freqs = np.asarray(freqs, np.int64)
    lengths = np.zeros(len(freqs), np.int64)
    present = [int(s) for s in np.flatnonzero(freqs > 0)]
    if not present:
        return lengths
    if len(present) == 1:
        lengths[present[0]] = 1
        return lengths
    heap = [(int(freqs[s]), k, s) for k, s in enumerate(present)]
    heapq.heapify(heap)
    order = len(heap)
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, order, (a, b)))
        order += 1
    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if isinstance(node, int):
            lengths[node] = max(depth, 1)
        else:
            stack += [(node[0], depth + 1), (node[1], depth + 1)]
    if lengths.max() > max_len:
        lengths = _adjust_bits(lengths, freqs, max_len)
    return lengths


def _adjust_bits(lengths, freqs, max_len):
    counts = np.zeros(33, np.int64)
    np.add.at(counts, lengths[lengths > 0], 1)
    for ln in range(32, max_len, -1):
        while counts[ln] > 0:
            j = ln - 2
            while counts[j] == 0:
                j -= 1
            counts[ln] -= 2
            counts[ln - 1] += 1
            counts[j] -= 1
            counts[j + 1] += 2
    ranked = [s for s in np.lexsort((np.arange(len(freqs)), -freqs))
              if freqs[s] > 0]
    out = np.zeros_like(lengths)
    k = 0
    for ln in range(1, max_len + 1):
        for _ in range(int(counts[ln])):
            out[ranked[k]] = ln
            k += 1
    return out


def canonical_codes(lengths) -> np.ndarray:
    """Codes assigned in (length, symbol) order."""
    lengths = np.asarray(lengths, np.int64)
    codes = np.zeros(len(lengths), np.int64)
    code = prev = 0
    for s in np.lexsort((np.arange(len(lengths)), lengths)):
        if lengths[s] == 0:
            continue
        code <<= int(lengths[s]) - prev
        codes[s] = code
        code += 1
        prev = int(lengths[s])
    return codes


def static_category_lengths(quality: int) -> np.ndarray:
    band = 0 if quality <= 25 else 1 if quality <= 75 else 2
    return code_lengths(_CATEGORY_PSEUDO_FREQS[band])


def decode_table(lengths) -> tuple[np.ndarray, np.ndarray]:
    """(symbol, length) for every 16-bit window: the symbol whose code
    prefixes it, or length 0 where no code does."""
    lengths = np.asarray(lengths, np.int64)
    if lengths.max(initial=0) > MAX_CODE_LEN:
        raise ValueError("code longer than 16 bits")
    if np.sum(np.ldexp(1.0, -lengths[lengths > 0])) > 1.0:
        raise ValueError("over-subscribed code")
    sym = np.zeros(1 << MAX_CODE_LEN, np.int64)
    ln = np.zeros(1 << MAX_CODE_LEN, np.int64)
    for s, (c, n) in enumerate(zip(canonical_codes(lengths), lengths)):
        if n:
            lo = int(c) << (MAX_CODE_LEN - int(n))
            hi = (int(c) + 1) << (MAX_CODE_LEN - int(n))
            sym[lo:hi] = s
            ln[lo:hi] = n
    return sym, ln
