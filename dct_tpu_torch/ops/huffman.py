"""Huffman coding: device-side histograms (torch) and the host-side
canonical tables (numpy).

Port of ``dct_tpu.ops.huffman``. The host half is a copy, not an import,
because that module imports jax; it must stay bit-identical to it (the
container stores only code lengths, and both packages must derive the same
codes from them). The tests hold the two against each other.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

MAX_CODE_LEN = 16  # canonical tables cap code length at 16 bits
NUM_CATEGORIES = 16  # categories 0..15; |value| < 2^15 always holds here
# Runs 0..n2: the terminal-zero symbol of an all-zero 8x8 block carries
# run = 64, so the alphabet has 65 entries.
RUN_ALPHABET = 65
# Coded runs cap run codes at 8 bits, keeping every worst-case shape
# identical to the fixed-run layout.
RUN_MAX_CODE_LEN = 8


# ---------------------------------------------------------------------------
# Magnitude categories (JPEG-style value coding)
# ---------------------------------------------------------------------------


def category_of(values: torch.Tensor) -> torch.Tensor:
    """Bits needed for |v|: cat(0) = 0, cat(v) = floor(log2|v|) + 1."""
    a = values.to(torch.int64).abs()
    # frexp: a = m * 2^e with m in [0.5, 1), so e is a's bit length (exact
    # in float64 for every int32 magnitude)
    _, e = torch.frexp(a.to(torch.float64))
    return torch.where(a > 0, e, 0).to(torch.int32)


def category_extra_bits(values: torch.Tensor, cats: torch.Tensor) -> torch.Tensor:
    """JPEG 'additional bits': the low ``cat`` bits of v (v > 0) or of
    ``v + 2^cat - 1`` (v < 0). Returned as int64 (nonnegative)."""
    v = values.to(torch.int64)
    one = torch.ones_like(v)
    span = (one << cats.to(torch.int64)) - 1
    adj = torch.where(v < 0, v + span, v)
    return adj & span


def value_from_category(cat: np.ndarray, extra: np.ndarray) -> np.ndarray:
    """Inverse of category coding (host-side decode)."""
    cat = np.asarray(cat, np.int64)
    extra = np.asarray(extra, np.int64)
    half = np.where(cat > 0, 1 << np.maximum(cat - 1, 0), 0)
    neg = (cat > 0) & (extra < half)
    val = np.where(neg, extra - (1 << cat) + 1, extra)
    return np.where(cat == 0, 0, val).astype(np.int32)


# ---------------------------------------------------------------------------
# Device histograms
# ---------------------------------------------------------------------------


def _masked_bincount(x: torch.Tensor, live: torch.Tensor, n_bins: int):
    # dead symbols count in an extra dump bin, which is dropped
    idx = torch.where(live, x.to(torch.int64), n_bins).reshape(-1)
    return torch.bincount(idx, minlength=n_bins + 1)[:n_bins].to(torch.int32)


def category_histogram_masked(values: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(NUM_CATEGORIES,) int32 histogram of the categories of live
    symbols."""
    return _masked_bincount(category_of(values), live, NUM_CATEGORIES)


def run_histogram_masked(runs: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(RUN_ALPHABET,) int32 histogram of run lengths over live symbols
    (coded-runs table construction)."""
    return _masked_bincount(runs, live, RUN_ALPHABET)


def value_histogram_masked(values: torch.Tensor, live: torch.Tensor,
                           vmin: int, vmax: int) -> torch.Tensor:
    """(vmax - vmin + 2,) int32 histogram of live symbol values over the
    alphabet [vmin, vmax] (direct mode); out-of-range values land in the
    final bin (the ESC symbol)."""
    n_bins = vmax - vmin + 1
    shifted = values.to(torch.int64) - vmin
    idx = torch.where((shifted >= 0) & (shifted < n_bins), shifted, n_bins)
    return _masked_bincount(idx, live, n_bins + 1)


# ---------------------------------------------------------------------------
# Host-side table construction (tiny + serial; deterministic)
# ---------------------------------------------------------------------------


def huffman_code_lengths(freqs: np.ndarray, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Optimal prefix-code lengths from symbol frequencies.

    Deterministic tie-breaking (heap keyed on (freq, creation order)).
    Symbols with zero frequency get length 0 (absent); a single-symbol
    alphabet gets length 1. Lengths over ``max_len`` are re-balanced with
    the JPEG adjust-bits procedure.
    """
    freqs = np.asarray(freqs, np.int64)
    n = len(freqs)
    present = np.nonzero(freqs > 0)[0]
    lengths = np.zeros(n, np.int32)
    if len(present) == 0:
        return lengths
    if len(present) == 1:
        lengths[present[0]] = 1
        return lengths

    # (freq, tiebreak, node) — node is a leaf symbol int or a merged tuple.
    heap = [(int(freqs[s]), i, int(s)) for i, s in enumerate(present)]
    heapq.heapify(heap)
    tiebreak = len(heap)
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, tiebreak, (n1, n2)))
        tiebreak += 1

    def walk(node, depth):
        if isinstance(node, int):
            lengths[node] = max(depth, 1)
            return
        walk(node[0], depth + 1)
        walk(node[1], depth + 1)

    walk(heap[0][2], 0)

    if lengths.max() > max_len:
        lengths = _limit_lengths(lengths, freqs, max_len)
    return lengths


def _limit_lengths(lengths: np.ndarray, freqs: np.ndarray, max_len: int) -> np.ndarray:
    """JPEG Annex K.3-style adjust-bits: fold over-long codes under max_len,
    then reassign lengths to symbols ordered by (frequency desc, symbol
    index asc)."""
    counts = np.bincount(lengths[lengths > 0], minlength=33)
    if len(counts) < 33:
        counts = np.pad(counts, (0, 33 - len(counts)))
    for ln in range(32, max_len, -1):
        while counts[ln] > 0:
            j = ln - 2
            while counts[j] == 0:
                j -= 1
            counts[ln] -= 2
            counts[ln - 1] += 1
            counts[j] -= 1
            counts[j + 1] += 2
    order = np.lexsort((np.arange(len(freqs)), -freqs))
    order = [s for s in order if freqs[s] > 0]
    out = np.zeros_like(lengths)
    it = iter(order)
    for ln in range(1, max_len + 1):
        for _ in range(int(counts[ln])):
            out[next(it)] = ln
    return out


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical Huffman codes (uint32) from lengths, assigned in
    (length, symbol) order."""
    lengths = np.asarray(lengths, np.int32)
    codes = np.zeros(len(lengths), np.uint32)
    code = 0
    prev_len = 0
    for sym in np.lexsort((np.arange(len(lengths)), lengths)):
        ln = int(lengths[sym])
        if ln == 0:
            continue
        code <<= ln - prev_len
        codes[sym] = code
        code += 1
        prev_len = ln
    return codes


class CanonicalTable:
    """A canonical Huffman table: lengths + derived codes + decode index."""

    def __init__(self, lengths: np.ndarray):
        self.lengths = np.asarray(lengths, np.int32)
        # containers store raw u8 lengths: over 32 overflows code
        # construction, an over-subscribed Kraft sum is no prefix code
        if np.any(self.lengths < 0) or np.any(self.lengths > 32):
            raise ValueError("invalid canonical code length (must be 0..32)")
        live = self.lengths[self.lengths > 0]
        if live.size and float(np.sum(np.ldexp(1.0, -live))) > 1.0:
            raise ValueError("over-subscribed canonical Huffman table")
        self.codes = canonical_codes(self.lengths)
        order = [
            s for s in np.lexsort((np.arange(len(lengths)), self.lengths))
            if self.lengths[s] > 0
        ]
        self.sorted_symbols = np.asarray(order, np.int32)
        self.sorted_lengths = self.lengths[self.sorted_symbols]
        self.sorted_codes = self.codes[self.sorted_symbols]

    @classmethod
    def from_frequencies(cls, freqs: np.ndarray, max_len: int = MAX_CODE_LEN):
        return cls(huffman_code_lengths(freqs, max_len))

    def decode_one(self, bit_reader) -> int:
        """Decode a single symbol (host-side reference decoder)."""
        code = 0
        ln = 0
        i = 0
        n = len(self.sorted_symbols)
        while i < n:
            target = int(self.sorted_lengths[i])
            while ln < target:
                code = (code << 1) | bit_reader.read_bit()
                ln += 1
            while i < n and int(self.sorted_lengths[i]) == ln:
                if int(self.sorted_codes[i]) == code:
                    return int(self.sorted_symbols[i])
                i += 1
        raise ValueError("invalid Huffman code in stream")


# ---------------------------------------------------------------------------
# Static default tables (single-pass mode): quality bands <= 25 | 26..75 |
# >= 76, the reference's measured pseudo-frequencies. Every entry is >= 1,
# so any symbol stays encodable.
# ---------------------------------------------------------------------------

_BAND_EDGES = (25, 75)

_DEFAULT_CATEGORY_PSEUDO_FREQS_BANDS = (
    np.array([10177, 15833, 6507, 3670, 2753, 1060,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1], np.int64),
    np.array([5642, 16727, 7749, 4086, 2494, 1647, 1082, 574,
              1, 1, 1, 1, 1, 1, 1, 1], np.int64),
    np.array([1989, 9437, 7395, 11660, 4129, 1845, 1233, 858, 594, 463,
              397, 1, 1, 1, 1, 1], np.int64),
)

_DEFAULT_RUN_PSEUDO_FREQS_BANDS = (
    np.array([22524, 4396, 1256, 738, 376, 207, 134, 88, 49, 19, 23, 7, 3,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2,
              1, 1, 1, 2, 2, 19, 37, 10, 3, 2, 38, 44, 63, 84, 57, 9, 92,
              142, 190, 59, 43, 212, 386, 206, 91, 567, 753, 186, 2783,
              1016, 2970, 101], np.int64),
    np.array([25507, 4765, 1590, 891, 583, 362, 257, 137, 86, 49, 51, 25,
              18, 21, 7, 5, 3, 6, 6, 3, 4, 13, 11, 3, 8, 6, 2, 5, 3, 12,
              14, 27, 34, 25, 3, 9, 22, 26, 92, 144, 46, 38, 9, 130, 161,
              156, 97, 52, 13, 83, 148, 216, 110, 86, 303, 257, 121, 90,
              452, 916, 239, 456, 86, 896, 1], np.int64),
    np.array([26035, 5950, 2425, 1322, 802, 506, 331, 219, 154, 142, 139,
              72, 56, 42, 32, 25, 28, 34, 14, 26, 48, 55, 32, 17, 36, 37,
              13, 8, 22, 30, 64, 60, 84, 39, 21, 27, 72, 38, 116, 196, 85,
              84, 24, 139, 103, 61, 36, 19, 7, 18, 16, 13, 9, 5, 4, 2, 2,
              1, 1, 1, 1, 1, 1, 1, 1], np.int64),
)


def _band(quality: int) -> int:
    if quality <= _BAND_EDGES[0]:
        return 0
    if quality <= _BAND_EDGES[1]:
        return 1
    return 2


def default_category_table(quality: int = 50) -> CanonicalTable:
    return CanonicalTable.from_frequencies(
        _DEFAULT_CATEGORY_PSEUDO_FREQS_BANDS[_band(quality)]
    )


def default_run_table(quality: int = 50) -> CanonicalTable:
    return CanonicalTable.from_frequencies(
        _DEFAULT_RUN_PSEUDO_FREQS_BANDS[_band(quality)],
        max_len=RUN_MAX_CODE_LEN,
    )
