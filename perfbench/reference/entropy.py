"""Entropy decode of category-mode stripes, in lockstep over lanes.

Symbol wire format, MSB first: the canonical code of the value's
category c (c = bit length of |v|), c extra bits (v, or v + 2^c - 1 where
v < 0), then the run of zeros before it in a fixed 8-bit field. A block
ends when its position reaches 64: after a value at position 63, or at a
terminal symbol (category 0, the block's trailing zeros as its run, 64
for an all-zero block). No other symbol has category 0 and no value
lands past position 63: a stream that breaks either rule, holds a window
that is no code, or ends anywhere but at its recorded bit length is a
fault of its lane.

A lane is a run of whole blocks from a start bit: one stripe where the
container has no block index, or every block on its own where it has.
All lanes advance one symbol an iteration, so the loop runs as many
iterations as the longest lane has symbols.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import tables

_MASK48 = (1 << 48) - 1
RUN_BITS = 8


def concat(streams: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """(one uint8 buffer with 8 zero bytes after, each stream's start
    bit)."""
    sizes = np.array([len(s) for s in streams], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]) * 8
    return (np.frombuffer(b"".join(streams) + bytes(8), np.uint8),
            starts.astype(np.int64))


def decode(buf: np.ndarray, start: np.ndarray, n_blocks: np.ndarray,
           end: np.ndarray, lengths) -> dict:
    """Decode lanes of ``n_blocks`` blocks each from bit ``start`` of
    ``buf``, each of which has to end exactly at bit ``end``. The lanes'
    blocks are numbered in lane order. -> {"coef": (NB, 64) int64 zigzag
    coefficients, "block_bits": (NB,) bits each block took, "faults":
    lanes at fault, "categories": (16,) histogram of the decoded
    symbols' categories}."""
    sym_tab, len_tab = tables.decode_table(lengths)
    start = np.asarray(start, np.int64)
    n_blocks = np.asarray(n_blocks, np.int64)
    end = np.asarray(end, np.int64)
    nb = int(n_blocks.sum())
    coef = np.zeros((nb, 64), np.int64)
    block_bits = np.zeros(nb, np.int64)
    cats = np.zeros(tables.NUM_CATEGORIES, np.int64)
    fault = np.zeros(len(start), bool)
    last = len(buf) - 6

    lane = np.arange(len(start))
    pos = start.copy()
    blk = np.concatenate([[0], np.cumsum(n_blocks)[:-1]]).astype(np.int64)
    blk_end = blk + n_blocks
    block_start = pos.copy()
    posb = np.zeros(len(start), np.int64)
    live = n_blocks > 0
    lane, pos, blk, blk_end, block_start, posb = (
        a[live] for a in (lane, pos, blk, blk_end, block_start, posb))
    while lane.size:
        over = pos > end[lane]
        b = np.minimum(pos >> 3, last)
        w = np.zeros(lane.size, np.int64)
        for k in range(6):
            w = (w << 8) | buf[b + k]
        win = (w << (pos & 7)) & _MASK48
        top = win >> 32
        ln = len_tab[top]
        cat = sym_tab[top]
        extra = (win >> (48 - ln - cat)) & ((np.int64(1) << cat) - 1)
        run = (win >> (48 - RUN_BITS - ln - cat)) & ((1 << RUN_BITS) - 1)
        half = np.where(cat > 0, np.int64(1) << np.maximum(cat - 1, 0), 0)
        value = np.where(extra < half, extra - (np.int64(1) << cat) + 1,
                         extra)
        q = posb + run
        bad = over | (ln == 0) | np.where(cat == 0, q != 64, q > 63)
        good = ~bad
        np.add.at(cats, cat[good], 1)
        put = good & (cat > 0)
        coef[blk[put], q[put]] = value[put]
        pos = pos + ln + cat + RUN_BITS
        posb = np.where(cat > 0, q + 1, 64)
        done_block = good & (posb == 64)
        block_bits[blk[done_block]] = (pos - block_start)[done_block]
        blk = np.where(done_block, blk + 1, blk)
        block_start = np.where(done_block, pos, block_start)
        posb = np.where(done_block, 0, posb)
        fault[lane[bad]] = True
        finished = good & (blk == blk_end)
        fault[lane[finished & (pos != end[lane])]] = True
        keep = good & ~finished
        lane, pos, blk, blk_end, block_start, posb = (
            a[keep] for a in (lane, pos, blk, blk_end, block_start, posb))
    return {"coef": coef, "block_bits": block_bits, "faults": fault,
            "categories": cats}


def pad_bits_clear(stream: bytes, bits: int) -> bool:
    """Whether the bits after ``bits`` in the stream's last byte are
    zero and the stream is ceil(bits / 8) bytes long."""
    if len(stream) != (bits + 7) // 8:
        return False
    spare = -bits % 8
    return spare == 0 or stream[-1] & ((1 << spare) - 1) == 0


def decode_stripes(stripes: list[bytes], stripe_bits, blocks_per_stripe: int,
                   lengths, block_bits=None) -> dict:
    """Decode a plane's (or several planes') stripes: one lane a stripe,
    or, given the container's ``block_bits`` index, one lane a block
    from the start the index gives it. -> decode's dict, faults counted
    over lanes and pad bits."""
    buf, starts = concat(stripes)
    stripe_bits = np.asarray(stripe_bits, np.int64)
    n = len(stripes)
    pads = sum(not pad_bits_clear(s, int(b))
               for s, b in zip(stripes, stripe_bits))
    if block_bits is None:
        out = decode(buf, starts, np.full(n, blocks_per_stripe),
                     starts + stripe_bits, lengths)
    else:
        bb = np.asarray(block_bits, np.int64).reshape(n, blocks_per_stripe)
        within = np.cumsum(bb, axis=1) - bb
        begin = (starts[:, None] + within).reshape(-1)
        out = decode(buf, begin, np.ones(begin.size, np.int64),
                     begin + bb.reshape(-1), lengths)
    out["n_faults"] = int(out["faults"].sum()) + pads
    return out
