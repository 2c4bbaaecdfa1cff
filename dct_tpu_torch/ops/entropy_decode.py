"""Kernel D, the device entropy decode of indexed (version 2) containers:
host preparation and the plain PyTorch version.

Port of ``dct_tpu.ops.entropy_decode_pallas``. With the per-block decode
index every block is an independent substream, so the unit of parallelism
is the block: block b's bits start at its stripe's first bit (the stripe's
byte offset x 8, built on the host from the stripe byte lengths:
:func:`stripe_starts`) plus the exclusive sum of the bit lengths before it
in its stripe (:func:`block_starts`; kernel D does that scan itself). Each
block then decodes on its own, symbol by symbol, with the semantics of the
reference kernel's lanes:

  value:  a canonical code of at most 16 bits, then the mode's payload —
          category: ``cat`` extra bits (JPEG sign rule); direct: the
          alphabet value, or after ESC a raw 16-bit two's-complement value;
          none: a raw 16-bit value;
  run:    a fixed ``run_bits`` field, or a second canonical code
          (cfg.coded_runs);
  expand: ``pos += run; write v at pos if pos < n2; ++pos``, until ``pos
          >= n2`` or the cursor reaches the block's end.

Bits are read MSB-first from the payload bytes (big-endian 16-bit units
on the wire). What the reference kernel spends on the TPU's layout — the
unit-to-column reshape, the log-roll window distribution, the window and
span buckets, SPAN_MAX, two symbols per fetch, the (8, 128) geometry
operand — has no counterpart here. Tables with a code longer than 16 bits,
or direct values outside int16, are for the host decoder
(:func:`tables_supported`).

Blocks that contradict their index. D decodes each block for at most its
indexed bit length and rejects nothing, where the host decoder walks the
stripe from its first bit and rejects a code that matches nothing (error
2) or a stripe it overruns (error 3). So D also reports, per stripe,
whether any block disagrees with the index (``status``): a block
agrees when its decode ended because ``pos >= n2`` (not because its bits
ran out), it consumed exactly its indexed length (a 0-bit block never
does: a valid block holds a symbol), and no value or run code went
unmatched. Where every block of a stripe agrees, the host decoder returns
the same coefficients and no error: csrc/entropy_decode.cu gives the
argument. The codec settles a flagged stripe with the host decoder. The
status is an (n_stripes,) int32 tensor of zeros that the caller hands in
(``status=``; codec.indexed_operands uploads it with the other operands)
and into which 1 is ORed for each such stripe.

The table operands travel as one int32 vector (:func:`table_inputs`), laid
out as TABLE_FIELDS; kernel D (csrc/entropy_decode.cu) copies the fixed
fields into shared memory and builds its lookahead tables from them.
"""

from __future__ import annotations

import numpy as np
import torch

from dct_tpu_torch.ops import huffman as hf

ESC_SENTINEL = 1 << 20  # marks the ESC slot of the direct value table
MAX_CODE_BITS = 16

# (name, length) of the packed table vector, in order; "vtab" (the direct
# mode's canonical index -> value table) has the alphabet's length and
# comes last. csrc/entropy_decode.cu hard-codes the same offsets.
TABLE_FIELDS = (("vfirst", 17), ("vlimit", 17), ("vbase", 17),
                ("rfirst", 17), ("rlimit", 17), ("rbase", 17),
                ("csym", 16), ("rsym", hf.RUN_ALPHABET))
TABLE_FIXED = sum(n for _, n in TABLE_FIELDS)  # 183: vtab starts here
MODE_IDS = {"category": 0, "direct": 1, "none": 2}


def canon_arrays(table: hf.CanonicalTable):
    """first/limit/base per code length 1..16 (index 0 unused) and the
    canonical-order symbols, or None if a code exceeds 16 bits. A code c
    of length L is symbol ``order[base[L] + c - first[L]]`` when
    ``first[L] <= c < limit[L]``."""
    if table.sorted_lengths.size and int(table.sorted_lengths.max()) > MAX_CODE_BITS:
        return None
    first = np.zeros(17, np.int32)
    limit = np.zeros(17, np.int32)
    base = np.zeros(17, np.int32)
    for L in range(1, 17):
        idx = np.nonzero(table.sorted_lengths == L)[0]
        if idx.size:
            first[L] = int(table.sorted_codes[idx[0]])
            limit[L] = int(table.sorted_codes[idx[-1]]) + 1
            base[L] = int(idx[0])
    return first, limit, base, table.sorted_symbols.astype(np.int32)


def tables_supported(table: hf.CanonicalTable | None,
                     run_table: hf.CanonicalTable | None,
                     vmin: int = 0) -> bool:
    """Whether kernel D can represent these wire tables: every code <= 16
    bits and direct values inside int16 (the host decoders reject wider
    values too)."""
    for t in (table, run_table):
        if t is not None and t.sorted_lengths.size and (
            int(t.sorted_lengths.max()) > MAX_CODE_BITS
        ):
            return False
    if table is not None and not (
        -0x8000 <= vmin and vmin + len(table.lengths) <= 0x8001
    ):
        return False
    return True


def table_inputs(table: hf.CanonicalTable | None,
                 run_table: hf.CanonicalTable | None,
                 mode: str, vmin: int) -> np.ndarray:
    """The packed int32 table vector (TABLE_FIELDS + vtab) for a stream
    whose tables pass :func:`tables_supported`. csym holds the category
    symbols in canonical order; vtab maps a direct-mode canonical index to
    its value, with ESC_SENTINEL at the ESC symbol; rsym the run symbols in
    canonical order. Unused fields are zero."""
    f = {name: np.zeros(n, np.int32) for name, n in TABLE_FIELDS}
    vtab = np.zeros(0, np.int32)
    if mode in ("category", "direct"):
        f["vfirst"], f["vlimit"], f["vbase"], order = canon_arrays(table)
        if mode == "category":
            f["csym"][: order.size] = order
        else:
            n_alpha = len(table.lengths) - 1  # the last symbol is ESC
            vtab = np.where(order == n_alpha, ESC_SENTINEL,
                            order + vmin).astype(np.int32)
    if run_table is not None:
        f["rfirst"], f["rlimit"], f["rbase"], rorder = canon_arrays(run_table)
        f["rsym"][: rorder.size] = rorder
    return np.concatenate([f[name] for name, _ in TABLE_FIELDS] + [vtab])


def stripe_starts(stripe_bytes) -> np.ndarray:
    """Byte lengths of the concatenated stripes -> (n_stripes,) int64 first
    bit of each: the exclusive sum of the lengths, times 8. Stripes are
    byte-aligned; a container's stripe lengths are ceil(stripe_bits / 8),
    and container.deserialize checks that the index sums to stripe_bits."""
    n = np.asarray(stripe_bytes, np.int64)
    return (np.cumsum(n) - n) * 8


def block_starts(block_bits: torch.Tensor,
                 stripe_start: torch.Tensor) -> torch.Tensor:
    """(n_stripes, bps) per-block bit lengths (u16 entries, int16 bit
    patterns accepted) and (n_stripes,) int64 stripe start bits -> (NB,)
    int64 first bit of every block in the concatenated payload: its
    stripe's first bit plus the exclusive sum of the lengths before it in
    its stripe (the scan kernel D runs)."""
    bb = block_bits.to(torch.int64) & 0xFFFF
    within = torch.cumsum(bb, dim=1) - bb
    return (stripe_start.to(torch.int64)[:, None] + within).reshape(-1)


def _bits(window: torch.Tensor, off: torch.Tensor, n) -> torch.Tensor:
    """n bits at bit ``off`` of a 56-bit MSB-first window (off + n <= 49,
    the window's bits that are always valid)."""
    if isinstance(n, int):
        return (window >> (56 - off - n)) & ((1 << n) - 1)
    return (window >> (56 - off - n)) & ((torch.ones_like(n) << n) - 1)


def _canon_decode(t16: torch.Tensor, first, limit, base):
    """<= 16-bit canonical decode of (M,) 16-bit windows: (canonical index,
    code length), both 0 where no code matches."""
    lens = torch.arange(1, 17, device=t16.device)
    cand = t16[:, None] >> (16 - lens)  # (M, 16): the first L bits
    hit = (cand >= first[1:]) & (cand < limit[1:])
    found = hit.any(dim=1)
    k = hit.to(torch.int8).argmax(dim=1)  # the shortest matching length
    c = cand.gather(1, k[:, None])[:, 0]
    idx = torch.where(found, base[1:][k] + c - first[1:][k], 0)
    ln = torch.where(found, k + 1, 0)
    return idx, ln


def _lookup(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx], 0 where idx lies outside the table."""
    if tab.numel() == 0:
        return torch.zeros_like(idx)
    inside = (idx >= 0) & (idx < tab.numel())
    return torch.where(inside, tab[idx.clamp(0, tab.numel() - 1)], 0)


def decode_blocks_plain(
    payload: torch.Tensor,
    stripe_start: torch.Tensor,
    block_bits: torch.Tensor,
    n2: int,
    mode: str,
    tabs: torch.Tensor,
    run_bits: int,
    status: torch.Tensor | None = None,
):
    """Plain version of kernel D: (P,) uint8 payload (the stripes
    concatenated; bytes past its end read as zero), (n_stripes,) int64
    stripe start bits, (n_stripes, bps) u16 block bit lengths (int16 bit
    patterns), the packed int32 table vector, the fixed run field's width
    (0: coded runs) -> (n_stripes * bps, n2) int16 zigzag coefficients;
    with ``status`` ((n_stripes,) int32 zeros), (coefficients, status)
    with 1 ORed into the entry of each stripe in which a block disagrees
    with its index. Block starts are :func:`block_starts`.

    Vectorised over blocks: every step decodes one symbol of each block
    that is still active, and the loop runs while any block is. A step
    advances a block's position by at least one, so there are at most n2
    steps."""
    dev = payload.device
    data = torch.cat([payload.to(torch.int64),
                      torch.zeros(8, dtype=torch.int64, device=dev)])
    last = data.numel() - 1
    t = {}
    o = 0
    for name, n in TABLE_FIELDS:
        t[name] = tabs[o:o + n].to(torch.int64)
        o += n
    vtab = tabs[o:].to(torch.int64)
    cur = block_starts(block_bits, stripe_start)
    nb = cur.numel()
    out = torch.zeros(nb, n2, dtype=torch.int16, device=dev)
    end = cur + (block_bits.reshape(-1).to(torch.int64) & 0xFFFF)
    live = torch.nonzero(end > cur).flatten()
    cur, end = cur[live], end[live]
    pos = torch.zeros_like(cur)
    # a block disagrees with the index until its decode ends as it should
    bad = torch.ones(nb, dtype=torch.bool, device=dev)
    unmatched = torch.zeros_like(cur, dtype=torch.bool)
    byte_k = torch.arange(7, device=dev)
    while live.numel():
        # 56-bit window MSB-first at the cursor: 7 bytes from cur >> 3,
        # shifted by cur & 7 (49 bits always valid; a symbol needs <= 48)
        raw = data[((cur >> 3)[:, None] + byte_k).clamp(max=last)]
        win = (raw << (48 - 8 * byte_k)).sum(dim=1)
        win = (win << (cur & 7)) & ((1 << 56) - 1)
        zero = torch.zeros_like(cur)
        t16 = _bits(win, zero, 16)
        if mode == "category":
            idx, ln = _canon_decode(t16, t["vfirst"], t["vlimit"], t["vbase"])
            unmatched |= ln == 0
            cat = torch.where(ln > 0, _lookup(t["csym"], idx), 0)
            e = torch.where(cat > 0, _bits(win, ln, cat), 0)
            half = torch.ones_like(cat) << (cat - 1).clamp(min=0)
            v = torch.where(cat == 0, 0,
                            torch.where(e < half, e - (1 << cat) + 1, e))
            gv = ln + cat
        elif mode == "direct":
            idx, ln = _canon_decode(t16, t["vfirst"], t["vlimit"], t["vbase"])
            unmatched |= ln == 0
            v = _lookup(vtab, idx)
            esc = v == ESC_SENTINEL
            r16 = _bits(win, ln, 16)
            v = torch.where(esc, r16 - ((r16 >> 15) << 16), v)
            gv = ln + torch.where(esc, 16, 0)
        else:  # none: a raw 16-bit two's-complement value
            v = t16 - ((t16 >> 15) << 16)
            gv = torch.full_like(cur, 16)
        if run_bits == 0:  # coded runs
            ridx, lc = _canon_decode(_bits(win, gv, 16), t["rfirst"],
                                     t["rlimit"], t["rbase"])
            run = _lookup(t["rsym"], ridx)
            unmatched |= lc == 0
        else:
            run = _bits(win, gv, run_bits)
            lc = torch.full_like(cur, run_bits)
        wpos = pos + run
        w = wpos < n2
        out[live[w], wpos[w]] = v[w].to(torch.int16)
        pos = torch.where(w, wpos + 1, wpos)
        cur = cur + gv + lc
        keep = (pos < n2) & (cur < end)
        done = ~keep
        bad[live[done]] = ~((pos[done] >= n2) & (cur[done] == end[done])
                            & ~unmatched[done])
        live, cur, pos, end = live[keep], cur[keep], pos[keep], end[keep]
        unmatched = unmatched[keep]
    if status is None:
        return out
    status |= bad.reshape(block_bits.shape).any(dim=1).to(torch.int32)
    return out, status
