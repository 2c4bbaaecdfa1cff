"""The category Huffman table of a stack of frames, in plain PyTorch on
the CPU in int64: the table a stack encoded with the codec's default
(dynamic) tables has to carry in every one of its containers.

From the zigzag coefficients of every frame, (NB, 64) a frame, the
symbols the codec's category mode codes, a block at a time in zigzag
order:

- at each nonzero coefficient, the pair (run, value): run is the number
  of zeros since the previous symbol of the block;
- where the block's last position (63) is zero, one terminal symbol
  (run, 0): its run is the block's trailing zeros, 64 for an all-zero
  block.

A symbol's category is the bit length of |value| (0 for the terminal
symbol). The histogram of the symbols' categories is summed over every
block of every frame, and its code lengths are those of
``tables.code_lengths``: a Huffman code over the present categories,
lengths over 16 folded by the adjust-bits procedure of ITU-T T.81
Annex K.3, absent categories 0, a lone category 1.

Where this departs from T.81 Annex K.2, which libjpeg runs under
``optimize_coding``:

- The alphabet is 16 categories, not JPEG's 162 AC symbols: the run is
  not part of the Huffman symbol but a fixed 8-bit field after the
  value's extra bits, so no run nibble and no ZRL (a run up to 63 is one
  field); the terminal symbol is category 0 with its run, where JPEG's
  EOB is the symbol 0x00 with none.
- DC is coded as the block's first position, against the same table; no
  DC difference and no DC table (the configuration sets
  ``dc_prediction`` false).
- One table for the whole stack, not one an image and component.
- No code point is reserved: K.2 adds a symbol of frequency 1 so that no
  code is all ones; the codec does not.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import tables

BLOCK = 64
RUN_BITS = 8


def symbols(coef: torch.Tensor):
    """(NB, 64) zigzag coefficients -> (values, runs, live), each (NB, 64):
    a symbol at every live position, its value and its run."""
    coef = torch.as_tensor(coef).to(torch.int64)
    pos = torch.arange(BLOCK, dtype=torch.int64).expand_as(coef)
    nonzero = coef != 0
    last = pos == BLOCK - 1
    live = nonzero | last
    # the position of the latest nonzero strictly before each position
    # (-1 where none): a symbol's run is the zeros between the two
    seen = torch.where(nonzero, pos, torch.full_like(pos, -1))
    before = torch.cummax(seen, dim=1).values
    before = torch.cat([torch.full_like(before[:, :1], -1),
                        before[:, :-1]], dim=1)
    run = pos - before - 1
    run = torch.where(nonzero, run, run + 1)     # the terminal's trailing run
    zero = torch.zeros_like(coef)
    return (torch.where(live, coef, zero), torch.where(live, run, zero),
            live)


def categories(values: torch.Tensor) -> torch.Tensor:
    """The bit length of each |value|, 0 for 0."""
    mag = values.abs()
    cat = torch.zeros_like(mag)
    for bit in range(tables.NUM_CATEGORIES):
        cat += (mag >= (1 << bit)).to(torch.int64)
    return cat


def histogram(frames) -> torch.Tensor:
    """(16,) int64 category histogram of every frame's symbols, summed;
    ``frames`` an iterable of (NB, 64) coefficient arrays."""
    total = torch.zeros(tables.NUM_CATEGORIES, dtype=torch.int64)
    for coef in frames:
        values, _, live = symbols(coef)
        cats = categories(values[live])
        total += torch.bincount(cats, minlength=tables.NUM_CATEGORIES)
    return total


def lengths(frames) -> np.ndarray:
    """(16,) code lengths of the stack's table."""
    return tables.code_lengths(histogram(frames).numpy())
