"""Run-length encoding of zigzag coefficient streams (port of
``dct_tpu.ops.rle``: RLEPositional, rle_encode_positional).

Reference semantics (entropy.c:216-256): at each nonzero value emit
``(value, run)``, run = zeros since the previous emitted symbol; if the
LAST position is zero, emit one terminal symbol ``(0, trailing zeros + 1)``,
so an all-zero block yields exactly ``(0, n2)``. The decoder's position
invariant (pos lands exactly at n2) delimits blocks with no count field.

Positional form: one slot per zigzag position, no compaction — zero-length
slots advance neither histograms nor bit offsets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RLEPositional(NamedTuple):
    """values: (B, n2) int32 symbol value at emitting positions, else 0.
    runs: (B, n2) int32 zero-run before the value, else 0.
    is_sym: (B, n2) bool, True where a symbol is emitted."""

    values: torch.Tensor
    runs: torch.Tensor
    is_sym: torch.Tensor

    @property
    def counts(self) -> torch.Tensor:
        return self.is_sym.sum(dim=1, dtype=torch.int32)


def rle_encode_positional(zz: torch.Tensor) -> RLEPositional:
    """Zigzag coefficients (B, n2) -> positional RLE symbols: one running
    max (previous nonzero position), no sort, no gather."""
    B, n2 = zz.shape
    idx = torch.arange(n2, dtype=torch.int32, device=zz.device).expand(B, n2)
    mask = zz != 0
    marked = torch.where(mask, idx, -1)
    pnz_incl = torch.cummax(marked, dim=1).values
    pnz = torch.cat([torch.full_like(pnz_incl[:, :1], -1), pnz_incl[:, :-1]],
                    dim=1)
    is_last = idx == (n2 - 1)
    is_sym = mask | is_last
    terminal_zero = is_last & ~mask
    run = idx - pnz - 1 + terminal_zero.to(torch.int32)
    return RLEPositional(
        values=torch.where(is_sym, zz, 0).to(torch.int32),
        runs=torch.where(is_sym, run, 0).to(torch.int32),
        is_sym=is_sym,
    )
