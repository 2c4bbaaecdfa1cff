"""Bitstream packing: RLE symbols -> serialized stripe bits (port of
``dct_tpu.ops.bitstream``).

Plain PyTorch version of the staged packer, in two passes:

  pass 1: per-symbol chunk values and bit lengths (table gathers) and an
          exclusive prefix sum of bit offsets per stripe;
  pass 2: every chunk (<= 16 bits) lands in at most two 16-bit stream
          units; all chunks are scatter-added into a zeroed unit buffer
          (bit ranges are disjoint, so add == or).

Symbol wire format (MSB-first), per RLE symbol:
  category mode: huff(category) | extra bits (category count) | run
  direct mode:   huff(value)    | [ESC: raw 16b value]        | run
  none mode:     raw 16b value  |                             | run
The run field is run_field_bits(n2) wide, or a canonical run code under
cfg.coded_runs. Stripes are byte-aligned independent substreams.

Integer widths: torch's uint16/uint32 have too few ops. Chunk values
(at most 16 bits) and lengths (at most 16) are int32, the one chunk dtype
kernel E takes; this packer widens them to int64 for the bit offsets and
the 32-bit windows. Stream units are held in any integer tensor whose low
16 bits are the unit (int32 from this packer, int16 bit patterns from the
kernels) until fetch_packed narrows them to numpy uint16.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.ops.rle import RLEPositional
from dct_tpu_torch.utils import tracing

def run_field_bits(n2: int) -> int:
    """Fixed run-field width: 8 bits (entropy.c:390), widened to
    bit_length(n2) where the all-zero block's run n2 needs it (16x16)."""
    return max(8, int(n2).bit_length())


def units_per_block_worst(n2: int = 64, coded_runs: bool = False) -> int:
    """Worst-case 16-bit stream units one n2-coefficient block can emit:
    n2 symbols x (16-bit code + 16-bit payload + the run field, or a
    16-bit canonical run code under coded_runs)."""
    bits = 16 + 16 + (16 if coded_runs else run_field_bits(n2))
    return (n2 * bits + 15) // 16


class PackedStripes(NamedTuple):
    """units: (n_stripes, U) stream units, big-endian 16-bit values (see
    the module docstring for their container dtype); bit_lengths:
    (n_stripes,) int32 payload bits per stripe."""

    units: torch.Tensor | np.ndarray
    bit_lengths: torch.Tensor | np.ndarray


def trim_units_count(bits: np.ndarray, capacity: int) -> int:
    """Unit count to keep when fetching a worst-case units buffer whose
    payload sizes are ``bits``: the used maximum, rounded up to 1024."""
    max_units = int((int(bits.max()) + 15) // 16) if bits.size else 1
    return min(int(capacity), -(-max(max_units, 1) // 1024) * 1024)


def fetch_packed(packed: PackedStripes) -> PackedStripes:
    """Device PackedStripes -> host numpy (uint16 units, int32 bits),
    copying only the units the payload uses."""
    with tracing.named_scope("bitstream.fetch_packed"):
        lengths = packed.bit_lengths.cpu()
        bits = lengths.numpy().astype(np.int32)
        u_trim = trim_units_count(bits, packed.units.shape[-1])
        # astype keeps the low 16 bits: int16 bit patterns and int32
        # values in [0, 65535] both narrow to the same uint16 unit
        units = packed.units[..., :u_trim].cpu()
        tracing.add("d2h_bytes", lengths.numel() * lengths.element_size()
                    + units.numel() * units.element_size())
        return PackedStripes(units=units.numpy().astype(np.uint16),
                             bit_lengths=bits)


def symbol_chunks(
    symbols: RLEPositional,
    mode: str,
    cat_lengths: torch.Tensor | None = None,
    cat_codes: torch.Tensor | None = None,
    val_lengths: torch.Tensor | None = None,
    val_codes: torch.Tensor | None = None,
    vmin: int = 0,
    run_lengths: torch.Tensor | None = None,
    run_codes: torch.Tensor | None = None,
    run_bits: int = 8,
):
    """Per-symbol (chunk_values (B, S, 3) int32, chunk_lens (B, S, 3)
    int32): code, payload and run field. Dead slots get zero lengths.

    run_lengths/run_codes: canonical run table (cfg.coded_runs); None =
    the fixed run_bits-wide run field."""
    i32 = torch.int32
    values = symbols.values.to(i32)
    runs = symbols.runs.to(i32)
    live = symbols.is_sym
    zero = torch.zeros_like(values)

    if run_lengths is not None:
        run_v = run_codes.to(i32)[runs]
        run_l = torch.where(live, run_lengths.to(i32)[runs], 0)
    else:
        run_v = runs
        run_l = torch.where(live, run_bits, zero)

    if mode == "category":
        cats = hf.category_of(values)
        a_v = cat_codes.to(i32)[cats]
        a_l = cat_lengths.to(i32)[cats]
        b_v = hf.category_extra_bits(values, cats).to(i32)
        b_l = cats
    elif mode == "direct":
        n_alpha = val_lengths.shape[0] - 1  # last entry is ESC
        shifted = values - vmin
        in_range = (shifted >= 0) & (shifted < n_alpha)
        idx = torch.where(in_range, shifted, n_alpha)
        a_v = val_codes.to(i32)[idx]
        a_l = val_lengths.to(i32)[idx]
        b_v = values & 0xFFFF
        b_l = torch.where(in_range, 0, 16 + zero)
    elif mode == "none":
        a_v = values & 0xFFFF
        a_l = 16 + zero
        b_v = zero
        b_l = zero
    else:
        raise ValueError(f"unknown huffman mode {mode!r}")

    a_l = torch.where(live, a_l, 0)
    b_l = torch.where(live, b_l, 0)
    cv = torch.stack([a_v, b_v, run_v], dim=-1)
    cl = torch.stack([a_l, b_l, run_l], dim=-1)
    return cv, cl


def pack_chunks(
    chunk_values: torch.Tensor, chunk_lens: torch.Tensor, units_capacity: int
) -> PackedStripes:
    """Pack (n_stripes, C, 3) chunks into 16-bit stream units per stripe.

    Chunk bit offsets are the exclusive cumsum of lengths along the
    stripe's flattened chunk axis. Each chunk's 32-bit window aligned at
    its first unit is split hi/lo and scatter-added (int64); dead chunks
    and anything past the capacity go to a dump slot."""
    n_stripes = chunk_values.shape[0]
    cv = chunk_values.reshape(n_stripes, -1).to(torch.int64)
    cl = chunk_lens.reshape(n_stripes, -1).to(torch.int64)

    csum = torch.cumsum(cl, dim=1)
    offs = csum - cl  # exclusive
    bit_lengths = csum[:, -1].to(torch.int32)

    unit_idx = offs >> 4
    sh = offs & 15
    live = cl > 0
    # guard the undefined <<32 case (dead chunks)
    shift = torch.clamp(32 - cl - sh, 0, 31)
    window = torch.where(live, (cv << shift) & 0xFFFFFFFF, 0)
    hi = window >> 16
    lo = window & 0xFFFF

    dump = units_capacity
    i0 = torch.clamp(torch.where(live, unit_idx, dump), max=dump)
    i1 = torch.clamp(torch.where(live & (lo > 0), unit_idx + 1, dump), max=dump)

    buf = torch.zeros(n_stripes, units_capacity + 1, dtype=torch.int64,
                      device=cv.device)
    buf.scatter_add_(1, i0, hi)
    buf.scatter_add_(1, i1, lo)
    return PackedStripes(
        units=buf[:, :units_capacity].to(torch.int32), bit_lengths=bit_lengths
    )


def stripes_to_bytes(packed: PackedStripes) -> list[bytes]:
    """Host epilogue: unit buffers -> per-stripe byte strings (big-endian
    16-bit units, truncated to the actual byte length)."""
    with tracing.named_scope("bitstream.stripes_to_bytes"):
        units = np.asarray(packed.units).astype(np.uint16)
        bits = np.asarray(packed.bit_lengths)
        out = []
        for s in range(units.shape[0]):
            n_bytes = int((bits[s] + 7) // 8)
            out.append(units[s].astype(">u2").tobytes()[:n_bytes])
        return out


class BitReader:
    """MSB-first bit reader over bytes (host-side decode)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_bit(self) -> int:
        byte = self.data[self.pos >> 3]
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


def unpack_stripe_host(
    data: bytes,
    n_blocks: int,
    n2: int,
    mode: str,
    cat_table: hf.CanonicalTable | None = None,
    val_table: hf.CanonicalTable | None = None,
    vmin: int = 0,
    expected_bits: int | None = None,
    run_table: hf.CanonicalTable | None = None,
) -> np.ndarray:
    """Decode one stripe substream -> (n_blocks, n2) int16 zigzag
    coefficients; a block ends when its position reaches n2.

    expected_bits: when given, raise ValueError unless the decode consumed
    exactly that many bits (the container records each stripe's length).
    """
    r = BitReader(data)
    out = np.zeros((n_blocks, n2), np.int16)
    for b in range(n_blocks):
        pos = 0
        while pos < n2:
            if mode == "category":
                c = cat_table.decode_one(r)
                if c > 15:
                    raise ValueError(f"category {c} exceeds the wire range")
                if c:
                    extra = r.read_bits(c)
                    v = int(hf.value_from_category(np.int32(c), np.int64(extra)))
                else:
                    v = 0
            elif mode == "direct":
                sym = val_table.decode_one(r)
                n_alpha = len(val_table.lengths) - 1
                if sym == n_alpha:  # ESC
                    raw = r.read_bits(16)
                    v = raw - 0x10000 if raw >= 0x8000 else raw
                else:
                    v = sym + vmin
                    if not -0x8000 <= v <= 0x7FFF:
                        raise ValueError(
                            f"direct value {v} exceeds the wire range"
                        )
            else:
                raw = r.read_bits(16)
                v = raw - 0x10000 if raw >= 0x8000 else raw
            if run_table is not None:
                run = run_table.decode_one(r)
            else:
                run = r.read_bits(run_field_bits(n2))
            pos += run
            if pos < n2:
                out[b, pos] = v
                pos += 1
    if expected_bits is not None and r.pos != expected_bits:
        raise ValueError(
            f"stripe consumed {r.pos} bits, container records {expected_bits}"
        )
    return out
