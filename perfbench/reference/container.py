"""The TPDC container layout, read and written in plain Python.

Little-endian. Header: b"TPDC", version u8 (1; 2 when the decode index is
present), flags u8 (bit0 adaptive, bit1 use_huffman, bits2-3 huffman
mode 0 category / 1 direct / 2 none, bit4 compat_b1, bit5 static_tables,
bit6 coded_runs, bit7 dc_prediction), block_size u8, quality u8, width
u32, height u32, n_planes u8, chroma u8 (0 gray, 1 4:4:4, 2 4:2:0),
stripe_rows u16; version 2 adds flags2 u8 (bit0 index, bit1 packed).
Per plane: width u32, height u32, n_stripes u32, 16 u8 category code
lengths, n_stripes u32 stripe bit lengths, with the index one u8 entry
width w and the per-block bit lengths as MSB-first w-bit entries (w the
smallest width the largest needs, zero pad bits), then the stripes, each
ceil(bits / 8) bytes.

Only the category mode with the fixed run field, without adaptive
quantization, DC prediction or coded runs, is read: the configurations
the benchmark runs. ``decode_index`` "auto" keeps the index where its
packed bytes are at most 6 % of the payload bytes.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

MAGIC = b"TPDC"
AUTO_INDEX_BOUND = 0.06
CHROMA = ("gray", "444", "420")


@dataclasses.dataclass
class Plane:
    width: int
    height: int
    lengths: np.ndarray          # (16,) category code lengths
    stripe_bits: np.ndarray      # (n_stripes,) int64
    stripes: list[bytes]
    block_bits: np.ndarray | None = None  # (n_stripes * bps,) int64


@dataclasses.dataclass
class Parsed:
    version: int
    flags: int
    block_size: int
    quality: int
    width: int
    height: int
    chroma: str
    stripe_rows: int
    planes: list[Plane]


def flags_of(static_tables: bool) -> int:
    """use_huffman, category mode, and static_tables where set."""
    return 0b10 | (0b100000 if static_tables else 0)


def index_width(bb: np.ndarray) -> int:
    return max(1, int(np.max(bb, initial=0)).bit_length())


def pack_index(bb: np.ndarray) -> bytes:
    bb = np.asarray(bb, np.int64)
    w = index_width(bb)
    bits = ((bb[:, None] >> np.arange(w - 1, -1, -1)) & 1).astype(np.uint8)
    return bytes([w]) + np.packbits(bits.reshape(-1)).tobytes()


def index_included(decode_index, planes: list[Plane]) -> bool:
    if decode_index != "auto":
        return bool(decode_index)
    payload = sum(int(((p.stripe_bits + 7) // 8).sum()) for p in planes)
    cost = sum(1 + (p.block_bits.size * index_width(p.block_bits) + 7) // 8
               for p in planes)
    return payload > 0 and cost <= AUTO_INDEX_BOUND * payload


def serialize(c: Parsed) -> bytes:
    with_index = c.version == 2
    out = bytearray(MAGIC)
    out += struct.pack("<BBBBIIBBH", c.version, c.flags, c.block_size,
                       c.quality, c.width, c.height, len(c.planes),
                       CHROMA.index(c.chroma), c.stripe_rows)
    if with_index:
        out += b"\x03"
    for p in c.planes:
        out += struct.pack("<III", p.width, p.height, len(p.stripes))
        out += bytes(np.asarray(p.lengths, np.uint8))
        out += np.asarray(p.stripe_bits, "<u4").tobytes()
        if with_index:
            out += pack_index(p.block_bits)
        for s in p.stripes:
            out += s
    return bytes(out)


def grid(height: int, width: int, n: int = 8) -> tuple[int, int]:
    """(block rows, block columns) of a plane padded to whole blocks
    (stripes of one block row)."""
    return -(-height // n), -(-width // n)


def parse(data: bytes) -> Parsed:
    """Raises ValueError on anything this reader does not take."""
    if data[:4] != MAGIC:
        raise ValueError("not a TPDC container")
    (version, flags, n, quality, width, height, n_planes, chroma,
     stripe_rows) = struct.unpack_from("<BBBBIIBBH", data, 4)
    off = 20
    if version == 2:
        if data[20] != 3:
            raise ValueError(f"flags2 0x{data[20]:02x}")
        off = 21
    elif version != 1:
        raise ValueError(f"version {version}")
    if flags & ~0b100000 != 0b10 or n != 8 or stripe_rows != 1:
        raise ValueError("a mode this reader does not take")
    if chroma >= len(CHROMA) or n_planes != (1 if chroma == 0 else 3):
        raise ValueError("chroma and plane count disagree")
    planes = []
    for _ in range(n_planes):
        pw, ph, n_stripes = struct.unpack_from("<III", data, off)
        off += 12
        bh, bw = grid(ph, pw)
        if n_stripes != bh:
            raise ValueError("stripe count disagrees with the plane")
        lengths = np.frombuffer(data, np.uint8, 16, off).astype(np.int64)
        off += 16
        bits = np.frombuffer(data, "<u4", n_stripes, off).astype(np.int64)
        off += 4 * n_stripes
        block_bits = None
        if version == 2:
            w = data[off]
            off += 1
            nb = n_stripes * bw
            nbytes = (nb * w + 7) // 8
            raw = np.unpackbits(np.frombuffer(data, np.uint8, nbytes, off))
            off += nbytes
            block_bits = (raw[:nb * w].reshape(nb, w).astype(np.int64)
                          << np.arange(w - 1, -1, -1)).sum(axis=1)
        stripes = []
        for b in bits:
            nbytes = int((b + 7) // 8)
            if off + nbytes > len(data):
                raise ValueError("payload past the end")
            stripes.append(bytes(data[off:off + nbytes]))
            off += nbytes
        planes.append(Plane(pw, ph, lengths, bits, stripes, block_bits))
    return Parsed(version, flags, n, quality, width, height, CHROMA[chroma],
                  stripe_rows, planes)
