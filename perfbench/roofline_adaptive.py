"""Bytes and operations the whole adaptive on-card encode needs for the
work its inputs ask for, whatever implements it, counted as
perfbench/roofline.py counts kernel B; the least time is
roofline.seconds.

u8 pixels in, 64 bytes a block; each block's u8 variance code out, 1
byte; the stripes' payload, their lengths and, where the config writes
one, the block index out, as roofline.kernel_b counts them. The float32
scales a staged implementation writes between its passes are not
counted: they are an intermediate, so a kernel B that computes each
block's variance itself reads against the same yardstick. Operations:
B's transform, and a block's variance code and scaled quantization, 64
squares and 126 additions for the two sums, 8 scalar steps to the code
and its scale, a reciprocal and 63 AC multiplies (262); bytes bind it as
they bind B.
"""

from __future__ import annotations

from perfbench import roofline

CODE_BYTES = 1
VARIANCE_OPS = 64 + 2 * 63 + 8 + 1 + 63


def encode(blocks: int, stripes: int, payload_bytes: int,
           index: bool) -> tuple[int, int]:
    """(bytes, operations) of the adaptive encode of ``blocks`` into
    ``stripes`` stripes that hold ``payload_bytes``."""
    nbytes, ops = roofline.kernel_b(blocks, stripes, payload_bytes, index)
    return nbytes + blocks * CODE_BYTES, ops + blocks * VARIANCE_OPS
