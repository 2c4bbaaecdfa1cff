"""Bytes and operations kernels A and E need for the work their inputs
ask for, whatever implements them, counted as perfbench/roofline.py
counts B, C and D; the least time is roofline.seconds.

A, the encode transform of the staged path: u8 pixels in and int16
zigzag coefficients out, 192 bytes a block, and the 608 operations of a
separable 8x8 transform with its quantization, against the int8 peak as
for B; bytes bind it (192 bytes take 57 ns at the memory peak, 608
operations 0.3 ns). E, the chunk packer: the code words it is handed,
each a value and a bit length of 4 bytes, in; the stripes' payload and
their bit lengths out; no arithmetic to speak of.
"""

from __future__ import annotations

from perfbench.roofline import BLOCK, COEF_BYTES, STRIPE_LENGTH_BYTES
from perfbench.roofline import TRANSFORM_OPS

WORD_BYTES = 4 + 4      # a code word's value and its bit length, int32 each


def kernel_a(blocks: int) -> tuple[int, int]:
    """(bytes, operations) of the encode transform of ``blocks``."""
    return blocks * BLOCK * (1 + COEF_BYTES), blocks * TRANSFORM_OPS


def kernel_e(chunks: int, stripes: int,
             payload_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of packing ``chunks`` code words into
    ``stripes`` stripes that hold ``payload_bytes``."""
    return (chunks * WORD_BYTES + payload_bytes
            + stripes * STRIPE_LENGTH_BYTES), 0
