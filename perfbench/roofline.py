"""Bytes and operations kernels B, C and D need for the work their inputs
ask for, whatever implements them, and the least time the card could
take for it.

Each input byte is counted read once and each output byte written once.
Work that depends on the data is counted as these inputs need it: kernel
B's output is the payload its stripes hold (each stripe's bit length
rounded up to whole bytes), not the worst-case buffer an implementation
may zero. Operations are counted at the fewest a separable 8x8 transform
needs: the Arai-Agui-Nakajima 8-point DCT takes 5 multiplications and 29
additions with its output scaling folded into the quantization, so a
block takes 16 such passes and 64 quantization (or dequantization)
multiplies, 608 operations. At these counts bytes bound all three
kernels: B needs at least 64 bytes a block (its pixels), 608 operations
take 0.3 ns a block at the int8 peak and 64 bytes 19 ns at the memory
peak; C moves 192 bytes a block against 608 float32 operations (9.1 ns
at 67 TFLOP/s against 57 ns); D's decode is no arithmetic to speak of
and is counted by its bytes.
"""

from __future__ import annotations

from perfbench import peaks

BLOCK = 64
TRANSFORM_OPS = 16 * (5 + 29) + 64
INDEX_ENTRY_BYTES = 2   # a block's bit length fits 16 bits
STRIPE_LENGTH_BYTES = 4
STRIPE_START_BYTES = 8
COEF_BYTES = 2          # int16 coefficients
STATUS_BYTES = 4        # kernel D's per-stripe flag


def kernel_b(blocks: int, stripes: int, payload_bytes: int,
             index: bool) -> tuple[int, int]:
    """(bytes, operations) of the fused encode: u8 pixels in; the stripes'
    payload, their lengths and, where the config writes one, the block
    index out."""
    nbytes = (blocks * BLOCK + payload_bytes + stripes * STRIPE_LENGTH_BYTES
              + (blocks * INDEX_ENTRY_BYTES if index else 0))
    return nbytes, blocks * TRANSFORM_OPS


def kernel_d(blocks: int, stripes: int, payload_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of the indexed entropy decode: the payload, the
    block index and the stripe starts in; int16 zigzag coefficients and a
    status word a stripe out."""
    nbytes = (payload_bytes + blocks * INDEX_ENTRY_BYTES
              + stripes * (STRIPE_START_BYTES + STATUS_BYTES)
              + blocks * BLOCK * COEF_BYTES)
    return nbytes, 0


def kernel_c(blocks: int) -> tuple[int, int]:
    """(bytes, operations) of dequantization and inverse transform: int16
    coefficients in, u8 pixels out."""
    return blocks * BLOCK * (COEF_BYTES + 1), blocks * TRANSFORM_OPS


def seconds(nbytes: int, ops: int, ops_per_s: float) -> float:
    """The larger of the bytes over the memory peak and the operations
    over ``ops_per_s``."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / ops_per_s)
