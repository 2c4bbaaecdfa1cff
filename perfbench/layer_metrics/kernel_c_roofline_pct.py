"""Kernel C's share of its roofline in the traced slice: the least time
for the bytes and float32 operations of the slice's blocks
(perfbench/roofline.py) over C's device time, by kernel name."""

from perfbench import peaks, roofline


def read(ctx):
    t = ctx["trace"].seconds("decode_blocks_kernel", "kernel")
    if t <= 0:
        return None
    nbytes, ops = roofline.kernel_c(ctx["work"]["kernel_c"]["blocks"])
    return 100.0 * roofline.seconds(nbytes, ops, peaks.FP32_FLOPS_PER_S) / t
