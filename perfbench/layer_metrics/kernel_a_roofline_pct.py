"""Kernel A's share of its roofline in the traced slice: the least time
for the bytes and operations of the slice's blocks
(perfbench/roofline_staged.py) over A's device time, by kernel name."""

from perfbench import peaks, roofline, roofline_staged


def read(ctx):
    t = ctx["trace"].seconds("encode_blocks_kernel", "kernel")
    if t <= 0:
        return None
    nbytes, ops = roofline_staged.kernel_a(ctx["work"]["kernel_a"]["blocks"])
    return 100.0 * roofline.seconds(nbytes, ops, peaks.INT8_OPS_PER_S) / t
