"""Kernel E's share of its roofline in the traced slice: the least time
for the code words the slice's stacks handed it and the payload it
wrote (perfbench/roofline_staged.py) over E's device time, by kernel
name."""

from perfbench import peaks, roofline, roofline_staged


def read(ctx):
    t = ctx["trace"].seconds("pack_chunks_kernel", "kernel")
    if t <= 0:
        return None
    w = ctx["work"]["kernel_e"]
    nbytes, ops = roofline_staged.kernel_e(w["chunks"], w["stripes"],
                                           w["payload_bytes"])
    return 100.0 * roofline.seconds(nbytes, ops, peaks.INT8_OPS_PER_S) / t
