"""Kernel D's share of its roofline in the traced slice: the least time
for the bytes the slice's containers need it to move
(perfbench/roofline.py) over D's device time, by kernel name."""

from perfbench import peaks, roofline


def read(ctx):
    t = ctx["trace"].seconds("entropy_decode_kernel", "kernel")
    if t <= 0:
        return None
    w = ctx["work"]["kernel_d"]
    nbytes, ops = roofline.kernel_d(w["blocks"], w["stripes"],
                                    w["payload_bytes"])
    return 100.0 * roofline.seconds(nbytes, ops, peaks.INT8_OPS_PER_S) / t
