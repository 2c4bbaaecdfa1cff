"""Kernel B's share of its roofline in the traced slice: the least time
the card could take for the bytes and operations the slice's batches
need (perfbench/roofline.py, counting the payload the stripes hold)
over B's device time, by kernel name, in the profiler's trace."""

from perfbench import peaks, roofline


def read(ctx):
    t = ctx["trace"].seconds("encode_stripes_kernel", "kernel")
    if t <= 0:
        return None
    w = ctx["work"]["kernel_b"]
    nbytes, ops = roofline.kernel_b(w["blocks"], w["stripes"],
                                    w["payload_bytes"], w["index"])
    return 100.0 * roofline.seconds(nbytes, ops, peaks.INT8_OPS_PER_S) / t
