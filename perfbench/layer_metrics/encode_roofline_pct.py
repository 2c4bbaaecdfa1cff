"""The whole adaptive on-card encode's share of its roofline in the
traced slice: the least time the card could take for the bytes and
operations the slice's batches need (perfbench/roofline_adaptive.py)
over the device time of every kernel in the profiled slice, whatever
implements it. None where the slice's work holds no adaptive blocks."""

from perfbench import peaks, roofline, roofline_adaptive


def read(ctx):
    t = ctx["trace"].seconds("", "kernel")
    if t <= 0 or "adaptive" not in ctx["work"]:
        return None
    w = ctx["work"]["kernel_b"]
    nbytes, ops = roofline_adaptive.encode(
        ctx["work"]["adaptive"]["blocks"], w["stripes"], w["payload_bytes"],
        w["index"])
    return 100.0 * roofline.seconds(nbytes, ops, peaks.INT8_OPS_PER_S) / t
