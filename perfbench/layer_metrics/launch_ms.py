"""The host's time in kernel B's library call (the program's
kernel.encode_stripes span, which only a launch on the card opens): its
median duration in the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.median_ms("kernel.encode_stripes") if c else None
