"""Bytes the program handed from host memory to the card (its h2d_bytes
counts), in MB a frame, in the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.mb_per_frame("h2d_bytes") if c else None
