"""Bytes the program read back from the card (its d2h_bytes counts), in
MB a frame, in the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.mb_per_frame("d2h_bytes") if c else None
