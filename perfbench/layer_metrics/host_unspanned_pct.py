"""The share of the entries' host time that no stage span names: the
entries' self time (their duration less what their child spans cover)
over their duration, in the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.unspanned_pct() if c else None
