"""Host time from the analyze pass's histogram to the tables on the card
(the program's codec.histogram_readback spans, the wait for the card
included, and codec.build_tables) a frame, in the slice profiled on the
card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return (c.ms_per_frame("codec.histogram_readback", "codec.build_tables")
            if c else None)
