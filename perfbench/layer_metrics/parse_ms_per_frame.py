"""Host time parsing containers (the program's container.deserialize
spans) a frame, in the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.ms_per_frame("container.deserialize") if c else None
