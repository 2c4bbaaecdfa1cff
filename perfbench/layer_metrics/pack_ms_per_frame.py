"""Host time of the staged pack (the program's codec.pack_frames spans:
the symbol chunks and kernel E's call enqueued) a frame, in the slice
profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.ms_per_frame("codec.pack_frames") if c else None
