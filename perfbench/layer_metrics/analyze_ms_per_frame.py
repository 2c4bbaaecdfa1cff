"""Host time of the analyze pass (the program's codec.encode_analyze
spans: kernel A's call, the RLE and the histogram enqueued) a frame, in
the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.ms_per_frame("codec.encode_analyze") if c else None
