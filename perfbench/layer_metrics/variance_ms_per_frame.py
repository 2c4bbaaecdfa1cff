"""Host time of the adaptive variance pass (the program's
codec.variance_codes spans: the blocks, their variances, codes and
scales enqueued) a frame, in the slice profiled on the card alone. None
for a program without that span."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.ms_per_frame("codec.variance_codes") if c else None
