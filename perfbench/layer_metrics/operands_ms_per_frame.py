"""Host time building and uploading kernel D's operands (the program's
codec.indexed_operands spans, their codec.upload included) a frame, in
the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.ms_per_frame("codec.indexed_operands") if c else None
