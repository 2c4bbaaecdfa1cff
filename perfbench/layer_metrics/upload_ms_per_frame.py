"""Host time of the encode's upload (the program's video.upload_pad
spans: the contiguous copy, the copy to the card and the pad) a frame, in
the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.ms_per_frame("video.upload_pad") if c else None
