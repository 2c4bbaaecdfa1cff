"""Host time turning fetched stripes into container bytes (the program's
bitstream.stripes_to_bytes and container.serialize spans) a frame, in
the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return (c.ms_per_frame("bitstream.stripes_to_bytes", "container.serialize")
            if c else None)
