"""Host time reading results back from the card, the wait for it
included: the program's codec.status_readback (decode),
bitstream.fetch_packed and codec.index_readback (encode) spans, a frame,
in the slice profiled on the card alone."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.ms_per_frame("codec.status_readback", "bitstream.fetch_packed",
                          "codec.index_readback") if c else None
