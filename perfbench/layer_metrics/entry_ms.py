"""The program's own span around each encode_step call, the inside twin
of enqueue_ms: its median duration in the slice profiled on the card
alone (perfbench/program_spans.py), host clock, no synchronise inside."""

from perfbench import program_spans


def read(ctx):
    c = program_spans.calls(ctx)
    return c.median_ms("codec.encode_step") if c else None
