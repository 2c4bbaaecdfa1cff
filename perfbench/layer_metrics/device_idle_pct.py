"""The card's idle share in the slice profiled on the card alone: the
share of the slice, from its first marker to its second, in which no
kernel, copy or memset ran (perfbench/trace.py)."""


def read(ctx):
    return ctx["trace"].idle_pct()
