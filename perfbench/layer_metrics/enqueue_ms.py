"""The host's time to enqueue one encode_step call: the median of the
benchmark's own spans around each call in the traced run's untraced
slice, on the host clock, with no synchronise inside."""

import statistics


def read(ctx):
    spans = ctx["spans"].get("encode_step")
    return 1e3 * statistics.median(spans) if spans else None
