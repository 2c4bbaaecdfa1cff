"""The program's own spans and counts (dct_tpu_torch.utils.tracing), for
the per-layer metrics that read them.

The program records spans while a profiler runs, so a traced run leaves
in its store the spans of both profiled slices: first the slice profiled
on the card alone, then, after the pause in which the benchmark exports
and summarises that slice's trace, the slice profiled with host
operators. ``calls`` takes those of the first: the entries (spans with no
span open around them) before the longest pause between one entry's end
and the next one's start, and every span that shares their call ids. A
run on the CPU profiles one slice, and all its calls are taken. The split
guesses a boundary the harness knows: a host stall longer than the
export would move it, with nothing failing, until the harness hands the
readers the slice's own records. Where the
program keeps no store, or the store holds no entry, it gives None, and
so do the readers.
"""

from __future__ import annotations

import statistics


class Calls:
    """The records of the taken calls: ``entries`` (no parent) and
    ``spans`` (every record of those calls, entries included), each a
    pair (index in the store, record)."""

    def __init__(self, entries: list, spans: list):
        self.entries = entries
        self.spans = spans
        self.frames = sum(e.counts.get("frames", 0) for _, e in entries)

    def durations_ms(self, *names: str) -> list[float]:
        return [(r.end_ns - r.start_ns) / 1e6 for _, r in self.spans
                if r.name in names]

    def median_ms(self, name: str) -> float | None:
        d = self.durations_ms(name)
        return statistics.median(d) if d else None

    def ms_per_frame(self, *names: str) -> float | None:
        d = self.durations_ms(*names)
        return sum(d) / self.frames if d and self.frames else None

    def mb_per_frame(self, key: str) -> float | None:
        found = [r.counts[key] for _, r in self.spans if key in r.counts]
        return (sum(found) / self.frames / 1e6
                if found and self.frames else None)

    def unspanned_pct(self) -> float | None:
        """The entries' self time (their duration less what their child
        spans cover) over their duration."""
        total = sum(e.end_ns - e.start_ns for _, e in self.entries)
        ids = {i for i, _ in self.entries}
        covered = sum(r.end_ns - r.start_ns for _, r in self.spans
                      if r.parent in ids)
        return 100.0 * (total - covered) / total if total > 0 else None


def calls(ctx) -> Calls | None:
    try:
        from dct_tpu_torch.utils import tracing
    except ImportError:
        return None
    read = getattr(tracing, "records", None)
    if read is None:
        return None
    recs = [(i, r) for i, r in enumerate(read()) if r is not None]
    entries = [(i, r) for i, r in recs if r.parent is None]
    if not entries:
        return None
    if ctx["device"].type == "cuda" and len(entries) > 1:
        pauses = [b.start_ns - a.end_ns
                  for (_, a), (_, b) in zip(entries, entries[1:])]
        entries = entries[:pauses.index(max(pauses)) + 1]
    ids = {e.call for _, e in entries}
    return Calls(entries, [(i, r) for i, r in recs if r.call in ids])
