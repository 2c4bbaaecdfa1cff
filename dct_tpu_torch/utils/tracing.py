"""Spans and counts of the port's host stages, and a profiler exporter.

``named_scope(name, **counts)`` marks a stage of the codec's paths in a
``with`` statement. Tracing is off by default, and then a span is one
shared no-op context manager, returned after two flag reads: no
RecordFunction, no NVTX range, no clock. It is on while a
``torch.profiler`` profile runs, or after ``enable()`` (until
``disable()``). On, each span

- takes the host clock (``time.perf_counter_ns``) at entry and exit;
- opens torch's C++ RecordFunction guard of ``name`` when a profiler
  runs, so the span is a host event ("cpu_op") on the profiler's own
  clock, in the same trace as the kernels (``trace`` below writes one),
  and an NVTX range under ``enable()`` on a machine with a card;
- appends one ``Record`` to a store of at most ``CAPACITY`` records: its
  name, start and end, its parent (the index of the span open around it,
  None for an entry), its call id and its counts. A span opened with no
  span open around it is an entry and takes a new call id; every span it
  encloses shares that id. The store grows as spans record and
  ``reset_timings()`` frees it; a full store keeps its first records,
  warns once and counts the spans it drops (``dropped()``).

``add(key, n)`` adds ``n`` to a count of the innermost open span (bytes
copied each way, frames); with no span open it does nothing.
``records()`` returns the store, ``timings_summary()`` its calls, total,
mean and self time by span name (a span's duration less the part of it
its child spans cover), and ``reset_timings()`` empties it. Spans nest
on one stack: the codec's spans are opened from one thread.

The host clock sees the work a stage enqueues, not when the card
finishes it: a stage that reads a result back (``.cpu()``) includes the
wait for the card.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16

_record = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter_ns

_enabled = False
_nvtx = False


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None   # index of the enclosing span's record; None: entry
    call: int
    counts: dict


class _Store:
    __slots__ = ("capacity", "records", "dropped", "calls", "stack")

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.records: list[tuple | None] = []
        self.dropped = self.calls = 0
        self.stack: list[_Span] = []

    def clear(self) -> None:
        self.records = []
        self.dropped = self.calls = 0
        self.stack.clear()


_store = _Store(CAPACITY)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "counts", "index", "parent", "call", "start",
                 "records", "rf", "nvtx")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def __enter__(self):
        s = _store
        stack = s.stack
        if stack:
            top = stack[-1]
            self.parent = top.index
            self.call = top.call
        else:
            s.calls += 1
            self.parent = None
            self.call = s.calls
        recs = self.records = s.records
        self.index = len(recs)
        if self.index < s.capacity:
            recs.append(None)
        else:
            self.index = None
            if not s.dropped:
                warnings.warn(f"tracing: the store is full ({s.capacity} "
                              "records); later spans are dropped",
                              RuntimeWarning, stacklevel=2)
            s.dropped += 1
        stack.append(self)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _record(self.name)
            self.rf.__enter__()
        self.nvtx = _nvtx and _enabled
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = _store.stack
        if stack and stack[-1] is self:
            stack.pop()
        # after a reset while the span was open, self.records is the old list
        if self.index is not None:
            self.records[self.index] = (self.name, self.start, end,
                                        self.parent, self.call, self.counts)
        return False


def named_scope(name: str, **counts):
    """A span of ``name`` with its starting ``counts`` (keyword: number),
    for a ``with`` statement; the shared no-op while tracing is off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name, counts)


def add(key: str, n: int) -> None:
    """Add ``n`` to count ``key`` of the innermost open span, if any."""
    stack = _store.stack
    if stack:
        counts = stack[-1].counts
        counts[key] = counts.get(key, 0) + n


def enable() -> None:
    """Record spans whether or not a profiler runs (NVTX ranges too on a
    machine with a card)."""
    global _enabled, _nvtx
    _enabled, _nvtx = True, torch.cuda.is_available()


def disable() -> None:
    """Record spans only while a profiler runs (the default)."""
    global _enabled
    _enabled = False


def records() -> list[Record | None]:
    """The store, in the order the spans opened (a span still open holds
    None); ``Record.parent`` indexes this list."""
    return [None if r is None else Record._make(r) for r in _store.records]


def dropped() -> int:
    """Spans not recorded since the store filled."""
    return _store.dropped


def timings_summary() -> dict[str, dict[str, float]]:
    """By span name: calls, total_s, mean_ms and self_s (the durations
    less the part of each its child spans cover), from records()."""
    recs = records()
    cover = [0] * len(recs)
    for r in recs:
        if r is not None and r.parent is not None:
            cover[r.parent] += r.end_ns - r.start_ns
    out: dict[str, dict[str, float]] = {}
    for r, c in zip(recs, cover):
        if r is None:
            continue
        d = out.setdefault(r.name, {"calls": 0, "total_s": 0.0, "self_s": 0.0})
        dur = r.end_ns - r.start_ns
        d["calls"] += 1
        d["total_s"] += dur / 1e9
        d["self_s"] += (dur - c) / 1e9
    for d in out.values():
        d["mean_ms"] = 1e3 * d["total_s"] / d["calls"]
    return out


def reset_timings() -> None:
    """Empty and free the store; spans open now are not recorded."""
    _store.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body (CPU activity, and CUDA activity where there is a
    card) and write a Chrome trace, ``<host>_<pid>.<ns>.pt.trace.json``
    (torch.profiler.tensorboard_trace_handler), into ``logdir`` when it
    ends; the body's spans are in it. Yields the torch.profiler.profile."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ) as prof:
        yield prof
