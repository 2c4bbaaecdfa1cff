"""The traced slices of a run, reduced to what the per-layer metrics and
the breakdown read.

Two slices are profiled. The first records CUDA activity alone, which
costs the host little a launch: its device times are those of an
untraced run, and its idle share is the card's in that slice, read a
little high where calls are short and the host paces them (the host
records each launch). A marker kernel (torch's spin_kernel, MARK) is
queued as the slice starts and again after its last call, and the
window runs from the first marker to the second. The second slice
records host operators too, which slows a host that enqueues small
calls; it serves only the idle gaps of the breakdown, and is marked by a
record_function span, WINDOW.

Device activity is every kernel, copy and memset event of the trace; the
card is busy where one of them runs, and idle in the rest of the window.
Each idle gap is named by the innermost host operation that spans its
midpoint (a torch operator, a CUDA runtime call, or a span of the
benchmark), so the gaps say what the host was doing while the card
waited; Python between operators shows as "host: between operations".
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from collections import defaultdict

import numpy as np
import torch

WINDOW = "perfbench.window"
MARK = "spin_kernel"
MARK_CYCLES = 1000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10
MAX_GAPS = 4096


@contextlib.contextmanager
def profiled(device: torch.device, host: bool):
    """Profile the body, with host operators or (``host`` False, on the
    card) CUDA activity alone; yields a list that holds the Summary
    after it."""
    if host:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
    else:
        acts = [torch.profiler.ProfilerActivity.CUDA]
    result = []
    with torch.profiler.profile(activities=acts) as prof:
        if host:
            with torch.profiler.record_function(WINDOW):
                yield result
        else:
            torch.cuda._sleep(MARK_CYCLES)
            yield result
            torch.cuda._sleep(MARK_CYCLES)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    result.append(summarize(prof, host))


def _events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device: list[dict]   # device events inside the window
    host: list[dict]     # host events inside the window
    gaps: list[tuple[float, float]]   # idle intervals, microseconds

    def seconds(self, substring: str = "", cat: str | None = None) -> float:
        """Device seconds of events whose name holds ``substring``, of one
        category ("kernel", "gpu_memcpy") or all."""
        return sum(e["dur"] for e in self.device
                   if substring in e["name"]
                   and (cat is None or e["cat"] == cat)) / 1e6

    def idle_pct(self) -> float | None:
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_ops(self) -> list:
        by = defaultdict(float)
        for e in self.device:
            by[e["name"]] += e["dur"] / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda x: -x[1])[:TOP]

    def idle_gaps(self) -> list:
        """Idle seconds by the host operation under each gap's midpoint,
        over the MAX_GAPS longest gaps."""
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:MAX_GAPS]
        host = [e for e in self.host if e["name"] != WINDOW]
        by = defaultdict(float)
        if not gaps:
            return []
        starts = np.array([e["ts"] for e in host], np.float64)
        ends = starts + np.array([e["dur"] for e in host], np.float64)
        durs = np.where(ends > starts, ends - starts, 0.0)
        for i in range(0, len(gaps), 64):
            chunk = np.array(gaps[i:i + 64], np.float64)
            mid = chunk.mean(axis=1)[:, None]
            cover = (starts[None, :] <= mid) & (ends[None, :] >= mid)
            inner = np.where(cover, durs[None, :], np.inf).argmin(axis=1)
            found = cover[np.arange(len(chunk)), inner]
            for (a, b), k, ok in zip(chunk, inner, found):
                name = host[k]["name"] if ok else "host: between operations"
                by[name] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda x: -x[1])[:TOP]


def summarize(prof, host: bool) -> Summary:
    events = _events(prof)
    if host:
        marks = [e for e in events if e["name"] == WINDOW
                 and e.get("cat") == "user_annotation"]
    else:
        marks = [e for e in events if MARK in e["name"]
                 and e.get("cat") == "kernel"]
        events = [e for e in events if e not in marks]
    if not marks:
        raise RuntimeError("the trace holds no mark of its window")
    t0 = min(e["ts"] for e in marks)
    t1 = max(e["ts"] + e["dur"] for e in marks)
    device, host = [], []
    for e in events:
        a, b = e["ts"], e["ts"] + e["dur"]
        if b < t0 or a > t1:
            continue
        if e.get("cat") in DEVICE_CATS:
            device.append(e)
        elif e.get("cat") in HOST_CATS:
            host.append(e)
    busy = _union([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in device])
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < t1:
        gaps.append((prev, t1))
    return Summary(window_s=(t1 - t0) / 1e6,
                   busy_s=sum(b - a for a, b in busy) / 1e6,
                   device=device, host=host, gaps=gaps)
