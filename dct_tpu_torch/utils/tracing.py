"""Profiling / tracing harness (the port's copy of
``dct_tpu.utils.tracing``).

``trace`` wraps torch.profiler for kernel-level traces (a Chrome trace,
viewable in Perfetto or TensorBoard), and ``named_scope`` marks a
pipeline stage in that trace (torch.profiler.record_function, and an NVTX
range where there is a card) while a small registry accumulates each
stage's wall time on the host clock. The host clock sees the work a stage
enqueues, not when the card finishes it: a timed stage that must include
its device work ends in ``torch.cuda.synchronize()`` (see
utils/metrics.measure_throughput for the bench-grade timer).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_timings: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def named_scope(name: str):
    """torch.profiler.record_function (+ an NVTX range on a machine with a
    card) and wall-clock accumulation (host-side)."""
    t0 = time.perf_counter()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    _timings[name].append(time.perf_counter() - t0)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body (CPU activity, and CUDA activity where there is a
    card) and write a Chrome trace, ``<host>_<pid>.<ns>.pt.trace.json``
    (torch.profiler.tensorboard_trace_handler), into ``logdir`` when it
    ends. Yields the torch.profiler.profile."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ) as prof:
        yield prof


def timings_summary() -> dict[str, dict[str, float]]:
    out = {}
    for name, ts in _timings.items():
        out[name] = {
            "calls": len(ts),
            "total_s": sum(ts),
            "mean_ms": 1e3 * sum(ts) / len(ts),
        }
    return out


def reset_timings() -> None:
    _timings.clear()
