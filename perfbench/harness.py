"""One run of one cell: set-up, warm-up, the measured window (or, with
trace, an untraced slice and two profiled ones), the check of what the
timed calls produced, and the result line.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric is found by name: workloads/<cell>.json names its
configuration (configs/<config>.json), its traffic kind
(traffic/<kind>.py) and the kind's parameters; BENCHMARK.json, at the
root of the checkout, lists the cell's end-to-end metrics and its
per-layer metrics, each read by layer_metrics/<metric>.py or, where
there is none, by the reader of its base name, the part before the
first dot (device_idle_pct.feed by layer_metrics/device_idle_pct.py).

A traffic module has four functions:
  setup(cell, seed, device) -> state: the inputs, made from the seed,
      and the program's objects; nothing timed;
  warm(state): every shape the window uses, once or more;
  window(state, seconds, sampler) -> {"metrics", "attempted", "failed",
      "elapsed", "work", "spans"}: the timed loop; it keeps the outputs of
      the calls the sampler picks, for judge;
  judge(state) -> {check: (number, limit)}: the kept outputs against the
      plain reference, after the program's inputs are freed.
A metric reader has read(ctx) -> number or None (nothing to read); ctx
holds the trace's Summary of the slice profiled on the card alone, that
slice's work (what its kernels had to move), and the untraced slice's
spans.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import time

import numpy as np
import torch

from perfbench import trace as tracing

HERE = pathlib.Path(__file__).resolve().parent
SPAN_SECONDS = 1.0     # the traced run's untraced slice, for spans
TRACE_SECONDS = 1.0    # and each of its profiled slices
FORBIDDEN = ("jax", "jaxlib", "flax", "dct_tpu")


def read_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def load_file(path: pathlib.Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: pathlib.Path = HERE) -> dict:
    """The cell's file with its configuration's file under "config" and
    the entry of BENCHMARK.json under "entry"."""
    cell = read_json(root / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config"] = read_json(root / "configs" / f"{cell['config']}.json")
    bench = read_json(root.parent / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    cell["entry"] = entries[0]

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    cell["end_to_end"] = [m for m in bench["end_to_end"] if mine(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if mine(m)]
    return cell


def traffic(kind: str, root: pathlib.Path = HERE):
    return load_file(root / "traffic" / f"{kind}.py",
                     f"perfbench_traffic_{kind}")


def reader(metric: str, root: pathlib.Path = HERE):
    path = root / "layer_metrics" / f"{metric}.py"
    if not path.is_file():
        metric = metric.split(".")[0]
        path = root / "layer_metrics" / f"{metric}.py"
    return load_file(path, f"perfbench_metric_{metric}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def picks(seed: int, salt: int, n: int, k: int) -> list[int]:
    """``k`` of ``n`` outputs drawn from the seed, one from each of ``k``
    equal runs of them, so that every half of a batch is judged."""
    rng = np.random.default_rng([int(seed), salt])
    edges = np.linspace(0, n, k + 1).astype(int)
    return [int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:])]


class Sampler:
    """Which timed call keeps its output for the check: the first at or
    after an instant of the window drawn from the seed (the traffic keeps
    the window's last call's too)."""

    def __init__(self, seed: int, seconds: float, salt: int = 0):
        rng = np.random.default_rng([int(seed), salt])
        self.at = float(rng.uniform(0.0, seconds))

    def take(self, elapsed: float) -> bool:
        if self.at is not None and elapsed >= self.at:
            self.at = None
            return True
        return False


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float, root: pathlib.Path = HERE) -> dict:
    """One run; -> the result object (its "checks" last). ``t0``: the
    host clock at process start."""
    cell = load_cell(name, root)
    mod = traffic(cell["traffic_kind"], root)
    state = mod.setup(cell, seed, device)
    mod.warm(state)
    sync(device)
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    summary = None
    if not trace:
        res = mod.window(state, seconds, Sampler(seed, seconds))
        attempted, failed = res["attempted"], res["failed"]
        spans, work = res["spans"], res["work"]
    else:
        # an untraced slice for the spans, a slice traced on the card alone
        # for the device's numbers, and one with host operators for the
        # breakdown's idle gaps (trace.py)
        slices = []
        span_s = min(seconds, SPAN_SECONDS)
        slices.append(mod.window(state, span_s, Sampler(seed, span_s, salt=1)))
        trace_s = min(seconds, TRACE_SECONDS)
        summaries = []
        for host in ([False] if device.type == "cuda" else []) + [True]:
            sampler = Sampler(seed, trace_s, salt=2 + host)
            with tracing.profiled(device, host) as out:
                slices.append(mod.window(state, trace_s, sampler))
            summaries.append(out[0])
        summary, gaps = summaries[0], summaries[-1].idle_gaps()
        attempted = sum(r["attempted"] for r in slices)
        failed = sum(r["failed"] for r in slices)
        spans, work = slices[0]["spans"], slices[1]["work"]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"loaded in the timed process: {', '.join(loaded)}")

    if summary is not None and slices[1]["attempted"]:
        # the card's busy seconds a call, at the untraced slice's call rate
        rate = slices[0]["attempted"] / slices[0]["elapsed"]
        busy = summary.busy_s / slices[1]["attempted"]
        print(f"idle share at the untraced rate of calls: "
              f"{100.0 * (1.0 - busy * rate)} %", file=sys.stderr)
    errors = state.get("errors", [])
    if errors:
        print(f"{len(errors)} timed calls raised; the first: {errors[0]}",
              file=sys.stderr)
    checks = mod.judge(state)
    del state
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())

    metrics = {}
    if not trace:
        for m in cell["end_to_end"]:
            name = m["name"]
            value = setup_s if name == "setup_s" else res["metrics"][name]
            metrics[name] = {"value": value, "unit": m["unit"]}
    else:
        ctx = {"cell": cell, "trace": summary, "spans": spans, "work": work,
               "device": device}
        for m in cell["per_layer"]:
            value = reader(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["entry"]["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": gaps}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
