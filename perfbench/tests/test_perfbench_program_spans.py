"""The per-layer metrics read from the program's own spans
(perfbench/program_spans.py and its readers).

Each cell, at a small size on the CPU with a traced run, gives every
metric of this kind a value; kernel B's launch span opens only on the
card, so the oncard cell's run stands one in around the plain version.
program_spans takes the calls before the longest pause on the card, all
of them on the CPU, and nothing from a program that keeps no store.
"""

from __future__ import annotations

import json

import pytest
import torch

from dct_tpu_torch.ops import fused_encode_cuda
from dct_tpu_torch.utils import tracing
from perfbench import harness, program_spans
from perfbench.tests.conftest import REPO, SMALL

CPU = torch.device("cpu")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
READERS = ("entry_ms", "launch_ms", "parse_ms_per_frame",
           "operands_ms_per_frame", "readback_ms_per_frame",
           "h2d_mb_per_frame", "d2h_mb_per_frame", "host_unspanned_pct",
           "upload_ms_per_frame", "serialize_ms_per_frame")


def span_metrics(cell: str) -> set[str]:
    return {m["name"] for m in BENCH["per_layer"]
            if m["name"].split(".")[0] in READERS
            and cell in m["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_reads_every_span_metric_of_its_cell(
        cell, small_root, monkeypatch):
    real = fused_encode_cuda.encode_plane_stripes_fused

    def launched(*a, **k):  # the span a launch on the card opens
        with tracing.named_scope("kernel.encode_stripes"):
            return real(*a, **k)

    monkeypatch.setattr(fused_encode_cuda, "encode_plane_stripes_fused",
                        launched)
    tracing.reset_timings()
    r = harness.run(cell, 2**31 + 55, 0.3, True, CPU, 0.0, small_root)
    tracing.reset_timings()
    assert r["correct"]
    want = span_metrics(cell)
    assert want and want <= set(r["metrics"])
    got = {k: r["metrics"][k]["value"] for k in want}
    assert all(v is not None and v >= 0 for v in got.values())
    if cell.endswith("archive-b32"):
        h, w = SMALL["gray1080p-q50-static"]
        assert got["h2d_mb_per_frame.archive"] == pytest.approx(h * w / 1e6)
    for k, v in got.items():
        if k.startswith("host_unspanned_pct"):
            assert v <= 100.0


def rec(name, start, end, parent=None, call=1, **counts):
    return tracing.Record(name, start, end, parent, call, counts)


def fake_store(monkeypatch, records):
    monkeypatch.setattr(tracing, "records", lambda: list(records))


STORE = [rec("video.encode", 0, 100, call=1, frames=4),
         rec("container.serialize", 10, 30, parent=0, call=1),
         rec("video.encode", 110, 200, call=2, frames=4),
         rec("container.serialize", 120, 150, parent=2, call=2),
         # the pause in which the benchmark exports the first slice
         rec("video.encode", 5000, 5100, call=3, frames=4),
         rec("container.serialize", 5010, 5090, parent=4, call=3)]


def test_on_the_card_the_calls_before_the_longest_pause_are_taken(
        monkeypatch):
    fake_store(monkeypatch, STORE)
    c = program_spans.calls({"device": torch.device("cuda")})
    assert [e.call for _, e in c.entries] == [1, 2]
    assert c.frames == 8
    assert c.durations_ms("container.serialize") == [20e-6, 30e-6]
    assert c.ms_per_frame("container.serialize") == pytest.approx(50e-6 / 8)
    assert c.unspanned_pct() == pytest.approx(100 * (190 - 50) / 190)


def test_on_the_cpu_every_call_is_taken(monkeypatch):
    fake_store(monkeypatch, STORE)
    c = program_spans.calls({"device": CPU})
    assert [e.call for _, e in c.entries] == [1, 2, 3] and c.frames == 12
    assert c.mb_per_frame("h2d_bytes") is None


def test_an_open_span_and_a_program_without_a_store_read_nothing(
        monkeypatch):
    fake_store(monkeypatch, [None, rec("codec.upload", 1, 2, parent=0)])
    assert program_spans.calls({"device": CPU}) is None
    monkeypatch.delattr(tracing, "records")  # a program older than spans
    ctx = {"device": CPU}
    assert program_spans.calls(ctx) is None
    for name in READERS:
        assert harness.reader(name).read(ctx) is None
