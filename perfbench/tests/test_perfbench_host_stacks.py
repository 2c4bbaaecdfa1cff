"""The dynamic-table archive cell's check (perfbench/traffic/
host_stacks.py) sees the faults such a cell can have, passes sound runs
and fails its control.

Each run drives the cell on the CPU at a small frame size, with its
committed stack, pool and sampling, the timed path broken underneath: a
table re-encoded consistently but not the stack's (the static table, or
two code lengths swapped), one coefficient altered, a container left
out, and a stack handed back from the previous call. ``correct`` has to
come out false, on every seed tried.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dct_tpu_torch.models import codec
from dct_tpu_torch.models.video import VideoCodec
from dct_tpu_torch.ops import huffman as hf
from perfbench import control_stacks, harness
from perfbench.tests.conftest import edit_json, small_copy
from perfbench.tests.test_perfbench_faults import list_fault

CPU = torch.device("cpu")
CELL = "gray1080p-q50-dynamic.archive-b32"
CONFIG = "gray1080p-q50-dynamic"
SEEDS = [2**31 + 21, 7, 2**31 + 1000003]


def root_at(tmp_path_factory, h, w):
    root = small_copy(tmp_path_factory.mktemp("dynamic"))
    edit_json(root / "configs" / f"{CONFIG}.json",
              lambda c: c["frame"].update(height=h, width=w))
    return root


@pytest.fixture(scope="module")
def dyn_root(tmp_path_factory):
    return root_at(tmp_path_factory, 60, 88)


def run(root, seed, trace=False):
    return harness.run(CELL, seed, 0.4, trace, CPU, 0.0, root)


def static_table(cfg, hist):
    return hf.default_category_table(cfg.quality)


def swapped_table(cfg, hist):
    """The stack's table with the lengths of two present categories of
    different lengths swapped: a valid code, consistently used."""
    lengths = hf.CanonicalTable.from_frequencies(hist).lengths.copy()
    live = np.flatnonzero(lengths)
    i = live[np.argmin(lengths[live])]
    j = live[np.argmax(lengths[live])]
    lengths[[i, j]] = lengths[[j, i]]
    return hf.CanonicalTable(lengths)


def altered_coefficient(real):
    def fn(*a, **k):
        out = real(*a, **k).clone()
        out[0, 5] += 7
        return out
    return fn


def fault(kind):
    if kind == "static_table":
        return codec, "_build_table", static_table
    if kind == "swapped_lengths":
        return codec, "_build_table", swapped_table
    if kind == "coefficient":
        return codec, "encode_transform", altered_coefficient(
            codec.encode_transform)
    real = VideoCodec.encode
    return VideoCodec, "encode", list_fault(
        real, {"left_out": "short", "stale": "stale"}[kind])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["static_table", "swapped_lengths",
                                  "coefficient", "left_out", "stale"])
def test_dynamic_archive_faults_fail(dyn_root, monkeypatch, kind, seed):
    monkeypatch.setattr(*fault(kind))
    r = run(dyn_root, seed)
    assert not r["correct"]
    checks = {k: c["value"] for k, c in r["checks"].items()}
    if kind in ("static_table", "swapped_lengths"):
        # the streams decode and every coefficient is right: only the
        # table against the stack's shows the fault
        assert checks["coef_mismatches"] == 0 and checks["stream_faults"] > 0
    elif kind == "left_out":
        assert checks["outputs_missing"] > 0
    else:
        assert checks["coef_mismatches"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_dynamic_runs_pass(dyn_root, seed):
    r = run(dyn_root, seed)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"encode_mpix_s", "setup_s"}


def test_a_traced_run_reads_the_span_metrics(dyn_root):
    r = run(dyn_root, SEEDS[0], trace=True)
    assert r["correct"]
    for name in ("analyze_ms_per_frame.dynamic", "tables_ms_per_frame.dynamic",
                 "pack_ms_per_frame.dynamic"):
        assert r["metrics"][name]["value"] > 0
    # the kernels' shares need the card's trace
    assert "kernel_a_roofline_pct.dynamic" not in r["metrics"]


def test_the_window_counts_what_kernels_a_and_e_had_to_do(dyn_root):
    cell = harness.load_cell(CELL, dyn_root)
    mod = harness.traffic("host_stacks", dyn_root)
    state = mod.setup(cell, SEEDS[1], CPU)
    mod.warm(state)
    res = mod.window(state, 0.3, harness.Sampler(SEEDS[1], 0.3))
    n = res["attempted"]
    blocks = 8 * 11 * 32           # 60 x 88 frames: 8 x 11 blocks, 32 a stack
    assert res["work"]["kernel_a"] == {"blocks": n * blocks}
    e = res["work"]["kernel_e"]
    assert e["chunks"] == n * blocks * 64 * 3 and e["stripes"] == n * 8 * 32
    out = [state["codec"].encode(s) for s in state["stacks"]]
    per = [sum(len(d) for d in o) for o in out]
    calls = np.bincount(np.arange(n) % 2, minlength=2)
    # the payload is the stripes' bytes: less than the containers
    assert 0 < e["payload_bytes"] < int(calls @ per)


@pytest.fixture(scope="module")
def control_root(tmp_path_factory):
    """Frames of 240 x 320, as the other cells' control test takes."""
    return root_at(tmp_path_factory, 240, 320)


def test_the_control_fails(control_root):
    got = control_stacks.readings(CELL, 2**31 + 3, CPU, control_root)
    assert got["coef_mismatches"] > 0, got
