"""Every configuration, cell, traffic kind and metric reader that
BENCHMARK.json names is a file of its own that the harness finds by
name, and a new cell file runs without a code edit."""

from __future__ import annotations

import json
import re

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import REPO, edit_json, small_copy

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load_and_name_what_exists(w):
    cell = harness.load_cell(w["name"])
    assert cell["config"]["name"] == w["config"]
    assert (harness.HERE / "traffic" / f"{cell['traffic_kind']}.py").is_file()
    mod = harness.traffic(cell["traffic_kind"])
    for fn in ("setup", "warm", "window", "judge"):
        assert callable(getattr(mod, fn))
    names = [m["name"] for m in cell["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_hold_their_settings(c):
    conf = json.loads((REPO / c["file"]).read_text())
    assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    from dct_tpu_torch.config import CodecConfig
    CodecConfig(**conf["settings"])


def test_names_and_units_keep_to_the_contract():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert moved and set(m["workloads"]) <= set(moved[0]["workloads"])


def test_a_new_cell_file_runs_without_a_code_edit(tmp_path):
    root = small_copy(tmp_path)
    name = "gray1080p-q50-static.oncard-b2"
    (root / "workloads" / f"{name}.json").write_text(json.dumps(
        {"config": "gray1080p-q50-static", "traffic_kind": "oncard_batches",
         "params": {"batch": 2, "pool_batches": 2, "in_flight": 2}}))

    def add(bench):
        bench["workloads"].append({"name": name,
                                   "config": "gray1080p-q50-static",
                                   "traffic": "oncard-b2", "chips": 1,
                                   "why": "two planes a batch"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "gray1080p-q50-static.oncard-b8" in m.get("workloads", []):
                m["workloads"].append(name)

    edit_json(root.parent / "BENCHMARK.json", add)
    r = harness.run(name, 11, 0.3, False, torch.device("cpu"), 0.0, root)
    assert r["correct"] and r["attempted"] > 0
    assert set(r["metrics"]) == {"oncard_encode_mpix_s", "setup_s"}
