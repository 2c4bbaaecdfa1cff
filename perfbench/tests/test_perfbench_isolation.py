"""What the command loads, in subprocesses: nothing whose top-level name
is jax, jaxlib, flax or dct_tpu (compared whole: dct_tpu_torch is the
program), and the reference loads nothing of dct_tpu_torch. Without a
card the command exits with an error and prints no result."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.tests.conftest import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "dct_tpu")


def run_py(code: str, cwd=REPO) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, text=True,
                          capture_output=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})


def test_a_run_loads_nothing_of_jax_or_the_jax_package(small_root):
    code = f"""
import json, sys, torch
sys.path.insert(0, {str(REPO)!r})
from perfbench import harness
for cell in ("gray1080p-q50-static.archive-b32", "rgb4k-420-q90-v2.feed-b8"):
    r = harness.run(cell, 5, 0.2, True, torch.device("cpu"), 0.0,
                    __import__("pathlib").Path({str(small_root)!r}))
    assert r["correct"], r
print(json.dumps(sorted(sys.modules)))
"""
    p = run_py(code)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = json.loads(p.stdout.strip().splitlines()[-1])
    assert "dct_tpu_torch" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_the_reference_loads_nothing_of_the_program():
    p = run_py("import sys, json; import perfbench.reference.judge, "
               "perfbench.reference.entropy; print(json.dumps(sorted("
               "sys.modules)))")
    assert p.returncode == 0, p.stderr
    mods = json.loads(p.stdout)
    assert not [m for m in mods if m.split(".")[0]
                in FORBIDDEN + ("dct_tpu_torch", "torch")]


@pytest.mark.parametrize("trace", ["0", "1"])
def test_without_a_card_the_command_fails_and_prints_no_result(trace):
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "gray1080p-q50-static.oncard-b8", "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", trace], cwd=REPO, text=True,
        capture_output=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "CUDA card" in p.stderr
