"""A copy of the benchmark at small frame sizes, run on the CPU.

The copy holds BENCHMARK.json and perfbench/ as committed, with each
configuration's frames cut to a few blocks; every cell keeps its
committed parameters (batch, pool, how many outputs its check judges).
The harness's runs take ``device`` and ``root``, so a test drives the
rest of a run on the CPU after the command's look for a card.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL = {"gray1080p-q50-static": (60, 88), "rgb4k-420-q90-v2": (46, 70)}


def edit_json(path: pathlib.Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def small_copy(dst: pathlib.Path) -> pathlib.Path:
    """-> the copy's perfbench directory."""
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    root = dst / "perfbench"
    for name, (h, w) in SMALL.items():
        edit_json(root / "configs" / f"{name}.json",
                  lambda c, h=h, w=w: c["frame"].update(height=h, width=w))
    return root


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return small_copy(tmp_path_factory.mktemp("bench"))
