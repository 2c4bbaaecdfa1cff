"""The rootdir's conftest.py: how `--dist loadfile` cuts the suite into
units of work (pytest_xdist_make_scheduler: the cases of a file in
_SPREAD_FILES are units of their own, every other file stays one unit),
and the xdist controller building the reference's host library before
its workers start (pytest_configure)."""

from __future__ import annotations

import importlib.util
import types
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "_root_conftest", Path(__file__).resolve().parents[1] / "conftest.py"
)
root_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(root_conftest)

FUSED = "tests/test_fused_encode.py"
PARALLEL = "tests/test_torch_parallel.py"


@pytest.mark.parametrize(
    "nodeid, scope",
    [
        (f"{FUSED}::test_fused_extreme_pixels",
         f"{FUSED}::test_fused_extreme_pixels"),
        (f"{FUSED}::test_fused_matches_staged[8-False-10]",
         f"{FUSED}::test_fused_matches_staged[8-False-10]"),
        ("elsewhere/tests/test_fused_encode.py::test_merge_tree_unit",
         "elsewhere/tests/test_fused_encode.py::test_merge_tree_unit"),
        (f"{PARALLEL}::test_collectives_counted", PARALLEL),
        (f"{PARALLEL}::TestMesh::test_rows", PARALLEL),
        (f"{PARALLEL}::test_mesh_shapes[shape0]", PARALLEL),
        ("tests/test_torch_fused_encode.py::test_modes[8]",
         "tests/test_torch_fused_encode.py"),
    ],
)
def test_xdist_scope(nodeid, scope):
    assert root_conftest._xdist_scope(nodeid) == scope


def _config(dist):
    option = types.SimpleNamespace(dist=dist, tx=["3*popen"])
    return types.SimpleNamespace(
        option=option, getvalue=lambda name: getattr(option, name)
    )


def test_hook_leaves_other_modes_to_xdist():
    assert root_conftest.pytest_xdist_make_scheduler(_config("load"),
                                                     None) is None


def test_hook_splits_loadfile_by_xdist_scope():
    from xdist.scheduler import LoadFileScheduling

    sched = root_conftest.pytest_xdist_make_scheduler(_config("loadfile"),
                                                      None)
    assert isinstance(sched, LoadFileScheduling)
    assert sched._split_scope is root_conftest._xdist_scope


@pytest.mark.parametrize("numprocesses, worker, builds", [
    (6, False, True),    # the xdist controller
    (6, True, False),    # an xdist worker
    (None, False, False),  # no xdist
])
def test_only_the_xdist_controller_builds_the_reference_library(
        monkeypatch, numprocesses, worker, builds):
    from dct_tpu import native

    calls = []
    monkeypatch.setattr(native, "available", lambda: calls.append(1) or True)
    config = types.SimpleNamespace(
        getoption=lambda name, default=None: numprocesses)
    if worker:
        config.workerinput = {}
    root_conftest.pytest_configure(config)
    assert calls == ([1] if builds else [])
