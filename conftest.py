"""How `pytest -n N` starts its workers and cuts the suite into units of
work under `--dist loadfile`.

pytest loads this file before `tests/conftest.py` (it sits in the rootdir),
so xdist finds the hooks below before it starts its workers.
"""

import pytest

# Files whose cases `--dist loadfile` hands out one by one, not as one unit
# of work. A file belongs here when its worker time alone is a large share
# of the tier-1 time limit and its cases share no module fixture worth
# keeping together. test_fused_encode.py runs the reference kernel B in
# interpret mode: ~1,260 worker-seconds in 60 cases, which on one worker
# were the suite's wall time.
_SPREAD_FILES = ("test_fused_encode.py",)


def _xdist_scope(nodeid: str) -> str:
    """The unit of work `nodeid` belongs to under `--dist loadfile`: the
    nodeid itself for a case of a file in _SPREAD_FILES, its file for
    every other case (xdist's own grouping)."""
    path = nodeid.split("::", 1)[0]
    if path.rsplit("/", 1)[-1] in _SPREAD_FILES:
        return nodeid
    return path


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None  # xdist's own scheduler for the mode
    from xdist.scheduler import LoadFileScheduling

    class SpreadLoadFileScheduling(LoadFileScheduling):
        _split_scope = staticmethod(_xdist_scope)

    return SpreadLoadFileScheduling(config, log)


def pytest_configure(config):
    # The reference's host library (dct_tpu/native.py) is built by `make`
    # straight into build/libdctbits.so on first use. Workers that start
    # on a fresh checkout all build it at once, and one that loads another's
    # half-written file falls back to the Python decoder for its whole
    # session. So the xdist controller builds it once, before any worker.
    if config.getoption("numprocesses", None) and not hasattr(
        config, "workerinput"
    ):
        from dct_tpu import native

        native.available()
