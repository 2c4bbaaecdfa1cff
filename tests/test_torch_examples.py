"""The port's examples (examples/torch_demo.py, examples/torch_serving.py)
beside the JAX package's (examples/demo.py, examples/serving.py), on the
CPU, each run in-process (runpy, then main()).

Tolerance: every printed line equal, so byte counts, ratios and booleans
exactly and PSNRs to the printed two decimals. Excepted: the backend
lines, the ingest rate (Mpix/s on each package's own clock), and the
demo's section 5, which the JAX package runs on the test session's 8
virtual CPU devices and the port runs only over the ranks of a process
group (checked here under torchrun, two gloo ranks).
"""

import contextlib
import io
import os
import pathlib
import re
import runpy
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = {"demo": ("demo.py", "torch_demo.py"),
            "serving": ("serving.py", "torch_serving.py")}
SHARDED = re.compile(r"^(sharded over \d+ devices|sharded encode: skipped)")
RATE = re.compile(r"\s*[\d.]+ Mpix/s wall$")


def _printed(path: pathlib.Path, *argv) -> list[str]:
    main = runpy.run_path(str(path))["main"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv)) if argv else main()
    assert rc == 0
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def printed():
    """{example: (the JAX example's lines, the port's with --device
    cpu)}."""
    return {name: (_printed(REPO / "examples" / ref),
                   _printed(REPO / "examples" / port, "--device", "cpu"))
            for name, (ref, port) in EXAMPLES.items()}


def _comparable(lines: list[str]) -> list[str]:
    return [RATE.sub(" Mpix/s wall", line) for line in lines
            if not line.startswith("backend:") and not SHARDED.match(line)]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_reference_numbers(printed, name):
    ref, port = printed[name]
    assert port[0] == "backend: cpu" + (", devices: 1" if name == "demo"
                                        else "")
    assert len(port) == len(ref) and _comparable(port) == _comparable(ref)


def test_demo_numbers(printed):
    """The numbers the demo prints, pinned (the same on both packages)."""
    ref, port = printed["demo"]
    text = "\n".join(port)
    for want in ("gray 320x240  ->  10604 B", "rgb  320x240  ->  19572 B",
                 "4682 B", "repaired == pristine: True",
                 "matches full decode: True", "15906 B total",
                 "quality 70, 11151 B"):
        assert want in text
    assert "sharded encode: skipped (1 device" in text
    assert any(re.match(r"sharded over 8 devices == single-device bytes: "
                        r"True", line) for line in ref)


def test_serving_feed_stays_on_the_device(printed):
    """feed prints the JAX toy model's statistics; the ingest ratio is the
    reference's, only its rate differs."""
    ref, port = printed["serving"]
    assert port[2] == ref[2] and port[2].startswith(
        "feed   : (8, 240, 320) u8 device batch -> model stats mean[0]=")
    assert RATE.search(port[1]) and RATE.search(ref[1])


def test_serving_model_takes_the_decoded_tensor():
    """The model's input is the tensor decode_to_device returned, on the
    codec's device, under inference mode."""
    mod = runpy.run_path(str(REPO / "examples" / "torch_serving.py"))
    seen = []

    class Spy(mod["ToyModel"]):
        def forward(self, batch):
            import torch

            seen.append((batch.device.type, batch.dtype,
                         torch.is_inference_mode_enabled()))
            return super().forward(batch)

    mod["feed_model"].__globals__["ToyModel"] = Spy
    frames = mod["np"].stack([mod["image_io"].synthetic_image(
        24, 40, "photo", seed=s) for s in range(2)])
    with contextlib.redirect_stdout(io.StringIO()):
        streams = mod["ingest_stream"](frames, "cpu")
        mod["feed_model"](streams, "cpu")
    import torch

    assert seen == [("cpu", torch.uint8, True)]


@pytest.mark.parametrize("example", ["torch_demo.py", "torch_serving.py"])
def test_default_device_is_the_card(example):
    """Without --device the examples take the card, and raise where there
    is none, as the CLI does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    main = runpy.run_path(str(REPO / "examples" / example))["main"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with contextlib.redirect_stdout(io.StringIO()):
            main([])


def test_demo_shards_over_two_gloo_ranks(printed):
    """Under torchrun with two gloo ranks on the CPU the demo runs section
    5 (encode_image_sharded over a (1, 2) mesh), rank 0 alone prints, and
    every other line is the one-process run's."""
    env = dict(os.environ, PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         str(REPO / "examples" / "torch_demo.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "backend: cpu, devices: 2"
    assert "sharded over 2 devices == single-device bytes: True" in lines
    assert _comparable(lines) == _comparable(printed["demo"][1])
