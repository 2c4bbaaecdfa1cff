"""The port's utilities (utils/metrics.py, utils/tracing.py) and its
top-level API (dct_tpu_torch.encode / decode / encode_to_size /
encode_to_psnr) against the JAX package's on the CPU.

The metrics must give the reference's values, for numpy arrays and for
torch tensors. The top-level functions must write the reference's bytes,
or bytes that differ only in encode ties (dct_tpu_torch.testing), and
choose the reference's qualities; without a card and without
``device="cpu"`` they raise.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import dct_tpu
import dct_tpu_torch
from dct_tpu import container as ref_cont
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.utils import metrics as ref_metrics
from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch.models import color
from dct_tpu_torch.utils import image_io, metrics, tracing


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(17)
    a = rng.integers(0, 256, (33, 47), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0,
                255).astype(np.uint8)
    return {"gray": (a, b),
            "rgb": (rng.integers(0, 256, (20, 24, 3), dtype=np.uint8),
                    rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)),
            "float": (rng.normal(size=(5, 7)), rng.normal(size=(5, 7)))}


@pytest.mark.parametrize("kind", ("gray", "rgb", "float"))
@pytest.mark.parametrize("as_tensor", (False, True), ids=("numpy", "torch"))
def test_image_metrics_equal_the_reference(pairs, kind, as_tensor):
    a, b = pairs[kind]
    want = (ref_metrics.mse(a, b), ref_metrics.psnr(a, b),
            ref_metrics.psnr(a, b, peak=1.0))
    if as_tensor:
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    assert (metrics.mse(a, b), metrics.psnr(a, b),
            metrics.psnr(a, b, peak=1.0)) == want


def test_psnr_of_identical_images_is_inf(pairs):
    a, _ = pairs["gray"]
    assert metrics.psnr(a, a.copy()) == float("inf")
    assert metrics.psnr(torch.from_numpy(a), a) == float("inf")
    assert metrics.mse(a, a) == 0.0


@pytest.mark.parametrize("args", ((64, 10), (64, 0), (16, 1), (256, 300)))
def test_ratios_equal_the_reference(args):
    assert metrics.rle_ratio(*args) == ref_metrics.rle_ratio(*args)
    assert (metrics.compression_ratio(*args)
            == ref_metrics.compression_ratio(*args))


def test_measure_throughput_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2, [x + 1, None]

    tp = metrics.measure_throughput(fn, torch.ones(64), iters=4, warmup=2,
                                    pixels=64)
    assert isinstance(tp, metrics.Throughput)
    assert len(calls) == 6 and tp.iters == 4 and tp.pixels == 64
    assert tp.seconds_per_frame > 0
    assert tp.mpix_per_s == pytest.approx(64 / tp.seconds_per_frame / 1e6)
    none = metrics.measure_throughput(fn, torch.ones(4), iters=1, warmup=0)
    assert none.mpix_per_s == 0.0 and len(calls) == 8  # one warm-up call


def test_kloop_delta_seconds_on_the_cpu():
    trips = []

    def make_step(k):
        def run(x):
            acc = torch.zeros((), dtype=torch.int64)
            for i in range(k):  # distinct data each trip
                acc += (x ^ (i & 255)).sum()
            trips.append(k)
            return acc
        return run

    x = torch.arange(1 << 16, dtype=torch.int64)
    dt, noisy = metrics.kloop_delta_seconds(make_step, x, k=5, iters=3)
    assert dt > 0 and isinstance(noisy, bool)
    assert trips == [1] * 4 + [5] * 4  # a warm-up call, then iters calls
    # a body that costs nothing: a positive time either way
    same = metrics.kloop_delta_seconds(
        lambda k: (lambda x: torch.zeros(())), x, k=3, iters=1)
    assert same[0] > 0 and isinstance(same[1], bool)


def test_named_scope_fills_and_reset_clears_the_registry():
    tracing.reset_timings()
    for _ in range(3):
        with tracing.named_scope("stage"):
            torch.ones(8).sum()
    with tracing.named_scope("other"):
        pass
    s = tracing.timings_summary()
    assert set(s) == {"stage", "other"}
    assert s["stage"]["calls"] == 3 and s["stage"]["total_s"] > 0
    assert s["stage"]["mean_ms"] == pytest.approx(
        1e3 * s["stage"]["total_s"] / 3)
    tracing.reset_timings()
    assert tracing.timings_summary() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with tracing.trace(str(tmp_path)):
        with tracing.named_scope("traced stage"):
            torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert "traced stage" in files[0].read_text()
    tracing.reset_timings()


# ---------------------------------------------------------------------------
# The top-level API
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def images():
    gray = image_io.synthetic_image(40, 48, "photo", seed=23)
    rgb = np.stack([gray, np.roll(gray, 3, 0), np.roll(gray, 5, 1)], -1)
    return {"gray": gray, "rgb": rgb}


def _same_or_ties(got: bytes, want: bytes, image) -> None:
    """got == want, or every differing coefficient is an encode tie. For a
    color container ``want`` is re-encoded by the reference package from
    the port's planes first: the two packages' color conversions may
    differ at float64 .5 ties (tests/test_torch_color.py holds them to
    that), and a plane tie moves coefficients by more than a tie."""
    if got == want:
        return
    c = ref_cont.deserialize(want)
    planes = [np.asarray(image)]
    if c.config.chroma != "gray":
        planes = [p.numpy() for p in color._to_planes(
            torch.from_numpy(np.asarray(image)), c.config.chroma)]
        want = ref_cont.serialize(dataclasses.replace(c, planes=[
            ref_codec.encode_plane(p, c.config, chroma=i > 0)
            for i, p in enumerate(planes)]))
    if got != want:
        assert testing.plane_encode_mismatches(got, want, planes)[1] == 0


@pytest.mark.parametrize("kind", ("gray", "rgb"))
@pytest.mark.parametrize("kw", (dict(quality=60), dict(
    quality=90, adaptive=True, decode_index=True)), ids=("q60", "q90_v2"))
def test_top_level_encode_decode(images, kind, kw):
    img = images[kind]
    got = dct_tpu_torch.encode(img, CodecConfig(**kw), device="cpu")
    want = dct_tpu.encode(img, RefConfig(**kw))
    _same_or_ties(got, want, img)
    rec = dct_tpu_torch.decode(got, device="cpu")
    assert rec.shape == img.shape and rec.dtype == np.uint8
    assert int(np.abs(rec.astype(int) - dct_tpu.decode(got)).max()) <= 1
    if kind == "gray":
        assert testing.decode_mismatches(rec, dct_tpu.decode(got), got)[1] == 0
    np.testing.assert_array_equal(rec, dct_tpu_torch.decode(got, "cpu"))


@pytest.mark.parametrize("kind", ("gray", "rgb"))
def test_top_level_rate_control(images, kind):
    img = images[kind]
    budget = len(dct_tpu.encode(img, RefConfig(quality=80))) * 2 // 3
    got, q = dct_tpu_torch.encode_to_size(img, budget, device="cpu")
    want, q_ref = dct_tpu.encode_to_size(img, budget)
    assert q == q_ref and len(got) <= budget
    got_p, qp = dct_tpu_torch.encode_to_psnr(img, 33.0, CodecConfig(
        adaptive=True), device="cpu")
    want_p, qp_ref = dct_tpu.encode_to_psnr(img, 33.0, RefConfig(
        adaptive=True))
    assert qp == qp_ref
    assert metrics.psnr(dct_tpu_torch.decode(got_p, "cpu"), img) >= 33.0
    _same_or_ties(got, want, img)
    _same_or_ties(got_p, want_p, img)


def test_top_level_names():
    assert dct_tpu_torch.__version__ == dct_tpu.__version__ == "0.1.0"
    assert set(dct_tpu_torch.__all__) == set(dct_tpu.__all__)
    assert dct_tpu_torch.tables is importlib.import_module(
        "dct_tpu_torch.tables")


@pytest.mark.parametrize("fn", ("encode", "decode", "encode_to_size",
                                "encode_to_psnr"))
def test_top_level_without_a_card_raises(images, monkeypatch, fn):
    img = images["gray"]
    data = dct_tpu_torch.encode(img, device="cpu")
    args = {"encode": (img,), "decode": (data,),
            "encode_to_size": (img, 10_000), "encode_to_psnr": (img, 30.0)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(dct_tpu_torch, fn)(*args[fn])
