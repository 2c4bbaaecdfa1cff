"""The check sees the faults a cell can have and fails the control.

Each run skips the command's look for a card and drives the rest of a
run on the CPU, at small frame sizes and with each cell's committed
batch and sampling, with the timed path broken underneath: an answer
altered where it is produced, half of a batch left out (its second half
a copy of the first), an answer left out, and a step that hands back its
previous answer unchanged. ``correct`` has to come out false, on every
seed tried. The control (the reference in TF32 in the codec's place) has to
read above every limit of 0.
"""

from __future__ import annotations

import pytest
import torch

from dct_tpu_torch.models import codec
from dct_tpu_torch.models.video import VideoCodec
from dct_tpu_torch.ops import bitstream as bs
from perfbench import control, harness
from perfbench.tests.conftest import edit_json, small_copy

CPU = torch.device("cpu")
ONCARD = "gray1080p-q50-static.oncard-b8"
FEED = "rgb4k-420-q90-v2.feed-b8"
ARCHIVE = "gray1080p-q50-static.archive-b32"
SEEDS = [2**31 + 21, 7, 2**31 + 1000003]


def run(root, name, seed=SEEDS[0]):
    return harness.run(name, seed, 0.4, False, CPU, 0.0, root)


def flip_byte(data: bytes) -> bytes:
    b = bytearray(data)
    b[len(b) - 3] ^= 0x21
    return bytes(b)


def stale(fn):
    """Hand back the previous call's answer (the first call's own)."""
    prev = []

    def wrapped(*a, **k):
        out = fn(*a, **k)
        prev.append(out)
        return prev[-2] if len(prev) > 1 else out
    return wrapped


def oncard_fault(kind):
    real = codec.encode_step

    def altered(*a, **k):
        packed, var, bb = real(*a, **k)
        units = packed.units.clone()
        units[0, 0, 1] ^= 0x0100
        return bs.PackedStripes(units, packed.bit_lengths), var, bb

    def half(*a, **k):
        packed, var, bb = real(*a, **k)
        f = packed.units.shape[0] // 2
        units, bits = packed.units.clone(), packed.bit_lengths.clone()
        units[f:], bits[f:] = units[:f], bits[:f]
        if bb is not None:
            bb = bb.clone()
            bb[f:] = bb[:f]
        return bs.PackedStripes(units, bits), var, bb

    return {"altered": altered, "half": half, "stale": stale(real)}[kind]


def list_fault(real, kind):
    def altered(*a, **k):
        return [flip_byte(d) for d in real(*a, **k)]

    def one(*a, **k):
        out = real(*a, **k)
        return [flip_byte(out[0])] + out[1:]

    def half(*a, **k):
        out = real(*a, **k)
        f = len(out) // 2
        return out[:f] + out[:f]

    def short(*a, **k):
        return real(*a, **k)[:-1]

    return {"altered": altered, "one": one, "half": half, "short": short,
            "stale": stale(real)}[kind]


def feed_fault(kind):
    real = VideoCodec.decode_to_device

    def altered(self, streams):
        out = real(self, streams).clone()
        out[:, 3, 5, 1] += 3
        return out

    def one(self, streams):
        out = real(self, streams).clone()
        out[0, 3, 5, 1] += 3
        return out

    def half(self, streams):
        out = real(self, streams).clone()
        f = out.shape[0] // 2
        out[f:] = out[:f]
        return out

    def short(self, streams):
        return real(self, streams)[:-1]

    return {"altered": altered, "one": one, "half": half, "short": short,
            "stale": stale(real)}[kind]


@pytest.mark.parametrize("kind", ["altered", "half", "short", "stale"])
def test_oncard_faults_fail(small_root, monkeypatch, kind):
    if kind == "short":
        real = codec.encode_step

        def fault(*a, **k):
            packed, var, bb = real(*a, **k)
            return (bs.PackedStripes(packed.units[:-1],
                                     packed.bit_lengths[:-1]), var,
                    None if bb is None else bb[:-1])
    else:
        fault = oncard_fault(kind)
    monkeypatch.setattr(codec, "encode_step", fault)
    r = run(small_root, ONCARD)
    assert not r["correct"]
    if kind == "short":
        assert r["checks"]["outputs_missing"]["value"] > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["altered", "half", "short", "stale"])
def test_archive_faults_fail(small_root, monkeypatch, kind, seed):
    monkeypatch.setattr(VideoCodec, "encode",
                        list_fault(VideoCodec.encode, kind))
    r = run(small_root, ARCHIVE, seed)
    assert not r["correct"]
    if kind == "short":
        assert r["checks"]["outputs_missing"]["value"] > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["altered", "half", "short", "stale"])
def test_feed_faults_fail(small_root, monkeypatch, kind, seed):
    monkeypatch.setattr(VideoCodec, "decode_to_device", feed_fault(kind))
    r = run(small_root, FEED, seed)
    assert not r["correct"]
    if kind == "short":
        assert r["checks"]["outputs_missing"]["value"] > 0


@pytest.fixture(scope="module")
def every_answer_root(tmp_path_factory):
    """The small copy with every output of a kept call judged."""
    root = small_copy(tmp_path_factory.mktemp("every"))
    for cell in (ARCHIVE, FEED):
        edit_json(root / "workloads" / f"{cell}.json",
                  lambda c: c["params"].update(check_frames=c["params"].get(
                      "stack", c["params"].get("batch"))))
    return root


@pytest.mark.parametrize("cell,fault", [
    (ARCHIVE, lambda: (VideoCodec, "encode",
                       list_fault(VideoCodec.encode, "one"))),
    (FEED, lambda: (VideoCodec, "decode_to_device", feed_fault("one")))])
def test_one_altered_answer_fails_where_every_answer_is_judged(
        every_answer_root, monkeypatch, cell, fault):
    monkeypatch.setattr(*fault())
    assert not run(every_answer_root, cell)["correct"]


def test_picks_cover_every_half_of_a_batch():
    for seed in range(200):
        for n, k in ((8, 2), (32, 4)):
            got = harness.picks(seed, 5, n, k)
            assert len(set(got)) == k and all(0 <= j < n for j in got)
            assert min(got) < n // 2 <= max(got)


@pytest.mark.parametrize("name", [ONCARD, FEED, ARCHIVE])
def test_sound_runs_pass(small_root, name):
    r = run(small_root, name)
    assert r["correct"] and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.fixture(scope="module")
def control_root(tmp_path_factory):
    """Frames of 240 x 320: enough coefficients near a rounding boundary
    for TF32 to move some (at the cells' own sizes the control moves
    thousands)."""
    root = small_copy(tmp_path_factory.mktemp("control"))
    for name in ("gray1080p-q50-static", "rgb4k-420-q90-v2"):
        edit_json(root / "configs" / f"{name}.json",
                  lambda c: c["frame"].update(height=240, width=320))
    return root


@pytest.mark.parametrize("name", [ONCARD, FEED, ARCHIVE])
def test_the_control_fails(control_root, name):
    got = control.readings(name, 2**31 + 3, CPU, control_root)
    assert max(got.values()) > 0, got
    if name == FEED:
        assert got["rgb_mismatches"] > 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 255.0])
    assert control.tf32(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9,
                                        255.0]
