"""The adaptive on-card cell's check (perfbench/traffic/oncard_adaptive.py)
sees the faults such a cell can have, passes sound runs and fails its
control; the roofline count of the whole adaptive encode.

Each run drives the cell on the CPU at 240 x 320, with its committed
batch, pool and sampling, the timed path broken underneath: one variance
code altered where its interval holds one code, the DC step scaled like
the AC steps, the AC steps scaled from the normalised variance rather
than from the code, half of a batch left out (its second half a copy of
the first), and the batch's last plane left out. ``correct`` has to come
out false, on every seed tried.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from dct_tpu_torch import tables
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.ops import blocks as blk
from dct_tpu_torch.ops import quant, transform
from perfbench import control_adaptive, harness, peaks, roofline
from perfbench import roofline_adaptive
from perfbench.reference import adaptive
from perfbench.tests.conftest import edit_json, small_copy

CPU = torch.device("cpu")
CELL = "gray1080p-q50-adaptive.oncard-b32"
CONFIG = "gray1080p-q50-adaptive"
SEEDS = [2**31 + 21, 7, 2**31 + 1000003]


@pytest.fixture(scope="module")
def ada_root(tmp_path_factory):
    root = small_copy(tmp_path_factory.mktemp("adaptive"))
    edit_json(root / "configs" / f"{CONFIG}.json",
              lambda c: c["frame"].update(height=240, width=320))
    return root


def run(root, seed, trace=False):
    return harness.run(CELL, seed, 0.4, trace, CPU, 0.0, root)


def one_code_altered(monkeypatch):
    real = codec.encode_step

    def fn(image, *a, **k):
        packed, codes, bb = real(image, *a, **k)
        want = adaptive.Plane(image[0].numpy(), 50)
        j = int((want.code_lo == want.code_hi).nonzero()[0][0])
        codes = codes.clone()
        codes[0, j] = want.code_lo[j] + (1 if want.code_lo[j] < 255 else -1)
        return packed, codes, bb

    monkeypatch.setattr(codec, "encode_step", fn)


def dc_scaled(monkeypatch):
    """The DC step scaled like the AC steps."""
    real = tables.build

    def fn(*a, **k):
        ops = real(*a, **k)
        return dataclasses.replace(ops, ac_mask=torch.ones_like(ops.ac_mask))

    monkeypatch.setattr(tables, "build", fn)


def scale_from_v(monkeypatch):
    """The AC steps scaled by 2 - v from the variance itself,
    quantization.c's arithmetic, while the codes stay as they are."""
    real = codec._adaptive

    def fn(pixels, cfg, planes=False):
        codes, _ = real(pixels, cfg, planes)
        px = blk.image_to_blocks(pixels, cfg.block_size) if planes else pixels
        v = quant.block_variance_flat(transform.level_shift(px)) / 1000.0
        return codes, 2.0 - torch.clamp(v, 0.1, 1.0)

    monkeypatch.setattr(codec, "_adaptive", fn)


def half(monkeypatch):
    real = codec.encode_step

    def fn(*a, **k):
        packed, codes, bb = real(*a, **k)
        f = packed.units.shape[0] // 2
        units, bits = packed.units.clone(), packed.bit_lengths.clone()
        codes, bb = codes.clone(), bb.clone()
        for t in (units, bits, codes, bb):
            t[f:] = t[:f]
        return bs.PackedStripes(units, bits), codes, bb

    monkeypatch.setattr(codec, "encode_step", fn)


def short(monkeypatch):
    real = codec.encode_step

    def fn(*a, **k):
        packed, codes, bb = real(*a, **k)
        return (bs.PackedStripes(packed.units[:-1], packed.bit_lengths[:-1]),
                codes[:-1], bb[:-1])

    monkeypatch.setattr(codec, "encode_step", fn)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault,check", [
    (one_code_altered, "variance_code_mismatches"),
    (dc_scaled, "coef_mismatches"), (scale_from_v, "coef_mismatches"),
    (half, "coef_mismatches"), (short, "outputs_missing")])
def test_faults_fail(ada_root, monkeypatch, fault, check, seed):
    fault(monkeypatch)
    r = run(ada_root, seed)
    assert not r["correct"]
    assert r["checks"][check]["value"] > 0, r["checks"]


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_sound_runs_pass(ada_root, seed):
    r = run(ada_root, seed)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"variance_code_mismatches",
                                "coef_mismatches", "stream_faults",
                                "outputs_missing"}
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"oncard_encode_mpix_s", "setup_s"}


def test_a_traced_run_reads_the_variance_span_and_the_enqueue(ada_root):
    r = run(ada_root, SEEDS[0], trace=True)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["variance_ms_per_frame.adaptive"] > 0
    assert m["enqueue_ms.adaptive"] > 0
    # no kernel runs on the CPU: the device readers find nothing
    assert "encode_roofline_pct.adaptive" not in m


def test_the_control_fails(ada_root):
    got = control_adaptive.readings(CELL, 2**31 + 3, CPU, ada_root)
    assert set(got) == set(control_adaptive.VARIANTS)
    for v in got.values():
        assert v["coef_mismatches"] > 0 and v["variance_code_mismatches"] == 0


def test_the_roofline_counts_pixels_codes_and_bs_outputs():
    # 10 blocks in 2 stripes holding 30 payload bytes, with the index:
    # 640 pixel bytes and 10 code bytes, B's 30 + 2 x 4 + 10 x 2 out
    nbytes, ops = roofline_adaptive.encode(10, 2, 30, True)
    assert nbytes == 640 + 10 + 30 + 8 + 20
    assert ops == 10 * (roofline.TRANSFORM_OPS + 262)
    assert roofline_adaptive.encode(10, 2, 30, False)[0] == nbytes - 20
    assert roofline.seconds(nbytes, ops, peaks.INT8_OPS_PER_S) == (
        pytest.approx(nbytes / peaks.HBM_BYTES_PER_S))
