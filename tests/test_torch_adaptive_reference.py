"""The port's adaptive quantization against the benchmark's plain
reference (perfbench/reference/adaptive.py), on the CPU.

``codec.encode_step`` with ``adaptive=True`` on padded planes: every
block's u8 variance code in its accepted interval, and every zigzag
coefficient, decoded from the stripes by the reference, in its interval
under that code's scale. Flat blocks and busy ones put both ends of the
clamp in play. Two wrong encoders each read mismatches, so the check
bites: the AC steps scaled from the normalised variance itself, without
the u8 code the container carries, and the DC step scaled like the AC
ones.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import quant
from perfbench import frames, harness
from perfbench.reference import adaptive
from perfbench.tests.test_perfbench_adaptive import dc_scaled, scale_from_v

CPU = torch.device("cpu")
CFG = CodecConfig(quality=50, static_tables=True, adaptive=True)
KIND = harness.traffic("oncard_adaptive")
COUNTS = ("variance_code_mismatches", "coef_mismatches", "stream_faults")


def photo(n, h, w, seed):
    return frames.pad_to_blocks(frames.photo(n, h, w,
                                             frames.generator(seed, CPU),
                                             CPU))


def flat_and_busy(seed):
    """Photo planes with noise of standard deviation 30 (variances that
    spread the codes between the clamps), then whole blocks made flat
    (variance 0: code 0) and others a 0/255 checkerboard (variance
    16256.25: code 255)."""
    p = photo(2, 96, 128, seed)
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.normal(0.0, 30.0, p.shape).astype(np.float32))
    p = (p.to(torch.float32) + noise).clamp(0, 255).to(torch.uint8)
    checker = torch.from_numpy(
        (np.indices((8, 8)).sum(axis=0) % 2 * 255).astype(np.uint8))
    p[:, 0:8, 0:16] = 90
    p[:, 8:16, 8:24] = checker.repeat(1, 2)
    return p


def judge(planes, out, quality=50):
    packed, codes, block_bits = out
    total = dict.fromkeys(COUNTS, 0)
    for f in range(planes.shape[0]):
        got = KIND.check_plane(
            planes[f].numpy(), packed.units[f].numpy(),
            packed.bit_lengths[f].numpy(),
            None if block_bits is None else block_bits[f].numpy(),
            codes[f].numpy(), quality)
        for k in COUNTS:
            total[k] += got[k]
    return total


def encode(planes, cfg=CFG):
    return codec.encode_step(planes, cfg, planes.shape[-2] // cfg.block_size)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_photo_planes_keep_every_code_and_coefficient_in_its_interval(
        seed):
    planes = photo(2, 64, 96, seed)
    out = encode(planes)
    assert judge(planes, out) == dict.fromkeys(COUNTS, 0)
    codes = out[1]
    assert codes.shape == (2, 8 * 12) and codes.dtype == torch.uint8
    assert int(codes.max()) > 0   # not every block at the low clamp


def test_flat_and_busy_blocks_reach_both_ends_of_the_clamp():
    planes = flat_and_busy(11)
    out = encode(planes)
    assert judge(planes, out) == dict.fromkeys(COUNTS, 0)
    codes = out[1].numpy()
    assert (codes[:, :2] == 0).all()            # the flat blocks
    assert (codes[:, 16 + 1:16 + 3] == 255).all()   # the checkerboards
    inner = codes[:, 2 * 16:]
    assert len(np.unique(inner)) > 10 and ((inner > 0) & (inner < 255)).any()


def test_the_reference_scale_is_the_codes():
    assert adaptive.scale([0, 255]).tolist() == [1.9, 1.0]
    want = quant.scale_from_variance_code(
        torch.arange(256, dtype=torch.int32).to(torch.uint8))
    got = adaptive.scale(np.arange(256))
    assert torch.allclose(want.to(torch.float64), got, rtol=5 * 2**-24,
                          atol=0)


@pytest.mark.parametrize("fault", [scale_from_v, dc_scaled])
def test_a_wrong_scale_reads_mismatches(monkeypatch, fault):
    planes = flat_and_busy(17)
    fault(monkeypatch)
    got = judge(planes, encode(planes))
    assert got["coef_mismatches"] > 0, got
    assert got["variance_code_mismatches"] == 0 and got["stream_faults"] == 0
