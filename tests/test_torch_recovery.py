"""The port's recovery (dct_tpu_torch.models.recovery) on the CPU, mirroring
tests/test_recovery.py, and against the JAX reference's verify.

Repairs are held byte-identical to the port's own from-scratch encode
(gray and color, 4:4:4 and 4:2:0, static and dynamic tables, adaptive
with DC prediction, coded runs, 2x2 blocks on the staged path); the
region decode to the full decode's rows exactly; the native and Python
integrity scans and the reference's verify to each other exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from dct_tpu.models import recovery as ref_recovery
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig, native
from dct_tpu_torch import container as cont
from dct_tpu_torch.models import codec, recovery, video
from dct_tpu_torch.models.color import ColorImageCodec
from dct_tpu_torch.ops import bitstream as bs

DEV = "cpu"


@pytest.fixture(scope="module")
def image():
    return image_io.synthetic_image(120, 168, "photo", seed=11)


@pytest.fixture(scope="module")
def rgb(image):
    return np.stack([image, np.roll(image, 3, 0), np.roll(image, 5, 1)], -1)


def _encode(cfg: CodecConfig, src: np.ndarray) -> bytes:
    return codec.encode(src, cfg, DEV)


def _corrupt(data: bytes, plane: int, stripe: int) -> bytes:
    """Flip the first 8 bytes of one plane's stripe payload."""
    c = cont.deserialize(data)
    p = c.planes[plane]
    s = bytearray(p.stripes[stripe])
    assert len(s) > 2
    for i in range(min(8, len(s))):
        s[i] ^= 0xA5
    p.stripes[stripe] = bytes(s)
    return cont.serialize(c)


GRAY_CASES = {
    "static": dict(quality=55, static_tables=True, stripe_rows=2),
    "dynamic": dict(quality=55, stripe_rows=2),
    "static_adaptive": dict(quality=55, static_tables=True, adaptive=True,
                            stripe_rows=2),
    "dynamic_adaptive": dict(quality=55, adaptive=True, stripe_rows=2),
    "adaptive_dc_runs_v2": dict(quality=90, adaptive=True,
                                dc_prediction=True, coded_runs=True,
                                decode_index=True, stripe_rows=2),
    "n2_staged": dict(block_size=2, quality=60, stripe_rows=4),
    "n16_direct": dict(block_size=16, huffman_mode="direct"),
}


@pytest.mark.parametrize("case", sorted(GRAY_CASES))
def test_verify_and_repair_gray(image, case):
    cfg = CodecConfig(**GRAY_CASES[case])
    original = _encode(cfg, image)
    assert recovery.verify(original) == []
    bad = _corrupt(original, 0, 3)
    damaged = recovery.verify(bad)
    assert 3 in damaged
    assert damaged == ref_recovery.verify(bad)
    repaired = recovery.repair(bad, image, device=DEV)
    assert repaired == original  # byte-identical to a from-scratch encode
    assert recovery.verify(repaired) == []


def test_v2_containers_are_covered(image):
    cfg = CodecConfig(**GRAY_CASES["adaptive_dc_runs_v2"])
    assert _encode(cfg, image)[4] == 2


def test_repair_noop_on_clean_container(image):
    data = _encode(CodecConfig(quality=50, static_tables=True), image)
    assert recovery.repair(data, image, device=DEV) == data


def test_repair_explicit_stripes_equals_full_encode(image):
    """Re-encoding named stripes (here three, with one named twice)
    reproduces the one-shot encode."""
    cfg = CodecConfig(quality=50)
    original = _encode(cfg, image)
    bad = original
    for s in range(3):
        bad = _corrupt(bad, 0, s)
    assert recovery.repair(bad, image, stripes=[2, 0, 1, 0],
                           device=DEV) == original


def test_repair_rejects_wrong_source_and_stripes(image, rgb):
    data = _encode(CodecConfig(quality=50, static_tables=True), image)
    with pytest.raises(ValueError):
        recovery.repair(data, image[:-8, :], stripes=[0], device=DEV)
    # even with nothing to repair, a wrong source is an error, never a
    # silent no-op success
    with pytest.raises(ValueError):
        recovery.repair(data, image[:-8, :], device=DEV)
    with pytest.raises(ValueError, match="out of range"):
        recovery.repair(data, image, stripes=[99], device=DEV)
    color = _encode(CodecConfig(quality=50, chroma="444"), rgb)
    with pytest.raises(ValueError):
        recovery.repair(color, rgb[:, :, 0], stripes=[(0, 0)], device=DEV)
    with pytest.raises(ValueError):
        recovery.repair(color, rgb[:-8], stripes=[(0, 0)], device=DEV)
    with pytest.raises(ValueError, match="plane index"):
        recovery.repair(color, rgb, stripes=[(3, 0)], device=DEV)


@pytest.mark.parametrize("chroma", ("444", "420"))
def test_rebuild_from_a_sibling_template(image, rgb, chroma):
    """Every frame of a VideoCodec stack carries the stack's tables, so a
    readable sibling rebuilds a lost frame byte for byte."""
    frames = np.stack([rgb, np.roll(rgb, 7, 1), np.roll(rgb, 11, 0)])
    cfg = CodecConfig(quality=60, chroma=chroma, adaptive=True)
    streams = video.VideoCodec(cfg, device=DEV).encode(frames)
    for f in (1, 2):
        assert recovery.rebuild(streams[0], frames[f], device=DEV) == \
            streams[f]
    gray = video.VideoCodec(CodecConfig(quality=60), device=DEV).encode(
        frames[..., 0])
    assert recovery.rebuild(gray[0], frames[2, ..., 0],
                            device=DEV) == gray[2]


def test_decode_region_matches_full(image):
    cfg = CodecConfig(quality=50, static_tables=True, stripe_rows=2)
    data = _encode(cfg, image)
    full = codec.decode(data, DEV)
    for row0, row1 in [(0, 16), (13, 57), (100, 120), (0, 120)]:
        region = recovery.decode_region(data, row0, row1, device=DEV)
        np.testing.assert_array_equal(region, full[row0:row1])


@pytest.mark.parametrize("kw", (
    dict(quality=55, adaptive=True, static_tables=True),
    dict(quality=90, adaptive=True, dc_prediction=True, coded_runs=True,
         decode_index=True),
    dict(block_size=16, quality=70)), ids=("adaptive", "dc_runs_v2", "n16"))
def test_decode_region_configs(image, kw):
    data = _encode(CodecConfig(**kw), image)
    full = codec.decode(data, DEV)
    for row0, row1 in [(40, 80), (1, 119)]:
        np.testing.assert_array_equal(
            recovery.decode_region(data, row0, row1, device=DEV),
            full[row0:row1])


def test_decode_region_bad_range(image):
    data = _encode(CodecConfig(quality=50, static_tables=True), image)
    with pytest.raises(ValueError):
        recovery.decode_region(data, 50, 10, device=DEV)
    with pytest.raises(ValueError):
        recovery.decode_region(data, 0, 10_000, device=DEV)


COLOR_CASES = {
    "444": dict(quality=55, chroma="444", stripe_rows=2),
    "420": dict(quality=55, chroma="420", stripe_rows=2),
    "444_coded_runs": dict(quality=55, chroma="444", coded_runs=True,
                           stripe_rows=2),
    "420_coded_runs": dict(quality=55, chroma="420", coded_runs=True,
                           stripe_rows=2),
    "420_static_adaptive_dc": dict(quality=60, chroma="420", adaptive=True,
                                   dc_prediction=True, static_tables=True),
    "420_q90_v2": dict(quality=90, chroma="420"),
}


@pytest.mark.parametrize("case", sorted(COLOR_CASES))
def test_color_verify_and_repair(rgb, case):
    cfg = CodecConfig(**COLOR_CASES[case])
    original = ColorImageCodec(cfg, device=DEV).encode(rgb)
    assert recovery.verify(original) == []
    bad = _corrupt(_corrupt(original, 1, 2), 0, 0)
    bad = _corrupt(bad, 2, 1)
    damaged = recovery.verify(bad)
    assert {(1, 2), (0, 0), (2, 1)} <= set(damaged)
    assert damaged == ref_recovery.verify(bad)
    repaired = recovery.repair(bad, rgb, device=DEV)
    assert repaired == original  # byte-identical to a from-scratch encode
    assert recovery.verify(repaired) == []


@pytest.mark.parametrize("chroma", ("444", "420"))
def test_color_decode_region_matches_full(rgb, chroma):
    cfg = CodecConfig(quality=60, chroma=chroma, stripe_rows=2)
    data = ColorImageCodec(cfg, device=DEV).encode(rgb)
    full = ColorImageCodec(cfg, device=DEV).decode(data)
    # odd bounds take the half-rate chroma row mapping of 4:2:0
    for row0, row1 in [(0, 16), (13, 57), (101, 119), (0, rgb.shape[0])]:
        region = recovery.decode_region(data, row0, row1, device=DEV)
        np.testing.assert_array_equal(region, full[row0:row1])


def _python_scan(p, cfg) -> list[int]:
    _, _, n_stripes, bps = recovery._geometry(p, cfg)
    mode, table, run_table = recovery._table(p, cfg)
    bad = []
    for s in range(n_stripes):
        try:
            bs.unpack_stripe_host(
                p.stripes[s], bps, cfg.n2, mode,
                cat_table=table if mode == "category" else None,
                val_table=table if mode == "direct" else None,
                vmin=p.vmin, expected_bits=int(p.stripe_bits[s]),
                run_table=run_table)
        except (ValueError, IndexError):
            bad.append(s)
    return bad


@pytest.mark.parametrize("coded_runs", (False, True))
def test_native_and_python_verify_agree(image, coded_runs):
    """The C++ integrity scan flags exactly the stripes the Python scan
    flags: clean, corrupted, and a recorded bit count that is off by one;
    verify takes the Python scan where the library is missing."""
    assert native.available()
    cfg = CodecConfig(quality=55, coded_runs=coded_runs, stripe_rows=1)
    data = _encode(cfg, image)
    variants = [data] + [_corrupt(data, 0, s) for s in (0, 4, 9)]
    c = cont.deserialize(data)
    bits = np.asarray(c.planes[0].stripe_bits).copy()
    bits[6] += 1
    c.planes[0] = dataclasses.replace(c.planes[0], stripe_bits=bits)
    variants.append(cont.serialize(c))
    for v in variants:
        p = cont.deserialize(v).planes[0]
        _, _, _, bps = recovery._geometry(p, cfg)
        mode, table, run_table = recovery._table(p, cfg)
        status = native.verify_stripes(
            p.stripes, bps, cfg.n2, mode, table, p.vmin,
            np.asarray(p.stripe_bits, np.uint32), run_table=run_table)
        nat = [int(s) for s in np.nonzero(status)[0]]
        assert nat == _python_scan(p, cfg) == recovery.verify(v)
    assert recovery.verify(variants[-1]) == [6]
    assert set(recovery.verify(variants[1])) >= {0}


def test_verify_without_the_native_library(image, monkeypatch):
    cfg = CodecConfig(quality=55, stripe_rows=1)
    bad = _corrupt(_encode(cfg, image), 0, 4)
    want = recovery.verify(bad)
    monkeypatch.setattr(native, "available", lambda: False)
    assert recovery.verify(bad) == want == ref_recovery.verify(bad)
