"""The port's rate control (dct_tpu_torch.models.rate_control) on the CPU:
size probes byte-exact against the port's own encodes, gray and RGB, v1
and v2, images and stacks; PSNR probes float-identical to the PSNR of the
port's encode and decode; and the encode_to_* fronts choosing the JAX
reference's quality on the same images.

The probes are exact, so every comparison here is equality: sizes in
bytes, PSNR as the same float64.
"""

from __future__ import annotations

import numpy as np
import pytest

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import rate_control as ref_rc
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig
from dct_tpu_torch.models import codec, rate_control as rc, video

DEV = "cpu"


@pytest.fixture(scope="module")
def image():
    return image_io.synthetic_image(56, 88, "photo", seed=3)


@pytest.fixture(scope="module")
def rgb(image):
    return np.stack([image, np.roll(image, 3, 0), np.roll(image, 5, 1)], -1)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    """10 log10(255^2 / mse) in float64, as the reference's metrics.psnr."""
    m = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if m == 0 else float(10.0 * np.log10(255.0 * 255.0
                                                             / m))


GRAY = {
    "static_q50": dict(quality=50, static_tables=True),
    "dynamic_q50": dict(quality=50),
    "dynamic_q90_v2": dict(quality=90, decode_index=True),
    "direct_q35": dict(quality=35, huffman_mode="direct"),
    "none_q50": dict(quality=50, use_huffman=False),
    "adaptive_dc_q50": dict(quality=50, adaptive=True, dc_prediction=True),
    "static_runs_q72": dict(quality=72, coded_runs=True, static_tables=True),
    "n4_q50": dict(quality=50, block_size=4, stripe_rows=2),
    "n16_adaptive_v2": dict(quality=50, block_size=16, adaptive=True,
                            decode_index=True),
    "n2_q60": dict(quality=60, block_size=2),
}


@pytest.mark.parametrize("case", sorted(GRAY))
def test_size_probe_exact_gray(image, case):
    cfg = CodecConfig(**GRAY[case])
    data = codec.encode(image, cfg, DEV)
    assert rc.container_size(image, cfg, DEV) == len(data)
    if "v2" in case:
        assert data[4] == 2


@pytest.mark.parametrize("kw", (
    dict(quality=50, chroma="420", static_tables=True),
    dict(quality=90, chroma="444", decode_index=True),
    dict(quality=60, chroma="420", adaptive=True, coded_runs=True)),
    ids=("420_static", "444_v2", "420_adaptive_runs"))
def test_size_probe_exact_color(rgb, kw):
    cfg = CodecConfig(**kw)
    assert rc.container_size(rgb, cfg, DEV) == len(codec.encode(rgb, cfg, DEV))


@pytest.mark.parametrize("case", ("dynamic_q50", "dynamic_q90_v2"))
def test_size_probe_equals_the_reference(image, case):
    """Where the two packages' containers are equal (gray, these
    configs), so are their probes."""
    assert rc.container_size(image, CodecConfig(**GRAY[case]), DEV) == \
        ref_rc.container_size(image, RefConfig(**GRAY[case]))


@pytest.mark.parametrize("kw", (
    dict(quality=50),
    dict(quality=90, adaptive=True, decode_index=True),
    dict(quality=60, chroma="420"),
    dict(quality=70, chroma="444", static_tables=True)),
    ids=("gray_q50", "gray_adaptive_v2", "rgb_420", "rgb_444_static"))
def test_video_sizes_exact(image, rgb, kw):
    cfg = CodecConfig(**kw)
    src = rgb if cfg.chroma != "gray" else image
    frames = np.stack([src, np.roll(src, 9, 1), np.roll(src, 4, 0)])
    for ck in (None, 2):
        streams = video.VideoCodec(cfg, chunk_frames=ck,
                                   device=DEV).encode(frames)
        sizes = rc.video_container_sizes(frames, cfg, chunk_frames=ck,
                                         device=DEV)
        assert sizes.tolist() == [len(s) for s in streams]


@pytest.mark.parametrize("kw", (
    dict(quality=50),
    dict(quality=90, adaptive=True, dc_prediction=True, coded_runs=True),
    dict(quality=50, block_size=16),
    dict(quality=60, block_size=2),
    dict(quality=55, chroma="420"),
    dict(quality=85, chroma="444", adaptive=True)),
    ids=("gray_q50", "gray_rich_q90", "gray_n16", "gray_n2", "rgb_420",
         "rgb_444_adaptive"))
def test_psnr_probe_equals_a_real_round_trip(image, rgb, kw):
    cfg = CodecConfig(**kw)
    src = rgb if cfg.chroma != "gray" else image
    rec = codec.decode(codec.encode(src, cfg, DEV), DEV)
    assert rc.psnr_at_quality(src, cfg, DEV) == _psnr(rec, src)
    if src.ndim == 2:
        sse = int(((rec.astype(np.int64) - src) ** 2).sum())
        assert rc.roundtrip_sse(src, cfg, DEV) == sse


def test_psnr_probe_of_an_exact_round_trip_is_inf():
    flat = np.full((16, 24), 128, np.uint8)
    assert rc.psnr_at_quality(flat, CodecConfig(quality=100), DEV) == \
        float("inf")


def test_chroma_rules(image, rgb):
    with pytest.raises(ValueError, match="chroma='gray'"):
        rc.container_size(image, CodecConfig(chroma="420"), DEV)
    with pytest.raises(ValueError, match="grayscale"):
        rc.roundtrip_sse(rgb, CodecConfig(), DEV)
    # RGB under a gray config probes (and encodes) at 4:2:0
    assert rc.container_size(rgb, CodecConfig(quality=50), DEV) == \
        len(codec.encode(rgb, CodecConfig(quality=50), DEV))
    with pytest.raises(ValueError, match="empty"):
        rc.encode_to_size(image, 10_000, qualities=(), device=DEV)


LADDER = (30, 50, 70, 90)


def test_encode_to_size_chooses_the_reference_quality(image, rgb):
    for src in (image, rgb):
        sizes = {q: rc.container_size(src, CodecConfig(quality=q), DEV)
                 for q in LADDER}
        budget = (sizes[50] + sizes[70]) // 2
        data, q = rc.encode_to_size(src, budget, qualities=LADDER, device=DEV)
        assert q == 50 and len(data) == sizes[50] <= budget
        _, ref_q = ref_rc.encode_to_size(src, budget, qualities=LADDER)
        assert ref_q == q
    with pytest.raises(ValueError, match="budget"):
        rc.encode_to_size(image, 10, qualities=LADDER, device=DEV)
    data, q = rc.encode_to_size(image, 10, qualities=LADDER, strict=False,
                                device=DEV)
    assert q == 30 and data == codec.encode(image, CodecConfig(quality=30),
                                            DEV)


def test_encode_to_psnr_chooses_the_reference_quality(image):
    psnrs = {q: rc.psnr_at_quality(image, CodecConfig(quality=q), DEV)
             for q in LADDER}
    target = (psnrs[50] + psnrs[70]) / 2
    data, q = rc.encode_to_psnr(image, target, qualities=LADDER, device=DEV)
    assert q == 70
    assert _psnr(codec.decode(data, DEV), image) == psnrs[70] >= target
    _, ref_q = ref_rc.encode_to_psnr(image, target, qualities=LADDER)
    assert ref_q == q
    with pytest.raises(ValueError, match="dB"):
        rc.encode_to_psnr(image, 99.0, qualities=LADDER, device=DEV)


def test_encode_video_to_size_chooses_the_reference_quality(image):
    frames = np.stack([image, np.roll(image, 9, 1), np.roll(image, 4, 0)])
    totals = {q: int(rc.video_container_sizes(
        frames, CodecConfig(quality=q), device=DEV).sum()) for q in LADDER}
    budget = (totals[70] + totals[90]) // 2
    streams, q = rc.encode_video_to_size(frames, budget, qualities=LADDER,
                                         device=DEV)
    assert q == 70 and sum(map(len, streams)) == totals[70] <= budget
    _, ref_q = ref_rc.encode_video_to_size(frames, budget, qualities=LADDER)
    assert ref_q == q
