"""The port's color codec (dct_tpu_torch.models.color) against the JAX
reference on the CPU: the color conversions, the chroma planes' encode,
ColorImageCodec end to end, and RGB stacks in VideoCodec.

Tolerances. The conversions are float32 in both packages, evaluated in
another order by XLA, so a plane or RGB value may differ from the
reference's by 1 only where the float64 value lies within 1e-4 of a .5
boundary (testing.PLANE_TIE_TOL). Containers encoded from the same planes
are equal byte for byte, or differ only in coefficients whose float64
value lies within 1e-6 of a .5 boundary (testing.ENCODE_TIE_TOL); where
the two packages' planes differ (at ties), so may their containers, and
each is held to the other's planes instead. Decoded RGB: within 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_tpu import container as ref_cont
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.models import color as ref_color
from dct_tpu.models import video as ref_video
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch import container as cont
from dct_tpu_torch.models import codec, color, video
from dct_tpu_torch.ops import _build

SIZES = {"odd": (61, 97), "even": (64, 96)}


def _rgb(img):
    """RGB from a gray image, as tests/test_recovery.py builds it."""
    return np.stack([img, np.roll(img, 3, 0), np.roll(img, 5, 1)], -1)


@pytest.fixture(scope="module")
def rgbs():
    return {(size, kind): _rgb(image_io.synthetic_image(h, w, kind, seed=41))
            for size, (h, w) in SIZES.items() for kind in ("photo", "noise")}


def _ref_planes(rgb, mode):
    return [np.asarray(p) for p in ref_color._to_planes(jnp.asarray(rgb),
                                                        mode)]


def _port_planes(rgb, mode):
    return [p.numpy() for p in color._to_planes(torch.from_numpy(rgb), mode)]


def _same_or_ties(got: bytes, want: bytes, planes):
    """got == want, or every differing coefficient is an encode tie of
    the planes both were encoded from."""
    if got != want:
        n_mis, n_bad = testing.plane_encode_mismatches(got, want, planes)
        assert n_mis > 0 and n_bad == 0, f"{n_bad} non-tie coefficients"


@pytest.mark.parametrize("kind", ("photo", "noise"))
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("mode", ("444", "420"))
def test_planes_differ_from_reference_at_ties_only(rgbs, mode, size, kind):
    rgb = rgbs[size, kind]
    want = _ref_planes(rgb, mode)
    got = _port_planes(rgb, mode)
    values = testing.plane_values_f64(rgb, mode)
    for g, w, v in zip(got, want, values):
        assert g.shape == w.shape == v.shape and g.dtype == np.uint8
        n_mis, n_bad = testing.tie_mismatches(g, w, v, testing.PLANE_TIE_TOL)
        assert n_bad == 0, f"{n_bad} of {n_mis} plane differences not ties"


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("mode", ("444", "420"))
def test_rgb_reconstruction_differs_from_reference_at_ties_only(mode, size):
    h, w = SIZES[size]
    rng = np.random.default_rng(7)
    ch, cw = (h, w) if mode == "444" else (-(-h // 2), -(-w // 2))
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cb, cr = (rng.integers(0, 256, (ch, cw), dtype=np.uint8) for _ in "bc")
    want = np.asarray(ref_color.planes_to_rgb(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), mode, h, w))
    got = color.planes_to_rgb(*(torch.from_numpy(p) for p in (y, cb, cr)),
                              mode, h, w).numpy()
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    n_mis, n_bad = testing.tie_mismatches(
        got, want, testing.rgb_values_f64(y, cb, cr, mode, h, w),
        testing.PLANE_TIE_TOL)
    assert n_bad == 0, f"{n_bad} of {n_mis} RGB differences not ties"
    # ycbcr_to_rgb on the same float planes, as decode_region calls it

    def up(p):
        return np.repeat(np.repeat(p, 2, 0), 2, 1)[:h, :w] if mode == "420" \
            else p

    ycc = np.stack([y, up(cb), up(cr)], -1).astype(np.float32)
    np.testing.assert_array_equal(
        color.ycbcr_to_rgb(torch.from_numpy(ycc)).numpy(), got)


def test_conversions_take_leading_frame_axes(rgbs):
    stack = np.stack([rgbs["odd", "photo"], rgbs["odd", "noise"]])
    for mode in ("444", "420"):
        planes = color._to_planes(torch.from_numpy(stack), mode)
        for f in range(2):
            for p, one in zip(planes, color._to_planes(
                    torch.from_numpy(stack[f]), mode)):
                torch.testing.assert_close(p[f], one, rtol=0, atol=0)
        rgb = color.planes_to_rgb(*planes, mode, 61, 97)
        assert rgb.shape == (2, 61, 97, 3)
        torch.testing.assert_close(
            rgb[1], color.planes_to_rgb(*(p[1] for p in planes), mode, 61,
                                        97), rtol=0, atol=0)


PLANE_CONFIGS = {
    "static_q50": dict(quality=50, static_tables=True),
    "dynamic_q90": dict(quality=90),
    "adaptive_dc_runs_q60": dict(quality=60, adaptive=True,
                                 dc_prediction=True, coded_runs=True),
    "n4_direct_q75": dict(block_size=4, quality=75, huffman_mode="direct"),
    "n16_none": dict(block_size=16, use_huffman=False),
}


@pytest.mark.parametrize("case", sorted(PLANE_CONFIGS))
def test_chroma_planes_encode_as_the_reference(rgbs, case):
    """encode_plane(..., chroma=i > 0) on the reference's own 4:2:0 planes
    against its encode_plane: the same containers, ties excepted."""
    kw = dict(PLANE_CONFIGS[case], chroma="420")
    rgb = rgbs["odd", "photo"]
    planes = _ref_planes(rgb, "420")
    want = ref_cont.serialize(ref_cont.Container(
        config=RefConfig(**kw), width=97, height=61,
        planes=[ref_codec.encode_plane(p, RefConfig(**kw), chroma=i > 0)
                for i, p in enumerate(planes)]))
    cfg = CodecConfig(**kw)
    got = cont.serialize(cont.Container(
        config=cfg, width=97, height=61,
        planes=[codec.encode_plane(p, cfg, "cpu", chroma=i > 0)
                for i, p in enumerate(planes)]))
    _same_or_ties(got, want, planes)
    # 8x8 blocks have a chrominance table of their own (other sizes one
    # formula for every plane): Cb against the luma table differs
    luma = codec.encode_plane(planes[1], cfg, "cpu")
    assert ((luma.stripes != cont.deserialize(got).planes[1].stripes)
            == (cfg.block_size == 8))


CODEC_CONFIGS = {
    "static_q50": dict(quality=50, static_tables=True),
    "dynamic_q90": dict(quality=90),
}


@pytest.mark.parametrize("case", sorted(CODEC_CONFIGS))
@pytest.mark.parametrize("mode", ("444", "420"))
def test_color_codec_end_to_end(rgbs, mode, case):
    """ColorImageCodec against the reference's: each container equals the
    other package's encode of its own planes (ties excepted), and equals
    the reference's container outright where the planes agree; each
    package decodes the other's containers within 1."""
    kw = dict(CODEC_CONFIGS[case], chroma=mode)
    rgb = rgbs["even", "photo"]
    cfg, ref_cfg = CodecConfig(**kw), RefConfig(**kw)
    ours = color.ColorImageCodec(cfg, device="cpu")
    got = ours.encode(rgb)
    want = ref_color.ColorImageCodec(ref_cfg).encode(rgb)
    port_planes = _port_planes(rgb, mode)
    ref_of_ours = ref_cont.serialize(ref_cont.Container(
        config=ref_cfg, width=96, height=64,
        planes=[ref_codec.encode_plane(p, ref_cfg, chroma=i > 0)
                for i, p in enumerate(port_planes)]))
    _same_or_ties(got, ref_of_ours, port_planes)
    if all(np.array_equal(a, b)
           for a, b in zip(port_planes, _ref_planes(rgb, mode))):
        _same_or_ties(got, want, port_planes)
    assert cont.deserialize(got).config.chroma == mode
    for data in (got, want):
        a = ours.decode(data)
        b = ref_color.ColorImageCodec(ref_cfg).decode(data)
        assert a.shape == b.shape == (64, 96, 3) and a.dtype == np.uint8
        assert int(np.abs(a.astype(int) - b).max()) <= 1
        on_dev = ours.decode_to_device(data)
        assert on_dev.device.type == "cpu" and on_dev.dtype == torch.uint8
        np.testing.assert_array_equal(on_dev.numpy(), a)


def test_both_container_versions_are_covered(rgbs):
    """q50 writes v1 color containers, q90 v2 (kernel D's route)."""
    rgb = rgbs["even", "photo"]
    assert {color.ColorImageCodec(CodecConfig(quality=q, chroma="420"),
                                  device="cpu").encode(rgb)[4]
            for q in (50, 90)} == {1, 2}


def test_color_codec_rejects_gray_config_and_input(rgbs):
    with pytest.raises(ValueError, match="444"):
        color.ColorImageCodec(CodecConfig(), device="cpu")
    ours = color.ColorImageCodec(CodecConfig(chroma="444"), device="cpu")
    with pytest.raises(ValueError, match="RGB"):
        ours.encode(rgbs["odd", "photo"][..., 0])


@pytest.fixture(scope="module")
def rgb_frames():
    return np.stack([_rgb(image_io.synthetic_image(48, 64, "photo", seed=s))
                     for s in range(3)])


VIDEO_CASES = {
    "420_dynamic_q60": dict(quality=60, chroma="420"),
    "444_static_adaptive_q50": dict(quality=50, chroma="444",
                                    static_tables=True, adaptive=True),
}


@pytest.mark.parametrize("case", sorted(VIDEO_CASES))
def test_rgb_stack_streams(rgb_frames, case):
    """RGB stacks: the same streams for chunk_frames 1, 2 and None, equal
    to the reference's video encode of the same planes (each plane type
    with its own stack-wide table), and decoded stacks equal to per-frame
    decodes and within 1 of the reference's."""
    kw = VIDEO_CASES[case]
    cfg, ref_cfg = CodecConfig(**kw), RefConfig(**kw)
    streams = {ck: video.VideoCodec(cfg, chunk_frames=ck,
                                    device="cpu").encode(rgb_frames)
               for ck in (None, 1, 2)}
    assert streams[1] == streams[None] and streams[2] == streams[None]
    got = streams[None]
    planes = video.rgb_planes(rgb_frames, kw["chroma"], None, "cpu")
    per_plane = [ref_video._encode_plane_batch(p, ref_cfg, chroma=i > 0,
                                               chunk_frames=None)
                 for i, p in enumerate(planes)]
    for f in range(3):
        want = ref_cont.serialize(ref_cont.Container(
            config=ref_cfg, width=64, height=48,
            planes=[pp[f] for pp in per_plane]))
        _same_or_ties(got[f], want, [p[f] for p in planes])
    ours = video.VideoCodec(cfg, device="cpu")
    rec = ours.decode(got)
    assert rec.shape == (3, 48, 64, 3) and rec.dtype == np.uint8
    single = color.ColorImageCodec(cfg, device="cpu")
    for f in range(3):
        np.testing.assert_array_equal(rec[f], single.decode(got[f]))
    want_rec = ref_video.VideoCodec(ref_cfg).decode(got)
    assert int(np.abs(rec.astype(int) - want_rec).max()) <= 1
    np.testing.assert_array_equal(
        video.VideoCodec(cfg, chunk_frames=2, device="cpu").decode(got), rec)


def test_rgb_stack_of_reference_streams_decodes(rgb_frames):
    """The reference's RGB video streams (v2 at q90) decode through the
    port's batched route within 1 of the reference's decode; a mixed
    batch (one frame of another config) decodes frame by frame."""
    kw = dict(quality=90, chroma="420")
    streams = ref_video.VideoCodec(RefConfig(**kw)).encode(rgb_frames)
    assert {s[4] for s in streams} == {2}
    rec = video.VideoCodec(device="cpu").decode(streams)
    want = ref_video.VideoCodec(RefConfig(**kw)).decode(streams)
    assert int(np.abs(rec.astype(int) - want).max()) <= 1
    mixed = list(streams)
    mixed[1] = ref_color.ColorImageCodec(RefConfig(quality=50, chroma="444")
                                         ).encode(rgb_frames[1])
    got = video.VideoCodec(device="cpu").decode(mixed)
    for f, data in enumerate(mixed):
        np.testing.assert_array_equal(got[f], codec.decode(data, "cpu"))


def test_rgb_stack_shape_checks(rgb_frames):
    with pytest.raises(ValueError, match="RGB"):
        video.VideoCodec(CodecConfig(chroma="420"),
                         device="cpu").encode(rgb_frames[..., 0])
    with pytest.raises(ValueError, match=r"\(F, H, W\)"):
        video.VideoCodec(device="cpu").encode(rgb_frames)


def test_cpu_color_launches_nothing(rgbs, rgb_frames):
    before = dict(_build.LAUNCHES)
    ours = color.ColorImageCodec(CodecConfig(quality=90, chroma="420"),
                                 device="cpu")
    ours.decode(ours.encode(rgbs["odd", "photo"]))
    vc = video.VideoCodec(CodecConfig(chroma="444"), device="cpu")
    vc.decode(vc.encode(rgb_frames))
    assert _build.LAUNCHES == before


def test_entry_points_without_a_card_raise(rgbs, monkeypatch):
    data = codec.encode(rgbs["odd", "photo"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: color.ColorImageCodec(CodecConfig(chroma="420")),
                 lambda: codec.encode(rgbs["odd", "photo"]),
                 lambda: codec.decode(data),
                 lambda: video.VideoCodec(CodecConfig(chroma="444"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
