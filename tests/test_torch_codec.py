"""The port's gray codec end to end against the JAX reference on the CPU:
byte-identical containers, cross-decoding, batched encode_step.

Cross-decoded pixels: equal, except at most 1 apart where the float64
value lies within 1e-3 of a .5 boundary (the two decode products sum in
different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import bitstream as bs

SIZES = {"odd": (61, 97), "even": (72, 136)}

CONFIGS = {
    "static_q50": dict(quality=50, static_tables=True),
    "dynamic_q50": dict(quality=50),
    "static_q90": dict(quality=90, static_tables=True),
    "dynamic_q90": dict(quality=90),
    "adaptive_q50": dict(quality=50, adaptive=True),
    "dc_runs_q50": dict(quality=50, dc_prediction=True, coded_runs=True),
    "all_static_q90": dict(quality=90, static_tables=True, adaptive=True,
                           dc_prediction=True, coded_runs=True),
    "all_dynamic_q50": dict(quality=50, adaptive=True, dc_prediction=True,
                            coded_runs=True),
}


@pytest.fixture(scope="module")
def images():
    return {k: image_io.synthetic_image(h, w, "photo", seed=41)
            for k, (h, w) in SIZES.items()}


def _decoded_close(got, want, data):
    """got/want pixels agree, or differ by at most 1 at decode ties."""
    n_mis, n_bad = testing.decode_mismatches(got, want, data)
    assert n_bad == 0, f"{n_bad} non-tie pixel differences"


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_containers_byte_identical_and_cross_decode(images, size, case):
    cfg = CodecConfig(**CONFIGS[case])
    img = images[size]
    want = ref_codec.encode(img, RefConfig(**CONFIGS[case]))
    got = codec.encode(img, cfg, device="cpu")
    assert got == want
    ref_pixels = ref_codec.decode(want)
    ours = codec.ImageCodec(cfg, device="cpu")
    _decoded_close(ours.decode(want), ref_pixels, want)
    on_dev = ours.decode_to_device(want)
    assert on_dev.device.type == "cpu" and on_dev.dtype == torch.uint8
    np.testing.assert_array_equal(on_dev.numpy(), ours.decode(want))


def test_both_container_versions_are_covered(images):
    """q50 writes v1 (no decode index), q90 writes v2 at these sizes."""
    versions = {codec.encode(images["even"], CodecConfig(quality=q),
                             device="cpu")[4] for q in (50, 90)}
    assert versions == {1, 2}


def test_pallas_reference_path_decodes_to_the_same_pixels(images):
    """The JAX side through kernels A and C in interpret mode."""
    kw = dict(quality=50, use_pallas=True)
    img = images["odd"]
    want = ref_codec.ImageCodec(RefConfig(**kw)).encode(img)
    assert codec.encode(img, CodecConfig(**kw), device="cpu") == want
    ref_pixels = ref_codec.ImageCodec(RefConfig(**kw)).decode(want)
    _decoded_close(codec.decode(want, device="cpu"), ref_pixels, want)


def test_encode_step_frames_equal_single_frames():
    kw = dict(quality=50, static_tables=True, adaptive=True)
    cfg = CodecConfig(**kw)
    frames = np.stack([image_io.synthetic_image(64, 120, "photo", seed=s)
                       for s in range(3)])
    n_stripes = 8
    batch, var_codes, bb = codec.encode_step(torch.from_numpy(frames), cfg,
                                             n_stripes)
    for f in range(3):
        one, vc1, bb1 = codec.encode_step(torch.from_numpy(frames[f]), cfg,
                                          n_stripes)
        a = bs.fetch_packed(one)
        b = bs.fetch_packed(bs.PackedStripes(batch.units[f],
                                             batch.bit_lengths[f]))
        np.testing.assert_array_equal(a.bit_lengths, b.bit_lengths)
        np.testing.assert_array_equal(a.units, b.units[:, :a.units.shape[1]])
        torch.testing.assert_close(vc1, var_codes[f], rtol=0, atol=0)
        torch.testing.assert_close(bb1, bb[f], rtol=0, atol=0)
        ref, _, ref_bb = ref_codec.encode_step(jnp.asarray(frames[f]),
                                               RefConfig(**kw), n_stripes)
        r = bs.fetch_packed(bs.PackedStripes(torch.from_numpy(np.array(
            ref.units).astype(np.int32)), torch.from_numpy(np.array(
                ref.bit_lengths))))
        np.testing.assert_array_equal(a.units, r.units)
        np.testing.assert_array_equal(bb1.numpy(), np.asarray(ref_bb))


def test_image_codec_rejects_a_color_config():
    """As the reference's: ImageCodec is gray, color is ColorImageCodec."""
    for chroma in ("444", "420"):
        with pytest.raises(ValueError, match="ColorImageCodec"):
            codec.ImageCodec(CodecConfig(chroma=chroma), device="cpu")
        with pytest.raises(ValueError, match="ColorImageCodec"):
            ref_codec.ImageCodec(RefConfig(chroma=chroma))


def _rgb(img):
    return np.stack([img, np.roll(img, 3, 0), np.roll(img, 5, 1)], -1)


def test_rgb_dispatch(images):
    """codec.encode of an RGB array encodes color, at 4:2:0 when the
    config says "gray"; codec.decode of a color container gives RGB;
    ImageCodec decodes a color container's luma plane, as the
    reference's does."""
    from dct_tpu_torch.models.color import ColorImageCodec

    rgb = _rgb(images["odd"])
    data = codec.encode(rgb, CodecConfig(quality=50), device="cpu")
    c = codec.cont.deserialize(data)
    assert c.config.chroma == "420"
    assert [(p.height, p.width) for p in c.planes] == [(61, 97)] + [(31, 49)] * 2
    color420 = ColorImageCodec(CodecConfig(quality=50, chroma="420"),
                               device="cpu")
    assert data == color420.encode(rgb)
    data444 = codec.encode(rgb, CodecConfig(quality=50, chroma="444"),
                           device="cpu")
    assert codec.cont.deserialize(data444).config.chroma == "444"
    out = codec.decode(data, device="cpu")
    assert out.shape == (61, 97, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, color420.decode(data))
    luma = codec.ImageCodec(device="cpu").decode(data)
    np.testing.assert_array_equal(luma, ref_codec.ImageCodec().decode(data))
    assert codec.decode(codec.encode(images["odd"], device="cpu"),
                        device="cpu").shape == (61, 97)


@pytest.mark.parametrize("chroma", ("444", "420"))
def test_reference_color_containers_decode(images, chroma):
    """The reference's color containers (v1 and v2) through codec.decode:
    each plane equal to the reference's decode of it but at decode ties,
    the RGB within 1."""
    from dct_tpu.models.color import ColorImageCodec as RefColor

    rgb = _rgb(images["even"])
    for q in (50, 90):
        kw = dict(quality=q, chroma=chroma)
        data = RefColor(RefConfig(**kw)).encode(rgb)
        got = codec.decode(data, device="cpu")
        want = ref_codec.decode(data)
        assert got.shape == want.shape == (72, 136, 3)
        assert int(np.abs(got.astype(int) - want).max()) <= 1
        c = codec.cont.deserialize(data)
        for i, p in enumerate(c.planes):
            mine = codec.decode_plane(p, CodecConfig(**kw), "cpu", chroma=i > 0)
            ref = ref_codec.decode_plane(p, RefConfig(**kw), chroma=i > 0)
            assert testing.decode_mismatches(mine, ref, data, plane=i)[1] == 0


def test_entry_points_without_a_card_raise(images, monkeypatch):
    """With no device named the entry points take the card, and raise
    where there is none; only device="cpu" runs the plain versions."""
    data = codec.encode(images["odd"], CodecConfig(quality=90), device="cpu")
    p = codec.cont.deserialize(data).planes[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: codec.ImageCodec(),
                 lambda: codec.ImageCodec(CodecConfig(quality=90)),
                 lambda: codec.encode(images["odd"]),
                 lambda: codec.decode(data),
                 lambda: codec.encode_plane(images["odd"], CodecConfig()),
                 lambda: codec.decode_plane_device(p, CodecConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert codec.ImageCodec(device="cpu").decode(data).shape == (61, 97)
