"""The float32 chains kernels A and C promise (dct_tpu_torch.testing
encode_fma_chain / decode_fma_chain) against the JAX reference and the
plain versions on the CPU, and the codec's dispatch of the block
transforms: kernel A for n2 in {4, 16, 64, 256} (at 256 the chain of
kernel B's 16x16 path, the reference's K = 128 split), kernel C for n2 in
{4, 16, 64}, the plain float32 product for 16x16 decode.

Tolerances. The chains sum the same exact products in another order than
the reference's matrix products, so their integers may differ at ties only:
at most 1 apart, where the float64 value lies within 1e-6 (encode,
tests/test_parity.py's criterion) or 1e-3 (decode) of a .5 boundary.
Containers are held byte-identical to the reference, ties excepted by the
same encode criterion; decoded pixels by the decode criterion.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.models.video import VideoCodec as RefVideoCodec
from dct_tpu.ops import blocks as ref_blocks
from dct_tpu.ops import quant as ref_quant
from dct_tpu.ops import transform as ref_tf
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig, tables, testing
from dct_tpu_torch.models import codec, video
from dct_tpu_torch.ops import _build, transform, transform_cuda


@pytest.fixture(scope="module")
def image():
    return image_io.synthetic_image(72, 136, "photo", seed=21)


def _reference_case(image, n, adaptive, quality):
    """(cfg, ops, px, scale as a tensor or None, reference cfg, reference
    scale) for the image's n x n blocks."""
    kw = dict(block_size=n, quality=quality, adaptive=adaptive)
    cfg, ref_cfg = CodecConfig(**kw), RefConfig(**kw)
    px = np.array(ref_blocks.image_to_blocks(jnp.asarray(image), n))
    scale = scale_t = None
    if adaptive:
        scale = ref_quant.scale_from_variance_code(ref_quant.variance_code(
            ref_quant.block_variance_flat(ref_tf.level_shift(jnp.asarray(px)))))
        scale_t = torch.from_numpy(np.array(scale))
    return cfg, tables.build(cfg), px, scale_t, ref_cfg, scale


def _ties_only(got, want, values, tol):
    n_mis, n_bad = testing.tie_mismatches(got, want, values, tol)
    assert n_bad == 0 and n_mis <= np.asarray(want).size // 1000


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("adaptive", (False, True))
@pytest.mark.parametrize("quality", (10, 50, 90))
def test_encode_fma_chain_matches_reference(image, n, adaptive, quality):
    cfg, ops, px, scale_t, ref_cfg, scale = _reference_case(
        image, n, adaptive, quality)
    recip = None if scale_t is None else transform.reciprocal_scale(scale_t)
    got = testing.encode_fma_chain(torch.from_numpy(px), cfg, ops, recip)
    assert got.dtype == torch.int32 and got.shape == px.shape
    vals = testing.encode_values_f64(
        px, cfg, None if recip is None else recip.numpy())
    want = np.array(ref_tf.encode_blocks(jnp.asarray(px), ref_cfg,
                                           adaptive_scale=scale))
    _ties_only(got, want, vals, testing.ENCODE_TIE_TOL)
    plain = transform.encode_blocks(torch.from_numpy(px), cfg, ops, scale_t)
    _ties_only(got, plain, vals, testing.ENCODE_TIE_TOL)


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("adaptive", (False, True))
@pytest.mark.parametrize("quality", (10, 50, 90))
def test_decode_fma_chain_matches_reference(image, n, adaptive, quality):
    cfg, ops, px, scale_t, ref_cfg, scale = _reference_case(
        image, n, adaptive, quality)
    zz = np.array(ref_tf.encode_blocks(jnp.asarray(px), ref_cfg,
                                         adaptive_scale=scale))
    got = testing.decode_fma_chain(torch.from_numpy(zz), cfg, ops, scale_t)
    assert got.dtype == torch.uint8 and got.shape == zz.shape
    vals = testing.decode_values_f64(
        zz, cfg, None if scale_t is None else scale_t.numpy())
    want = np.array(ref_tf.decode_blocks(jnp.asarray(zz), ref_cfg,
                                           adaptive_scale=scale))
    _ties_only(got, want, vals, testing.DECODE_TIE_TOL)
    plain = transform.decode_blocks(torch.from_numpy(zz), cfg, ops, scale_t)
    _ties_only(got, plain, vals, testing.DECODE_TIE_TOL)


@pytest.mark.parametrize("adaptive", (False, True))
@pytest.mark.parametrize("quality", (10, 50, 90))
def test_encode_fma_chain_256_matches_reference(image, adaptive, quality):
    """The n2 = 256 chain (lo and hi halves of each part, t_i = lo_i +
    hi_i, ((t_0 + t_1) + t_2) + b) against the JAX 16x16 encode, whose
    explicit K = 128 dots keep the same association: ties only."""
    cfg, ops, px, scale_t, ref_cfg, scale = _reference_case(
        image[:64, :128], 16, adaptive, quality)
    recip = None if scale_t is None else transform.reciprocal_scale(scale_t)
    got = testing.encode_fma_chain(torch.from_numpy(px), cfg, ops, recip)
    assert got.dtype == torch.int32 and got.shape == px.shape == (32, 256)
    vals = testing.encode_values_f64(
        px, cfg, None if recip is None else recip.numpy())
    want = np.array(ref_tf.encode_blocks(jnp.asarray(px), ref_cfg,
                                           adaptive_scale=scale))
    _ties_only(got, want, vals, testing.ENCODE_TIE_TOL)
    plain = transform.encode_blocks(torch.from_numpy(px), cfg, ops, scale_t)
    _ties_only(got, plain, vals, testing.ENCODE_TIE_TOL)


def test_fma_chains_take_int16_and_leading_axes(image):
    """The kernels' input types: int16 coefficients decode as int32 ones."""
    cfg = CodecConfig(quality=50)
    ops = tables.build(cfg)
    px = torch.from_numpy(np.array(ref_blocks.image_to_blocks(
        jnp.asarray(image), 8)))
    zz = testing.encode_fma_chain(px, cfg, ops)
    torch.testing.assert_close(
        testing.decode_fma_chain(zz.to(torch.int16), cfg, ops),
        testing.decode_fma_chain(zz, cfg, ops), rtol=0, atol=0)


@pytest.fixture
def kernels_refused(monkeypatch):
    """Kernel C's wrapper, raising if called at all: 16x16 decode takes
    the float32 product. (16x16 encode calls kernel A's wrapper, which
    runs its plain version on the CPU.)"""
    def refuse(*args, **kwargs):
        raise AssertionError("the decode kernel wrapper was called")

    monkeypatch.setattr(transform_cuda, "decode_blocks_kernel", refuse)


CASES_16 = {
    "v1_q50": dict(block_size=16, quality=50, decode_index=False),
    "v2_q90_index": dict(block_size=16, quality=90, decode_index=True),
    "v1_adaptive_dc_q60": dict(block_size=16, quality=60, adaptive=True,
                               dc_prediction=True, decode_index=False),
}


@pytest.mark.parametrize("case", sorted(CASES_16))
def test_16x16_codec_takes_the_float32_route(image, kernels_refused, case):
    kw = CASES_16[case]
    data = codec.ImageCodec(CodecConfig(**kw), device="cpu").encode(image)
    want = ref_codec.encode(image, RefConfig(**kw))
    assert data[4] == (2 if kw.get("decode_index") else 1)
    if data != want:
        assert testing.encode_mismatches(data, want, image)[1] == 0
    rec = codec.ImageCodec(CodecConfig(**kw), device="cpu").decode(want)
    n_mis, n_bad = testing.decode_mismatches(rec, ref_codec.decode(want), want)
    assert n_bad == 0


def test_16x16_video_takes_the_float32_route(kernels_refused):
    kw = dict(block_size=16, quality=50)
    frames = np.stack([image_io.synthetic_image(48, 64, "photo", seed=s)
                       for s in range(2)])
    streams = video.VideoCodec(CodecConfig(**kw), device="cpu").encode(frames)
    want = RefVideoCodec(RefConfig(**kw)).encode(frames)
    for f in range(2):
        if streams[f] != want[f]:
            assert testing.encode_mismatches(streams[f], want[f],
                                             frames[f])[1] == 0
    rec = video.VideoCodec(CodecConfig(**kw), device="cpu").decode(want)
    ref = RefVideoCodec(RefConfig(**kw)).decode(want)
    for f in range(2):
        assert testing.decode_mismatches(rec[f], ref[f], want[f])[1] == 0


@pytest.mark.parametrize("n", (2, 4, 8, 16))
def test_transform_dispatch(image, monkeypatch, n):
    """codec.encode_transform / decode_transform call kernel A for n2 in
    ENCODE_N2 (16x16 included) and kernel C for n2 in DECODE_N2 (never
    for 16x16 blocks), and count nothing themselves."""
    calls = []
    for name in ("encode_blocks_kernel", "decode_blocks_kernel"):
        real = getattr(transform_cuda, name)
        monkeypatch.setattr(transform_cuda, name,
                            lambda *a, _r=real, _n=name: calls.append(_n)
                            or _r(*a))
    cfg = CodecConfig(block_size=n)
    ops = tables.build(cfg)
    px = codec.blk.image_to_blocks(torch.from_numpy(image[:64, :128]), n)
    before = dict(_build.LAUNCHES)
    zz = codec.encode_transform(px, cfg, ops)
    rec = codec.decode_transform(zz, cfg, ops)
    assert _build.LAUNCHES == before
    assert cfg.n2 in transform_cuda.ENCODE_N2
    assert calls == (["encode_blocks_kernel", "decode_blocks_kernel"]
                     if cfg.n2 in transform_cuda.DECODE_N2
                     else ["encode_blocks_kernel"])
    torch.testing.assert_close(zz, transform.encode_blocks(px, cfg, ops),
                               rtol=0, atol=0)
    torch.testing.assert_close(rec, transform.decode_blocks(zz, cfg, ops),
                               rtol=0, atol=0)


def test_full_float32_restores_the_callers_switch():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            with transform.full_float32():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is flag
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(ZeroDivisionError):
            with transform.full_float32():
                1 / 0
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
