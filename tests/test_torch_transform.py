"""Plain versions of kernels A and C (dct_tpu_torch.ops.transform) and the
numerics around them (blocks, quant) against the JAX reference on the CPU.

Tolerances. Encode: integers equal, except at exact .5 ties by
tests/test_parity.py's criterion (at most 1 apart, the float64 value within
1e-6 of a .5 boundary, rare). Decode: pixels equal, except at most 1 apart
where the float64 value lies within 1e-3 of a .5 boundary.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.ops import blocks as ref_blocks
from dct_tpu.ops import quant as ref_quant
from dct_tpu.ops import transform as ref_tf
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig, tables, testing
from dct_tpu_torch.ops import blocks, quant, transform


@pytest.fixture(scope="module")
def image():
    return image_io.synthetic_image(72, 136, "photo", seed=21)


@pytest.mark.parametrize("shape", ((61, 97), (72, 136), (2, 61, 97)))
@pytest.mark.parametrize("n", (4, 8, 16))
def test_tiling_matches_reference(shape, n):
    rng = np.random.default_rng(n)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = blocks.image_to_blocks(torch.from_numpy(img), n)
    want = np.array(ref_blocks.image_to_blocks(jnp.asarray(img), n))
    np.testing.assert_array_equal(got.numpy(), want)
    h, w = shape[-2:]
    back = blocks.blocks_to_image(got, h, w, n)
    np.testing.assert_array_equal(back.numpy(), img)


@pytest.mark.parametrize("n", (4, 8, 16))
def test_variance_codes_match_reference(image, n):
    px = np.array(ref_blocks.image_to_blocks(jnp.asarray(image), n))
    want = ref_quant.variance_code(
        ref_quant.block_variance_flat(ref_tf.level_shift(jnp.asarray(px))))
    got = quant.variance_code(
        quant.block_variance_flat(transform.level_shift(torch.from_numpy(px))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        quant.scale_from_variance_code(got).numpy(),
        np.array(ref_quant.scale_from_variance_code(want)))


def test_round_half_away_matches_reference():
    x = np.array([-2.5, -1.5, -0.5, -0.0, 0.0, 0.5, 1.5, 2.5, 0.49999997,
                  -0.49999997, 1e7 + 0.5], np.float32)
    got = transform.round_half_away(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.array(ref_tf.round_half_away(
        jnp.asarray(x))))


@pytest.mark.parametrize("n", (4, 8, 16))
@pytest.mark.parametrize("adaptive", (False, True))
@pytest.mark.parametrize("quality", (10, 50, 90))
def test_plain_transform_matches_reference(image, n, adaptive, quality):
    kw = dict(block_size=n, quality=quality, adaptive=adaptive)
    cfg, ref_cfg = CodecConfig(**kw), RefConfig(**kw)
    px = np.array(ref_blocks.image_to_blocks(jnp.asarray(image), n))
    scale = scale_t = None
    if adaptive:
        scale = ref_quant.scale_from_variance_code(ref_quant.variance_code(
            ref_quant.block_variance_flat(ref_tf.level_shift(jnp.asarray(px)))))
        scale_t = torch.from_numpy(np.array(scale))
    ops = tables.build(cfg)

    want = np.array(ref_tf.encode_blocks(jnp.asarray(px), ref_cfg,
                                           adaptive_scale=scale))
    got = transform.encode_blocks(torch.from_numpy(px), cfg, ops, scale_t)
    assert got.dtype == torch.int32
    recip = None if scale_t is None else transform.reciprocal_scale(scale_t)
    n_mis, n_bad = testing.tie_mismatches(
        got, want, testing.encode_values_f64(px, cfg, recip),
        testing.ENCODE_TIE_TOL)
    assert n_bad == 0 and n_mis <= want.size // 1000

    dwant = np.array(ref_tf.decode_blocks(jnp.asarray(want), ref_cfg,
                                            adaptive_scale=scale))
    dgot = transform.decode_blocks(torch.from_numpy(want), cfg, ops, scale_t)
    assert dgot.dtype == torch.uint8
    n_mis, n_bad = testing.tie_mismatches(
        dgot, dwant,
        testing.decode_values_f64(
            want, cfg, None if scale_t is None else scale_t.numpy()),
        testing.DECODE_TIE_TOL)
    assert n_bad == 0 and n_mis <= dwant.size // 1000


def test_leading_frame_axis_is_a_batch(image):
    cfg = CodecConfig(quality=50)
    ops = tables.build(cfg)
    px = blocks.image_to_blocks(torch.from_numpy(np.stack([image, image[::-1]])), 8)
    both = transform.encode_blocks(px, cfg, ops)
    for f in range(2):
        torch.testing.assert_close(both[f], transform.encode_blocks(px[f], cfg, ops),
                                   rtol=0, atol=0)
    dec = transform.decode_blocks(both, cfg, ops)
    torch.testing.assert_close(dec[1], transform.decode_blocks(both[1], cfg, ops),
                               rtol=0, atol=0)


def test_float64_values_round_to_the_reference_integers(image):
    """encode_values_f64 / decode_values_f64 measure ties: away from .5,
    their rounding is the codec's integer."""
    cfg = CodecConfig(quality=50)
    px = np.array(ref_blocks.image_to_blocks(jnp.asarray(image), 8))
    zz = np.array(ref_tf.encode_blocks(jnp.asarray(px), RefConfig(quality=50)))
    vals = testing.encode_values_f64(px, cfg)
    far = np.abs(np.abs(vals) % 1.0 - 0.5) > 1e-3
    np.testing.assert_array_equal(
        (np.sign(vals) * np.floor(np.abs(vals) + 0.5))[far], zz[far])
    dec = np.array(ref_tf.decode_blocks(jnp.asarray(zz), RefConfig(quality=50)))
    dvals = np.clip(testing.decode_values_f64(zz, cfg), 0, 255)
    dfar = np.abs(dvals % 1.0 - 0.5) > 1e-3
    np.testing.assert_array_equal(np.floor(dvals + 0.5)[dfar], dec[dfar])
