"""The port's tables and operator bundle against the reference's numpy
operators.

The port keeps its own copy of the float64 builders; they must be
bit-identical to dct_tpu.tables'. The bf16 split is built with
torch.bfloat16 instead of ml_dtypes; it must be bit-identical to
dct_tpu.tables.fused_encode_operator_split, and the bundle ``from_numpy``
makes of the reference's arrays must equal the one the port builds itself.
"""

import dataclasses

import numpy as np
import pytest

from dct_tpu import tables as ref_tables
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.ops import huffman as ref_hf
from dct_tpu.ops import transform as ref_tf
from dct_tpu_torch import CodecConfig, tables


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("quality", (1, 50, 90, 100))
@pytest.mark.parametrize("n", (4, 8, 16))
@pytest.mark.parametrize("chroma", (False, True))
def test_split_is_bit_identical(quality, n, chroma):
    kw = dict(block_size=n, quality=quality)
    want = ref_tables.fused_encode_operator_split(RefConfig(**kw),
                                                  chroma=chroma)
    got = tables.encode_operator_split(CodecConfig(**kw), chroma=chroma)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("quality", (50, 90))
@pytest.mark.parametrize("coded_runs", (False, True))
def test_from_numpy_equals_port_build(n, quality, coded_runs):
    kw = dict(block_size=n, quality=quality, coded_runs=coded_runs)
    cfg, ref_cfg = CodecConfig(**kw), RefConfig(**kw)
    m0, m1, m2, b = ref_tf.packed_encode_operator_split(ref_cfg)
    m_dec, bias_dec = ref_tf.packed_decode_operator(ref_cfg)
    cat = ref_hf.default_category_table(quality)
    run = ref_hf.default_run_table(quality) if coded_runs else None
    got = tables.from_numpy(
        m0, m1, m2, b, m_dec, cat.lengths, cat.codes,
        None if run is None else run.lengths,
        None if run is None else run.codes, n2=cfg.n2,
    )
    own = tables.build(cfg)
    assert bias_dec == 128.0
    for field in ("m0", "m1", "m2", "bias", "m_dec", "ac_mask",
                  "cat_lengths", "cat_codes", "run_lengths", "run_codes"):
        a, b_ = getattr(got, field), getattr(own, field)
        if a is None or b_ is None:
            assert a is None and b_ is None, field
            continue
        assert a.dtype == b_.dtype and a.shape == b_.shape, field
        np.testing.assert_array_equal(a.numpy().view(np.uint32)
                                      if a.is_floating_point() else a.numpy(),
                                      b_.numpy().view(np.uint32)
                                      if b_.is_floating_point() else b_.numpy())
    np.testing.assert_array_equal(own.ac_mask.numpy(),
                                  ref_tf.packed_ac_mask(cfg.n2))


@pytest.mark.parametrize("n", (3, 16))
def test_unpacked_block_sizes_keep_the_plain_operator(n):
    own = tables.build(CodecConfig(block_size=n, quality=50))
    ref_cfg = RefConfig(block_size=n, quality=50)
    m0, _, _, b = ref_tables.fused_encode_operator_split(ref_cfg)
    m_dec, _ = ref_tables.fused_decode_operator(ref_cfg)
    np.testing.assert_array_equal(_bits(own.m0.numpy()), _bits(m0))
    np.testing.assert_array_equal(_bits(own.bias.numpy()[0]), _bits(b))
    np.testing.assert_array_equal(_bits(own.m_dec.numpy()), _bits(m_dec))
    np.testing.assert_array_equal(own.ac_mask.numpy()[0],
                                  ref_tables.adaptive_scale_mask(ref_cfg))


@pytest.mark.parametrize("n", (2, 3, 4, 8, 16))
def test_basis_quant_and_zigzag_copies_are_identical(n):
    np.testing.assert_array_equal(tables.dct_basis(n), ref_tables.dct_basis(n))
    np.testing.assert_array_equal(tables.zigzag_permutation(n),
                                  ref_tables.zigzag_permutation(n))
    np.testing.assert_array_equal(tables.inverse_zigzag_permutation(n),
                                  ref_tables.inverse_zigzag_permutation(n))
    for q in (0, 1, 25, 50, 90, 100, 120):
        assert tables.quality_scale_factor(q) == \
            ref_tables.quality_scale_factor(q)
        for chroma in (False, True):
            np.testing.assert_array_equal(
                tables.quant_matrix(n, q, chroma=chroma),
                ref_tables.quant_matrix(n, q, chroma=chroma))


@pytest.mark.parametrize("kw", (
    dict(), dict(block_size=4, quality=90), dict(block_size=16, quality=10),
    dict(adaptive=True, compat_b1=True), dict(compat_b1=True),
    dict(block_size=3, dtype="float64")))
@pytest.mark.parametrize("chroma", (False, True))
def test_fused_operator_copies_are_identical(kw, chroma):
    cfg, ref_cfg = CodecConfig(**kw), RefConfig(**kw)
    for ours, ref in ((tables.fused_encode_operator(cfg, chroma=chroma),
                       ref_tables.fused_encode_operator(ref_cfg, chroma=chroma)),
                      (tables.fused_decode_operator(cfg, chroma=chroma),
                       ref_tables.fused_decode_operator(ref_cfg,
                                                        chroma=chroma))):
        for a, b in zip(ours, ref):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tables.adaptive_scale_mask(cfg),
                                  ref_tables.adaptive_scale_mask(ref_cfg))


def test_config_copy_validates_like_the_reference():
    for kw in (dict(block_size=1), dict(decode_index="sometimes"),
               dict(coded_runs=True, block_size=16)):
        with pytest.raises(ValueError):
            RefConfig(**kw)
        with pytest.raises(ValueError):
            CodecConfig(**kw)
    for q in (-5, 0, 50, 101, 300):
        assert CodecConfig(quality=q).quality == RefConfig(quality=q).quality
    assert ([(f.name, f.default) for f in dataclasses.fields(CodecConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(RefConfig)])
