"""The port's operator bundle against the reference's numpy operators.

The bf16 split is built with torch.bfloat16 instead of ml_dtypes; it must
be bit-identical to dct_tpu.tables.fused_encode_operator_split, and the
bundle ``from_numpy`` makes of the reference's arrays must equal the one
the port builds itself.
"""

import numpy as np
import pytest

from dct_tpu import tables as ref_tables
from dct_tpu.config import CodecConfig
from dct_tpu.ops import huffman as ref_hf
from dct_tpu.ops import transform as ref_tf
from dct_tpu_torch import tables


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("quality", (1, 50, 90, 100))
@pytest.mark.parametrize("n", (4, 8, 16))
@pytest.mark.parametrize("chroma", (False, True))
def test_split_is_bit_identical(quality, n, chroma):
    cfg = CodecConfig(block_size=n, quality=quality)
    want = ref_tables.fused_encode_operator_split(cfg, chroma=chroma)
    got = tables.encode_operator_split(cfg, chroma=chroma)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("quality", (50, 90))
@pytest.mark.parametrize("coded_runs", (False, True))
def test_from_numpy_equals_port_build(n, quality, coded_runs):
    cfg = CodecConfig(block_size=n, quality=quality, coded_runs=coded_runs)
    m0, m1, m2, b = ref_tf.packed_encode_operator_split(cfg)
    m_dec, bias_dec = ref_tf.packed_decode_operator(cfg)
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
    cfg = CodecConfig(block_size=n, quality=50)
    own = tables.build(cfg)
    m0, _, _, b = ref_tables.fused_encode_operator_split(cfg)
    m_dec, _ = ref_tables.fused_decode_operator(cfg)
    np.testing.assert_array_equal(_bits(own.m0.numpy()), _bits(m0))
    np.testing.assert_array_equal(_bits(own.bias.numpy()[0]), _bits(b))
    np.testing.assert_array_equal(_bits(own.m_dec.numpy()), _bits(m_dec))
    np.testing.assert_array_equal(own.ac_mask.numpy()[0],
                                  ref_tables.adaptive_scale_mask(cfg))
