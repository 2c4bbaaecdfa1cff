"""The port's entropy stages against the JAX reference, fed the SAME
integer coefficients: RLE, histograms, canonical tables, symbol chunks,
chunk packing, stripe bytes and the host stripe decoder must be bit-exact,
and so must the plain version of kernel B (transform + staged pipeline)
against the reference's encode_pack."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_tpu import native
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.ops import bitstream as ref_bs
from dct_tpu.ops import blocks as ref_blocks
from dct_tpu.ops import huffman as ref_hf
from dct_tpu.ops import rle as ref_rle
from dct_tpu.ops import transform as ref_tf
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig, tables
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.ops import fused_encode_cuda, rle
from dct_tpu_torch.ops import huffman as hf

N_STRIPES = 9  # 72 rows of 8x8 blocks


@pytest.fixture(scope="module")
def image():
    return image_io.synthetic_image(72, 136, "photo", seed=31)


def _coefficients(image, n, quality, dc_prediction=False):
    cfg = RefConfig(block_size=n, quality=quality)
    px = ref_blocks.image_to_blocks(jnp.asarray(image), n)
    zz = ref_tf.encode_blocks(px, cfg)
    if dc_prediction:
        zz = ref_codec.dc_predict(zz, (image.shape[0] // n))
    return np.array(zz)


def _both_symbols(zz):
    return (ref_rle.rle_encode_positional(jnp.asarray(zz)),
            rle.rle_encode_positional(torch.from_numpy(zz)))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n", (4, 8, 16))
@pytest.mark.parametrize("quality", (10, 50, 90))
def test_rle_and_histograms(image, n, quality):
    zz = _coefficients(image, n, quality)
    want, got = _both_symbols(zz)
    for field in ("values", "runs", "is_sym"):
        _eq(getattr(got, field).numpy(), getattr(want, field))
    _eq(got.counts.numpy(), want.counts)
    _eq(hf.category_histogram_masked(got.values, got.is_sym).numpy(),
        ref_hf.category_histogram_masked(want.values, want.is_sym))
    if n <= 8:
        _eq(hf.run_histogram_masked(got.runs, got.is_sym).numpy(),
            ref_hf.run_histogram_masked(want.runs, want.is_sym))


def test_category_coding_matches_reference():
    v = np.arange(-2100, 2100, dtype=np.int32)
    cats = ref_hf.category_of(jnp.asarray(v))
    _eq(hf.category_of(torch.from_numpy(v)).numpy(), cats)
    _eq(hf.category_extra_bits(torch.from_numpy(v),
                               hf.category_of(torch.from_numpy(v))).numpy(),
        np.array(ref_hf.category_extra_bits(jnp.asarray(v), cats)).astype(np.int64))


@pytest.mark.parametrize("quality", (10, 50, 90))
def test_static_tables_match_reference(quality):
    for ours, ref in ((hf.default_category_table(quality),
                       ref_hf.default_category_table(quality)),
                      (hf.default_run_table(quality),
                       ref_hf.default_run_table(quality))):
        _eq(ours.lengths, ref.lengths)
        _eq(ours.codes, ref.codes)


@pytest.mark.parametrize("seed", range(4))
def test_tables_from_frequencies_match_reference(seed):
    rng = np.random.default_rng(seed)
    # geometric tails force the length limiter (JPEG adjust-bits) to run
    for size, max_len in ((16, 16), (65, 8), (512, 16)):
        freqs = (rng.geometric(0.3, size) ** 3) * (rng.random(size) < 0.8)
        ours = hf.CanonicalTable.from_frequencies(freqs, max_len)
        ref = ref_hf.CanonicalTable.from_frequencies(freqs, max_len)
        _eq(ours.lengths, ref.lengths)
        _eq(ours.codes, ref.codes)
        _eq(ours.sorted_symbols, ref.sorted_symbols)


def _direct_table(want):
    c = ref_rle.compact(want)
    hist = ref_hf.value_histogram(c.values, c.counts, ref_codec.DIRECT_VMIN,
                                  -ref_codec.DIRECT_VMIN)
    return ref_hf.CanonicalTable.from_frequencies(np.asarray(hist))


@pytest.mark.parametrize("mode", ("category", "direct", "none"))
@pytest.mark.parametrize("coded_runs", (False, True))
@pytest.mark.parametrize("quality", (50, 90))
def test_chunks_pack_bytes_and_host_decode(image, mode, coded_runs, quality):
    zz = _coefficients(image, 8, quality, dc_prediction=coded_runs)
    want, got = _both_symbols(zz)
    if mode == "category":
        table = ref_hf.CanonicalTable.from_frequencies(np.asarray(
            ref_hf.category_histogram_masked(want.values, want.is_sym)))
    elif mode == "direct":
        table = _direct_table(want)
    else:
        table = None
    run_table = ref_hf.default_run_table(quality) if coded_runs else None
    kw_ref, kw = {}, {}
    if run_table is not None:
        kw_ref = dict(run_lengths=jnp.asarray(run_table.lengths),
                      run_codes=jnp.asarray(run_table.codes))
        kw = dict(run_lengths=torch.from_numpy(run_table.lengths),
                  run_codes=torch.from_numpy(run_table.codes.astype(np.int64)))
    if table is not None:
        key = "cat" if mode == "category" else "val"
        kw_ref.update({f"{key}_lengths": jnp.asarray(table.lengths),
                       f"{key}_codes": jnp.asarray(table.codes)})
        kw.update({f"{key}_lengths": torch.from_numpy(table.lengths),
                   f"{key}_codes": torch.from_numpy(table.codes.astype(np.int64))})
    if mode == "direct":
        kw_ref["vmin"] = kw["vmin"] = ref_codec.DIRECT_VMIN
    cv_ref, cl_ref = ref_bs.symbol_chunks(want, mode, **kw_ref)
    cv, cl = bs.symbol_chunks(got, mode, **kw)
    _eq(cv.numpy(), np.asarray(cv_ref).astype(np.int64))
    _eq(cl.numpy(), cl_ref)

    bps = zz.shape[0] // N_STRIPES
    capacity = bps * bs.units_per_block_worst(64, coded_runs)
    p_ref = ref_bs.fetch_packed(ref_bs.pack_chunks(
        cv_ref.reshape(N_STRIPES, -1, 3), cl_ref.reshape(N_STRIPES, -1, 3),
        capacity))
    p = bs.fetch_packed(bs.pack_chunks(cv.reshape(N_STRIPES, -1, 3),
                                       cl.reshape(N_STRIPES, -1, 3), capacity))
    _eq(p.units, p_ref.units)
    _eq(p.bit_lengths, p_ref.bit_lengths)
    stripes = bs.stripes_to_bytes(p)
    assert stripes == ref_bs.stripes_to_bytes(p_ref)

    ours_t = None if table is None else hf.CanonicalTable(table.lengths)
    ours_rt = None if run_table is None else hf.CanonicalTable(run_table.lengths)
    dec = np.concatenate([
        bs.unpack_stripe_host(
            s, bps, 64, mode,
            cat_table=ours_t if mode == "category" else None,
            val_table=ours_t if mode == "direct" else None,
            vmin=ref_codec.DIRECT_VMIN, run_table=ours_rt,
            expected_bits=int(p.bit_lengths[i]))
        for i, s in enumerate(stripes)])
    _eq(dec, zz)
    if native.available():
        _eq(dec, native.unpack_stripes(stripes, bps, 64, mode, table,
                                       ref_codec.DIRECT_VMIN,
                                       run_table=run_table))


PLAIN_B_CASES = {
    "static_q50": dict(quality=50, static_tables=True),
    "dynamic_q50": dict(quality=50),
    "q90_coded_runs": dict(quality=90, coded_runs=True),
    "q50_dc_prediction": dict(quality=50, dc_prediction=True),
    "q50_adaptive_dc_runs": dict(quality=50, adaptive=True,
                                 dc_prediction=True, coded_runs=True),
    "n4_q50": dict(block_size=4, quality=50),
}


@pytest.mark.parametrize("case", sorted(PLAIN_B_CASES))
def test_plain_stripe_encode_matches_reference_encode_pack(image, case):
    cfg = CodecConfig(**PLAIN_B_CASES[case])
    ref_cfg = RefConfig(**PLAIN_B_CASES[case])
    n = cfg.block_size
    img = jnp.asarray(image)
    n_stripes = image.shape[0] // n
    symbols, var_codes, hist, run_hist = ref_codec.encode_analyze(img, ref_cfg)
    table = ref_codec._build_table(ref_cfg, np.asarray(hist))
    run_table = ref_codec._build_run_table(
        ref_cfg, None if cfg.static_tables else np.asarray(run_hist))
    lengths, codes = ref_codec._table_arrays(table)
    rl, rc = (ref_codec._table_arrays(run_table) if cfg.coded_runs
              else (None, None))
    ref_packed, ref_bb = ref_codec.encode_pack(
        symbols, ref_cfg, n_stripes, lengths, codes, rl, rc,
        return_block_bits=True)

    ops = tables.build(cfg).with_tables(
        hf.CanonicalTable(table.lengths),
        None if run_table is None else hf.CanonicalTable(run_table.lengths))
    px = codec.pad_plane_for_encode(torch.from_numpy(image), cfg)
    pixels = codec.blk.image_to_blocks(px, n)
    _, scale = codec._adaptive(pixels, cfg)
    packed, bb = fused_encode_cuda.encode_stripes_plain(
        pixels, cfg, n_stripes, ops, scale)
    # the fused wrapper takes the plain path for CPU tensors
    packed2, bb2 = fused_encode_cuda.encode_stripes_fused(
        pixels, cfg, n_stripes, ops, scale)
    a, b, r = (bs.fetch_packed(packed), bs.fetch_packed(packed2),
               ref_bs.fetch_packed(ref_packed))
    for p in (a, b):
        _eq(p.units, r.units)
        _eq(p.bit_lengths, r.bit_lengths)
    _eq(bb.numpy(), ref_bb)
    _eq(bb2.numpy(), ref_bb)
    assert packed.units.shape[-1] == ref_packed.units.shape[-1]
    if cfg.adaptive:
        _eq(codec._adaptive(pixels, cfg)[0].numpy(), var_codes)
