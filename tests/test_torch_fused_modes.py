"""Kernel B's plain version (ops/fused_encode_cuda.py encode_stripes_plain,
and the wrapper on CPU tensors) against the JAX kernel
(dct_tpu.ops.fused_encode_pallas.encode_stripes_fused, in interpret mode on
the CPU, as the JAX package's own tests run it), at the configs kernel B
takes: n2 16, 64 and 256 in the category, direct and "none" modes;
adaptive quantization + DC prediction + coded runs at n2 16 and 64; and
stripes of 300 blocks. Stripes of 17 blocks, as in
tests/test_fused_encode.py, cut from a synthetic photo; the tables are
canonical tables of the blocks' own histograms (+1 smoothing), handed to
both packages.

Tolerance: units, stripe bits and block bits bit-exact. The two
transforms sum the same exact float32 products in different orders
(torch's product against XLA's), so where the streams differ, every
differing coefficient must be a tie — at most 1 apart, its float64 value
within 1e-6 of a .5 boundary (testing.encode_values_f64) — and the test
decodes both streams to show it. Each JAX config compiles anew in
interpret mode (~15 s on the CPU).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.ops import fused_encode_pallas as ref_fused
from dct_tpu_torch import CodecConfig, tables, testing
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import _build, blocks, bitstream as bs
from dct_tpu_torch.ops import fused_encode_cuda, rle, transform
from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.utils import image_io

RICH = dict(adaptive=True, dc_prediction=True, coded_runs=True)

# name -> (block size, mode, other config fields, stripes, blocks a stripe)
CASES = {
    **{f"n{b}_{m}": (b, m, {}, 3, 17)
       for b in (4, 8, 16) for m in ("category", "direct", "none")},
    "n4_category_rich": (4, "category", RICH, 3, 17),
    "n8_direct_rich": (8, "direct", RICH, 3, 17),
    "n8_category_dc_300": (8, "category", dict(dc_prediction=True), 2, 300),
}


def _config(case: str) -> dict:
    block, mode, extra, _, _ = CASES[case]
    return dict(block_size=block, quality=75, use_huffman=mode != "none",
                huffman_mode=mode if mode != "none" else "category", **extra)


@functools.lru_cache(maxsize=None)
def _inputs(case: str):
    """(cfg, (NB, n2) u8 pixels, scale or None, ops with the case's
    tables, table, run table)."""
    block, mode, _, n_stripes, bps = CASES[case]
    cfg = CodecConfig(**_config(case))
    img = image_io.synthetic_image(n_stripes * block, bps * block, "photo",
                                   seed=block + bps)
    px = blocks.image_to_blocks(torch.from_numpy(img), block)
    _, scale = codec._adaptive(px, cfg)
    ops = tables.build(cfg)
    zz = transform.encode_blocks(px, cfg, ops, scale)
    if cfg.dc_prediction:
        zz = codec.dc_predict(zz, n_stripes)
    sym = rle.rle_encode_positional(zz)
    table = None
    if mode == "category":
        hist = hf.category_histogram_masked(sym.values, sym.is_sym)
    elif mode == "direct":
        hist = hf.value_histogram_masked(sym.values, sym.is_sym,
                                         codec.DIRECT_VMIN, -codec.DIRECT_VMIN)
    if mode != "none":
        table = hf.CanonicalTable.from_frequencies(hist.numpy() + 1)
    run_table = codec._build_run_table(
        cfg, hf.run_histogram_masked(sym.runs, sym.is_sym).numpy())
    return cfg, px, scale, ops.with_tables(table, run_table), table, run_table


def _jnp_table(t):
    if t is None:
        return jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.uint32)
    return (jnp.asarray(t.lengths, jnp.int32),
            jnp.asarray(t.codes.astype(np.int64), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    """The JAX kernel's (units, stripe bits, block bits) as numpy."""
    cfg, px, scale, _, table, run_table = _inputs(case)
    _, mode, _, n_stripes, _ = CASES[case]
    lengths, codes = _jnp_table(table)
    rl = rc = None
    if run_table is not None:
        rl, rc = _jnp_table(run_table)
    packed, bb = ref_fused.encode_stripes_fused(
        jnp.asarray(px.numpy()), RefConfig(**_config(case)), n_stripes,
        lengths, codes,
        adaptive_scale=None if scale is None else jnp.asarray(scale.numpy()),
        run_lengths=rl, run_codes=rc,
        vmin=codec.DIRECT_VMIN if mode == "direct" else 0,
        return_block_bits=True)
    return (np.asarray(packed.units), np.asarray(packed.bit_lengths),
            np.asarray(bb))


def _coefficients(units, bits, cfg, bps, table, run_table, n_stripes):
    """Host decode of packed stripes -> (NB, n2) coefficients, DC
    prediction undone."""
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    stripes = bs.stripes_to_bytes(bs.PackedStripes(
        np.asarray(units).astype(np.uint16), np.asarray(bits)))
    zz = np.concatenate([bs.unpack_stripe_host(
        s, bps, cfg.n2, mode,
        cat_table=table if mode == "category" else None,
        val_table=table if mode == "direct" else None,
        vmin=codec.DIRECT_VMIN, run_table=run_table) for s in stripes])
    zz = torch.from_numpy(zz)
    if cfg.dc_prediction:
        zz = codec.dc_reconstruct(zz, n_stripes)
    return zz.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_stripe_encode_matches_the_jax_kernel(case):
    cfg, px, scale, ops, table, run_table = _inputs(case)
    _, _, _, n_stripes, bps = CASES[case]
    recip = None if scale is None else transform.reciprocal_scale(scale)
    before = dict(_build.LAUNCHES)
    packed, bb = fused_encode_cuda.encode_stripes_fused(
        px, cfg, n_stripes, ops, adaptive_recip=recip)
    assert _build.LAUNCHES == before  # the CPU runs the plain version
    plain, plain_bb = fused_encode_cuda.encode_stripes_plain(
        px, cfg, n_stripes, ops, adaptive_recip=recip)
    assert torch.equal(packed.units, plain.units)
    assert torch.equal(bb, plain_bb)
    assert packed.units.shape == (
        n_stripes, bps * bs.units_per_block_worst(cfg.n2, cfg.coded_runs))

    units, bits, want_bb = _reference(case)
    got_units = packed.units.numpy() & 0xFFFF
    same = (np.array_equal(got_units, units)
            and np.array_equal(packed.bit_lengths.numpy(), bits)
            and np.array_equal(bb.numpy(), want_bb))
    if not same:  # show that ties, and nothing else, moved the stream
        got = _coefficients(got_units, packed.bit_lengths, cfg, bps, table,
                            run_table, n_stripes)
        want = _coefficients(units, bits, cfg, bps, table, run_table,
                             n_stripes)
        n_mis, n_bad = testing.tie_mismatches(
            got, want, testing.encode_values_f64(
                px.numpy(), cfg, None if recip is None else recip.numpy()),
            testing.ENCODE_TIE_TOL)
        assert n_mis > 0 and n_bad == 0
