"""Kernel E's plain version, the direct-mode histogram and the staged
encode path against the JAX reference on the CPU.

The port's chunk packer (ops/bitstream.py pack_chunks, which
ops/pack_cuda.py pack_chunks_kernel runs for CPU tensors) must give the
units and stripe bit lengths of the JAX Pallas packer in interpret mode
(``pack_chunks_pallas``, as tests/test_entropy_stage.py runs it) and of the
JAX scatter packer, bit for bit; the dynamic-table ImageCodec on the CPU
(the analyze pass, then the staged pack kernel E's plain version runs)
must write the JAX ImageCodec's container bytes in every mode. On the
card the same configs run kernel B after the analyze pass, except 2x2
blocks, which keep kernel E.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.ops import bitstream as ref_bs
from dct_tpu.ops import blocks as ref_blocks
from dct_tpu.ops import huffman as ref_hf
from dct_tpu.ops import rle as ref_rle
from dct_tpu.ops import transform as ref_tf
from dct_tpu.ops.pack_pallas import pack_chunks_pallas
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import _build, pack_cuda, rle
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.ops import huffman as hf


@pytest.fixture(scope="module")
def image():
    return image_io.synthetic_image(72, 136, "photo", seed=23)


def _packed_np(p):
    """PackedStripes of either package -> (u16 units, int32 bit lengths)."""
    units = np.asarray(p.units).astype(np.int64) & 0xFFFF
    return units.astype(np.uint16), np.asarray(p.bit_lengths).astype(np.int32)


def _all_packers_agree(cv: np.ndarray, cl: np.ndarray, capacity: int,
                       pallas: bool = True):
    """Pack (S, C, 3) chunks with the port's plain packer, its kernel
    wrapper on CPU tensors, the JAX scatter packer and (within capacity)
    the JAX Pallas packer in interpret mode; all must agree."""
    cv_t, cl_t = torch.from_numpy(cv), torch.from_numpy(cl)
    before = dict(_build.LAUNCHES)
    ours = _packed_np(bs.pack_chunks(cv_t, cl_t, capacity))
    wrapped = _packed_np(pack_cuda.pack_chunks_kernel(cv_t, cl_t, capacity))
    assert _build.LAUNCHES == before  # CPU tensors launch nothing
    cv_j = jnp.asarray(cv.astype(np.uint32))
    cl_j = jnp.asarray(cl.astype(np.int32))
    refs = [ref_bs.pack_chunks(cv_j, cl_j, capacity)]
    if pallas:
        refs.append(pack_chunks_pallas(cv_j, cl_j, capacity))
    for other in [wrapped] + [_packed_np(r) for r in refs]:
        np.testing.assert_array_equal(ours[0], other[0])
        np.testing.assert_array_equal(ours[1], other[1])
    return ours


def _random_chunks(rng, s, c, dead=0.5):
    cl = rng.integers(1, 17, (s, c, 3))
    cl[rng.random((s, c, 3)) < dead] = 0
    cv = rng.integers(0, 1 << 16, (s, c, 3))
    # live values hold no bit above their length; dead ones carry junk
    cv = np.where(cl > 0, cv & ((1 << cl) - 1), cv)
    return cv.astype(np.int32), cl.astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("dead", (0.0, 0.5, 0.95))
def test_plain_pack_matches_jax_on_random_chunks(seed, dead):
    """Stripes of 900 chunks (four of the JAX kernel's 256-chunk tiles),
    live over uneven lengths, one stripe all dead."""
    rng = np.random.default_rng(seed)
    cv, cl = _random_chunks(rng, 4, 300, dead)
    for s in range(4):
        cl[s, 300 * (s + 1) // 4:] = 0
    cl[1] = 0
    units, bits = _all_packers_agree(cv, cl, 300 * 3)
    assert bits[1] == 0 and not units[1].any()
    np.testing.assert_array_equal(bits, cl.reshape(4, -1).sum(axis=1))


def test_plain_pack_drops_units_past_capacity():
    """A stripe filled exactly to an odd capacity and one past it: the
    units past the capacity are dropped, the bit lengths count them."""
    rng = np.random.default_rng(4)
    cv, cl = _random_chunks(rng, 3, 200)
    cap = 200 * 3 - 7
    cl[0] = 16
    cl[1] = 0
    cl[1].reshape(-1)[:cap] = 16
    cv = np.where(cl > 0, rng.integers(0, 1 << 16, cv.shape), cv)
    units, bits = _all_packers_agree(cv, cl, cap, pallas=False)
    assert units.shape == (3, cap)
    assert bits[0] == 200 * 3 * 16 and bits[1] == cap * 16


def _ref_tables(symbols, mode, quality):
    """The JAX package's per-image table for ``mode`` (direct: from the
    compacted symbols, as its encode_analyze builds it)."""
    if mode == "category":
        return ref_hf.CanonicalTable.from_frequencies(np.asarray(
            ref_hf.category_histogram_masked(symbols.values, symbols.is_sym)))
    if mode == "direct":
        c = ref_rle.compact(symbols)
        return ref_hf.CanonicalTable.from_frequencies(np.asarray(
            ref_hf.value_histogram(c.values, c.counts, ref_codec.DIRECT_VMIN,
                                   -ref_codec.DIRECT_VMIN)))
    return None


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("mode", ("category", "direct", "none"))
@pytest.mark.parametrize("coded_runs", (False, True))
def test_plain_pack_matches_jax_on_symbol_chunks(image, n, mode, coded_runs):
    """Real symbol chunks of both packages (equal), packed by every
    packer: stripes of 816 to 3,264 chunks."""
    quality = 60
    ref_cfg = RefConfig(block_size=n, quality=quality, coded_runs=coded_runs,
                        huffman_mode=mode if mode != "none" else "category",
                        use_huffman=mode != "none")
    zz = np.array(ref_tf.encode_blocks(
        ref_blocks.image_to_blocks(jnp.asarray(image), n), ref_cfg))
    want = ref_rle.rle_encode_positional(jnp.asarray(zz))
    got = rle.rle_encode_positional(torch.from_numpy(zz))
    table = _ref_tables(want, mode, quality)
    run_table = ref_hf.default_run_table(quality) if coded_runs else None
    lengths, codes = ref_codec._table_arrays(table)
    rl, rc = (ref_codec._table_arrays(run_table) if coded_runs
              else (None, None))
    cv_ref, cl_ref = ref_codec.symbol_chunks_for(want, ref_cfg, lengths, codes,
                                                 rl, rc)
    cfg = CodecConfig(block_size=n, quality=quality, coded_runs=coded_runs,
                      huffman_mode=ref_cfg.huffman_mode,
                      use_huffman=ref_cfg.use_huffman)
    ops = codec.tables.build(cfg).with_tables(
        None if table is None else hf.CanonicalTable(table.lengths),
        None if run_table is None else hf.CanonicalTable(run_table.lengths))
    n_stripes = image.shape[0] // n
    cv, cl, capacity, block_bits = codec._stripe_chunks(got, cfg, n_stripes,
                                                        ops)
    assert cv.dtype == cl.dtype == torch.int32  # the dtype kernel E takes
    np.testing.assert_array_equal(
        cv.numpy().reshape(-1), np.asarray(cv_ref).astype(np.int64).reshape(-1))
    np.testing.assert_array_equal(cl.numpy().reshape(-1),
                                  np.asarray(cl_ref).reshape(-1))
    units, bits = _all_packers_agree(cv.numpy(), cl.numpy(), capacity)
    np.testing.assert_array_equal(bits, block_bits.sum(dim=1).numpy())
    # the staged pipeline (kernel E's route) and its plain twin agree
    staged, bb = codec.pack_frames(got, cfg, (), n_stripes, ops)
    plain, bb_plain = codec.encode_pack_plain(got, cfg, n_stripes, ops)
    for p in (staged, plain):
        np.testing.assert_array_equal(_packed_np(p)[0], units)
    np.testing.assert_array_equal(bb.numpy(), bb_plain.numpy())


@pytest.mark.parametrize("quality", (20, 90))
@pytest.mark.parametrize("dc_prediction", (False, True))
def test_value_histogram_masked_matches_reference(image, quality,
                                                  dc_prediction):
    """Direct-mode histogram of positional symbols == the JAX
    value_histogram of the compacted ones (DC prediction and high quality
    push values past 255 into the ESC bin)."""
    ref_cfg = RefConfig(quality=quality)
    zz = ref_tf.encode_blocks(ref_blocks.image_to_blocks(jnp.asarray(image), 8),
                              ref_cfg)
    if dc_prediction:
        zz = ref_codec.dc_predict(zz, image.shape[0] // 8)
    zz = np.array(zz)
    zz[0, 0] = 1000  # an escape in every case
    c = ref_rle.rle_encode(jnp.asarray(zz))
    want = np.asarray(ref_hf.value_histogram(c.values, c.counts, -255, 255))
    sym = rle.rle_encode_positional(torch.from_numpy(zz))
    got = hf.value_histogram_masked(sym.values, sym.is_sym, -255, 255)
    assert got.dtype == torch.int32 and got.shape == (512,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[-1] >= 1


def test_value_histogram_masked_counts_only_live_symbols():
    values = torch.tensor([[-300, -255, 0, 255, 256, 7]])
    live = torch.tensor([[True, True, False, True, True, True]])
    got = hf.value_histogram_masked(values, live, -255, 255)
    want = np.zeros(512, np.int32)
    want[[0, 510, 262]] = 1
    want[511] = 2  # -300 and 256 escape
    np.testing.assert_array_equal(got.numpy(), want)


STAGED_CASES = {
    "direct_q90": dict(quality=90, huffman_mode="direct"),
    "direct_q50_adaptive_runs": dict(quality=50, huffman_mode="direct",
                                     adaptive=True, coded_runs=True),
    "direct_dc_q30": dict(quality=30, huffman_mode="direct",
                          dc_prediction=True),
    "none_q50": dict(quality=50, use_huffman=False),
    "none_runs_adaptive": dict(quality=70, use_huffman=False, coded_runs=True,
                               adaptive=True),
    "n4_category": dict(block_size=4, quality=50),
    "n4_static_runs": dict(block_size=4, quality=50, static_tables=True,
                           coded_runs=True),
    "n2_dc_runs": dict(block_size=2, quality=80, dc_prediction=True,
                       coded_runs=True),
}


@pytest.mark.parametrize("decode_index", (True, False, "auto"))
@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_staged_image_path_matches_reference(image, case, decode_index):
    kw = dict(STAGED_CASES[case], decode_index=decode_index)
    cfg = CodecConfig(**kw)
    assert codec.fused_kernel_ok(cfg) == (cfg.block_size != 2)
    want = ref_codec.ImageCodec(RefConfig(**kw)).encode(image)
    got = codec.ImageCodec(cfg, device="cpu").encode(image)
    assert got == want
    if decode_index is not True:
        return
    n_mis, n_bad = testing.decode_mismatches(
        codec.ImageCodec(cfg, device="cpu").decode(want),
        ref_codec.ImageCodec(RefConfig(**kw)).decode(want), want)
    assert n_bad == 0


@pytest.mark.parametrize("case", ("n4_static_runs",))
def test_staged_encode_step_matches_reference(case):
    """Static tables at 4x4 blocks with coded runs: encode_step over a
    frame stack (kernel B's route, its plain version on the CPU), frame by
    frame equal to the JAX encode_step."""
    kw = STAGED_CASES[case]
    cfg = CodecConfig(**kw)
    frames = np.stack([image_io.synthetic_image(32, 48, "photo", seed=s)
                       for s in range(3)])
    n_stripes = 32 // cfg.block_size
    batch, _, bb = codec.encode_step(torch.from_numpy(frames), cfg, n_stripes)
    for f in range(3):
        ref, _, ref_bb = ref_codec.encode_step(jnp.asarray(frames[f]),
                                               RefConfig(**kw), n_stripes)
        got = _packed_np(bs.PackedStripes(batch.units[f], batch.bit_lengths[f]))
        np.testing.assert_array_equal(got[0], _packed_np(ref)[0])
        np.testing.assert_array_equal(got[1], _packed_np(ref)[1])
        np.testing.assert_array_equal(bb[f].numpy(), np.asarray(ref_bb))
