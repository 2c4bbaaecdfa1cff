"""Kernel D's plain version and the port's indexed (v2) decode against the
JAX package on the CPU.

Tolerances: the entropy-decoded coefficients are integers and must be
bit-exact against the JAX package's device decoder (interpret mode on the
CPU) and its host decoder. Decoded pixels may differ from the JAX
package's at decode ties only: at most 1 apart, where the float64 value
lies within 1e-3 of a .5 boundary (the two sum the decode products in
different orders). Kernel D itself is held against the plain version on the
card in tests/test_torch_kernels.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dct_tpu import native as ref_native
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.ops import entropy_decode_pallas as edp
from dct_tpu.ops import huffman as ref_hf
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig, native, testing
from dct_tpu_torch import container as cont
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.ops import entropy_decode as ed
from dct_tpu_torch.ops import entropy_decode_cuda
from dct_tpu_torch.ops import huffman as hf

# (image shape, config) per case; every case writes a v2 container. The
# first six are tests/test_device_decode.py's mode lattice.
CASES = {
    "category": ((40, 72), dict(quality=40)),
    "category_runs_dc_adaptive": ((40, 72), dict(
        quality=40, coded_runs=True, dc_prediction=True, adaptive=True)),
    "direct": ((40, 72), dict(quality=40, huffman_mode="direct")),
    "direct_runs_adaptive": ((40, 72), dict(
        quality=40, huffman_mode="direct", coded_runs=True, adaptive=True)),
    "none_dc": ((40, 72), dict(quality=40, huffman_mode="none",
                               dc_prediction=True)),
    "none_runs": ((40, 72), dict(quality=40, huffman_mode="none",
                                 coded_runs=True)),
    "n4_runs": ((12, 31), dict(block_size=4, quality=40, coded_runs=True)),
    "n16": ((48, 115), dict(block_size=16, quality=40)),
    # 256 blocks per stripe: the JAX kernel's cells past the first 128
    "wide": ((16, 2048), dict(quality=50)),
    # n2 = 4 (2x2 blocks) in both Huffman modes, n2 = 256 without Huffman
    "n2_runs": ((10, 38), dict(block_size=2, quality=40, coded_runs=True)),
    "n2_direct": ((10, 38), dict(block_size=2, quality=40,
                                 huffman_mode="direct")),
    "n16_none": ((32, 70), dict(block_size=16, quality=40,
                                huffman_mode="none")),
}


@functools.lru_cache(maxsize=None)
def _container(case: str) -> bytes:
    """The JAX package's container for a case (direct mode has no encoder
    in the port yet)."""
    shape, kw = CASES[case]
    im = image_io.synthetic_image(*shape, "photo", seed=3)
    return ref_codec.ImageCodec(RefConfig(decode_index=True, **kw)).encode(im)


def _stream(data: bytes):
    """(plane, config, mode, table, run_table) of a container, parsed by
    the port."""
    c = cont.deserialize(data)
    cfg = c.config
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    p = c.planes[0]
    table = hf.CanonicalTable(p.table_lengths) if mode != "none" else None
    run_table = (hf.CanonicalTable(p.run_table_lengths) if cfg.coded_runs
                 else None)
    return p, cfg, mode, table, run_table


def _jax_device_decode(p, cfg, mode):
    """The JAX kernel's coefficients, from the units as its codec lays them
    out (codec._device_decode_prep)."""
    n_stripes = len(p.stripes)
    units = np.zeros((n_stripes, max((len(s) + 1) // 2 for s in p.stripes)),
                     np.int32)
    for s, data in enumerate(p.stripes):
        data = data + b"\x00" * (len(data) % 2)
        units[s, : len(data) // 2] = np.frombuffer(data, ">u2")
    table = (ref_hf.CanonicalTable(p.table_lengths) if mode != "none"
             else None)
    run_table = (ref_hf.CanonicalTable(p.run_table_lengths) if cfg.coded_runs
                 else None)
    zz = edp.decode_stripes_device(
        units, p.block_bits.reshape(n_stripes, -1), n_stripes, cfg.n2, mode,
        table, vmin=codec.DIRECT_VMIN, run_table=run_table,
        run_bits=bs.run_field_bits(cfg.n2))
    return np.asarray(zz), table, run_table


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_host_decoders(case):
    p, cfg, mode, table, run_table = _stream(_container(case))
    assert p.block_bits is not None
    ops = codec.indexed_operands(p.stripes, p.block_bits, table, run_table,
                                   mode, cfg.n2, "cpu")
    # the stripe starts from the stripe byte lengths are the index's own
    stripe_bits = (ops["block_bits"].to(torch.int64) & 0xFFFF).sum(dim=1)
    np.testing.assert_array_equal(
        ops["stripe_start"].numpy(),
        ed.stripe_starts(-(-stripe_bits.numpy() // 8)))
    got = ed.decode_blocks_plain(**ops)
    assert got.dtype == torch.int16 and got.shape == (p.block_bits.size,
                                                      cfg.n2)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        entropy_decode_cuda.decode_blocks_kernel(**ops).numpy(), got.numpy())

    want, ref_table, ref_run_table = _jax_device_decode(p, cfg, mode)
    np.testing.assert_array_equal(got.numpy(), want)
    bps = p.block_bits.size // len(p.stripes)
    host = ref_native.unpack_stripes(p.stripes, bps, cfg.n2, mode, ref_table,
                                     codec.DIRECT_VMIN, run_table=ref_run_table)
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(
        native.unpack_stripes(p.stripes, bps, cfg.n2, mode, table,
                              codec.DIRECT_VMIN, run_table=run_table), host)


@pytest.mark.parametrize("case", ("category_runs_dc_adaptive",
                                  "direct_runs_adaptive", "none_dc", "wide"))
def test_decode_to_device_matches_jax_device_decode(monkeypatch, case):
    data = _container(case)
    kw = CASES[case][1]
    monkeypatch.setattr(ref_codec, "_FORCE_DEVICE_DECODE", True)
    want = np.asarray(ref_codec.ImageCodec(
        RefConfig(use_pallas=True, decode_index=True, **kw)).decode_to_device(
            data))
    ours = codec.ImageCodec(CodecConfig(decode_index=True, **kw), device="cpu")
    got = ours.decode_to_device(data)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    n_mis, n_bad = testing.decode_mismatches(got.numpy(), want, data)
    assert n_bad == 0 and n_mis <= want.size // 1000
    np.testing.assert_array_equal(ours.decode(data), got.numpy())


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_routing_by_index_and_tables(monkeypatch):
    """v2 containers decode through kernel D's wrapper, v1 containers and
    tables kernel D cannot hold through the host decoder, to the same
    pixels."""
    d_calls = _count_calls(monkeypatch, entropy_decode_cuda,
                           "decode_blocks_kernel")
    host_calls = _count_calls(monkeypatch, codec, "_decode_stripes")
    im = image_io.synthetic_image(40, 72, "photo", seed=5)
    cfg = CodecConfig(quality=60, coded_runs=True)
    ours = codec.ImageCodec(cfg, device="cpu")
    v2 = codec.ImageCodec(cfg.replace(decode_index=True), device="cpu").encode(im)
    v1 = codec.ImageCodec(cfg.replace(decode_index=False), device="cpu").encode(im)
    assert (v2[4], v1[4]) == (2, 1)
    indexed = ours.decode(v2)
    assert (len(d_calls), len(host_calls)) == (1, 0)
    np.testing.assert_array_equal(ours.decode(v1), indexed)
    assert (len(d_calls), len(host_calls)) == (1, 1)
    monkeypatch.setattr(ed, "tables_supported", lambda *a: False)
    np.testing.assert_array_equal(ours.decode(v2), indexed)
    assert (len(d_calls), len(host_calls)) == (1, 2)


def test_long_codes_take_the_host_decoder():
    lengths = np.zeros(32, np.int32)
    lengths[:3] = [1, 17, 2]  # a 17-bit code
    t, ref_t = hf.CanonicalTable(lengths), ref_hf.CanonicalTable(lengths)
    assert not ed.tables_supported(t, None)
    assert not edp.tables_supported(ref_t, None)
    assert not ed.tables_supported(None, t)
    p = cont.PlaneData(width=8, height=8, table_lengths=lengths, vmin=0,
                       variance_codes=None, stripe_bits=np.zeros(1, np.uint32),
                       stripes=[b""], block_bits=np.zeros(1, np.uint16))
    assert not codec.indexed_decode_ok(p, CodecConfig(), t, None)
    assert codec.indexed_decode_ok(p, CodecConfig(),
                                   hf.default_category_table(50), None)
    # direct values outside int16, as the JAX package decides
    wide = hf.CanonicalTable(np.full(8, 3, np.int32))
    for vmin in (-0x8001, -0x8000, 0x7FF9, 0x7FFA):
        assert ed.tables_supported(wide, None, vmin) == edp.tables_supported(
            ref_hf.CanonicalTable(wide.lengths), None, vmin)


@pytest.mark.parametrize("case", ("category_runs_dc_adaptive",
                                  "direct_runs_adaptive", "none_runs"))
def test_table_inputs_match_the_jax_kernels_tables(case):
    p, cfg, mode, table, run_table = _stream(_container(case))
    got = ed.table_inputs(table, run_table, mode, codec.DIRECT_VMIN)
    fields = {}
    o = 0
    for name, n in ed.TABLE_FIELDS:
        fields[name] = got[o:o + n]
        o += n
    ref_t = ref_hf.CanonicalTable(p.table_lengths) if table else None
    ref_rt = ref_hf.CanonicalTable(p.run_table_lengths) if run_table else None
    cf, cl, cb, csym, rf, rl, rb, vtab, rsym = edp._table_inputs(
        ref_t, ref_rt, mode, codec.DIRECT_VMIN)
    for name, want in (("vfirst", cf), ("vlimit", cl), ("vbase", cb),
                       ("csym", csym), ("rfirst", rf), ("rlimit", rl),
                       ("rbase", rb)):
        np.testing.assert_array_equal(fields[name], want, err_msg=name)
    np.testing.assert_array_equal(fields["rsym"], rsym[:hf.RUN_ALPHABET, 0])
    np.testing.assert_array_equal(got[o:], vtab[:got.size - o, 0])
    assert not vtab[got.size - o:].any()


# (n_stripes, bps): blocks a stripe that are not multiples of a warp's 32
# or the JAX kernel's 128-block cells, and the 4x4 / stripe_rows=4 widths
SCAN_SHAPES = ((3, 7), (5, 130), (2, 257), (2, 480), (1, 960))


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_block_scan_matches_jax_plan_cells(shape):
    """The plain version's scan of the index (the scan kernel D runs)
    against the JAX package's host plan: block offsets within a stripe,
    plus the stripe's first bit."""
    rng = np.random.default_rng(shape[1])
    bits = rng.integers(0, 2000, shape).astype(np.uint16)
    bits[0, : shape[1] // 3] = 0  # empty blocks
    starts = ed.stripe_starts(-(-bits.astype(np.int64).sum(axis=1) // 8))
    got = ed.block_starts(torch.from_numpy(bits.view(np.int16)),
                          torch.from_numpy(starts)).numpy()
    boff = edp.plan_cells(bits, shape[0])[0][:, : shape[1]]
    np.testing.assert_array_equal(got.reshape(shape) - starts[:, None], boff)


def _byte_aligned_starts(bits: torch.Tensor) -> np.ndarray:
    """ed.block_starts of an index whose stripes are byte-aligned, their
    byte lengths ceil(bits / 8), as a container's are."""
    stripe_bits = (bits.to(torch.int64) & 0xFFFF).sum(dim=1).numpy()
    starts = ed.stripe_starts(-(-stripe_bits // 8))
    return ed.block_starts(bits, torch.from_numpy(starts)).numpy()


def test_block_starts_follow_byte_aligned_stripes():
    bits = torch.tensor([[3, 0, 9], [1, 1, 1], [16, 0, 0]], dtype=torch.int16)
    np.testing.assert_array_equal(_byte_aligned_starts(bits),
                                  [0, 3, 3, 16, 17, 18, 24, 40, 40])
    # u16 entries arrive as int16 bit patterns
    big = torch.tensor([[40000 - 65536, 5]], dtype=torch.int16)
    np.testing.assert_array_equal(_byte_aligned_starts(big), [0, 40000])


def test_hostile_index_never_reads_past_the_payload():
    """Blocks whose index points past the payload decode from zero bits:
    the plain version, like the kernel, reads nothing outside it."""
    p, cfg, mode, table, run_table = _stream(_container("category"))
    ops = codec.indexed_operands(p.stripes, p.block_bits, table, run_table,
                                   mode, cfg.n2, "cpu")
    past = ops["payload"].numel() * 8
    ops["stripe_start"] = ops["stripe_start"] + past
    out = ed.decode_blocks_plain(**ops)
    zero_payload = dict(ops, payload=torch.zeros(past // 8 + 64,
                                                 dtype=torch.uint8))
    np.testing.assert_array_equal(
        out.numpy(), ed.decode_blocks_plain(**zero_payload).numpy())


def test_empty_blocks_decode_to_zeros():
    p, cfg, mode, table, run_table = _stream(_container("category"))
    ops = codec.indexed_operands(p.stripes, np.zeros_like(p.block_bits),
                                   table, run_table, mode, cfg.n2, "cpu")
    assert not ed.decode_blocks_plain(**ops).any()


def test_indexed_stream_helper_round_trips_every_mode():
    """testing.indexed_stream (the card tests' and chip_smoke's encoder of
    the modes the port's card path cannot encode) against the host
    decoder."""
    rng = np.random.default_rng(0)
    zz = torch.from_numpy(
        (rng.laplace(0, 3, (6 * 16, 64)) * (rng.random((6 * 16, 64)) < 0.3))
        .astype(np.int32))
    zz[5, 3] = 4000  # ESC in direct mode
    for kw in (dict(), dict(huffman_mode="direct", coded_runs=True),
               dict(use_huffman=False)):
        cfg = CodecConfig(decode_index=True, **kw)
        stripes, bits, table, run_table = testing.indexed_stream(zz, cfg, 6)
        mode = cfg.huffman_mode if cfg.use_huffman else "none"
        ops = codec.indexed_operands(stripes, bits, table, run_table, mode,
                                       64, "cpu")
        np.testing.assert_array_equal(ed.decode_blocks_plain(**ops).numpy(),
                                      zz.numpy())
        np.testing.assert_array_equal(
            native.unpack_stripes(stripes, 16, 64, mode, table,
                                  codec.DIRECT_VMIN, run_table=run_table),
            zz.numpy())


def test_stripped_index_decodes_the_same():
    """The host route of the same container (its index removed) gives the
    pixels the indexed route gives."""
    data = _container("category_runs_dc_adaptive")
    c = cont.deserialize(data)
    p = c.planes[0]
    indexed = codec.decode_plane_device(p, c.config, "cpu")
    host = codec.decode_plane_device(dataclasses.replace(p, block_bits=None),
                                     c.config, "cpu")
    np.testing.assert_array_equal(indexed.numpy(), host.numpy())
