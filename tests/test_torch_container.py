"""The port's copy of the container format (dct_tpu_torch.container) and
of the image helpers (dct_tpu_torch.utils.image_io) against the JAX
package's: the same bytes from the same fields, the same fields from the
same bytes, the same refusals of damaged input, the same arrays."""

import dataclasses

import numpy as np
import pytest

from dct_tpu import container as ref_cont
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.utils import image_io as ref_image_io
from dct_tpu_torch import CodecConfig
from dct_tpu_torch import container as cont
from dct_tpu_torch import native
from dct_tpu_torch.models.color import ColorImageCodec
from dct_tpu_torch.utils import image_io, tracing

CONFIGS = {
    "v1_q50": dict(quality=50),
    "v2_q90": dict(quality=90),
    "v2_forced": dict(quality=40, decode_index=True, adaptive=True,
                      coded_runs=True, dc_prediction=True),
    "v2_direct": dict(quality=40, decode_index=True, huffman_mode="direct"),
    "v2_none_n4": dict(block_size=4, quality=40, decode_index=True,
                       use_huffman=False, stripe_rows=2),
    "v1_color": dict(quality=60, chroma="420", decode_index=False),
    "v2_color": dict(quality=90, chroma="420", decode_index=True),
}
INDEXED = sorted(c for c in CONFIGS if c.startswith("v2"))

# the two parses of a packed decode index: the host library's one pass,
# and the plain Python version with the library patched away
PATHS = ("native", "python")


@pytest.fixture
def index_path(request, monkeypatch):
    """Run the test on one parse of the index (its parameter)."""
    if request.param == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the host library did not build")
    return request.param


def _container(case: str) -> bytes:
    kw = CONFIGS[case]
    im = ref_image_io.synthetic_image(37, 70, "photo", seed=9,
                                      color=kw.get("chroma", "gray") != "gray")
    return ref_codec.encode(im, RefConfig(**kw))


def _fields(c) -> dict:
    """A container's content as plain values, whichever package parsed
    it."""
    out = dict(config=dataclasses.asdict(c.config), width=c.width,
               height=c.height)
    for i, p in enumerate(c.planes):
        for f in dataclasses.fields(p):
            v = getattr(p, f.name)
            out[f"{i}.{f.name}"] = (None if v is None else
                                    v if isinstance(v, (int, list)) else
                                    (np.asarray(v).dtype.str,
                                     np.asarray(v).tolist()))
    return out


def _to_port(c: ref_cont.Container) -> cont.Container:
    return cont.Container(
        config=CodecConfig(**dataclasses.asdict(c.config)), width=c.width,
        height=c.height,
        planes=[cont.PlaneData(**dataclasses.asdict(p)) for p in c.planes])


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_same_fields_and_same_bytes(case):
    data = _container(case)
    ours, ref = cont.deserialize(data), ref_cont.deserialize(data)
    assert isinstance(ours.config, CodecConfig)
    assert _fields(ours) == _fields(ref)
    assert data[4] == (2 if case.startswith("v2") else 1)
    assert cont.serialize(ours) == data
    assert cont.serialize(_to_port(ref)) == ref_cont.serialize(ref)
    # the index rule decides alike when the config is rewritten
    for di in (True, False, "auto"):
        r = dataclasses.replace(ref, config=ref.config.replace(decode_index=di))
        o = dataclasses.replace(ours,
                                config=ours.config.replace(decode_index=di))
        if ours.planes[0].block_bits is None and di is True:
            continue  # no index to write
        assert cont.serialize(o) == ref_cont.serialize(r)


def test_index_packing_matches():
    rng = np.random.default_rng(3)
    for hi in (1, 2, 300, 65535):
        bb = rng.integers(0, hi + 1, 1000).astype(np.uint16)
        assert cont.pack_index(bb) == ref_cont.pack_index(bb)
    c = ref_cont.deserialize(_container("v2_q90"))
    assert (cont.index_cost_bytes(c.planes)
            == ref_cont.index_cost_bytes(c.planes))


@pytest.mark.parametrize("w", range(1, 17))
@pytest.mark.parametrize("n_stripes,bps", ((1, 203), (37, 11)),
                         ids=("one_stripe", "many_stripes"))
def test_native_index_unpack_matches_the_plain_parse(w, n_stripes, bps):
    """The host library's one-pass unpack of w-bit entries (counts not a
    multiple of 8, entries at 0 and 2^w - 1) equals the port's plain
    version and the JAX package's."""
    if not native.available():
        pytest.skip("the host library did not build")
    n = n_stripes * bps
    rng = np.random.default_rng(w * 100 + n_stripes)
    vals = rng.integers(0, 1 << w, n)
    vals[rng.integers(0, n, n // 8)] = 0
    vals[rng.integers(0, n, n // 8)] = (1 << w) - 1
    vals[0], vals[-1] = 0, (1 << w) - 1
    width, packed = cont.pack_index(vals)
    assert width == w and n % 8
    sums = vals.reshape(n_stripes, bps).sum(1).astype(np.uint32)
    got, rc = native.unpack_index(np.frombuffer(packed, np.uint8),
                                  n_stripes, bps, w, sums)
    assert rc == 0
    plain = cont._unpack_index(packed, 0, n, w)
    ref = ref_cont._unpack_index(packed, 0, n, w)
    for a in (got, plain, ref):
        assert a.dtype == np.uint16 and a.shape == (n,)
        np.testing.assert_array_equal(a, vals)
    # a stripe's sum off by one, and a pad bit set, with the pad bits there
    sums[-1] += 1
    assert native.unpack_index(np.frombuffer(packed, np.uint8), n_stripes,
                               bps, w, sums)[1] == 2
    if (n * w) % 8:
        bad = np.frombuffer(packed, np.uint8).copy()
        bad[-1] |= 1
        assert native.unpack_index(bad, n_stripes, bps, w, sums)[1] == 1


@pytest.mark.parametrize("index_path", PATHS, indirect=True)
@pytest.mark.parametrize("case", INDEXED)
def test_deserialize_gives_the_same_index_either_way(case, index_path):
    """deserialize returns the reference's block_bits, byte for byte and
    as uint16, with the host library and without it, and counts the
    parse under its path."""
    data = _container(case)
    before = dict(cont.INDEX_UNPACKS)
    ours, ref = cont.deserialize(data), ref_cont.deserialize(data)
    assert _fields(ours) == _fields(ref)
    for p, r in zip(ours.planes, ref.planes):
        assert p.block_bits.dtype == np.uint16 == r.block_bits.dtype
        assert p.block_bits.tobytes() == r.block_bits.tobytes()
    other = "python" if index_path == "native" else "native"
    assert cont.INDEX_UNPACKS[index_path] - before[index_path] == len(
        ours.planes)
    assert cont.INDEX_UNPACKS[other] == before[other]


@pytest.mark.parametrize("index_path", PATHS, indirect=True)
def test_index_unpacks_are_counted_and_spanned(index_path):
    """Decoding a v2 4:2:0 container moves INDEX_UNPACKS[path] by its
    planes, and each plane's container.unpack_index span counts its
    blocks."""
    data = _container("v2_color")
    planes = cont.deserialize(data).planes
    before = cont.INDEX_UNPACKS[index_path]
    tracing.reset_timings()
    tracing.enable()
    try:
        ColorImageCodec(CodecConfig(**CONFIGS["v2_color"]),
                        device="cpu").decode(data)
        spans = [r for r in tracing.records()
                 if r is not None and r.name == "container.unpack_index"]
    finally:
        tracing.disable()
        tracing.reset_timings()
    assert cont.INDEX_UNPACKS[index_path] - before == len(planes) == 3
    assert [r.counts["index_entries"] for r in spans] == [
        p.block_bits.size for p in planes]


def _outcome(fn, data):
    try:
        return _fields(fn(data))
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("case", ("v2_q90", "v2_forced", "v1_q50"))
def test_damaged_containers_meet_the_same_fate(case):
    data = _container(case)
    rng = np.random.default_rng(len(data))
    cuts = sorted(set(rng.integers(0, len(data), 40).tolist()) | {0, 3, 20})
    for n in cuts:
        assert _outcome(cont.deserialize, data[:n]) == _outcome(
            ref_cont.deserialize, data[:n]), n
    # tampered bytes, the index and the header flags among them
    for off in sorted(set(rng.integers(4, 200, 40).tolist()) | {4, 20}):
        for bit in (0x01, 0x08, 0x80):
            bad = bytearray(data)
            bad[off] ^= bit
            assert _outcome(cont.deserialize, bytes(bad)) == _outcome(
                ref_cont.deserialize, bytes(bad)), (off, bit)


FAULTS = {
    # a fault of the first plane's packed index: words of its message
    "flipped_bit": "stripe sums disagree",
    "pad_bit": "pad bits not zero",
    "truncated": "buffer is smaller than requested size",
    "width_0": "invalid decode index width 0",
    "width_17": "invalid decode index width 17",
}


@pytest.mark.parametrize("index_path", PATHS, indirect=True)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_tampered_index_is_rejected(fault, index_path):
    """A damaged packed index raises the JAX package's ValueError, message
    for message, on both parses."""
    data = _container("v2_forced")
    c = cont.deserialize(data)
    w, packed = cont.pack_index(c.planes[0].block_bits)
    at = data.index(bytes([w]) + packed) + 1  # the first plane's index
    assert (c.planes[0].block_bits.size * w) % 8  # it has pad bits
    bad = bytearray(data)
    if fault == "flipped_bit":
        bad[at] ^= 0x08
    elif fault == "pad_bit":
        bad[at + len(packed) - 1] |= 1
    elif fault == "truncated":
        bad = bad[:at + len(packed) // 2]
    else:
        bad[at - 1] = int(fault.split("_")[1])
    with pytest.raises(ValueError, match=FAULTS[fault]) as ref:
        ref_cont.deserialize(bytes(bad))
    with pytest.raises(ValueError) as ours:
        cont.deserialize(bytes(bad))
    assert str(ours.value) == str(ref.value)
    assert str(ours.value).startswith("truncated or corrupt TPDC container")
    p = dataclasses.replace(c.planes[0], block_bits=c.planes[0].block_bits.copy())
    p.block_bits[0] += 8
    with pytest.raises(ValueError, match="stripe sums"):
        cont.serialize(dataclasses.replace(c, planes=[p]))


def test_stream_files_match():
    frames = [_container(c) for c in ("v1_q50", "v2_q90", "v2_forced")]
    blob = cont.serialize_streams(frames)
    assert blob == ref_cont.serialize_streams(frames)
    assert cont.deserialize_streams(blob) == frames
    for n in (3, 7, 12, len(blob) - 1):
        for parse in (cont.deserialize_streams, ref_cont.deserialize_streams):
            with pytest.raises(ValueError):
                parse(blob[:n])


@pytest.mark.parametrize("kind", ("photo", "flat", "noise", "checker"))
@pytest.mark.parametrize("seed", (0, 7))
@pytest.mark.parametrize("color", (False, True))
def test_synthetic_image_copy_is_identical(kind, seed, color):
    got = image_io.synthetic_image(33, 50, kind, seed=seed, color=color)
    want = ref_image_io.synthetic_image(33, 50, kind, seed=seed, color=color)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("suffix,color", ((".pgm", False), (".ppm", True),
                                          (".npy", False)))
def test_image_files_read_back_alike(tmp_path, suffix, color):
    im = image_io.synthetic_image(21, 34, "photo", seed=1, color=color)
    ours, ref = tmp_path / f"ours{suffix}", tmp_path / f"ref{suffix}"
    image_io.write_image(ours, im)
    ref_image_io.write_image(ref, im)
    assert ours.read_bytes() == ref.read_bytes()
    np.testing.assert_array_equal(image_io.read_image(ref), im)
    np.testing.assert_array_equal(ref_image_io.read_image(ours), im)
