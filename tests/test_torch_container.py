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
from dct_tpu_torch.utils import image_io

CONFIGS = {
    "v1_q50": dict(quality=50),
    "v2_q90": dict(quality=90),
    "v2_forced": dict(quality=40, decode_index=True, adaptive=True,
                      coded_runs=True, dc_prediction=True),
    "v2_direct": dict(quality=40, decode_index=True, huffman_mode="direct"),
    "v2_none_n4": dict(block_size=4, quality=40, decode_index=True,
                       use_huffman=False, stripe_rows=2),
    "v1_color": dict(quality=60, chroma="420", decode_index=False),
}


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


def test_tampered_index_is_rejected():
    data = _container("v2_forced")
    c = cont.deserialize(data)
    _, packed = cont.pack_index(c.planes[0].block_bits)
    bad = bytearray(data)
    bad[data.index(packed)] ^= 0x08
    for parse in (cont.deserialize, ref_cont.deserialize):
        with pytest.raises(ValueError, match="decode index"):
            parse(bytes(bad))
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
