"""Damaged containers through the port's decode and the JAX package's, on
the CPU.

The contract: for every container, the port's decode has the fate of the
JAX package's at its default (use_pallas=False, the host entropy
decoder): the same pixels, or a ValueError where that raises. Kernel D
decodes the port's indexed (v2) planes and reports each stripe whose
blocks contradict the index; the codec decodes such a plane again on the
host decoder, which then settles its fate.

The cases: 48x72 "photo" images (seed = the config's index), gray and
4:2:0, at seven configs; 40 mutations each, from
np.random.default_rng(config index): one bit flipped, one byte XORed, or
1-11 bytes scrambled, at an offset >= 4 (560 containers). Tolerance:
none; the pixels are equal, and on this data no decode tie arises.
"""

import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest
import torch

from dct_tpu import cli as ref_cli
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.models.video import VideoCodec as RefVideoCodec
from dct_tpu_torch import CodecConfig, cli, native, testing
from dct_tpu_torch import container as cont
from dct_tpu_torch import decode as top_decode
from dct_tpu_torch.models import codec, color
from dct_tpu_torch.models.video import VideoCodec
from dct_tpu_torch.ops import entropy_decode as ed
from dct_tpu_torch.ops import entropy_decode_cuda
from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.utils import image_io

CONFIGS = [
    dict(quality=50),
    dict(quality=50, coded_runs=True),
    dict(quality=80, huffman_mode="direct"),
    dict(quality=50, use_huffman=False),
    dict(quality=30, block_size=16),
    dict(quality=90, decode_index=True),
    dict(quality=50, adaptive=True, dc_prediction=True, coded_runs=True,
         decode_index=True),
]
CHROMAS = ("gray", "420")
N_MUTATIONS = 40


def _image(ci: int, chroma: str) -> np.ndarray:
    g = image_io.synthetic_image(48, 72, "photo", seed=ci)
    if chroma == "gray":
        return g
    return np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], -1)


def _config(ci: int, chroma: str) -> dict:
    return dict(CONFIGS[ci], **({} if chroma == "gray" else {"chroma": chroma}))


@functools.lru_cache(maxsize=None)
def _clean(ci: int, chroma: str) -> bytes:
    return ref_codec.encode(_image(ci, chroma), RefConfig(**_config(ci, chroma)))


@functools.lru_cache(maxsize=None)
def _damaged(ci: int) -> dict:
    """{chroma: the 40 damaged containers} of config ci: one generator
    per config, gray's draws first (testing.damaged_containers)."""
    rng = np.random.default_rng(ci)
    return {chroma: testing.damaged_containers(_clean(ci, chroma), rng,
                                               N_MUTATIONS)
            for chroma in CHROMAS}


_fate = testing.decode_fate


def _same_fate(ref, got, what: str) -> str:
    assert got[0] == ref[0], f"{what}: reference {ref[0]} ({ref[1]!s:.80}), " \
                             f"port {got[0]} ({got[1]!s:.80})"
    if ref[0] == "ok":
        assert got[1].shape == ref[1].shape and np.array_equal(got[1], ref[1]), \
            f"{what}: pixels differ"
    return ref[0]


@pytest.mark.parametrize("chroma", CHROMAS)
@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_damaged_containers_have_the_reference_fate(ci, chroma):
    codec.reset_host_redecodes()
    fates = {"ok": 0, "ValueError": 0}
    for k, m in enumerate(_damaged(ci)[chroma]):
        ref = _fate(lambda: ref_codec.decode(m))
        fates[_same_fate(ref, _fate(lambda: codec.decode(m, device="cpu")),
                         f"config {ci} {chroma} mutation {k}")] += 1
    assert fates["ok"] > 0


def test_flagged_planes_go_to_the_host_decoder():
    """Over the damaged v2 containers some planes are flagged and decoded
    again on the host, some of those raise, and a clean container never
    takes that path."""
    codec.reset_host_redecodes()
    for ci in range(len(CONFIGS)):
        for chroma in CHROMAS:
            codec.decode(_clean(ci, chroma), device="cpu")
    assert codec.HOST_REDECODES["planes"] == 0
    rejected = 0
    for m in _damaged(5)["gray"] + _damaged(6)["420"]:
        rejected += _fate(lambda: codec.decode(m, device="cpu"))[0] != "ok"
    assert codec.HOST_REDECODES["planes"] > 0 and rejected > 0


def _stripe_cases():
    """(stripes, index, tables, mode, n2) of every gray and chroma plane of
    the v2 configs, the payload damaged and the index kept."""
    for ci in range(len(CONFIGS)):
        for chroma in CHROMAS:
            c = cont.deserialize(_clean(ci, chroma))
            cfg = c.config
            if c.planes[0].block_bits is None:
                continue
            mode = cfg.huffman_mode if cfg.use_huffman else "none"
            rng = np.random.default_rng(500 + ci)
            for p in c.planes:
                table = (hf.CanonicalTable(p.table_lengths)
                         if mode != "none" else None)
                runs = (hf.CanonicalTable(p.run_table_lengths)
                        if cfg.coded_runs else None)
                for _ in range(12):
                    blob = bytearray(b"".join(p.stripes))
                    i = int(rng.integers(0, len(blob)))
                    j = min(len(blob), i + int(rng.integers(1, 4)))
                    blob[i:j] = rng.integers(0, 256, j - i,
                                             dtype=np.uint8).tobytes()
                    cut = np.cumsum([0] + [len(s) for s in p.stripes])
                    stripes = [bytes(blob[a:b]) for a, b in
                               zip(cut[:-1], cut[1:])]
                    yield stripes, p.block_bits, table, runs, mode, cfg.n2


def test_an_unflagged_stripe_is_the_host_decoders():
    """Where D's status is 0, the plain version's coefficients of that
    stripe equal the host decoder's on the same stripe, which does not
    raise; the wrapper gives the plain version's coefficients and status
    on the CPU."""
    n = {"clean": 0, "flagged": 0}
    for stripes, bits, table, runs, mode, n2 in _stripe_cases():
        ops = codec.indexed_operands(stripes, bits, table, runs, mode, n2,
                                     "cpu", status=True)
        bare = {k: v for k, v in ops.items() if k != "status"}
        zz, status = ed.decode_blocks_plain(**ops)
        assert status.dtype == torch.int32 and status.shape == (len(stripes),)
        got = entropy_decode_cuda.decode_blocks_kernel(**dict(
            ops, status=torch.zeros_like(status)))
        assert np.array_equal(got[0], zz) and np.array_equal(got[1], status)
        assert np.array_equal(entropy_decode_cuda.decode_blocks_kernel(**bare),
                              zz)
        bps = len(bits) // len(stripes)
        for s in range(len(stripes)):
            if status[s]:
                n["flagged"] += 1
                continue
            n["clean"] += 1
            host = native.unpack_stripes([stripes[s]], bps, n2, mode, table,
                                         codec.DIRECT_VMIN, run_table=runs)
            assert np.array_equal(zz[s * bps:(s + 1) * bps].numpy(), host)
    assert n["flagged"] > 0 and n["clean"] > 0, n


def test_clean_status_is_zero():
    for ci in (5, 6):
        c = cont.deserialize(_clean(ci, "gray"))
        p = c.planes[0]
        cfg = c.config
        table = hf.CanonicalTable(p.table_lengths)
        runs = (hf.CanonicalTable(p.run_table_lengths) if cfg.coded_runs
                else None)
        _, status = ed.decode_blocks_plain(**codec.indexed_operands(
            p.stripes, p.block_bits, table, runs, "category", cfg.n2, "cpu",
            status=True))
        assert not status.any()


def test_a_zero_bit_block_contradicts_the_index():
    """A block indexed at 0 bits holds no symbol: flagged, while the
    coefficients stay what D decodes (zeros)."""
    c = cont.deserialize(_clean(5, "gray"))
    p = c.planes[0]
    bits = np.asarray(p.block_bits, np.uint16).copy()
    bps = len(bits) // len(p.stripes)
    bits[bps + 1] += bits[bps]  # stripe 1: same sum, block 0 empty
    bits[bps] = 0
    zz, status = ed.decode_blocks_plain(**codec.indexed_operands(
        p.stripes, bits, hf.CanonicalTable(p.table_lengths), None,
        "category", 64, "cpu", status=True))
    assert status.tolist() == [0, 1] + [0] * (len(p.stripes) - 2)
    assert not zz[bps].any()


def _video_fates(ci: int, chroma: str, m: bytes):
    streams = [_clean(ci, chroma), m, _clean(ci, chroma)]
    ref = _fate(lambda: RefVideoCodec(RefConfig(**_config(ci, chroma)))
                .decode(streams))
    got = _fate(lambda: VideoCodec(CodecConfig(**_config(ci, chroma)),
                                   device="cpu").decode(streams))
    return ref, got


@pytest.mark.parametrize("chroma", CHROMAS)
def test_damaged_frames_of_a_stack_have_the_reference_fate(chroma):
    for ci in (0, 5, 6):
        for k, m in enumerate(_damaged(ci)[chroma][:10]):
            _same_fate(*_video_fates(ci, chroma, m),
                       f"video config {ci} {chroma} mutation {k}")


def _header_20_case() -> bytes:
    """A 4:2:0 16x16 container with header byte 20 flipped: its luma
    plane is 48x76, its chroma planes upsample to 48x72."""
    m = bytearray(_clean(4, "420"))
    m[20] ^= 4
    return bytes(m)


def test_planes_that_do_not_form_an_image_raise_value_error():
    m = _header_20_case()
    assert [(p.height, p.width) for p in cont.deserialize(m).planes] == [
        (48, 76), (24, 36), (24, 36)]
    with pytest.raises(ValueError):
        ref_codec.decode(m)
    for fn in (lambda: codec.decode(m, device="cpu"),
               lambda: top_decode(m, device="cpu"),
               lambda: color.ColorImageCodec(
                   cont.deserialize(m).config, "cpu").decode(m)):
        with pytest.raises(ValueError, match="do not form one 420 image"):
            fn()
    y = torch.zeros(48, 76, dtype=torch.uint8)
    c = torch.zeros(24, 36, dtype=torch.uint8)
    with pytest.raises(ValueError):
        color.planes_to_rgb(y, c, c, "420", 48, 72)
    with pytest.raises(ValueError):
        color.planes_to_rgb(y[:, :72], c, c, "444", 48, 72)
    assert color.planes_to_rgb(y[:, :72], c, c, "420", 48, 72).shape == (
        48, 72, 3)


def _first_rejected() -> bytes:
    """The first damaged gray v2 container of the recipe that the
    reference rejects with the host decoder's error."""
    for ci in range(len(CONFIGS)):
        for m in _damaged(ci)["gray"]:
            fate = _fate(lambda: ref_codec.decode(m))
            if (m[4] == 2 and fate[0] == "ValueError"
                    and "native stripe decode" in fate[1]):
                return m
    raise AssertionError("no rejected container in the recipe")


@pytest.mark.parametrize("case", ["index contradicted", "planes"])
def test_both_clis_print_one_decode_line_and_exit_1(case, tmp_path, capsys):
    m = _first_rejected() if case == "index contradicted" else _header_20_case()
    path = tmp_path / "bad.tpdc"
    path.write_bytes(m)
    for main, extra in ((ref_cli.main, []),
                        (cli.main, ["--device", "cpu"])):
        out = tmp_path / "out.pgm"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(["decode", str(path), str(out)] + extra)
        err = capsys.readouterr().err.strip().splitlines()
        assert rc == 1 and len(err) == 1 and err[0].startswith(
            f"decode: {path}: "), (main, err)
        assert not out.exists()


def test_clean_containers_decode_exactly_as_before():
    """Clean v2 containers: D's route, no host decode, pixels equal to the
    reference's and to the host route's."""
    codec.reset_host_redecodes()
    for ci in range(len(CONFIGS)):
        data = _clean(ci, "gray")
        got = codec.decode(data, device="cpu")
        assert np.array_equal(got, ref_codec.decode(data))
        c = cont.deserialize(data)
        host = codec.decode_plane(dataclasses.replace(
            c.planes[0], block_bits=None), c.config, "cpu")
        assert np.array_equal(got, host)
    assert codec.HOST_REDECODES["planes"] == 0
