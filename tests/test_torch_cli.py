"""The port's CLI (``python -m dct_tpu_torch.cli``) on the CPU
(``--device cpu``), every subcommand driven in-process through
main(argv): one case for each case of tests/test_cli.py, then the two
CLIs against each other. Files written by either CLI are read by the
other, and the bytes the two write for the same command are equal, or
differ only in encode ties (a coefficient whose float64 value lies within
1e-6 of a .5 boundary, dct_tpu_torch.testing). Decoded pixels agree, or
differ by 1 at decode ties (color: within 1).
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from dct_tpu import cli as ref_cli
from dct_tpu import container as ref_cont
from dct_tpu.models import codec as ref_codec
from dct_tpu_torch import cli, testing
from dct_tpu_torch import container as cont
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import color
from dct_tpu_torch.models.video import VideoCodec
from dct_tpu_torch.ops import _build
from dct_tpu_torch.utils import image_io, metrics

# the subcommands that run the codec, and so take --device
DEVICE_CMDS = ("encode", "decode", "roundtrip", "repair", "encode-video",
               "decode-video", "bench")


def run(argv) -> int:
    """The port's CLI on the CPU."""
    argv = [str(a) for a in argv]
    return cli.main(argv + (["--device", "cpu"] if argv[0] in DEVICE_CMDS
                            else []))


def _video(frames, **kw) -> list[bytes]:
    return VideoCodec(CodecConfig(**kw), device="cpu").encode(frames)


@pytest.fixture(scope="module")
def pgm(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    img = image_io.synthetic_image(72, 96, "photo", seed=3)
    p = d / "in.pgm"
    image_io.write_image(str(p), img)
    return d, p, img


# ---------------------------------------------------------------------------
# The cases of tests/test_cli.py
# ---------------------------------------------------------------------------


def test_encode_decode_info(pgm, capsys):
    d, p, img = pgm
    out = d / "out.tpdc"
    rec = d / "rec.pgm"
    assert run(["encode", p, out, "--quality", "60"]) == 0
    assert out.exists() and out.stat().st_size > 0
    assert run(["decode", out, rec]) == 0
    got = image_io.read_image(str(rec))
    assert got.shape == img.shape
    assert metrics.mse(got, img) < 150  # q60 reconstruction is decent

    capsys.readouterr()
    assert run(["info", out]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["width"] == 96 and info["height"] == 72
    assert info["quality"] == 60


def test_roundtrip_reports_psnr(pgm, capsys):
    d, p, img = pgm
    capsys.readouterr()
    assert run(["roundtrip", p, "--quality", "85", "--adaptive"]) == 0
    out = capsys.readouterr().out
    assert "PSNR" in out and "dB" in out
    from dct_tpu_torch.models import codec

    data = codec.encode(img, CodecConfig(quality=85, adaptive=True), "cpu")
    want = metrics.psnr(codec.decode(data, "cpu"), img)
    assert out.startswith(f"PSNR {want:.2f} dB") and f"({len(data)} bytes)" in out


def test_verify_and_repair(pgm, capsys):
    d, p, img = pgm
    out = d / "v.tpdc"
    assert run(["encode", p, out, "--quality", "50", "--static-tables"]) == 0
    assert run(["verify", out]) == 0

    data = bytearray(out.read_bytes())
    data[-6:-2] = b"\xa5\xa5\xa5\xa5"  # clobber tail payload
    bad = d / "bad.tpdc"
    bad.write_bytes(bytes(data))
    assert run(["verify", bad]) == 1

    fixed = d / "fixed.tpdc"
    assert run(["repair", bad, p, "-o", fixed]) == 0
    assert run(["verify", fixed]) == 0
    assert fixed.read_bytes() == out.read_bytes()


def test_color_roundtrip(tmp_path):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    p = tmp_path / "c.ppm"
    image_io.write_image(str(p), img)
    out = tmp_path / "c.tpdc"
    rec = tmp_path / "c_rec.ppm"
    assert run(["encode", p, out, "--quality", "80"]) == 0
    assert cont.deserialize(out.read_bytes()).config.chroma == "420"
    assert run(["decode", out, rec]) == 0
    assert image_io.read_image(str(rec)).shape == img.shape


@pytest.mark.parametrize("argv", (["frobnicate", "x"], ["info"],
                                  ["encode", "a.pgm", "b.tpdc", "--huffman",
                                   "lzw"]),
                         ids=("unknown_command", "missing_input",
                              "unknown_choice"))
def test_unknown_command_rejected(argv):
    with pytest.raises(SystemExit):
        cli.main(argv)


@pytest.mark.parametrize("color", (False, True), ids=("gray", "color"))
def test_encode_decode_video(tmp_path, color):
    base = image_io.synthetic_image(40, 56, "photo", seed=3 + color)
    if color:
        rgb = np.stack([base, np.roll(base, 3, 0), np.roll(base, 5, 1)], -1)
        frames, flags = np.stack([rgb, rgb[::-1]]), ["--quality", "70"]
    else:
        frames = np.stack([np.roll(base, 5 * i, 0) for i in range(4)])
        flags = ["--quality", "60", "--coded-runs"]
    inp = tmp_path / "v.npy"
    np.save(inp, frames)
    out = tmp_path / "v.tpdv"
    rec = tmp_path / "r.npy"
    assert run(["encode-video", inp, out] + flags) == 0
    assert run(["decode-video", out, rec]) == 0
    got = np.load(rec)
    assert got.shape == frames.shape
    if not color:
        assert metrics.psnr(got, frames) >= 30


def test_tpdv_truncation_fails_cleanly(tmp_path):
    base = image_io.synthetic_image(24, 32, "photo", seed=5)
    data = cont.serialize_streams(_video(np.stack([base, base[::-1]]),
                                         quality=50))
    assert cont.deserialize_streams(data)  # intact roundtrip
    for cut in (0, 3, 6, 10, len(data) - 1):
        with pytest.raises(ValueError):
            cont.deserialize_streams(data[:cut])
    bad = tmp_path / "cut.tpdv"
    bad.write_bytes(data[:-1])
    for argv in (["info", bad], ["verify", bad],
                 ["decode-video", bad, tmp_path / "o.npy"]):
        with pytest.raises(ValueError):
            run(argv)


def _corrupt_video(tmp_path, seed, kw, clobber):
    """(source .npy, pristine bytes, damaged .tpdv) for 2-3 frames."""
    base = image_io.synthetic_image(32, 40, "photo", seed=seed)
    frames = np.stack([base, base[::-1], np.roll(base, 5, 1)])
    src = tmp_path / "src.npy"
    np.save(src, frames)
    pristine = cont.serialize_streams(_video(frames, **kw))
    raw = bytearray(pristine)
    clobber(raw, cont.deserialize_streams(pristine))
    bad = tmp_path / "bad.tpdv"
    bad.write_bytes(bytes(raw))
    return src, pristine, bad


def test_verify_video_stream(tmp_path, capsys):
    base = image_io.synthetic_image(32, 40, "photo", seed=6)
    streams = _video(np.stack([base, base[::-1]]), quality=50)
    out = tmp_path / "v.tpdv"
    out.write_bytes(cont.serialize_streams(streams))
    assert run(["verify", out]) == 0
    assert "all frames OK" in capsys.readouterr().out

    # corrupt frame 1's last stripe payload
    raw = bytearray(cont.serialize_streams(streams))
    raw[-12:-4] = b"\x99" * 8
    bad = tmp_path / "bad.tpdv"
    bad.write_bytes(bytes(raw))
    assert run(["verify", bad]) == 1
    assert "CORRUPT frames" in capsys.readouterr().out


def _clobber_tail(raw, streams):
    raw[-14:-6] = b"\x5c" * 8  # the last frame's tail


def _clobber_magic(raw, streams):
    # frame 1's TPDC magic: the 4 bytes after the sizes table and frame 0
    off = 8 + 4 * len(streams) + len(streams[0])
    raw[off:off + 4] = b"XXXX"


@pytest.mark.parametrize("seed, kw, clobber, report", (
    (7, dict(quality=55), _clobber_tail, "{2: [3]}"),
    (9, dict(quality=55, adaptive=True), _clobber_magic, "unreadable"),
), ids=("tail", "unreadable_frame"))
def test_repair_video_stream(tmp_path, capsys, seed, kw, clobber, report):
    """A damaged frame's stripes are re-encoded; a frame whose header is
    destroyed is rebuilt against a sibling frame's (batch-shared) tables;
    either way byte-identical to pristine."""
    src, pristine, bad = _corrupt_video(tmp_path, seed, kw, clobber)
    capsys.readouterr()
    assert run(["verify", bad]) == 1
    assert report in capsys.readouterr().out
    fixed = tmp_path / "fixed.tpdv"
    assert run(["repair", bad, src, "-o", fixed]) == 0
    assert fixed.read_bytes() == pristine
    assert run(["verify", fixed]) == 0


def test_info_video_stream(tmp_path, capsys):
    base = image_io.synthetic_image(24, 32, "photo", seed=8)
    streams = _video(np.stack([base, base[::-1]]), quality=45)
    out = tmp_path / "v.tpdv"
    out.write_bytes(cont.serialize_streams(streams))
    assert run(["info", out]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["stream_file"] and info["frames"] == 2
    assert info["quality"] == 45 and info["width"] == 32
    assert info["frame_bytes"] == [len(s) for s in streams]


def test_empty_tpdv_handled(tmp_path, capsys):
    empty = tmp_path / "e.tpdv"
    empty.write_bytes(cont.serialize_streams([]))
    assert run(["info", empty]) == 0
    assert '"frames": 0' in capsys.readouterr().out
    assert run(["verify", empty]) == 0
    with pytest.raises(SystemExit):
        run(["decode-video", empty, tmp_path / "o.npy"])


def test_encode_max_bytes(pgm, capsys):
    d, p, img = pgm
    free = d / "free.tpdc"
    capped = d / "capped.tpdc"
    assert run(["encode", p, free, "--quality", "90"]) == 0
    budget = free.stat().st_size // 2
    assert run(["encode", p, capped, "--max-bytes", budget]) == 0
    assert capped.stat().st_size <= budget
    assert "rate control" in capsys.readouterr().out
    rec = d / "capped.pgm"
    assert run(["decode", capped, rec]) == 0
    assert image_io.read_image(str(rec)).shape == img.shape


def test_encode_min_psnr(pgm, capsys):
    d, p, img = pgm
    out = d / "psnr.tpdc"
    assert run(["encode", p, out, "--min-psnr", "34"]) == 0
    assert "rate control" in capsys.readouterr().out
    rec = d / "psnr.pgm"
    assert run(["decode", out, rec]) == 0
    assert metrics.psnr(image_io.read_image(str(rec)), img) >= 34
    # mutually exclusive flags must fail loudly
    assert run(["encode", p, out, "--min-psnr", "34", "--max-bytes", "99"]) == 2


def test_encode_video_max_total_bytes(tmp_path, capsys):
    frames = np.stack([
        image_io.synthetic_image(48, 64, "photo", seed=s) for s in range(3)
    ])
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    free = tmp_path / "free.tpdv"
    assert run(["encode-video", src, free]) == 0
    budget = int(free.stat().st_size * 0.7)
    capped = tmp_path / "capped.tpdv"
    assert run(["encode-video", src, capped, "--max-total-bytes", budget]) == 0
    assert capped.stat().st_size <= budget
    assert "rate control" in capsys.readouterr().out
    rec = tmp_path / "rec.npy"
    assert run(["decode-video", capped, rec]) == 0
    assert np.load(rec).shape == frames.shape


def test_infeasible_rate_targets_fail_cleanly(pgm, capsys):
    """Infeasible --max-bytes / --min-psnr / --max-total-bytes must exit 2
    with a message, not escape a ValueError traceback."""
    d, p, _ = pgm
    out = d / "never.tpdc"
    capsys.readouterr()
    assert run(["encode", p, out, "--max-bytes", "10"]) == 2
    assert "budget" in capsys.readouterr().err
    assert run(["encode", p, out, "--min-psnr", "500"]) == 2
    assert "target" in capsys.readouterr().err
    assert not out.exists()
    frames = np.stack([
        image_io.synthetic_image(24, 32, "photo", seed=s) for s in range(2)
    ])
    src = d / "tiny.npy"
    np.save(src, frames)
    tp = d / "never.tpdv"
    # smaller than even the .tpdv wrapper header
    assert run(["encode-video", src, tp, "--max-total-bytes", "10"]) == 2
    assert "header" in capsys.readouterr().err
    # bigger than the wrapper but smaller than any rung
    assert run(["encode-video", src, tp, "--max-total-bytes", "40"]) == 2
    assert "budget" in capsys.readouterr().err


def _hostile_container() -> bytes:
    """A direct-mode container whose one stripe decodes past its plane."""
    lengths = np.zeros(40001, np.uint8)
    lengths[33100] = 1
    lengths[40000] = 1
    plane = cont.PlaneData(
        width=8, height=8, table_lengths=lengths, vmin=-255,
        variance_codes=None, stripe_bits=np.asarray([9], np.uint32),
        stripes=[bytes([0b00011111, 0b10000000])],
    )
    return cont.serialize(cont.Container(
        config=CodecConfig(quality=50, huffman_mode="direct"),
        width=8, height=8, planes=[plane],
    ))


def test_decode_corrupt_container_fails_cleanly(tmp_path, capsys):
    bad = tmp_path / "hostile.tpdc"
    bad.write_bytes(_hostile_container())
    capsys.readouterr()
    assert run(["decode", bad, tmp_path / "h.pgm"]) == 1
    assert "decode:" in capsys.readouterr().err
    assert not (tmp_path / "h.pgm").exists()
    assert run(["verify", bad]) == 1  # per-stripe report


# ---------------------------------------------------------------------------
# The port's additions: bench, --device, --pallas
# ---------------------------------------------------------------------------


def test_bench_prints_a_rate(capsys):
    capsys.readouterr()
    assert run(["bench", "--size", "96x72", "--frames", "1", "--iters",
                "1"]) == 0
    out = capsys.readouterr().out
    rate, ms = (float(x) for x in re.match(
        r"([\d.]+) Mpix/s \(([\d.]+) ms / 1 frames of 96x72, host clock\)",
        out).groups())
    # the rate is printed to 0.1 Mpix/s: at this size on a loaded host it
    # may round to 0.0, so it is held to the printed time
    assert ms > 0
    assert rate == pytest.approx(96 * 72 / ms / 1e3, rel=0.01, abs=0.05)


@pytest.mark.parametrize("cmd", DEVICE_CMDS)
def test_no_card_fails_without_falling_back(pgm, tmp_path, monkeypatch,
                                            cmd):
    """Without --device the CLI takes the card, and where there is none it
    fails with the entry points' error: it never carries on on the CPU."""
    d, p, img = pgm
    tpdc = d / "nocard.tpdc"
    tpdv = tmp_path / "nocard.tpdv"
    npy = tmp_path / "frames.npy"
    assert run(["encode", p, tpdc]) == 0
    np.save(npy, img[None])
    tpdv.write_bytes(cont.serialize_streams(_video(img[None])))
    out = tmp_path / "out"
    argv = {
        "encode": ["encode", p, out],
        "decode": ["decode", tpdc, tmp_path / "out.pgm"],
        "roundtrip": ["roundtrip", p],
        "repair": ["repair", tpdc, p, "-o", out],
        "encode-video": ["encode-video", npy, out],
        "decode-video": ["decode-video", tpdv, tmp_path / "out.npy"],
        "bench": ["bench", "--size", "16x16", "--frames", "1"],
    }[cmd]
    if cmd == "repair":  # a repair that has work to do
        raw = bytearray(tpdc.read_bytes())
        raw[-6:-2] = b"\xa5\xa5\xa5\xa5"
        tpdc = tmp_path / "bad.tpdc"
        tpdc.write_bytes(bytes(raw))
        argv[1] = tpdc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(a) for a in argv])
    assert not any(tmp_path.glob("out*"))
    assert _build.LAUNCHES == before


def _options(main, cmd: str, capsys) -> set[str]:
    """The option strings a subcommand's --help lists."""
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main([cmd, "--help"])
    return set(re.findall(r"(?<![\w-])--?[a-z][\w-]*",
                          capsys.readouterr().out))


@pytest.mark.parametrize("cmd", ("encode", "decode", "info", "roundtrip",
                                 "verify", "repair", "encode-video",
                                 "decode-video", "bench"))
def test_the_reference_clis_flags(cmd, capsys):
    """Every subcommand takes the reference CLI's flags, plus --device
    where it runs the codec."""
    want = _options(ref_cli.main, cmd, capsys)
    extra = {"--device"} if cmd in DEVICE_CMDS else set()
    assert _options(cli.main, cmd, capsys) == want | extra


def test_pallas_flag_is_accepted_and_ignored(pgm):
    d, p, _ = pgm
    outs = [d / "nopallas.tpdc", d / "pallas.tpdc"]
    assert run(["encode", p, outs[0], "--static-tables"]) == 0
    assert run(["encode", p, outs[1], "--static-tables", "--pallas"]) == 0
    assert outs[0].read_bytes() == outs[1].read_bytes()


# ---------------------------------------------------------------------------
# The two CLIs against each other
# ---------------------------------------------------------------------------


def _rgb(seed: int) -> np.ndarray:
    base = image_io.synthetic_image(48, 64, "photo", seed=seed)
    return np.stack([base, np.roll(base, 3, 0), np.roll(base, 5, 1)], -1)


# name: (subcommand, input, flags); the inputs are built by `cross`
CROSS = {
    "gray_q60": ("encode", "in.pgm", ["--quality", "60"]),
    "gray_q90_index_all": ("encode", "in.pgm", [
        "--quality", "90", "--decode-index", "on", "--adaptive",
        "--coded-runs", "--dc-prediction"]),
    "gray_static_q50": ("encode", "in.pgm", ["--static-tables"]),
    "gray_direct_stripes": ("encode", "in.pgm", [
        "--huffman", "direct", "--stripe-rows", "2", "--block-size", "4"]),
    "rgb_444": ("encode", "in.ppm", ["--quality", "75", "--chroma", "444"]),
    "gray_max_bytes": ("encode", "in.pgm", ["--max-bytes", "1500"]),
    "video_gray": ("encode-video", "in.npy", ["--quality", "60",
                                              "--coded-runs"]),
}


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """{name: (input image or stack, the reference CLI's output bytes,
    the port CLI's output bytes, the two CLIs' printed lines)}, for each
    command of CROSS run through both CLIs."""
    d = tmp_path_factory.mktemp("cross")
    inputs = {"in.pgm": image_io.synthetic_image(72, 96, "photo", seed=13),
              "in.ppm": _rgb(14),
              "in.npy": np.stack([image_io.synthetic_image(
                  40, 56, "photo", seed=s) for s in range(3)])}
    for name, arr in inputs.items():
        image_io.write_image(str(d / name), arr)
    out = {}
    for name, (cmd, inp, flags) in CROSS.items():
        res = []
        for which, main in (("ref", ref_cli.main), ("port", run)):
            path = d / f"{name}.{which}"
            lines = _printed(main, [cmd, str(d / inp), str(path)] + flags)
            res.append((path.read_bytes(), lines))
        out[name] = (inputs[inp], d, res[0][0], res[1][0], res[0][1],
                     res[1][1])
    return out


def _printed(main, argv) -> str:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _same_or_ties(got: bytes, want: bytes, image) -> None:
    """got == want, or every differing coefficient is an encode tie. For a
    color container ``want`` is re-encoded by the reference package from
    the port's planes first: the two packages' color conversions may
    differ at float64 .5 ties (tests/test_torch_color.py holds them to
    that), and a plane tie moves coefficients by more than a tie."""
    if got == want:
        return
    c = ref_cont.deserialize(want)
    planes = [np.asarray(image)]
    if c.config.chroma != "gray":
        planes = [p.numpy() for p in color._to_planes(
            torch.from_numpy(np.asarray(image)), c.config.chroma)]
        want = ref_cont.serialize(dataclasses.replace(c, planes=[
            ref_codec.encode_plane(p, c.config, chroma=i > 0)
            for i, p in enumerate(planes)]))
    if got != want:
        assert testing.plane_encode_mismatches(got, want, planes)[1] == 0


@pytest.mark.parametrize("name", sorted(CROSS))
def test_the_two_clis_write_the_same_bytes(cross, name):
    image, _, ref, port, ref_lines, port_lines = cross[name]
    if CROSS[name][0] == "encode-video":
        ref_s, port_s = (cont.deserialize_streams(b) for b in (ref, port))
        assert len(ref_s) == len(port_s) == len(image)
        for a, b, frame in zip(port_s, ref_s, image):
            _same_or_ties(a, b, frame)
    else:
        _same_or_ties(port, ref, image)
    if "rate control" in ref_lines:  # the same quality chosen
        assert ref_lines.split("rate control")[1] == \
            port_lines.split("rate control")[1]


@pytest.mark.parametrize("name", sorted(CROSS))
def test_each_cli_reads_the_others_files(cross, name, capsys):
    """info prints the same summary, verify passes, and decode gives the
    same pixels (ties excepted) through either CLI, for either's file."""
    image, d, ref, port, _, _ = cross[name]
    video = CROSS[name][0] == "encode-video"
    for which, data in (("ref", ref), ("port", port)):
        f = d / f"{name}.{which}.x{'.tpdv' if video else '.tpdc'}"
        f.write_bytes(data)
        infos = []
        for main in (ref_cli.main, run):
            capsys.readouterr()
            assert main(["info", str(f)]) == 0
            infos.append(json.loads(capsys.readouterr().out))
            assert main(["verify", str(f)]) == 0
        assert infos[0] == infos[1]
        ext = ".npy" if video else (".ppm" if image.ndim == 3 else ".pgm")
        recs = []
        for i, main in enumerate((ref_cli.main, run)):
            r = d / f"{name}.{which}.rec{i}{ext}"
            assert main(["decode-video" if video else "decode", str(f),
                         str(r)]) == 0
            recs.append(np.load(r) if video else image_io.read_image(str(r)))
        assert recs[0].shape == recs[1].shape == image.shape
        if video:
            for a, b, s in zip(recs[1], recs[0],
                               cont.deserialize_streams(data)):
                assert testing.decode_mismatches(a, b, s)[1] == 0
        elif image.ndim == 3:
            assert int(np.abs(recs[1].astype(int) - recs[0]).max()) <= 1
        else:
            assert testing.decode_mismatches(recs[1], recs[0], data)[1] == 0


def test_each_cli_repairs_the_others_video(tmp_path):
    """A .tpdv written by one CLI, damaged, is repaired by the other to
    the bytes that CLI writes from scratch."""
    frames = np.stack([image_io.synthetic_image(32, 40, "photo", seed=s)
                       for s in (21, 22)])
    src = tmp_path / "src.npy"
    np.save(src, frames)
    written = {}
    for which, main in (("ref", ref_cli.main), ("port", run)):
        written[which] = tmp_path / f"{which}.tpdv"
        assert main(["encode-video", str(src), str(written[which]),
                     "--quality", "55"]) == 0
    for writer, repairer, main in (("ref", "port", run),
                                   ("port", "ref", ref_cli.main)):
        raw = bytearray(written[writer].read_bytes())
        raw[-14:-6] = b"\x5c" * 8
        bad = tmp_path / f"{writer}.bad.tpdv"
        bad.write_bytes(bytes(raw))
        fixed = tmp_path / f"{writer}.fixed.tpdv"
        assert main(["repair", str(bad), str(src), "-o", str(fixed)]) == 0
        want = cont.deserialize_streams(written[repairer].read_bytes())
        got = cont.deserialize_streams(fixed.read_bytes())
        for a, b, frame in zip(got, want, frames):
            _same_or_ties(a, b, frame)
