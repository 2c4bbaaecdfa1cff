"""The color, recovery, rate-control and sharded paths of the port on the
card, through kernels A-E, held to the port's CPU path or its unsharded
card path.

These need an NVIDIA GPU and skip without one; run them on the card with
``python -m pytest --noconftest tests/test_torch_card_paths.py -q`` (the
suite's conftest.py imports jax; this file imports only the port).

Two sets. Color: ColorImageCodec and RGB VideoCodec stacks encode through
kernel B (after kernel A's analyze pass with dynamic tables) with the
chroma operators, and decode through kernel D (v2) or the host decoder,
then kernel C; the color conversions on the card equal the CPU's bit for
bit, containers equal the CPU path's or differ only in encode ties (a
coefficient whose float64 value lies within 1e-6 of a .5 boundary), and
pixels are within 1 of it and equal to the host route's. Recovery and
probes: a repair re-encodes stripes through kernels A and E and must give
the card's from-scratch bytes (which kernel B wrote: A and B run one
tile function); size probes equal len() of the card's containers and
PSNR probes the PSNR of its encode and decode, exactly. Sharding: at world
size 1 over NCCL, and at world size 2 over gloo with both ranks on the
one card, the sharded image, video and decode paths (parallel/) give the
unsharded card path's bytes and pixels, through the kernels. The CLI:
the four real PGMs of tests/data encoded and decoded by
``python -m dct_tpu_torch.cli`` (in this process) on the card, equal to
the CPU path (ties excepted) and to the host route. The examples
(examples/torch_demo.py, examples/torch_serving.py) with their default
device print the lines of their --device cpu runs; damaged v2 containers
have the CPU path's fate.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch import container as cont
from dct_tpu_torch.models import codec, color, rate_control, recovery, video
from dct_tpu_torch.ops import _build
from dct_tpu_torch.parallel import shard_encode
from dct_tpu_torch.utils import image_io


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rgb(img):
    return np.stack([img, np.roll(img, 3, 0), np.roll(img, 5, 1)], -1)


@pytest.fixture(scope="module")
def rgb():
    return _rgb(image_io.synthetic_image(75, 137, "photo", seed=11))


def _counted(fn):
    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES)


COLOR_CASES = {
    "444_static_q50": dict(quality=50, chroma="444", static_tables=True),
    "420_static_q50": dict(quality=50, chroma="420", static_tables=True),
    "420_q90_v2": dict(quality=90, chroma="420", decode_index=True),
    "444_adaptive_dc_runs": dict(quality=60, chroma="444", adaptive=True,
                                 dc_prediction=True, coded_runs=True),
    "420_n4_direct": dict(quality=75, chroma="420", block_size=4,
                          huffman_mode="direct"),
    "420_n16_v2": dict(quality=90, chroma="420", block_size=16,
                       decode_index=True),
}


@pytest.mark.cuda
def test_color_conversions_on_cuda_equal_the_cpu(cuda, rgb):
    for src in (rgb, rgb[:-1, :-2]):
        h, w = src.shape[:2]
        for mode in ("444", "420"):
            gpu = color._to_planes(torch.from_numpy(src).to(cuda), mode)
            cpu = color._to_planes(torch.from_numpy(src), mode)
            for g, c in zip(gpu, cpu):
                assert torch.equal(g.cpu(), c)
            back = color.planes_to_rgb(*gpu, mode, h, w)
            assert torch.equal(back.cpu(), color.planes_to_rgb(*cpu, mode,
                                                               h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(COLOR_CASES))
def test_color_codec_on_cuda_matches_cpu(cuda, rgb, case):
    cfg = CodecConfig(**COLOR_CASES[case])
    gpu = color.ColorImageCodec(cfg, device=cuda)
    data, enc = _counted(lambda: gpu.encode(rgb))
    assert enc["encode_stripes"] == 3 and enc["pack_chunks"] == 0
    assert enc["encode_blocks"] == (0 if cfg.static_tables else 3)
    cpu = color.ColorImageCodec(cfg, device="cpu")
    want = cpu.encode(rgb)
    if data != want:
        assert testing.encode_mismatches(data, want, rgb)[1] == 0
    indexed = data[4] == 2
    assert indexed or cfg.decode_index is not True
    rec, dec = _counted(lambda: gpu.decode_to_device(data))
    assert rec.device.type == "cuda" and rec.shape == (75, 137, 3)
    assert dec["entropy_decode"] == (3 if indexed else 0)
    assert dec["decode_blocks"] == (0 if cfg.n2 == 256 else 3)
    rec = rec.cpu().numpy()
    np.testing.assert_array_equal(gpu.decode(data), rec)
    assert np.abs(rec.astype(int) - cpu.decode(data)).max() <= 1
    c = cont.deserialize(data)
    host = color.planes_to_rgb(*(codec.decode_plane_device(
        dataclasses.replace(p, block_bits=None), c.config, cuda, chroma=i > 0)
        for i, p in enumerate(c.planes)), cfg.chroma, 75, 137)
    np.testing.assert_array_equal(host.cpu().numpy(), rec)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", (dict(quality=60, chroma="420"),
                                dict(quality=90, chroma="444")),
                         ids=("420_q60", "444_q90"))
def test_rgb_video_on_cuda_matches_cpu(cuda, kw):
    cfg = CodecConfig(**kw)
    frames = np.stack([_rgb(image_io.synthetic_image(72, 136, "photo",
                                                     seed=s))
                       for s in range(3)])
    streams, enc = _counted(
        lambda: video.VideoCodec(cfg, device=cuda).encode(frames))
    assert enc["encode_blocks"] == enc["pack_chunks"] == 3  # one a plane
    assert video.VideoCodec(cfg, chunk_frames=1, device=cuda).encode(
        frames) == streams
    want = video.VideoCodec(cfg, device="cpu").encode(frames)
    for f in range(3):
        if streams[f] != want[f]:
            assert testing.encode_mismatches(streams[f], want[f],
                                             frames[f])[1] == 0
    rec, dec = _counted(
        lambda: video.VideoCodec(cfg, device=cuda).decode_to_device(streams))
    assert dec["decode_blocks"] == 3
    rec = rec.cpu().numpy()
    single = color.ColorImageCodec(cfg, device=cuda)
    for f in range(3):
        np.testing.assert_array_equal(rec[f], single.decode(streams[f]))
    cpu = video.VideoCodec(cfg, device="cpu").decode(streams)
    assert np.abs(rec.astype(int) - cpu).max() <= 1


REPAIR_CASES = {
    "gray_static_q50": dict(quality=50, static_tables=True, stripe_rows=2),
    "gray_adaptive_dc_runs_v2": dict(quality=90, adaptive=True,
                                     dc_prediction=True, coded_runs=True,
                                     decode_index=True),
    "gray_n16_direct": dict(block_size=16, huffman_mode="direct"),
    "gray_n2": dict(block_size=2, quality=60, stripe_rows=4),
    "420_q90_v2": dict(quality=90, chroma="420", decode_index=True),
    "444_coded_runs": dict(quality=55, chroma="444", coded_runs=True,
                           stripe_rows=2),
}


def _corrupt(data: bytes, plane: int, stripe: int) -> bytes:
    c = cont.deserialize(data)
    s = bytearray(c.planes[plane].stripes[stripe])
    for i in range(min(8, len(s))):
        s[i] ^= 0xA5
    c.planes[plane].stripes[stripe] = bytes(s)
    return cont.serialize(c)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(REPAIR_CASES))
def test_repair_on_cuda_equals_the_cards_encode(cuda, rgb, case):
    cfg = CodecConfig(**REPAIR_CASES[case])
    src = rgb if cfg.chroma != "gray" else rgb[..., 0]
    original = codec.encode(src, cfg, cuda)
    gray = cfg.chroma == "gray"
    stripes = [1, 3] if gray else [(0, 1), (1, 2), (2, 0)]
    bad = original
    for st in stripes:
        bad = _corrupt(bad, *((0, st) if gray else st))
    # (damaged bytes need not desynchronize the decoder: Huffman codes
    # resynchronize, so verify may miss one; the stripes are named here)
    repaired, counts = _counted(lambda: recovery.repair(
        bad, src, stripes=stripes, device=cuda))
    assert repaired == original
    # one A and one E launch a damaged plane, no B
    assert counts["encode_stripes"] == 0
    assert counts["encode_blocks"] == counts["pack_chunks"] == (
        1 if gray else len({p for p, _ in stripes}))
    assert recovery.rebuild(original, src, device=cuda) == original


@pytest.mark.cuda
@pytest.mark.parametrize("chroma", ("gray", "444", "420"))
def test_decode_region_on_cuda(cuda, rgb, chroma):
    cfg = CodecConfig(quality=90, chroma=chroma, decode_index=True)
    src = rgb if chroma != "gray" else rgb[..., 0]
    data = codec.encode(src, cfg, cuda)
    full = codec.decode(data, cuda)
    for row0, row1 in ((0, 16), (13, 57), (50, 75)):
        region, counts = _counted(lambda: recovery.decode_region(
            data, row0, row1, device=cuda))
        np.testing.assert_array_equal(region, full[row0:row1])
        assert counts["decode_blocks"] == (1 if chroma == "gray" else 3)


PROBE_CASES = {
    "gray_dynamic_q50": dict(quality=50),
    "gray_v2_adaptive_q90": dict(quality=90, adaptive=True,
                                 decode_index=True),
    "gray_n16": dict(quality=50, block_size=16),
    "420_q50": dict(quality=50, chroma="420"),
    "444_v2_q90": dict(quality=90, chroma="444", decode_index=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probes_on_cuda_are_exact(cuda, rgb, case):
    cfg = CodecConfig(**PROBE_CASES[case])
    src = rgb if cfg.chroma != "gray" else rgb[..., 0]
    data = codec.encode(src, cfg, cuda)
    size, counts = _counted(lambda: rate_control.container_size(src, cfg,
                                                                  cuda))
    assert size == len(data)
    assert counts["encode_blocks"] >= 1 and counts["encode_stripes"] == 0
    rec = codec.decode(data, cuda).astype(np.float64)
    mse = float(np.mean((rec - src) ** 2))
    psnr, counts = _counted(lambda: rate_control.psnr_at_quality(src, cfg,
                                                                   cuda))
    assert psnr == float(10.0 * np.log10(255.0 * 255.0 / mse))
    assert counts["encode_blocks"] >= 1
    assert counts["decode_blocks"] == (0 if cfg.n2 == 256 else
                                       (1 if cfg.chroma == "gray" else 3))


@pytest.mark.cuda
def test_video_size_probe_on_cuda_is_exact(cuda):
    frames = np.stack([_rgb(image_io.synthetic_image(72, 136, "photo",
                                                     seed=s))
                       for s in range(3)])
    for cfg, src in ((CodecConfig(quality=60, chroma="420"), frames),
                     (CodecConfig(quality=90), frames[..., 0])):
        for ck in (None, 2):
            streams = video.VideoCodec(cfg, chunk_frames=ck,
                                       device=cuda).encode(src)
            sizes = rate_control.video_container_sizes(src, cfg, ck, cuda)
            assert sizes.tolist() == [len(s) for s in streams]


SHARD_CASES = {
    "gray_static_q50": dict(quality=50, static_tables=True),
    "gray_dynamic_adaptive_q50": dict(quality=50, adaptive=True,
                                      coded_runs=True),
    "gray_q90_v2": dict(quality=90, decode_index=True, dc_prediction=True),
    "gray_n16_v2": dict(quality=90, block_size=16, decode_index=True),
    "420_q90_v2": dict(quality=90, chroma="420", decode_index=True),
    "444_q50": dict(quality=50, chroma="444"),
}
SHARD_VIDEO = {"dynamic_one_chunk": (dict(quality=50), None),
               "dynamic_chunked": (dict(quality=50, adaptive=True), 2),
               "static_420": (dict(quality=50, static_tables=True,
                                   chroma="420"), None)}


def _shard_src(rgb, cfg):
    return rgb if cfg.chroma != "gray" else rgb[..., 0]


@pytest.fixture(scope="module")
def sharded_ranks(cuda, rgb, tmp_path_factory):
    """{(backend, mesh shape): every rank's results} of the sharded paths
    on the card: world size 1 over NCCL, and 2 over gloo, both ranks on
    the one card (NCCL refuses two ranks on one GPU)."""
    frames = np.stack([_rgb(image_io.synthetic_image(72, 136, "photo",
                                                     seed=s))
                       for s in range(3)])
    jobs = []
    for case, kw in SHARD_CASES.items():
        cfg = CodecConfig(**kw)
        src = _shard_src(rgb, cfg)
        jobs += [(f"enc_{case}", shard_encode.encode_image_sharded,
                  (src, cfg), {}),
                 (f"dec_{case}", shard_encode.decode_image_sharded,
                  (codec.encode(src, cfg, cuda),), {})]
    for case, (kw, ck) in SHARD_VIDEO.items():
        cfg = CodecConfig(**kw)
        jobs.append((f"video_{case}", shard_encode.encode_video_sharded,
                     (_shard_src(frames, cfg), cfg), dict(chunk_frames=ck)))
    cfg = CodecConfig(quality=70, chroma="420")
    jobs += [("size", rate_control.container_size, (rgb, cfg), {}),
             ("psnr", rate_control.psnr_at_quality, (rgb, cfg), {})]
    out = {}
    for backend, shape in (("nccl", (1, 1)), ("gloo", (1, 2))):
        out[backend, shape] = testing.run_mesh_jobs(
            shape[0] * shape[1], shape, jobs,
            tmp_path_factory.mktemp(backend), backend=backend,
            device_type="cuda", timeout=600)
    return out, frames


SHARD_RUNS = (("nccl", (1, 1)), ("gloo", (1, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("run", SHARD_RUNS, ids=("nccl_1", "gloo_2"))
@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_sharded_image_on_cuda_equals_the_card(cuda, rgb, sharded_ranks,
                                               run, case):
    ranks, _ = sharded_ranks
    cfg = CodecConfig(**SHARD_CASES[case])
    src = _shard_src(rgb, cfg)
    data = codec.encode(src, cfg, cuda)
    rec = codec.decode(data, cuda)
    for r in ranks[run]:
        enc, dec = r[f"enc_{case}"], r[f"dec_{case}"]
        assert enc["value"] == data
        assert enc["launches"]["encode_stripes"] >= 1
        np.testing.assert_array_equal(dec["value"], rec)
        assert dec["launches"]["entropy_decode"] == (
            0 if data[4] == 1 else len(cont.deserialize(data).planes))
        assert dec["launches"]["decode_blocks"] == (
            0 if cfg.n2 == 256 else len(cont.deserialize(data).planes))


@pytest.mark.cuda
@pytest.mark.parametrize("run", SHARD_RUNS, ids=("nccl_1", "gloo_2"))
@pytest.mark.parametrize("case", sorted(SHARD_VIDEO))
def test_sharded_video_on_cuda_equals_the_card(cuda, sharded_ranks, run,
                                               case):
    ranks, frames = sharded_ranks
    kw, ck = SHARD_VIDEO[case]
    cfg = CodecConfig(**kw)
    want = video.VideoCodec(cfg, chunk_frames=ck, device=cuda).encode(
        _shard_src(frames, cfg))
    for r in ranks[run]:
        assert r[f"video_{case}"]["value"] == want
        launches = r[f"video_{case}"]["launches"]
        assert launches["encode_stripes"] + launches["pack_chunks"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("run", SHARD_RUNS, ids=("nccl_1", "gloo_2"))
def test_sharded_probes_on_cuda_equal_the_card(cuda, rgb, sharded_ranks,
                                               run):
    ranks, _ = sharded_ranks
    cfg = CodecConfig(quality=70, chroma="420")
    size = rate_control.container_size(rgb, cfg, cuda)
    psnr = rate_control.psnr_at_quality(rgb, cfg, cuda)
    for r in ranks[run]:
        assert r["size"]["value"] == size
        assert r["psnr"]["value"] == psnr
        assert r["psnr"]["launches"]["decode_blocks"] == 3


PGMS = ("dem.pgm", "hopper.pgm", "mri.pgm", "topobathy.pgm")
PGM_FLAGS = {"q50": ["--quality", "50"],
             "q90_v2": ["--quality", "90", "--decode-index", "on"]}


@pytest.mark.cuda
@pytest.mark.parametrize("flags", sorted(PGM_FLAGS))
@pytest.mark.parametrize("name", PGMS)
def test_real_images_through_the_cli_on_cuda(cuda, tmp_path, name, flags):
    """The four real PGMs of tests/data encoded and decoded by
    ``python -m dct_tpu_torch.cli`` on the card (no --device): the
    containers equal the CPU path's (ties excepted), and the decoded
    pixels equal the host route's (host entropy decode, then kernel C)."""
    from dct_tpu_torch import cli

    pgm = pathlib.Path(__file__).resolve().parent / "data" / name
    img = image_io.read_image(pgm)
    out, rec = tmp_path / "a.tpdc", tmp_path / "a.pgm"
    argv = ["encode", str(pgm), str(out)] + PGM_FLAGS[flags]
    rc, enc = _counted(lambda: cli.main(argv))
    assert rc == 0 and enc["encode_stripes"] == 1
    assert enc["encode_blocks"] == 1  # the analyze pass (dynamic tables)
    data = out.read_bytes()
    cpu = codec.encode(img, cont.deserialize(data).config, "cpu")
    if data != cpu:
        assert testing.encode_mismatches(data, cpu, img)[1] == 0
    rc, dec = _counted(lambda: cli.main(["decode", str(out), str(rec)]))
    assert rc == 0 and dec["decode_blocks"] == 1
    assert dec["entropy_decode"] == (1 if data[4] == 2 else 0)
    assert (data[4] == 2) == (flags == "q90_v2")
    c = cont.deserialize(data)
    host = codec.decode_plane_device(
        dataclasses.replace(c.planes[0], block_bits=None), c.config, cuda)
    np.testing.assert_array_equal(image_io.read_image(rec),
                                  host.cpu().numpy())


EXAMPLES = ("torch_demo.py", "torch_serving.py")


def _example_lines(name: str, argv) -> list[str]:
    import contextlib
    import io
    import runpy

    main = runpy.run_path(str(pathlib.Path(__file__).resolve().parents[1]
                              / "examples" / name))["main"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [line for line in buf.getvalue().splitlines()
            if not line.startswith(("backend:", "ingest :"))]


@pytest.mark.cuda
@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_on_cuda_print_the_cpu_numbers(cuda, name):
    """Each example with its default device (the card) prints the lines of
    its --device cpu run (the backend and the ingest rate aside), through
    kernels A, B, C and E, and the demo's v2 decode through D (serving's
    streams are v1)."""
    lines, counts = _counted(lambda: _example_lines(name, []))
    assert lines == _example_lines(name, ["--device", "cpu"])
    kernels = ["encode_blocks", "encode_stripes", "decode_blocks",
               "pack_chunks"] + (["entropy_decode"] if "demo" in name else [])
    assert all(counts[k] > 0 for k in kernels), counts


# gray and 4:2:0 at the v2 configs of tests/test_torch_damaged_decode.py
DAMAGED = {"q90_index": dict(quality=90, decode_index=True),
           "rich_index": dict(quality=50, adaptive=True, dc_prediction=True,
                              coded_runs=True, decode_index=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("chroma", ("gray", "420"))
@pytest.mark.parametrize("case", sorted(DAMAGED))
def test_damaged_containers_on_cuda_have_the_cpu_fate(cuda, case, chroma):
    """Damaged v2 containers (testing.damaged_containers): the card's
    decode gives the CPU's pixels or raises ValueError where it does;
    flagged planes go to the host decoder, a clean container never."""
    g = image_io.synthetic_image(48, 72, "photo", seed=len(case))
    img = g if chroma == "gray" else _rgb(g)
    cfg = CodecConfig(**DAMAGED[case],
                      **({} if chroma == "gray" else {"chroma": chroma}))
    data = codec.encode(img, cfg, cuda)
    codec.reset_host_redecodes()
    assert np.array_equal(codec.decode(data, cuda),
                          codec.decode(data, "cpu"))
    assert codec.HOST_REDECODES["planes"] == 0
    fates = []
    for m in testing.damaged_containers(data, np.random.default_rng(9), 40):
        card = testing.decode_fate(lambda: codec.decode(m, cuda))
        cpu = testing.decode_fate(lambda: codec.decode(m, "cpu"))
        assert card[0] == cpu[0], (card[1], cpu[1])
        if card[0] == "ok":
            np.testing.assert_array_equal(card[1], cpu[1])
        fates.append(card[0])
    assert "ok" in fates and codec.HOST_REDECODES["planes"] > 0
