"""The port's model-level entry points with ``mesh=`` on the CPU, over
gloo (after tests/test_mesh_models.py): the sharded VideoCodec and the
sharded rate control equal the unsharded port.

  * VideoCodec(cfg, chunk_frames=3, mesh=...) writes the unsharded
    VideoCodec's streams byte for byte: dynamic, static, adaptive with
    coded runs, direct, indexed, 2x2 blocks, RGB at 4:2:0, and one chunk
    (the pass-1 symbols packed by kernel E's plain version). 5 frames of
    7 stripes: mesh-pad stripes, and on the (2, 2) mesh a last chunk
    whose second data rank holds only a pad frame.
  * container_size, psnr_at_quality and roundtrip_sse give the same
    integers and floats with and without a mesh, gray and RGB; the
    encode_to_size / encode_to_psnr / encode_video_to_size fronts choose
    the same quality and return the same bytes; video_container_sizes
    the same integers.

Each mesh shape is spawned once (testing.run_mesh_jobs) and every case
runs in its ranks.
"""

from __future__ import annotations

import numpy as np
import pytest

from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch.models import rate_control as rc
from dct_tpu_torch.models.video import VideoCodec
from dct_tpu_torch.parallel import shard_encode as se
from dct_tpu_torch.utils import image_io

MESHES = [(1, 2), (2, 2)]
DEV = "cpu"

# 13 block rows: 13 stripes, which no stripe axis of 2 divides
IMAGE = image_io.synthetic_image(100, 160, "photo", seed=2)
RGB = np.stack([IMAGE, np.roll(IMAGE, 3, 0), np.roll(IMAGE, 5, 1)], -1)
FRAMES = np.stack([image_io.synthetic_image(56, 80, "photo", seed=s)
                   for s in range(5)])  # 7 stripes a frame
RGB_FRAMES = np.stack([FRAMES, np.roll(FRAMES, 3, 1), np.roll(FRAMES, 5, 2)],
                      -1)

VIDEO = {
    "dynamic": (dict(quality=45), 3),
    "static": (dict(quality=45, static_tables=True), 3),
    "adaptive_runs": (dict(quality=45, adaptive=True, coded_runs=True), 3),
    "direct": (dict(quality=45, huffman_mode="direct"), 3),
    "indexed": (dict(quality=45, decode_index=True), 3),
    "n2": (dict(quality=45, block_size=2), 3),
    "rgb420": (dict(quality=45, chroma="420"), 3),
    "one_chunk": (dict(quality=45, dc_prediction=True), None),
}

PROBES = {
    "dynamic": dict(quality=40),
    "adaptive_runs": dict(quality=40, adaptive=True, coded_runs=True),
    "static": dict(quality=40, static_tables=True),
}

BASE = CodecConfig(quality=40)


def _frames(cfg: CodecConfig) -> np.ndarray:
    return FRAMES if cfg.chroma == "gray" else RGB_FRAMES


def _jobs() -> list:
    jobs = []
    for case, (kw, ck) in VIDEO.items():
        cfg = CodecConfig(**kw)
        jobs.append((f"video_{case}", se.encode_video_sharded,
                     (_frames(cfg), cfg), dict(chunk_frames=ck)))
    for case, kw in PROBES.items():
        cfg = CodecConfig(**kw)
        jobs += [(f"size_{case}", rc.container_size, (IMAGE, cfg), {}),
                 (f"psnr_{case}", rc.psnr_at_quality, (IMAGE, cfg), {}),
                 (f"sse_{case}", rc.roundtrip_sse, (IMAGE, cfg), {})]
    rgb_cfg = BASE.replace(chroma="420")
    jobs += [
        ("size_rgb", rc.container_size, (RGB, rgb_cfg), {}),
        ("psnr_rgb", rc.psnr_at_quality, (RGB, rgb_cfg), {}),
        ("to_size", rc.encode_to_size, (IMAGE, 3000, BASE), {}),
        ("to_psnr", rc.encode_to_psnr, (IMAGE, 30.0, BASE), {}),
        ("to_size_rgb", rc.encode_to_size, (RGB, 6000, rgb_cfg), {}),
        ("video_sizes", rc.video_container_sizes, (FRAMES, BASE),
         dict(chunk_frames=3)),
        ("video_to_size", rc.encode_video_to_size, (FRAMES, 9000, BASE),
         dict(chunk_frames=3)),
    ]
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """mesh shape -> every rank's results, each shape spawned once (a
    failed spawn too: later tests of the shape re-raise its error)."""
    cache = {}

    def get(shape):
        if shape not in cache:
            try:
                cache[shape] = testing.run_mesh_jobs(
                    shape[0] * shape[1], shape, _jobs(),
                    tmp_path_factory.mktemp("mesh"))
            except Exception as e:
                cache[shape] = e
        if isinstance(cache[shape], Exception):
            raise cache[shape]
        return cache[shape]

    return get


def _values(ranks, shape, name):
    return [r[name]["value"] for r in ranks(shape)]


@pytest.mark.parametrize("case", sorted(VIDEO))
@pytest.mark.parametrize("shape", MESHES)
def test_video_sharded_byte_identical(ranks, shape, case):
    kw, ck = VIDEO[case]
    cfg = CodecConfig(**kw)
    want = VideoCodec(cfg, chunk_frames=ck, device=DEV).encode(_frames(cfg))
    for got in _values(ranks, shape, f"video_{case}"):
        assert got == want


@pytest.mark.parametrize("case", sorted(PROBES))
@pytest.mark.parametrize("shape", MESHES)
def test_probes_mesh_invariant(ranks, shape, case):
    cfg = CodecConfig(**PROBES[case])
    for name, fn in (("size", rc.container_size),
                     ("psnr", rc.psnr_at_quality),
                     ("sse", rc.roundtrip_sse)):
        want = fn(IMAGE, cfg, DEV)
        for got in _values(ranks, shape, f"{name}_{case}"):
            assert got == want, name


@pytest.mark.parametrize("shape", MESHES)
def test_color_probes_and_budget_mesh_identical(ranks, shape):
    cfg = BASE.replace(chroma="420")
    want_size = rc.container_size(RGB, cfg, DEV)
    want_psnr = rc.psnr_at_quality(RGB, cfg, DEV)
    want_fit = rc.encode_to_size(RGB, 6000, cfg, device=DEV)
    for r in ranks(shape):
        assert r["size_rgb"]["value"] == want_size
        assert r["psnr_rgb"]["value"] == want_psnr
        assert r["to_size_rgb"]["value"] == want_fit


@pytest.mark.parametrize("shape", MESHES)
def test_encode_to_size_and_psnr_mesh_identical(ranks, shape):
    want_size = rc.encode_to_size(IMAGE, 3000, BASE, device=DEV)
    want_psnr = rc.encode_to_psnr(IMAGE, 30.0, BASE, device=DEV)
    assert len(want_size[0]) <= 3000
    for r in ranks(shape):
        assert r["to_size"]["value"] == want_size
        assert r["to_psnr"]["value"] == want_psnr


@pytest.mark.parametrize("shape", MESHES)
def test_video_rate_control_mesh_identical(ranks, shape):
    sizes = rc.video_container_sizes(FRAMES, BASE, chunk_frames=3,
                                     device=DEV)
    streams, q = rc.encode_video_to_size(FRAMES, 9000, BASE, chunk_frames=3,
                                         device=DEV)
    assert sum(map(len, streams)) <= 9000
    for r in ranks(shape):
        np.testing.assert_array_equal(r["video_sizes"]["value"], sizes)
        assert r["video_to_size"]["value"] == (streams, q)
