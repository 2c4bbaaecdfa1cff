"""The port's gray VideoCodec against the JAX VideoCodec on the CPU:
byte-identical streams for every chunking, decoded stacks within decode
ties on the indexed (v2) and host (v1) routes and for mixed batches, and
the routing of the encode paths.

Decoded pixels: equal, except at most 1 apart where the float64 value
lies within 1e-3 of a .5 boundary (the two decode products sum in
different orders; dct_tpu_torch.testing.decode_mismatches).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu.models.video import VideoCodec as RefVideoCodec
from dct_tpu.utils import image_io
from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch import container as cont
from dct_tpu_torch.models import codec
from dct_tpu_torch.models.video import VideoCodec
from dct_tpu_torch.ops import _build

CASES = {
    "dynamic_q50": dict(quality=50),
    "static_q50": dict(quality=50, static_tables=True),
    "adaptive_dc_runs_q55": dict(quality=55, adaptive=True,
                                 dc_prediction=True, coded_runs=True),
    "n4_q50": dict(block_size=4, quality=50),
    "none_q50": dict(quality=50, use_huffman=False),
    "direct_q90": dict(quality=90, huffman_mode="direct"),
}


@pytest.fixture(scope="module")
def frames():
    """The 5 x 48x64 stack of tests/test_video.py."""
    return np.stack([image_io.synthetic_image(48, 64, "photo", seed=s)
                     for s in range(5)])


@functools.lru_cache(maxsize=None)
def _ref_streams(case: str) -> tuple:
    stack = np.stack([image_io.synthetic_image(48, 64, "photo", seed=s)
                      for s in range(5)])
    return tuple(RefVideoCodec(RefConfig(**CASES[case])).encode(stack))


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_byte_identical(frames, case):
    got = VideoCodec(CodecConfig(**CASES[case]), device="cpu").encode(frames)
    assert got == list(_ref_streams(case))


@pytest.mark.parametrize("chunk_frames", (1, 2, 3))
@pytest.mark.parametrize("case", sorted(CASES))
def test_chunking_invariant(frames, case, chunk_frames):
    """Every chunking gives the unchunked reference's bytes: pass 1 sums
    the histograms, pass 2 encodes each chunk (kernel B's route where it
    takes the config, else analyze + kernel E's)."""
    vc = VideoCodec(CodecConfig(**CASES[case]), chunk_frames=chunk_frames,
                    device="cpu")
    assert vc.encode(frames) == list(_ref_streams(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_reference(case):
    """Decoded stacks of the reference streams: the port's indexed route
    (v2 streams) or host route (v1) against the JAX decode."""
    streams = list(_ref_streams(case))
    ours = VideoCodec(CodecConfig(**CASES[case]), device="cpu")
    got = ours.decode(streams)
    want = RefVideoCodec(RefConfig(**CASES[case])).decode(streams)
    assert got.shape == want.shape == (5, 48, 64) and got.dtype == np.uint8
    for f, data in enumerate(streams):
        n_mis, n_bad = testing.decode_mismatches(got[f], want[f], data)
        assert n_bad == 0
    on_dev = ours.decode_to_device(streams)
    assert on_dev.device.type == "cpu" and on_dev.dtype == torch.uint8
    np.testing.assert_array_equal(on_dev.numpy(), got)


@pytest.mark.parametrize("case", ("direct_q90", "none_q50", "dynamic_q50"))
def test_indexed_and_host_routes_agree(case):
    """The stack decode with the per-block index and with the index
    removed (host entropy decode) gives the same pixels, and equals
    per-frame ImageCodec decode."""
    streams = list(_ref_streams(case))
    cfg = CodecConfig(**CASES[case])
    conts = [cont.deserialize(s) for s in streams]
    indexed = codec.decode_planes_device([c.planes[0] for c in conts], cfg,
                                         "cpu")
    host = codec.decode_planes_device(
        [dataclasses.replace(c.planes[0], block_bits=None) for c in conts],
        cfg, "cpu")
    np.testing.assert_array_equal(indexed.numpy(), host.numpy())
    single = codec.ImageCodec(cfg, device="cpu")
    for f, s in enumerate(streams):
        np.testing.assert_array_equal(indexed[f].numpy(), single.decode(s))


def test_both_routes_are_covered():
    versions = {case: {s[4] for s in _ref_streams(case)} for case in CASES}
    assert versions["direct_q90"] == {2} and versions["dynamic_q50"] == {1}


def test_mixed_batch_decodes_frame_by_frame(frames):
    """Per-image dynamic tables differ per frame, so the stack cannot
    share one: the decode falls back to frame by frame, as the
    reference's does."""
    kw = dict(quality=60, adaptive=True)
    streams = [ref_codec.ImageCodec(RefConfig(**kw)).encode(f) for f in frames]
    streams[2] = ref_codec.ImageCodec(RefConfig(quality=90)).encode(frames[2])
    got = VideoCodec(CodecConfig(**kw), device="cpu").decode(streams)
    want = RefVideoCodec(RefConfig(**kw)).decode(streams)
    for f, data in enumerate(streams):
        assert testing.decode_mismatches(got[f], want[f], data)[1] == 0
        np.testing.assert_array_equal(
            got[f], codec.ImageCodec(device="cpu").decode(data))


def test_chunked_decode_matches(frames):
    cfg = CodecConfig(quality=55, adaptive=True)
    streams = VideoCodec(cfg, device="cpu").encode(frames)
    whole = VideoCodec(cfg, device="cpu").decode(streams)
    np.testing.assert_array_equal(
        VideoCodec(cfg, chunk_frames=2, device="cpu").decode(streams), whole)


@pytest.mark.parametrize("block_size", (2, 4, 8, 16))
@pytest.mark.parametrize("mode", ("category", "direct", "none"))
def test_fused_kernel_ok_truth_table(block_size, mode):
    """Kernel B takes 4x4, 8x8 and 16x16 blocks in every mode, and 2x2
    blocks in none."""
    cfg = CodecConfig(block_size=block_size, use_huffman=mode != "none",
                      huffman_mode=mode if mode != "none" else "category")
    assert codec.fused_kernel_ok(cfg) == (block_size in (4, 8, 16))


def test_cpu_video_launches_nothing(frames):
    before = dict(_build.LAUNCHES)
    vc = VideoCodec(CodecConfig(quality=90), device="cpu")
    vc.decode(vc.encode(frames))
    assert _build.LAUNCHES == before


def test_decode_of_no_streams_raises():
    for call in (VideoCodec(device="cpu").decode,
                 VideoCodec(device="cpu").decode_to_device):
        with pytest.raises(ValueError, match="at least one stream"):
            call([])


def test_rgb_stacks_round_trip(frames):
    """An RGB stack under a color config: one color container per frame,
    each decodable with codec.decode; a VideoCodec of any config decodes
    the stack to RGB, and the reference's color streams within 1 of the
    reference's decode."""
    rgb = np.stack([np.stack([f, np.roll(f, 3, 0), np.roll(f, 5, 1)], -1)
                    for f in frames[:2]])
    vc = VideoCodec(CodecConfig(quality=60, chroma="444"), device="cpu")
    streams = vc.encode(rgb)
    assert [cont.deserialize(s).config.chroma for s in streams] == ["444"] * 2
    rec = VideoCodec(device="cpu").decode(streams)
    assert rec.shape == (2, 48, 64, 3) and rec.dtype == np.uint8
    for f, s in enumerate(streams):
        np.testing.assert_array_equal(rec[f], codec.decode(s, "cpu"))
    color = RefVideoCodec(RefConfig(quality=60, chroma="444")).encode(rgb)
    got = VideoCodec(device="cpu").decode(color)
    want = RefVideoCodec(RefConfig(quality=60, chroma="444")).decode(color)
    assert int(np.abs(got.astype(int) - want).max()) <= 1


def test_entry_points_without_a_card_raise(frames, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoCodec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoCodec(CodecConfig(quality=90), chunk_frames=2)
    assert len(VideoCodec(device="cpu").encode(frames)) == 5
