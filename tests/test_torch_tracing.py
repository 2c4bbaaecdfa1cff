"""The port's spans and counts (dct_tpu_torch/utils/tracing.py) on the CPU.

Off (the default, no profiler running) a span is one shared no-op that
reads no clock and opens no RecordFunction or NVTX range. On (``enable()``
or a running profiler) spans record name, start, end, parent, call id and
counts in a bounded store; self time is a span's duration less its
children's. The codec's paths emit the spans PERF.md lists, and the bytes
they count are the bytes handed to the device.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from dct_tpu_torch import CodecConfig
from dct_tpu_torch.models.codec import ImageCodec
from dct_tpu_torch.models.color import ColorImageCodec
from dct_tpu_torch.models.video import VideoCodec
from dct_tpu_torch.utils import tracing

ENCODE_SPANS = {"video.encode", "video.upload_pad", "codec.encode_step",
                "bitstream.fetch_packed", "codec.index_readback",
                "bitstream.stripes_to_bytes", "container.serialize"}
DECODE_SPANS = {"video.decode_to_device", "container.deserialize",
                "container.unpack_index", "codec.indexed_operands",
                "codec.upload", "codec.reconstruct", "codec.status_readback",
                "color.planes_to_rgb", "video.stack"}


@pytest.fixture
def on():
    tracing.reset_timings()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset_timings()


def names() -> set[str]:
    return {r.name for r in tracing.records()}


def test_off_a_span_is_the_shared_noop_and_touches_nothing(monkeypatch):
    tracing.reset_timings()
    touched = []

    def count(what):
        def fn(*a, **k):
            touched.append(what)
        return fn

    monkeypatch.setattr(tracing, "_record", count("record"))
    monkeypatch.setattr(torch.profiler, "record_function", count("rf"))
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", count("nvtx"))
    monkeypatch.setattr(time, "perf_counter_ns", count("clock"))
    monkeypatch.setattr(tracing, "_clock", count("clock"))
    a = tracing.named_scope("a")
    b = tracing.named_scope("b", frames=3)
    assert a is b
    with a:
        with b:
            tracing.add("h2d_bytes", 5)
    assert touched == []
    assert tracing.records() == [] and tracing.timings_summary() == {}


def test_nested_spans_share_a_call_id_and_self_time_is_less_children(on):
    with tracing.named_scope("outer", frames=2):
        time.sleep(0.002)
        with tracing.named_scope("inner"):
            tracing.add("h2d_bytes", 7)
            tracing.add("h2d_bytes", 5)
            time.sleep(0.002)
        with tracing.named_scope("inner"):
            with tracing.named_scope("leaf"):
                pass
    with tracing.named_scope("next"):
        pass
    recs = tracing.records()
    assert [r.name for r in recs] == ["outer", "inner", "inner", "leaf",
                                      "next"]
    assert [r.parent for r in recs] == [None, 0, 0, 2, None]
    assert [r.call for r in recs] == [1, 1, 1, 1, 2]
    assert recs[0].counts == {"frames": 2}
    assert recs[1].counts == {"h2d_bytes": 12}
    for r in recs:
        assert r.end_ns >= r.start_ns
    s = tracing.timings_summary()
    dur = [r.end_ns - r.start_ns for r in recs]
    assert s["outer"]["self_s"] == pytest.approx(
        (dur[0] - dur[1] - dur[2]) / 1e9, rel=1e-12)
    assert s["inner"]["self_s"] == pytest.approx(
        (dur[1] + dur[2] - dur[3]) / 1e9, rel=1e-12)
    assert s["inner"]["calls"] == 2 and s["leaf"]["self_s"] == s["leaf"][
        "total_s"]
    assert 0 < s["outer"]["self_s"] < s["outer"]["total_s"]


def test_the_store_keeps_its_first_records_and_counts_the_dropped(
        on, monkeypatch):
    monkeypatch.setattr(tracing, "_store", tracing._Store(4))
    with pytest.warns(RuntimeWarning, match="store is full") as warned:
        for i in range(3):
            with tracing.named_scope(f"e{i}"):
                with tracing.named_scope(f"c{i}"):
                    pass
    assert len(warned) == 1  # once, at the first span dropped
    assert [r.name for r in tracing.records()] == ["e0", "c0", "e1", "c1"]
    assert tracing.dropped() == 2
    tracing.reset_timings()
    assert tracing.records() == [] and tracing.dropped() == 0
    assert tracing._store.records == []  # freed, to grow again


def test_a_span_open_across_a_reset_is_not_recorded(on):
    with tracing.named_scope("before"):
        tracing.reset_timings()
        with tracing.named_scope("after"):
            pass
    recs = tracing.records()
    assert [(r.name, r.parent) for r in recs] == [("after", None)]


def test_under_the_profiler_spans_record_and_land_in_its_trace(tmp_path):
    tracing.reset_timings()
    with tracing.trace(str(tmp_path)):
        with tracing.named_scope("outer.stage"):
            with tracing.named_scope("inner.stage"):
                torch.ones(64).cumsum(0)
    assert [r.name for r in tracing.records()] == ["outer.stage",
                                                   "inner.stage"]
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    found = {e["name"]: e for e in events
             if e.get("ph") == "X" and e["name"].endswith(".stage")}
    assert set(found) == {"outer.stage", "inner.stage"}
    # host events of torch's RecordFunction guard, which the benchmark's
    # breakdown names idle gaps by
    assert all(e["cat"] == "cpu_op" for e in found.values())
    o, i = found["outer.stage"], found["inner.stage"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    tracing.reset_timings()
    with tracing.named_scope("after.profile"):
        pass
    assert tracing.records() == []


def test_video_encode_emits_the_encode_spans_and_counts_its_upload(on):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 20, 28), dtype=np.uint8)
    cfg = CodecConfig(quality=50, static_tables=True)
    VideoCodec(cfg, device="cpu").encode(frames)
    assert names() == ENCODE_SPANS
    recs = tracing.records()
    entries = [r for r in recs if r.parent is None]
    assert [(e.name, e.counts["frames"]) for e in entries] == [
        ("video.encode", 2)]
    assert {r.call for r in recs} == {entries[0].call}
    assert sum(r.counts.get("h2d_bytes", 0) for r in recs) == frames.size
    assert [r.name for r in recs].count("bitstream.fetch_packed") == 1
    assert [r.name for r in recs].count("codec.index_readback") == 1
    d2h = sum(r.counts.get("d2h_bytes", 0) for r in recs)
    assert d2h > 0
    assert [r.name for r in recs].count("container.serialize") == 2


def test_video_decode_emits_the_decode_spans(on):
    rng = np.random.default_rng(5)
    smooth = np.add.outer(np.arange(24), np.arange(40)).astype(np.uint8)
    rgbs = [np.stack([smooth, smooth + 9, 255 - smooth], -1),
            rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)]
    cfg = CodecConfig(quality=90, chroma="420", decode_index=True)
    tracing.disable()
    data = [ColorImageCodec(cfg, device="cpu").encode(x) for x in rgbs]
    tracing.reset_timings()
    tracing.enable()
    out = VideoCodec(cfg, device="cpu").decode_to_device(data)
    assert tuple(out.shape) == (2, 24, 40, 3)
    assert names() == DECODE_SPANS
    recs = tracing.records()
    entries = [r for r in recs if r.parent is None]
    assert [(e.name, e.counts["frames"]) for e in entries] == [
        ("video.decode_to_device", 2)]
    uploads = [r for r in recs if r.name == "codec.upload"]
    assert len(uploads) == 6  # frame by frame: three planes each
    assert sum(r.counts.get("h2d_bytes", 0) for r in recs) == sum(
        r.counts["h2d_bytes"] for r in uploads)
    assert [r.name for r in recs].count("codec.status_readback") == 6


def test_the_image_entries_nest_their_stages(on):
    img = np.random.default_rng(1).integers(0, 256, (16, 24), np.uint8)
    codec = ImageCodec(CodecConfig(quality=90, static_tables=True),
                       device="cpu")
    data = codec.encode(img)
    codec.decode_to_device(data)
    recs = tracing.records()
    entries = [r.name for r in recs if r.parent is None]
    assert entries == ["image.encode", "image.decode_to_device"]
    by_call = {}
    for r in recs:
        by_call.setdefault(r.call, set()).add(r.name)
    assert {"container.serialize", "bitstream.fetch_packed",
            "codec.encode_step"} <= by_call[1]
    assert {"container.deserialize", "codec.reconstruct"} <= by_call[2]
    assert sum(r.counts.get("h2d_bytes", 0) for r in recs
               if r.call == 1) == img.size


ANALYZE_SPANS = ("codec.encode_analyze", "codec.histogram_readback",
                 "codec.build_tables", "codec.pack_frames")


def photo_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Smooth frames with noise: every category table symbol in use."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 3.0)
    return np.clip(base + rng.normal(0, 6, (n, h, w)), 0, 255).astype(
        np.uint8)


def by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_dynamic_video_encode_spans_its_analyze_pass(on):
    frames = photo_frames(3, 24, 40, 1)
    VideoCodec(CodecConfig(quality=50), device="cpu").encode(frames)
    recs = tracing.records()
    entry = recs.index(next(r for r in recs if r.parent is None))
    assert recs[entry].name == "video.encode"
    for name in ANALYZE_SPANS:
        found = by_name(recs, name)
        assert len(found) == 1, name
        assert found[0].parent == entry, name
    (a,) = by_name(recs, "codec.encode_analyze")
    assert a.counts == {"frames": 3, "blocks": 3 * 3 * 5}
    (rb,) = by_name(recs, "codec.histogram_readback")
    assert rb.counts == {"d2h_bytes": 16 * 4 + 4}   # categories, run stub
    (bt,) = by_name(recs, "codec.build_tables")
    assert bt.counts == {"h2d_bytes": 16 * 8}      # lengths and codes
    (pk,) = by_name(recs, "codec.pack_frames")
    assert pk.counts == {"frames": 3}
    order = [r.name for r in recs if r.name in ANALYZE_SPANS]
    assert order == list(ANALYZE_SPANS)
    assert "codec.encode_step" not in names()


def test_dynamic_video_encode_in_chunks_reads_each_chunks_histogram(on):
    frames = photo_frames(3, 24, 40, 2)
    VideoCodec(CodecConfig(quality=50), chunk_frames=2,
               device="cpu").encode(frames)
    recs = tracing.records()
    analyzed = by_name(recs, "codec.encode_analyze")
    assert [r.counts["frames"] for r in analyzed] == [2, 1]
    assert len(by_name(recs, "codec.histogram_readback")) == 2
    assert len(by_name(recs, "codec.build_tables")) == 1
    # pass 2 of 8x8 blocks is kernel B's, which packs nothing apart
    assert by_name(recs, "codec.pack_frames") == []


def test_the_one_chunk_route_packs_its_symbols_and_runs_no_b(monkeypatch):
    from dct_tpu_torch.models import codec

    calls = []

    def counted(name):
        real = getattr(codec, name)

        def fn(*a, **k):
            calls.append(name)
            return real(*a, **k)
        return fn

    for name in ("encode_analyze", "pack_frames", "encode_fused_step",
                 "encode_step"):
        monkeypatch.setattr(codec, name, counted(name))
    VideoCodec(CodecConfig(quality=50), device="cpu").encode(
        photo_frames(4, 16, 24, 3))
    assert calls == ["encode_analyze", "pack_frames"]


def test_encode_plane_dynamic_spans_analyze_readback_and_tables(on):
    img = photo_frames(1, 24, 40, 4)[0]
    ImageCodec(CodecConfig(quality=50), device="cpu").encode(img)
    recs = tracing.records()
    entry = recs.index(next(r for r in recs if r.parent is None))
    assert recs[entry].name == "image.encode"
    for name in ANALYZE_SPANS[:3]:
        (r,) = by_name(recs, name)
        assert r.parent == entry and r.call == recs[entry].call
    assert by_name(recs, "codec.encode_analyze")[0].counts == {
        "frames": 1, "blocks": 15}


def test_off_a_dynamic_encode_records_nothing():
    tracing.disable()
    tracing.reset_timings()
    VideoCodec(CodecConfig(quality=50), device="cpu").encode(
        photo_frames(2, 16, 24, 5))
    ImageCodec(CodecConfig(quality=50), device="cpu").encode(
        photo_frames(1, 16, 24, 6)[0])
    assert tracing.records() == []


@pytest.mark.parametrize("entry", ["video", "image"])
def test_a_static_table_encode_records_no_analyze_span(on, entry):
    cfg = CodecConfig(quality=50, static_tables=True)
    if entry == "video":
        VideoCodec(cfg, device="cpu").encode(photo_frames(2, 16, 24, 7))
    else:
        ImageCodec(cfg, device="cpu").encode(photo_frames(1, 16, 24, 8)[0])
    assert names() and not names() & set(ANALYZE_SPANS)


READER_SPANS = {
    # (span, the span it opens in) for each span a per-layer metric of
    # the benchmark reads, and the entries and parents that hold them
    "static": {
        ("video.encode", None), ("video.upload_pad", "video.encode"),
        ("codec.encode_step", "video.encode"),
        ("bitstream.fetch_packed", "video.encode"),
        ("codec.index_readback", "video.encode"),
        ("bitstream.stripes_to_bytes", "video.encode"),
        ("container.serialize", "video.encode")},
    "dynamic": {
        ("video.encode", None), ("video.upload_pad", "video.encode"),
        ("codec.encode_analyze", "video.encode"),
        ("codec.histogram_readback", "video.encode"),
        ("codec.build_tables", "video.encode"),
        ("codec.pack_frames", "video.encode"),
        ("bitstream.fetch_packed", "video.encode"),
        ("codec.index_readback", "video.encode"),
        ("bitstream.stripes_to_bytes", "video.encode"),
        ("container.serialize", "video.encode")},
    "decode": {
        ("video.decode_to_device", None),
        ("container.deserialize", "video.decode_to_device"),
        ("container.unpack_index", "container.deserialize"),
        ("codec.indexed_operands", "video.decode_to_device"),
        ("codec.upload", "codec.indexed_operands"),
        ("codec.reconstruct", "video.decode_to_device"),
        ("codec.status_readback", "video.decode_to_device")},
}


@pytest.mark.parametrize("case", sorted(READER_SPANS))
def test_the_readers_spans_keep_their_parents(on, case):
    """A 2-frame VideoCodec encode at static and at dynamic tables, and
    the decode of its v2 containers, record exactly these spans under
    these parents: a plan that lost or moved one would null a per-layer
    metric."""
    cfg = CodecConfig(quality=50, decode_index=True,
                      static_tables=case == "static")
    codec = VideoCodec(cfg, device="cpu")
    frames = photo_frames(2, 24, 40, 9)
    if case == "decode":
        tracing.disable()
        data = codec.encode(frames)
        tracing.enable()
        codec.decode_to_device(data)
    else:
        codec.encode(frames)
    recs = tracing.records()
    got = {(r.name, None if r.parent is None else recs[r.parent].name)
           for r in recs}
    assert got == READER_SPANS[case]


@pytest.mark.parametrize("adaptive", [True, False])
def test_the_variance_pass_is_spanned_under_adaptive_only(on, adaptive):
    """encode_step records one codec.variance_codes, with the blocks of
    every frame, inside its own span under adaptive quantization, and
    none at static quantization."""
    from dct_tpu_torch.models import codec

    cfg = CodecConfig(quality=50, static_tables=True, adaptive=adaptive)
    planes = torch.from_numpy(photo_frames(3, 24, 40, 10))
    codec.encode_step(planes, cfg, 3)
    recs = tracing.records()
    found = by_name(recs, "codec.variance_codes")
    if not adaptive:
        assert found == [] and names() == {"codec.encode_step"}
        return
    (v,) = found
    assert recs[v.parent].name == "codec.encode_step"
    assert v.counts == {"blocks": 3 * 3 * 5}
    assert recs[v.parent].counts == {"frames": 3}
