"""The port's sharded paths (dct_tpu_torch/parallel/) on the CPU, over
gloo: 2 and 4 ranks, meshes (1, 2), (2, 1) and (2, 2), on an image whose
15 stripes do not divide the stripe axis (mesh-pad stripes in play).

Each mesh shape is spawned once for the module (testing.run_mesh_jobs,
its ranks run every case) and the tests compare the saved results:
  * the collectives: stripe_byte_offsets and the two global histograms
    against their plain sums; the collectives each path calls (the
    batch step and a rank's decode of its stripes none, a decode one
    all-reduce of its ranks' failures before its gathers, a dynamic
    plane one all-reduce per histogram and one all-gather of bit
    lengths);
  * encode_image_sharded byte for byte the port's unsharded ImageCodec /
    ColorImageCodec on the CPU, on every rank, and the JAX package's
    shard_encode.encode_image_sharded on the same-shaped JAX CPU mesh,
    ties excepted (testing.encode_mismatches);
  * encode_batch_step's stripes those of codec.encode_step per frame;
  * decode_image_sharded the unsharded port decode's pixels, v1 and v2,
    gray and 4:2:0, and of damaged v2 containers its fate (the same
    pixels, or ValueError on every rank).
"""

from __future__ import annotations

import functools
import time

import jax
import numpy as np
import pytest
import torch

from dct_tpu import container as ref_cont
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.parallel import mesh as ref_meshlib
from dct_tpu.parallel import shard_encode as ref_se
from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch import container as cont
from dct_tpu_torch.models import codec, color
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.parallel import mesh as meshlib
from dct_tpu_torch.parallel import shard_encode as se
from dct_tpu_torch.utils import image_io

MESHES = [(1, 2), (2, 1), (2, 2)]

# 120 rows: 15 stripes of 8x8 blocks, which no stripe axis of 2 divides
IMAGE = image_io.synthetic_image(120, 96, "photo", seed=3)
RGB = np.stack([IMAGE, np.roll(IMAGE, 3, 0), np.roll(IMAGE, 5, 1)], -1)

ENCODE = {
    "static": dict(quality=50, static_tables=True),
    "dynamic": dict(quality=50),
    "adaptive": dict(quality=50, adaptive=True),
    "direct": dict(quality=50, huffman_mode="direct"),
    "none": dict(quality=50, use_huffman=False),
    "coded_runs_dc": dict(quality=55, coded_runs=True, dc_prediction=True),
    "decode_index": dict(quality=45, decode_index=True, adaptive=True),
    "n2_staged": dict(quality=50, block_size=2),
    "n16_static": dict(quality=60, block_size=16, static_tables=True),
    "420": dict(quality=60, chroma="420", adaptive=True),
    "444_runs": dict(quality=60, chroma="444", coded_runs=True),
}
# against the JAX package, each on one mesh shape (each JAX config
# compiles anew, 1-8 s)
JAX_CASES = ("static", "dynamic", "adaptive", "direct", "coded_runs_dc",
             "decode_index", "420")
JAX_MESH = {case: MESHES[i % len(MESHES)] for i, case in enumerate(JAX_CASES)}

DECODE = {
    "v1_gray": dict(quality=55, adaptive=True, dc_prediction=True),
    "v2_gray": dict(quality=45, decode_index=True, adaptive=True,
                    coded_runs=True, dc_prediction=True),
    "v2_n16": dict(quality=90, block_size=16, decode_index=True),
    "v1_420": dict(quality=60, chroma="420", coded_runs=True),
    "v2_420": dict(quality=50, chroma="420", decode_index=True),
}

# damaged containers (testing.damaged_containers) of one v2 config
DAMAGED = {"gray": DECODE["v2_gray"],
           "420": dict(DECODE["v2_gray"], chroma="420")}

BATCH_CFG = CodecConfig(quality=50, static_tables=True)
BATCH = np.stack([image_io.synthetic_image(64, 96, "photo", seed=s)
                  for s in range(4)])  # 8 stripes a frame
BITS = np.array([9, 16, 0, 7, 32, 100, 1, 8], np.int32)
_rng = np.random.default_rng(4)
HIST_VALUES = _rng.integers(-300, 300, (8, 64)).astype(np.int32)
HIST_LIVE = _rng.random((8, 64)) < 0.6
HIST_RUNS = _rng.integers(0, 64, (8, 64)).astype(np.int32)
MESH_SIZES = [(None, None), (2, None), (None, 1), (3, None), (2, 3)]


def _src(cfg: CodecConfig) -> np.ndarray:
    return IMAGE if cfg.chroma == "gray" else RGB


@functools.lru_cache(maxsize=None)
def _container(case: str) -> bytes:
    """The port's unsharded CPU container of a DECODE case."""
    cfg = CodecConfig(**DECODE[case])
    return codec.encode(_src(cfg), cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _damaged(chroma: str) -> list[bytes]:
    """40 damaged copies of the port's unsharded CPU container of a
    DAMAGED case."""
    cfg = CodecConfig(**DAMAGED[chroma])
    return testing.damaged_containers(codec.encode(_src(cfg), cfg,
                                                   device="cpu"),
                                      np.random.default_rng(7), 40)


def _jobs(shape) -> list:
    jobs = [(f"enc_{case}", se.encode_image_sharded,
             (_src(CodecConfig(**kw)), CodecConfig(**kw)), {})
            for case, kw in ENCODE.items()]
    jobs += [(f"dec_{case}", se.decode_image_sharded, (_container(case),),
              {}) for case in DECODE]
    jobs += [(f"damaged_{chroma}", testing.sharded_decode_fates,
              (_damaged(chroma),), {}) for chroma in DAMAGED]
    jobs += [
        ("batch", se.encode_batch_step, (BATCH, BATCH_CFG, 8), {}),
        ("offsets", testing.rank_byte_offsets, (BITS,), {}),
        ("hist", testing.rank_histograms, (HIST_VALUES, HIST_LIVE,
                                           HIST_RUNS), {}),
        ("shapes", testing.mesh_shapes, (MESH_SIZES,), {}),
    ]
    if shape[1] > 1:  # 9 stripes over the stripe axis must raise
        jobs.append(("batch_bad", testing.value_error,
                     (se.encode_batch_step, BATCH, BATCH_CFG, 9), {}))
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
                    shape[0] * shape[1], shape, _jobs(shape),
                    tmp_path_factory.mktemp("mesh"))
            except Exception as e:
                cache[shape] = e
        if isinstance(cache[shape], Exception):
            raise cache[shape]
        return cache[shape]

    return get


def _values(ranks, shape, name):
    return [r[name]["value"] for r in ranks(shape)]


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshlib.make_mesh()


def test_a_failed_rank_ends_the_call_at_once(tmp_path):
    """Rank 1 raises while rank 0 waits for it in a collective: the call
    fails well before its timeout, the waiting rank killed."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank exit codes"):
        testing.run_mesh_jobs(2, (1, 2), [
            ("fail", testing.fail_on_rank, (1,), {})], tmp_path, timeout=120)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_shapes(ranks, shape):
    n = shape[0] * shape[1]
    want = [(1, n), (2, n // 2), (n, 1), f"mesh 3x{n // 3} != {n} ranks",
            f"mesh 2x3 != {n} ranks"]
    for got in _values(ranks, shape, "shapes"):
        assert got == want


@pytest.mark.parametrize("shape", MESHES)
def test_stripe_byte_offsets_are_the_plain_sum(ranks, shape):
    nbytes = (BITS.astype(np.int64) + 7) // 8
    want = np.cumsum(nbytes) - nbytes
    k = len(BITS) // shape[1]
    for r in ranks(shape):
        s = r["offsets"]["coordinate"][1]
        np.testing.assert_array_equal(r["offsets"]["value"],
                                      want[s * k:(s + 1) * k])


@pytest.mark.parametrize("shape", MESHES)
def test_global_histograms_are_the_plain_sums(ranks, shape):
    from dct_tpu_torch.ops import huffman as hf

    v, live, runs = (torch.from_numpy(a) for a in (HIST_VALUES, HIST_LIVE,
                                                   HIST_RUNS))
    want_cat = hf.category_histogram_masked(v, live).numpy()
    want_run = hf.run_histogram_masked(runs, live).numpy()
    for cat, run in _values(ranks, shape, "hist"):
        np.testing.assert_array_equal(cat, want_cat)
        np.testing.assert_array_equal(run, want_run)


@pytest.mark.parametrize("case", sorted(ENCODE))
@pytest.mark.parametrize("shape", MESHES)
def test_encode_equals_the_unsharded_port(ranks, shape, case):
    cfg = CodecConfig(**ENCODE[case])
    want = codec.encode(_src(cfg), cfg, device="cpu")
    for got in _values(ranks, shape, f"enc_{case}"):
        assert got == want


@pytest.mark.parametrize("case", JAX_CASES)
def test_encode_matches_the_jax_sharded_encode(ranks, case):
    """Against the JAX package's sharded encode on the same mesh shape:
    equal but for encode ties. A color container is held to the JAX
    sharded encode of the port's own planes (the two packages' RGB
    conversions differ at float64 near-ties, tests/test_torch_color.py)."""
    shape = JAX_MESH[case]
    cfg = RefConfig(**ENCODE[case])
    mesh = ref_meshlib.make_mesh(*shape,
                                 devices=jax.devices()[:shape[0] * shape[1]])
    src = _src(cfg)
    got = _values(ranks, shape, f"enc_{case}")[0]
    if cfg.chroma == "gray":
        planes = [src]
        want = ref_se.encode_image_sharded(src, cfg, mesh)
    else:
        planes = [p.numpy() for p in color._to_planes(torch.from_numpy(src),
                                                       cfg.chroma)]
        want = ref_cont.serialize(ref_cont.Container(
            config=cfg, width=src.shape[1], height=src.shape[0],
            planes=[ref_se.encode_plane_sharded(p, cfg, mesh, chroma=i > 0)
                    for i, p in enumerate(planes)]))
    if got != want:
        n_mis, n_bad = testing.plane_encode_mismatches(got, want, planes)
        assert n_bad == 0, f"{n_mis} mismatches, {n_bad} not ties"


@pytest.mark.parametrize("shape", MESHES)
def test_encode_collectives(ranks, shape):
    """A static plane gathers and reduces nothing before its bits; a
    dynamic plane all-reduces each histogram once over the stripe group,
    then gathers the bit lengths once, then the units, the variance codes
    (adaptive) and the block bits (the index)."""
    r0 = ranks(shape)[0]
    n_loc = -(-15 // shape[1])
    for case, hists in (("static", []), ("dynamic", [16]),
                        ("direct", [512]), ("none", []),
                        ("coded_runs_dc", [16, 65]),
                        ("adaptive", [16]), ("decode_index", [16])):
        calls = r0[f"enc_{case}"]["collectives"]
        reduces = [c for c in calls if c[0] == "all_reduce"]
        gathers = [c for c in calls if c[0] == "all_gather"]
        assert reduces == [("all_reduce", meshlib.STRIPE_AXIS, "torch.int32",
                            (n,)) for n in hists], case
        assert calls[:len(reduces)] == reduces, case
        assert gathers[0] == ("all_gather", "torch.int32", (n_loc,)), case
        assert gathers[1][1:] == ("torch.int32", (n_loc, 1024)), case
        cfg = CodecConfig(**ENCODE[case])
        assert len(gathers) == 2 + bool(cfg.adaptive) + bool(
            cfg.decode_index), case


@pytest.mark.parametrize("shape", MESHES)
def test_batch_step_equals_encode_step(ranks, shape):
    """Each rank's packed stripes are codec.encode_step's for its frames
    and stripes, and the step calls no collective."""
    packed, _, _ = codec.encode_step(torch.from_numpy(BATCH), BATCH_CFG, 8)
    want = bs.fetch_packed(packed)
    f_loc, s_loc = 4 // shape[0], 8 // shape[1]
    for r in ranks(shape):
        got = r["batch"]["value"]
        assert r["batch"]["collectives"] == []
        d, s = r["batch"]["coordinate"]
        assert got.bit_lengths.shape == (f_loc, s_loc)
        for i in range(f_loc):
            f = d * f_loc + i
            sl = slice(s * s_loc, (s + 1) * s_loc)
            np.testing.assert_array_equal(got.bit_lengths[i],
                                          want.bit_lengths[f, sl])
            assert bs.stripes_to_bytes(bs.PackedStripes(
                got.units[i], got.bit_lengths[i])) == bs.stripes_to_bytes(
                bs.PackedStripes(want.units[f, sl], want.bit_lengths[f, sl]))


@pytest.mark.parametrize("shape", [m for m in MESHES if m[1] > 1])
def test_batch_step_needs_stripes_that_divide(ranks, shape):
    for got in _values(ranks, shape, "batch_bad"):
        assert f"must divide over the {shape[1]}-rank stripe axis" in got


@pytest.mark.parametrize("case", sorted(DECODE))
@pytest.mark.parametrize("shape", MESHES)
def test_decode_equals_the_unsharded_port(ranks, shape, case):
    """Every rank holds the whole image; one all-reduce of the ranks'
    failures, then each plane is assembled by one all-gather of the
    ranks' row bands, and nothing else crosses ranks."""
    data = _container(case)
    want = codec.decode(data, device="cpu")
    n_planes = len(cont.deserialize(data).planes)
    for r in ranks(shape):
        np.testing.assert_array_equal(r[f"dec_{case}"]["value"], want)
        calls = r[f"dec_{case}"]["collectives"]
        assert [c[:2] for c in calls] == [
            ("all_reduce", meshlib.STRIPE_AXIS)] + [
            ("all_gather", "torch.uint8")] * n_planes


@pytest.mark.parametrize("chroma", sorted(DAMAGED))
@pytest.mark.parametrize("shape", MESHES)
def test_damaged_decode_has_the_unsharded_fate(ranks, shape, chroma):
    """Damaged v2 containers: every rank's sharded decode gives the
    unsharded port's pixels, or raises ValueError where it raises (a
    rank whose stripes decode well raises too, and none is left waiting
    in a gather)."""
    fates = {"ok": 0, "ValueError": 0}
    for k, m in enumerate(_damaged(chroma)):
        want = testing.decode_fate(lambda: codec.decode(m, device="cpu"))
        fates[want[0]] += 1
        for r in ranks(shape):
            got = r[f"damaged_{chroma}"]["value"][k]
            assert got[0] == want[0], (k, got[1], want[1])
            if want[0] == "ok":
                np.testing.assert_array_equal(got[1], want[1])
    assert fates["ok"] > 0 and fates["ValueError"] > 0


def test_cpu_ranks_launch_no_kernel(ranks):
    for r in ranks(MESHES[0]):
        for name, res in r.items():
            assert sum(res["launches"].values()) == 0, name
