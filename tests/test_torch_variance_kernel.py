"""The adaptive encode's variance kernel (csrc/fused_encode.cu,
ops/fused_encode_cuda.py plane_variance_codes) on the card against its
plain version, and kernel B's route through it.

The plain version runs on the CPU's copy of the planes: the kernel keeps
the CPU's float32 arithmetic, which tests/test_torch_variance_model.py
holds to ops/quant.py on every sum a 4x4 block can have. Codes must be
byte-equal and reciprocals bit-equal (int32 views), at 4x4, 8x8 and
16x16 blocks, on flat, busy and "photo" planes and on planes of blocks
built at the clamp edges (variance 100 and 1000) and at exact .5 ties of
the code's rounding; on one plane, odd plane counts, planes with two
leading axes, widths that are not a multiple of 16 and planes that are
not 16-byte aligned; on widths of whole 16-byte chunks and of ragged
ones; and on blocks whose code a multiply by float32(1 / 1000) would
round the other way. With dynamic tables the analyze pass (quant.py's
chain on the card) and the kernel give the CPU's codes on those blocks,
and the container decodes. An adaptive encode_step on the card makes one
variance launch and one kernel B launch a call, takes no reciprocal in
B's wrapper and gives the units, bit lengths and block bits of B fed the
op chain's scales; the variance pass allocates only its outputs, and its
span kernel.variance_codes sits inside codec.variance_codes.

These need an NVIDIA GPU and skip without one; run them on the card with
``python -m pytest --noconftest tests/test_torch_variance_kernel.py -q``.
This file imports only the port: the machine with the card has no jax.
"""

import numpy as np
import pytest
import torch

from dct_tpu_torch import CodecConfig, tables, testing
from dct_tpu_torch import container as cont
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import _build, blocks, fused_encode_cuda, transform
from dct_tpu_torch.utils import image_io, tracing

pytestmark = pytest.mark.cuda

K = testing.variance_kernel_constants()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def adaptive(n: int) -> CodecConfig:
    return CodecConfig(block_size=n, quality=50, static_tables=True,
                       adaptive=True)


def planes_of(kind: str, frames: int, h: int, w: int, n: int,
              seed: int) -> torch.Tensor:
    """(frames, h, w) u8 planes of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        p = np.broadcast_to(rng.integers(0, 256, (frames, 1, 1)),
                            (frames, h, w))
    elif kind == "busy":
        p = rng.integers(0, 256, (frames, h, w))
    elif kind == "photo":
        p = np.stack([image_io.synthetic_image(h, w, "photo", seed=seed + f)
                      for f in range(frames)])
    else:  # blocks built at the clamp edges and at ties, then shuffled;
        # "split": only blocks whose code a multiply by float32(1 / 1000)
        # rounds the other way
        n2 = n * n
        sums = [(n2 * m, n2 * (v + m * m)) for v in (100, 1000)
                for m in (0, -3, 7, 40)]
        sums += testing.variance_tie_sums(n2, K, 12, seed)
        if kind == "split":
            sums = testing.variance_split_sums(n2, 12, seed)
        built = np.stack([testing.block_with_sums(s1, s2, n2)
                          for s1, s2 in sums])
        nb = frames * (h // n) * (w // n)
        pick = built[rng.integers(0, len(built), nb)]
        return blocks.blocks_to_image(
            torch.from_numpy(pick).reshape(frames, -1, n2), h, w, n)
    return torch.from_numpy(np.ascontiguousarray(p, dtype=np.uint8))


def assert_kernel_equals_plain(planes: torch.Tensor, cfg: CodecConfig,
                               dev) -> torch.Tensor:
    _build.reset_launch_counts()
    codes, recip = fused_encode_cuda.plane_variance_codes(planes.to(dev), cfg)
    assert _build.LAUNCHES["variance_codes"] == 1
    want_codes, want_recip = fused_encode_cuda.variance_codes_plain(
        planes.cpu().contiguous(), cfg)
    assert codes.device.type == recip.device.type == "cuda"
    assert codes.shape == want_codes.shape and recip.shape == want_recip.shape
    assert torch.equal(codes.cpu(), want_codes)
    assert torch.equal(recip.cpu().view(torch.int32),
                       want_recip.view(torch.int32))
    return want_codes


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("kind", ["flat", "busy", "photo", "built", "split"])
@pytest.mark.parametrize("width", ["ragged", "whole"])
def test_the_kernel_equals_its_plain_version(cuda, n, kind, width):
    # 3 planes; "ragged" widths 252, 216 and 160 bytes (the kernel's 4-byte
    # loads but at 16x16), "whole" widths of 16-byte chunks (its 16-byte
    # loads and vector stores)
    w = {"ragged": {4: 28 * 9, 8: 72 * 3, 16: 80 * 2},
         "whole": {4: 16 * 4 * 5, 8: 16 * 8 * 3, 16: 16 * 16 * 2}}[width][n]
    codes = assert_kernel_equals_plain(planes_of(kind, 3, 6 * n, w, n, n),
                                       adaptive(n), cuda)
    if kind == "built":  # both clamps and the band between them
        assert codes.min() == 0 and codes.max() == 255
        assert ((codes > 0) & (codes < 255)).any()


@pytest.mark.parametrize("n", [4, 8, 16])
def test_the_kernel_on_ragged_shapes(cuda, n):
    cfg = adaptive(n)
    for lead, h, w in [((), 2 * n, n), ((1,), n, 3 * n), ((5,), 3 * n, 5 * n),
                       ((2, 3), 2 * n, 7 * n), ((3,), 4 * n, 121 * n)]:
        p = planes_of("photo", int(np.prod(lead)), h, w, n, 3)
        assert_kernel_equals_plain(p.reshape(*lead, h, w), cfg, cuda)
    # not 16-byte aligned, and not contiguous: the wrapper copies them
    p = planes_of("busy", 3, 2 * n, 4 * n, n, 4).to(cuda)
    buf = torch.empty(p.numel() + 1, dtype=torch.uint8, device=cuda)
    odd = buf[1:].view(p.shape)
    odd.copy_(p)
    assert odd.data_ptr() % 16
    assert_kernel_equals_plain(odd, cfg, cuda)
    assert_kernel_equals_plain(p.transpose(-1, -2)[..., :2 * n], cfg, cuda)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_adaptive_encode_step_runs_one_variance_pass_and_one_b(
        cuda, n, monkeypatch):
    """Three calls: one variance launch and one B launch each, no
    reciprocal taken in B's wrapper, and B's outputs those of B fed the
    op chain's scales (the route before the kernel)."""
    cfg = adaptive(n)
    planes = planes_of("photo", 3, 4 * n * 3, 16 * n, n, 5)
    n_stripes = planes.shape[-2] // n // cfg.stripe_rows
    planes_d = planes.to(cuda)
    real = transform.reciprocal_scale

    def refuse(*a, **k):
        raise AssertionError("B's wrapper took a reciprocal")

    monkeypatch.setattr(transform, "reciprocal_scale", refuse)
    _build.reset_launch_counts()
    for _ in range(3):
        packed, codes, bb = codec.encode_step(planes_d, cfg, n_stripes)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "variance_codes": 3, "encode_stripes": 3}
    monkeypatch.setattr(transform, "reciprocal_scale", real)
    want_codes, scale = codec._adaptive(blocks.image_to_blocks(planes, n),
                                        cfg)
    assert torch.equal(codes.cpu(), want_codes)
    ops = tables.build(cfg, device=cuda)
    want, want_bb = fused_encode_cuda.encode_plane_stripes_fused(
        planes_d, cfg, 3 * n_stripes, ops,
        adaptive_recip=transform.reciprocal_scale(scale.to(cuda)))
    assert torch.equal(packed.units.reshape(want.units.shape), want.units)
    assert torch.equal(packed.bit_lengths.reshape(-1), want.bit_lengths)
    assert bb is None or torch.equal(bb.reshape(want_bb.shape), want_bb)


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("mode", ["category", "direct"])
def test_dynamic_tables_analyze_and_encode_with_the_same_codes(cuda, n,
                                                               mode):
    """With dynamic tables the card builds the table from the analyze
    pass (the blocks route: quant.py's op chain on the card) and encodes
    with kernel B fed the variance kernel: on blocks whose code a
    multiply by float32(1 / 1000) would round the other way, both give
    the CPU's codes, so every symbol B writes is in the table, and the
    container decodes to the CPU container's coefficients."""
    cfg = CodecConfig(block_size=n, quality=50, adaptive=True,
                      huffman_mode=mode)
    img = planes_of("split", 1, 6 * n, 16 * n * 2, n, 9)[0]
    pad = codec.pad_plane_for_encode(img, cfg).to(cuda)
    _, analyzed, _, _ = codec.encode_analyze(
        pad, cfg, tables.build(cfg, device=cuda))
    fused, _ = fused_encode_cuda.plane_variance_codes(pad, cfg)
    want_codes, _ = codec._adaptive(blocks.image_to_blocks(pad.cpu(), n),
                                    cfg)
    assert torch.equal(analyzed.cpu(), want_codes)
    assert torch.equal(fused.cpu(), want_codes)
    _build.reset_launch_counts()
    data = codec.ImageCodec(cfg, device=cuda).encode(img.numpy())
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "encode_blocks": 1, "variance_codes": 1, "encode_stripes": 1}
    want = codec.ImageCodec(cfg, device="cpu").encode(img.numpy())
    assert np.array_equal(
        np.asarray(cont.deserialize(data).planes[0].variance_codes),
        np.asarray(cont.deserialize(want).planes[0].variance_codes))
    if data != want:
        assert testing.encode_mismatches(data, want, img.numpy())[1] == 0
    assert codec.decode(data, device="cpu").shape == img.shape


def test_the_variance_pass_allocates_only_its_outputs(cuda):
    planes = planes_of("photo", 8, 1088, 1920, 8, 6).to(cuda)
    cfg = adaptive(8)
    fused_encode_cuda.plane_variance_codes(planes, cfg)  # built, loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    codes, recip = fused_encode_cuda.plane_variance_codes(planes, cfg)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    outputs = codes.numel() + 4 * recip.numel()
    assert outputs <= extra <= outputs + 2 * 512
    assert extra < planes.numel() // 4  # no blocked or float32 copy


def test_the_kernel_span_sits_inside_the_variance_span(cuda):
    cfg = adaptive(8)
    planes = planes_of("photo", 2, 32, 64, 8, 7).to(cuda)
    tracing.reset_timings()
    tracing.enable()
    try:
        codec.encode_step(planes, cfg, 4)
        recs = tracing.records()
    finally:
        tracing.disable()
        tracing.reset_timings()
    parent = {r.name: None if r.parent is None else recs[r.parent].name
              for r in recs}
    assert parent == {"codec.encode_step": None,
                      "codec.variance_codes": "codec.encode_step",
                      "kernel.variance_codes": "codec.variance_codes",
                      "kernel.encode_stripes": "codec.encode_step"}
