"""The port's CUDA kernels (A: encode transform, B: fused stripe encode,
C: decode transform, D: entropy decode of indexed containers, E: chunk
packer) against their plain PyTorch versions, and the codecs on the card
against the CPU path.

These need an NVIDIA GPU and skip without one; run them on the card with
``python -m pytest --noconftest tests/test_torch_kernels.py -q`` (the
suite's conftest.py imports jax). Shapes are small; the full-size
comparison at 8 x 1088 x 1920 is chip_smoke.py's.

Tolerances: kernel B is held bit-exact against the plain staged pipeline
fed kernel A's integers (A and B share one tensor-core tile, whose
integers are the float32 chain's at every n2; the tile's integer products
are held equal to int64 products first),
in every mode at 4x4, 8x8 and 16x16 blocks, on a stripe wider than
shared memory could hold, on stripes of 1-300 blocks around its tile and
round edges, on more stripes than its persistent grid has CTAs and on the
densest stream real pixels give (testing.densest_stream): the whole unit
buffer, its rescue count A's. A and C are held bit-exact against the float32
chains they promise (dct_tpu_torch.testing encode_fma_chain /
decode_fma_chain), at every block count, A at 16x16 too; they sum their
float32 products in another order than the plain version's matrix
product, so against it their integers may differ at ties only: at most 1
apart, where the float64 value lies within 1e-6 (encode,
tests/test_parity.py's criterion) or 1e-3 (decode) of a .5 boundary. The
plain versions run on the card here with TF32 off, so their float32
products stay float32; 16x16 blocks, whose decode no kernel takes, are
decoded once more with TF32 on, which the codec's route must override. Kernel D
is held bit-exact against its plain version and the host decoder in every
mode, against its plain version on random bits under a random index (long
direct tables too), and against the coefficients on stripes whose width
its 32-block tiles do not divide and at n2 = 256; a payload that is not
16-byte aligned raises; the codec's indexed decode on the card gives
exactly the pixels of the host route on the same container. Kernel E is
held bit-exact (units and stripe bits) against its plain version, also on
rows of a chunk count not a multiple of 4, at tile boundaries and with the
capacity cut inside a tile and at its last unit, and the staged encode
path and the video codec on the card give the CPU path's bytes.

This file imports only the port: the machine with the card has no jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dct_tpu_torch import CodecConfig, native, tables, testing
from dct_tpu_torch import container as cont
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import _build, blocks, bitstream as bs, rle
from dct_tpu_torch.ops import entropy_decode as ed
from dct_tpu_torch.models import video
from dct_tpu_torch.ops import entropy_decode_cuda, fused_encode_cuda, pack_cuda
from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.ops import transform, transform_cuda
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


@pytest.fixture(scope="module")
def image():
    return image_io.synthetic_image(72, 136, "photo", seed=11)


def _blocks_and_scale(image, cfg, device):
    img = codec.pad_plane_for_encode(torch.from_numpy(image), cfg)
    px = blocks.image_to_blocks(img, cfg.block_size).to(device)
    _, scale = codec._adaptive(px, cfg)
    return px, scale


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("adaptive", (False, True))
def test_encode_and_decode_kernels_match_plain(cuda, image, n, adaptive):
    cfg = CodecConfig(block_size=n, quality=50, adaptive=adaptive)
    px, scale = _blocks_and_scale(image, cfg, cuda)
    ops_d, ops_h = tables.build(cfg, device=cuda), tables.build(cfg)
    scale_h = None if scale is None else scale.cpu()
    got = transform_cuda.encode_blocks_kernel(px, cfg, ops_d, scale).cpu()
    want = transform.encode_blocks(px.cpu(), cfg, ops_h, scale_h)
    recip = None if scale is None else transform.reciprocal_scale(scale_h)
    vals = testing.encode_values_f64(px.cpu().numpy(), cfg, recip)
    n_mis, n_bad = testing.tie_mismatches(got, want, vals,
                                          testing.ENCODE_TIE_TOL)
    assert n_bad == 0 and n_mis <= got.numel() // 1000

    dec = transform_cuda.decode_blocks_kernel(want.to(cuda), cfg, ops_d, scale)
    ref = transform.decode_blocks(want, cfg, ops_h, scale_h)
    dvals = testing.decode_values_f64(
        want.numpy(), cfg, None if scale_h is None else scale_h.numpy())
    n_mis, n_bad = testing.tie_mismatches(dec.cpu(), ref, dvals,
                                          testing.DECODE_TIE_TOL)
    assert n_bad == 0 and n_mis <= ref.numel() // 1000


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("adaptive", (False, True))
def test_transform_kernels_equal_the_fma_chains(cuda, image, n, adaptive):
    cfg = CodecConfig(block_size=n, quality=50, adaptive=adaptive)
    px, scale = _blocks_and_scale(image, cfg, cuda)
    px = px.reshape(-1, cfg.n2)
    ops_d, ops_h = tables.build(cfg, device=cuda), tables.build(cfg)
    scale_h = None if scale is None else scale.cpu()
    recip = None if scale is None else transform.reciprocal_scale(scale_h)
    got = transform_cuda.encode_blocks_kernel(px, cfg, ops_d, scale)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        testing.encode_fma_chain(px.cpu(), cfg, ops_h, recip).numpy())
    dec = transform_cuda.decode_blocks_kernel(got, cfg, ops_d, scale)
    np.testing.assert_array_equal(
        dec.cpu().numpy(),
        testing.decode_fma_chain(got.cpu(), cfg, ops_h, scale_h).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("n_blocks", (0, 1, 4099, 40003))
def test_transform_kernels_on_ragged_batches(cuda, n, n_blocks):
    """Block counts that fill no tile (0, 1), end in a part tile (4099 is
    no multiple of any tile or micro-tile), and hand every CTA several
    tiles (40003 at n2 = 64); the input starts one block into its buffer,
    which at n2 = 4 is off the 16-byte grid of the kernels' copies."""
    cfg = CodecConfig(block_size=n, quality=70, adaptive=True)
    rng = np.random.default_rng(n_blocks + n)
    buf = torch.from_numpy(rng.integers(0, 256, (n_blocks + 1, cfg.n2),
                                        dtype=np.uint8))
    px = buf.to(cuda)[1:]
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, n_blocks).astype(
        np.float32))
    ops_d, ops_h = tables.build(cfg, device=cuda), tables.build(cfg)
    before = dict(_build.LAUNCHES)
    got = transform_cuda.encode_blocks_kernel(px, cfg, ops_d, scale.to(cuda))
    dec = transform_cuda.decode_blocks_kernel(got, cfg, ops_d, scale.to(cuda))
    torch.cuda.synchronize()
    launched = int(n_blocks > 0)
    for k in ("encode_blocks", "decode_blocks"):
        assert _build.LAUNCHES[k] == before[k] + launched
    assert got.shape == dec.shape == (n_blocks, cfg.n2)
    want = testing.encode_fma_chain(buf[1:], cfg, ops_h,
                                    transform.reciprocal_scale(scale))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(
        dec.cpu().numpy(),
        testing.decode_fma_chain(want, cfg, ops_h, scale).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", (0, 1, 4099, 40003))
def test_encode_kernel_256_on_ragged_batches(cuda, n_blocks):
    """Kernel A at 16x16 blocks (kernel B's tile, the byte planes read
    through L2): bit-exact against encode_fma_chain's n2 = 256 chain on
    block counts that fill no tile, end in a part tile and give every CTA
    several tiles, from an input one block into its buffer."""
    cfg = CodecConfig(block_size=16, quality=70, adaptive=True)
    rng = np.random.default_rng(n_blocks)
    buf = torch.from_numpy(rng.integers(0, 256, (n_blocks + 1, 256),
                                        dtype=np.uint8))
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, n_blocks).astype(
        np.float32))
    before = _build.LAUNCHES["encode_blocks"]
    got = transform_cuda.encode_blocks_kernel(
        buf.to(cuda)[1:], cfg, tables.build(cfg, device=cuda), scale.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["encode_blocks"] == before + int(n_blocks > 0)
    assert got.shape == (n_blocks, 256) and got.dtype == torch.int32
    want = testing.encode_fma_chain(buf[1:], cfg, tables.build(cfg),
                                    transform.reciprocal_scale(scale))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 4, 8, 16))
def test_tile_products_equal_int64_matmul(cuda, n):
    """The tensor-core tile's integer products (four byte-plane mma
    products combined in int64) equal x @ W in int64 on random packed rows,
    the all-255 row and a row count that ends in a part tile, before
    kernels A and B rely on them."""
    cfg = CodecConfig(block_size=n, quality=4)  # the widest columns
    ops = tables.build(cfg, device=cuda)
    p = tables.mma_width(cfg.n2)
    w, _ = tables.certificate_operator(*(m[:cfg.n2, :cfg.n2].cpu().numpy()
                                         for m in (ops.m0, ops.m1, ops.m2)))
    w_bd = torch.block_diag(*[torch.from_numpy(w)] * (p // cfg.n2))
    rows = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, (1000, p), dtype=np.uint8))
    rows[0] = 255
    got = transform_cuda.mma_products(rows.to(cuda), ops, cfg.n2)
    assert torch.equal(got.cpu(), rows.to(torch.int64) @ w_bd)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (4, 8, 16))
def test_rescue_counts_of_a_and_b_agree(cuda, image, n):
    """Kernels A and B run one tile function: on the same blocks they
    rescue the same coefficients, as many as the CPU emulation of the
    certificate leaves open, and both give the chain's integers."""
    cfg = CodecConfig(block_size=n, quality=100, adaptive=True)
    px, scale = _blocks_and_scale(image, cfg, cuda)
    px = px.reshape(-1, cfg.n2)
    ops = tables.build(cfg, device=cuda)
    n_stripes = codec._padded_grid(*image.shape, cfg)[2]
    _build.reset_rescued()
    got = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
    fused_encode_cuda.encode_stripes_fused(
        px, cfg, n_stripes, ops,
        adaptive_recip=transform.reciprocal_scale(scale))
    ops_h = tables.build(cfg)
    recip = transform.reciprocal_scale(scale.cpu())
    want, rescued = testing.encode_certified(px.cpu(), cfg, ops_h, recip)
    assert torch.equal(got.cpu(), want)
    assert _build.rescued("encode_blocks") == int(rescued.sum()) > 0
    assert _build.rescued("encode_stripes") == int(rescued.sum())


CERT_CASES = {  # name: (CodecConfig keywords, chroma operator, densest)
    "n8_static_q50": (dict(quality=50, static_tables=True), False, False),
    "n8_static_q100": (dict(quality=100, static_tables=True), False, False),
    "n16_adaptive_q50": (dict(block_size=16, quality=50, adaptive=True),
                         False, False),
    "n4_q50": (dict(block_size=4, quality=50), False, False),
    "n2_q100": (dict(block_size=2, quality=100), False, False),
    "n8_chroma_q90": (dict(quality=90), True, False),
    "n8_chroma_adaptive_q90": (dict(quality=90, adaptive=True), True, False),
    "n16_chroma_q100": (dict(block_size=16, quality=100), True, False),
    "n4_densest": (None, False, True),
    "n8_densest": (None, False, True),
    "n16_densest": (None, False, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CERT_CASES))
def test_certified_transform_on_cuda_equals_the_cpu_model(cuda, image, case):
    """Kernels A and B run the certificate of testing.certify: on the same
    blocks each one's rescue counter equals the number of coefficients the
    CPU model leaves open, A's integers are encode_certified's (the
    float32 chain's), and B's stripes are bit-exact against the staged
    pipeline fed A's integers (static q50 and q100, 16x16 adaptive, 4x4,
    the chroma operator, testing.densest_stream; 2x2 through A only)."""
    kw, chroma, densest = CERT_CASES[case]
    ops_cpu = None
    if densest:
        n = int(case[1:case.index("_")])
        cfg, img, table, run_table = testing.densest_stream(
            n, 6 * n, 40 * n, seed=n)
        ops = tables.build(cfg, device=cuda).with_tables(table, run_table)
    else:
        cfg, img = CodecConfig(**kw), image
        ops = tables.build(cfg, chroma=chroma, device=cuda)
    ops_cpu = tables.build(cfg, chroma=chroma)
    px, scale = _blocks_and_scale(img, cfg, cuda)
    px = px.reshape(-1, cfg.n2)
    recip = None if scale is None else transform.reciprocal_scale(scale)
    want, open_ = testing.encode_certified(
        px.cpu(), cfg, ops_cpu, None if recip is None else recip.cpu())
    _build.reset_rescued()
    got = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
    assert torch.equal(got.cpu(), want)
    assert _build.rescued("encode_blocks") == int(open_.sum())
    print(f"{case}: {int(open_.sum())} of {open_.numel()} coefficients "
          f"open ({100 * open_.double().mean().item():.4f} %)")
    if cfg.n2 in fused_encode_cuda.KERNEL_N2:
        n_stripes = 6 if densest else codec._padded_grid(*img.shape, cfg)[2]
        _stripe_check(cfg, px, scale, n_stripes, ops)
        assert _build.rescued("encode_stripes") == int(open_.sum())


@pytest.mark.cuda
def test_transform_kernels_refuse_what_they_do_not_take(cuda):
    """Kernel C takes no 16x16 blocks (the codec decodes them through the
    float32 product), and neither kernel a block size without a kernel."""
    cfg = CodecConfig(block_size=16)
    ops = tables.build(cfg, device=cuda)
    with pytest.raises(NotImplementedError):
        transform_cuda.decode_blocks_kernel(
            torch.zeros(4, 256, dtype=torch.int16, device=cuda), cfg, ops)
    cfg3 = CodecConfig(block_size=3)
    ops3 = tables.build(cfg3, device=cuda)
    with pytest.raises(NotImplementedError):
        transform_cuda.encode_blocks_kernel(
            torch.zeros(4, 9, dtype=torch.uint8, device=cuda), cfg3, ops3)


CASES_16 = {
    "v1_q50": dict(block_size=16, quality=50, decode_index=False),
    "v2_q90_index": dict(block_size=16, quality=90, decode_index=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES_16))
def test_16x16_codec_on_cuda_matches_cpu(cuda, image, case):
    """16x16 blocks encode on the card through kernels A (the analyze
    pass) and B, and decode through D where the container is indexed and
    the float32 product: no C or E launch."""
    cfg = CodecConfig(**CASES_16[case])
    gpu = codec.ImageCodec(cfg, device=cuda)
    _build.reset_launch_counts()
    data = gpu.encode(image)
    rec = gpu.decode_to_device(data)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    assert counts["encode_blocks"] == counts["encode_stripes"] == 1
    assert counts["decode_blocks"] == 0 and counts["pack_chunks"] == 0
    assert counts["entropy_decode"] == (1 if cfg.decode_index else 0)
    want = codec.ImageCodec(cfg, device="cpu").encode(image)
    assert data[4] == want[4] == (2 if cfg.decode_index else 1)
    if data != want:
        assert testing.encode_mismatches(data, want, image)[1] == 0
    assert rec.device.type == "cuda"
    ref = codec.ImageCodec(cfg, device="cpu").decode(data)
    assert testing.decode_mismatches(rec.cpu().numpy(), ref, data)[1] == 0


@pytest.mark.cuda
def test_16x16_route_pins_float32_under_tf32(cuda, image):
    """With the caller's TF32 switch on, the 16x16 encode and decode on
    the card still agree with the CPU path (TF32's 10-bit mantissa would
    move decoded pixels by several levels), and the switch is left on."""
    cfg = CodecConfig(**CASES_16["v2_q90_index"])
    want = codec.ImageCodec(cfg, device="cpu").encode(image)
    ref = codec.ImageCodec(cfg, device="cpu").decode(want)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gpu = codec.ImageCodec(cfg, device=cuda)
        data = gpu.encode(image)
        rec = gpu.decode(want)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if data != want:
        assert testing.encode_mismatches(data, want, image)[1] == 0
    assert testing.decode_mismatches(rec, ref, want)[1] == 0


@pytest.mark.cuda
def test_16x16_video_on_cuda_matches_cpu(cuda):
    cfg = CodecConfig(block_size=16, quality=50)
    frames = np.stack([image_io.synthetic_image(72, 136, "photo", seed=s)
                       for s in range(2)])
    _build.reset_launch_counts()
    streams = video.VideoCodec(cfg, device=cuda).encode(frames)
    rec = video.VideoCodec(cfg, device=cuda).decode(streams)
    assert _build.LAUNCHES["encode_blocks"] == 1  # one chunk: analyze + E
    assert _build.LAUNCHES["pack_chunks"] == 1
    assert _build.LAUNCHES["decode_blocks"] == 0
    want = video.VideoCodec(cfg, device="cpu").encode(frames)
    ref = video.VideoCodec(cfg, device="cpu").decode(streams)
    for f in range(2):
        if streams[f] != want[f]:
            assert testing.encode_mismatches(streams[f], want[f],
                                             frames[f])[1] == 0
        assert testing.decode_mismatches(rec[f], ref[f], streams[f])[1] == 0


STRIPE_CASES = {
    "static_q50": dict(quality=50, static_tables=True),
    "dynamic_q50": dict(quality=50),
    "q90_adaptive_dc_runs": dict(quality=90, adaptive=True,
                                 dc_prediction=True, coded_runs=True),
    "n4_category": dict(block_size=4),
    "n4_direct": dict(block_size=4, huffman_mode="direct"),
    "n4_none": dict(block_size=4, use_huffman=False),
    "direct_q90": dict(quality=90, huffman_mode="direct"),
    "none_q50": dict(use_huffman=False),
    "direct_adaptive_dc_runs": dict(quality=90, huffman_mode="direct",
                                    adaptive=True, dc_prediction=True,
                                    coded_runs=True),
    "n16_category_q90": dict(block_size=16, quality=90),
    "n16_direct": dict(block_size=16, huffman_mode="direct"),
    "n16_none": dict(block_size=16, use_huffman=False),
}


def _stripe_check(cfg, px, scale, n_stripes, ops):
    """Kernel B against the plain staged pipeline fed kernel A's integers:
    units (the whole buffer, zeros past each stripe's payload included),
    stripe bits and block bits exactly equal, and B's rescue count A's ->
    (the plain block bits, the fullest stripe's share of its worst-case
    buffer)."""
    _build.reset_rescued()
    recip = None if scale is None else transform.reciprocal_scale(scale)
    packed, bbits = fused_encode_cuda.encode_stripes_fused(
        px, cfg, n_stripes, ops, adaptive_recip=recip)
    zz = transform_cuda.encode_blocks_kernel(px, cfg, ops, scale)
    assert _build.rescued("encode_stripes") == _build.rescued("encode_blocks")
    if cfg.dc_prediction:
        zz = codec.dc_predict(zz, n_stripes)
    ref, ref_bbits = codec.encode_pack_plain(rle.rle_encode_positional(zz),
                                             cfg, n_stripes, ops)
    got_h, ref_h = bs.fetch_packed(packed), bs.fetch_packed(ref)
    np.testing.assert_array_equal(got_h.bit_lengths, ref_h.bit_lengths)
    np.testing.assert_array_equal(got_h.units, ref_h.units)
    np.testing.assert_array_equal(bbits.cpu(), ref_bbits.cpu())
    assert packed.units.shape == ref.units.shape
    np.testing.assert_array_equal(packed.units.cpu().to(torch.int32) & 0xFFFF,
                                  ref.units.cpu().to(torch.int32) & 0xFFFF)
    fill = got_h.bit_lengths.max() / (16 * packed.units.shape[1])
    return ref_bbits.cpu().numpy(), float(fill)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STRIPE_CASES))
def test_stripe_kernel_matches_staged_pipeline(cuda, image, case):
    cfg = CodecConfig(**STRIPE_CASES[case])
    px, scale = _blocks_and_scale(image, cfg, cuda)
    n_stripes = codec._padded_grid(*image.shape, cfg)[2]
    ops = tables.build(cfg, device=cuda)
    if not cfg.static_tables:  # per-image tables, as the codec builds them
        _, _, hist, run_hist = codec.encode_analyze(
            codec.pad_plane_for_encode(torch.from_numpy(image).to(cuda), cfg),
            cfg, ops)
        ops = ops.with_tables(codec._build_table(cfg, hist.cpu().numpy()),
                              codec._build_run_table(cfg, run_hist.cpu().numpy()))
    _stripe_check(cfg, px.reshape(-1, cfg.n2), scale, n_stripes, ops)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STRIPE_CASES))
def test_codec_on_cuda_matches_cpu(cuda, image, case):
    cfg = CodecConfig(**STRIPE_CASES[case])
    _build.reset_launch_counts()
    data = codec.ImageCodec(cfg, device=cuda).encode(image)
    want = codec.ImageCodec(cfg, device="cpu").encode(image)
    if data != want:  # 16x16: kernel A's chain against the CPU's product
        assert cfg.block_size == 16
        assert testing.encode_mismatches(data, want, image)[1] == 0
    rec = codec.ImageCodec(cfg, device=cuda).decode_to_device(data)
    assert rec.device.type == "cuda"
    ref = codec.ImageCodec(cfg, device="cpu").decode(data)
    assert np.abs(rec.cpu().numpy().astype(int) - ref).max() <= 1
    assert _build.LAUNCHES["encode_stripes"] == 1
    assert _build.LAUNCHES["encode_blocks"] == (0 if cfg.static_tables else 1)
    assert _build.LAUNCHES["pack_chunks"] == 0
    assert _build.LAUNCHES["decode_blocks"] == (0 if cfg.n2 == 256 else 1)


@pytest.mark.cuda
def test_encode_step_frames_on_cuda(cuda):
    cfg = CodecConfig(quality=50, static_tables=True)
    frames = np.stack([image_io.synthetic_image(64, 120, "photo", seed=s)
                       for s in range(3)])
    batch, _, bb = codec.encode_step(torch.from_numpy(frames).to(cuda), cfg, 8)
    for f in range(3):
        one, _, bb1 = codec.encode_step(torch.from_numpy(frames[f]).to(cuda),
                                        cfg, 8)
        a, b = bs.fetch_packed(one), bs.fetch_packed(
            bs.PackedStripes(batch.units[f], batch.bit_lengths[f]))
        np.testing.assert_array_equal(a.units, b.units)
        np.testing.assert_array_equal(bb1.cpu(), bb[f].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", (dict(block_size=2),
                                dict(block_size=2, use_huffman=False)))
def test_stripe_kernel_refuses_what_it_does_not_cover(cuda, kw):
    """2x2 blocks (n2 = 4): no B config in the reference either."""
    cfg = CodecConfig(static_tables=False, **kw)
    px = torch.zeros(16, cfg.n2, dtype=torch.uint8, device=cuda)
    with pytest.raises(NotImplementedError):
        fused_encode_cuda.encode_stripes_fused(
            px, cfg, 2, tables.build(cfg, device=cuda))


@pytest.mark.cuda
def test_container_of_1080p_frame_is_v1_at_q50(cuda):
    img = image_io.synthetic_image(1080, 1920, "photo", seed=7)
    data = codec.ImageCodec(CodecConfig(quality=50, static_tables=True),
                            device=cuda).encode(img)
    assert cont.deserialize(data).planes[0].block_bits is None


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", (4, 8, 16))
def test_stripe_wider_than_shared_memory_encodes(cuda, block_size):
    """Two stripes of 1,201 blocks each (at 8x8 ~290 KB of pixels,
    operators and coefficients, more than a CTA's shared memory): kernel
    B walks them in tiles, the last one part-filled (an odd count, so at
    4x4 the last warp holds one block)."""
    cfg = CodecConfig(block_size=block_size, quality=80, static_tables=True,
                      dc_prediction=True)
    img = image_io.synthetic_image(2 * block_size, 1201 * block_size,
                                   "photo", seed=4)
    px, _ = _blocks_and_scale(img, cfg, cuda)
    _stripe_check(cfg, px.reshape(-1, cfg.n2), None, 2,
                  tables.build(cfg, device=cuda))


SEAM_WIDTHS = (1, 127, 128, 129, 257, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("width", SEAM_WIDTHS)
@pytest.mark.parametrize("block_size", (4, 8, 16))
def test_stripe_kernel_at_tile_and_round_edges(cuda, block_size, width):
    """Stripes of 1 to 300 blocks around kernel B's tiles (256, 128, 64
    blocks at 4x4, 8x8, 16x16) and entropy rounds (256, 64, 32), with
    adaptive quantization, DC prediction carried across the edges and, at
    n2 <= 64, coded runs. Where a stripe spans several tiles, some stripe's
    bits before a tile edge must end inside a word, so the word carried
    across the edge is exercised."""
    cfg = CodecConfig(block_size=block_size, quality=80, static_tables=True,
                      adaptive=True, dc_prediction=True,
                      coded_runs=block_size <= 8)
    img = image_io.synthetic_image(3 * block_size, width * block_size,
                                   "photo", seed=width)
    px, scale = _blocks_and_scale(img, cfg, cuda)
    bbits, _ = _stripe_check(cfg, px.reshape(-1, cfg.n2), scale, 3,
                             tables.build(cfg, device=cuda))
    tile = fused_encode_cuda.TILE_BLOCKS[cfg.n2]
    if width > tile:
        assert (bbits[:, :tile].sum(axis=1) % 32 != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", (4, 8, 16))
def test_stripe_kernel_with_more_stripes_than_its_grid(cuda, block_size):
    """Three times as many stripes (of 5 blocks) as the persistent grid has
    CTAs, plus 7: each CTA walks several stripes, the next stripe's pixels
    copied in during the last tile of the one before."""
    cfg = CodecConfig(block_size=block_size, quality=70, static_tables=True,
                      dc_prediction=True)
    info = fused_encode_cuda.kernel_info(cfg.n2, cuda)
    n_stripes = 3 * info["sms"] * info["ctas_per_sm"] + 7
    img = image_io.synthetic_image(n_stripes * block_size, 5 * block_size,
                                   "photo", seed=block_size)
    px, _ = _blocks_and_scale(img, cfg, cuda)
    _stripe_check(cfg, px.reshape(-1, cfg.n2), None, n_stripes,
                  tables.build(cfg, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", (4, 8, 16))
def test_stripe_kernel_on_the_densest_stream(cuda, block_size):
    """testing.densest_stream: q100 noise in direct mode with every code
    16 bits long (coded runs at n2 <= 64), the densest stream real pixels
    give, near kernel B's worst-case staging."""
    cfg, img, table, run_table = testing.densest_stream(
        block_size, 6 * block_size, 300 * block_size, seed=block_size)
    ops = tables.build(cfg, device=cuda).with_tables(table, run_table)
    px, _ = _blocks_and_scale(img, cfg, cuda)
    _, fill = _stripe_check(cfg, px.reshape(-1, cfg.n2), None, 6, ops)
    print(f"densest stream {block_size}x{block_size}: the fullest stripe "
          f"fills {100 * fill:.1f} % of its worst-case buffer")
    assert fill > 0.6


def _plane_check(cfg, plane, n_stripes, ops, scale=None):
    """Kernel B from the padded plane(s) against B from their blocks (the
    whole unit buffer, stripe bits, block bits), both against the plain
    staged pipeline (_stripe_check), and both rescue counts against the
    CPU model of the certificate (testing.certify) on the same blocks."""
    px = blocks.image_to_blocks(plane, cfg.block_size).reshape(-1, cfg.n2)
    recip = None if scale is None else transform.reciprocal_scale(scale)
    _build.reset_rescued()
    got, got_bb = fused_encode_cuda.encode_plane_stripes_fused(
        plane, cfg, n_stripes, ops, adaptive_recip=recip)
    from_plane = _build.rescued("encode_stripes")
    _build.reset_rescued()
    want, want_bb = fused_encode_cuda.encode_stripes_fused(
        px, cfg, n_stripes, ops, adaptive_recip=recip)
    from_blocks = _build.rescued("encode_stripes")
    assert torch.equal(got.units, want.units)
    assert torch.equal(got.bit_lengths, want.bit_lengths)
    assert torch.equal(got_bb, want_bb)
    _, ok = testing.certify(testing.certified_products(px, cfg, ops),
                            ops.int_cert[:cfg.n2], recip)
    assert from_plane == from_blocks == int((~ok).sum())
    _stripe_check(cfg, px, scale, n_stripes, ops)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STRIPE_CASES))
def test_stripe_kernel_from_the_plane(cuda, image, case):
    """Kernel B reading the padded plane equals B on its blocks and the
    staged pipeline, in every mode and block size (coded runs, adaptive
    quantization and DC prediction among them), on two frames at once."""
    cfg = CodecConfig(**STRIPE_CASES[case])
    frames = np.stack([image, image[:, ::-1]])
    plane = codec.pad_plane_for_encode(torch.from_numpy(frames).to(cuda), cfg)
    n_stripes = 2 * codec._padded_grid(*image.shape, cfg)[2]
    px = blocks.image_to_blocks(plane, cfg.block_size).reshape(-1, cfg.n2)
    _, scale = codec._adaptive(px, cfg)
    ops = tables.build(cfg, device=cuda)
    if not cfg.static_tables:  # the batch's own tables
        _, _, hist, run_hist = codec.encode_analyze(plane, cfg, ops)
        ops = ops.with_tables(codec._build_table(cfg, hist.cpu().numpy()),
                              codec._build_run_table(cfg, run_hist.cpu().numpy()))
    _plane_check(cfg, plane, n_stripes, ops, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (-1, 0, 1))
@pytest.mark.parametrize("stripe_rows", (1, 2))
@pytest.mark.parametrize("block_size", (4, 8, 16))
def test_stripe_kernel_from_the_plane_at_tile_edges(cuda, block_size,
                                                    stripe_rows, offset):
    """Stripes of TILE_BLOCKS[n2] - 1, + 0 and + 1 blocks (in one block row,
    or split over two), read from a plane whose row is no multiple of 16
    bytes where the block size allows, with adaptive quantization, DC
    prediction carried across tiles and, at n2 <= 64, coded runs; 3
    stripes, far fewer than the grid's CTAs."""
    cfg = CodecConfig(block_size=block_size, quality=85, static_tables=True,
                      adaptive=True, dc_prediction=True,
                      coded_runs=block_size <= 8, stripe_rows=stripe_rows)
    bps = fused_encode_cuda.TILE_BLOCKS[cfg.n2] + offset
    bps += bps % stripe_rows  # whole block rows a stripe
    width = bps // stripe_rows * block_size
    img = image_io.synthetic_image(3 * stripe_rows * block_size, width,
                                   "photo", seed=bps + stripe_rows)
    plane = torch.from_numpy(img).to(cuda)
    px = blocks.image_to_blocks(plane, block_size).reshape(-1, cfg.n2)
    _, scale = codec._adaptive(px, cfg)
    _plane_check(cfg, plane, 3, tables.build(cfg, device=cuda), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", (4, 8, 16))
def test_stripe_kernel_on_one_short_stripe(cuda, block_size):
    """One stripe of 5 blocks: a grid of one CTA, one tile shorter than a
    round."""
    cfg = CodecConfig(block_size=block_size, quality=60, static_tables=True,
                      dc_prediction=True)
    img = image_io.synthetic_image(block_size, 5 * block_size, "photo",
                                   seed=block_size)
    _plane_check(cfg, torch.from_numpy(img).to(cuda), 1,
                 tables.build(cfg, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", (4, 8, 16))
def test_stripe_kernel_from_the_plane_on_the_densest_stream(cuda, block_size):
    """testing.densest_stream read from the plane: B's fullest staging."""
    cfg, img, table, run_table = testing.densest_stream(
        block_size, 6 * block_size, 300 * block_size, seed=block_size)
    ops = tables.build(cfg, device=cuda).with_tables(table, run_table)
    _plane_check(cfg, torch.from_numpy(img).to(cuda), 6, ops)


@pytest.mark.cuda
def test_stripe_kernel_launch_shape(cuda):
    """B's launch shape: no spilled registers, at least one CTA an SM, the
    tile TILE_BLOCKS names, at every n2."""
    for n2 in fused_encode_cuda.KERNEL_N2:
        info = fused_encode_cuda.kernel_info(n2, cuda)
        assert info["local_bytes"] == 0 and info["ctas_per_sm"] >= 1
        assert info["tile_blocks"] == fused_encode_cuda.TILE_BLOCKS[n2]


DECODE_CASES = {
    "category_n8": dict(),
    "category_runs_n8": dict(coded_runs=True),
    "direct_n8": dict(huffman_mode="direct"),
    "direct_runs_n8": dict(huffman_mode="direct", coded_runs=True),
    "none_n8": dict(use_huffman=False),
    "none_runs_n8": dict(use_huffman=False, coded_runs=True),
    "category_runs_n4": dict(block_size=4, coded_runs=True),
    "direct_n4": dict(block_size=4, huffman_mode="direct"),
    "none_runs_n4": dict(block_size=4, use_huffman=False, coded_runs=True),
    "category_n2": dict(block_size=2),
    "direct_n16": dict(block_size=16, huffman_mode="direct"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_entropy_decode_kernel_matches_plain(cuda, image, case):
    cfg = CodecConfig(quality=40, decode_index=True, **DECODE_CASES[case])
    px, _ = _blocks_and_scale(image, cfg, "cpu")
    zz = transform.encode_blocks(px, cfg, tables.build(cfg))
    n_stripes = -(-image.shape[0] // cfg.block_size)
    stripes, bits, table, run_table = testing.indexed_stream(zz, cfg,
                                                             n_stripes)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    args = (stripes, bits, table, run_table, mode, cfg.n2)
    before = _build.LAUNCHES["entropy_decode"]
    got = entropy_decode_cuda.decode_blocks_kernel(
        **codec.indexed_operands(*args, cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["entropy_decode"] == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int16
    want = ed.decode_blocks_plain(**codec.indexed_operands(*args, "cpu"))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(want.numpy(), zz.numpy())
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        native.unpack_stripes(stripes, len(bits) // n_stripes, cfg.n2, mode,
                              table, codec.DIRECT_VMIN, run_table=run_table))


def _random_coefficients(n_blocks, n2, seed):
    """Laplace-distributed zigzag coefficients, ~30 % nonzero, a few far
    outside the direct alphabet (ESC in direct mode)."""
    rng = np.random.default_rng(seed)
    zz = (rng.laplace(0, 4, (n_blocks, n2))
          * (rng.random((n_blocks, n2)) < 0.3)).astype(np.int32)
    zz[rng.integers(0, n_blocks, 5), rng.integers(0, n2, 5)] = 3000
    return torch.from_numpy(zz)


# blocks a stripe, block size, config: stripes whose width is not a multiple
# of a warp's 32 blocks or a CTA's 256 (a warp's 32 rows then straddle
# stripes; at 9 blocks a stripe, several), and n2 = 256, the largest tile
STAGED_STREAMS = {
    "bps9_category": (9, 8, dict()),
    "bps37_direct_runs": (37, 8, dict(huffman_mode="direct",
                                      coded_runs=True)),
    "bps300_none_runs": (300, 8, dict(use_huffman=False, coded_runs=True)),
    "bps45_n256_category": (45, 16, dict()),
    "bps45_n256_direct": (45, 16, dict(huffman_mode="direct")),
    "bps45_n256_none": (45, 16, dict(use_huffman=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STAGED_STREAMS))
def test_entropy_decode_kernel_on_ragged_stripes(cuda, case):
    """Kernel D against its plain version and the coefficients themselves
    on streams of 7 stripes whose width the kernel's tiles do not divide,
    and at n2 = 256."""
    bps, n, kw = STAGED_STREAMS[case]
    cfg = CodecConfig(block_size=n, decode_index=True, **kw)
    zz = _random_coefficients(7 * bps, cfg.n2, bps)
    stripes, bits, table, run_table = testing.indexed_stream(zz, cfg, 7)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    args = (stripes, bits, table, run_table, mode, cfg.n2)
    got = entropy_decode_cuda.decode_blocks_kernel(
        **codec.indexed_operands(*args, cuda))
    want = ed.decode_blocks_plain(**codec.indexed_operands(*args, "cpu"))
    np.testing.assert_array_equal(want.numpy(), zz.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# mode, alphabet size, coded runs, n2 of a random stream
RANDOM_STREAMS = {
    "category_runs_n64": ("category", 16, True, 64),
    "category_n16": ("category", 16, False, 16),
    "category_n4": ("category", 16, False, 4),
    "direct_n64": ("direct", 512, False, 64),
    # many codes longer than the kernel's lookahead tables: their values
    # are read from the direct table in device memory
    "direct_long_runs_n256": ("direct", 3000, True, 256),
    "direct_long_n64": ("direct", 3000, False, 64),
    "none_runs_n64": ("none", 0, True, 64),
}


def _random_stream(case):
    """(stripes, index, tables, mode, n2): random payload bytes under a
    random index, the last stripe cut short."""
    mode, n_alpha, coded_runs, n2 = RANDOM_STREAMS[case]
    rng = np.random.default_rng(5)
    table = (hf.CanonicalTable.from_frequencies(rng.integers(1, 1000, n_alpha))
             if n_alpha else None)
    short_runs = 1000 >> np.minimum(np.arange(hf.RUN_ALPHABET), 9)
    run_table = (hf.CanonicalTable.from_frequencies(
        short_runs + rng.integers(1, 4, hf.RUN_ALPHABET),
        max_len=hf.RUN_MAX_CODE_LEN) if coded_runs else None)
    bits = rng.integers(0, 600, (8, 40)).astype(np.uint16)
    stripes = [rng.bytes(-(-int(b) // 8)) for b in bits.sum(axis=1)]
    stripes[-1] = stripes[-1][: len(stripes[-1]) // 2]
    return stripes, bits.reshape(-1), table, run_table, mode, n2


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RANDOM_STREAMS))
def test_entropy_decode_kernel_matches_plain_on_random_bits(cuda, case):
    """Random payload bytes under a random index, the last stripe cut
    short: the kernel decodes whatever it is given exactly as the plain
    version does, and reads nothing past the payload."""
    args = _random_stream(case)
    got = entropy_decode_cuda.decode_blocks_kernel(
        **codec.indexed_operands(*args, cuda))
    want = ed.decode_blocks_plain(**codec.indexed_operands(*args, "cpu"))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def _d_with_status(args, dev):
    got = entropy_decode_cuda.decode_blocks_kernel(
        **codec.indexed_operands(*args, dev, status=True))
    return tuple(t.cpu().numpy() for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RANDOM_STREAMS))
def test_entropy_decode_status_matches_plain_on_random_bits(cuda, case):
    """Random bits contradict their index: the kernel's coefficients and
    per-stripe status equal the plain version's, and its coefficients do
    not depend on whether a status is handed in."""
    args = _random_stream(case)
    zz, status = _d_with_status(args, cuda)
    want_zz, want_status = _d_with_status(args, "cpu")
    np.testing.assert_array_equal(zz, want_zz)
    np.testing.assert_array_equal(status, want_status)
    assert status.shape == (len(args[0]),) and status.any()
    np.testing.assert_array_equal(
        entropy_decode_cuda.decode_blocks_kernel(
            **codec.indexed_operands(*args, cuda)).cpu().numpy(), zz)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STAGED_STREAMS))
def test_entropy_decode_status_on_damaged_stripes(cuda, case):
    """A clean stream's status is 0; with bytes of stripes 1 and 5
    scrambled, the kernel flags what the plain version flags (tiles that
    straddle stripes included) and decodes the same coefficients."""
    bps, n, kw = STAGED_STREAMS[case]
    cfg = CodecConfig(block_size=n, decode_index=True, **kw)
    zz = _random_coefficients(7 * bps, cfg.n2, bps)
    stripes, bits, table, run_table = testing.indexed_stream(zz, cfg, 7)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    clean = _d_with_status((stripes, bits, table, run_table, mode, cfg.n2),
                           cuda)
    assert not clean[1].any()
    np.testing.assert_array_equal(clean[0], zz.numpy())
    rng = np.random.default_rng(bps)
    for s in (1, 5):
        b = bytearray(stripes[s])
        at = rng.integers(0, len(b), 3)
        b[at[0]] ^= 0x40
        b[at[1]:at[1] + 2] = rng.bytes(len(b[at[1]:at[1] + 2]))
        stripes[s] = bytes(b)
    args = (stripes, bits, table, run_table, mode, cfg.n2)
    got, want = _d_with_status(args, cuda), _d_with_status(args, "cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].any() and not got[1][[0, 2, 3, 4, 6]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STRIPE_CASES))
def test_indexed_decode_on_cuda_equals_the_host_route(cuda, image, case):
    cfg = CodecConfig(decode_index=True, **STRIPE_CASES[case])
    data = codec.ImageCodec(cfg, device=cuda).encode(image)
    assert data[4] == 2
    _build.reset_launch_counts()
    rec = codec.ImageCodec(cfg, device=cuda).decode_to_device(data)
    assert rec.device.type == "cuda"
    assert _build.LAUNCHES["entropy_decode"] == 1
    assert _build.LAUNCHES["decode_blocks"] == (0 if cfg.n2 == 256 else 1)
    c = cont.deserialize(data)
    host = codec.decode_plane_device(
        dataclasses.replace(c.planes[0], block_bits=None), c.config, cuda)
    assert _build.LAUNCHES["entropy_decode"] == 1
    np.testing.assert_array_equal(rec.cpu().numpy(), host.cpu().numpy())


@pytest.mark.cuda
def test_entropy_decode_kernel_refuses_a_wrong_status(cuda):
    cfg = CodecConfig(decode_index=True)
    ops = codec.indexed_operands(
        *testing.indexed_stream(torch.zeros(16, 64, dtype=torch.int32), cfg,
                                2), "category", 64, cuda, status=True)
    with pytest.raises(ValueError, match="status has 1 entries"):
        entropy_decode_cuda.decode_blocks_kernel(
            **dict(ops, status=ops["status"][:1]))
    with pytest.raises(TypeError):
        entropy_decode_cuda.decode_blocks_kernel(
            **dict(ops, status=ops["status"].to(torch.int64)))
    with pytest.raises(ValueError):
        entropy_decode_cuda.decode_blocks_kernel(
            **dict(ops, status=ops["status"].cpu()))


@pytest.mark.cuda
def test_entropy_decode_kernel_refuses_what_it_does_not_take(cuda):
    cfg = CodecConfig(decode_index=True)
    zz = torch.zeros(16, 64, dtype=torch.int32)
    ops = codec.indexed_operands(*testing.indexed_stream(zz, cfg, 2),
                                   "category", 64, cuda)
    with pytest.raises(NotImplementedError):
        entropy_decode_cuda.decode_blocks_kernel(**dict(ops, n2=9))
    with pytest.raises(TypeError):
        entropy_decode_cuda.decode_blocks_kernel(
            **dict(ops, block_bits=ops["block_bits"].to(torch.int32)))
    with pytest.raises(TypeError):
        entropy_decode_cuda.decode_blocks_kernel(
            **dict(ops, block_bits=ops["block_bits"].reshape(-1)))
    with pytest.raises(ValueError):
        entropy_decode_cuda.decode_blocks_kernel(
            **dict(ops, stripe_start=ops["stripe_start"].cpu()))
    with pytest.raises(ValueError):
        entropy_decode_cuda.decode_blocks_kernel(
            **dict(ops, stripe_start=ops["stripe_start"][:1]))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (1, 4, 8))
def test_entropy_decode_kernel_refuses_an_unaligned_payload(cuda, offset):
    """The kernel reads the payload in aligned words: a view that does not
    start on 16 bytes raises, and the same bytes aligned decode."""
    cfg = CodecConfig(decode_index=True)
    ops = codec.indexed_operands(
        *testing.indexed_stream(_random_coefficients(32, 64, 1), cfg, 2),
        "category", 64, cuda)
    n = ops["payload"].numel()
    buf = torch.zeros(n + 32, dtype=torch.uint8, device=cuda)
    buf[offset:offset + n] = ops["payload"]
    assert buf.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="aligned"):
        entropy_decode_cuda.decode_blocks_kernel(
            **dict(ops, payload=buf[offset:offset + n]))
    buf[16:16 + n] = ops["payload"]
    np.testing.assert_array_equal(
        entropy_decode_cuda.decode_blocks_kernel(
            **dict(ops, payload=buf[16:16 + n])).cpu().numpy(),
        entropy_decode_cuda.decode_blocks_kernel(**ops).cpu().numpy())


def _pack_case(case):
    """(values, lengths, capacity) of a random chunk case: 60 % dead chunks
    (junk values), stripes live over uneven lengths, an all-dead stripe,
    and the case's own shape and capacity."""
    rng = np.random.default_rng(3)
    s, c = (6, 701) if case == "ragged_rows" else (24, 700)
    if case.startswith(("tile", "capacity")):
        s, c = 3, 1400  # 4,200 chunks a stripe: two tiles of 2,048 and a tail
    cl = rng.integers(1, 17, (s, c, 3))
    cl[rng.random(cl.shape) < 0.6] = 0
    for st in range(s):
        cl[st, c * (st + 1) // s:] = 0
    cl[0] = 0
    cap = c * 3
    if case == "full_and_past_capacity":
        cap = c * 3 - 7
        cl[1] = 16
        cl[2] = 0
        cl[2].reshape(-1)[:cap] = 16
    elif case.startswith(("tile", "capacity")):
        # stripe 1: 16-bit chunks, so a tile ends on a word exactly; stripe
        # 2: one bit fewer in the first tile, so a word straddles into the
        # second
        cl[1] = 16
        cl[2] = 16
        cl[2].reshape(-1)[5] = 15
        cap = {"capacity_inside_a_tile": 2048 + 1001,
               "capacity_at_a_tiles_last_unit": 2047,
               "capacity_after_a_tiles_last_unit": 2048}.get(case, c * 3)
    cv = rng.integers(0, 1 << 16, cl.shape)
    cv = np.where(cl > 0, cv & ((1 << cl) - 1), cv)
    return (*(torch.from_numpy(a).to(torch.int32) for a in (cv, cl)), cap)


# the worst-case capacity (every chunk fits) unless the name says else;
# "ragged_rows": 2,103 chunks a row, not a multiple of 4, so every other
# row starts off 16 bytes
PACK_CASES = ("worst_capacity", "full_and_past_capacity", "ragged_rows",
              "tile_boundary", "capacity_inside_a_tile",
              "capacity_at_a_tiles_last_unit",
              "capacity_after_a_tiles_last_unit")


@pytest.mark.cuda
@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_kernel_matches_plain(cuda, case):
    """Kernel E against its plain version, bit for bit (units and stripe
    bits), on random chunks."""
    cv_h, cl_h, cap = _pack_case(case)
    s = cv_h.shape[0]
    before = _build.LAUNCHES["pack_chunks"]
    got = pack_cuda.pack_chunks_kernel(cv_h.to(cuda), cl_h.to(cuda), cap)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pack_chunks"] == before + 1
    assert got.units.shape == (s, cap) and got.bit_lengths.dtype == torch.int32
    want = bs.pack_chunks(cv_h, cl_h, cap)
    np.testing.assert_array_equal(got.bit_lengths.cpu(), want.bit_lengths)
    np.testing.assert_array_equal(
        got.units.cpu().to(torch.int32) & 0xFFFF, want.units)


STAGED_CASES = {
    "n4_category": dict(block_size=4, quality=50),
    "n4_direct_runs": dict(block_size=4, huffman_mode="direct",
                           coded_runs=True),
    "n4_none": dict(block_size=4, use_huffman=False),
    "n8_direct_q90": dict(quality=90, huffman_mode="direct"),
    "n8_none_adaptive_dc": dict(use_huffman=False, adaptive=True,
                                dc_prediction=True),
    "n2_category_runs": dict(block_size=2, coded_runs=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_staged_pack_matches_plain_on_symbol_chunks(cuda, image, case):
    """Kernel E on the int32 chunks symbol_chunks gives, against the plain
    staged pipeline on the same card tensors."""
    cfg = CodecConfig(**STAGED_CASES[case])
    img = codec.pad_plane_for_encode(torch.from_numpy(image).to(cuda), cfg)
    ops = tables.build(cfg, device=cuda)
    sym, _, hist, run_hist = codec.encode_analyze(img, cfg, ops)
    ops = ops.with_tables(codec._build_table(cfg, hist.cpu().numpy()),
                          codec._build_run_table(cfg, run_hist.cpu().numpy()))
    n_stripes = img.shape[0] // cfg.block_size
    got, got_bb = codec.pack_frames(sym, cfg, (), n_stripes, ops)
    want, want_bb = codec.encode_pack_plain(sym, cfg, n_stripes, ops)
    g, w = bs.fetch_packed(got), bs.fetch_packed(want)
    np.testing.assert_array_equal(g.bit_lengths, w.bit_lengths)
    np.testing.assert_array_equal(g.units, w.units)
    np.testing.assert_array_equal(got_bb.cpu(), want_bb.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_staged_codec_on_cuda_matches_cpu(cuda, image, case):
    """The dynamic-table encodes: kernel A's analyze pass, then kernel B
    where it takes the config, else (2x2 blocks) kernel E."""
    cfg = CodecConfig(**STAGED_CASES[case])
    fused = codec.fused_kernel_ok(cfg)
    assert fused == (cfg.block_size != 2)
    _build.reset_launch_counts()
    data = codec.ImageCodec(cfg, device=cuda).encode(image)
    assert _build.LAUNCHES["pack_chunks"] == (0 if fused else 1)
    assert _build.LAUNCHES["encode_blocks"] == 1
    assert _build.LAUNCHES["encode_stripes"] == (1 if fused else 0)
    assert data == codec.ImageCodec(cfg, device="cpu").encode(image)
    rec = codec.ImageCodec(cfg, device=cuda).decode_to_device(data)
    assert rec.device.type == "cuda"
    ref = codec.ImageCodec(cfg, device="cpu").decode(data)
    assert np.abs(rec.cpu().numpy().astype(int) - ref).max() <= 1


@pytest.mark.cuda
def test_pack_kernel_refuses_what_it_does_not_take(cuda):
    cv = torch.zeros(2, 8, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pack_cuda.pack_chunks_kernel(cv.float(), cv, 64)
    with pytest.raises(TypeError):
        pack_cuda.pack_chunks_kernel(cv, cv.to(torch.int64), 64)
    with pytest.raises(ValueError):
        pack_cuda.pack_chunks_kernel(cv, cv.reshape(2, 24), 64)
    with pytest.raises(ValueError):
        pack_cuda.pack_chunks_kernel(cv, cv.transpose(0, 1), 64)
    with pytest.raises(ValueError):
        pack_cuda.pack_chunks_kernel(cv, cv.cpu(), 64)


VIDEO_CASES = {
    "dynamic_q50": dict(quality=50),
    "direct_q90": dict(quality=90, huffman_mode="direct"),
    "n4_adaptive_runs": dict(block_size=4, adaptive=True, coded_runs=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_frames", (None, 2))
@pytest.mark.parametrize("case", sorted(VIDEO_CASES))
def test_video_on_cuda_matches_cpu(cuda, case, chunk_frames):
    cfg = CodecConfig(**VIDEO_CASES[case])
    frames = np.stack([image_io.synthetic_image(72, 136, "photo", seed=s)
                       for s in range(5)])
    vc = video.VideoCodec(cfg, chunk_frames=chunk_frames, device=cuda)
    _build.reset_launch_counts()
    streams = vc.encode(frames)
    if chunk_frames is None:  # one chunk: one analyze, one pack
        assert _build.LAUNCHES["encode_blocks"] == 1
        assert _build.LAUNCHES["pack_chunks"] == 1
        assert _build.LAUNCHES["encode_stripes"] == 0
    assert streams == video.VideoCodec(cfg, chunk_frames=chunk_frames,
                                       device="cpu").encode(frames)
    _build.reset_launch_counts()
    rec = vc.decode_to_device(streams)
    assert rec.device.type == "cuda" and rec.shape == frames.shape
    n_chunks = 1 if chunk_frames is None else 3
    assert _build.LAUNCHES["decode_blocks"] == n_chunks
    ref = video.VideoCodec(cfg, device="cpu").decode(streams)
    assert np.abs(rec.cpu().numpy().astype(int) - ref).max() <= 1
    one = codec.ImageCodec(cfg, device=cuda)
    for f, data in enumerate(streams):
        np.testing.assert_array_equal(rec[f].cpu().numpy(), one.decode(data))
