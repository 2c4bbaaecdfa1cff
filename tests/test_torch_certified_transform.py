"""The integer form of the encode operator and the rounding certificate
that kernels A and B run on the tensor cores, through their plain torch
emulation (dct_tpu_torch.testing.encode_certified), on the CPU.

Each column of the bf16 split m0 + m1 + m2 is an int32 column W times a
power of two, so x @ W is an exact integer, and four byte planes of W
give it as u8 x u8 and u8 x s8 products. The certificate proves, per
coefficient, that the float32 chain the kernels promise
(testing.encode_fma_chain) rounds to round(Y*) for the float64 value Y*;
the coefficients it leaves open are rescued by the chain itself.
Tolerances: none. Every certified coefficient must equal the chain's
integer, and so must every rescued one; the mismatches between round(Y*)
and the chain must all lie in the rescued set. Against the JAX reference
the emulation differs at ties only (at most 1 apart, the float64 value
within 1e-6 of a .5 boundary, tests/test_parity.py's criterion), as the
chain does.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.ops import transform as ref_tf
from dct_tpu_torch import CodecConfig, tables, testing
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import blocks, transform
from dct_tpu_torch.utils import image_io

QUALITIES = (1, 4, 10, 50, 90, 97, 100)


@pytest.mark.parametrize("chroma", (False, True))
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("n", (2, 4, 8, 16))
def test_integer_operator_is_the_split_exactly(n, quality, chroma):
    """W 2^-e == m0 + m1 + m2 exactly (each part integral at e, the parts'
    integers summing to W), which is the float32 operator itself; |W| <
    2^31; the four byte planes reassemble W."""
    cfg = CodecConfig(block_size=n, quality=quality)
    m0, m1, m2, _ = tables.encode_operator_split(cfg, chroma=chroma)
    w, e = tables.integer_operator(m0, m1, m2)
    assert w.shape == m0.shape and e.shape == (cfg.n2,)
    total = np.zeros(w.shape, np.int64)
    for m in (m0, m1, m2):
        scaled = np.ldexp(np.asarray(m, np.float64), e[None, :])
        assert np.array_equal(scaled, np.floor(scaled))
        total += scaled.astype(np.int64)
    np.testing.assert_array_equal(total, w)
    m_enc, _ = tables.fused_encode_operator(cfg, chroma=chroma)
    np.testing.assert_array_equal(
        np.ldexp(w.astype(np.float64), -e[None, :]),
        np.asarray(m_enc, np.float32).astype(np.float64))
    k = int(np.argmax(np.abs(w).max(axis=0)))  # one column, as fractions
    for j in range(0, cfg.n2, 7):
        assert Fraction(int(w[j, k]), 2 ** int(e[k])) == sum(
            Fraction(float(m[j, k])) for m in (m0, m1, m2))
    assert np.abs(w).max() < 2 ** 31
    planes = tables.byte_planes(w)
    assert planes[:3].min() >= 0 and planes[:3].max() <= 255
    assert planes[3].min() >= -128 and planes[3].max() <= 127
    np.testing.assert_array_equal(
        sum(planes[l] << 8 * l for l in range(4)), w)


def _unfragment(frag: np.ndarray) -> np.ndarray:
    """The (4, P, P) planes back from mma_fragments' order, by the
    m16n8k32 B-fragment map written out element by element."""
    nt_n, ks_n = frag.shape[:2]
    p = nt_n * 8
    out = np.zeros((4, p, p), np.int64)
    for nt in range(nt_n):
        for ks in range(ks_n):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for word in range(8):
                    plane, h = word // 2, word % 2
                    for i in range(4):
                        v = int(frag[nt, ks, lane, word * 4 + i])
                        if plane == 3 and v > 127:
                            v -= 256
                        row = ks * 32 + 16 * h + 4 * t + i
                        out[plane, row, nt * 8 + g] = v
    return out


@pytest.mark.parametrize("n", (2, 4, 8, 16))
def test_plane_products_equal_the_integer_product(n):
    """sum_l 2^(8 l) (x @ w_l) in int64 equals x @ W on random u8 blocks,
    each plane product fits int32, and the bundle's fragments hold the
    planes (block-diagonal below n2 = 32) in the tile's order."""
    cfg = CodecConfig(block_size=n, quality=90)
    m0, m1, m2, b = tables.encode_operator_split(cfg)
    w, e = tables.integer_operator(m0, m1, m2)
    planes = tables.byte_planes(w)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(0, 256, (300, cfg.n2)).astype(np.int64))
    x[0] = 255  # the largest sums
    prods = [x @ torch.from_numpy(pl) for pl in planes]
    assert max(int(p.abs().max()) for p in prods) < 2 ** 31
    got = sum(p << 8 * l for l, p in enumerate(prods))
    torch.testing.assert_close(got, x @ torch.from_numpy(w), rtol=0, atol=0)

    ops = tables.build(cfg)
    p = tables.mma_width(cfg.n2)
    assert ops.int_planes.shape == (p // 8, p // 32, 32, 32)
    assert ops.int_planes.dtype == torch.uint8
    copies = p // cfg.n2
    want = np.zeros((4, p, p), np.int64)
    for c in range(copies):
        sl = slice(c * cfg.n2, (c + 1) * cfg.n2)
        want[:, sl, sl] = planes
    np.testing.assert_array_equal(_unfragment(ops.int_planes.numpy()), want)
    cert = tables.certificate_constants(m0, m1, m2, b, e)
    np.testing.assert_array_equal(ops.int_cert.numpy(),
                                  np.tile(cert, copies))
    np.testing.assert_array_equal(
        ops.parts_t.numpy(), np.stack([m.T for m in (m0, m1, m2)]))


def _adversarial(n: int, count: int, seed: int) -> np.ndarray:
    """(count, n2) u8 blocks whose values sit on or near .5 boundaries:
    constant blocks (exact ties of the DC at q100 where the level shift
    leaves .5), sums at every residue mod 8, 0/255 checkerboards and
    ramps, and the random blocks of a large pool whose nearest coefficient
    lies closest to a boundary."""
    n2 = n * n
    rng = np.random.default_rng(seed)
    const = np.repeat(np.arange(0, 256, 17, dtype=np.int64)[:, None], n2, 1)
    steps = np.zeros((16, n2), np.int64) + 100
    steps[np.arange(16), np.arange(16) % n2] += np.arange(16)
    yy, xx = np.mgrid[0:n, 0:n]
    checker = (255 * ((yy + xx) % 2)).reshape(1, -1)
    ramps = np.stack([(xx * 255 // (n - 1)).reshape(-1),
                      (yy * 255 // (n - 1)).reshape(-1),
                      ((xx + yy) * 255 // (2 * n - 2)).reshape(-1)])
    pool = rng.integers(0, 256, (20000, n2))
    cfg = CodecConfig(block_size=n, quality=100)
    vals = testing.encode_values_f64(pool, cfg)
    near = np.abs(np.abs(vals) % 1.0 - 0.5).min(axis=1)
    picked = pool[np.argsort(near)[:count]]
    return np.concatenate([const, steps, checker, 255 - checker, ramps,
                           picked]).astype(np.uint8)


def _blocks(kind: str, n: int) -> np.ndarray:
    if kind == "adversarial":
        return _adversarial(n, 96, seed=n)
    img = image_io.synthetic_image(64, 128, kind, seed=5)
    return blocks.image_to_blocks(torch.from_numpy(img), n).reshape(
        -1, n * n).numpy()


@pytest.mark.parametrize("adaptive", (False, True))
@pytest.mark.parametrize("quality", (97, 98, 100))
@pytest.mark.parametrize("n", (8, 16))
@pytest.mark.parametrize("kind", ("photo", "noise", "checker",
                                  "adversarial"))
def test_certified_coefficients_equal_the_chain(kind, n, quality, adaptive,
                                                record_property):
    """Every coefficient the certificate passes is encode_fma_chain's
    integer, every mismatch between round(Y*) and the chain lies in the
    rescued set, and the emulation as a whole equals the chain."""
    cfg = CodecConfig(block_size=n, quality=quality, adaptive=adaptive)
    ops = tables.build(cfg)
    px = torch.from_numpy(_blocks(kind, n))
    recip = None
    if adaptive:
        _, scale = codec._adaptive(px, cfg)
        recip = transform.reciprocal_scale(scale)
    chain = testing.encode_fma_chain(px, cfg, ops, recip)
    w, _ = tables.integer_operator(
        *(m[:cfg.n2, :cfg.n2].numpy() for m in (ops.m0, ops.m1, ops.m2)))
    s = px.to(torch.float64) @ torch.from_numpy(w).to(torch.float64)
    q, ok = testing.certify(s, ops.int_cert[:, :cfg.n2], recip)
    assert torch.equal(q[ok], chain[ok])
    assert not ((q != chain) & ok).any()
    got, rescued = testing.encode_certified(px, cfg, ops, recip)
    assert torch.equal(rescued, ~ok)
    assert torch.equal(got, chain)
    share = rescued.double().mean().item()
    record_property("rescued_share", share)
    print(f"{kind} n={n} q{quality} adaptive={adaptive}: "
          f"{100 * share:.3f} % rescued, "
          f"{int((q != chain).sum())} round(Y*) mismatches")
    if kind == "adversarial":
        assert rescued.any()  # the blocks reach the boundaries


@pytest.mark.parametrize("adaptive", (False, True))
@pytest.mark.parametrize("quality", (50, 97))
@pytest.mark.parametrize("n", (2, 4, 8, 16))
def test_certified_transform_matches_reference(n, quality, adaptive):
    """The emulation against the JAX package's encode transform on the
    same blocks: ties only."""
    kw = dict(block_size=n, quality=quality, adaptive=adaptive)
    cfg, ref_cfg = CodecConfig(**kw), RefConfig(**kw)
    px = _blocks("photo", n)
    scale = recip = None
    if adaptive:
        _, scale = codec._adaptive(torch.from_numpy(px), cfg)
        recip = transform.reciprocal_scale(scale)
    got, _ = testing.encode_certified(torch.from_numpy(px), cfg,
                                      tables.build(cfg), recip)
    want = np.array(ref_tf.encode_blocks(
        jnp.asarray(px), ref_cfg,
        adaptive_scale=None if scale is None else jnp.asarray(scale.numpy())))
    vals = testing.encode_values_f64(
        px, cfg, None if recip is None else recip.numpy())
    n_mis, n_bad = testing.tie_mismatches(got, want, vals,
                                          testing.ENCODE_TIE_TOL)
    assert n_bad == 0 and n_mis <= got.numel() // 1000


def test_operands_only_for_the_tensor_core_sizes():
    """Block sizes the tensor-core tile does not take carry no integer
    operands; the kernels refuse them before reading any."""
    for n in (3, 5):
        ops = tables.build(CodecConfig(block_size=n))
        assert ops.int_planes is None and ops.int_cert is None
        assert ops.parts_t is None
    ops = tables.build(CodecConfig(block_size=16))
    assert ops.int_cert.dtype == torch.float64
    assert ops.parts_t.is_contiguous() and ops.parts_t.dtype == torch.float32
