"""The variance kernel's arithmetic (csrc/fused_encode.cu code_and_recip)
on the CPU, against ops/quant.py's op chain and transform.reciprocal_scale.

The kernel sums each block's level-shifted pixels and their squares as
integers, then runs quant.py's float32 steps in quant.py's order, one
rounding each, on float32 constants written in its source.
dct_tpu_torch.testing.variance_from_sums is that arithmetic in torch
float32 on the kernel's own constants (read from the source). It is held
bit for bit to the plain chain (codes byte-equal, reciprocals as int32
views): at n2 16 for every S1 a block can have, each with every S2 of the
unclamped band and past its edges; at every block size on seeded blocks,
on blocks built at the clamp edges (variance 100 and 1000) and on blocks
built at exact .5 ties of the code's rounding. The chain's division by
1000 is a true division on every device, on blocks that a multiply by
its reciprocal (CUDA's arithmetic for a Python-scalar divisor) would
code otherwise. The kernel itself is held
to its plain version on the card (tests/test_torch_variance_kernel.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import _build, fused_encode_cuda, quant, transform

K = testing.variance_kernel_constants()


def plain(y: torch.Tensor):
    """The plain chain on (B, n2) level-shifted rows -> (codes, recip)."""
    codes = quant.variance_code(quant.block_variance_flat(y))
    return codes, transform.reciprocal_scale(
        quant.scale_from_variance_code(codes))


def sums(y: torch.Tensor):
    return y.sum(-1), (y * y).sum(-1)


def assert_model_equals_plain(y: torch.Tensor, s1: torch.Tensor,
                              s2: torch.Tensor):
    """y: (B, n2) integer rows of sums s1, s2 (their float32 sums are
    exact)."""
    codes, recip = testing.variance_from_sums(s1, s2, y.shape[-1], K)
    want_codes, want_recip = plain(y.to(torch.float32))
    assert torch.equal(codes, want_codes)
    assert torch.equal(recip.view(torch.int32), want_recip.view(torch.int32))


def test_the_kernels_constants_are_pytorchs_for_quants_scalars():
    scalars = {"kVarianceUnit": 1000.0, "kNormMin": 0.1, "kNormMax": 1.0,
               "kCodeScale": 255.0 / 0.9, "kCodeStep": 0.9 / 255.0}
    assert K == {k: torch.tensor(v, dtype=torch.float32).item()
                 for k, v in scalars.items()}


def four_squares(top: int) -> torch.Tensor:
    """(top + 1, 4) integers whose squares sum to the row's index."""
    two = {}
    for a in range(int(top ** 0.5) + 1):
        for b in range(a, int(top ** 0.5) + 1):
            two.setdefault(a * a + b * b, (a, b))
    sums = sorted(two)
    out = np.zeros((top + 1, 4), np.int64)
    for n in range(top + 1):
        u = next(u for u in sums if n - u in two)
        out[n] = two[u] + two[n - u]
    return torch.from_numpy(out)


def rows_with_sums(s1: torch.Tensor, s2: torch.Tensor,
                   squares: torch.Tensor) -> torch.Tensor:
    """(B, 16) integer rows y with sum s1 and square sum s2 (s2 = s1 mod 2
    and at least the variance band's floor): c + z, c the rounded mean,
    z |r| entries of sign(r) (r = s1 - 16 c) and four pairs +-a whose
    squares make up the rest. Entries may leave [-128, 127]; the plain
    chain's float32 sums of them are exact, so it computes what it computes
    on every u8 block with these sums."""
    c = torch.round(s1 / 16).to(torch.int64)
    r = s1 - 16 * c
    rest = s2 - 16 * c * c - 2 * c * r - r.abs()
    assert bool((rest >= 0).all() and (rest % 2 == 0).all())
    a = squares[rest // 2]
    ones = torch.where(torch.arange(8) < r.abs()[:, None],
                       torch.sign(r)[:, None], 0)
    pairs = torch.stack([a, -a], -1).reshape(-1, 8)
    return torch.cat([ones, pairs], 1) + c[:, None]


def test_every_s1_at_n2_16_with_every_s2_of_the_unclamped_band():
    squares = four_squares(9000)
    n = 0
    for chunk in torch.arange(-128 * 16, 127 * 16 + 1).split(512):
        s1s, s2s = [], []
        for s1 in chunk.tolist():
            m2 = (s1 / 16) ** 2
            lo, hi = int(16 * (90 + m2)), int(16 * (1010 + m2))
            s2 = torch.arange(lo + (lo - s1) % 2, hi + 1, 2)
            s1s.append(torch.full_like(s2, s1))
            s2s.append(s2)
        s1, s2 = torch.cat(s1s), torch.cat(s2s)
        y = rows_with_sums(s1, s2, squares)
        got1, got2 = sums(y)
        assert torch.equal(got1, s1) and torch.equal(got2, s2)
        assert_model_equals_plain(y, s1, s2)
        n += s1.numel()
    assert n > 29_000_000


def seeded_blocks(n2: int, count: int, seed: int) -> torch.Tensor:
    """(count, n2) level-shifted u8 blocks, each of its own mean and
    spread, so the codes cover the clamps and the band between them."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(0, 255, (count, 1))
    spread = rng.choice([0.0, 3.0, 10.0, 20.0, 32.0, 60.0], (count, 1))
    p = np.clip(np.rint(mean + spread * rng.standard_normal((count, n2))),
                0, 255)
    return torch.from_numpy(p.astype(np.int64) - 128)


def built_blocks(n2: int, seed: int) -> torch.Tensor:
    """Level-shifted u8 blocks at the clamp edges (variance exactly 100 and
    1000, at several means) and at exact .5 ties of the code's rounding."""
    targets = [(n2 * m, n2 * (v + m * m)) for v in (100, 1000)
            for m in (0, -3, 7, 40)]
    targets += testing.variance_tie_sums(n2, K, 8, seed)
    return torch.from_numpy(np.stack(
        [testing.block_with_sums(s1, s2, n2) for s1, s2 in targets])
        .astype(np.int64) - 128)


@pytest.mark.parametrize("n2", [16, 64, 256])
def test_seeded_and_built_blocks(n2):
    built = built_blocks(n2, 5)
    t = testing.variance_code_product(*sums(built), n2, K)
    assert (t[8:] - torch.floor(t[8:]) == 0.5).all()  # the ties are ties
    var = quant.block_variance_flat(built[:8].to(torch.float32))
    assert torch.equal(var, torch.tensor([100.0] * 4 + [1000.0] * 4))
    y = torch.cat([seeded_blocks(n2, 40_000 * 64 // n2, 2**31 + n2), built])
    codes = plain(y.to(torch.float32))[0]
    assert codes.min() == 0 and codes.max() == 255
    assert codes.unique().numel() > 200
    assert_model_equals_plain(y, *sums(y))


class Divisors(TorchFunctionMode):
    """Records the divisor of every tensor division made under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__truediv__, torch.Tensor.div, torch.div,
                    torch.true_divide):
            self.seen.append(args[1])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n2", [16, 64, 256])
def test_the_chain_divides_where_cuda_would_multiply(n2):
    """quant.variance_code divides by 1000 as the kernel does, through a
    tensor on the variance's device (CUDA turns a Python-scalar divisor
    into a multiply by float32(1 / 1000)). On blocks whose code that
    multiply rounds the other way (testing.variance_split_sums) the chain
    equals the kernel's model, and the multiply differs from both: the
    card's blocks route (the dynamic tables' analyze pass) and the
    kernel on B's route give the same codes."""
    targets = testing.variance_split_sums(n2, 12, n2)
    assert len(targets) == 12
    y = torch.from_numpy(np.stack(
        [testing.block_with_sums(s1, s2, n2) for s1, s2 in targets])
        .astype(np.int64) - 128)
    assert_model_equals_plain(y, *sums(y))
    var = quant.block_variance_flat(y.to(torch.float32))
    with Divisors() as d:
        codes = quant.variance_code(var)
    assert d.seen and all(isinstance(v, torch.Tensor)
                          and v.device == var.device for v in d.seen)
    inv = torch.tensor(1.0) / torch.tensor(1000.0)
    by_mul = torch.round((torch.clamp(var * inv, 0.1, 1.0) - 0.1)
                         * (255.0 / 0.9)).to(torch.uint8)
    assert (by_mul != codes).all()


@pytest.mark.parametrize("n", [4, 8, 16])
def test_the_plain_twin_on_the_cpu_is_the_blocks_route(n):
    """On the CPU the variance pass of kernel B's route is the op chain on
    the planes' blocks and the reciprocal of its scales, and launches
    nothing."""
    cfg = CodecConfig(block_size=n, quality=50, adaptive=True)
    rng = np.random.default_rng(n)
    planes = torch.from_numpy(rng.integers(0, 256, (3, 4 * n, 5 * n),
                                           dtype=np.uint8) // rng.integers(
        1, 9, (3, 4 * n, 5 * n)).astype(np.uint8))
    before = dict(_build.LAUNCHES)
    codes, recip = fused_encode_cuda.plane_variance_codes(planes, cfg)
    assert _build.LAUNCHES == before
    blocks = codec.blk.image_to_blocks(planes, n)
    want_codes, want_scale = codec._adaptive(blocks, cfg)
    assert codes.shape == (3, 20) and torch.equal(codes, want_codes)
    assert torch.equal(recip, transform.reciprocal_scale(
        want_scale.reshape(-1)))
    assert torch.equal(codec._adaptive(planes, cfg, planes=True)[1], recip)
