"""Kernel B's plane route on the CPU: the padded plane(s) (..., Hp, Wp) go
to ops/fused_encode_cuda.py encode_plane_stripes_fused as they are, with
no blocking pass, and the kernel reads each block at its address in the
plane (csrc/fused_encode.cu; on the CPU the plain version runs on
blocks.image_to_blocks's blocks).

- The kernel's block address (_plane_offsets) gathers exactly
  blocks.image_to_blocks's blocks: stripes of one and two block rows, rows
  that are no multiple of 16 bytes, one and three frames.
- models/codec.py encode_fused_step, which now hands the plane to B, gives
  the units (the whole worst-case buffer), stripe bits and block bits of
  dct_tpu.models.codec.encode_fused_step on the same seeded frames, byte
  for byte (the JAX kernel in interpret mode; one config, so it compiles
  once, ~13 s).

The card's side (the kernel from the plane against the kernel from the
blocks and the staged pipeline) is tests/test_torch_kernels.py's.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu_torch import CodecConfig, tables
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import _build, blocks
from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.utils import image_io


def _plane_offsets(plane_shape, n: int, n_stripes: int) -> torch.Tensor:
    """Where kernel B reads each block of padded planes (..., Hp, Wp)
    taken as one flat array: (NB, n * n) byte offsets, block j of stripe
    s, pixel row r and column c at s * bps * n^2 + (j // bw) * n * Wp +
    (j % bw) * n + r * Wp + c (bw = Wp // n, bps blocks a stripe)."""
    wp, n2 = int(plane_shape[-1]), n * n
    nb = math.prod(plane_shape) // n2
    bps, bw = nb // n_stripes, wp // n
    j = torch.arange(bps)
    first = (torch.arange(n_stripes)[:, None] * (bps * n2)
             + (j // bw * (n * wp) + j % bw * n)[None, :])
    within = (torch.arange(n)[:, None] * wp + torch.arange(n)[None, :])
    return (first.reshape(-1, 1) + within.reshape(1, -1)).reshape(nb, n2)


@pytest.mark.parametrize("frames", (1, 3))
@pytest.mark.parametrize("stripe_rows", (1, 2))
@pytest.mark.parametrize("n", (4, 8, 16))
def test_plane_addresses_gather_the_blocks(n, stripe_rows, frames):
    cfg = CodecConfig(block_size=n, stripe_rows=stripe_rows)
    h, w = 5 * n - 3, 9 * n - 1  # padded to 5 by 9 blocks
    rng = np.random.default_rng(n * 10 + stripe_rows)
    img = torch.from_numpy(rng.integers(0, 256, (frames, h, w), np.uint8))
    plane = codec.pad_plane_for_encode(img, cfg)
    n_stripes = frames * codec._padded_grid(h, w, cfg)[2]
    offsets = _plane_offsets(plane.shape, n, n_stripes)
    want = blocks.image_to_blocks(plane, n).reshape(-1, n * n)
    assert torch.equal(plane.reshape(-1)[offsets], want)
    if n < 16:
        assert plane.shape[-1] % 16  # a row no multiple of 16 bytes


# block_size 4 (rows of 36 bytes), stripes of two block rows, DC
# prediction, the index's block bits
CONFIG = dict(block_size=4, quality=60, static_tables=True, stripe_rows=2,
              dc_prediction=True, decode_index=True)
H, W = 20, 36


@functools.lru_cache(maxsize=None)
def _reference(seed: int):
    """dct_tpu's encode_fused_step on one frame -> (units, bits, block
    bits) as numpy."""
    cfg = RefConfig(**CONFIG)
    table = hf.default_category_table(cfg.quality)
    img = ref_codec.pad_plane_for_encode(
        jnp.asarray(image_io.synthetic_image(H, W, "photo", seed=seed)), cfg)
    packed, _, bb = ref_codec.encode_fused_step(
        img, cfg, ref_codec._padded_grid(H, W, cfg)[2],
        jnp.asarray(table.lengths, jnp.int32),
        jnp.asarray(table.codes.astype(np.int64), jnp.uint32))
    return (np.asarray(packed.units) & 0xFFFF, np.asarray(packed.bit_lengths),
            np.asarray(bb))


@pytest.mark.parametrize("frames", (1, 3))
def test_encode_fused_step_from_the_plane_equals_jax(frames):
    cfg = CodecConfig(**CONFIG)
    stack = np.stack([image_io.synthetic_image(H, W, "photo", seed=s)
                      for s in range(frames)])
    plane = codec.pad_plane_for_encode(torch.from_numpy(stack), cfg)
    n_stripes = codec._padded_grid(H, W, cfg)[2]
    before = dict(_build.LAUNCHES)
    packed, _, bb = codec.encode_fused_step(plane, cfg, n_stripes,
                                            tables.build(cfg))
    assert _build.LAUNCHES == before  # the CPU runs the plain version
    for f in range(frames):
        units, bits, want_bb = _reference(f)
        np.testing.assert_array_equal(packed.units[f].numpy() & 0xFFFF, units)
        np.testing.assert_array_equal(packed.bit_lengths[f].numpy(), bits)
        np.testing.assert_array_equal(bb[f].numpy(), want_bb)
