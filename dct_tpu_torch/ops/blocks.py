"""Image <-> macroblock tiling (port of ``dct_tpu.ops.blocks``).

All functions take an optional leading frame axis: (..., H, W) images and
(..., NB, n^2) blocks. Blocks are ordered raster-scan (block-row major),
so stripe s of a frame covers block rows [s*stripe_rows, (s+1)*stripe_rows).
"""

from __future__ import annotations

import torch


def pad_to_blocks(image: torch.Tensor, n: int) -> torch.Tensor:
    """Pad (..., H, W) up to multiples of n by edge replication."""
    return pad_edge(image, image.shape[-2] + (-image.shape[-2]) % n,
                    image.shape[-1] + (-image.shape[-1]) % n)


def pad_edge(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pad (..., H, W) at the bottom and right to (..., h, w) by edge
    replication (numpy's mode="edge")."""
    ph, pw = h - image.shape[-2], w - image.shape[-1]
    if ph == 0 and pw == 0:
        return image
    if ph:
        image = torch.cat(
            [image, image[..., -1:, :].expand(*image.shape[:-2], ph,
                                              image.shape[-1])], dim=-2)
    if pw:
        image = torch.cat(
            [image, image[..., :, -1:].expand(*image.shape[:-1], pw)], dim=-1)
    return image


def image_to_blocks(image: torch.Tensor, n: int) -> torch.Tensor:
    """(..., H, W) -> (..., H/n * W/n, n*n) row-major flattened blocks
    (contiguous)."""
    x = pad_to_blocks(image, n)
    *lead, h, w = x.shape
    bh, bw = h // n, w // n
    x = x.reshape(*lead, bh, n, bw, n).transpose(-3, -2)
    return x.reshape(*lead, bh * bw, n * n).contiguous()


def blocks_to_image(blocks: torch.Tensor, h: int, w: int, n: int) -> torch.Tensor:
    """Inverse of image_to_blocks; crops padding back to (h, w)."""
    *lead, nb, n2 = blocks.shape
    ph, pw = h + (-h) % n, w + (-w) % n
    bh, bw = ph // n, pw // n
    x = blocks.reshape(*lead, bh, bw, n, n).transpose(-3, -2)
    return x.reshape(*lead, ph, pw)[..., :h, :w]
