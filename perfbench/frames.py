"""Synthetic "photo" frames made on the device from a seed.

A frozen copy, in torch and float32, of the codec package's "photo"
generator (smooth multi-scale gradients and texture, plus Gaussian noise
of standard deviation 4, clipped and truncated to u8), so that later
changes to the package cannot change the benchmark's inputs. Each frame
shifts the pattern by its own offsets, drawn from the seed with the
noise, so frames differ everywhere and share their statistics. An RGB
frame's channels share half their pattern and take the other half, and
their noise, each from a pattern shifted by offsets of its own, with the
generator's colour offsets (+15 on red, -20 on blue): the channels stay
correlated, as a photo's do, and both chroma planes vary across the
frame.
"""

from __future__ import annotations

import torch

OFFSET_RANGE = 4096
COLOUR_OFFSETS = (15.0, 0.0, -20.0)   # added to red, green, blue


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _pattern(y: torch.Tensor, x: torch.Tensor,
             base: float = 0.0) -> torch.Tensor:
    """The generator's smooth gradients and texture, about ``base``."""
    return (base + 55.0 * torch.sin(x / 37.0 + 1.3) * torch.cos(y / 23.0)
            + 35.0 * torch.sin((x + y) / 91.0)
            + 20.0 * torch.sin(x / 7.0) * torch.sin(y / 5.0))


def photo(n: int, h: int, w: int, gen: torch.Generator, device,
          rgb: bool = False) -> torch.Tensor:
    """(n, h, w) u8 gray frames, or (n, h, w, 3) RGB, on ``device``."""
    out = torch.empty((n, h, w, 3) if rgb else (n, h, w), dtype=torch.uint8,
                      device=device)
    offsets = torch.randint(0, OFFSET_RANGE, (n, 2), generator=gen,
                            device=device).to(torch.float32)
    if rgb:
        own = torch.randint(0, OFFSET_RANGE, (n, 3, 2), generator=gen,
                            device=device).to(torch.float32)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    for i in range(n):
        y, x = yy + offsets[i, 0], xx + offsets[i, 1]
        if not rgb:
            img = (_pattern(y, x, 128.0)
                   + 4.0 * torch.randn((h, w), generator=gen, device=device))
            out[i] = img.clamp_(0.0, 255.0).to(torch.uint8)
            continue
        shared = _pattern(y, x)
        for c, bias in enumerate(COLOUR_OFFSETS):
            img = (128.0 + bias + 0.5 * shared
                   + 0.5 * _pattern(yy + own[i, c, 0], xx + own[i, c, 1])
                   + 4.0 * torch.randn((h, w), generator=gen, device=device))
            out[i, ..., c] = img.clamp_(0.0, 255.0).to(torch.uint8)
    return out


def pad_to_blocks(x: torch.Tensor, n: int = 8) -> torch.Tensor:
    """(..., H, W) planes padded to whole n x n blocks by repeating the
    last row and column."""
    h, w = x.shape[-2:]
    ph, pw = -h % n, -w % n
    if ph:
        x = torch.cat([x, x[..., -1:, :].expand(*x.shape[:-2], ph, w)], -2)
    if pw:
        x = torch.cat([x, x[..., :, -1:].expand(*x.shape[:-1], pw)], -1)
    return x.contiguous()
