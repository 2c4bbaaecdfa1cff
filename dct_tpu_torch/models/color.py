"""Color codec: RGB <-> YCbCr, chroma subsampling, three-plane containers
(port of ``dct_tpu.models.color``).

BT.601 full-range conversion (the JFIF convention), 4:4:4 or 4:2:0
chroma. Each plane is encoded as a gray plane is (models/codec.py), Y
against the luma quant table and Cb/Cr against the chrominance table
(``chroma=True``), so kernels A, B, C and D run them with the chroma
operators as operands; the conversions are plain torch ops on the planes'
device.

The conversions are separate eager elementwise ops in one fixed order
(each product and each sum rounded to float32 on its own, no fused or
contracted expression, no reduction whose order depends on the device),
so the card and the CPU give the same planes and RGB bit for bit. They
round half to even (``torch.round``), as the reference's ``jnp.round``
does; the transform's rounding (half away from zero) is another rule.
The reference's XLA evaluates the same expressions in another float32
order, so a plane value may differ from the reference's by 1 where the
float64 value lies within a few ulp of a .5 boundary
(``dct_tpu_torch.testing.plane_values_f64``).

All functions take leading frame axes: (..., H, W, 3) RGB and (..., H, W)
planes.
"""

from __future__ import annotations

import numpy as np
import torch

from dct_tpu_torch import container as cont
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec as _codec
from dct_tpu_torch.ops import blocks as blk
from dct_tpu_torch.utils import tracing


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 RGB -> (..., 3) float32 YCbCr (JFIF full-range
    BT.601), each term rounded left to right."""
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return torch.stack([y, cb, cr], dim=-1)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clamp to [0, 255], u8."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """(..., 3) float32 YCbCr -> (..., 3) u8 RGB."""
    y = ycc[..., 0]
    cb = ycc[..., 1] - 128.0
    cr = ycc[..., 2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return _to_u8(torch.stack([r, g, b], dim=-1))


def subsample_420(plane: torch.Tensor) -> torch.Tensor:
    """2x2 box-filter downsample (..., H, W) -> (..., ceil(H/2),
    ceil(W/2)), an odd edge replicated first. The four samples are summed
    in row-major order, (((x00 + x01) + x10) + x11) / 4: the order of the
    reference's XLA mean over the 2x2 window."""
    h, w = int(plane.shape[-2]), int(plane.shape[-1])
    x = blk.pad_edge(plane, h + (h & 1), w + (w & 1))
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
    s = s + x[..., 1::2, 0::2]
    s = s + x[..., 1::2, 1::2]
    return s / 4.0


def upsample_420(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of (..., h2, w2) back to (..., h, w)."""
    x = plane.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return x[..., :h, :w]


def planes_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  mode: str, h: int, w: int) -> torch.Tensor:
    """Decoded u8 planes -> (..., h, w, 3) u8 RGB on their device: the
    chroma upsample (4:2:0) and YCbCr -> RGB. The reconstruction tail of
    every color decoder (image, video stack, probe), so they agree by
    construction. Raises ValueError where the planes, chroma upsampled,
    do not share one shape (a damaged container's plane sizes), as the
    reference's stack does."""
    with tracing.named_scope("color.planes_to_rgb"):
        cb = cb.to(torch.float32)
        cr = cr.to(torch.float32)
        if mode == "420":
            cb = upsample_420(cb, h, w)
            cr = upsample_420(cr, h, w)
        if not y.shape == cb.shape == cr.shape:
            raise ValueError(f"color planes of shapes {tuple(y.shape)}, "
                             f"{tuple(cb.shape)}, {tuple(cr.shape)} (chroma "
                             f"upsampled) do not form one {mode} image")
        return ycbcr_to_rgb(torch.stack([y.to(torch.float32), cb, cr],
                                        dim=-1))


def _to_planes(rgb: torch.Tensor, mode: str):
    """(..., H, W, 3) u8 RGB -> (Y, Cb, Cr) u8 planes on rgb's device;
    under "420" Cb and Cr are (..., ceil(H/2), ceil(W/2))."""
    ycc = rgb_to_ycbcr(rgb)
    y = _to_u8(ycc[..., 0])
    cb, cr = ycc[..., 1], ycc[..., 2]
    if mode == "420":
        cb = subsample_420(cb)
        cr = subsample_420(cr)
    return y, _to_u8(cb), _to_u8(cr)


class ColorImageCodec:
    """YCbCr three-plane codec on one device: chroma "444" or "420"."""

    def __init__(self, config: CodecConfig,
                 device: str | torch.device | None = None):
        if config.chroma not in ("444", "420"):
            raise ValueError("ColorImageCodec requires chroma '444' or '420'")
        self.config = config
        self.device = (torch.device(device) if device is not None
                       else _codec._default_device())

    def encode(self, rgb: np.ndarray) -> bytes:
        if rgb.ndim != 3 or rgb.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) RGB, got {rgb.shape}")
        h, w = int(rgb.shape[0]), int(rgb.shape[1])
        with tracing.named_scope("color.encode", frames=1):
            with tracing.named_scope("color.to_planes"):
                planes = _to_planes(_codec.to_device_u8(rgb, self.device),
                                    self.config.chroma)
            return cont.serialize(cont.Container(
                config=self.config, width=w, height=h,
                planes=[_codec.encode_plane(p, self.config, self.device,
                                            chroma=i > 0)
                        for i, p in enumerate(planes)]))

    def decode(self, data: bytes) -> np.ndarray:
        return self.decode_to_device(data).cpu().numpy()

    def decode_to_device(self, data: bytes) -> torch.Tensor:
        """(H, W, 3) u8 RGB left on this codec's device: each plane by
        decode_plane_device (kernel D for a v2 plane, else the host
        decoder; then kernel C), then planes_to_rgb."""
        with tracing.named_scope("color.decode_to_device", frames=1):
            c = cont.deserialize(data)
            cfg = c.config
            y, cb, cr = (_codec.decode_plane_device(p, cfg, self.device,
                                                    chroma=i > 0)
                         for i, p in enumerate(c.planes))
            return planes_to_rgb(y, cb, cr, cfg.chroma, c.height, c.width)
