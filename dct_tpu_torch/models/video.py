"""Batched-frame codec (the "video" model family; port of
``dct_tpu.models.video``): encode a stack of gray or RGB frames with one
launch per stage and plane, decode a stack of containers likewise.

All-intra: every frame is coded independently, but the stack shares one
canonical table (and run table) built from the stack's summed histograms,
and each frame's container stays individually decodable
(models/codec.py). The bytes do not depend on how the stack is cut into
chunks: dynamic tables come from histograms summed over every chunk (pass
1), and pass 2 encodes each chunk against the final tables.

Per chunk of frames, on the card: static tables run kernel B over every
stripe of every frame (or, for 2x2 blocks, which kernel B does not take,
the staged path); with dynamic tables a stack that fits one chunk runs
the analyze pass once (kernel A) and packs those same symbols with one
kernel E launch, as the reference does; with several chunks, pass 1 runs
the analyze pass chunk by chunk for the histograms, and pass 2 encodes
each chunk with kernel B where codec.fused_kernel_ok (4x4, 8x8 and 16x16
blocks, every mode), else analyze + kernel E. Kernels A and B share one
float32 chain at every block size, so the bytes do not depend on which
of the two paths ran. Decode runs one kernel D launch over an
all-indexed (v2) stack and one kernel C launch (16x16 blocks: the float32
product).

RGB stacks (chroma "444" or "420") are converted to Y, Cb and Cr planes
on the device in chunks of frames (models/color.py) and each plane type
is encoded as a gray stack is, Cb and Cr against the chrominance quant
table, with a table of its own; a stack of color containers decodes one
plane type at a time, then planes_to_rgb over the stack.

With ``mesh`` (parallel/mesh.py) the encode runs over its ranks, frames
over the data axis and stripes over the stripe axis
(parallel/shard_encode.py), and writes the same bytes for every mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from dct_tpu_torch import container as cont
from dct_tpu_torch import tables
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec, color
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.utils import tracing

# Pixels per encode (and decode) dispatch. The staged path's peak device
# memory grows with it, mostly the int32 symbol chunks (24 B a pixel) and
# their temporaries; the largest 1080p chunk it allows, 61 frames, fits an
# 80 GB H100 with room to spare (PERF.md).
CHUNK_PIXEL_BUDGET = 128_000_000


def frames_per_chunk(f: int, h: int, w: int,
                     chunk_frames: int | None) -> int:
    """Frames per encode dispatch of an (f, h, w) plane stack: chunk_frames,
    else as many as CHUNK_PIXEL_BUDGET allows, within [1, f]."""
    if chunk_frames is None:
        chunk_frames = CHUNK_PIXEL_BUDGET // (h * w)
    return max(1, min(int(chunk_frames), f))


def _encode_plane_batch(
    planes: np.ndarray,
    cfg: CodecConfig,
    chunk_frames: int | None,
    device: torch.device,
    chroma: bool = False,
) -> list[cont.PlaneData]:
    """(F, h, w) u8 plane stack -> one PlaneData per frame, sharing one
    table (and run table) for the whole stack, the same for every
    chunking. chroma: Cb or Cr planes (the chrominance quant table)."""
    f, h, w = (int(x) for x in planes.shape)
    _, _, n_stripes = codec._padded_grid(h, w, cfg)
    chunk = frames_per_chunk(f, h, w, chunk_frames)

    def prep(i0: int) -> torch.Tensor:
        with tracing.named_scope("video.upload_pad"):
            sub = np.ascontiguousarray(planes[i0:i0 + chunk], np.uint8)
            tracing.add("h2d_bytes", sub.nbytes)
            return codec.pad_plane_for_encode(
                torch.from_numpy(sub).to(device), cfg)

    ops = tables.build(cfg, chroma=chroma, device=device)
    symbols_once = var_once = None
    if cfg.static_tables:
        table = codec._build_table(cfg, None)
        run_table = codec._build_run_table(cfg, None)
    else:
        if f <= chunk:
            # one chunk: analyze once and pack the same symbols
            symbols_once, var_once, hist, run_hist = codec.encode_analyze(
                prep(0), cfg, ops)
            hist, run_hist = codec.read_histograms(hist, run_hist)
        else:
            # pass 1: the stack's histograms, chunk by chunk, summed in
            # int64 on the host (a bin can pass 2^31 over a long stack)
            hist = run_hist = 0
            for i0 in range(0, f, chunk):
                _, _, h_, rh_ = codec.encode_analyze(prep(i0), cfg, ops)
                h_, rh_ = codec.read_histograms(h_, rh_)
                hist = hist + h_.astype(np.int64)
                run_hist = run_hist + rh_.astype(np.int64)
        table, run_table, ops = codec.build_tables(cfg, ops, hist, run_hist)

    out: list[cont.PlaneData] = []
    for i0 in range(0, f, chunk):
        if cfg.static_tables:
            packed, var_codes, block_bits = codec.encode_step(
                prep(i0), cfg, n_stripes, chroma)
        elif symbols_once is not None:
            packed, block_bits = codec.pack_frames(symbols_once, cfg, (f,),
                                                   n_stripes, ops)
            var_codes = var_once
        elif codec.fused_kernel_ok(cfg):
            packed, var_codes, block_bits = codec.encode_fused_step(
                prep(i0), cfg, n_stripes, ops)
        else:
            packed, var_codes, block_bits = codec.encode_staged_step(
                prep(i0), cfg, n_stripes, ops)

        out += codec.plane_data(
            bs.fetch_packed(packed),  # trim worst-case slack before D2H
            w, h, table, run_table,
            var_codes.cpu().numpy() if cfg.adaptive else None,
            (codec.read_back(block_bits, "codec.index_readback")
             if block_bits is not None else None))
    return out


def _batch_key(c: cont.Container):
    """What frames decoded as one batch must share: the config, and every
    plane's size and tables."""
    return (c.config,) + tuple(
        (p.height, p.width,
         None if p.table_lengths is None else p.table_lengths.tobytes(),
         None if p.run_table_lengths is None
         else p.run_table_lengths.tobytes())
        for p in c.planes)


def rgb_planes(frames: np.ndarray, mode: str, chunk_frames: int | None,
               device: torch.device) -> list[np.ndarray]:
    """(F, H, W, 3) u8 RGB -> [Y, Cb, Cr] (F, h, w) u8 host plane stacks,
    converted on ``device`` in chunks of frames (chunk_frames, else from
    CHUNK_PIXEL_BUDGET): the float32 intermediates of a whole long stack
    would dwarf the u8 planes they give."""
    f, h, w = (int(x) for x in frames.shape[:3])
    cc = chunk_frames or max(1, CHUNK_PIXEL_BUDGET // (h * w))
    parts = [[], [], []]
    for i0 in range(0, f, cc):
        with tracing.named_scope("color.to_planes"):
            planes = color._to_planes(
                codec.to_device_u8(frames[i0:i0 + cc], device), mode)
            for lst, p in zip(parts, planes):
                lst.append(p.cpu().numpy())
                tracing.add("d2h_bytes", p.numel())
    return [np.concatenate(lst) for lst in parts]


class VideoCodec:
    """Encode (F, H, W) gray or (F, H, W, 3) RGB u8 frame stacks (by the
    config's chroma) to one container per frame (each decodable with
    models.codec.decode), and decode such stacks, on one device."""

    def __init__(self, config: CodecConfig | None = None,
                 chunk_frames: int | None = None,
                 device: str | torch.device | None = None,
                 mesh=None):
        """chunk_frames caps the frames per dispatch (None: from
        CHUNK_PIXEL_BUDGET); the output bytes do not depend on it. With a
        torch.distributed DeviceMesh from parallel.mesh.make_mesh, encode
        runs sharded on the mesh's device (shard_encode) and the bytes do
        not depend on the mesh either."""
        self.config = config or CodecConfig()
        self.chunk_frames = chunk_frames
        self.mesh = mesh
        if mesh is not None:
            from dct_tpu_torch.parallel import mesh as meshlib

            self.device = meshlib.entry_device(mesh, device)
        else:
            self.device = (torch.device(device) if device is not None
                           else codec._default_device())

    def encode(self, frames: np.ndarray) -> list[bytes]:
        cfg = self.config
        if cfg.chroma == "gray":
            if frames.ndim != 3:
                raise ValueError(f"expected (F, H, W), got {frames.shape}")
        elif frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f"expected (F, H, W, 3) RGB for chroma={cfg.chroma}, "
                f"got {frames.shape}")
        with tracing.named_scope("video.encode", frames=int(frames.shape[0])):
            return self._encode(frames)

    def _encode(self, frames: np.ndarray) -> list[bytes]:
        cfg, ck = self.config, self.chunk_frames
        batches = ([frames] if cfg.chroma == "gray"
                   else rgb_planes(frames, cfg.chroma, ck, self.device))
        h, w = int(frames.shape[1]), int(frames.shape[2])
        if self.mesh is None:
            per_plane = [_encode_plane_batch(b, cfg, ck, self.device,
                                             chroma=i > 0)
                         for i, b in enumerate(batches)]
        else:
            from dct_tpu_torch.parallel import shard_encode

            per_plane = [shard_encode.encode_video_plane_batch_sharded(
                b, cfg, self.mesh, chroma=i > 0, chunk_frames=ck)
                for i, b in enumerate(batches)]
        return [cont.serialize(cont.Container(config=cfg, width=w, height=h,
                                              planes=list(planes)))
                for planes in zip(*per_plane)]

    def decode(self, streams: list[bytes]) -> np.ndarray:
        return self.decode_to_device(streams).cpu().numpy()

    def decode_to_device(self, streams: list[bytes]) -> torch.Tensor:
        """(F, H, W) gray or (F, H, W, 3) RGB u8 frames left on this
        codec's device. Frames that share config, sizes and tables decode
        as one batch per chunk of frames (models.codec.decode_planes_device
        for each plane type); a mixed batch decodes frame by frame."""
        if not streams:
            raise ValueError("decode requires at least one stream")
        with tracing.named_scope("video.decode_to_device",
                                 frames=len(streams)):
            conts = [cont.deserialize(s) for s in streams]
            c0 = conts[0]
            if any(_batch_key(c) != _batch_key(c0) for c in conts[1:]):
                parts = [self._decode_batch([c]) for c in conts]
            else:
                # symmetric with encode: long stacks decode in chunks of
                # frames
                ck = max(1, self.chunk_frames
                         or CHUNK_PIXEL_BUDGET // (c0.height * c0.width))
                parts = [self._decode_batch(conts[i0:i0 + ck])
                         for i0 in range(0, len(conts), ck)]
            if len(parts) == 1:
                return parts[0]
            with tracing.named_scope("video.stack"):
                return torch.cat(parts)

    def _decode_batch(self, conts: list[cont.Container]) -> torch.Tensor:
        """Containers that share _batch_key -> (F, H, W) or (F, H, W, 3)
        u8 frames: one decode_planes_device per plane type."""
        c0 = conts[0]
        cfg = c0.config
        planes = [codec.decode_planes_device([c.planes[i] for c in conts],
                                             cfg, self.device, chroma=i > 0)
                  for i in range(len(c0.planes))]
        if cfg.chroma == "gray":
            return planes[0]
        return color.planes_to_rgb(*planes, cfg.chroma, c0.height, c0.width)
