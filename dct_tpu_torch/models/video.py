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

The encode and the video size probe (models/rate_control.py) share one
plan over a placement (codec.Placement, stack_plan). With ``mesh``
(parallel/mesh.py) it is the mesh's (shard_encode.MeshPlacement): frames
over the data axis and stripes over the stripe axis, the same bytes for
every mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dct_tpu_torch import container as cont
from dct_tpu_torch import tables
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec, color
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


class StackPlan(NamedTuple):
    """What the encode and the size probe of an (F, h, w) plane stack
    share: the placement, the grid, the chunks of frames
    (Placement.chunks), the stack's tables with the operators that hold
    them, and the (symbols, var_codes) of a one-chunk stack's analyze
    pass (else None)."""
    planes: np.ndarray
    place: codec.Placement
    grid: codec.Grid
    chunk: int
    chunks: list
    table: object
    run_table: object
    ops: tables.CodecOperators
    once: tuple | None


def upload_chunk(plan: StackPlan, i0: int, f_pad: int) -> torch.Tensor:
    """The chunk of the stack from frame i0, this rank's part of it on
    its device, padded to the grid (and to f_pad frames)."""
    with tracing.named_scope("video.upload_pad"):
        return plan.place.upload(plan.planes[i0:i0 + plan.chunk], plan.grid,
                                 f_pad)


def stack_plan(planes: np.ndarray, cfg: CodecConfig, place: codec.Placement,
               chroma: bool, chunk_frames: int | None) -> StackPlan:
    """The grid, the chunks and the stack's tables of an (F, h, w) plane
    stack (pass 1): static tables; or the analyze pass of each chunk, its
    histograms summed over the placement's ranks, and over the chunks in
    int64 on the host (a bin can pass 2^31 over a long stack). A stack of
    one chunk is analyzed once and keeps its symbols; a longer one drops
    each chunk's symbols after its histograms (keeping them would unbound
    the memory CHUNK_PIXEL_BUDGET bounds)."""
    f, h, w = (int(x) for x in planes.shape)
    grid = place.grid(h, w, cfg)
    chunk, chunks = place.chunks(f, frames_per_chunk(f, h, w, chunk_frames))
    ops = tables.build(cfg, chroma=chroma, device=place.device)
    plan = StackPlan(planes, place, grid, chunk, chunks, None, None, ops,
                     None)
    if cfg.static_tables:
        return plan._replace(table=codec._build_table(cfg, None),
                             run_table=codec._build_run_table(cfg, None))
    hists, once = [], None
    for i0, f_real, f_pad in chunks:
        symbols, var_codes, h_, rh_ = codec.encode_analyze(
            upload_chunk(plan, i0, f_pad), cfg, ops)
        hists.append(place.histograms(symbols, h_, rh_, cfg, grid, f_real))
        if len(chunks) == 1:
            once = (symbols, var_codes)
        del symbols, var_codes
    hist, run_hist = (hists[0] if once is not None
                      else (_sum64(parts) for parts in zip(*hists)))
    table, run_table, ops = codec.build_tables(cfg, ops, hist, run_hist)
    return plan._replace(table=table, run_table=run_table, ops=ops,
                         once=once)


def _sum64(parts: list):
    """The chunks' histograms of one kind summed in int64 (None where the
    placement gives none)."""
    return (None if parts[0] is None
            else sum(p.astype(np.int64) for p in parts))


def _encode_plane_batch(
    planes: np.ndarray,
    cfg: CodecConfig,
    chunk_frames: int | None,
    place: codec.Placement,
    chroma: bool = False,
) -> list[cont.PlaneData]:
    """(F, h, w) u8 plane stack -> one PlaneData per frame, sharing one
    table (and run table) for the whole stack, the same for every
    chunking and placement. chroma: Cb or Cr planes (the chrominance
    quant table)."""
    f, h, w = (int(x) for x in planes.shape)
    plan = stack_plan(planes, cfg, place, chroma, chunk_frames)
    n_loc = plan.grid.n_loc
    out: list[cont.PlaneData] = []
    for i0, f_real, f_pad in plan.chunks:
        if cfg.static_tables:
            packed, var_codes, block_bits = codec.encode_step(
                upload_chunk(plan, i0, f_pad), cfg, n_loc, chroma)
        elif plan.once is not None:
            # one chunk: pack the pass-1 symbols with one kernel E launch
            symbols, var_codes = plan.once
            packed, block_bits = codec.pack_frames(
                symbols, cfg, (f_pad // place.shape[0],), n_loc, plan.ops)
        else:
            step = (codec.encode_fused_step if codec.fused_kernel_ok(cfg)
                    else codec.encode_staged_step)
            packed, var_codes, block_bits = step(
                upload_chunk(plan, i0, f_pad), cfg, n_loc, plan.ops)
        packed, var_codes, block_bits = place.outputs(
            packed, var_codes, block_bits, plan.grid, f_real)
        out += codec.plane_data(packed, w, h, plan.table, plan.run_table,
                                var_codes, block_bits)
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
        runs over its ranks on the mesh's device (a MeshPlacement) and the
        bytes do not depend on the mesh either."""
        self.config = config or CodecConfig()
        self.chunk_frames = chunk_frames
        if mesh is not None:
            from dct_tpu_torch.parallel import shard_encode

            self.placement = shard_encode.MeshPlacement(mesh, device)
        else:
            self.placement = codec.Placement(
                device if device is not None else codec._default_device())
        self.device = self.placement.device

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
        per_plane = [_encode_plane_batch(b, cfg, ck, self.placement,
                                         chroma=i > 0)
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
