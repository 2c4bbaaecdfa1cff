"""Rate-distortion control: encode to a byte budget or a PSNR target by
probing EXACT container sizes and distortions on the device (port of
``dct_tpu.models.rate_control``). Every probe is one plan over a
placement (codec.Placement): one device, or with ``mesh=``
(parallel/mesh.py) its ranks (shard_encode.MeshPlacement, built at the
entry), which gives the same integers, the same PSNR and the same bytes
for every mesh shape.

A size probe is the encode without the bit pack: the analyze pass
(kernel A, DC prediction, positional RLE, histograms), the canonical
tables, then the symbol chunks of codec.symbol_chunks_for, the dispatch
the packers take their chunks from, whose lengths are summed per block
and per stripe. The header is priced by serializing a skeleton container
with empty stripes and the real stripe and block bits (the packed decode
index's width and the "auto" index decision depend on them), so a probe
equals ``len()`` of the real container byte for byte.

A distortion probe runs the codec's transform pair (kernel A, then kernel
C: the ops the decoder runs on the integers the wire carries) and sums
the squared error as an exact int64 on the device; the PSNR,
``10 log10(255^2 / (sse / n))``, is computed in float64 on the host, so it
equals the PSNR of a real encode and decode exactly.

``encode_to_size`` / ``encode_to_psnr`` / ``encode_video_to_size`` bisect a
quality ladder for the best rung, then run one real encode.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dct_tpu_torch import container as cont
from dct_tpu_torch import tables
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec as _codec
from dct_tpu_torch.models import color as _color
from dct_tpu_torch.models import video as _video
from dct_tpu_torch.ops import blocks as blk

# Quality rungs for the encode_to_* ladders: dense where the size/quality
# curve is steep (high quality), sparse where it is flat.
DEFAULT_LADDER = (1, 5, 10, 15, 20, 30, 40, 50, 60, 70, 80, 85, 90, 95, 97, 100)


def _placement(device, mesh) -> _codec.Placement:
    """The entry point's placement: over the mesh's ranks when it is given
    one (shard_encode.MeshPlacement; ``device``, when given, must name
    the mesh's), else on ``device`` (None: the card)."""
    if mesh is not None:
        from dct_tpu_torch.parallel import shard_encode

        return shard_encode.MeshPlacement(mesh, device)
    return _codec.Placement(device if device is not None
                            else _codec._default_device())


def _normalize_chroma(ndim: int, cfg: CodecConfig) -> CodecConfig:
    """codec.encode's rank rules, applied up front: RGB input with chroma
    "gray" switches to "420"; gray input with a color chroma is rejected
    here, before any probe work."""
    if ndim == 3:
        return cfg.replace(chroma="420") if cfg.chroma == "gray" else cfg
    if cfg.chroma != "gray":
        raise ValueError(
            "grayscale (H, W) input requires chroma='gray' "
            f"(config has {cfg.chroma!r})"
        )
    return cfg


def _ladder_bisect(
    ladder: list[int],
    meets: Callable[[int], bool],
    strict: bool,
    fail_msg: Callable[[int], str],
) -> int:
    """Largest ladder value satisfying ``meets``, assuming ``meets`` is
    (near-)monotone true -> false along the ladder. If even ladder[0]
    fails: raise ValueError(fail_msg) when strict, else return ladder[0]
    (best effort). The PSNR front passes a descending ladder, so 'largest
    satisfying index' means 'lowest satisfying quality'."""
    lo, hi = 0, len(ladder) - 1
    if not meets(ladder[lo]):
        if strict:
            raise ValueError(fail_msg(ladder[lo]))
        return ladder[lo]
    if meets(ladder[hi]):
        return ladder[hi]
    # invariant: ladder[lo] satisfies, ladder[hi] does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if meets(ladder[mid]):
            lo = mid
        else:
            hi = mid
    return ladder[lo]


def _clean_ladder(qualities) -> list[int]:
    if not qualities:
        raise ValueError("empty quality ladder")
    return sorted(set(int(q) for q in qualities))


# ---------------------------------------------------------------------------
# Size probes (exact container bytes without packing)
# ---------------------------------------------------------------------------


def _plane_tables(cfg: CodecConfig, hist, run_hist):
    """(table, run_table) as encode_plane builds them (hist, run_hist:
    host histograms, None for static tables)."""
    return (_codec._build_table(cfg, hist),
            _codec._build_run_table(cfg, run_hist))


def _chunk_bits(symbols, cfg: CodecConfig, frames: int, n_stripes: int,
                ops: tables.CodecOperators):
    """((frames, n_stripes) int64 payload bits a stripe, (frames, NB)
    int64 bits a block) of stacked symbols, tensors on their device: the
    chunk lengths of the dispatch the packers take
    (codec.symbol_chunks_for), summed."""
    _, cl = _codec.symbol_chunks_for(symbols, cfg, ops)
    bb = cl.sum(dim=(1, 2), dtype=torch.int64).reshape(frames, -1)
    return bb.reshape(frames, n_stripes, -1).sum(dim=2), bb


def _probe_skeleton(
    w: int, h: int, cfg: CodecConfig, n_stripes: int, table, run_table,
    var_codes, stripe_bits, block_bits,
) -> cont.PlaneData:
    """Empty-stripe PlaneData carrying exactly the header fields a probe
    prices, so serializing it gives the per-plane overhead byte for byte.
    stripe_bits and block_bits are the real probed counts: the packed
    decode index's width and serialize()'s "auto" decision depend on
    their values."""
    return cont.PlaneData(
        width=w,
        height=h,
        table_lengths=table.lengths if table is not None else None,
        vmin=_codec.DIRECT_VMIN,
        variance_codes=var_codes,
        stripe_bits=np.asarray(stripe_bits, np.uint32),
        stripes=[b""] * n_stripes,
        run_table_lengths=(
            run_table.lengths if run_table is not None else None
        ),
        block_bits=(
            np.asarray(block_bits).reshape(-1).astype(np.uint16)
            if cfg.decode_index and block_bits is not None else None
        ),
    )


def _plane_size(plane, cfg: CodecConfig, chroma: bool,
                place: _codec.Placement) -> tuple[np.ndarray, cont.PlaneData]:
    """(per-stripe bit counts, empty-stripe skeleton) of one (H, W) u8
    plane at cfg.quality over ``place``: codec.encode_plane up to (not
    including) the pack, the same counts for every placement."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    grid = place.grid(h, w, cfg)
    img = place.upload(plane, grid)
    ops = tables.build(cfg, chroma=chroma, device=img.device)
    symbols, var_codes, hist, run_hist = _codec.encode_analyze(img, cfg, ops)
    if cfg.static_tables:
        table, run_table = _plane_tables(cfg, None, None)
    else:
        table, run_table = _plane_tables(cfg, *place.histograms(
            symbols, hist, run_hist, cfg, grid))
    bits, bb = _chunk_bits(symbols, cfg, 1, grid.n_loc,
                           ops.with_tables(table, run_table))
    nb = grid.n_stripes * grid.bps
    bits = place.host(bits[0], grid.n_stripes)
    bb = place.host(bb[0], nb)
    vc = place.host(var_codes, nb) if cfg.adaptive else None
    return bits, _probe_skeleton(w, h, cfg, grid.n_stripes, table, run_table,
                                 vc, bits, bb)


def _image_plane_args(image: np.ndarray, cfg: CodecConfig,
                      device: torch.device) -> list[tuple[torch.Tensor, bool]]:
    """Image -> [(plane tensor on device, is_chroma)] under an already
    normalized cfg. The RGB -> YCbCr split does not depend on the quality,
    so encode_to_size makes it once for every rung."""
    x = _codec.to_device_u8(image, device)
    if image.ndim == 2:
        return [(x, False)]
    y, cb, cr = _color._to_planes(x, cfg.chroma)
    return [(y, False), (cb, True), (cr, True)]


def _container_size_from_planes(
    plane_args: list[tuple[torch.Tensor, bool]], cfg: CodecConfig, w: int,
    h: int, place: _codec.Placement,
) -> int:
    payload = 0
    skeletons = []
    for plane, chroma in plane_args:
        bits, skel = _plane_size(plane, cfg, chroma, place)
        payload += int(((bits.astype(np.int64) + 7) // 8).sum())
        skeletons.append(skel)
    header = len(cont.serialize(
        cont.Container(config=cfg, width=w, height=h, planes=skeletons)))
    return header + payload


def container_size(image: np.ndarray, cfg: CodecConfig,
                   device: str | torch.device | None = None,
                   mesh=None) -> int:
    """EXACT serialized container size in bytes of encoding ``image``
    under ``cfg``, without packing or materializing the payload: gray
    (H, W) or RGB (H, W, 3) by array rank, with codec.encode's chroma rule
    (RGB with chroma "gray" encodes at "420"). With a mesh the probe runs
    stripe-sharded and gives the same integer for every mesh shape."""
    cfg = _normalize_chroma(image.ndim, cfg)
    place = _placement(device, mesh)
    return _container_size_from_planes(
        _image_plane_args(image, cfg, place.device), cfg,
        int(image.shape[1]), int(image.shape[0]), place)


# ---------------------------------------------------------------------------
# Video (frame stacks, models/video.py)
# ---------------------------------------------------------------------------


def _plane_batch_bits(
    planes: np.ndarray,
    cfg: CodecConfig,
    chroma: bool,
    chunk_frames: int | None,
    place: _codec.Placement,
):
    """((F, n_stripes) bits a stripe, (F, NB) bits a block, skeleton
    factory frame -> PlaneData) of an (F, h, w) plane stack at
    cfg.quality over ``place``: video._encode_plane_batch up to (not
    including) the pack, with the stack's tables and chunks of frames
    (video.stack_plan). A stack of one chunk is counted from its pass-1
    symbols; a longer one is analyzed again, chunk by chunk, to count.
    Skeletons are per frame: the packed decode index's width depends on
    each frame's block bits."""
    f, h, w = (int(x) for x in planes.shape)
    plan = _video.stack_plan(planes, cfg, place, chroma, chunk_frames)
    grid = plan.grid
    nb = grid.n_stripes * grid.bps
    bits, bbs = [], []
    for i0, f_real, f_pad in plan.chunks:
        symbols = (plan.once[0] if plan.once is not None
                   else _codec.encode_analyze(_video.upload_chunk(
                       plan, i0, f_pad), cfg, plan.ops)[0])
        b, bb = _chunk_bits(symbols, cfg, f_pad // place.shape[0],
                            grid.n_loc, plan.ops)
        bits.append(place.host(b, grid.n_stripes, f_real))
        bbs.append(place.host(bb, nb, f_real))
    bits, bbs = np.concatenate(bits), np.concatenate(bbs)

    def skeleton(i: int) -> cont.PlaneData:
        return _probe_skeleton(
            w, h, cfg, grid.n_stripes, plan.table, plan.run_table,
            np.zeros(nb, np.uint8) if cfg.adaptive else None,
            bits[i], bbs[i],
        )

    return bits, bbs, skeleton


def _video_plane_batches(
    frames: np.ndarray, cfg: CodecConfig, chunk_frames: int | None,
    device: torch.device,
) -> list[tuple[np.ndarray, bool]]:
    """Frame stack -> [(plane stack, is_chroma)], RGB converted as
    VideoCodec.encode converts it (video.rgb_planes). It does not depend
    on the quality, so encode_video_to_size makes it once."""
    if cfg.chroma == "gray":
        if frames.ndim != 3:
            raise ValueError(f"expected (F, H, W), got {frames.shape}")
        return [(np.asarray(frames, np.uint8), False)]
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(
            f"expected (F, H, W, 3) RGB for chroma={cfg.chroma}, "
            f"got {frames.shape}"
        )
    y, cb, cr = _video.rgb_planes(frames, cfg.chroma, chunk_frames, device)
    return [(y, False), (cb, True), (cr, True)]


def _video_sizes_from_batches(
    plane_batches: list[tuple[np.ndarray, bool]],
    cfg: CodecConfig,
    w: int,
    h: int,
    chunk_frames: int | None,
    place: _codec.Placement,
) -> np.ndarray:
    f = int(plane_batches[0][0].shape[0])
    per_frame = np.zeros(f, np.int64)
    skel_factories = []
    for batch, chroma in plane_batches:
        bits, _, skel = _plane_batch_bits(batch, cfg, chroma, chunk_frames,
                                          place)
        per_frame += ((bits.astype(np.int64) + 7) // 8).sum(axis=1)
        skel_factories.append(skel)
    # headers are per frame: the packed decode index's width (and the
    # "auto" decision) vary with each frame's block bits
    for i in range(f):
        per_frame[i] += len(cont.serialize(cont.Container(
            config=cfg, width=w, height=h,
            planes=[sk(i) for sk in skel_factories],
        )))
    return per_frame


def video_container_sizes(
    frames: np.ndarray,
    cfg: CodecConfig,
    chunk_frames: int | None = None,
    device: str | torch.device | None = None,
    mesh=None,
) -> np.ndarray:
    """EXACT per-frame container sizes (bytes) of
    VideoCodec(cfg).encode(frames), without packing: (F,) int64. The
    stack shares one table per plane type, so these differ from per-image
    container_size wherever tables are dynamic. With a mesh the probe
    runs over its data and stripe axes and gives the same integers for
    every mesh shape."""
    place = _placement(device, mesh)
    batches = _video_plane_batches(frames, cfg, chunk_frames, place.device)
    h, w = int(frames.shape[1]), int(frames.shape[2])
    return _video_sizes_from_batches(batches, cfg, w, h, chunk_frames, place)


def encode_video_to_size(
    frames: np.ndarray,
    total_bytes: int,
    config: CodecConfig | None = None,
    qualities: tuple[int, ...] = DEFAULT_LADDER,
    strict: bool = True,
    chunk_frames: int | None = None,
    device: str | torch.device | None = None,
    mesh=None,
) -> tuple[list[bytes], int]:
    """Encode a frame stack into at most ``total_bytes`` over all its
    per-frame containers, at one shared quality (the stack's
    encode_to_size; each frame's stream stays decodable on its own).
    Returns (streams, quality). With a mesh the probes and the encode run
    sharded; the quality and the bytes are the same for every mesh."""
    place = _placement(device, mesh)
    base = config or CodecConfig()
    if frames.ndim == 4 and base.chroma == "gray":
        base = base.replace(chroma="420")
    ladder = _clean_ladder(qualities)
    # the RGB -> YCbCr split does not depend on the quality: once
    batches = _video_plane_batches(frames, base, chunk_frames, place.device)
    h, w = int(frames.shape[1]), int(frames.shape[2])

    totals: dict[int, int] = {}

    def size_of(q: int) -> int:
        if q not in totals:
            totals[q] = int(_video_sizes_from_batches(
                batches, base.replace(quality=q), w, h, chunk_frames,
                place).sum())
        return totals[q]

    best = _ladder_bisect(
        ladder,
        lambda q: size_of(q) <= total_bytes,
        strict,
        lambda q: (
            f"quality {q} needs {size_of(q)} bytes > budget {total_bytes}"
        ),
    )
    streams = _video.VideoCodec(base.replace(quality=best),
                                chunk_frames=chunk_frames,
                                device=place.device, mesh=mesh).encode(frames)
    return streams, best


# ---------------------------------------------------------------------------
# Distortion probes (exact PSNR without a bitstream)
# ---------------------------------------------------------------------------


def _band_roundtrip(plane, cfg: CodecConfig, chroma: bool,
                    place: _codec.Placement):
    """(this rank's band of the padded (H, W) u8 plane, its quantize +
    reconstruct through the codec's transform pair: kernel A, then kernel
    C, the ops decode_plane_device runs on the integers the wire
    carries; the grid)."""
    grid = place.grid(int(plane.shape[0]), int(plane.shape[1]), cfg)
    img = place.upload(plane, grid)
    n = cfg.block_size
    pixels = blk.image_to_blocks(img, n).reshape(-1, cfg.n2)
    _, scale = _codec._adaptive(pixels, cfg)
    ops = tables.build(cfg, chroma=chroma, device=img.device)
    zz = _codec.encode_transform(pixels, cfg, ops, scale)
    rec = _codec.decode_transform(zz, cfg, ops, scale)
    return img, blk.blocks_to_image(rec, img.shape[0], img.shape[1], n), grid


def _plane_sse(plane, cfg: CodecConfig, place: _codec.Placement) -> int:
    """Exact sum of squared errors of a gray plane's roundtrip, as an
    int64 on the device (each square is at most 255^2) over the rows and
    columns of each rank's band inside the plane, summed over the ranks:
    the same integer for every placement."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    img, rec, grid = _band_roundtrip(plane, cfg, False, place)
    rows = max(0, min(img.shape[0], h - place.row0(grid)))
    d = rec[:rows, :w].to(torch.int64) - img[:rows, :w].to(torch.int64)
    return place.total((d * d).sum())


def roundtrip_sse(image: np.ndarray, cfg: CodecConfig,
                  device: str | torch.device | None = None,
                  mesh=None) -> int:
    """EXACT sum of squared pixel errors of encode -> decode under
    ``cfg``, without a bitstream. Gray (H, W) only; color goes through
    psnr_at_quality (its reconstruction crosses planes). With a mesh each
    rank round-trips its band of rows: the same integer for every
    mesh."""
    if image.ndim != 2:
        raise ValueError("roundtrip_sse takes a grayscale (H, W) plane")
    return _plane_sse(image, cfg, _placement(device, mesh))


def _rgb_sse(image: np.ndarray, cfg: CodecConfig,
             place: _codec.Placement) -> int:
    """Exact roundtrip squared error of an RGB image: the YCbCr split,
    each plane's quantize and reconstruct (the chrominance table on Cb
    and Cr, 4:2:0 resampling), the RGB reassembly of
    ColorImageCodec.decode_to_device. Each plane's bands are gathered
    before the reassembly, whose 4:2:0 chroma rows do not follow the luma
    bands."""
    rgb = _codec.to_device_u8(image, place.device)
    recs = [place.rows(_band_roundtrip(p, cfg, i > 0, place)[1])[
        :p.shape[0], :p.shape[1]]
        for i, p in enumerate(_color._to_planes(rgb, cfg.chroma))]
    h, w = int(image.shape[0]), int(image.shape[1])
    d = (_color.planes_to_rgb(*recs, cfg.chroma, h, w).to(torch.int64)
         - rgb.to(torch.int64))
    return int((d * d).sum().item())


def _psnr(image: np.ndarray, cfg: CodecConfig,
          place: _codec.Placement) -> float:
    h, w = int(image.shape[0]), int(image.shape[1])
    if image.ndim == 2:
        sse = _plane_sse(image, cfg, place)
        n_px = h * w
    else:
        sse = _rgb_sse(image, cfg, place)
        n_px = h * w * 3
    if sse == 0:
        return float("inf")
    mse = sse / n_px  # the mean of the float64 squares, exactly
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def psnr_at_quality(image: np.ndarray, cfg: CodecConfig,
                    device: str | torch.device | None = None,
                    mesh=None) -> float:
    """EXACT PSNR (dB) of encoding ``image`` under ``cfg``: equal to the
    PSNR of decode(encode(image, cfg)) against image, computed as
    10 log10(255^2 / mse) in float64 over the exact integer SSE, without
    packing or parsing a bitstream. Only the SSE leaves the device. With
    a mesh the roundtrips run sharded; the PSNR is the same float for
    every mesh."""
    return _psnr(image, _normalize_chroma(image.ndim, cfg),
                 _placement(device, mesh))


def encode_to_psnr(
    image: np.ndarray,
    min_psnr: float,
    config: CodecConfig | None = None,
    qualities: tuple[int, ...] = DEFAULT_LADDER,
    strict: bool = True,
    device: str | torch.device | None = None,
    mesh=None,
) -> tuple[bytes, int]:
    """Encode ``image`` at the LOWEST ladder quality whose exact PSNR
    meets ``min_psnr`` dB (the smallest file reaching the distortion
    target). Returns (bytes, quality). If even the highest rung misses:
    raise ValueError when ``strict``, else return its encode. With a mesh
    the probes and the encode run sharded; the quality and the bytes are
    the same for every mesh."""
    place = _placement(device, mesh)
    base = _normalize_chroma(image.ndim, config or CodecConfig())
    ladder = _clean_ladder(qualities)[::-1]  # descending: see _ladder_bisect

    psnrs: dict[int, float] = {}

    def psnr_of(q: int) -> float:
        if q not in psnrs:
            psnrs[q] = _psnr(image, base.replace(quality=q), place)
        return psnrs[q]

    best = _ladder_bisect(
        ladder,
        lambda q: psnr_of(q) >= min_psnr,
        strict,
        lambda q: (
            f"quality {q} reaches only {psnr_of(q):.2f} dB < "
            f"target {min_psnr}"
        ),
    )
    return _color.encode_image(image, base.replace(quality=best),
                               place), best


def encode_to_size(
    image: np.ndarray,
    max_bytes: int,
    config: CodecConfig | None = None,
    qualities: tuple[int, ...] = DEFAULT_LADDER,
    strict: bool = True,
    device: str | torch.device | None = None,
    mesh=None,
) -> tuple[bytes, int]:
    """Encode ``image`` into at most ``max_bytes`` at the highest ladder
    quality that fits. Returns (container bytes, quality). ``config``
    gives every knob but the quality. If even the lowest rung exceeds the
    budget: raise ValueError when ``strict``, else return its encode (over
    budget). The probes are exact, so the container fits whenever a rung
    does. With a mesh the probes and the encode run sharded; the quality
    and the bytes are the same for every mesh."""
    place = _placement(device, mesh)
    base = _normalize_chroma(image.ndim, config or CodecConfig())
    ladder = _clean_ladder(qualities)
    # the RGB -> YCbCr split does not depend on the quality: once
    plane_args = _image_plane_args(image, base, place.device)
    w, h = int(image.shape[1]), int(image.shape[0])

    sizes: dict[int, int] = {}

    def size_of(q: int) -> int:
        if q not in sizes:
            sizes[q] = _container_size_from_planes(
                plane_args, base.replace(quality=q), w, h, place)
        return sizes[q]

    best = _ladder_bisect(
        ladder,
        lambda q: size_of(q) <= max_bytes,
        strict,
        lambda q: f"quality {q} needs {size_of(q)} bytes > budget {max_bytes}",
    )
    return _color.encode_image(image, base.replace(quality=best),
                               place), best
