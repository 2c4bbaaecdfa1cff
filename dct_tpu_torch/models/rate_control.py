"""Rate-distortion control: encode to a byte budget or a PSNR target by
probing EXACT container sizes and distortions on the device (port of
``dct_tpu.models.rate_control``). With ``mesh=`` (parallel/mesh.py) the
probes, and the final encodes, run sharded over its ranks
(parallel/shard_encode.py) and return the same integers, the same PSNR
and the same bytes as without it, for every mesh shape.

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
from dct_tpu_torch.parallel import mesh as meshlib
from dct_tpu_torch.parallel import shard_encode as _se

# Quality rungs for the encode_to_* ladders: dense where the size/quality
# curve is steep (high quality), sparse where it is flat.
DEFAULT_LADDER = (1, 5, 10, 15, 20, 30, 40, 50, 60, 70, 80, 85, 90, 95, 97, 100)


def _device(device, mesh=None) -> torch.device:
    """The entry point's device: the mesh's when it is given one."""
    if mesh is not None:
        return meshlib.entry_device(mesh, device)
    return (torch.device(device) if device is not None
            else _codec._default_device())


def _encode(image: np.ndarray, cfg: CodecConfig, device, mesh) -> bytes:
    """The final encode of the encode_to_* fronts, sharded with a mesh."""
    if mesh is not None:
        return _se.encode_image_sharded(image, cfg, mesh)
    return _codec.encode(image, cfg, device)


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


def _plane_size(plane: torch.Tensor, cfg: CodecConfig, chroma: bool,
                mesh=None) -> tuple[np.ndarray, cont.PlaneData]:
    """(per-stripe bit counts, empty-stripe skeleton) of one (H, W) u8
    plane tensor at cfg.quality, on its device: codec.encode_plane up to
    (not including) the pack. With a mesh, the analyze pass and the
    chunk-length sums run sharded, with the tables of
    shard_encode.encode_plane_sharded: the same counts for every mesh."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    _, _, n_stripes = _codec._padded_grid(h, w, cfg)
    if mesh is not None:
        bits, bb, vc, table, run_table = _se.plane_probe_bits_sharded(
            plane, cfg, mesh, chroma)
        return bits, _probe_skeleton(w, h, cfg, n_stripes, table, run_table,
                                     vc, bits, bb)
    img = _codec.pad_plane_for_encode(plane, cfg)
    ops = tables.build(cfg, chroma=chroma, device=img.device)
    symbols, var_codes, hist, run_hist = _codec.encode_analyze(img, cfg, ops)
    if cfg.static_tables:
        table, run_table = _plane_tables(cfg, None, None)
    else:
        table, run_table = _plane_tables(cfg, hist.cpu().numpy(),
                                         run_hist.cpu().numpy())
    bits, bb = (t.cpu().numpy() for t in _chunk_bits(
        symbols, cfg, 1, n_stripes, ops.with_tables(table, run_table)))
    return bits[0], _probe_skeleton(
        w, h, cfg, n_stripes, table, run_table,
        var_codes.cpu().numpy() if cfg.adaptive else None, bits[0], bb[0],
    )


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
    h: int, mesh=None,
) -> int:
    payload = 0
    skeletons = []
    for plane, chroma in plane_args:
        bits, skel = _plane_size(plane, cfg, chroma, mesh)
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
    return _container_size_from_planes(
        _image_plane_args(image, cfg, _device(device, mesh)), cfg,
        int(image.shape[1]), int(image.shape[0]), mesh)


# ---------------------------------------------------------------------------
# Video (frame stacks, models/video.py)
# ---------------------------------------------------------------------------


def _plane_batch_bits(
    planes: np.ndarray,
    cfg: CodecConfig,
    chroma: bool,
    chunk_frames: int | None,
    device: torch.device,
    mesh=None,
):
    """((F, n_stripes) bits a stripe, (F, NB) bits a block, skeleton
    factory frame -> PlaneData) of an (F, h, w) plane stack at
    cfg.quality: video._encode_plane_batch up to (not including) the pack,
    with the stack's tables and chunks of frames. A stack of one chunk is
    analyzed once; a longer one drops each chunk's symbols after its
    histograms (keeping them would unbound the memory CHUNK_PIXEL_BUDGET
    bounds) and analyzes again to count. Skeletons are per frame: the
    packed decode index's width depends on each frame's block bits. With a
    mesh the counts come from shard_encode.video_plane_batch_bits_sharded,
    the same for every mesh."""
    f, h, w = (int(x) for x in planes.shape)
    bh, bw, n_stripes = _codec._padded_grid(h, w, cfg)
    if mesh is not None:
        bits, bbs, table, run_table = _se.video_plane_batch_bits_sharded(
            planes, cfg, mesh, chroma, chunk_frames)
    else:
        bits, bbs, table, run_table = _plane_batch_counts(
            planes, cfg, chroma, chunk_frames, device, n_stripes)

    def skeleton(i: int) -> cont.PlaneData:
        return _probe_skeleton(
            w, h, cfg, n_stripes, table, run_table,
            np.zeros(bh * bw, np.uint8) if cfg.adaptive else None,
            bits[i], bbs[i],
        )

    return bits, bbs, skeleton


def _plane_batch_counts(planes: np.ndarray, cfg: CodecConfig, chroma: bool,
                        chunk_frames: int | None, device: torch.device,
                        n_stripes: int):
    """_plane_batch_bits on one device -> (bits, block bits, table,
    run_table)."""
    f, h, w = (int(x) for x in planes.shape)
    chunk = _video.frames_per_chunk(f, h, w, chunk_frames)
    ops = tables.build(cfg, chroma=chroma, device=device)

    def analyze(i0: int):
        img = _codec.pad_plane_for_encode(
            _codec.to_device_u8(planes[i0:i0 + chunk], device), cfg)
        return _codec.encode_analyze(img, cfg, ops)

    symbols_once = None
    if cfg.static_tables:
        table, run_table = _plane_tables(cfg, None, None)
    elif f <= chunk:
        symbols_once, _, hist, run_hist = analyze(0)
        table, run_table = _plane_tables(cfg, hist.cpu().numpy(),
                                         run_hist.cpu().numpy())
    else:
        # summed in int64 on the host, as the encoder's pass 1 does
        hist = run_hist = 0
        for i0 in range(0, f, chunk):
            _, _, h_, rh_ = analyze(i0)
            hist = hist + h_.cpu().numpy().astype(np.int64)
            run_hist = run_hist + rh_.cpu().numpy().astype(np.int64)
        table, run_table = _plane_tables(cfg, hist, run_hist)
    ops = ops.with_tables(table, run_table)

    bits, bbs = [], []
    for i0 in range(0, f, chunk):
        sym = symbols_once if symbols_once is not None else analyze(i0)[0]
        b, bb = _chunk_bits(sym, cfg, min(chunk, f - i0), n_stripes, ops)
        bits.append(b.cpu().numpy())
        bbs.append(bb.cpu().numpy())
    return np.concatenate(bits), np.concatenate(bbs), table, run_table


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
    device: torch.device,
    mesh=None,
) -> np.ndarray:
    f = int(plane_batches[0][0].shape[0])
    per_frame = np.zeros(f, np.int64)
    skel_factories = []
    for batch, chroma in plane_batches:
        bits, _, skel = _plane_batch_bits(batch, cfg, chroma, chunk_frames,
                                          device, mesh)
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
    device = _device(device, mesh)
    batches = _video_plane_batches(frames, cfg, chunk_frames, device)
    h, w = int(frames.shape[1]), int(frames.shape[2])
    return _video_sizes_from_batches(batches, cfg, w, h, chunk_frames,
                                     device, mesh)


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
    device = _device(device, mesh)
    base = config or CodecConfig()
    if frames.ndim == 4 and base.chroma == "gray":
        base = base.replace(chroma="420")
    ladder = _clean_ladder(qualities)
    # the RGB -> YCbCr split does not depend on the quality: once
    batches = _video_plane_batches(frames, base, chunk_frames, device)
    h, w = int(frames.shape[1]), int(frames.shape[2])

    totals: dict[int, int] = {}

    def size_of(q: int) -> int:
        if q not in totals:
            totals[q] = int(_video_sizes_from_batches(
                batches, base.replace(quality=q), w, h, chunk_frames,
                device, mesh).sum())
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
                                chunk_frames=chunk_frames, device=device,
                                mesh=mesh).encode(frames)
    return streams, best


# ---------------------------------------------------------------------------
# Distortion probes (exact PSNR without a bitstream)
# ---------------------------------------------------------------------------


def _plane_roundtrip(plane: torch.Tensor, cfg: CodecConfig,
                     chroma: bool) -> torch.Tensor:
    """Quantize and reconstruct one (H, W) u8 plane tensor with the
    codec's transform pair on its device (kernel A, then kernel C: the
    ops decode_plane_device runs on the integers the wire carries) ->
    the (H, W) u8 reconstruction."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    img = _codec.pad_plane_for_encode(plane, cfg)
    n = cfg.block_size
    pixels = _codec.blk.image_to_blocks(img, n).reshape(-1, cfg.n2)
    _, scale = _codec._adaptive(pixels, cfg)
    ops = tables.build(cfg, chroma=chroma, device=img.device)
    zz = _codec.encode_transform(pixels, cfg, ops, scale)
    rec = _codec.decode_transform(zz, cfg, ops, scale)
    return _codec.blk.blocks_to_image(rec, img.shape[0], img.shape[1],
                                      n)[:h, :w]


def _sse(a: torch.Tensor, b: torch.Tensor) -> int:
    """Exact sum of squared differences of two u8 tensors (int64 on their
    device: each square is at most 255^2)."""
    d = a.to(torch.int64) - b.to(torch.int64)
    return int((d * d).sum().item())


def roundtrip_sse(image: np.ndarray, cfg: CodecConfig,
                  device: str | torch.device | None = None,
                  mesh=None) -> int:
    """EXACT sum of squared pixel errors of encode -> decode under
    ``cfg``, without a bitstream. Gray (H, W) only; color goes through
    psnr_at_quality (its reconstruction crosses planes). With a mesh each
    rank round-trips its band of rows
    (shard_encode.plane_sse_chunks_sharded): the same integer for every
    mesh."""
    if image.ndim != 2:
        raise ValueError("roundtrip_sse takes a grayscale (H, W) plane")
    if mesh is not None:
        return _se.plane_sse_chunks_sharded(
            image, cfg, mesh, False, int(image.shape[0]), int(image.shape[1]))
    x = _codec.to_device_u8(image, _device(device))
    return _sse(_plane_roundtrip(x, cfg, False), x)


def _rgb_sse(image: np.ndarray, cfg: CodecConfig, device: torch.device,
             mesh=None) -> int:
    """Exact roundtrip squared error of an RGB image: the YCbCr split,
    each plane's quantize and reconstruct (the chrominance table on Cb
    and Cr, 4:2:0 resampling), the RGB reassembly of
    ColorImageCodec.decode_to_device. With a mesh each plane's roundtrip
    runs sharded and is gathered (shard_encode.plane_roundtrip_sharded)
    before the reassembly, whose 4:2:0 chroma rows do not follow the luma
    bands."""
    rgb = _codec.to_device_u8(image, device)
    recs = []
    for i, p in enumerate(_color._to_planes(rgb, cfg.chroma)):
        if mesh is None:
            recs.append(_plane_roundtrip(p, cfg, chroma=i > 0))
        else:
            recs.append(_se.plane_roundtrip_sharded(
                p, cfg, mesh, chroma=i > 0)[:p.shape[0], :p.shape[1]])
    h, w = int(image.shape[0]), int(image.shape[1])
    return _sse(_color.planes_to_rgb(*recs, cfg.chroma, h, w), rgb)


def psnr_at_quality(image: np.ndarray, cfg: CodecConfig,
                    device: str | torch.device | None = None,
                    mesh=None) -> float:
    """EXACT PSNR (dB) of encoding ``image`` under ``cfg``: equal to the
    PSNR of decode(encode(image, cfg)) against image, computed as
    10 log10(255^2 / mse) in float64 over the exact integer SSE, without
    packing or parsing a bitstream. Only the SSE leaves the device. With
    a mesh the roundtrips run sharded; the PSNR is the same float for
    every mesh."""
    cfg = _normalize_chroma(image.ndim, cfg)
    device = _device(device, mesh)
    h, w = int(image.shape[0]), int(image.shape[1])
    if image.ndim == 2:
        sse = roundtrip_sse(image, cfg, device, mesh)
        n_px = h * w
    else:
        sse = _rgb_sse(image, cfg, device, mesh)
        n_px = h * w * 3
    if sse == 0:
        return float("inf")
    mse = sse / n_px  # the mean of the float64 squares, exactly
    return float(10.0 * np.log10(255.0 ** 2 / mse))


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
    device = _device(device, mesh)
    base = _normalize_chroma(image.ndim, config or CodecConfig())
    ladder = _clean_ladder(qualities)[::-1]  # descending: see _ladder_bisect

    psnrs: dict[int, float] = {}

    def psnr_of(q: int) -> float:
        if q not in psnrs:
            psnrs[q] = psnr_at_quality(image, base.replace(quality=q), device,
                                       mesh)
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
    return _encode(image, base.replace(quality=best), device, mesh), best


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
    device = _device(device, mesh)
    base = _normalize_chroma(image.ndim, config or CodecConfig())
    ladder = _clean_ladder(qualities)
    # the RGB -> YCbCr split does not depend on the quality: once
    plane_args = _image_plane_args(image, base, device)
    w, h = int(image.shape[1]), int(image.shape[0])

    sizes: dict[int, int] = {}

    def size_of(q: int) -> int:
        if q not in sizes:
            sizes[q] = _container_size_from_planes(
                plane_args, base.replace(quality=q), w, h, mesh)
        return sizes[q]

    best = _ladder_bisect(
        ladder,
        lambda q: size_of(q) <= max_bytes,
        strict,
        lambda q: f"quality {q} needs {size_of(q)} bytes > budget {max_bytes}",
    )
    return _encode(image, base.replace(quality=best), device, mesh), best
