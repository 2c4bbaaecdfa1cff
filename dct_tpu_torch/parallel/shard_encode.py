"""Sharded encode and decode (port of ``dct_tpu.parallel.shard_encode``):
images striped over the ranks of a (data, stripe) mesh (parallel/mesh.py),
containers byte for byte those of the unsharded codec for every mesh
shape and world size.

  * A frame's stripes are a property of the image (cfg.stripe_rows block
    rows each), not of the mesh: each stripe is an independent
    byte-aligned substream with a table built from the GLOBAL histogram,
    so any assignment of stripes to ranks gives the same container. Where
    the stripe count does not divide the stripe axis it is rounded up
    with mesh-pad stripes (edge rows), which are masked out of every
    histogram and cut from the container.
  * Each rank uploads only its band of rows (and, for frame stacks, its
    frames) and runs the unsharded codec's functions on it
    (models/codec.py): kernel B for the static-table encode and, after
    the analyze pass (kernel A), the dynamic-table one; kernel E for the
    staged pack; kernels D and C to decode. On the CPU they run their
    plain versions.
  * Collectives: each histogram of the dynamic tables is one integer
    all-reduce over the stripe group (over the data group too for a frame
    stack), exact in any order; each assembled output (the bit lengths,
    then the units cut to the global payload width, the variance codes,
    the block bits, the decoded rows) is one all-gather over every rank,
    so every rank writes the same container. Every rank calls every
    collective in the same order, also a rank whose frames are all
    padding. The static-table batch step and each rank's decode of its
    stripes call none.

Collective tensors live on ``mesh.collective_device``: the card under
NCCL, the host under gloo. The two collective calls are ``_all_reduce``
and ``_all_gather``; nothing else here talks to other ranks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from dct_tpu_torch import container as cont
from dct_tpu_torch import tables
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec as _codec
from dct_tpu_torch.models import color as _color
from dct_tpu_torch.models import video as _video
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.ops import blocks as blk
from dct_tpu_torch.ops import entropy_decode_cuda
from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.ops import quant
from dct_tpu_torch.parallel import mesh as meshlib
from dct_tpu_torch.parallel.mesh import DATA_AXIS, STRIPE_AXIS


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """Sum of x over the mesh group of ``dim`` (x is left as it was) ->
    a tensor on the collective device."""
    y = x.to(meshlib.collective_device(mesh), copy=True).contiguous()
    dist.all_reduce(y, group=mesh.get_group(dim))
    return y


def _all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's x (one shape on every rank) -> (n_data, n_stripe,
    *x.shape) on the collective device, by mesh coordinate."""
    x = x.to(meshlib.collective_device(mesh)).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    ranks = mesh.mesh.reshape(-1).tolist()
    return torch.stack([parts[r] for r in ranks]).reshape(
        *meshlib.shape(mesh), *x.shape)


def _psum(x: torch.Tensor, mesh, dims=(STRIPE_AXIS,)) -> np.ndarray:
    """Integer all-reduce of x over the groups of ``dims``, one after the
    other -> the host array."""
    for d in dims:
        x = _all_reduce(x, mesh, d)
    return x.cpu().numpy()


def _gather(x: torch.Tensor, mesh, frames: bool = False) -> torch.Tensor:
    """The whole tensor from the ranks' parts, on the collective device.
    frames False: x (k, ...) is this rank's k stripes (or rows), the same
    on every data row -> (n_stripe * k, ...). frames True: x (f, k, ...)
    is its f frames of k stripes -> (n_data * f, n_stripe * k, ...)."""
    g = _all_gather(x, mesh)
    if not frames:
        return g[0].reshape(-1, *x.shape[1:])
    n_data, n_stripe = g.shape[:2]
    return g.transpose(1, 2).reshape(n_data * x.shape[0],
                                     n_stripe * x.shape[1], *x.shape[2:])


def _host_full(x: torch.Tensor, mesh, frames: bool = False) -> np.ndarray:
    """_gather to a host array: the codec's analog of an MPI gather of
    per-rank results at the writer, made on every rank."""
    return _gather(x, mesh, frames).cpu().numpy()


def stripe_byte_offsets(bit_lengths: torch.Tensor, mesh) -> np.ndarray:
    """Global byte offsets of this rank's stripes in the final payload.

    bit_lengths: (k,) this rank's stripes. One all-gather of every
    stripe's bit length, the exclusive cumulative sum of the byte sizes,
    this rank's slice: the same for every mesh, since the order is the
    stripe index."""
    all_bits = _host_full(bit_lengths, mesh).astype(np.int64)
    nbytes = (all_bits + 7) // 8
    offs = np.cumsum(nbytes) - nbytes
    k = int(bit_lengths.shape[0])
    s = meshlib.coordinate(mesh)[1]
    return offs[s * k:(s + 1) * k]


def global_category_histogram(values: torch.Tensor, live: torch.Tensor,
                              mesh, dims=(STRIPE_AXIS,)) -> np.ndarray:
    """The category histogram of the live symbols of every rank: each
    rank's (B, S) values and live mask, one integer all-reduce per group
    of ``dims``. Exact in any order, so the table is the same for every
    mesh shape."""
    return _psum(hf.category_histogram_masked(values, live), mesh, dims)


def global_run_histogram(runs: torch.Tensor, live: torch.Tensor, mesh,
                         dims=(STRIPE_AXIS,)) -> np.ndarray:
    """The run-length histogram of every rank's live symbols (the
    coded_runs table), as global_category_histogram."""
    return _psum(hf.run_histogram_masked(runs, live), mesh, dims)


def _hist_fallback(symbols, cfg: CodecConfig, live: torch.Tensor):
    """This rank's histogram of a mode that is not "category": direct
    mode's value histogram of the live symbols (the masked blocks of
    mesh-pad stripes and pad frames count nothing), None in "none" mode
    (no table)."""
    if cfg.use_huffman and cfg.huffman_mode == "direct":
        return hf.value_histogram_masked(symbols.values, live,
                                         _codec.DIRECT_VMIN,
                                         -_codec.DIRECT_VMIN)
    return None


def _masked_histograms(symbols, cfg: CodecConfig, live: torch.Tensor, mesh,
                       dims):
    """(histogram or None, run histogram or None) of the live symbols of
    every rank in the groups of ``dims``, as host arrays: one all-reduce
    per histogram and group."""
    if cfg.use_huffman and cfg.huffman_mode == "category":
        hist = global_category_histogram(symbols.values, live, mesh, dims)
    else:
        local = _hist_fallback(symbols, cfg, live)
        hist = None if local is None else _psum(local, mesh, dims)
    run_hist = (global_run_histogram(symbols.runs, live, mesh, dims)
                if cfg.coded_runs else None)
    return hist, run_hist


# ---------------------------------------------------------------------------
# Grid and bands
# ---------------------------------------------------------------------------


def _mesh_stripe_grid(h: int, w: int, cfg: CodecConfig, mesh):
    """Padded grid dims with the stripe count rounded up to divide the
    stripe axis: (bh, bw, n_stripes, n_stripes_padded, bh_real). Mesh-pad
    stripes hold edge rows; bh_real is the block-row count before mesh
    padding (histogram masks and container assembly drop the rest)."""
    bh, bw, n_stripes = _codec._padded_grid(h, w, cfg)
    n_dev = meshlib.shape(mesh)[1]
    n_stripes_p = -(-n_stripes // n_dev) * n_dev
    return n_stripes_p * cfg.stripe_rows, bw, n_stripes, n_stripes_p, bh


def _band(a, mesh, ph: int, pw: int, frames=slice(None)) -> torch.Tensor:
    """This rank's band of rows of a plane (or, with ``frames``, of the
    selected frames of a stack) that every rank holds whole, host array
    or tensor: only the source rows the band needs are copied to the
    mesh's device, then edge-padded to (ph / n_stripe, pw)."""
    rows = meshlib.row_slice(mesh, ph)
    h = int(a.shape[-2])
    r0 = min(rows.start, h - 1)  # a band past the image repeats its edge
    part = a[frames, r0:max(min(rows.stop, h), r0 + 1)]
    return blk.pad_edge(_codec.to_device_u8(part, meshlib.device(mesh)),
                        rows.stop - rows.start, pw)


def _sharded_padded_plane(plane, cfg: CodecConfig, mesh, bh: int,
                          bw: int) -> torch.Tensor:
    """This rank's band of a plane padded to the (mesh-padded) block grid
    by edge replication, on the mesh's device."""
    n = cfg.block_size
    return _band(plane[None], mesh, bh * n, bw * n)[0]


def _dynamic_tables_sharded(symbols, cfg: CodecConfig, mesh, nb_real: int):
    """Global (mesh-invariant) tables from this rank's symbols of its band:
    (table, run_table). The blocks of mesh-pad stripes (global block index
    >= nb_real) are masked out, or the tables, and the whole container,
    would depend on the mesh."""
    nb = symbols.values.shape[0]
    s = meshlib.coordinate(mesh)[1]
    real = torch.arange(s * nb, (s + 1) * nb,
                        device=symbols.values.device) < nb_real
    hist, run_hist = _masked_histograms(
        symbols, cfg, symbols.is_sym & real[:, None], mesh, (STRIPE_AXIS,))
    return _codec._build_table(cfg, hist), _codec._build_run_table(cfg,
                                                                   run_hist)


def _plane_data(w: int, h: int, table, run_table, bits: np.ndarray,
                units: np.ndarray, var_codes, block_bits, n_stripes: int,
                nb_real: int) -> cont.PlaneData:
    """One frame's gathered outputs over the mesh-padded stripes -> its
    PlaneData. Mesh-pad stripes exist only so the stripe count divides the
    stripe axis: their variance codes, block bits and stripes are cut
    here, or the bytes would depend on the mesh."""
    bits = bits[:n_stripes]
    return cont.PlaneData(
        width=w,
        height=h,
        table_lengths=table.lengths if table is not None else None,
        vmin=_codec.DIRECT_VMIN,
        variance_codes=(var_codes[:nb_real] if var_codes is not None
                        else None),
        stripe_bits=bits.astype(np.uint32),
        stripes=bs.stripes_to_bytes(bs.PackedStripes(units[:n_stripes],
                                                     bits)),
        run_table_lengths=(
            run_table.lengths if run_table is not None else None
        ),
        block_bits=(
            block_bits[:n_stripes].reshape(-1).astype(np.uint16)
            if block_bits is not None else None
        ),
    )


def _gather_outputs(packed: bs.PackedStripes, var_codes, block_bits, mesh,
                    frames: bool):
    """Every rank's encode outputs -> host (bits, units, var_codes or None,
    block_bits or None) over the whole grid. The bit lengths first: their
    global maximum sets the units' width (bs.trim_units_count), so every
    rank sends the same shape and only payload-sized units move."""
    bits = _host_full(packed.bit_lengths, mesh, frames)
    u_trim = bs.trim_units_count(bits, packed.units.shape[-1])
    # int32 units (gloo and NCCL have no int16): kernels B and E give an
    # int16 view, whose low 16 bits stripes_to_bytes keeps
    units = _host_full(packed.units[..., :u_trim].to(torch.int32), mesh,
                       frames)
    var = None if var_codes is None else _host_full(var_codes, mesh, frames)
    bb = None if block_bits is None else _host_full(block_bits, mesh, frames)
    return bits, units, var, bb


# ---------------------------------------------------------------------------
# Image encode
# ---------------------------------------------------------------------------


def _encode_step_sharded(img: torch.Tensor, cfg: CodecConfig,
                         n_stripes: int, mesh, chroma: bool = False):
    """Static-table encode of this rank's band (its n_stripes / n_stripe
    stripes) by codec.encode_step: kernel B, or for 2x2 blocks kernels A
    and E. No collective: stripes are independent, the tables fixed."""
    n_dev = meshlib.shape(mesh)[1]
    if n_stripes % n_dev:
        # a silent floor division would re-segment stripes wrongly
        raise ValueError(
            f"n_stripes={n_stripes} must divide over the {n_dev}-rank "
            f"stripe axis"
        )
    return _codec.encode_step(img, cfg, n_stripes // n_dev, chroma)


def encode_plane_sharded(plane, cfg: CodecConfig, mesh,
                         chroma: bool = False) -> cont.PlaneData:
    """Stripe-sharded encode of one (H, W) u8 plane (host array or
    tensor, whole on every rank) to the PlaneData of the unsharded
    encoder, byte for byte. chroma: a Cb or Cr plane (the chrominance
    quant table)."""
    h, w = int(plane.shape[0]), int(plane.shape[1])
    bh, bw, n_stripes, n_stripes_p, bh_real = _mesh_stripe_grid(h, w, cfg,
                                                                mesh)
    img = _sharded_padded_plane(plane, cfg, mesh, bh, bw)
    n_loc = n_stripes_p // meshlib.shape(mesh)[1]
    if cfg.static_tables:
        table = _codec._build_table(cfg, None)
        run_table = _codec._build_run_table(cfg, None)
        packed, var_codes, block_bits = _encode_step_sharded(
            img, cfg, n_stripes_p, mesh, chroma)
    else:
        dev = img.device
        ops = tables.build(cfg, chroma=chroma, device=dev)
        symbols, var_codes, _, _ = _codec.encode_analyze(img, cfg, ops)
        table, run_table = _dynamic_tables_sharded(symbols, cfg, mesh,
                                                   bh_real * bw)
        ops = ops.with_tables(table, run_table)
        if dev.type == "cuda" and _codec.fused_kernel_ok(cfg):
            # as codec.encode_plane: kernel B re-runs the transform
            packed, var_codes, block_bits = _codec.encode_fused_step(
                img, cfg, n_loc, ops)
        else:
            packed, block_bits = _codec.pack_frames(symbols, cfg, (), n_loc,
                                                    ops)
    bits, units, var, bb = _gather_outputs(packed, var_codes, block_bits,
                                           mesh, frames=False)
    return _plane_data(w, h, table, run_table, bits, units, var, bb,
                       n_stripes, bh_real * bw)


def encode_image_sharded(image: np.ndarray, cfg: CodecConfig, mesh) -> bytes:
    """Full sharded encode -> container bytes, the same for every mesh.

    Gray ((H, W) input, cfg.chroma "gray") or color ((H, W, 3) RGB,
    "444"/"420"): the three planes of a color container are each
    stripe-sharded, byte-identical to ColorImageCodec. Every rank converts
    the whole RGB image on its device (color._to_planes), then encodes
    its band of each plane."""
    if cfg.chroma == "gray":
        if image.ndim != 2:
            raise ValueError(f"expected (H, W) grayscale, got {image.shape}")
        planes = [encode_plane_sharded(image, cfg, mesh)]
    else:
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) RGB, got {image.shape}")
        yuv = _color._to_planes(
            _codec.to_device_u8(image, meshlib.device(mesh)), cfg.chroma)
        planes = [encode_plane_sharded(p, cfg, mesh, chroma=i > 0)
                  for i, p in enumerate(yuv)]
    return cont.serialize(cont.Container(
        config=cfg, width=int(image.shape[1]), height=int(image.shape[0]),
        planes=planes))


# ---------------------------------------------------------------------------
# Sharded rate-control probes (models/rate_control.py with a mesh)
# ---------------------------------------------------------------------------


def plane_probe_bits_sharded(plane, cfg: CodecConfig, mesh,
                             chroma: bool = False):
    """Sharded size probe: the per-stripe payload bits of one plane
    without packing, the mesh analog of rate_control._plane_size's bits.
    The sharded analyze pass and the same masked all-reduced tables as
    encode_plane_sharded, then the chunk lengths the packers take
    (rate_control._chunk_bits) on each rank's band, gathered. ->
    (bits[:n_stripes], the real stripes' block bits, variance codes or
    None, table, run_table), the same for every mesh."""
    from dct_tpu_torch.models import rate_control as _rc

    h, w = int(plane.shape[0]), int(plane.shape[1])
    bh, bw, n_stripes, n_stripes_p, bh_real = _mesh_stripe_grid(h, w, cfg,
                                                                mesh)
    img = _sharded_padded_plane(plane, cfg, mesh, bh, bw)
    ops = tables.build(cfg, chroma=chroma, device=img.device)
    symbols, var_codes, _, _ = _codec.encode_analyze(img, cfg, ops)
    if cfg.static_tables:
        table, run_table = _rc._plane_tables(cfg, None, None)
    else:
        table, run_table = _dynamic_tables_sharded(symbols, cfg, mesh,
                                                   bh_real * bw)
    n_loc = n_stripes_p // meshlib.shape(mesh)[1]
    bits, bb = _rc._chunk_bits(symbols, cfg, 1, n_loc,
                               ops.with_tables(table, run_table))
    bits = _host_full(bits[0], mesh)[:n_stripes]
    bb = _host_full(bb[0], mesh)[:n_stripes * cfg.stripe_rows * bw]
    vc = (_host_full(var_codes, mesh)[:bh_real * bw] if cfg.adaptive
          else None)
    return bits, bb, vc, table, run_table


def _band_roundtrip(plane, cfg: CodecConfig, mesh, chroma: bool):
    """(this rank's band of the mesh-padded plane, its quantize +
    reconstruct through the codec's transform pair, first row)."""
    from dct_tpu_torch.models import rate_control as _rc

    h, w = int(plane.shape[0]), int(plane.shape[1])
    bh, bw, _, _, _ = _mesh_stripe_grid(h, w, cfg, mesh)
    img = _sharded_padded_plane(plane, cfg, mesh, bh, bw)
    r0 = meshlib.row_slice(mesh, bh * cfg.block_size).start
    return img, _rc._plane_roundtrip(img, cfg, chroma), r0


def plane_sse_chunks_sharded(plane, cfg: CodecConfig, mesh, chroma: bool,
                             h: int, w: int) -> int:
    """Sharded distortion probe, the mesh analog of
    rate_control.roundtrip_sse's sum: each rank round-trips its band of
    rows through the codec's transform pair (kernels A and C) and sums
    the squared error over the rows and columns inside the (h, w) image
    as an exact int64 (the chunks are the ranks' bands); one all-reduce
    over the stripe group. The same integer for every mesh."""
    img, rec, r0 = _band_roundtrip(plane, cfg, mesh, chroma)
    rows = max(0, min(img.shape[0], h - r0))
    d = (rec[:rows, :w].to(torch.int64) - img[:rows, :w].to(torch.int64))
    return int(_psum((d * d).sum().reshape(1), mesh)[0])


def plane_roundtrip_sharded(plane, cfg: CodecConfig, mesh,
                            chroma: bool) -> torch.Tensor:
    """Sharded quantize + reconstruct of one plane, the mesh analog of
    rate_control._plane_roundtrip: each rank round-trips its band, and
    the bands are gathered to the whole mesh-padded plane on every rank's
    device (callers crop). The sharded RGB distortion probe recombines
    the planes after the gather: 4:2:0 chroma rows do not follow the
    luma bands."""
    _, rec, _ = _band_roundtrip(plane, cfg, mesh, chroma)
    return _gather(rec, mesh).to(meshlib.device(mesh))


# ---------------------------------------------------------------------------
# Sharded decode
# ---------------------------------------------------------------------------


def _rank_stripes(n_stripes: int, mesh) -> tuple[int, int, int]:
    """(first stripe, end of its real stripes, stripes a rank) of this
    rank on the mesh-padded stripe grid; the real range may be empty."""
    n_dev = meshlib.shape(mesh)[1]
    n_loc = -(-n_stripes // n_dev)
    s0 = meshlib.coordinate(mesh)[1] * n_loc
    return s0, max(s0, min(s0 + n_loc, n_stripes)), n_loc


def _decode_step_sharded(zz: torch.Tensor, codes, cfg: CodecConfig,
                         chroma: bool, n_real: int, bw: int) -> torch.Tensor:
    """(NB, n2) coefficients of a rank's n_real stripes, on its device ->
    their rows of pixels: DC un-prediction (stripe-local), dequant + IDCT
    (kernel C; 16x16 blocks the float32 product, codec.decode_transform)
    and block assembly. No collective: blocks share no pixels."""
    if cfg.dc_prediction:
        zz = _codec.dc_reconstruct(zz, n_real)
    scale = None
    if codes is not None:
        scale = quant.scale_from_variance_code(
            torch.from_numpy(np.asarray(codes, np.uint8)).to(zz.device))
    ops = tables.build(cfg, chroma=chroma, device=zz.device)
    n = cfg.block_size
    px = _codec.decode_transform(zz, cfg, ops, scale)
    return blk.blocks_to_image(px, n_real * cfg.stripe_rows * n, bw * n, n)


def _device_decode_step_sharded(p: cont.PlaneData, cfg: CodecConfig, table,
                                run_table, mode: str, s0: int, s1: int,
                                bps: int, device) -> torch.Tensor:
    """Kernel D on the stripes [s0, s1) of an indexed (v2) plane: their
    units and index rows only (codec.indexed_operands) -> (NB, n2) int16
    coefficients on ``device``."""
    bb = np.asarray(p.block_bits).reshape(-1, bps)[s0:s1]
    return entropy_decode_cuda.decode_blocks_kernel(**_codec.indexed_operands(
        p.stripes[s0:s1], bb, table, run_table, mode, cfg.n2, device))


def _device_decode_plane_sharded(p: cont.PlaneData, cfg: CodecConfig,
                                 mesh, table, mode: str, run_table, s0: int,
                                 s1: int, bps: int):
    """This rank's coefficients of an indexed (v2) plane with the entropy
    stage on its device (kernel D), or None when kernel D does not take
    the plane (codec.indexed_decode_ok): the caller's host path."""
    if not _codec.indexed_decode_ok(p, cfg, table, run_table):
        return None
    return _device_decode_step_sharded(p, cfg, table, run_table, mode, s0,
                                       s1, bps, meshlib.device(mesh))


def _decode_plane_sharded(p: cont.PlaneData, cfg: CodecConfig, mesh,
                          chroma: bool = False) -> torch.Tensor:
    """One container plane -> this rank's band of the mesh-padded plane
    ((n_loc * stripe_rows * n, bw * n) u8 on its device), with no
    collective: the rank entropy-decodes only its stripes, on the device
    (kernel D) for an indexed plane, else on the host, and reconstructs
    their rows (kernel C). The rows of mesh-pad stripes stay zero (they
    are cropped)."""
    n = cfg.block_size
    bh, bw, n_stripes = _codec._padded_grid(p.height, p.width, cfg)
    bps = cfg.stripe_rows * bw
    s0, s1, n_loc = _rank_stripes(n_stripes, mesh)
    dev = meshlib.device(mesh)
    band = torch.zeros(n_loc * cfg.stripe_rows * n, bw * n, dtype=torch.uint8,
                       device=dev)
    if s1 == s0:
        return band
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    table = hf.CanonicalTable(p.table_lengths) if mode != "none" else None
    run_table = (hf.CanonicalTable(p.run_table_lengths) if cfg.coded_runs
                 else None)
    zz = _device_decode_plane_sharded(p, cfg, mesh, table, mode, run_table,
                                      s0, s1, bps)
    if zz is None:
        zz = torch.from_numpy(_codec._decode_stripes(
            dataclasses.replace(p, stripes=p.stripes[s0:s1]), cfg,
            table, mode, s1 - s0, bps, run_table)).to(dev)
    codes = (np.asarray(p.variance_codes)[s0 * bps:s1 * bps] if cfg.adaptive
             else None)
    rows = _decode_step_sharded(zz, codes, cfg, chroma, s1 - s0, bw)
    band[:rows.shape[0]] = rows
    return band


def decode_image_sharded(data: bytes, mesh) -> torch.Tensor:
    """Sharded decode: container bytes (on every rank) -> the whole (H, W)
    gray or (H, W, 3) RGB u8 image on every rank's device, the mirror of
    encode_image_sharded. Each rank decodes its stripes of each plane
    (_decode_plane_sharded), one all-gather a plane assembles it, and a
    color image is recombined by color.planes_to_rgb. The mesh's device
    decides the route: kernels on the card, plain versions on the CPU."""
    c = cont.deserialize(data)
    cfg = c.config
    dev = meshlib.device(mesh)
    planes = [
        _gather(_decode_plane_sharded(p, cfg, mesh, chroma=i > 0),
                mesh).to(dev)[:p.height, :p.width]
        for i, p in enumerate(c.planes)
    ]
    if cfg.chroma == "gray":
        return planes[0]
    return _color.planes_to_rgb(*planes, cfg.chroma, c.height, c.width)


# ---------------------------------------------------------------------------
# Sharded video encode (models/video.py with a mesh): data x stripe over
# frame stacks, byte-identical to the unsharded VideoCodec for every mesh
# ---------------------------------------------------------------------------


def _pad_frames(sub: np.ndarray, cfg: CodecConfig, mesh, ph: int, pw: int,
                f_pad: int) -> torch.Tensor:
    """This rank's part of a frame chunk on the (mesh-padded) grid and
    padded to f_pad frames: its frames (a pad frame repeats the last
    frame; its outputs are dropped and its histograms masked) and its
    band of rows, on its device."""
    fs = meshlib.frame_slice(mesh, f_pad)
    idx = np.minimum(np.arange(fs.start, fs.stop), sub.shape[0] - 1)
    return _band(np.asarray(sub), mesh, ph, pw, frames=idx)


def _video_hist_step(fr: torch.Tensor, cfg: CodecConfig, mesh, ops,
                     nb_real: int, f_real: int):
    """Pass 1 on this rank's part of a chunk: the analyze pass, then the
    chunk's histograms summed over both mesh axes (the whole world) with
    pad frames and mesh-pad stripes masked out, so the tables, and the
    bytes, depend neither on the mesh nor on the frame padding. ->
    (symbols, var_codes, histogram or None, run histogram or None)."""
    symbols, var_codes, _, _ = _codec.encode_analyze(fr, cfg, ops)
    f_l = fr.shape[0]
    nb_l = symbols.values.shape[0] // f_l
    d, s = meshlib.coordinate(mesh)
    dev = symbols.values.device
    real = ((torch.arange(d * f_l, (d + 1) * f_l, device=dev) < f_real)[:, None]
            & (torch.arange(s * nb_l, (s + 1) * nb_l, device=dev)
               < nb_real)[None, :])
    hist, run_hist = _masked_histograms(
        symbols, cfg, symbols.is_sym & real.reshape(-1, 1), mesh,
        (DATA_AXIS, STRIPE_AXIS))
    return symbols, var_codes, hist, run_hist


def _video_encode_step(fr: torch.Tensor, cfg: CodecConfig, n_stripes: int,
                       mesh, chroma: bool, ops):
    """Pass 2 on this rank's part of a chunk, as the unsharded encoder's
    several-chunk pass 2: static tables through codec.encode_step,
    dynamic through kernel B where codec.fused_kernel_ok, else the
    analyze pass and kernel E, against the global tables in ``ops``. ->
    (PackedStripes, var_codes, block_bits-or-None) with the frame axis."""
    if cfg.static_tables:
        return _encode_step_sharded(fr, cfg, n_stripes, mesh, chroma)
    n_loc = n_stripes // meshlib.shape(mesh)[1]
    if _codec.fused_kernel_ok(cfg):
        return _codec.encode_fused_step(fr, cfg, n_loc, ops)
    return _codec.encode_staged_step(fr, cfg, n_loc, ops)


def _video_bits_step(symbols, cfg: CodecConfig, f_loc: int, n_stripes: int,
                     mesh, ops):
    """Size-probe step on this rank's part of a chunk: the bits a stripe
    and a block of its symbols against the global tables
    (rate_control._chunk_bits) -> ((f_loc, k) int64, (f_loc, NB) int64)
    tensors."""
    from dct_tpu_torch.models import rate_control as _rc

    return _rc._chunk_bits(symbols, cfg, f_loc,
                           n_stripes // meshlib.shape(mesh)[1], ops)


def _video_chunks(f: int, h: int, w: int, mesh,
                  chunk_frames: int | None) -> int:
    """Frames per sharded chunk: the unsharded rule
    (video.frames_per_chunk) rounded up to a multiple of the data axis
    (pad frames are masked and dropped)."""
    n_data = meshlib.shape(mesh)[0]
    chunk = _video.frames_per_chunk(f, h, w, chunk_frames)
    return -(-chunk // n_data) * n_data


def _chunks(f: int, mesh, chunk: int):
    """(first frame, real frames, frames padded to the data axis) of each
    chunk of an f-frame stack."""
    n_data = meshlib.shape(mesh)[0]
    for i0 in range(0, f, chunk):
        f_real = min(chunk, f - i0)
        yield i0, f_real, -(-f_real // n_data) * n_data


class _VideoPlan(NamedTuple):
    """What the sharded encode and size probe of a plane stack share."""
    grid: tuple  # _mesh_stripe_grid
    chunk: int
    ph: int
    pw: int
    ops: tables.CodecOperators  # with the stack's tables
    table: hf.CanonicalTable | None
    run_table: hf.CanonicalTable | None
    once: tuple | None  # (symbols, var_codes) of a one-chunk stack


def _video_tables_sharded(planes: np.ndarray, cfg: CodecConfig, mesh, ops,
                          chunk: int, ph: int, pw: int, nb_real: int):
    """Pass 1 under the mesh: the stack's tables from the masked,
    all-reduced histograms of each chunk, summed in int64 on the host as
    the unsharded encoder sums them. -> (table, run_table, (symbols,
    var_codes) of this rank's part when the stack is one chunk, else
    None: as the unsharded encoder, one chunk is analyzed once)."""
    f = int(planes.shape[0])
    hist = run_hist = once = None
    for i0, f_real, f_pad in _chunks(f, mesh, chunk):
        fr = _pad_frames(planes[i0:i0 + chunk], cfg, mesh, ph, pw, f_pad)
        symbols, var_codes, h_, rh_ = _video_hist_step(fr, cfg, mesh, ops,
                                                       nb_real, f_real)
        if h_ is not None:
            hist = h_.astype(np.int64) + (0 if hist is None else hist)
        if rh_ is not None:
            run_hist = rh_.astype(np.int64) + (0 if run_hist is None
                                               else run_hist)
        if f_real == f:
            once = (symbols, var_codes)
    return (_codec._build_table(cfg, hist),
            _codec._build_run_table(cfg, run_hist), once)


def _video_plan(planes: np.ndarray, cfg: CodecConfig, mesh, chroma: bool,
                chunk_frames: int | None) -> _VideoPlan:
    """The grid, the chunking and the stack's tables (pass 1 for dynamic
    tables) of an (F, h, w) plane stack."""
    f, h, w = (int(x) for x in planes.shape)
    grid = _mesh_stripe_grid(h, w, cfg, mesh)
    bh, bw, _, _, bh_real = grid
    n = cfg.block_size
    chunk = _video_chunks(f, h, w, mesh, chunk_frames)
    ops = tables.build(cfg, chroma=chroma, device=meshlib.device(mesh))
    once = None
    if cfg.static_tables:
        table = _codec._build_table(cfg, None)
        run_table = _codec._build_run_table(cfg, None)
    else:
        table, run_table, once = _video_tables_sharded(
            planes, cfg, mesh, ops, chunk, bh * n, bw * n, bh_real * bw)
    return _VideoPlan(grid, chunk, bh * n, bw * n,
                      ops.with_tables(table, run_table), table, run_table,
                      once)


def encode_video_plane_batch_sharded(
    planes: np.ndarray,
    cfg: CodecConfig,
    mesh,
    chroma: bool = False,
    chunk_frames: int | None = None,
) -> list[cont.PlaneData]:
    """(F, h, w) u8 plane stack -> one PlaneData per frame, frames over
    the data axis and stripes over the stripe axis, byte-identical to
    video._encode_plane_batch for every mesh (the stack's tables from
    masked all-reduced histograms: mesh-pad stripes and pad frames count
    nothing)."""
    f, h, w = (int(x) for x in planes.shape)
    plan = _video_plan(planes, cfg, mesh, chroma, chunk_frames)
    _, bw, n_stripes, n_stripes_p, bh_real = plan.grid
    n_data, n_dev = meshlib.shape(mesh)
    out: list[cont.PlaneData] = []
    for i0, f_real, f_pad in _chunks(f, mesh, plan.chunk):
        if plan.once is not None:
            # one chunk: pack the pass-1 symbols with one kernel E launch
            symbols, var_codes = plan.once
            packed, block_bits = _codec.pack_frames(
                symbols, cfg, (f_pad // n_data,), n_stripes_p // n_dev,
                plan.ops)
        else:
            fr = _pad_frames(planes[i0:i0 + plan.chunk], cfg, mesh, plan.ph,
                             plan.pw, f_pad)
            packed, var_codes, block_bits = _video_encode_step(
                fr, cfg, n_stripes_p, mesh, chroma, plan.ops)
        bits, units, var, bb = _gather_outputs(packed, var_codes, block_bits,
                                               mesh, frames=True)
        out += [_plane_data(w, h, plan.table, plan.run_table, bits[i],
                            units[i], None if var is None else var[i],
                            None if bb is None else bb[i], n_stripes,
                            bh_real * bw)
                for i in range(f_real)]
    return out


def encode_video_sharded(frames: np.ndarray, cfg: CodecConfig, mesh,
                         chunk_frames: int | None = None) -> list[bytes]:
    """Sharded VideoCodec.encode: (F, H, W) gray or (F, H, W, 3) RGB ->
    per-frame containers, byte-identical to the unsharded VideoCodec for
    every mesh."""
    return _video.VideoCodec(cfg, chunk_frames, mesh=mesh).encode(frames)


def video_plane_batch_bits_sharded(
    planes: np.ndarray,
    cfg: CodecConfig,
    mesh,
    chroma: bool,
    chunk_frames: int | None,
):
    """Sharded video size probe: ((F, n_stripes) bits a stripe, (F, NB)
    bits a block of the real stripes, table, run_table), the mesh analog
    of rate_control._plane_batch_bits, equal to the unsharded counts for
    every mesh."""
    f = int(planes.shape[0])
    plan = _video_plan(planes, cfg, mesh, chroma, chunk_frames)
    _, bw, n_stripes, n_stripes_p, _ = plan.grid
    n_data = meshlib.shape(mesh)[0]
    nb = n_stripes * cfg.stripe_rows * bw
    bits, bbs = [], []
    for i0, f_real, f_pad in _chunks(f, mesh, plan.chunk):
        if plan.once is not None:
            symbols = plan.once[0]
        else:
            symbols = _codec.encode_analyze(_pad_frames(
                planes[i0:i0 + plan.chunk], cfg, mesh, plan.ph, plan.pw,
                f_pad), cfg, plan.ops)[0]
        b, bb = _video_bits_step(symbols, cfg, f_pad // n_data, n_stripes_p,
                                 mesh, plan.ops)
        bits.append(_host_full(b, mesh, frames=True)[:f_real, :n_stripes])
        bbs.append(_host_full(bb, mesh, frames=True)[:f_real, :nb])
    return np.concatenate(bits), np.concatenate(bbs), plan.table, \
        plan.run_table


# ---------------------------------------------------------------------------
# Batched multi-frame sharded encode (data x stripe): the "training step"
# ---------------------------------------------------------------------------


def encode_batch_step(frames, cfg: CodecConfig, n_stripes: int, mesh):
    """One static-table step over a batch of padded frames.

    frames: (F, Hp, Wp) u8 (host array or tensor, whole on every rank),
    frames over the data axis and rows over the stripe axis. Returns this
    rank's PackedStripes, units (F / n_data, n_stripes / n_stripe, U) and
    bit lengths (F / n_data, n_stripes / n_stripe). Pure SPMD: no
    collective (the offsets exchange happens in stripe_byte_offsets when
    assembling)."""
    fs = meshlib.frame_slice(mesh, int(frames.shape[0]))
    part = _band(frames, mesh, int(frames.shape[1]), int(frames.shape[2]),
                 frames=fs)
    return _encode_step_sharded(part, cfg, n_stripes, mesh)[0]
