"""Sharded encode and decode (port of ``dct_tpu.parallel.shard_encode``):
images striped over the ranks of a (data, stripe) mesh (parallel/mesh.py),
containers byte for byte those of the unsharded codec for every mesh
shape and world size. The module holds the two collective calls, the
mesh's placement and the public sharded entry points; the plans are the
codec's own (models/), handed a MeshPlacement.

  * A frame's stripes are a property of the image (cfg.stripe_rows block
    rows each), not of the mesh: each stripe is an independent
    byte-aligned substream with a table built from the GLOBAL histogram,
    so any assignment of stripes to ranks gives the same container. Where
    the stripe count does not divide the stripe axis it is rounded up
    with mesh-pad stripes (edge rows), which are masked out of every
    histogram and cut from the container.
  * Each rank uploads only its band of rows (and, for frame stacks, its
    frames, padded to the data axis by repeating the last) and runs the
    codec's plans on it (models/codec.py, models/video.py,
    models/rate_control.py): the plan's kernels, or on the CPU their
    plain versions, over the rank's stripes.
  * Collectives: each histogram of the dynamic tables is one integer
    all-reduce over the stripe group (over the data group too for a frame
    stack), exact in any order; each assembled output (the bit lengths,
    then the units cut to the global payload width, the variance codes,
    the block bits, the decoded rows) is one all-gather over every rank,
    so every rank writes the same container. Every rank calls every
    collective in the same order, also a rank whose frames are all
    padding. The static-table batch step calls none; a decode calls one
    all-reduce, of its ranks' failures, before its gathers.

Collective tensors live on ``mesh.collective_device``: the card under
NCCL, the host under gloo. The two collective calls are ``_all_reduce``
and ``_all_gather``; nothing else here talks to other ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from dct_tpu_torch import container as cont
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec as _codec
from dct_tpu_torch.models import color as _color
from dct_tpu_torch.models import video as _video
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.ops import blocks as blk
from dct_tpu_torch.ops import huffman as hf
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


def _masked_histograms(symbols, cfg: CodecConfig, live: torch.Tensor, mesh,
                       dims):
    """(histogram or None, run histogram or None) of the live symbols of
    every rank in the groups of ``dims``, as host arrays: one all-reduce
    per histogram and group. Direct mode's histogram is of the values;
    "none" mode has no table."""
    hist = None
    if cfg.use_huffman and cfg.huffman_mode == "category":
        hist = global_category_histogram(symbols.values, live, mesh, dims)
    elif cfg.use_huffman and cfg.huffman_mode == "direct":
        hist = _psum(hf.value_histogram_masked(
            symbols.values, live, _codec.DIRECT_VMIN, -_codec.DIRECT_VMIN),
            mesh, dims)
    run_hist = (global_run_histogram(symbols.runs, live, mesh, dims)
                if cfg.coded_runs else None)
    return hist, run_hist


# ---------------------------------------------------------------------------
# The mesh's placement
# ---------------------------------------------------------------------------


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


class MeshPlacement(_codec.Placement):
    """A plan's data over the ranks of a make_mesh mesh: a plane's stripes
    over the stripe axis (every data row holds the same), a stack's
    frames over the data axis too; every rank holds the input whole and
    uploads only its part. Histograms are masked to the real blocks and
    frames and all-reduced; outputs are gathered to every rank's host and
    cut to the real frames and stripes, so a plan gives the same result
    for every mesh."""

    def __init__(self, mesh, requested=None):
        self.mesh = mesh
        self.shape = meshlib.shape(mesh)
        self.device = meshlib.entry_device(mesh, requested)

    def upload(self, a, grid: _codec.Grid, f_pad: int | None = None):
        if f_pad is None:
            return _band(a[None], self.mesh, grid.ph, grid.pw)[0]
        fs = meshlib.frame_slice(self.mesh, f_pad)
        idx = np.minimum(np.arange(fs.start, fs.stop), a.shape[0] - 1)
        return _band(np.asarray(a), self.mesh, grid.ph, grid.pw, frames=idx)

    def histograms(self, symbols, hist, run_hist, cfg: CodecConfig,
                   grid: _codec.Grid, f_real: int | None = None):
        """The histograms of every rank's live symbols, the blocks of
        mesh-pad stripes (and the pad frames of a chunk) masked out, or
        the tables, and the whole container, would depend on the mesh;
        summed over the stripe group (and the data group for a chunk)."""
        nb_l = grid.n_loc * grid.bps
        f_l = symbols.values.shape[0] // nb_l
        d, s = meshlib.coordinate(self.mesh)
        dev = symbols.values.device
        real = (torch.arange(s * nb_l, (s + 1) * nb_l, device=dev)
                < grid.n_stripes * grid.bps)[None, :]
        dims = (STRIPE_AXIS,)
        if f_real is not None:
            real = real & (torch.arange(d * f_l, (d + 1) * f_l, device=dev)
                           < f_real)[:, None]
            dims = (DATA_AXIS, STRIPE_AXIS)
        return _masked_histograms(symbols, cfg,
                                  symbols.is_sym & real.reshape(-1, 1),
                                  self.mesh, dims)

    def host(self, x: torch.Tensor, n_real: int,
             f_real: int | None = None) -> np.ndarray:
        if f_real is None:
            return _host_full(x, self.mesh)[:n_real]
        return _host_full(x, self.mesh, frames=True)[:f_real, :n_real]

    def outputs(self, packed: bs.PackedStripes, var_codes, block_bits,
                grid: _codec.Grid, f_real: int | None = None):
        """The bit lengths first: their global maximum sets the units'
        width (bs.trim_units_count), so every rank sends the same shape
        and only payload-sized units move."""
        frames = f_real is not None
        n = grid.n_stripes
        bits = _host_full(packed.bit_lengths, self.mesh, frames)
        u_trim = bs.trim_units_count(bits, packed.units.shape[-1])
        # int32 units (gloo and NCCL have no int16): kernels B and E give an
        # int16 view, whose low 16 bits the payload pass keeps
        units = self.host(packed.units[..., :u_trim].to(torch.int32), n,
                          f_real)
        bits = bits[:f_real, :n] if frames else bits[:n]
        return (bs.PackedStripes(units, bits),
                None if var_codes is None
                else self.host(var_codes, n * grid.bps, f_real),
                None if block_bits is None
                else self.host(block_bits, n, f_real))

    def row0(self, grid: _codec.Grid) -> int:
        return meshlib.row_slice(self.mesh, grid.ph).start

    def total(self, x: torch.Tensor) -> int:
        return int(_psum(x.reshape(1), self.mesh)[0])

    def rows(self, band: torch.Tensor) -> torch.Tensor:
        return _gather(band, self.mesh).to(self.device)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def encode_image_sharded(image: np.ndarray, cfg: CodecConfig, mesh) -> bytes:
    """Full sharded encode -> container bytes, the same for every mesh.

    Gray ((H, W) input, cfg.chroma "gray") or color ((H, W, 3) RGB,
    "444"/"420"): the three planes of a color container are each
    stripe-sharded, byte-identical to ColorImageCodec. Every rank converts
    the whole RGB image on its device (color._to_planes), then encodes
    its band of each plane (codec.encode_plane over a MeshPlacement)."""
    if cfg.chroma == "gray":
        if image.ndim != 2:
            raise ValueError(f"expected (H, W) grayscale, got {image.shape}")
    elif image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {image.shape}")
    return _color.encode_image(image, cfg, MeshPlacement(mesh))


def encode_video_sharded(frames: np.ndarray, cfg: CodecConfig, mesh,
                         chunk_frames: int | None = None) -> list[bytes]:
    """Sharded VideoCodec.encode: (F, H, W) gray or (F, H, W, 3) RGB ->
    per-frame containers, byte-identical to the unsharded VideoCodec for
    every mesh."""
    return _video.VideoCodec(cfg, chunk_frames, mesh=mesh).encode(frames)


def _decode_band(p: cont.PlaneData, cfg: CodecConfig,
                 place: MeshPlacement, chroma: bool) -> torch.Tensor:
    """One container plane -> this rank's band of the mesh-padded plane
    ((n_loc * stripe_rows * n, W) u8 on its device): its real stripes
    cut to a plane of their own and decoded by codec.decode_planes_device
    (kernel D and its host re-decode of flagged stripes for an indexed
    plane, else the host decoder; then kernel C). No collective: blocks
    share no pixels. The rows of mesh-pad stripes stay zero (they are
    cropped)."""
    grid = place.grid(p.height, p.width, cfg)
    rows = cfg.stripe_rows * cfg.block_size
    s0 = meshlib.coordinate(place.mesh)[1] * grid.n_loc
    s1 = max(s0, min(s0 + grid.n_loc, grid.n_stripes))
    band = torch.zeros(grid.n_loc * rows, p.width, dtype=torch.uint8,
                       device=place.device)
    if s1 == s0:
        return band

    def cut(a, per_stripe: int):
        return None if a is None else np.asarray(a).reshape(-1)[
            s0 * per_stripe:s1 * per_stripe]

    own = dataclasses.replace(
        p, height=(s1 - s0) * rows, stripes=p.stripes[s0:s1],
        stripe_bits=cut(p.stripe_bits, 1),
        variance_codes=cut(p.variance_codes, grid.bps),
        block_bits=cut(p.block_bits, grid.bps))
    band[:own.height] = _codec.decode_planes_device([own], cfg, place.device,
                                                    chroma)[0]
    return band


def decode_image_sharded(data: bytes, mesh) -> torch.Tensor:
    """Sharded decode: container bytes (on every rank) -> the whole (H, W)
    gray or (H, W, 3) RGB u8 image on every rank's device, the mirror of
    encode_image_sharded. Each rank decodes its stripes of each plane
    (_decode_band); one all-reduce of the ranks' failures gives every
    rank the fate of the unsharded decode (a ValueError on one rank is
    raised on all, before any of them waits in a gather); then one
    all-gather a plane assembles it, and a color image is recombined by
    color.planes_to_rgb. The mesh's device decides the route: kernels on
    the card, plain versions on the CPU."""
    c = cont.deserialize(data)
    cfg = c.config
    place = MeshPlacement(mesh)
    bands, error = [], None
    try:
        for i, p in enumerate(c.planes):
            bands.append(_decode_band(p, cfg, place, chroma=i > 0))
    except ValueError as e:
        error = e
    if place.total(torch.tensor(int(error is not None))):
        raise error or ValueError("a stripe of another rank failed to "
                                  "decode")
    planes = [place.rows(b)[:p.height] for b, p in zip(bands, c.planes)]
    if cfg.chroma == "gray":
        return planes[0]
    return _color.planes_to_rgb(*planes, cfg.chroma, c.height, c.width)


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
    n_dev = meshlib.shape(mesh)[1]
    if n_stripes % n_dev:
        # a silent floor division would re-segment stripes wrongly
        raise ValueError(
            f"n_stripes={n_stripes} must divide over the {n_dev}-rank "
            f"stripe axis"
        )
    return _codec.encode_step(part, cfg, n_stripes // n_dev)[0]
