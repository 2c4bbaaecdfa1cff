"""End-to-end grayscale image codec: u8 image -> TPDC bitstream -> u8 image
(port of ``dct_tpu.models.codec``, gray planes).

  encode:  pad -> [device] transform + entropy stage -> packed stripe units
           -> [host] stripe bytes + container (dct_tpu_torch.container)
  decode:  [host] parse container -> [device] entropy decode of indexed
           (v2) containers (kernel D) -> DC un-prediction -> dequant + IDCT
           (kernel C) -> crop; v1 containers are entropy-decoded on the
           host (dct_tpu_torch.native, or the Python decoder) and uploaded,
           as is a v2 plane whose blocks kernel D found to contradict the
           index (a damaged container: the host decoder settles its fate)

Two encode paths, as in the reference. Configs that kernel B takes (4x4,
8x8 and 16x16 blocks, every entropy mode: ``fused_kernel_ok``) encode
static tables in one kernel (ops/fused_encode_cuda.py); with dynamic
tables the analyze pass — transform (kernel A), RLE, histogram — gives
the per-image canonical table, then kernel B encodes with it. 2x2 blocks
run the staged path: the analyze pass, then symbol chunks packed by
kernel E (ops/pack_cuda.py), as does the video codec's one-chunk encode.
On the CPU the same functions run the plain versions. The encode
transform goes to kernel A at every block size B takes and at 2x2; the
decode transform to kernel C at 2x2, 4x4 and 8x8, while 16x16 blocks
decode through the plain float32 product on the card
(decode_transform), as the reference runs it in XLA.

The entry points run on the card: with no ``device`` they take ``cuda``,
and raise where there is none; ``device="cpu"`` runs the plain versions.
The tensors handed to the step functions decide where the work runs. A
plan (encode_plane here) asks a Placement where its data lives: one
device, or the ranks of a mesh (parallel/shard_encode.py), with the same
bytes. The video codec batching these functions over frame stacks is
models/video.py; color images (one plane each of Y, Cb and Cr, the chroma
planes against the chrominance quant table) are models/color.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dct_tpu_torch import container as cont
from dct_tpu_torch import native, tables
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.ops import blocks as blk
from dct_tpu_torch.ops import entropy_decode as ed
from dct_tpu_torch.ops import entropy_decode_cuda, fused_encode_cuda
from dct_tpu_torch.ops import pack_cuda
from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.ops import quant, rle, transform, transform_cuda
from dct_tpu_torch.utils import tracing

DIRECT_VMIN = -255  # direct-mode alphabet [-255, 255] + ESC

# Planes of indexed (v2) containers that kernel D flagged (a block that
# contradicts its index) and the host decoder then decoded again, counted
# where decode_planes_device does it; reset with reset_host_redecodes().
HOST_REDECODES = {"planes": 0}


def reset_host_redecodes() -> None:
    HOST_REDECODES["planes"] = 0


def _padded_grid(h: int, w: int, cfg: CodecConfig) -> tuple[int, int, int]:
    """(block rows padded to stripe multiple, block cols, n_stripes)."""
    n = cfg.block_size
    bh = -(-h // n)
    bw = -(-w // n)
    bh = -(-bh // cfg.stripe_rows) * cfg.stripe_rows
    return bh, bw, bh // cfg.stripe_rows


def _default_device() -> torch.device:
    """The entry points' device when the caller names none: the card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass device='cpu' to run the plain versions")
    return torch.device("cuda")


def dc_predict(zz: torch.Tensor, n_stripes: int) -> torch.Tensor:
    """Stripe-local DC DPCM (cfg.dc_prediction): each block's DC becomes
    the delta against the previous block in its stripe (first block raw).
    zz: (NB, n2); returns a new tensor."""
    nb = zz.shape[0]
    dc = zz[:, 0].reshape(n_stripes, nb // n_stripes)
    prev = torch.cat([torch.zeros_like(dc[:, :1]), dc[:, :-1]], dim=1)
    out = zz.clone()
    out[:, 0] = (dc - prev).reshape(-1)
    return out


def dc_reconstruct(zz: torch.Tensor, n_stripes: int) -> torch.Tensor:
    """Inverse of dc_predict on decoded (NB, n2) coefficients, on their
    device: each stripe's DC deltas become a running sum. Returns a new
    tensor of zz's dtype."""
    nb = zz.shape[0]
    dc = zz[:, 0].reshape(n_stripes, nb // n_stripes)
    out = zz.clone()
    out[:, 0] = torch.cumsum(dc, dim=1).reshape(-1).to(zz.dtype)
    return out


def _adaptive(pixels: torch.Tensor, cfg: CodecConfig, planes: bool = False):
    """Each block's variance code and what the quantizer takes from it,
    under cfg.adaptive; else (None, None). The second output's form
    depends on the route:

    - blocks (pixels (..., n2)): (codes, scales), quant.py's op chain.
      Kernel A and the decode transform take the scale itself.
    - ``planes`` (the padded planes (..., Hp, Wp) of kernel B's route):
      (codes (..., NB), each block's float32 1 / scale (frames * NB,) in
      raster order over every plane), the reciprocal B takes as it is
      (fused_encode_cuda.plane_variance_codes: one kernel on the card).

    Both routes give the same codes on every device. Span
    ``codec.variance_codes`` (blocks), under cfg.adaptive only."""
    if not cfg.adaptive:
        return None, None
    with tracing.named_scope("codec.variance_codes",
                             blocks=pixels.numel() // cfg.n2):
        if planes:
            return fused_encode_cuda.plane_variance_codes(pixels, cfg)
        codes = quant.variance_code(
            quant.block_variance_flat(transform.level_shift(pixels))
        )
        return codes, quant.scale_from_variance_code(codes)


def encode_transform(pixels: torch.Tensor, cfg: CodecConfig,
                     ops: tables.CodecOperators,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """(..., B, n2) u8 blocks -> int32 quantized zigzag coefficients on
    their device: kernel A for the block sizes it takes
    (transform_cuda.ENCODE_N2, 16x16 included: its chain is kernel B's),
    else (block sizes no kernel takes) transform.encode_blocks, the
    reference's float32 XLA product, in full float32 whatever the caller's
    TF32 switch; that route launches and counts nothing."""
    if cfg.n2 in transform_cuda.ENCODE_N2:
        return transform_cuda.encode_blocks_kernel(pixels, cfg, ops, scale)
    with transform.full_float32():
        return transform.encode_blocks(pixels, cfg, ops, scale)


def decode_transform(zz: torch.Tensor, cfg: CodecConfig,
                     ops: tables.CodecOperators,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """(..., B, n2) zigzag coefficients -> u8 pixel blocks on their device:
    kernel C for the block sizes it takes (transform_cuda.DECODE_N2), else
    (16x16 blocks) transform.decode_blocks, the reference's float32 XLA
    product: not a kernel and not a fallback, since no TPU kernel takes
    it. On the card it is torch.matmul in full float32, whatever the
    caller's TF32 switch; it launches and counts nothing."""
    if cfg.n2 in transform_cuda.DECODE_N2:
        return transform_cuda.decode_blocks_kernel(zz, cfg, ops, scale)
    with transform.full_float32():
        return transform.decode_blocks(zz, cfg, ops, scale)


def pad_plane_for_encode(plane: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """The canonical encoder padding: (..., H, W) u8 -> (..., bh*n, bw*n),
    edge-replicated to the block grid and then the stripe grid."""
    h, w = int(plane.shape[-2]), int(plane.shape[-1])
    bh, bw, _ = _padded_grid(h, w, cfg)
    n = cfg.block_size
    return blk.pad_edge(plane.to(torch.uint8), bh * n, bw * n)


def encode_analyze(
    image: torch.Tensor, cfg: CodecConfig, ops: tables.CodecOperators
):
    """Stage 1: padded plane(s) (..., Hp, Wp) -> (symbols, var_codes,
    histogram, run_histogram). Every frame's blocks are stacked: symbols
    cover (frames * NB, n2) blocks, DC prediction is stripe-local over
    frames x stripes, and the histograms sum over the stack. var_codes keep
    the leading axes, (..., NB). histogram: the (16,) category histogram,
    in direct mode the (512,) histogram of [-255, 255] + ESC, in "none" mode
    a zero stub; run_histogram: the (65,) run histogram under
    cfg.coded_runs, else a zero stub. Span ``codec.encode_analyze``
    (frames, blocks)."""
    n = cfg.block_size
    frames = math.prod(image.shape[:-2])
    blocks = frames * (image.shape[-2] // n) * (image.shape[-1] // n)
    with tracing.named_scope("codec.encode_analyze", frames=frames,
                             blocks=blocks):
        return _analyze(image, cfg, ops, frames)


def _analyze(image: torch.Tensor, cfg: CodecConfig,
             ops: tables.CodecOperators, frames: int):
    n = cfg.block_size
    lead = image.shape[:-2]
    pixels = blk.image_to_blocks(image, n).reshape(-1, cfg.n2)
    var_codes, scale = _adaptive(pixels, cfg)
    zz = encode_transform(pixels, cfg, ops, scale)
    if cfg.dc_prediction:
        zz = dc_predict(zz, frames * (image.shape[-2] // n) // cfg.stripe_rows)
    symbols = rle.rle_encode_positional(zz)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    if mode == "category":
        hist = hf.category_histogram_masked(symbols.values, symbols.is_sym)
    elif mode == "direct":
        # positional symbols pack to the same bytes as the reference's
        # compacted ones, so direct mode histograms them as they are
        hist = hf.value_histogram_masked(symbols.values, symbols.is_sym,
                                         DIRECT_VMIN, -DIRECT_VMIN)
    else:
        hist = torch.zeros(1, dtype=torch.int32, device=zz.device)
    if cfg.coded_runs:
        run_hist = hf.run_histogram_masked(symbols.runs, symbols.is_sym)
    else:
        run_hist = torch.zeros(1, dtype=torch.int32, device=zz.device)
    if var_codes is not None:
        var_codes = var_codes.reshape(*lead, -1)
    return symbols, var_codes, hist, run_hist


def symbol_chunks_for(symbols: rle.RLEPositional, cfg: CodecConfig,
                      ops: tables.CodecOperators):
    """The codec's mode dispatch over bs.symbol_chunks: (cv, cl)."""
    rkw = dict(
        run_lengths=ops.run_lengths if cfg.coded_runs else None,
        run_codes=ops.run_codes if cfg.coded_runs else None,
        run_bits=bs.run_field_bits(cfg.n2),
    )
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    if mode == "category":
        return bs.symbol_chunks(symbols, mode, cat_lengths=ops.cat_lengths,
                                cat_codes=ops.cat_codes, **rkw)
    if mode == "direct":
        return bs.symbol_chunks(symbols, mode, val_lengths=ops.cat_lengths,
                                val_codes=ops.cat_codes, vmin=DIRECT_VMIN,
                                **rkw)
    return bs.symbol_chunks(symbols, mode, **rkw)


def _stripe_chunks(symbols: rle.RLEPositional, cfg: CodecConfig,
                   n_stripes: int, ops: tables.CodecOperators):
    """Symbols -> ((n_stripes, C, 3) chunk values, lengths, the stripes'
    units capacity, (n_stripes, bps) int32 per-block bit lengths)."""
    if cfg.coded_runs and ops.run_lengths is None:
        raise ValueError("coded_runs requires a run table")
    cv, cl = symbol_chunks_for(symbols, cfg, ops)
    bps = symbols.values.shape[0] // n_stripes
    block_bits = cl.sum(dim=(1, 2)).reshape(n_stripes, bps).to(torch.int32)
    capacity = bps * bs.units_per_block_worst(cfg.n2, cfg.coded_runs)
    return (cv.reshape(n_stripes, -1, 3), cl.reshape(n_stripes, -1, 3),
            capacity, block_bits)


def encode_pack_plain(
    symbols: rle.RLEPositional, cfg: CodecConfig, n_stripes: int,
    ops: tables.CodecOperators,
):
    """The staged pack of n_stripes stripes (every frame's, stacked)
    through the plain packer (bs.pack_chunks) on any device ->
    (PackedStripes, (n_stripes, bps) int32 per-block bit lengths): the
    staged pipeline the kernels are held against."""
    cv, cl, capacity, block_bits = _stripe_chunks(symbols, cfg, n_stripes, ops)
    return bs.pack_chunks(cv, cl, capacity), block_bits


def read_histograms(hist: torch.Tensor, run_hist: torch.Tensor):
    """encode_analyze's histograms as host arrays, in one span,
    ``codec.histogram_readback``, that holds the host's wait for the
    device and both copies."""
    nbytes = (hist.numel() * hist.element_size()
              + run_hist.numel() * run_hist.element_size())
    with tracing.named_scope("codec.histogram_readback", d2h_bytes=nbytes):
        return hist.cpu().numpy(), run_hist.cpu().numpy()


def build_tables(cfg: CodecConfig, ops: tables.CodecOperators,
                 hist: np.ndarray, run_hist: np.ndarray):
    """The dynamic tables from host histograms, in the span
    ``codec.build_tables`` (h2d_bytes: the tables handed to ops' device)
    -> (table, run_table, ops with them)."""
    with tracing.named_scope("codec.build_tables"):
        table = _build_table(cfg, hist)
        run_table = _build_run_table(cfg, run_hist)
        tracing.add("h2d_bytes", sum(8 * len(t.lengths)
                                     for t in (table, run_table)
                                     if t is not None))
        return table, run_table, ops.with_tables(table, run_table)


def _build_table(cfg: CodecConfig, hist: np.ndarray | None):
    if not cfg.use_huffman or cfg.huffman_mode == "none":
        return None
    if cfg.static_tables:
        if cfg.huffman_mode != "category":
            raise ValueError("static_tables requires huffman_mode='category'")
        return hf.default_category_table(cfg.quality)
    return hf.CanonicalTable.from_frequencies(hist)


def _build_run_table(cfg: CodecConfig, run_hist: np.ndarray | None):
    if not cfg.coded_runs:
        return None
    if cfg.static_tables or run_hist is None:
        return hf.default_run_table(cfg.quality)
    # +1 smoothing: every run 0..64 must stay encodable
    return hf.CanonicalTable.from_frequencies(
        np.asarray(run_hist, np.int64) + 1, max_len=hf.RUN_MAX_CODE_LEN
    )


def fused_kernel_ok(cfg: CodecConfig) -> bool:
    """Whether kernel B (the fused stripe encode) takes cfg: 4x4, 8x8 and
    16x16 blocks in every entropy mode, stripes of any width, as the
    reference's kernel does. Other block sizes (2x2) encode through the
    staged path (kernel A, DC prediction, positional RLE, symbol chunks,
    kernel E)."""
    return cfg.n2 in fused_encode_cuda.KERNEL_N2


def _frames_out(packed: bs.PackedStripes, block_bits: torch.Tensor,
                cfg: CodecConfig, lead, n_stripes: int):
    """Stacked stripes -> (PackedStripes, block_bits-or-None) with the
    leading frame axes: units (..., n_stripes, U), bit lengths (...,
    n_stripes), block bits (..., n_stripes, bps) when cfg.decode_index is
    truthy."""
    packed = bs.PackedStripes(
        units=packed.units.reshape(*lead, n_stripes, -1),
        bit_lengths=packed.bit_lengths.reshape(*lead, n_stripes),
    )
    if not cfg.decode_index:
        return packed, None
    return packed, block_bits.reshape(*lead, n_stripes, -1)


def encode_fused_step(
    image: torch.Tensor,
    cfg: CodecConfig,
    n_stripes: int,
    ops: tables.CodecOperators,
):
    """Padded plane(s) (..., Hp, Wp) + tables -> (PackedStripes, var_codes,
    block_bits-or-None), one fused stripe encode (kernel B) over every
    stripe of every frame. Outputs keep the leading frame axes: units (...,
    n_stripes, U), bit lengths (..., n_stripes), var_codes (..., NB),
    block_bits (..., n_stripes, bps) when cfg.decode_index is truthy.
    Kernel B reads the planes themselves, as does, under cfg.adaptive,
    the variance pass that gives it each block's reciprocal scale."""
    lead = image.shape[:-2]
    var_codes, recip = _adaptive(image, cfg, planes=True)
    packed, block_bits = fused_encode_cuda.encode_plane_stripes_fused(
        image, cfg, math.prod(lead) * n_stripes, ops, adaptive_recip=recip)
    packed, block_bits = _frames_out(packed, block_bits, cfg, lead, n_stripes)
    return packed, var_codes, block_bits


def pack_frames(
    symbols: rle.RLEPositional,
    cfg: CodecConfig,
    lead,
    n_stripes: int,
    ops: tables.CodecOperators,
):
    """Stage 2, staged: encode_analyze's symbols of frames with leading
    axes ``lead`` (``()`` for one plane) + tables -> (PackedStripes,
    block_bits-or-None) with those axes. The chunks of every stripe of
    every frame are packed in one launch of kernel E on CUDA
    (ops/pack_cuda.py), by its plain version on the CPU. Span
    ``codec.pack_frames`` (frames)."""
    frames = int(np.prod(lead, dtype=np.int64))
    with tracing.named_scope("codec.pack_frames", frames=frames):
        cv, cl, capacity, block_bits = _stripe_chunks(symbols, cfg,
                                                      frames * n_stripes, ops)
        packed = pack_cuda.pack_chunks_kernel(cv, cl, capacity)
        return _frames_out(packed, block_bits, cfg, lead, n_stripes)


def encode_staged_step(
    image: torch.Tensor,
    cfg: CodecConfig,
    n_stripes: int,
    ops: tables.CodecOperators,
):
    """Padded plane(s) (..., Hp, Wp) + tables -> (PackedStripes, var_codes,
    block_bits-or-None) through the staged path: the analyze pass (kernel
    A, DC prediction, positional RLE), then one kernel E launch over every
    stripe of every frame. Outputs keep the leading axes, as
    encode_fused_step's do."""
    symbols, var_codes, _, _ = encode_analyze(image, cfg, ops)
    packed, block_bits = pack_frames(symbols, cfg, image.shape[:-2],
                                     n_stripes, ops)
    return packed, var_codes, block_bits


def encode_step(image: torch.Tensor, cfg: CodecConfig, n_stripes: int,
                chroma: bool = False):
    """Full static-table encode of padded plane(s) (..., Hp, Wp) on the
    tensor's device: -> (PackedStripes, var_codes, block_bits-or-None), with
    the leading axes. Kernel B where fused_kernel_ok(cfg), else the staged
    path (kernel A, then kernel E). chroma: the planes are Cb or Cr
    (the chrominance quant table)."""
    if not cfg.static_tables:
        raise ValueError("encode_step requires cfg.static_tables")
    with tracing.named_scope("codec.encode_step",
                             frames=math.prod(image.shape[:-2])):
        ops = tables.build(cfg, chroma=chroma, device=image.device)
        step = (encode_fused_step if fused_kernel_ok(cfg)
                else encode_staged_step)
        return step(image, cfg, n_stripes, ops)


def to_device_u8(a, device: torch.device) -> torch.Tensor:
    """A u8 array (host array or tensor) as a tensor on ``device``: host
    arrays are copied there, tensors moved (no copy where they are)."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.uint8)
    host = np.array(a, np.uint8)
    tracing.add("h2d_bytes", host.nbytes)
    return torch.from_numpy(host).to(device)


def read_back(t: torch.Tensor, span: str) -> np.ndarray:
    """``t`` as a host array, in a span of its own that counts the bytes;
    the span holds the host's wait for the device."""
    with tracing.named_scope(span, d2h_bytes=t.numel() * t.element_size()):
        return t.cpu().numpy()


def plane_data(packed: bs.PackedStripes, w: int, h: int, table, run_table,
               var_codes: np.ndarray | None = None,
               block_bits: np.ndarray | None = None) -> list[cont.PlaneData]:
    """Fetched packed stripes of one plane ((S, U) units, (S,) bits) or of
    a chunk of planes ((F, S, U), (F, S)) on the host, with their variance
    codes ((F,) NB) and block bits ((F,) S, bps) or None -> one PlaneData a
    plane against the tables given; every plane's stripes written by one
    payload pass (bs.plane_payloads)."""
    stripes = bs.plane_payloads(packed)
    n = len(stripes)
    bits = np.asarray(packed.bit_lengths).reshape(n, -1).astype(np.uint32)
    if var_codes is not None:
        var_codes = np.asarray(var_codes).reshape(n, -1)
    if block_bits is not None:
        block_bits = np.asarray(block_bits).reshape(n, -1).astype(np.uint16)
    return [cont.PlaneData(
        width=w,
        height=h,
        table_lengths=table.lengths if table is not None else None,
        vmin=DIRECT_VMIN,
        variance_codes=None if var_codes is None else var_codes[i],
        stripe_bits=bits[i],
        stripes=stripes[i],
        run_table_lengths=(
            run_table.lengths if run_table is not None else None
        ),
        block_bits=None if block_bits is None else block_bits[i],
    ) for i in range(n)]


class Grid(NamedTuple):
    """A plane's stripe grid under a placement: its real stripes, the
    stripes of each rank (the real ones rounded up to divide the stripe
    axis; the rest are mesh-pad stripes of edge rows), the blocks of a
    stripe, and the (rows, columns) of the whole padded plane."""
    n_stripes: int
    n_loc: int
    bps: int
    ph: int
    pw: int


class Placement:
    """Where a plan's data lives: this class is one device, holding every
    frame and stripe of a plane or chunk (parallel/shard_encode.py's
    MeshPlacement spreads them over a mesh's ranks). The plans
    (encode_plane, video._encode_plane_batch, the rate-control probes)
    ask it only for the grid, the chunks of frames, a rank's upload, the
    histograms summed to the host and the way of the outputs back to the
    host. ``f_real`` is None for a plane, else the real frames of a chunk
    of a stack."""

    shape = (1, 1)  # (n_data, n_stripe)

    def __init__(self, device):
        self.device = torch.device(device)

    def grid(self, h: int, w: int, cfg: CodecConfig) -> Grid:
        _, bw, n_stripes = _padded_grid(h, w, cfg)
        n_stripe = self.shape[1]
        n_loc = -(-n_stripes // n_stripe)
        n = cfg.block_size
        return Grid(n_stripes, n_loc, cfg.stripe_rows * bw,
                    n_loc * n_stripe * cfg.stripe_rows * n, bw * n)

    def chunks(self, f: int, chunk: int):
        """(frames a chunk, [(first frame, real frames, frames padded to
        the data axis)] of each chunk of an f-frame stack): pad frames
        repeat the last frame, count in no histogram and are dropped."""
        n_data = self.shape[0]
        chunk = -(-chunk // n_data) * n_data
        return chunk, [(i0, min(chunk, f - i0),
                        -(-min(chunk, f - i0) // n_data) * n_data)
                       for i0 in range(0, f, chunk)]

    def upload(self, a, grid: Grid, f_pad: int | None = None):
        """A plane (host array or tensor) or, with f_pad, a chunk of a
        host stack -> this rank's part on its device, edge-padded to the
        grid."""
        if f_pad is None:
            x = to_device_u8(a, self.device)
        else:
            a = np.ascontiguousarray(a, np.uint8)
            tracing.add("h2d_bytes", a.nbytes)
            x = torch.from_numpy(a).to(self.device)
        return blk.pad_edge(x, grid.ph, grid.pw)

    def histograms(self, symbols, hist, run_hist, cfg: CodecConfig,
                   grid: Grid, f_real: int | None = None):
        """encode_analyze's histograms of the plane or chunk as host
        arrays (a placement may give None where no table of that kind is
        built)."""
        return read_histograms(hist, run_hist)

    def host(self, x: torch.Tensor, n_real: int,
             f_real: int | None = None) -> np.ndarray:
        """A per-stripe (or per-block) tensor, with a leading frame axis
        for a chunk -> the host array of the real frames and the first
        n_real stripes (blocks)."""
        return x.cpu().numpy()

    def outputs(self, packed: bs.PackedStripes, var_codes, block_bits,
                grid: Grid, f_real: int | None = None):
        """An encode's outputs -> host (PackedStripes, variance codes or
        None, block bits or None) of the real frames and stripes."""
        return (bs.fetch_packed(packed),  # trim worst-case slack before D2H
                None if var_codes is None else var_codes.cpu().numpy(),
                (read_back(block_bits, "codec.index_readback")
                 if block_bits is not None else None))

    def row0(self, grid: Grid) -> int:
        """The first row of this rank's band."""
        return 0

    def total(self, x: torch.Tensor) -> int:
        """An integer tensor of one element summed over the ranks."""
        return int(x.item())

    def rows(self, band: torch.Tensor) -> torch.Tensor:
        """Every rank's band -> the whole padded plane on the device."""
        return band


def encode_plane(
    plane, cfg: CodecConfig,
    device: str | torch.device | None = None,
    chroma: bool = False,
    placement: Placement | None = None,
) -> cont.PlaneData:
    """Encode one (H, W) u8 plane (host array or tensor) to PlaneData
    (device compute + host assembly), on ``device`` or over
    ``placement``. chroma: a Cb or Cr plane, encoded against the
    chrominance quant table."""
    place = placement or Placement(
        device if device is not None else _default_device())
    h, w = int(plane.shape[0]), int(plane.shape[1])
    grid = place.grid(h, w, cfg)
    img = place.upload(plane, grid)

    if cfg.static_tables:
        table = _build_table(cfg, None)
        run_table = _build_run_table(cfg, None)
        packed, var_codes, block_bits = encode_step(img, cfg, grid.n_loc,
                                                    chroma)
    else:
        ops = tables.build(cfg, chroma=chroma, device=img.device)
        symbols, var_codes, hist, run_hist = encode_analyze(img, cfg, ops)
        table, run_table, ops = build_tables(
            cfg, ops, *place.histograms(symbols, hist, run_hist, cfg, grid))
        if img.device.type == "cuda" and fused_kernel_ok(cfg):
            # the fused kernel re-runs the transform with the real tables
            packed, var_codes, block_bits = encode_fused_step(
                img, cfg, grid.n_loc, ops
            )
        else:
            packed, block_bits = pack_frames(symbols, cfg, (), grid.n_loc,
                                             ops)
    packed, var_codes, block_bits = place.outputs(packed, var_codes,
                                                  block_bits, grid)
    return plane_data(packed, w, h, table, run_table, var_codes,
                      block_bits)[0]


def host_decoder() -> str:
    """Which host entropy decoder decodes v1 containers: "native" (the C++
    decoder of dct_tpu_torch.native, when it builds) or "python"."""
    return "native" if native.available() else "python"


def _decode_stripes(
    p: cont.PlaneData, cfg: CodecConfig, table, mode: str, n_stripes: int,
    bps: int, run_table=None,
) -> np.ndarray:
    """Entropy-decode all stripes on the host to (NB, n2) int16 zigzag
    coefficients: the native C++ decoder when it builds, else the Python
    decoder."""
    if host_decoder() == "native":
        return native.unpack_stripes(
            p.stripes, bps, cfg.n2, mode, table, DIRECT_VMIN,
            run_table=run_table,
        )
    return np.concatenate([
        bs.unpack_stripe_host(
            p.stripes[s], bps, cfg.n2, mode,
            cat_table=table if mode == "category" else None,
            val_table=table if mode == "direct" else None,
            vmin=DIRECT_VMIN, run_table=run_table,
        )
        for s in range(n_stripes)
    ], axis=0)


def _upload(arrays: list[np.ndarray], device) -> list[torch.Tensor]:
    """Copy host arrays to ``device`` in one transfer: packed at 8-byte
    aligned offsets into one byte buffer, returned as views of their own
    dtype and shape (uint16 arrives as int16 bit patterns)."""
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 8) * 8
    with tracing.named_scope("codec.upload", h2d_bytes=max(total, 8)):
        buf = np.zeros(max(total, 8), np.uint8)
        for a, o in zip(arrays, offsets):
            buf[o:o + a.nbytes] = (np.ascontiguousarray(a).reshape(-1)
                                   .view(np.uint8))
        dev = torch.from_numpy(buf).to(device)
        out = []
        for a, o in zip(arrays, offsets):
            dt = np.int16 if a.dtype == np.uint16 else a.dtype
            view = dev[o:o + a.nbytes].view(
                torch.from_numpy(np.zeros(0, dt)).dtype)
            out.append(view.reshape(a.shape))
        return out


def indexed_decode_ok(p: cont.PlaneData, cfg: CodecConfig, table,
                      run_table) -> bool:
    """Whether the entropy decode runs on the device: the container
    carries the per-block decode index (v2), kernel D takes the block
    size, and its tables fit (codes <= 16 bits, direct values in int16)."""
    return (p.block_bits is not None
            and cfg.n2 in entropy_decode_cuda.KERNEL_N2
            and ed.tables_supported(table, run_table, DIRECT_VMIN))


def indexed_operands(stripes: list[bytes], block_bits: np.ndarray, table,
                     run_table, mode: str, n2: int, device,
                     status: bool = False) -> dict:
    """Kernel D's operands for an indexed stream, on ``device``: one
    upload of the payload (the stripes concatenated, first, so at offset 0
    of a fresh allocation: 16-byte aligned), the stripe start bits (from
    the stripe byte lengths, on the host), the (n_stripes, bps) index, the
    packed tables and, with ``status``, the (n_stripes,) int32 zeros of
    D's status. -> keyword arguments of
    entropy_decode_cuda.decode_blocks_kernel (and of its plain version),
    which scans the index into block starts itself."""
    with tracing.named_scope("codec.indexed_operands"):
        arrays = [np.frombuffer(b"".join(stripes), np.uint8),
                  ed.stripe_starts([len(s) for s in stripes]),
                  np.asarray(block_bits, np.uint16).reshape(len(stripes), -1),
                  ed.table_inputs(table, run_table, mode, DIRECT_VMIN)]
        if status:
            arrays.append(np.zeros(len(stripes), np.int32))
        uploaded = _upload(arrays, device)
    ops = dict(zip(("payload", "stripe_start", "block_bits", "tabs",
                    "status"), uploaded))
    return dict(ops, n2=n2, mode=mode,
                run_bits=0 if run_table is not None else bs.run_field_bits(n2))


def _reconstruct(zz: torch.Tensor, planes: list[cont.PlaneData],
                 cfg: CodecConfig, chroma: bool, n_stripes: int,
                 bh: int, bw: int) -> torch.Tensor:
    """(F * NB, n2) int16 coefficients of F planes on their device ->
    (F, H, W) u8 planes: DC un-prediction over frames x stripes, dequant +
    IDCT (kernel C on CUDA; chroma: the chrominance quant table), the
    block grid, the crop."""
    with tracing.named_scope("codec.reconstruct"):
        device = zz.device
        n = cfg.block_size
        p0 = planes[0]
        if cfg.dc_prediction:
            zz = dc_reconstruct(zz, len(planes) * n_stripes)
        scale = None
        if cfg.adaptive:
            codes = np.concatenate(
                [np.asarray(p.variance_codes, np.uint8) for p in planes])
            tracing.add("h2d_bytes", codes.nbytes)
            scale = quant.scale_from_variance_code(
                torch.from_numpy(codes).to(device))
        ops = tables.build(cfg, chroma=chroma, device=device)
        pixels = decode_transform(zz, cfg, ops, scale)
        # rebuild on the (stripe-padded) encoder grid, then crop to true dims
        return blk.blocks_to_image(pixels.reshape(len(planes), -1, cfg.n2),
                                   bh * n, bw * n,
                                   n)[:, : p0.height, : p0.width]


def decode_planes_device(
    planes: list[cont.PlaneData], cfg: CodecConfig,
    device: str | torch.device | None = None,
    chroma: bool = False,
) -> torch.Tensor:
    """PlaneData of F frames that share their size and tables ->
    reconstructed (F, H, W) u8 planes as a tensor on ``device``, one launch
    of each kernel for the stack. When every plane is indexed (v2) and
    kernel D takes it, the stack is entropy-decoded on the device in one D
    launch over every frame's stripes (payload and index concatenated), so
    only those and the tables cross to it; otherwise each plane is decoded
    on the host and the coefficients are uploaded at once. Then DC
    un-prediction over frames x stripes, dequant + IDCT (kernel C on CUDA;
    chroma: against the chrominance quant table) and the crop run on the
    device.

    The result is the host decoder's, which the reference package runs by
    default: D also reports each stripe whose blocks contradict the index
    (ops/entropy_decode.py), read once after kernel C is queued. A plane
    with such a stripe is decoded again on the host (HOST_REDECODES):
    its ValueError propagates, or its coefficients replace D's and kernel
    C runs again on that plane. Where no stripe is flagged, D's
    coefficients are the host decoder's (csrc/entropy_decode.cu)."""
    device = torch.device(device) if device is not None else _default_device()
    p0 = planes[0]
    bh, bw, n_stripes = _padded_grid(p0.height, p0.width, cfg)
    bps = (bh // n_stripes) * bw  # blocks per stripe

    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    table = hf.CanonicalTable(p0.table_lengths) if mode != "none" else None
    run_table = (
        hf.CanonicalTable(p0.run_table_lengths) if cfg.coded_runs else None
    )

    def host(ps):
        with tracing.named_scope("codec.host_entropy_decode"):
            zz = np.concatenate([
                _decode_stripes(p, cfg, table, mode, n_stripes, bps,
                                run_table)
                for p in ps])
            tracing.add("h2d_bytes", zz.nbytes)
            return torch.from_numpy(zz).to(device)

    if not all(indexed_decode_ok(p, cfg, table, run_table) for p in planes):
        return _reconstruct(host(planes), planes, cfg, chroma, n_stripes,
                            bh, bw)
    zz, status = entropy_decode_cuda.decode_blocks_kernel(
        **indexed_operands([s for p in planes for s in p.stripes],
                           np.concatenate([p.block_bits for p in planes]),
                           table, run_table, mode, cfg.n2, device,
                           status=True))
    out = _reconstruct(zz, planes, cfg, chroma, n_stripes, bh, bw)
    flagged = np.flatnonzero(read_back(status, "codec.status_readback")
                             .reshape(len(planes), n_stripes).any(axis=1))
    if flagged.size:
        with tracing.named_scope("codec.host_redecode"):
            HOST_REDECODES["planes"] += int(flagged.size)
            again = [planes[i] for i in flagged]
            out[torch.from_numpy(flagged).to(device)] = _reconstruct(
                host(again), again, cfg, chroma, n_stripes, bh, bw)
    return out


def decode_plane_device(
    p: cont.PlaneData, cfg: CodecConfig,
    device: str | torch.device | None = None,
    chroma: bool = False,
) -> torch.Tensor:
    """PlaneData -> reconstructed (H, W) u8 plane as a tensor on
    ``device`` (decode_planes_device of one plane: kernel D for an indexed
    plane, else the host decoder, then kernel C)."""
    return decode_planes_device([p], cfg, device, chroma)[0]


def decode_plane(
    p: cont.PlaneData, cfg: CodecConfig,
    device: str | torch.device | None = None,
    chroma: bool = False,
) -> np.ndarray:
    """PlaneData -> reconstructed u8 plane (host array)."""
    return decode_plane_device(p, cfg, device, chroma).cpu().numpy()


class ImageCodec:
    """Grayscale single-plane codec on one device (color:
    models/color.py ColorImageCodec)."""

    def __init__(self, config: CodecConfig | None = None,
                 device: str | torch.device | None = None):
        self.config = config or CodecConfig()
        if self.config.chroma != "gray":
            raise ValueError("ImageCodec is grayscale; use ColorImageCodec")
        self.device = (torch.device(device) if device is not None
                       else _default_device())

    def encode(self, image: np.ndarray) -> bytes:
        if image.ndim != 2:
            raise ValueError(f"expected (H, W) grayscale, got {image.shape}")
        from dct_tpu_torch.models.color import encode_image

        with tracing.named_scope("image.encode", frames=1):
            return encode_image(image, self.config, Placement(self.device))

    def decode(self, data: bytes) -> np.ndarray:
        return self.decode_to_device(data).cpu().numpy()

    def decode_to_device(self, data: bytes) -> torch.Tensor:
        """Decode with the reconstruction left on this codec's device (of a
        color container, its luma plane, as the reference's does)."""
        with tracing.named_scope("image.decode_to_device", frames=1):
            c = cont.deserialize(data)
            return decode_plane_device(c.planes[0], c.config,
                                       device=self.device)


def encode(image: np.ndarray, config: CodecConfig | None = None,
           device: str | torch.device | None = None) -> bytes:
    """Module-level convenience: grayscale (H, W) or RGB (H, W, 3) by
    array rank; RGB with chroma "gray" encodes at "420"."""
    cfg = config or CodecConfig()
    if image.ndim == 2:
        return ImageCodec(cfg, device).encode(image)
    from dct_tpu_torch.models.color import ColorImageCodec

    if cfg.chroma == "gray":
        cfg = cfg.replace(chroma="420")
    return ColorImageCodec(cfg, device).encode(image)


def decode(data: bytes, device: str | torch.device | None = None) -> np.ndarray:
    """Container bytes -> (H, W) gray or (H, W, 3) RGB u8 pixels."""
    c = cont.deserialize(data)
    if c.config.chroma == "gray":
        return ImageCodec(device=device).decode(data)
    from dct_tpu_torch.models.color import ColorImageCodec

    return ColorImageCodec(c.config, device).decode(data)
