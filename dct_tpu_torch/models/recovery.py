"""Per-stripe integrity, repair and random-access decode (port of
``dct_tpu.models.recovery``).

A TPDC container's stripes are independent substreams, so they are the
unit of checking and of recovery:

  * verify(data)        the integrity scan, on the host: every stripe is
                        entropy-decoded on its own and checked against
                        the bit length the container records (a decode
                        that raises, overruns or consumes another number
                        of bits is corrupt). The C++ scan of
                        dct_tpu_torch.native where it builds, else the
                        Python decoder.
  * repair(data, src)   re-encodes only the damaged stripes from the
                        source image against the container's own tables
                        and splices them in: byte-identical to a
                        from-scratch encode.
  * rebuild(tpl, src)   every stripe of ``src`` against a template
                        container's config and tables (a sibling frame of
                        a stack).
  * decode_region(data, row0, row1)
                        decodes only the stripes that overlap a row range.

Gray containers address stripes by flat index, color containers by
(plane, stripe) pairs; a color plane is re-encoded from the source's
planes (models/color.py _to_planes), Cb and Cr against the chrominance
quant table.

The re-encode runs on ``device`` (default: the card) as the staged path:
kernel A, DC prediction, positional RLE and symbol chunks, then kernel E
(codec.pack_frames), every damaged stripe of a plane in one launch of
each. The from-scratch encode ran kernel B for 4x4-16x16 blocks; the two
agree byte for byte because A and B run one tile function
(csrc/transform_core.cuh), whose integers are the float32 chain's.
decode_region entropy-decodes its stripes on the host and runs the
decode transform (kernel C) on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from dct_tpu_torch import container as cont
from dct_tpu_torch import native, tables
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec, color
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.ops import quant


def _is_gray(c: cont.Container) -> bool:
    return c.config.chroma == "gray"


def _geometry(p: cont.PlaneData, cfg: CodecConfig):
    bh, bw, n_stripes = codec._padded_grid(p.height, p.width, cfg)
    bps = (bh // n_stripes) * bw  # blocks per stripe
    return bh, bw, n_stripes, bps


def _table(p: cont.PlaneData, cfg: CodecConfig):
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    t = hf.CanonicalTable(p.table_lengths) if mode != "none" else None
    run_t = (
        hf.CanonicalTable(p.run_table_lengths) if cfg.coded_runs else None
    )
    return mode, t, run_t


def _verify_plane(p: cont.PlaneData, cfg: CodecConfig) -> list[int]:
    _, _, n_stripes, bps = _geometry(p, cfg)
    mode, table, run_table = _table(p, cfg)
    if native.available():
        status = native.verify_stripes(
            p.stripes, bps, cfg.n2, mode, table, p.vmin,
            np.asarray(p.stripe_bits, np.uint32), run_table=run_table,
        )
        return [int(s) for s in np.nonzero(status)[0]]
    bad = []
    for s in range(n_stripes):
        try:
            bs.unpack_stripe_host(
                p.stripes[s], bps, cfg.n2, mode,
                cat_table=table if mode == "category" else None,
                val_table=table if mode == "direct" else None,
                vmin=p.vmin,
                expected_bits=int(p.stripe_bits[s]),
                run_table=run_table,
            )
        except (ValueError, IndexError):
            bad.append(s)
    return bad


def verify(data: bytes) -> list:
    """Scan a container; return its corrupt stripes: flat stripe indices
    (list[int]) for gray containers, (plane_index, stripe_index) tuples
    for color ones.

    A stripe is corrupt if its entropy decode raises (an invalid code, an
    overrun) or consumes another bit count than the container records:
    the decoder consumes an exact, content-determined number of bits, so
    damaged bytes almost surely desynchronize it."""
    c = cont.deserialize(data)
    cfg = c.config
    if _is_gray(c):
        return _verify_plane(c.planes[0], cfg)
    return [(pi, s) for pi, p in enumerate(c.planes)
            for s in _verify_plane(p, cfg)]


def _encode_stripes(rows: torch.Tensor, cfg: CodecConfig,
                    ops: tables.CodecOperators):
    """(k, rows_per_stripe, Wp) padded stripe rows, each one stripe, ->
    (stripe bytes, (k,) bit lengths, (k, bps) var codes or None, (k, bps)
    block bits or None), against the FIXED tables in ``ops`` (the
    container's: never rebuilt from these stripes' histograms, or a
    dynamic-table repair would drift from the original encode). One
    analyze pass (kernel A, stripe-local DC prediction, positional RLE)
    and one pack (kernel E) over the k stripes."""
    symbols, var_codes, _, _ = codec.encode_analyze(rows, cfg, ops)
    packed, block_bits = codec.pack_frames(symbols, cfg, rows.shape[:1], 1,
                                           ops)
    packed = bs.fetch_packed(packed)  # trim worst-case slack, as encode
    stripes = list(bs.stripes_to_bytes(bs.PackedStripes(
        packed.units[:, 0], packed.bit_lengths[:, 0])))
    return (stripes, packed.bit_lengths[:, 0],
            None if var_codes is None else var_codes.cpu().numpy(),
            None if block_bits is None else block_bits.cpu().numpy())


def _repair_plane(
    p: cont.PlaneData,
    cfg: CodecConfig,
    source_plane: torch.Tensor,
    stripes: list[int],
    chroma: bool,
) -> cont.PlaneData:
    if tuple(source_plane.shape) != (p.height, p.width):
        raise ValueError(
            f"source {tuple(source_plane.shape)} != container plane "
            f"{(p.height, p.width)}"
        )
    _, _, n_stripes, bps = _geometry(p, cfg)
    for s in stripes:
        if not 0 <= s < n_stripes:
            raise ValueError(f"stripe {s} out of range (n_stripes={n_stripes})")
    _, table, run_table = _table(p, cfg)
    img = codec.pad_plane_for_encode(source_plane, cfg)
    rows_per_stripe = cfg.stripe_rows * cfg.block_size
    order = sorted(set(stripes))
    ops = tables.build(cfg, chroma=chroma, device=img.device).with_tables(
        table, run_table)
    rows = img.reshape(n_stripes, rows_per_stripe, -1)[order]
    new, bits, vc, bb = _encode_stripes(rows, cfg, ops)

    stripe_bits = np.asarray(p.stripe_bits, np.uint32).copy()
    new_stripes = list(p.stripes)
    var_codes = (
        np.asarray(p.variance_codes, np.uint8).copy() if cfg.adaptive else None
    )
    block_bits = (
        np.asarray(p.block_bits, np.uint16).copy()
        if p.block_bits is not None else None
    )
    for i, s in enumerate(order):
        new_stripes[s] = new[i]
        stripe_bits[s] = int(bits[i])
        if cfg.adaptive:
            var_codes[s * bps:(s + 1) * bps] = vc[i]
        if block_bits is not None:
            block_bits[s * bps:(s + 1) * bps] = bb[i].reshape(-1)
    return cont.PlaneData(
        width=p.width,
        height=p.height,
        table_lengths=p.table_lengths,
        vmin=p.vmin,
        variance_codes=var_codes,
        stripe_bits=stripe_bits,
        stripes=new_stripes,
        run_table_lengths=p.run_table_lengths,
        block_bits=block_bits,
    )


def _source_planes(c: cont.Container, source: np.ndarray,
                   device: torch.device) -> list[torch.Tensor]:
    """The encoder's source -> planes mapping on ``device``
    (models/color.py _to_planes for color, identity for gray)."""
    if _is_gray(c):
        if source.ndim != 2:
            raise ValueError(f"expected (H, W) source, got {source.shape}")
        return [codec.to_device_u8(source, device)]
    if source.ndim != 3 or source.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) RGB source, got {source.shape}")
    return list(color._to_planes(codec.to_device_u8(source, device),
                                 c.config.chroma))


def repair(
    data: bytes, source: np.ndarray, stripes: list | None = None,
    device: str | torch.device | None = None,
) -> bytes:
    """Re-encode the given (default: verify's) stripes of a container from
    the source image on ``device`` and return the repaired container,
    byte-identical to a from-scratch encode of the source under the
    container's config. Gray containers address stripes by flat index,
    color containers by (plane_index, stripe_index) pairs, as verify
    reports them."""
    c = cont.deserialize(data)
    cfg = c.config
    # check the source before the nothing-to-repair return: a wrong source
    # is never reported as a successful (no-op) repair
    want_shape = (
        (c.height, c.width) if _is_gray(c) else (c.height, c.width, 3)
    )
    if tuple(source.shape) != want_shape:
        raise ValueError(
            f"source {source.shape} != container image {want_shape}"
        )
    if stripes is None:
        stripes = verify(data)
    if not stripes:
        return data
    if _is_gray(c):
        per_plane = {0: list(stripes)}
    else:
        per_plane = {}
        for pi, s in stripes:
            per_plane.setdefault(pi, []).append(s)
        if any(not 0 <= pi < len(c.planes) for pi in per_plane):
            raise ValueError(f"plane index out of range in {sorted(per_plane)}")
    device = (torch.device(device) if device is not None
              else codec._default_device())
    planes_src = _source_planes(c, source, device)
    new_planes = [
        _repair_plane(p, cfg, planes_src[pi], per_plane[pi], chroma=pi > 0)
        if pi in per_plane else p
        for pi, p in enumerate(c.planes)
    ]
    return cont.serialize(cont.Container(
        config=cfg, width=c.width, height=c.height, planes=new_planes))


def rebuild(template: bytes, source: np.ndarray,
            device: str | torch.device | None = None) -> bytes:
    """Re-encode EVERY stripe of ``source`` against a template container's
    config and tables: the repair of a frame whose own header and tables
    were lost, from a readable sibling of its stack (every frame of a
    VideoCodec stack carries the same tables), byte-identical to the lost
    original."""
    c = cont.deserialize(template)
    if _is_gray(c):
        _, _, n_stripes, _ = _geometry(c.planes[0], c.config)
        all_stripes: list = list(range(n_stripes))
    else:
        all_stripes = [(pi, s) for pi, p in enumerate(c.planes)
                       for s in range(len(p.stripes))]
    return repair(template, source, stripes=all_stripes, device=device)


def decode_region(data: bytes, row0: int, row1: int,
                  device: str | torch.device | None = None) -> np.ndarray:
    """Decode only pixel rows [row0, row1): entropy-decodes just the
    stripes that overlap them (on the host), then the decode transform on
    ``device``. Color containers give (rows, W, 3) RGB: the luma rows and
    the chroma rows that cover them (half-rate under 4:2:0), recombined
    as the full decoder does."""
    c = cont.deserialize(data)
    cfg = c.config
    if not 0 <= row0 < row1 <= c.height:
        raise ValueError(f"bad row range [{row0}, {row1}) for height {c.height}")
    device = (torch.device(device) if device is not None
              else codec._default_device())
    y = _decode_plane_region(c.planes[0], cfg, row0, row1, False, device)
    if _is_gray(c):
        return y.cpu().numpy()
    if cfg.chroma == "444":
        cb, cr = (_decode_plane_region(c.planes[i], cfg, row0, row1, True,
                                       device) for i in (1, 2))
    else:  # 420: pixel row r draws from chroma row r // 2
        ch = c.planes[1].height
        c0, c1 = row0 // 2, min(-(-row1 // 2), ch)
        cb, cr = (color.upsample_420(
            _decode_plane_region(c.planes[i], cfg, c0, c1, True, device),
            2 * (c1 - c0), c.width)[row0 - 2 * c0:row1 - 2 * c0]
            for i in (1, 2))
    ycc = torch.stack([y.to(torch.float32), cb.to(torch.float32),
                       cr.to(torch.float32)], dim=-1)
    return color.ycbcr_to_rgb(ycc).cpu().numpy()


def _decode_plane_region(
    p: cont.PlaneData, cfg: CodecConfig, row0: int, row1: int, chroma: bool,
    device: torch.device,
) -> torch.Tensor:
    if not 0 <= row0 < row1 <= p.height:
        raise ValueError(f"bad row range [{row0}, {row1}) for height {p.height}")
    _, bw, n_stripes, bps = _geometry(p, cfg)
    mode, table, run_table = _table(p, cfg)
    n = cfg.block_size
    rows_per_stripe = cfg.stripe_rows * n
    s0 = row0 // rows_per_stripe
    s1 = min(-(-row1 // rows_per_stripe), n_stripes)
    part = cont.PlaneData(
        width=p.width, height=p.height, table_lengths=p.table_lengths,
        vmin=p.vmin, variance_codes=None,
        stripe_bits=np.asarray(p.stripe_bits)[s0:s1],
        stripes=p.stripes[s0:s1], run_table_lengths=p.run_table_lengths)
    zz = torch.from_numpy(codec._decode_stripes(
        part, cfg, table, mode, s1 - s0, bps, run_table)).to(device)
    if cfg.dc_prediction:
        zz = codec.dc_reconstruct(zz, s1 - s0)
    scale = None
    if cfg.adaptive:
        scale = quant.scale_from_variance_code(torch.from_numpy(
            np.asarray(p.variance_codes[s0 * bps:s1 * bps], np.uint8)
        ).to(device))
    ops = tables.build(cfg, chroma=chroma, device=device)
    pixels = codec.decode_transform(zz, cfg, ops, scale)
    img = codec.blk.blocks_to_image(pixels, (s1 - s0) * rows_per_stripe,
                                    bw * n, n)
    base = s0 * rows_per_stripe
    return img[row0 - base:row1 - base, :p.width]
