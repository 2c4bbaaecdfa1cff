"""What the reference accepts, and the counts of what it does not.

Each value the codec rounds is worked out in float64. The codec computes
it in float32, so where the float64 value lies within a tolerance of a
.5 boundary either neighbour is right: the accepted interval of a value
v is [ceil(v - 0.5 - tol), floor(v + 0.5 + tol)], clipped where the
codec clips. Tolerances: for the encode transform, two float32 roundings
at the largest sum a coefficient's products can reach from u8 pixels,
ENCODE_ROUNDINGS * 2**-24 * 255 * sum_j |K[j, c]| for zigzag coefficient
c (1.7e-6 to 1.1e-4 over the cells' tables): a float32 sum of u8 pixels
times the operator rounds at that scale, whatever the value it ends at;
1e-3 for the decode transform (its coefficients reach 2047 times a quant
step); 1e-4 for the colour conversions. Where an input is itself a
rounding with two accepted values (a plane sample made from RGB, a
decoded plane sample under RGB), the interval of what follows spans
every accepted input: the transforms and the conversions are linear, so
its ends are the linear map's least and greatest over the inputs' box.

A count is of values outside their interval: none is the codec's
contract, and each count's limit is 0.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import container, entropy, tables

SETTINGS = {"quality": 50, "static_tables": False, "decode_index": "auto",
            "chroma": "gray"}
ENCODE_ROUNDINGS = 2.0
F32_UNIT = 2.0 ** -24
DECODE_TOL = 1e-3
COLOR_TOL = 1e-4


def settings(given: dict) -> dict:
    """A configuration's codec settings with the codec's defaults for
    what it leaves out; anything else is a mode this reference lacks."""
    extra = set(given) - set(SETTINGS)
    if extra:
        raise NotImplementedError(f"the reference lacks {sorted(extra)}")
    return {**SETTINGS, **given}


def accepted(v_lo, v_hi, tol, clip=None, dtype=np.int64):
    """[ceil(v_lo - 0.5 - tol), floor(v_hi + 0.5 + tol)], clipped."""
    lo = np.ceil(np.subtract(v_lo, 0.5 + tol))
    hi = np.floor(np.add(v_hi, 0.5 + tol))
    if clip is not None:
        np.clip(lo, *clip, out=lo)
        np.clip(hi, *clip, out=hi)
    return lo.astype(dtype), hi.astype(dtype)


def outside(got, lo, hi) -> int:
    """How many of ``got`` lie outside [lo, hi]."""
    got = np.asarray(got)
    if got.dtype == np.uint8 and lo.dtype == np.uint8:
        return int(np.count_nonzero((got < lo) | (got > hi)))
    got = got.astype(np.int64)
    return int(np.count_nonzero((got < lo) | (got > hi)))


def blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (bh * bw, 64) row-major 8x8 blocks of the plane padded to
    whole blocks by repeating its last row and column."""
    h, w = plane.shape
    bh, bw = container.grid(h, w)
    p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 64)


def unblock(b: np.ndarray, h: int, w: int) -> np.ndarray:
    bh, bw = container.grid(h, w)
    img = b.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
    return img.reshape(bh * 8, bw * 8)[:h, :w]


def encode_tolerance(quality: int, chroma: bool) -> np.ndarray:
    """(64,) the encode transform's tolerance a zigzag coefficient."""
    k = tables.coefficient_operator(quality, chroma)
    return ENCODE_ROUNDINGS * F32_UNIT * 255.0 * np.abs(k).sum(axis=0)


def coefficient_bounds(lo: np.ndarray, hi: np.ndarray, quality: int,
                       chroma: bool):
    """Accepted (lo, hi) zigzag coefficients of a plane whose samples
    may be any integer in [lo, hi] (equal where exact)."""
    k = tables.coefficient_operator(quality, chroma)
    x = blocks(np.asarray(lo, np.float64)) - 128.0
    y = x @ k
    d = blocks(np.asarray(hi, np.float64) - np.asarray(lo, np.float64))
    y_lo = y + d @ np.minimum(k, 0.0) if d.any() else y
    y_hi = y + d @ np.maximum(k, 0.0) if d.any() else y
    return accepted(y_lo, y_hi, encode_tolerance(quality, chroma))


def plane_bounds(coef: np.ndarray, h: int, w: int, quality: int,
                 chroma: bool):
    """Accepted (lo, hi) u8 samples of the plane decoded from (NB, 64)
    zigzag coefficients."""
    v = coef.astype(np.float64) @ tables.pixel_operator(quality, chroma)
    v = unblock(v + 128.0, h, w)
    return accepted(v, v, DECODE_TOL, (0, 255), np.uint8)


def rgb_planes(rgb: np.ndarray, subsample: bool):
    """(H, W, 3) u8 -> accepted (lo, hi) of the Y, Cb and Cr planes
    (BT.601 full range; 4:2:0 as the mean of each 2x2 window, an odd edge
    repeated)."""
    x = np.asarray(rgb, np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b

    def half(p):
        h, w = p.shape
        p = np.pad(p, ((0, h & 1), (0, w & 1)), mode="edge")
        return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                + p[1::2, 1::2]) / 4.0

    if subsample:
        cb, cr = half(cb), half(cr)
    return [accepted(p, p, COLOR_TOL, (0, 255), np.uint8)
            for p in (y, cb, cr)]


def rgb_bounds(y, cb, cr, h: int, w: int, subsample: bool):
    """Accepted (lo, hi) (H, W, 3) u8 RGB of planes each given as (lo,
    hi)."""
    def up(p):
        p = np.asarray(p, np.float64) - 128.0
        if subsample:
            p = p.repeat(2, 0).repeat(2, 1)
        return p[:h, :w]

    y0, y1 = (np.asarray(p, np.float64) for p in y)
    b0, b1 = (up(p) for p in cb)
    r0, r1 = (up(p) for p in cr)
    lo = np.empty((h, w, 3), np.uint8)
    hi = np.empty((h, w, 3), np.uint8)
    for c, (v_lo, v_hi) in enumerate((
            (y0 + 1.402 * r0, y1 + 1.402 * r1),
            (y0 - 0.344136 * b1 - 0.714136 * r1,
             y1 - 0.344136 * b0 - 0.714136 * r0),
            (y0 + 1.772 * b0, y1 + 1.772 * b1))):
        lo[..., c], hi[..., c] = accepted(v_lo, v_hi, COLOR_TOL, (0, 255),
                                          np.uint8)
    return lo, hi


def check_planes(streams: list[dict], quality: int,
                 static_tables: bool) -> dict:
    """Judge encoded planes. Each stream: {"stripes", "stripe_bits",
    "lengths", "block_bits" (the program's, or None), "bounds" ((lo, hi)
    accepted coefficients), "width", "height"}. -> {"coef_mismatches",
    "stream_faults", "coef": [the program's coefficients a plane]}."""
    faults = mismatches = 0
    coefs = []
    for s in streams:
        bh, bw = container.grid(s["height"], s["width"])
        bits = np.asarray(s["stripe_bits"], np.int64)
        if len(s["stripes"]) != bh or bits.size != bh:
            faults += 1
            coefs.append(None)
            continue
        bb = s.get("block_bits")
        if bb is not None:
            bb = np.asarray(bb, np.int64).reshape(-1)
            if bb.size != bh * bw:
                faults += 1
                coefs.append(None)
                continue
            faults += int(np.count_nonzero(
                bb.reshape(bh, bw).sum(axis=1) != bits))
        # with an index, each block is a lane that has to end where the
        # index says: the decode then checks the index block by block
        out = entropy.decode_stripes(s["stripes"], bits, bw, s["lengths"],
                                     bb)
        faults += out["n_faults"]
        if static_tables:
            want = tables.static_category_lengths(quality)
        else:
            want = tables.code_lengths(out["categories"])
        faults += int(not np.array_equal(np.asarray(s["lengths"]), want))
        lo, hi = s["bounds"]
        mismatches += outside(out["coef"], lo, hi)
        coefs.append(out["coef"])
        s["decoded_block_bits"] = out["block_bits"]
    return {"coef_mismatches": mismatches, "stream_faults": faults,
            "coef": coefs}


def plane_sizes(height: int, width: int, chroma: str) -> list:
    """(height, width) of each plane of an image."""
    if chroma == "gray":
        return [(height, width)]
    if chroma == "420":
        return [(height, width)] + [(-(-height // 2), -(-width // 2))] * 2
    return [(height, width)] * 3


def check_container(data: bytes, quality: int, static_tables: bool,
                    decode_index, chroma: str, height: int, width: int,
                    bounds: list) -> dict:
    """Judge a whole container of a (height, width) image against the
    accepted coefficients of each of its planes: its planes decoded and
    checked, and its bytes equal to the reference's serialization of the
    same content. -> check_planes' dict."""
    try:
        c = container.parse(data)
    except (ValueError, IndexError) as e:
        return {"coef_mismatches": 0, "stream_faults": 1, "coef": [],
                "error": str(e)}
    sizes = plane_sizes(height, width, chroma)
    streams = [{"stripes": p.stripes, "stripe_bits": p.stripe_bits,
                "lengths": p.lengths, "block_bits": p.block_bits,
                "bounds": b, "width": w, "height": h}
               for p, b, (h, w) in zip(c.planes, bounds, sizes)]
    out = check_planes(streams, quality, static_tables)
    if len(c.planes) != len(bounds) or out["stream_faults"]:
        out["stream_faults"] += int(len(c.planes) != len(bounds))
        return out
    planes = [container.Plane(w, h, p.lengths, p.stripe_bits, p.stripes,
                              s["decoded_block_bits"])
              for p, s, (h, w) in zip(c.planes, streams, sizes)]
    version = 2 if container.index_included(decode_index, planes) else 1
    want = container.serialize(container.Parsed(
        version, container.flags_of(static_tables), 8, quality, width,
        height, chroma, 1, planes))
    out["stream_faults"] += int(want != data)
    return out
