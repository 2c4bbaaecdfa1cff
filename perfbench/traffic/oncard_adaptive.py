"""Batches of padded gray planes already on the card, encoded by
``models/codec.py::encode_step`` under per-block variance-adaptive
quantization (``adaptive`` in the configuration's settings): each
block's u8 variance code, then kernel B with every AC step of the block
scaled by the code's factor.

Set-up, warm-up and the window are oncard_batches': closed loop with at
most ``in_flight`` batches in flight, ``pool_batches`` distinct batches
of ``batch`` planes made from the seed and cycled; metric
oncard_encode_mpix_s. The window's work also carries the blocks of the
whole adaptive encode (the variance codes and B), which
perfbench/roofline_adaptive.py counts.

Check, on every plane of a call drawn from the seed and of the last
call:
- variance_code_mismatches: its variance codes against
  perfbench/reference/adaptive.py;
- coef_mismatches: each stripe decoded by the reference
  (perfbench/reference/entropy.py) and every coefficient against its
  interval under the program's code where that code is accepted, under
  the reference's nearest code where it is not;
- stream_faults: the stripes' bit lengths and the block index against
  what the decode took;
- outputs_missing: a call short of its batch, of a plane's stripes or of
  its codes counts the rest (as oncard_batches counts stripes).
"""

from __future__ import annotations

import pathlib

import numpy as np

from perfbench import harness
from perfbench.reference import adaptive
from perfbench.reference import judge as ref
from perfbench.reference import tables

oncard_batches = harness.traffic("oncard_batches",
                                 pathlib.Path(__file__).resolve().parents[1])
setup = oncard_batches.setup
warm = oncard_batches.warm


def window(state, seconds, sampler):
    res = oncard_batches.window(state, seconds, sampler)
    res["work"]["adaptive"] = {"blocks": res["work"]["kernel_b"]["blocks"]}
    return res


def settings(given: dict) -> dict:
    """The configuration's settings as the judge takes them: adaptive
    quantization is this kind's own check, and the kind takes no other
    mode."""
    if not given.get("adaptive"):
        raise ValueError("oncard_adaptive runs adaptive quantization only")
    return ref.settings({k: v for k, v in given.items() if k != "adaptive"})


def check_plane(plane: np.ndarray, units: np.ndarray, bits: np.ndarray,
                block_bits, codes: np.ndarray, quality: int) -> dict:
    """Judge one padded (H, W) plane's output: (S, U) int16 units, (S,)
    bit lengths, (S, bps) block bits or None, (NB,) u8 variance codes.
    -> {"variance_code_mismatches", "coef_mismatches", "stream_faults"}."""
    want = adaptive.Plane(plane, quality)
    stripes = [units[k].astype(">u2").tobytes()[:(int(bits[k]) + 7) // 8]
               for k in range(units.shape[0])]
    out = ref.check_planes([{
        "stripes": stripes, "stripe_bits": bits,
        "lengths": tables.static_category_lengths(quality),
        "block_bits": block_bits,
        "bounds": want.coefficient_bounds(want.judged_codes(codes)),
        "width": plane.shape[1], "height": plane.shape[0]}], quality, True)
    return {"variance_code_mismatches": int(want.code_mismatches(codes)
                                            .sum()),
            "coef_mismatches": out["coef_mismatches"],
            "stream_faults": out["stream_faults"]}


def judge(state):
    s = settings(state["cell"]["config"]["settings"])
    kept = [(b, o[0].units.cpu().numpy(), o[0].bit_lengths.cpu().numpy(),
             None if o[1] is None else o[1].cpu().numpy(),
             None if o[2] is None else o[2].cpu().numpy())
            for b, o in state["kept"]]
    planes = state["planes"].cpu().numpy()
    n_stripes = state["n_stripes"]
    state.clear()
    batch, h, w = planes.shape[1:]
    n_blocks = h // 8 * (w // 8)
    counts = dict.fromkeys(("variance_code_mismatches", "coef_mismatches",
                            "stream_faults"), 0)
    missing = 0
    for b, units, bits, codes, block_bits in kept:
        if codes is None or codes.ndim != 2 or codes.shape[1] != n_blocks:
            codes = np.zeros((0, n_blocks), np.uint8)
        judged = min(units.shape[0], bits.shape[0], codes.shape[0], batch)
        missing += (batch * n_stripes
                    - min(units.shape[0], batch) * min(units.shape[1],
                                                       n_stripes)
                    + batch - judged)
        for f in range(judged):
            got = check_plane(planes[b, f], units[f], bits[f],
                              None if block_bits is None else block_bits[f],
                              codes[f], s["quality"])
            for k in counts:
                counts[k] += got[k]
    return {**{k: (v, 0) for k, v in counts.items()},
            "outputs_missing": (missing + int(not kept), 0)}
