"""Batches of padded gray planes already on the card, encoded by
``models/codec.py::encode_step`` into packed stripes that stay there.

Closed loop with at most ``in_flight`` batches enqueued and not yet
finished. The inputs are ``pool_batches`` distinct batches of ``batch``
planes made from the seed, cycled, so that they do not sit in the card's
cache. The window ends with a synchronise; every batch issued in it is
counted.

Metric: oncard_encode_mpix_s, the padded planes' pixels over the window.
Check: a batch of stripes kept from a call drawn from the seed and from
the last call, each stripe decoded by the reference, every coefficient
against the float64 transform of its planes; the stripe bit lengths and
the block index against what the decode took. A call that returns fewer
planes or stripes than its batch counts the rest as missing.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec
from perfbench import frames
from perfbench.reference import judge as ref
from perfbench.reference import tables


def setup(cell, seed, device):
    conf, p = cell["config"], cell["params"]
    cfg = CodecConfig(**conf["settings"])
    h, w = conf["frame"]["height"], conf["frame"]["width"]
    gen = frames.generator(seed, device)
    planes = frames.pad_to_blocks(frames.photo(
        p["pool_batches"] * p["batch"], h, w, gen, device))
    planes = planes.reshape(p["pool_batches"], p["batch"], *planes.shape[-2:])
    return {"cell": cell, "cfg": cfg, "device": device, "planes": planes,
            "n_stripes": planes.shape[-2] // 8, "in_flight": p["in_flight"],
            "seed": seed, "kept": []}


def _call(state, i):
    return codec.encode_step(state["planes"][i % len(state["planes"])],
                             state["cfg"], state["n_stripes"])


def warm(state):
    for i in range(len(state["planes"])):
        _call(state, i)


def window(state, seconds, sampler):
    dev = state["device"]
    pool = len(state["planes"])
    events = collections.deque()
    spans, last = [], {}
    n = failed = 0
    out = None
    t0 = time.perf_counter()
    while True:
        if len(events) >= state["in_flight"]:
            events.popleft().synchronize()
        a = time.perf_counter()
        try:
            out = _call(state, n)
        except Exception as e:  # a raised call counts as failed
            failed += 1
            state.setdefault("errors", []).append(repr(e))
            out = None
        spans.append(time.perf_counter() - a)
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
        if out is not None:
            last[n % pool] = out[0].bit_lengths
            if sampler.take(a - t0):
                state["kept"].append((n % pool, out))
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    if out is not None:
        state["kept"].append(((n - 1) % pool, out))
    px = state["planes"][0].numel()
    calls = np.bincount(np.arange(n) % pool, minlength=pool)
    payload = sum(int(calls[b]) * int(((bits.to(torch.int64) + 7) // 8).sum())
                  for b, bits in last.items())
    blocks = n * px // 64
    return {"metrics": {"oncard_encode_mpix_s": n * px / elapsed / 1e6},
            "attempted": n, "failed": failed, "elapsed": elapsed,
            "spans": {"encode_step": spans},
            "work": {"kernel_b": {"blocks": blocks,
                                  "stripes": n * state["planes"].shape[1]
                                  * state["n_stripes"],
                                  "payload_bytes": payload,
                                  "index": state["cfg"].decode_index
                                  is not False}}}


def judge(state):
    s = ref.settings(state["cell"]["config"]["settings"])
    kept = [(b, o[0].units.cpu().numpy(), o[0].bit_lengths.cpu().numpy(),
             None if o[2] is None else o[2].cpu().numpy())
            for b, o in state["kept"]]
    planes = state["planes"].cpu().numpy()
    n_stripes = state["n_stripes"]
    state.clear()
    lengths = tables.static_category_lengths(s["quality"])
    mism = faults = missing = 0
    for b, units, bits, block_bits in kept:
        missing += (planes.shape[1] * n_stripes
                    - min(units.shape[0], planes.shape[1])
                    * min(units.shape[1], n_stripes))
        for f in range(units.shape[0]):
            stripes = [units[f, k].astype(">u2").tobytes()[:(int(bits[f, k])
                                                              + 7) // 8]
                       for k in range(units.shape[1])]
            plane = planes[b, f]
            out = ref.check_planes([{
                "stripes": stripes, "stripe_bits": bits[f],
                "lengths": lengths,
                "block_bits": None if block_bits is None else block_bits[f],
                "bounds": ref.coefficient_bounds(plane, plane, s["quality"],
                                                 False),
                "width": plane.shape[1], "height": plane.shape[0]}],
                s["quality"], s["static_tables"])
            mism += out["coef_mismatches"]
            faults += out["stream_faults"]
    return {"coef_mismatches": (mism, 0), "stream_faults": (faults, 0),
            "outputs_missing": (missing + int(not kept), 0)}
