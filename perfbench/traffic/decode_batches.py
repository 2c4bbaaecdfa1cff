"""Batches of still-image containers in host memory decoded by
``models/video.py::VideoCodec.decode_to_device`` into u8 RGB frames on
the card, ready for a model: a training dataloader's feed.

Set-up makes ``pool_batches`` x ``batch`` distinct RGB stills from the
seed on the card and encodes each with
``models/color.py::ColorImageCodec`` (the configuration's settings), so
each still has its own tables and the batch decodes frame by frame.
Closed loop, one batch in flight: each call's frames are synchronised
before the next call.

Metric: decode_mpix_s, the frames' pixels over the window.
Check: in a batch kept from a call drawn from the seed and in the last
call's, ``check_frames`` frames drawn from the seed afresh for each, one
from each of as many equal runs of the batch: the container set-up made,
judged as in host_batches against the float64 conversion and transform
of its RGB, and the decoded RGB against the float64 decode of that
container's coefficients and the float64 conversion back to RGB. A call
that returns fewer frames than its batch counts the rest as missing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models.color import ColorImageCodec
from dct_tpu_torch.models.video import VideoCodec
from perfbench import frames, harness
from perfbench.reference import container
from perfbench.reference import judge as ref


def setup(cell, seed, device):
    conf, p = cell["config"], cell["params"]
    cfg = CodecConfig(**conf["settings"])
    h, w = conf["frame"]["height"], conf["frame"]["width"]
    gen = frames.generator(seed, device)
    n = p["pool_batches"] * p["batch"]
    rgb = frames.photo(n, h, w, gen, device, rgb=True)
    still = ColorImageCodec(cfg, device=device)
    data = [still.encode(rgb[i]) for i in range(n)]
    batches = [data[i:i + p["batch"]] for i in range(0, n, p["batch"])]
    work = []
    for b in batches:
        blocks = stripes = payload = 0
        for d in b:
            for pl in container.parse(d).planes:
                bh, bw = container.grid(pl.height, pl.width)
                blocks += bh * bw
                stripes += bh
                payload += sum(len(s) for s in pl.stripes)
        work.append((blocks, stripes, payload))
    return {"cell": cell, "codec": VideoCodec(cfg, device=device),
            "device": device, "rgb": rgb, "batches": batches, "work": work,
            "seed": seed, "kept": [], "check_frames": p["check_frames"]}


def warm(state):
    for b in state["batches"]:
        state["codec"].decode_to_device(b)


def window(state, seconds, sampler):
    dev, batches = state["device"], state["batches"]
    spans = []
    n = failed = 0
    out = None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        try:
            out = state["codec"].decode_to_device(batches[n % len(batches)])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except Exception as e:  # a raised call counts as failed
            failed += 1
            state.setdefault("errors", []).append(repr(e))
            out = None
        spans.append(time.perf_counter() - a)
        if out is not None and sampler.take(a - t0):
            state["kept"].append((n % len(batches), out))
        n += 1
    elapsed = time.perf_counter() - t0
    if out is not None:
        state["kept"].append(((n - 1) % len(batches), out))
    calls = np.bincount(np.arange(n) % len(batches), minlength=len(batches))
    blocks, stripes, payload = (int(v) for v in
                                np.asarray(state["work"]).T @ calls)
    f = len(batches[0])
    h, w = state["rgb"].shape[1:3]
    return {"metrics": {"decode_mpix_s": n * f * h * w / elapsed / 1e6},
            "attempted": n, "failed": failed, "elapsed": elapsed,
            "spans": {"VideoCodec.decode_to_device": spans},
            "work": {"frames": n * f,
                     "kernel_d": {"blocks": blocks, "stripes": stripes,
                                  "payload_bytes": payload},
                     "kernel_c": {"blocks": blocks}}}


def judge(state):
    s = ref.settings(state["cell"]["config"]["settings"])
    sub = s["chroma"] == "420"
    f = len(state["batches"][0])
    kept, missing = [], 0
    for n, (b, out) in enumerate(state["kept"]):
        missing += max(0, f - out.shape[0])
        picks = harness.picks(state["seed"], 5 + n, f, state["check_frames"])
        kept.append((b, {j: out[j].cpu().numpy() for j in picks
                         if j < out.shape[0]}))
    rgb = {b * f + j: state["rgb"][b * f + j].cpu().numpy()
           for b, got in kept for j in got}
    data = [d for b in state["batches"] for d in b]
    state.pop("codec")
    state.pop("rgb")
    mism = faults = rgb_mism = 0
    bounds_of = {}
    for k, frame in rgb.items():
        h, w = frame.shape[:2]
        planes = ref.rgb_planes(frame, sub)
        r = ref.check_container(
            data[k], s["quality"], s["static_tables"], s["decode_index"],
            s["chroma"], h, w,
            [ref.coefficient_bounds(lo, hi, s["quality"], i > 0)
             for i, (lo, hi) in enumerate(planes)])
        mism += r["coef_mismatches"]
        faults += r["stream_faults"]
        if len(r["coef"]) == 3 and all(c is not None for c in r["coef"]):
            pb = [ref.plane_bounds(c, ph, pw, s["quality"], i > 0)
                  for i, (c, (ph, pw)) in enumerate(zip(
                      r["coef"], ref.plane_sizes(h, w, s["chroma"])))]
            bounds_of[k] = ref.rgb_bounds(*pb, h, w, sub)
    for b, got in kept:
        for j, img in got.items():
            k = b * f + j
            if k not in bounds_of:
                continue  # its container is at fault, counted above
            lo, hi = bounds_of[k]
            rgb_mism += (ref.outside(img, lo, hi) if img.shape == lo.shape
                         else lo.size)
    return {"coef_mismatches": (mism, 0), "stream_faults": (faults, 0),
            "rgb_mismatches": (rgb_mism, 0),
            "outputs_missing": (missing + int(not kept), 0)}
