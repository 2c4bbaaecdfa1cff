"""Stacks of u8 frames in host memory encoded by
``models/video.py::VideoCodec.encode`` into one finished container
(bytes in host memory) a frame: an archive or ingest job.

Closed loop, one stack at a time; ``pool_stacks`` distinct stacks of
``stack`` frames made from the seed, cycled. The window's time is the
host clock from the first call to the return of the last.

Metric: encode_mpix_s, the frames' pixels over the window.
Check: of a call drawn from the seed and of the last call,
``check_frames`` containers drawn from the seed afresh for each, one
from each of as many equal runs of the stack, against the reference:
every
plane decoded, every coefficient against the float64 transform of its
frame, the table, and the container's bytes against the reference's
layout of the same content.
"""

from __future__ import annotations

import time

from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models.video import VideoCodec
from perfbench import frames, harness
from perfbench.reference import judge as ref

def setup(cell, seed, device):
    conf, p = cell["config"], cell["params"]
    cfg = CodecConfig(**conf["settings"])
    h, w = conf["frame"]["height"], conf["frame"]["width"]
    gen = frames.generator(seed, device)
    stacks = [frames.photo(p["stack"], h, w, gen, device).cpu().numpy()
              for _ in range(p["pool_stacks"])]
    return {"cell": cell, "codec": VideoCodec(cfg, device=device),
            "stacks": stacks, "seed": seed, "kept": [],
            "check_frames": p["check_frames"]}

def warm(state):
    for stack in state["stacks"]:
        state["codec"].encode(stack)

def window(state, seconds, sampler):
    stacks = state["stacks"]
    spans = []
    n = failed = 0
    out = None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        try:
            out = state["codec"].encode(stacks[n % len(stacks)])
        except Exception as e:  # a raised call counts as failed
            failed += 1
            state.setdefault("errors", []).append(repr(e))
            out = None
        spans.append(time.perf_counter() - a)
        if out is not None and sampler.take(a - t0):
            state["kept"].append((n % len(stacks), out))
        n += 1
    elapsed = time.perf_counter() - t0
    if out is not None:
        state["kept"].append(((n - 1) % len(stacks), out))
    f = stacks[0].shape[0]
    return {"metrics": {"encode_mpix_s": n * stacks[0].size / elapsed / 1e6},
            "attempted": n, "failed": failed, "elapsed": elapsed,
            "spans": {"VideoCodec.encode": spans},
            "work": {"frames": n * f}}

def judge(state):
    s = ref.settings(state["cell"]["config"]["settings"])
    mism = faults = missing = 0
    for n, (b, out) in enumerate(state["kept"]):
        stack = state["stacks"][b]
        if len(out) != len(stack):
            missing += abs(len(stack) - len(out))
        for i in harness.picks(state["seed"], 3 + n, len(stack),
                               state["check_frames"]):
            if i >= len(out):
                continue
            frame = stack[i]
            r = ref.check_container(
                out[i], s["quality"], s["static_tables"], s["decode_index"],
                "gray", frame.shape[0], frame.shape[1],
                [ref.coefficient_bounds(frame, frame, s["quality"], False)])
            mism += r["coef_mismatches"]
            faults += r["stream_faults"]
    return {"coef_mismatches": (mism, 0), "stream_faults": (faults, 0),
            "outputs_missing": (missing + int(not state["kept"]), 0)}
