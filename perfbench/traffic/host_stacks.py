"""Stacks of u8 frames in host memory encoded by
``models/video.py::VideoCodec.encode`` with the codec's default per-stack
tables: the table is built from the histogram of the stack's own
symbols, so the encode runs the analyze pass (kernel A, the RLE, the
histogram), reads the histogram back, builds the table and packs the
symbols with kernel E. An archive or ingest job that keeps the defaults.

Set-up, warm-up and the window are host_batches': closed loop, one stack
at a time, ``pool_stacks`` distinct stacks of ``stack`` frames made from
the seed, cycled; metric encode_mpix_s. The window also returns what the
slice's kernels had to do, counted once for each pool stack in the
warm-up and summed over the calls: blocks for kernel A; for kernel E the
chunks it was handed (three code words a zigzag position of every
block), the stripes and the payload bytes they hold.

Check: of a call drawn from the seed and of the last call, every
container decoded by the reference (the stack's containers share one
table, so they decode in one lockstep pass) and every coefficient
against the float64 transform of its frame; every container's table
equal to the lengths of the stack's table that reference/stack_table.py
builds from the decoded coefficients of every frame; and, of
``check_frames`` containers drawn from the seed afresh for each call,
one from each of as many equal runs of the stack, the bytes against the
reference's layout of the same content.
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

from perfbench import harness
from perfbench.reference import container, entropy, stack_table
from perfbench.reference import judge as ref

host_batches = harness.traffic("host_batches",
                               pathlib.Path(__file__).resolve().parents[1])
setup = host_batches.setup


def stack_work(out: list[bytes], frames: int, h: int, w: int) -> dict:
    """What kernels A and E have to do for one stack of (frames, h, w)
    encoded to the containers ``out``."""
    bh, bw = container.grid(h, w)
    blocks = frames * bh * bw
    payload = sum(len(s) for d in out for s in container.parse(d).planes[0]
                  .stripes)
    return {"kernel_a": {"blocks": blocks},
            "kernel_e": {"chunks": blocks * 64 * 3, "stripes": frames * bh,
                         "payload_bytes": payload}}


def warm(state):
    state["work"] = []
    for stack in state["stacks"]:
        out = state["codec"].encode(stack)
        state["work"].append(stack_work(out, *stack.shape))


def window(state, seconds, sampler):
    res = host_batches.window(state, seconds, sampler)
    pool = len(state["stacks"])
    calls = np.bincount(np.arange(res["attempted"]) % pool, minlength=pool)
    for kernel in ("kernel_a", "kernel_e"):
        res["work"][kernel] = {
            key: sum(int(c) * w[kernel][key]
                     for c, w in zip(calls, state["work"]))
            for key in state["work"][0][kernel]}
    return res


def check_stack(out: list[bytes], stack: np.ndarray, quality: int,
                decode_index, layout: set) -> dict:
    """Judge one call's containers against its (F, H, W) frames: the
    coefficients, the stack's table, and the bytes of the frames in
    ``layout``. -> {"coef_mismatches", "stream_faults"}."""
    h, w = stack.shape[1:]
    bh, bw = container.grid(h, w)
    faults = mism = 0
    parsed = {}
    for i, data in enumerate(out[:len(stack)]):
        try:
            c = container.parse(data)
        except (ValueError, IndexError, struct.error):
            faults += 1
            continue
        p = c.planes[0] if len(c.planes) == 1 else None
        if (p is None or c.chroma != "gray" or c.quality != quality
                or c.flags != container.flags_of(False)
                or (c.width, c.height, p.width, p.height) != (w, h, w, h)
                or len(p.stripes) != bh or p.stripe_bits.size != bh
                or (p.block_bits is not None and p.block_bits.size
                    != bh * bw)):
            faults += 1
            continue
        if p.block_bits is not None:
            faults += int(np.count_nonzero(
                p.block_bits.reshape(bh, bw).sum(axis=1) != p.stripe_bits))
        parsed[i] = p
    # frames that share a table and an index or its absence decode as one
    # run of lanes
    groups: dict = {}
    for i, p in parsed.items():
        key = (p.lengths.tobytes(), p.block_bits is None)
        groups.setdefault(key, []).append(i)
    coef, block_bits = {}, {}
    for members in groups.values():
        ps = [parsed[i] for i in members]
        indexed = ps[0].block_bits is not None
        try:
            got = entropy.decode_stripes(
                [s for p in ps for s in p.stripes],
                np.concatenate([p.stripe_bits for p in ps]), bw,
                ps[0].lengths,
                np.concatenate([p.block_bits for p in ps]) if indexed
                else None)
        except ValueError:   # a table that is no prefix code
            faults += len(members)
            continue
        faults += got["n_faults"]
        nb = bh * bw
        for k, i in enumerate(members):
            coef[i] = got["coef"][k * nb:(k + 1) * nb]
            block_bits[i] = got["block_bits"][k * nb:(k + 1) * nb]
    for i, z in coef.items():
        mism += ref.outside(z, *ref.coefficient_bounds(stack[i], stack[i],
                                                       quality, False))
    want = stack_table.lengths(coef[i] for i in sorted(coef))
    faults += sum(not np.array_equal(p.lengths, want)
                  for p in parsed.values())
    for i in sorted(layout & set(coef)):
        p = parsed[i]
        plane = container.Plane(w, h, p.lengths, p.stripe_bits, p.stripes,
                                block_bits[i])
        version = 2 if container.index_included(decode_index, [plane]) else 1
        mine = container.serialize(container.Parsed(
            version, container.flags_of(False), 8, quality, w, h, "gray", 1,
            [plane]))
        faults += int(mine != out[i])
    return {"coef_mismatches": mism, "stream_faults": faults}


def judge(state):
    s = ref.settings(state["cell"]["config"]["settings"])
    mism = faults = missing = 0
    for n, (b, out) in enumerate(state["kept"]):
        stack = state["stacks"][b]
        missing += abs(len(stack) - len(out))
        layout = set(harness.picks(state["seed"], 3 + n, len(stack),
                                   state["check_frames"]))
        r = check_stack(out, stack, s["quality"], s["decode_index"], layout)
        mism += r["coef_mismatches"]
        faults += r["stream_faults"]
    return {"coef_mismatches": (mism, 0), "stream_faults": (faults, 0),
            "outputs_missing": (missing + int(not state["kept"]), 0)}
