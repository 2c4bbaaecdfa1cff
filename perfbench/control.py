"""The control of a cell's check: the plain reference put in the codec's
place and computed one precision below the configuration's float32 (its
matrix products in TF32: on the card with TF32 switched on, on the CPU
by rounding both operands to TF32's 10 explicit mantissa bits), judged by
the same check as a run. It has to come out not correct; each number it
reads is an upper reading for the limit of that check.

    python perfbench/control.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed with each check's reading. The inputs are
the run's own for that seed (the traffic's set-up makes them); the
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from perfbench import frames, harness  # noqa: E402
from perfbench.reference import judge as ref  # noqa: E402
from perfbench.reference import tables  # noqa: E402


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's precision, to nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def matmul(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    x = torch.as_tensor(a, dtype=torch.float32, device=device)
    m = torch.as_tensor(b, dtype=torch.float32, device=device)
    if device.type == "cuda":
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return (x @ m).cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return (tf32(x) @ tf32(m)).numpy()


def round_half_away(y: np.ndarray) -> np.ndarray:
    return np.trunc(y + np.copysign(0.5, y)).astype(np.int64)


def encode(plane: np.ndarray, quality: int, chroma: bool, device):
    k = tables.coefficient_operator(quality, chroma)
    return round_half_away(matmul(ref.blocks(plane.astype(np.float64))
                                  - 128.0, k, device))


def decode_rgb(coefs, sizes, h, w, quality, subsample, device):
    planes = []
    for i, (c, (ph, pw)) in enumerate(zip(coefs, sizes)):
        v = matmul(c, tables.pixel_operator(quality, i > 0), device) + 128.0
        planes.append(np.clip(round_half_away(ref.unblock(v, ph, pw)),
                              0, 255).astype(np.float32))
    y, cb, cr = planes
    if subsample:
        cb, cr = (p.repeat(2, 0).repeat(2, 1)[:h, :w] for p in (cb, cr))
    cb, cr = cb - np.float32(128), cr - np.float32(128)
    rgb = np.stack([y + np.float32(1.402) * cr,
                    y - np.float32(0.344136) * cb - np.float32(0.714136) * cr,
                    y + np.float32(1.772) * cb], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.int64)


def gray_frames(kind: str, state) -> list[np.ndarray]:
    """The frames a run of this seed checks, by traffic kind."""
    if kind == "oncard_batches":
        return list(state["planes"][0].cpu().numpy())
    if kind == "host_batches":
        return list(state["stacks"][0][:state["check_frames"]])
    raise NotImplementedError(f"no control for traffic kind {kind!r}")


def readings(name: str, seed: int, device, root=harness.HERE) -> dict:
    cell = harness.load_cell(name, root)
    s = ref.settings(cell["config"]["settings"])
    q = s["quality"]
    mism = rgb_mism = 0
    if cell["traffic_kind"] == "decode_batches":
        conf, p = cell["config"], cell["params"]
        h, w = conf["frame"]["height"], conf["frame"]["width"]
        gen = frames.generator(seed, device)
        rgb = frames.photo(p["pool_batches"] * p["batch"], h, w, gen, device,
                           rgb=True)
        sub = s["chroma"] == "420"
        sizes = ref.plane_sizes(h, w, s["chroma"])
        for i in range(p["check_frames"]):
            frame = rgb[i].cpu().numpy()
            planes = ref.rgb_planes(frame, sub)
            want = []
            for j, (lo, hi) in enumerate(planes):
                b_lo, b_hi = ref.coefficient_bounds(lo, hi, q, j > 0)
                # the plane the control converts: its own float32 rounding
                got = encode(lo, q, j > 0, device)
                mism += ref.outside(got, b_lo, b_hi)
                want.append(b_lo)
            pb = [ref.plane_bounds(c, ph, pw, q, j > 0)
                  for j, (c, (ph, pw)) in enumerate(zip(want, sizes))]
            lo, hi = ref.rgb_bounds(*pb, h, w, sub)
            rgb_mism += ref.outside(
                decode_rgb(want, sizes, h, w, q, sub, device), lo, hi)
        return {"coef_mismatches": mism, "rgb_mismatches": rgb_mism}
    kind = cell["traffic_kind"]
    state = harness.traffic(kind, root).setup(cell, seed, device)
    for plane in gray_frames(kind, state):
        lo, hi = ref.coefficient_bounds(plane, plane, q, False)
        mism += ref.outside(encode(plane, q, False, device), lo, hi)
    return {"coef_mismatches": mism}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings(args.workload, seed, device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
