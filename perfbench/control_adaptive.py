"""The control of an oncard_adaptive cell's check: two wrong encoders put
in the codec's place over every plane of the run's first batch, judged
by the cell's check. Each has to come out not correct; each number it
reads is an upper reading for the limit of that check.

- ``tf32``: the reference (perfbench/reference/adaptive.py) with its
  matrix products in TF32 (control.py's ``matmul``: on the card with
  TF32 switched on, on the CPU by rounding both operands), one precision
  below the configuration's float32; its codes are the reference's
  nearest.
- ``scale_from_v``: quantization.c's own arithmetic, each AC step scaled
  by 2 - v from the normalised variance itself rather than from the u8
  code the container carries; the products in float64.

    python perfbench/control_adaptive.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed with each variant's readings. The inputs are
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

from perfbench import control, harness  # noqa: E402
from perfbench.reference import adaptive  # noqa: E402
from perfbench.reference import judge as ref  # noqa: E402
from perfbench.reference import tables  # noqa: E402

VARIANTS = ("tf32", "scale_from_v")


def encode(want: adaptive.Plane, plane: np.ndarray, quality: int,
           variant: str, device):
    """(u8 codes (NB,), zigzag coefficients (NB, 64)) of one variant on
    ``plane``, whose reference is ``want``."""
    if variant == "tf32":
        k = tables.coefficient_operator(quality, False)
        y = control.matmul(ref.blocks(plane.astype(np.float64)) - 128.0, k,
                           device).astype(np.float64)
        s = adaptive.scale(want.nearest).numpy()
    else:
        y = want.y.numpy().copy()
        s = 2.0 - adaptive.normalized(torch.from_numpy(want.var)).numpy()
    y[:, 1:] /= s[:, None]
    return want.nearest, control.round_half_away(y)


def readings(name: str, seed: int, device, root=harness.HERE) -> dict:
    cell = harness.load_cell(name, root)
    kind = harness.traffic(cell["traffic_kind"], root)
    q = kind.settings(cell["config"]["settings"])["quality"]
    state = kind.setup(cell, seed, device)
    out = {v: {"variance_code_mismatches": 0, "coef_mismatches": 0}
           for v in VARIANTS}
    for plane in state["planes"][0].cpu().numpy():
        want = adaptive.Plane(plane, q)
        for v in VARIANTS:
            codes, coef = encode(want, plane, q, v, device)
            out[v]["variance_code_mismatches"] += int(
                want.code_mismatches(codes).sum())
            out[v]["coef_mismatches"] += ref.outside(
                coef, *want.coefficient_bounds(want.judged_codes(codes)))
    return out


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
