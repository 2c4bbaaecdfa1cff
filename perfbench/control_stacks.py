"""The control of a host_stacks cell's check: control.py's reference,
its matrix products in TF32, put in the codec's place over every frame
of the run's first stack, as the cell's check judges every frame of a
kept stack. It has to come out not correct; each number it reads is an
upper reading for the limit of that check.

    python perfbench/control_stacks.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed with each check's reading. The inputs are
the run's own for that seed (the traffic's set-up makes them); the
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from perfbench import control, harness  # noqa: E402
from perfbench.reference import judge as ref  # noqa: E402


def readings(name: str, seed: int, device, root=harness.HERE) -> dict:
    cell = harness.load_cell(name, root)
    q = ref.settings(cell["config"]["settings"])["quality"]
    state = harness.traffic(cell["traffic_kind"], root).setup(cell, seed,
                                                             device)
    mism = 0
    for plane in state["stacks"][0]:
        lo, hi = ref.coefficient_bounds(plane, plane, q, False)
        mism += ref.outside(control.encode(plane, q, False, device), lo, hi)
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
