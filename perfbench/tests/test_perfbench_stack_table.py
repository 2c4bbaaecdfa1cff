"""The plain reference of a stack's table (perfbench/reference/
stack_table.py) against the port's analyze pass and table build on the
CPU, and the reason the dynamic-table cell judges a container's table
against its stack's and not its frame's own."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from dct_tpu_torch import tables as dct_tables
from dct_tpu_torch.config import CodecConfig
from dct_tpu_torch.models import codec
from dct_tpu_torch.models.video import VideoCodec
from dct_tpu_torch.ops import blocks as blk
from dct_tpu_torch.ops import rle
from perfbench import frames, harness
from perfbench.reference import judge as ref
from perfbench.reference import stack_table

CPU = torch.device("cpu")
CFG = CodecConfig(quality=50)
SEEDS = [2**31 + 21, 7, 2**31 + 1000003]


def photo(n, seed, h=64, w=96):
    return frames.photo(n, h, w, frames.generator(seed, CPU), CPU).numpy()


def analyze(stack):
    """The port's analyze pass over the stack -> (its category histogram,
    each frame's (NB, 64) coefficients)."""
    ops = dct_tables.build(CFG, device=CPU)
    img = codec.pad_plane_for_encode(torch.from_numpy(stack), CFG)
    _, _, hist, _ = codec.encode_analyze(img, CFG, ops)
    zz = codec.encode_transform(blk.image_to_blocks(img, 8).reshape(-1, 64),
                                CFG, ops)
    return hist, list(zz.reshape(len(stack), -1, 64))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_stack_histogram_and_lengths_are_the_ports(seed):
    hist, coef = analyze(photo(4, seed))
    want = stack_table.histogram(coef)
    assert want.dtype == torch.int64
    assert hist.to(torch.int64).tolist() == want.tolist()
    assert np.array_equal(codec._build_table(CFG, hist.numpy()).lengths,
                          stack_table.lengths(coef))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_symbols_are_the_ports_positional_rle(seed):
    _, coef = analyze(photo(2, seed))
    z = torch.cat(coef)
    z[0] = 0                       # an all-zero block: one terminal of 64
    z[1, 63] = 5                   # a block that ends on a value: none
    values, runs, live = stack_table.symbols(z)
    port = rle.rle_encode_positional(z.to(torch.int32))
    assert torch.equal(live, port.is_sym)
    assert torch.equal(values, port.values.to(torch.int64))
    assert torch.equal(runs, port.runs.to(torch.int64))
    assert runs[0].tolist() == [0] * 63 + [64]
    assert live[1].sum() == (z[1] != 0).sum()


def test_categories_are_bit_lengths():
    v = torch.tensor([0, 1, -1, 2, -3, 4, 1023, -1024, 2047, 32767])
    assert stack_table.categories(v).tolist() == [0, 1, 1, 2, 2, 3, 10, 11,
                                                  11, 15]


def test_a_scene_cut_passes_the_stack_check_and_fails_the_frames_own():
    """Two frames of one scene, then two of another: the stack's table is
    not every frame's own. The cell's check passes the program's
    containers; the per-frame comparison of judge.check_container, right
    only for static tables, would count faults."""
    stack = np.concatenate([photo(2, 11), photo(2, 12)])
    _, coef = analyze(stack)
    want = stack_table.lengths(coef)
    own = [stack_table.lengths([c]) for c in coef]
    assert any(not np.array_equal(o, want) for o in own)
    out = VideoCodec(CFG, device=CPU).encode(stack)
    host_stacks = harness.traffic("host_stacks")
    got = host_stacks.check_stack(out, stack, 50, "auto", set(range(4)))
    assert got == {"coef_mismatches": 0, "stream_faults": 0}
    per_frame = [ref.check_container(
        d, 50, False, "auto", "gray", *f.shape,
        [ref.coefficient_bounds(f, f, 50, False)]) for d, f in zip(out, stack)]
    assert all(r["coef_mismatches"] == 0 for r in per_frame)
    assert sum(r["stream_faults"] for r in per_frame) > 0


def test_the_stack_reference_loads_nothing_of_the_program_or_jax():
    from perfbench.tests.test_perfbench_isolation import FORBIDDEN, run_py

    p = run_py("import sys, json; import perfbench.reference.stack_table; "
               "print(json.dumps(sorted(sys.modules)))")
    assert p.returncode == 0, p.stderr
    mods = json.loads(p.stdout)
    assert "torch" in mods
    assert not [m for m in mods
                if m.split(".")[0] in FORBIDDEN + ("dct_tpu_torch",)]
