"""Import hygiene of the PyTorch port: it must load neither jax nor
ml_dtypes (the machine with the GPU has neither), and importing must not
need nvcc or a GPU (kernels build on first launch)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

PORT_MODULES = (
    "dct_tpu_torch",
    "dct_tpu_torch.tables",
    "dct_tpu_torch.ops.blocks",
    "dct_tpu_torch.ops.quant",
    "dct_tpu_torch.ops.transform",
    "dct_tpu_torch.ops.transform_cuda",
    "dct_tpu_torch.ops.rle",
    "dct_tpu_torch.ops.huffman",
    "dct_tpu_torch.ops.bitstream",
    "dct_tpu_torch.ops.fused_encode_cuda",
    "dct_tpu_torch.ops._build",
    "dct_tpu_torch.models.codec",
    "dct_tpu_torch.utils.image_io",
    "dct_tpu_torch.testing",
)


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.fixture(scope="module")
def loaded_after_import():
    """{module: the banned modules in sys.modules right after importing
    it}, from one fresh interpreter importing the port module by module."""
    out = _run(
        "import importlib, json, sys\n"
        f"mods = {list(PORT_MODULES)!r}\n"
        "res = {}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "    res[m] = sorted(b for b in ('jax', 'ml_dtypes') if b in sys.modules)\n"
        "print(json.dumps(res))\n"
    )
    return json.loads(out)


@pytest.mark.parametrize("module", PORT_MODULES)
def test_module_loads_no_jax_and_no_ml_dtypes(loaded_after_import, module):
    assert loaded_after_import[module] == []


def test_import_builds_nothing():
    out = _run(
        "import dct_tpu_torch.models.codec; "
        "from dct_tpu_torch.ops import _build; "
        "print(len(_build._libs), sum(_build.LAUNCHES.values()))"
    )
    assert out.split() == ["0", "0"]


def test_import_leaves_backend_switches_alone():
    """No global backend switch: importing the port keeps the process's
    TF32 settings as they were."""
    out = _run(
        "import importlib, torch\n"
        "flags = lambda: (torch.backends.cuda.matmul.allow_tf32, "
        "torch.backends.cudnn.allow_tf32)\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "before = flags()\n"
        f"for m in {list(PORT_MODULES)!r}:\n"
        "    importlib.import_module(m)\n"
        "print(before == flags())\n"
    )
    assert out.split() == ["True"]


def test_cpu_tensors_take_the_plain_path_without_launching():
    from dct_tpu.config import CodecConfig
    from dct_tpu_torch import tables
    from dct_tpu_torch.ops import _build, transform_cuda

    cfg = CodecConfig()
    ops = tables.build(cfg)
    px = torch.arange(128, dtype=torch.uint8).reshape(2, 64)
    before = dict(_build.LAUNCHES)
    zz = transform_cuda.encode_blocks_kernel(px, cfg, ops)
    transform_cuda.decode_blocks_kernel(zz, cfg, ops)
    assert _build.LAUNCHES == before
