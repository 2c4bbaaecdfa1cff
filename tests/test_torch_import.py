"""Import hygiene of the PyTorch port: it must load nothing of the JAX
package ``dct_tpu`` (not even its numpy-only modules), nor jax or
ml_dtypes (the machine with the GPU has neither), and importing must not
need nvcc or a GPU (kernels build on first launch)."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

PORT_MODULES = (
    "dct_tpu_torch",
    "dct_tpu_torch.config",
    "dct_tpu_torch.container",
    "dct_tpu_torch.native",
    "dct_tpu_torch.tables",
    "dct_tpu_torch.ops.blocks",
    "dct_tpu_torch.ops.quant",
    "dct_tpu_torch.ops.transform",
    "dct_tpu_torch.ops.transform_cuda",
    "dct_tpu_torch.ops.rle",
    "dct_tpu_torch.ops.huffman",
    "dct_tpu_torch.ops.bitstream",
    "dct_tpu_torch.ops.fused_encode_cuda",
    "dct_tpu_torch.ops.entropy_decode",
    "dct_tpu_torch.ops.entropy_decode_cuda",
    "dct_tpu_torch.ops.pack_cuda",
    "dct_tpu_torch.ops._build",
    "dct_tpu_torch.models.codec",
    "dct_tpu_torch.models.video",
    "dct_tpu_torch.models.color",
    "dct_tpu_torch.models.recovery",
    "dct_tpu_torch.models.rate_control",
    "dct_tpu_torch.parallel",
    "dct_tpu_torch.parallel.mesh",
    "dct_tpu_torch.parallel.shard_encode",
    "dct_tpu_torch.utils.image_io",
    "dct_tpu_torch.testing",
)


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


# what the port must not load: the JAX package, any of its modules, jax
# and ml_dtypes
_BANNED = ("import re, sys\n"
           "def banned():\n"
           "    return sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes')"
           " or re.fullmatch(r'dct_tpu(\\..*)?', m))\n")


@pytest.fixture(scope="module")
def loaded_after_import():
    """{module: the banned modules in sys.modules right after importing
    it}, from one fresh interpreter importing the port module by module."""
    out = _run(
        "import importlib, json\n" + _BANNED +
        f"mods = {list(PORT_MODULES)!r}\n"
        "res = {}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "    res[m] = banned()\n"
        "print(json.dumps(res))\n"
    )
    return json.loads(out)


@pytest.mark.parametrize("module", PORT_MODULES)
def test_module_loads_no_jax_and_no_ml_dtypes(loaded_after_import, module):
    assert loaded_after_import[module] == []


def _chip_smoke_imports() -> list[str]:
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods += [f"{node.module}.{a.name}" for a in node.names]
    return mods


def test_chip_smoke_imports_only_the_port():
    mods = _chip_smoke_imports()
    assert any(m.startswith("dct_tpu_torch") for m in mods)
    assert not [m for m in mods if re.match(r"(dct_tpu|jax|ml_dtypes)\b", m)]
    out = _run(
        "import importlib, json\n" + _BANNED +
        f"for m in {mods!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "    except ModuleNotFoundError:  # `from package import name`\n"
        "        importlib.import_module(m.rsplit('.', 1)[0])\n"
        "print(json.dumps(banned()))\n"
    )
    assert json.loads(out) == []


def test_port_sources_name_no_jax_package_module():
    """No port source or chip_smoke.py imports dct_tpu (dct_tpu_torch is
    the port's own)."""
    pattern = re.compile(r"^\s*(from|import)\s+(dct_tpu|jax|ml_dtypes)\b"
                         r"(?!_torch)", re.M)
    files = sorted((REPO / "dct_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert hits == []


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
    from dct_tpu_torch import CodecConfig, tables, testing
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.ops import _build, entropy_decode_cuda, transform_cuda

    cfg = CodecConfig()
    ops = tables.build(cfg)
    px = torch.arange(128, dtype=torch.uint8).reshape(2, 64)
    before = dict(_build.LAUNCHES)
    zz = transform_cuda.encode_blocks_kernel(px, cfg, ops)
    transform_cuda.decode_blocks_kernel(zz, cfg, ops)
    stream = testing.indexed_stream(zz, cfg.replace(decode_index=True), 1)
    entropy_decode_cuda.decode_blocks_kernel(**codec.indexed_operands(
        *stream, "category", 64, "cpu"))
    assert _build.LAUNCHES == before
