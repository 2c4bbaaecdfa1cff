"""Build and load the port's CUDA kernels (dct_tpu_torch/csrc/*.cu).

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library
with a plain C interface (csrc/bindings.h) and loaded with ctypes. The
sources include no PyTorch header, so a build takes seconds; all of them
are compiled in parallel, one nvcc each, on first use. Libraries land in
``build/torch_kernels/`` at the repository root (listed in .gitignore),
named by a digest of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused.

Nothing here runs at import: a machine without nvcc or a GPU imports the
package and runs the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("transform", "fused_encode", "entropy_decode", "pack")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "transform": {
        "dct_encode_blocks": [_p, _p, _p, _p, _p, _p, _p, _ll, _i, _p, _p],
        "dct_mma_products": [_p, _p, _p, _i, _i, _p],
        "dct_decode_blocks": [_p, _p, _i, _p, _p, _ll, _i, _p],
    },
    "fused_encode": {
        "dct_encode_stripes": [_p, _p, _p, _p, _p, _p, _p, _p, _i, _p, _p,
                               _i, _i, _i, _i, _i, _i, _p, _i, _p, _p, _p,
                               _p],
    },
    "entropy_decode": {
        "dct_entropy_decode": [_p, _ll, _p, _p, _i, _p, _i, _p, _ll, _i, _i,
                               _i, _p],
    },
    "pack": {
        "dct_pack_chunks": [_p, _p, _i, _ll, _ll, _p, _ll, _p, _p],
    },
}

# Launches per kernel, counted by the wrappers where they launch (and
# nowhere else), so a run can show which kernels the path went through.
LAUNCHES = {"encode_blocks": 0, "encode_stripes": 0, "decode_blocks": 0,
            "entropy_decode": 0, "pack_chunks": 0}

# Coefficients the float32 chain computed in kernels A and B (the rescue
# of transform_core.cuh), one uint64 counter in device memory per kernel
# and device, added to by the kernels: read with rescued(), which waits.
_rescue_counters: dict[tuple, torch.Tensor] = {}

_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rescue_counter(kernel: str, device) -> torch.Tensor:
    """The (1,) int64 device counter kernel A or B adds its rescued
    coefficients to."""
    key = (kernel, torch.device(device))
    if key not in _rescue_counters:
        _rescue_counters[key] = torch.zeros(1, dtype=torch.int64,
                                            device=device)
    return _rescue_counters[key]


def rescued(kernel: str) -> int:
    """Coefficients kernel A ("encode_blocks") or B ("encode_stripes") has
    rescued since the last reset_rescued(), over all devices."""
    return sum(int(t.item()) for (k, _), t in _rescue_counters.items()
               if k == kernel)


def reset_rescued() -> None:
    for t in _rescue_counters.values():
        t.zero_()


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.h")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all() -> dict[str, str]:
    """Compile every stale source, all nvcc processes at once. Returns
    {name: compiler output} for the sources built (ptxas register and
    shared-memory lines included); raises with the log if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, args in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = _i
        lib.dct_error_string.argtypes = [_i]
        lib.dct_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def ptr(t) -> int | None:
    """A tensor's device pointer, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc != 0:
        msg = lib.dct_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")

