"""ctypes binding of the port's host entropy decoder, stripe integrity
scan and decode-index parse (csrc/host/bitpack.cpp).

The decode of a stripe is serial; stripes are independent, so the C++
decoder runs them on a thread pool. The library is compiled with the host
C++ compiler on first use into ``build/torch_kernels/`` (listed in
.gitignore), named by a digest of the source and flags, and installed with
an atomic rename, so concurrent processes agree. Where no compiler is
found, or the build fails, ``available()`` is False and the codec decodes
with the Python decoder (ops/bitstream.unpack_stripe_host) and parses the
decode index in Python (container._unpack_index), which the tests hold
equal.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

from dct_tpu_torch.ops._build import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "host" / "bitpack.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_MODE_IDS = {"category": 0, "direct": 1, "none": 2}

# Must equal bitpack.cpp's dctbits_abi_version(): v2 writes int16
# coefficients, v3 adds dctbits_unpack_index, and a library of another
# version would be called through a mismatched signature.
_ABI_VERSION = 3

_lib: ctypes.CDLL | None = None
_build_failed = False


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"bitpack-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: concurrent builds agree
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # ABI handshake before any signature is bound
    lib.dctbits_abi_version.restype = ctypes.c_int
    ver = lib.dctbits_abi_version()
    if ver != _ABI_VERSION:
        raise OSError(f"bitpack ABI {ver} != expected {_ABI_VERSION}")
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.dctbits_unpack_stripes.argtypes = [
        p,  # concatenated stripe bytes
        p,  # per-stripe byte offsets, uint64 (n_stripes + 1)
        i,  # n_stripes
        i,  # blocks per stripe
        i,  # n2
        i,  # mode id
        p,  # table lengths, uint8
        i,  # table size
        p,  # run-table lengths, uint8 (coded runs)
        i,  # run-table size (0: the fixed run field)
        i,  # vmin
        p,  # out, int16 (n_stripes * bps * n2)
        i,  # n_threads
    ]
    lib.dctbits_unpack_stripes.restype = i
    lib.dctbits_verify_stripes.argtypes = [
        p,  # concatenated stripe bytes
        p,  # per-stripe byte offsets, uint64 (n_stripes + 1)
        i,  # n_stripes
        i,  # blocks per stripe
        i,  # n2
        i,  # mode id
        p,  # table lengths, uint8
        i,  # table size
        p,  # run-table lengths, uint8 (coded runs)
        i,  # run-table size (0: the fixed run field)
        i,  # vmin
        p,  # expected bits per stripe, uint32
        p,  # status out, int32 (n_stripes)
        i,  # n_threads
    ]
    lib.dctbits_verify_stripes.restype = i
    lib.dctbits_unpack_index.argtypes = [
        p,  # packed index bytes
        ctypes.c_uint64,  # their count
        i,  # n_stripes
        i,  # blocks per stripe
        i,  # entry width w
        p,  # bits per stripe, uint32 (n_stripes)
        p,  # out, uint16 (n_stripes * bps)
    ]
    lib.dctbits_unpack_index.restype = i
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    path = library_path()
    try:
        if not path.exists() and not _build(path):
            raise OSError("bitpack.cpp did not build")
        _lib = _bind(ctypes.CDLL(str(path)))
    except (OSError, AttributeError):
        _build_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _marshal(stripes: list[bytes], table, run_table):
    """(blob, uint64 offsets, table lengths, run-table lengths, run-table
    size) as the C functions take them."""
    blob = b"".join(stripes)
    buf = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
    offsets = np.zeros(len(stripes) + 1, np.uint64)
    np.cumsum([len(s) for s in stripes], out=offsets[1:])
    lengths = (np.ascontiguousarray(table.lengths, np.uint8)
               if table is not None else np.zeros(1, np.uint8))
    if run_table is not None:
        run_lengths = np.ascontiguousarray(run_table.lengths, np.uint8)
        return buf, offsets, lengths, run_lengths, len(run_lengths)
    return buf, offsets, lengths, np.zeros(1, np.uint8), 0


def _threads(n_threads: int | None) -> int:
    return (os.cpu_count() or 1) if n_threads is None else n_threads


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native decoder did not build")
    return lib


def unpack_stripes(
    stripes: list[bytes],
    blocks_per_stripe: int,
    n2: int,
    mode: str,
    table,
    vmin: int,
    run_table=None,
    n_threads: int | None = None,
) -> np.ndarray:
    """Decode stripe substreams -> (n_stripes * bps, n2) int16 zigzag
    coefficients (the wire's coefficient type, and kernel C's input).
    table/run_table: CanonicalTable or None. n_threads defaults to the
    host's core count. Raises ValueError on a corrupt stream."""
    lib = _require()
    n_stripes = len(stripes)
    buf, offsets, lengths, run_lengths, run_size = _marshal(
        stripes, table, run_table)
    out = np.empty((n_stripes * blocks_per_stripe, n2), np.int16)
    rc = lib.dctbits_unpack_stripes(
        buf.ctypes.data, offsets.ctypes.data, n_stripes, blocks_per_stripe,
        n2, _MODE_IDS[mode], lengths.ctypes.data, len(lengths),
        run_lengths.ctypes.data, run_size, vmin, out.ctypes.data,
        _threads(n_threads),
    )
    if rc != 0:
        raise ValueError(f"native stripe decode failed with code {rc}")
    return out


def verify_stripes(
    stripes: list[bytes],
    blocks_per_stripe: int,
    n2: int,
    mode: str,
    table,
    vmin: int,
    expected_bits: np.ndarray,
    run_table=None,
    n_threads: int | None = None,
) -> np.ndarray:
    """Integrity scan of stripe substreams -> (n_stripes,) int32 status:
    0 ok, 2 an invalid symbol, 3 an overrun, 4 the decode consumed another
    bit count than the container records (expected_bits). The contract of
    the Python scan in models/recovery.py, on the thread pool."""
    lib = _require()
    n_stripes = len(stripes)
    buf, offsets, lengths, run_lengths, run_size = _marshal(
        stripes, table, run_table)
    expected = np.ascontiguousarray(expected_bits, np.uint32)
    status = np.zeros(n_stripes, np.int32)
    lib.dctbits_verify_stripes(
        buf.ctypes.data, offsets.ctypes.data, n_stripes, blocks_per_stripe,
        n2, _MODE_IDS[mode], lengths.ctypes.data, len(lengths),
        run_lengths.ctypes.data, run_size, vmin, expected.ctypes.data,
        status.ctypes.data, _threads(n_threads),
    )
    return status


def unpack_index(raw: np.ndarray, n_stripes: int, bps: int, w: int,
                 stripe_bits: np.ndarray) -> tuple[np.ndarray, int]:
    """Parse a packed decode index in one pass -> ((n_stripes * bps,)
    uint16 entries, status). raw: the index's bytes (uint8; at least
    ceil(n_stripes * bps * w / 8)), MSB-first w-bit entries. Status: 0 ok;
    1 the pad bits after the last entry are not zero; 2 a stripe's entries
    do not sum to its stripe_bits; 3 the arguments are out of range (w
    outside 1..16, no stripes or blocks, raw too short), with the entries
    unwritten."""
    lib = _require()
    raw = np.ascontiguousarray(raw, np.uint8)
    sb = np.ascontiguousarray(stripe_bits, np.uint32)
    n = n_stripes * bps
    if not (1 <= w <= 16 and 1 <= n_stripes < 2**31 and 1 <= bps < 2**31
            and (n * w + 7) // 8 <= raw.size and n_stripes <= sb.size):
        return np.empty(0, np.uint16), 3
    out = np.empty(n, np.uint16)
    rc = lib.dctbits_unpack_index(raw.ctypes.data, raw.size, n_stripes, bps,
                                  w, sb.ctypes.data, out.ctypes.data)
    return out, rc
