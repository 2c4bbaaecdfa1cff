"""Kernel D (csrc/entropy_decode.cu): the port's counterpart of
``dct_tpu.ops.entropy_decode_pallas``.

``decode_blocks_kernel`` replaces ``decode_call``. For a payload on the
CPU it runs the plain version (ops/entropy_decode.py); for a CUDA payload
it checks its operands, launches the kernel on the current stream and
counts the launch, and never falls back. The kernel takes n2 in
{4, 16, 64, 256}, all three modes, fixed and coded runs, and any direct
alphabet (one longer than the kernel's shared-memory table is read from
device memory).
"""

from __future__ import annotations

import torch

from dct_tpu_torch.ops import _build
from dct_tpu_torch.ops import entropy_decode as ed

KERNEL_N2 = (4, 16, 64, 256)


def _check_launch(payload, block_start, block_bits, n2, mode, tabs,
                  run_bits) -> None:
    if n2 not in KERNEL_N2:
        raise NotImplementedError(
            f"entropy_decode kernel takes n2 in {KERNEL_N2}, got {n2}")
    if mode not in ed.MODE_IDS:
        raise ValueError(f"unknown huffman mode {mode!r}")
    if not 0 <= run_bits <= 16:
        raise ValueError(f"run_bits must be in [0, 16], got {run_bits}")
    for name, t, dtype, ndim in (("payload", payload, torch.uint8, 1),
                                 ("block_start", block_start, torch.int64, 1),
                                 ("block_bits", block_bits, torch.int16, 1),
                                 ("tabs", tabs, torch.int32, 1)):
        if t.device != payload.device:
            raise ValueError(f"entropy_decode: {name} on {t.device}, payload "
                             f"on {payload.device}")
        if t.dtype != dtype or t.dim() != ndim:
            raise TypeError(f"entropy_decode: {name} must be a 1-D {dtype} "
                            f"tensor, got {t.dim()}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"entropy_decode: {name} must be contiguous")
    if block_bits.numel() != block_start.numel():
        raise ValueError("entropy_decode: block_start and block_bits differ "
                         "in length")
    if tabs.numel() < ed.TABLE_FIXED:
        raise ValueError(f"entropy_decode: tabs holds {tabs.numel()} values, "
                         f"fewer than {ed.TABLE_FIXED}")


def decode_blocks_kernel(
    payload: torch.Tensor,
    block_start: torch.Tensor,
    block_bits: torch.Tensor,
    n2: int,
    mode: str,
    tabs: torch.Tensor,
    run_bits: int,
) -> torch.Tensor:
    """(P,) u8 payload, (NB,) int64 block starts, (NB,) int16 (u16 bit
    patterns) block bit lengths, the packed int32 tables, the run field's
    width (0: coded runs) -> (NB, n2) int16 zigzag coefficients;
    entropy_decode.decode_blocks_plain on the CPU, kernel D on CUDA."""
    if payload.device.type == "cpu":
        return ed.decode_blocks_plain(payload, block_start, block_bits, n2,
                                      mode, tabs, run_bits)
    _check_launch(payload, block_start, block_bits, n2, mode, tabs, run_bits)
    n_blocks = block_start.numel()
    out = torch.empty((n_blocks, n2), dtype=torch.int16, device=payload.device)
    if n_blocks == 0:
        return out
    lib = _build.library("entropy_decode")
    with torch.cuda.device(payload.device):
        rc = lib.dct_entropy_decode(
            payload.data_ptr(), payload.numel(), block_start.data_ptr(),
            block_bits.data_ptr(), tabs.data_ptr(),
            tabs.numel() - ed.TABLE_FIXED, out.data_ptr(), n_blocks, n2,
            ed.MODE_IDS[mode], run_bits,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "entropy_decode")
    _build.LAUNCHES["entropy_decode"] += 1
    return out
