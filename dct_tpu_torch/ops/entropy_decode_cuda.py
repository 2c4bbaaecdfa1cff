"""Kernel D (csrc/entropy_decode.cu): the port's counterpart of
``dct_tpu.ops.entropy_decode_pallas``.

``decode_blocks_kernel`` replaces ``decode_call``. For a payload on the
CPU it runs the plain version (ops/entropy_decode.py); for a CUDA payload
it checks its operands, launches the kernel on the current stream and
counts the launch, and never falls back. The kernel takes n2 in
{4, 16, 64, 256}, all three modes, fixed and coded runs, and any direct
alphabet (values of codes longer than its lookahead tables are read from
device memory).

Operands: the payload (the stripes concatenated), each stripe's first bit
(host-built from the stripe byte lengths, ``ed.stripe_starts``), the
(n_stripes, bps) block bit lengths of the decode index, which the kernel
scans itself into block starts, and the packed tables. The kernel reads
the payload in aligned 32-bit words, so the payload's ``data_ptr()`` must
be 16-byte aligned: the wrapper raises otherwise. ``codec.indexed_operands``
uploads the payload first, at offset 0 of a fresh allocation, so its
payload always is.

With ``status`` ((n_stripes,) int32 zeros on the payload's device) it
returns (coefficients, status), 1 ORed into the entry of each stripe in
which a block contradicts its index (ops/entropy_decode.py): one atomic a
stripe and warp. ``codec.indexed_operands(..., status=True)`` uploads the
zeros with the other operands, so no memset precedes the launch.
"""

from __future__ import annotations

import torch

from dct_tpu_torch.ops import _build
from dct_tpu_torch.ops import entropy_decode as ed
from dct_tpu_torch.utils import tracing

KERNEL_N2 = (4, 16, 64, 256)
PAYLOAD_ALIGN = 16  # bytes


def _check_launch(payload, stripe_start, block_bits, n2, mode, tabs,
                  run_bits, status) -> None:
    if n2 not in KERNEL_N2:
        raise NotImplementedError(
            f"entropy_decode kernel takes n2 in {KERNEL_N2}, got {n2}")
    if mode not in ed.MODE_IDS:
        raise ValueError(f"unknown huffman mode {mode!r}")
    if not 0 <= run_bits <= 16:
        raise ValueError(f"run_bits must be in [0, 16], got {run_bits}")
    operands = [("payload", payload, torch.uint8, 1),
                ("stripe_start", stripe_start, torch.int64, 1),
                ("block_bits", block_bits, torch.int16, 2),
                ("tabs", tabs, torch.int32, 1)]
    if status is not None:
        operands.append(("status", status, torch.int32, 1))
        if status.numel() != stripe_start.numel():
            raise ValueError(f"entropy_decode: status has {status.numel()} "
                             f"entries, stripe_start {stripe_start.numel()}")
    for name, t, dtype, ndim in operands:
        if t.device != payload.device:
            raise ValueError(f"entropy_decode: {name} on {t.device}, payload "
                             f"on {payload.device}")
        if t.dtype != dtype or t.dim() != ndim:
            raise TypeError(f"entropy_decode: {name} must be a {ndim}-D "
                            f"{dtype} tensor, got {t.dim()}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"entropy_decode: {name} must be contiguous")
    if block_bits.shape[0] != stripe_start.numel():
        raise ValueError(f"entropy_decode: block_bits has "
                         f"{block_bits.shape[0]} stripes, stripe_start "
                         f"{stripe_start.numel()}")
    if payload.data_ptr() % PAYLOAD_ALIGN:
        raise ValueError(f"entropy_decode: the payload must be "
                         f"{PAYLOAD_ALIGN}-byte aligned (data_ptr "
                         f"{payload.data_ptr():#x})")
    if tabs.numel() < ed.TABLE_FIXED:
        raise ValueError(f"entropy_decode: tabs holds {tabs.numel()} values, "
                         f"fewer than {ed.TABLE_FIXED}")


def decode_blocks_kernel(
    payload: torch.Tensor,
    stripe_start: torch.Tensor,
    block_bits: torch.Tensor,
    n2: int,
    mode: str,
    tabs: torch.Tensor,
    run_bits: int,
    status: torch.Tensor | None = None,
):
    """(P,) u8 payload (16-byte aligned on CUDA), (n_stripes,) int64 stripe
    start bits, (n_stripes, bps) int16 (u16 bit patterns) block bit
    lengths, the packed int32 tables, the run field's width (0: coded
    runs), optionally the (n_stripes,) int32 zeroed status -> (n_stripes *
    bps, n2) int16 zigzag coefficients, or (coefficients, status) with a
    status; entropy_decode.decode_blocks_plain on the CPU, kernel D on
    CUDA."""
    if payload.device.type == "cpu":
        return ed.decode_blocks_plain(payload, stripe_start, block_bits, n2,
                                      mode, tabs, run_bits, status)
    _check_launch(payload, stripe_start, block_bits, n2, mode, tabs, run_bits,
                  status)
    n_stripes, bps = block_bits.shape
    n_blocks = n_stripes * bps
    out = torch.empty((n_blocks, n2), dtype=torch.int16, device=payload.device)
    if n_blocks == 0:
        return out if status is None else (out, status)
    lib = _build.library("entropy_decode")
    with tracing.named_scope("kernel.entropy_decode"), \
            torch.cuda.device(payload.device):
        rc = lib.dct_entropy_decode(
            payload.data_ptr(), payload.numel(), stripe_start.data_ptr(),
            block_bits.data_ptr(), bps, tabs.data_ptr(),
            tabs.numel() - ed.TABLE_FIXED, out.data_ptr(), n_blocks, n2,
            ed.MODE_IDS[mode], run_bits, _build.ptr(status),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "entropy_decode")
    _build.LAUNCHES["entropy_decode"] += 1
    return out if status is None else (out, status)
