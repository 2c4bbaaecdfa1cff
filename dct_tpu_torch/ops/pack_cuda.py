"""Kernel E (csrc/pack.cu): the chunk packer, the port's counterpart of
``dct_tpu.ops.pack_pallas.pack_chunks_pallas``.

``pack_chunks_kernel`` packs (n_stripes, C, 3) symbol chunks into 16-bit
stream units per stripe. For chunks on the CPU it runs the plain version
(ops/bitstream.py ``pack_chunks``); for CUDA chunks it checks its operands,
launches the kernel on the current stream and counts the launch, and never
falls back. The kernel takes the int32 chunks symbol_chunks gives, with
lengths in [0, 16] and no value bit above its length; under that contract
its units and bit lengths equal the plain version's.

On the main paths only two encodes reach it: 2x2 blocks, which kernel B
does not take, and the video codec's one-chunk encode with dynamic
tables, which packs the symbols of its analyze pass (models/video.py).
Every other encode runs kernel B.
"""

from __future__ import annotations

import torch

from dct_tpu_torch.ops import _build
from dct_tpu_torch.ops import bitstream as bs
from dct_tpu_torch.utils import tracing


def _check_launch(chunk_values, chunk_lens, units_capacity) -> None:
    for name, t in (("chunk_values", chunk_values), ("chunk_lens", chunk_lens)):
        if t.device != chunk_values.device:
            raise ValueError(f"pack_chunks: {name} on {t.device}, chunk_values "
                             f"on {chunk_values.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"pack_chunks: {name} must be int32, got "
                            f"{t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"pack_chunks: {name} must be (n_stripes, C, 3), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"pack_chunks: {name} must be contiguous")
    if chunk_lens.shape != chunk_values.shape:
        raise ValueError("pack_chunks: chunk_values and chunk_lens differ in "
                         "shape")
    if units_capacity < 0:
        raise ValueError(f"pack_chunks: units_capacity {units_capacity} < 0")


def pack_chunks_kernel(
    chunk_values: torch.Tensor, chunk_lens: torch.Tensor, units_capacity: int
) -> bs.PackedStripes:
    """(n_stripes, C, 3) int32 chunk values and bit lengths ->
    PackedStripes of (n_stripes, units_capacity) units and (n_stripes,)
    int32 bit lengths; bs.pack_chunks on the CPU, kernel E on CUDA. The
    kernel's units come back as an int16 view of its word buffer (u16 bit
    patterns), as kernel B gives them."""
    if chunk_values.device.type == "cpu":
        return bs.pack_chunks(chunk_values, chunk_lens, units_capacity)
    _check_launch(chunk_values, chunk_lens, units_capacity)
    n_stripes = chunk_values.shape[0]
    n_chunks = chunk_values.shape[1] * 3
    n_words = -(-units_capacity // 2)
    dev = chunk_values.device
    words = torch.empty(n_stripes, n_words, dtype=torch.int32, device=dev)
    bits = torch.empty(n_stripes, dtype=torch.int32, device=dev)
    if n_stripes:
        lib = _build.library("pack")
        with tracing.named_scope("kernel.pack_chunks"), \
                torch.cuda.device(dev):
            rc = lib.dct_pack_chunks(
                chunk_values.data_ptr(), chunk_lens.data_ptr(), n_stripes,
                n_chunks, units_capacity, words.data_ptr(), n_words,
                bits.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(lib, rc, "pack_chunks")
        _build.LAUNCHES["pack_chunks"] += 1
    units = words.view(torch.int16)[:, :units_capacity]
    return bs.PackedStripes(units=units, bit_lengths=bits)
