"""Codec configuration (the port's copy of ``dct_tpu.config``).

The whole configuration is one frozen, hashable dataclass; every derived
constant (DCT basis, quant tables, zigzag permutation, fused operators) is
a pure function of it (:mod:`dct_tpu_torch.tables`). The fields, defaults
and validation are the reference package's, so the same keyword arguments
describe the same codec in both packages and the containers they write
agree byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

HuffmanMode = Literal["category", "direct", "none"]
ChromaMode = Literal["gray", "444", "420"]


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Full configuration of the codec pipeline.

    Attributes:
      block_size: transform block size N (8 uses the JPEG table; other N a
        synthetic radial quant table).
      quality: JPEG-style quality in [1, 100]; values outside are clamped.
      adaptive: per-block variance-adaptive quantization.
      use_huffman: Huffman-code the RLE values; if False, fixed 16-bit
        values (mode "none").
      huffman_mode: how values are entropy-coded:
          * ``"category"`` — JPEG-style magnitude category + extra bits,
            per-image canonical table. Default.
          * ``"direct"`` — canonical Huffman over the value alphabet
            [-255, 255] plus an escape to a raw 16-bit value.
          * ``"none"`` — fixed-length 16-bit values.
      static_tables: a fixed default category table instead of a per-image
        table from the histogram (one encode pass, no histogram sync). Only
        meaningful with huffman_mode="category".
      dc_prediction: delta-code each block's DC coefficient against the
        previous block within its stripe (stripe-local DPCM).
      coded_runs: Huffman-code the run field with its own canonical table
        instead of the fixed 8-bit field.
      use_pallas: the reference package's switch to its TPU kernels. The
        port routes by the tensor's device instead and ignores it; it stays
        a field so both packages accept the same arguments.
      compat_b1: reproduce the C reference's bug B1 (the non-adaptive
        dequantize multiplies by 1/q instead of q). Off by default.
      chroma: ``"gray"`` single plane, ``"444"`` or ``"420"`` YCbCr.
      stripe_rows: block rows per bitstream stripe; each stripe is an
        independent byte-aligned substream in the container.
      decode_index: store per-block bit lengths in the container (version
        2), which makes every block an independently addressable substream
        and lets the entropy decode run on the card (kernel D,
        ops/entropy_decode_cuda.py). True (always), False (never, version
        1), or "auto" (the default: only when the packed index costs at
        most ``container.AUTO_INDEX_BOUND`` of the payload).
      dtype: compute dtype name of the float64-built operators.
    """

    block_size: int = 8
    quality: int = 50
    adaptive: bool = False
    use_huffman: bool = True
    huffman_mode: HuffmanMode = "category"
    static_tables: bool = False
    coded_runs: bool = False
    dc_prediction: bool = False
    use_pallas: bool = False
    compat_b1: bool = False
    chroma: ChromaMode = "gray"
    stripe_rows: int = 1
    decode_index: bool | str = "auto"
    dtype: str = "float32"

    def __post_init__(self):
        if self.block_size < 2:
            raise ValueError(f"block_size must be >= 2, got {self.block_size}")
        if self.decode_index not in (True, False, "auto"):
            raise ValueError(
                f"decode_index must be True, False or 'auto', got "
                f"{self.decode_index!r}"
            )
        if self.coded_runs and self.block_size > 8:
            # The run-code alphabet (and the container's 65-entry run
            # table) covers runs 0..64; N > 8 blocks produce runs up to
            # N^2. The fixed run field handles any N <= 16.
            raise ValueError(
                "coded_runs requires block_size <= 8 (run alphabet is 0..64)"
            )
        # clamp rather than reject, as the C reference does
        q = min(100, max(1, int(self.quality)))
        object.__setattr__(self, "quality", q)

    @property
    def n(self) -> int:
        return self.block_size

    @property
    def n2(self) -> int:
        return self.block_size * self.block_size

    def replace(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = CodecConfig()
