"""dct_tpu_torch — the PyTorch/CUDA port of the dct_tpu block-transform codec.

The JAX package ``dct_tpu`` stays the reference. This package mirrors its
layout (``ops/``, ``models/``) and writes the same containers byte for byte,
but stands alone: it keeps its own copies of the configuration, the
constant tables, the container format, the host entropy decoder and the
image helpers, and imports nothing of ``dct_tpu`` (a subprocess test holds
every module to that).

Each Pallas kernel on a ported path is a CUDA kernel for Hopper
(``csrc/``), built on first use; beside each one sits a plain PyTorch
version of the same function, which a wrapper runs only for tensors that
lie on the CPU. The entry points run on the card unless the caller passes
``device="cpu"``. Importing this package loads neither jax nor a CUDA
toolchain.
"""

from dct_tpu_torch import tables
from dct_tpu_torch.config import DEFAULT_CONFIG, CodecConfig

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "DEFAULT_CONFIG",
    "tables",
    "encode",
    "decode",
    "encode_to_size",
    "encode_to_psnr",
    "__version__",
]


def encode(image, config: CodecConfig | None = None, device=None) -> bytes:
    """Top-level convenience: u8 image array -> TPDC container bytes, on
    ``device`` (default: the card, raising where there is none).

    Grayscale (H, W) or RGB (H, W, 3) by array rank; see
    dct_tpu_torch.models.codec for the full API (codecs, recovery, video).
    """
    from dct_tpu_torch.models import codec

    return codec.encode(image, config, device)


def decode(data: bytes, device=None):
    """TPDC container bytes -> reconstructed u8 image array, decoded on
    ``device`` (default: the card)."""
    from dct_tpu_torch.models import codec

    return codec.decode(data, device)


def encode_to_size(image, max_bytes: int, config: CodecConfig | None = None,
                   device=None):
    """Encode to a byte budget (exact size probes): (bytes, quality).
    Full API: dct_tpu_torch.models.rate_control."""
    from dct_tpu_torch.models import rate_control

    return rate_control.encode_to_size(image, max_bytes, config,
                                       device=device)


def encode_to_psnr(image, min_psnr: float, config: CodecConfig | None = None,
                   device=None):
    """Encode to a distortion target (exact PSNR probes): (bytes, quality).
    Full API: dct_tpu_torch.models.rate_control."""
    from dct_tpu_torch.models import rate_control

    return rate_control.encode_to_psnr(image, min_psnr, config,
                                       device=device)
