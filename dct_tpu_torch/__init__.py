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

from dct_tpu_torch.config import DEFAULT_CONFIG, CodecConfig

__all__ = ["CodecConfig", "DEFAULT_CONFIG"]
