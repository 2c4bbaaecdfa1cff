"""dct_tpu_torch — the PyTorch/CUDA port of the dct_tpu block-transform codec.

The JAX package ``dct_tpu`` stays the reference. This package mirrors its
layout (``ops/``, ``models/``) and writes the same containers byte for byte:
the wire format, the container code and the host entropy decoder are
imported from the numpy-only ``dct_tpu`` modules (config, tables,
container, native, utils.image_io), everything that imports jax is ported.

Each Pallas kernel of the reference's main path is a CUDA kernel for
Hopper (``csrc/``), built on first use; beside each one sits a plain
PyTorch version of the same function, which a wrapper runs only for
tensors that lie on the CPU. Importing this package loads neither jax nor
a CUDA toolchain.
"""

from dct_tpu.config import CodecConfig

__all__ = ["CodecConfig"]
