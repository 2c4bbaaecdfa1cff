"""Synthetic test images: the reference's numpy-only
``dct_tpu.utils.image_io.synthetic_image``, re-exported so callers of the
port name only the port."""

from dct_tpu.utils.image_io import synthetic_image

__all__ = ["synthetic_image"]
