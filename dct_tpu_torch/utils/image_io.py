"""Minimal dependency-free image I/O: PGM/PPM (binary P5/P6) and .npy, and
deterministic synthetic test images (the port's copy of
``dct_tpu.utils.image_io``; a test holds the two to the same arrays).
"""

from __future__ import annotations

import pathlib

import numpy as np


def read_image(path: str | pathlib.Path) -> np.ndarray:
    """Load (H, W) grayscale or (H, W, 3) RGB u8 from .pgm/.ppm/.npy."""
    path = pathlib.Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npy":
        arr = np.load(path)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr
    if suffix in (".pgm", ".ppm"):
        return _read_pnm(path)
    raise ValueError(f"unsupported image format: {suffix} (use .pgm/.ppm/.npy)")


def write_image(path: str | pathlib.Path, image: np.ndarray) -> None:
    path = pathlib.Path(path)
    suffix = path.suffix.lower()
    image = np.asarray(image, np.uint8)
    if suffix == ".npy":
        np.save(path, image)
    elif suffix == ".pgm":
        if image.ndim != 2:
            raise ValueError("PGM is grayscale; got shape %s" % (image.shape,))
        _write_pnm(path, image, b"P5")
    elif suffix == ".ppm":
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError("PPM is RGB; got shape %s" % (image.shape,))
        _write_pnm(path, image, b"P6")
    else:
        raise ValueError(f"unsupported image format: {suffix}")


def _read_pnm(path: pathlib.Path) -> np.ndarray:
    data = path.read_bytes()
    if data[:2] not in (b"P5", b"P6"):
        raise ValueError("only binary PGM (P5) / PPM (P6) supported")
    rgb = data[:2] == b"P6"
    # parse header tokens, skipping comments
    tokens: list[int] = []
    i = 2
    while len(tokens) < 3:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(int(data[i:j]))
        i = j
    i += 1  # single whitespace after maxval
    w, h, maxval = tokens
    if maxval != 255:
        raise ValueError("only 8-bit PNM supported")
    n = h * w * (3 if rgb else 1)
    arr = np.frombuffer(data, np.uint8, n, i)
    return arr.reshape((h, w, 3) if rgb else (h, w)).copy()


def _write_pnm(path: pathlib.Path, image: np.ndarray, magic: bytes) -> None:
    h, w = image.shape[:2]
    header = magic + b"\n%d %d\n255\n" % (w, h)
    path.write_bytes(header + image.tobytes())


def synthetic_image(h: int, w: int, kind: str = "photo", seed: int = 0,
                    color: bool = False) -> np.ndarray:
    """Deterministic synthetic test images with natural-ish statistics.

    kinds: 'photo' (smooth multi-scale gradients + texture noise), 'flat',
    'noise', 'checker'.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == "photo":
        img = (
            128
            + 55 * np.sin(xx / 37.0 + 1.3) * np.cos(yy / 23.0)
            + 35 * np.sin((xx + yy) / 91.0)
            + 20 * np.sin(xx / 7.0) * np.sin(yy / 5.0)
            + rng.normal(0, 4, (h, w))
        )
    elif kind == "flat":
        img = np.full((h, w), 120.0) + rng.normal(0, 1.5, (h, w))
    elif kind == "noise":
        img = rng.uniform(0, 255, (h, w))
    elif kind == "checker":
        img = 255.0 * (((xx // 8) + (yy // 8)) % 2)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    img = np.clip(img, 0, 255).astype(np.uint8)
    if color:
        # correlated channels with constant chroma offsets (natural-ish)
        r = np.clip(img.astype(np.int16) + 15, 0, 255).astype(np.uint8)
        b = np.clip(img.astype(np.int16) - 20, 0, 255).astype(np.uint8)
        img = np.stack([r, img, b], axis=-1)
    return img
