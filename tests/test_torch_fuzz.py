"""A small fuzz of the port's bytes against the JAX package's, on the CPU:
a few seeds, each drawing one config (block size 4, 8 or 16; mode;
quality 1-100, with q97-q100 among the seeds; stripe_rows 1-4; adaptive
quantization, DC prediction, coded runs, static tables and the decode
index on or off) and one image of at most 64 x 96 of "photo", "noise" or
"checker" content; and the four real images of tests/data at q50 and
q90.

Containers: byte-identical to the JAX package's, ties excepted (an
encode tie: at most 1 apart, the float64 value within 1e-6 of a .5
boundary; testing.encode_mismatches). Decoded pixels of the JAX
container: within 1 of the JAX decode, and equal except at decode ties
(1e-3; testing.decode_mismatches).
"""

import os

import numpy as np
import pytest

from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu_torch import CodecConfig, testing
from dct_tpu_torch.models import codec
from dct_tpu_torch.utils import image_io

DATA = os.path.join(os.path.dirname(__file__), "data")
SEEDS = range(16)
HIGH_QUALITY = (97, 98, 99, 100)


def _draw(seed: int):
    """(config fields, image) of one fuzz seed."""
    rng = np.random.default_rng(7000 + seed)
    block = int(rng.choice([4, 8, 16]))
    mode = str(rng.choice(["category", "direct", "none"]))
    quality = (HIGH_QUALITY[seed // 2 % 4] if seed % 2 == 0
               else int(rng.integers(1, 101)))
    kw = dict(
        block_size=block, quality=quality,
        use_huffman=mode != "none",
        huffman_mode=mode if mode != "none" else "category",
        adaptive=bool(rng.integers(0, 2)),
        dc_prediction=bool(rng.integers(0, 2)),
        coded_runs=bool(rng.integers(0, 2)) and block <= 8,
        static_tables=bool(rng.integers(0, 2)) and mode == "category",
        stripe_rows=int(rng.integers(1, 5)),
        decode_index=(True, False, "auto")[int(rng.integers(0, 3))],
    )
    kind = ("photo", "noise", "checker")[seed % 3]
    h, w = int(rng.integers(9, 65)), int(rng.integers(9, 97))
    return kw, image_io.synthetic_image(h, w, kind, seed=seed)


def _check(kw: dict, img: np.ndarray) -> None:
    data = codec.ImageCodec(CodecConfig(**kw), device="cpu").encode(img)
    want = ref_codec.ImageCodec(RefConfig(**kw)).encode(img)
    if data != want:
        first = next(i for i, (a, b) in enumerate(zip(data, want)) if a != b)
        n_mis, n_bad = testing.encode_mismatches(data, want, img)
        assert n_bad == 0, (kw, img.shape, f"first differing byte {first}")
    rec = codec.ImageCodec(CodecConfig(**kw), device="cpu").decode(want)
    ref = ref_codec.ImageCodec(RefConfig(**kw)).decode(want)
    assert rec.shape == ref.shape == img.shape
    assert np.abs(rec.astype(int) - ref).max() <= 1, kw
    assert testing.decode_mismatches(rec, ref, want)[1] == 0, kw


def test_seeds_cover_the_dense_end():
    qualities = [_draw(s)[0]["quality"] for s in SEEDS]
    assert set(HIGH_QUALITY) <= set(qualities)
    assert {_draw(s)[0]["block_size"] for s in SEEDS} == {4, 8, 16}


@pytest.mark.parametrize("seed", SEEDS)
def test_random_config_bytes_match_reference(seed):
    _check(*_draw(seed))


@pytest.mark.parametrize("quality", (50, 90))
@pytest.mark.parametrize("name", ("mri", "topobathy", "dem", "hopper"))
def test_real_image_bytes_match_reference(name, quality):
    img = image_io.read_image(os.path.join(DATA, name + ".pgm"))
    _check(dict(quality=quality), img)
