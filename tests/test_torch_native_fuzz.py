"""Hostile input through the port's host decoder (dct_tpu_torch.native,
csrc/host/bitpack.cpp) beside the JAX package's (dct_tpu.native), on the
CPU.

The cases are the mutation families of tests/test_native_fuzz.py:
payload bit flips, byte-range scrambles, truncations and noise over five
configs; hostile canonical tables (all zero, 255, 32, 33, all one,
random lengths) that bypass the tables' own validation; a direct-mode
table whose values leave int16; hostile vmin near the int32 limits.

Tolerance: none. On every case the two decoders give the same integrity
status per stripe, and either the same coefficients or a ValueError
with the same error code. The same cases then run through
native/fuzz_driver.cpp built against the port's bitpack.cpp with
-fsanitize=address,undefined (any report aborts it), and its printed
status, return code and checksum must equal the in-process results.
"""

import pathlib
import shutil
import struct
import subprocess

import numpy as np
import pytest

from dct_tpu import native as ref_native
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu_torch import container as cont
from dct_tpu_torch import native
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import huffman as hf
from dct_tpu_torch.utils import image_io

REPO = pathlib.Path(__file__).resolve().parent.parent
MODE_IDS = {"category": 0, "direct": 1, "none": 2}
CONFIGS = [
    dict(quality=50, huffman_mode="category"),
    dict(quality=50, huffman_mode="category", coded_runs=True),
    dict(quality=80, huffman_mode="direct"),
    dict(quality=50, use_huffman=False),
    dict(quality=30, block_size=16, huffman_mode="category"),
]
N_MUTATIONS = 24

pytestmark = pytest.mark.skipif(
    not (native.available() and ref_native.available()),
    reason="a host decoder did not build")


class Case:
    """One decoder input: stripes, geometry, tables, expected bits."""

    def __init__(self, stripes, bps, n2, mode, lengths, run_lengths,
                 expected_bits, vmin):
        self.stripes, self.bps, self.n2, self.mode = stripes, bps, n2, mode
        self.lengths, self.run_lengths = lengths, run_lengths
        self.expected_bits, self.vmin = expected_bits, vmin

    def table(self, lengths):
        """A table object carrying raw lengths, past the tables' own
        validation: the decoders must survive what it would refuse."""
        if lengths is None:
            return None
        t = hf.CanonicalTable.__new__(hf.CanonicalTable)
        t.lengths = np.asarray(lengths, np.uint8)
        return t

    def args(self):
        return (self.stripes, self.bps, self.n2, self.mode,
                self.table(self.lengths), self.vmin)

    def write(self, path):
        """The case file fuzz_driver.cpp reads (little-endian)."""
        tl = np.asarray(self.lengths if self.lengths is not None else [],
                        np.uint8)
        rl = np.asarray(self.run_lengths if self.run_lengths is not None
                        else [], np.uint8)
        offsets = np.zeros(len(self.stripes) + 1, np.uint64)
        np.cumsum([len(s) for s in self.stripes], out=offsets[1:])
        with open(path, "wb") as f:
            f.write(struct.pack("<I7i", 0x315A4644, len(self.stripes),
                                self.bps, self.n2, MODE_IDS[self.mode],
                                len(tl), len(rl), self.vmin))
            f.write(tl.tobytes() + rl.tobytes())
            f.write(np.asarray(self.expected_bits, np.uint32).tobytes())
            f.write(offsets.tobytes() + b"".join(self.stripes))


def _plane(kw: dict, seed: int):
    """(PlaneData, cfg, bps) of a 64x64 "photo" image's container."""
    img = image_io.synthetic_image(64, 64, "photo", seed=seed)
    c = cont.deserialize(ref_codec.ImageCodec(RefConfig(**kw)).encode(img))
    cfg, p = c.config, c.planes[0]
    bh, bw, n_stripes = codec._padded_grid(p.height, p.width, cfg)
    return p, cfg, (bh // n_stripes) * bw


def _mutations(stripes: list[bytes], rng, n: int):
    """n mutated stripe lists: a bit flip, a byte-range scramble, a
    truncation or noise, in one stripe each."""
    for _ in range(n):
        kind = rng.integers(0, 4)
        s = [bytearray(x) for x in stripes]
        idx = int(rng.integers(0, len(s)))
        if kind == 0 and len(s[idx]):
            i = int(rng.integers(0, len(s[idx])))
            s[idx][i] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1 and len(s[idx]):
            i = int(rng.integers(0, len(s[idx])))
            j = min(len(s[idx]), i + int(rng.integers(1, 16)))
            s[idx][i:j] = rng.integers(0, 256, j - i, dtype=np.uint8).tobytes()
        elif kind == 2:
            s[idx] = s[idx][: int(rng.integers(0, max(1, len(s[idx]))))]
        else:
            s[idx] = bytearray(rng.integers(
                0, 256, int(rng.integers(0, 200)), dtype=np.uint8).tobytes())
        yield [bytes(x) for x in s]


def _payload_cases(cfg_i: int) -> list[Case]:
    kw = CONFIGS[cfg_i]
    p, cfg, bps = _plane(kw, cfg_i)
    mode = cfg.huffman_mode if cfg.use_huffman else "none"
    runs = p.run_table_lengths if cfg.coded_runs else None
    rng = np.random.default_rng(300 + cfg_i)
    return [Case(list(p.stripes), bps, cfg.n2, mode, p.table_lengths, runs,
                 p.stripe_bits, codec.DIRECT_VMIN)] + [
        Case(stripes, bps, cfg.n2, mode, p.table_lengths, runs,
             p.stripe_bits, codec.DIRECT_VMIN)
        for stripes in _mutations(list(p.stripes), rng, N_MUTATIONS)]


def _table_cases() -> list[Case]:
    p, cfg, bps = _plane(dict(quality=50), 13)
    base = np.asarray(p.table_lengths, np.uint8)
    rng = np.random.default_rng(6)
    hostile = [np.zeros_like(base), np.full_like(base, 255),
               np.full_like(base, 32), np.full_like(base, 33),
               np.ones_like(base),
               rng.integers(0, 64, base.shape).astype(np.uint8)]
    return [Case(list(p.stripes), bps, cfg.n2, "category", tl, None,
                 p.stripe_bits, codec.DIRECT_VMIN) for tl in hostile]


def _value_cases() -> list[Case]:
    """Direct-mode values outside int16: a 40001-symbol table, and vmin
    at the int32 limits (sym 0, run 63: one 8x8 block in 9 bits)."""
    stripe = bytes([0b00011111, 0b10000000])
    wide = np.zeros(40001, np.uint8)
    wide[33100] = wide[40000] = 1
    small = np.zeros(3, np.uint8)
    small[0] = small[2] = 1
    return ([Case([stripe], 1, 64, "direct", wide, None, [9], -255)]
            + [Case([stripe], 1, 64, "direct", small, None, [9], vmin)
               for vmin in (2**31 - 1, -(2**31), -255)])


def _fate(pkg, case: Case):
    """(status per stripe, coefficients or the ValueError's message)."""
    status = pkg.verify_stripes(*case.args(), np.asarray(
        case.expected_bits, np.uint32), run_table=case.table(case.run_lengths))
    try:
        out = pkg.unpack_stripes(*case.args(),
                                 run_table=case.table(case.run_lengths))
    except ValueError as e:
        return status, str(e)
    return status, out


def _assert_same(cases: list[Case]) -> dict:
    """The port's fate equals the reference's on every case -> counts."""
    kinds = {"decoded": 0, "rejected": 0, "flagged": 0}
    for k, case in enumerate(cases):
        ref_status, ref_out = _fate(ref_native, case)
        status, out = _fate(native, case)
        assert np.array_equal(status, ref_status), f"case {k}: status"
        if isinstance(ref_out, str):
            assert out == ref_out, f"case {k}: {out!r} != {ref_out!r}"
            kinds["rejected"] += 1
        else:
            assert isinstance(out, np.ndarray), f"case {k}: {out}"
            assert out.dtype == ref_out.dtype and np.array_equal(out, ref_out)
            kinds["decoded"] += 1
        kinds["flagged"] += int(np.any(status != 0))
    return kinds


@pytest.mark.parametrize("cfg_i", range(len(CONFIGS)))
def test_payload_mutations_match_the_reference_decoder(cfg_i):
    kinds = _assert_same(_payload_cases(cfg_i))
    assert kinds["flagged"] > 0 and kinds["decoded"] > 0


def test_hostile_tables_match_the_reference_decoder():
    kinds = _assert_same(_table_cases())
    assert kinds["rejected"] > 0


def test_values_outside_int16_are_rejected_as_the_reference_does():
    cases = _value_cases()
    _assert_same(cases)
    for case in cases[:3]:
        with pytest.raises(ValueError, match="code 2"):
            native.unpack_stripes(*case.args())
    assert native.unpack_stripes(*cases[3].args())[0, 63] == -255


@pytest.fixture(scope="module")
def asan_harness(tmp_path_factory):
    """native/fuzz_driver.cpp linked with the port's bitpack.cpp, under
    AddressSanitizer and UndefinedBehaviorSanitizer; any report aborts."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++")
    out = tmp_path_factory.mktemp("asan") / "fuzz_port_asan"
    r = subprocess.run(
        [cxx, "-O1", "-g", "-std=c++17", "-pthread",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-fno-omit-frame-pointer", "-Wall", "-o", str(out),
         str(REPO / "native" / "fuzz_driver.cpp"),
         str(REPO / "dct_tpu_torch" / "csrc" / "host" / "bitpack.cpp")],
        capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "sanitize" in r.stderr:
        pytest.skip(f"the sanitizer runtime is missing: {r.stderr[-300:]}")
    assert r.returncode == 0, r.stderr[-3000:]
    return out


def _run_asan(harness, cases: list[Case], tmp_path) -> None:
    """Every case through the sanitized harness: no report, and its rc,
    checksum and statuses those of the in-process decoder."""
    env = {"ASAN_OPTIONS": "detect_leaks=0:abort_on_error=0",
           "UBSAN_OPTIONS": "print_stacktrace=1"}
    for k, case in enumerate(cases):
        path = tmp_path / f"case{k}.bin"
        case.write(path)
        r = subprocess.run([str(harness), str(path)], capture_output=True,
                           text=True, timeout=60, env=env)
        assert r.returncode == 0 and "runtime error" not in r.stderr, (
            f"sanitizer report on case {k}:\n{r.stderr[-3000:]}")
        status, out = _fate(native, case)
        rc = (0 if isinstance(out, np.ndarray)
              else int(out.rsplit(" ", 1)[1]))
        want = f"unpack_rc={rc} "
        if rc == 0:
            want += f"checksum={int(out.astype(np.int64).sum())} "
        assert r.stdout.startswith(want), (k, r.stdout, want)
        assert r.stdout.strip().endswith(
            "status=" + ",".join(str(int(v)) for v in status)), (k, r.stdout)


@pytest.mark.parametrize("cfg_i", range(len(CONFIGS)))
def test_port_decoder_under_sanitizers_payload(asan_harness, cfg_i, tmp_path):
    _run_asan(asan_harness, _payload_cases(cfg_i), tmp_path)


def test_port_decoder_under_sanitizers_tables(asan_harness, tmp_path):
    # the 40001-symbol table is past the harness's own 4096-entry cap
    _run_asan(asan_harness, _table_cases() + _value_cases()[1:], tmp_path)
