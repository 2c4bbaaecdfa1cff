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

The parse of a packed decode index (``native.unpack_index``) meets the
port's plain version (``container._unpack_index`` and the stripe-sum
check) on valid indexes, indexes with a stripe's length off, a pad bit
set, random bytes, bytes cut short, and hostile widths and counts: the
same status, and the same entries wherever both write them. The same
cases run through tests/index_fuzz_harness.cpp under the same sanitizers,
with every buffer at exactly the size it is declared.

The encoder's payload pass (``native.pack_payload``, through
``bitstream.plane_payloads``) and its Python version write the per-stripe
formula's bytes (big-endian units cut to ceil(bits / 8) bytes) on uint16,
int16 and int32 units, single planes and chunks, zero-bit and full
stripes; both refuse bit lengths out of range. The same cases, bit
lengths out of range and buffers one byte short, run through
tests/payload_fuzz_harness.cpp under the same sanitizers: no write past
a buffer, nothing written where the pass refuses.
"""

import pathlib
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from dct_tpu import native as ref_native
from dct_tpu.config import CodecConfig as RefConfig
from dct_tpu.models import codec as ref_codec
from dct_tpu_torch import container as cont
from dct_tpu_torch import native
from dct_tpu_torch.models import codec
from dct_tpu_torch.ops import bitstream as bs
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


# ---------------------------------------------------------------------------
# The decode index's parse (dctbits_unpack_index)
# ---------------------------------------------------------------------------

def _pack(vals: np.ndarray, w: int) -> bytes:
    """MSB-first w-bit entries, zero pad bits (container.pack_index at a
    width of the caller's choosing)."""
    bits = (vals[:, None] >> np.arange(w - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).ravel()).tobytes()


def _index_cases() -> list[tuple]:
    """(w, n_stripes, bps, index bytes, stripe lengths) cases."""
    rng = np.random.default_rng(20)
    cases = []
    for k in range(80):
        w = int(rng.integers(1, 17))
        n_stripes, bps = int(rng.integers(1, 9)), int(rng.integers(1, 40))
        vals = rng.integers(0, 1 << w, n_stripes * bps)
        raw = bytearray(_pack(vals, w))
        sums = vals.reshape(n_stripes, bps).sum(1).astype(np.uint32)
        kind = k % 5
        if kind == 1:  # a stripe's length off
            sums[rng.integers(0, n_stripes)] ^= 1 << int(rng.integers(0, 4))
        elif kind == 2:  # a pad bit set, where there are pad bits
            raw[-1] |= 1
        elif kind == 3:  # random bytes
            raw = bytearray(rng.integers(0, 256, len(raw), dtype=np.uint8))
        elif kind == 4:  # cut short
            raw = raw[:int(rng.integers(0, len(raw)))]
        cases.append((w, n_stripes, bps, bytes(raw), sums))
    noise = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    for w in (-1, 0, 1, 16, 17, 255):
        for n_stripes in (-1, 0, 1, 2**31 - 1):
            for bps in (-7, 0, 1, 2**31 - 1):
                sums = np.zeros(min(max(n_stripes, 0), 4096), np.uint32)
                cases.append((w, n_stripes, bps, noise, sums))
    return cases


def _plain_fate(w, n_stripes, bps, raw, sums):
    """(status, entries or None) of the plain parse, in the library's
    status codes."""
    n = n_stripes * bps
    if not (1 <= w <= 16 and n_stripes >= 1 and bps >= 1
            and (n * w + 7) // 8 <= len(raw) and n_stripes <= sums.size):
        return 3, None
    try:
        vals = cont._unpack_index(raw, 0, n, w)
    except ValueError:
        return 1, None
    try:
        cont._check_stripe_sums(vals, sums, n_stripes)
    except ValueError:
        return 2, vals
    return 0, vals


def test_index_unpack_meets_the_plain_parse_on_hostile_input():
    seen = set()
    for k, (w, n_stripes, bps, raw, sums) in enumerate(_index_cases()):
        want, vals = _plain_fate(w, n_stripes, bps, raw, sums)
        got, rc = native.unpack_index(np.frombuffer(raw, np.uint8),
                                      n_stripes, bps, w, sums)
        assert rc == want, (k, w, n_stripes, bps, len(raw))
        if vals is not None:
            assert got.dtype == np.uint16 and np.array_equal(got, vals), k
        seen.add(rc)
    assert seen == {0, 1, 2, 3}


def test_index_unpack_under_sanitizers(tmp_path):
    """Every case of the test above through tests/index_fuzz_harness.cpp
    under ASan and UBSan: no report, and the in-process status and sum."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++")
    exe = tmp_path / "index_fuzz_asan"
    r = subprocess.run(
        [cxx, "-O1", "-g", "-std=c++17", "-pthread",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-fno-omit-frame-pointer", "-Wall", "-o", str(exe),
         str(REPO / "tests" / "index_fuzz_harness.cpp"),
         str(REPO / "dct_tpu_torch" / "csrc" / "host" / "bitpack.cpp")],
        capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "sanitize" in r.stderr:
        pytest.skip(f"the sanitizer runtime is missing: {r.stderr[-300:]}")
    assert r.returncode == 0, r.stderr[-3000:]
    cases = _index_cases()
    path = tmp_path / "cases.bin"
    with open(path, "wb") as f:
        for w, n_stripes, bps, raw, sums in cases:
            f.write(struct.pack("<iiiQI", w, n_stripes, bps, len(raw),
                                sums.size))
            f.write(np.asarray(sums, "<u4").tobytes() + raw)
    r = subprocess.run([str(exe), str(path)], capture_output=True, text=True,
                       timeout=120, env={"ASAN_OPTIONS": "detect_leaks=0",
                                         "UBSAN_OPTIONS": "print_stacktrace=1"})
    assert r.returncode == 0 and "runtime error" not in r.stderr, (
        r.stderr[-3000:])
    lines = r.stdout.splitlines()
    assert len(lines) == len(cases)
    for k, ((w, n_stripes, bps, raw, sums), line) in enumerate(
            zip(cases, lines)):
        out, rc = native.unpack_index(np.frombuffer(raw, np.uint8),
                                      n_stripes, bps, w, sums)
        want = f"rc={rc}"
        if rc <= 2:
            want += f" sum={int(out.astype(np.int64).sum())}"
        assert line == want, (k, line, want)


# ---------------------------------------------------------------------------
# The encoder's payload pass (dctbits_pack_payload)
# ---------------------------------------------------------------------------

def test_abi_handshake_binds_version_4_only(monkeypatch):
    """The library reports ABI 4 (the payload pass); one of version 3,
    built before it, does not bind, and the port falls back to Python."""
    assert native._ABI_VERSION == 4
    assert native._load().dctbits_abi_version() == 4

    class _Version:
        restype = None

        def __init__(self, v):
            self.v = v

        def __call__(self):
            return self.v

    class _Library:
        def __init__(self, v):
            self.dctbits_abi_version = _Version(v)

    with pytest.raises(OSError, match="ABI 3 != expected 4"):
        native._bind(_Library(3))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native.ctypes, "CDLL", lambda *a, **k: _Library(3))
    assert not native.available()
    monkeypatch.undo()
    assert native.available()


def _formula(units, bits) -> list[list[bytes]]:
    """Each plane's stripes by the per-stripe formula the pass replaced:
    big-endian 16-bit units cut to ceil(bits / 8) bytes."""
    bits = np.asarray(bits)
    units = np.asarray(units).astype(np.uint16).reshape(
        -1, bits.shape[-1], np.shape(units)[-1])
    return [[u.astype(">u2").tobytes()[:(int(b) + 7) // 8]
             for u, b in zip(us, bb)]
            for us, bb in zip(units, bits.reshape(-1, bits.shape[-1]))]


def _unit_cases() -> list[tuple]:
    """(name, units, bits) of planes ((S, U), (S,)) and chunks ((F, S, U),
    (F, S)): odd byte counts, zero-bit stripes and stripes at exactly
    16 * U bits; int16 units with the high bit set; the plain packer's
    int32 units."""
    rng = np.random.default_rng(22)
    cases = []
    for lead, s, u in (((), 1, 1), ((), 1, 5), ((), 7, 3), ((3,), 5, 16),
                       ((3,), 9, 64)):
        bits = rng.integers(0, 16 * u + 1, lead + (s,))
        flat = bits.reshape(-1)
        flat[-1] = 0
        flat[0] = 16 * u
        # odd byte counts
        flat[1::3] = np.minimum(flat[1::3] // 16 * 16 + 1, 16 * u - 15)
        units = rng.integers(0, 1 << 16, lead + (s, u)).astype(np.uint16)
        cases.append((f"uint16{lead}x{s}x{u}", units, bits))
        cases.append((f"int16{lead}x{s}x{u}",
                      units.view(np.int16), bits.astype(np.int32)))
    cv = torch.from_numpy(rng.integers(0, 1 << 16, (6, 40, 3))).int()
    cl = torch.from_numpy(rng.integers(0, 17, (6, 40, 3))).int()
    packed = bs.pack_chunks(cv, cl, 128)
    assert packed.units.dtype == torch.int32
    cases.append(("int32_plain_packer", packed.units.reshape(3, 2, -1),
                  packed.bit_lengths.reshape(3, 2)))
    return cases


@pytest.mark.parametrize("path", ("native", "python"))
def test_payload_pass_equals_the_per_stripe_formula(path, monkeypatch):
    """bs.plane_payloads, by the native pass and by its Python version,
    writes every plane's stripes as the per-stripe formula does, byte for
    byte, and counts one plane each under the path that ran."""
    if path == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    other = "python" if path == "native" else "native"
    for name, units, bits in _unit_cases():
        want = _formula(units, bits)
        before = dict(bs.PAYLOAD_PACKS)
        got = bs.plane_payloads(bs.PackedStripes(units, bits))
        assert [list(p) for p in got] == want, name
        assert bs.PAYLOAD_PACKS[path] - before[path] == len(want), name
        assert bs.PAYLOAD_PACKS[other] == before[other], name
        if np.ndim(bits) == 1:
            assert bs.stripes_to_bytes(bs.PackedStripes(units, bits)) == (
                want[0]), name


@pytest.mark.parametrize("path", ("native", "python"))
def test_payload_pass_refuses_lengths_out_of_range(path, monkeypatch):
    if path == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    units = np.zeros((2, 4), np.uint16)
    for bits in ([-1, 8], [8, 16 * 4 + 1]):
        with pytest.raises(ValueError, match="outside"):
            bs.plane_payloads(bs.PackedStripes(units, np.array(bits)))


def test_payload_pass_under_sanitizers(tmp_path):
    """The cases above and hostile counts through
    tests/payload_fuzz_harness.cpp under ASan and UBSan, every buffer at
    exactly its declared size: no report, the formula's bytes and offsets
    where the call succeeds, nothing written where it refuses."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++")
    exe = tmp_path / "payload_fuzz_asan"
    r = subprocess.run(
        [cxx, "-O1", "-g", "-std=c++17", "-pthread",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-fno-omit-frame-pointer", "-Wall", "-o", str(exe),
         str(REPO / "tests" / "payload_fuzz_harness.cpp"),
         str(REPO / "dct_tpu_torch" / "csrc" / "host" / "bitpack.cpp")],
        capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "sanitize" in r.stderr:
        pytest.skip(f"the sanitizer runtime is missing: {r.stderr[-300:]}")
    assert r.returncode == 0, r.stderr[-3000:]
    cases = []  # (n, U, out_cap, bits, units, expected line)
    for _, units, bits in _unit_cases():
        units = np.asarray(units).astype(np.uint16)
        units = units.reshape(-1, units.shape[-1])
        bits = np.asarray(bits, np.int64).reshape(-1)
        want = b"".join(s for p in _formula(units, bits) for s in p)
        offs = np.concatenate([[0], np.cumsum((bits + 7) // 8)])
        ok = (f"rc=0 out={want.hex()} offsets="
              + ",".join(str(int(o)) for o in offs))
        cases.append((bits.size, units.shape[1], len(want), bits, units, ok))
        if want:
            cases.append((bits.size, units.shape[1], len(want) - 1, bits,
                          units, "rc=2 untouched"))
        for k, v in ((0, -1), (-1, 16 * units.shape[1] + 1)):
            bad = bits.copy()
            bad[k] = v
            cases.append((bits.size, units.shape[1], len(want), bad, units,
                          "rc=1 untouched"))
    none = np.zeros(0, np.int64)
    for n, u in ((-1, 4), (0, -1), (0, 2**62), (2**40, 2**62)):
        cases.append((n, u, 0, none, np.zeros((0, 0), np.uint16),
                      "rc=3 untouched"))
    cases.append((0, 4, 0, none, np.zeros((0, 4), np.uint16),
                  "rc=0 out= offsets=0"))
    path = tmp_path / "cases.bin"
    with open(path, "wb") as f:
        for n, u, cap, bits, units, _ in cases:
            f.write(struct.pack("<qqQQQ", n, u, cap, np.size(bits),
                                np.size(units)))
            f.write(np.asarray(bits, "<i8").tobytes()
                    + np.asarray(units, "<u2").tobytes())
    r = subprocess.run([str(exe), str(path)], capture_output=True, text=True,
                       timeout=120, env={"ASAN_OPTIONS": "detect_leaks=0",
                                         "UBSAN_OPTIONS": "print_stacktrace=1"})
    assert r.returncode == 0 and "runtime error" not in r.stderr, (
        r.stderr[-3000:])
    lines = r.stdout.splitlines()
    assert len(lines) == len(cases)
    for k, (case, line) in enumerate(zip(cases, lines)):
        assert line == case[-1], (k, line, case[-1])
