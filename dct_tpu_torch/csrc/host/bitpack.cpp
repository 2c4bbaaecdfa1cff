// bitpack.cpp — the host entropy decoder of dct_tpu_torch (a copy of the
// reference package's native/bitpack.cpp, cut to the stripe decoder and
// the integrity scan the port calls), the parse of a container's packed
// decode index, and the encoder's payload writer (packed stripe units to
// the stripes' bytes).
//
// Canonical-Huffman DECODE of stripe substreams, serial within a stripe and
// parallel across stripes on a thread pool, the integrity scan of stripes
// against their recorded bit lengths, and the unpack of the packed w-bit
// per-block index with its validation. Built with the host compiler
// on first use and bound with ctypes by dct_tpu_torch/native.py. The wire
// format is documented in dct_tpu_torch/ops/bitstream.py and
// dct_tpu_torch/container.py; the result must equal the Python decoder
// (bitstream.unpack_stripe_host) and kernel D (csrc/entropy_decode.cu).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kRunBits = 8;

// Fixed run-field width for n2-coefficient blocks: 8 bits covers runs up
// to n2 for N <= 15; 16x16 blocks (run 256 on the all-zero terminal) need
// bit_length(n2). Mirrors ops/bitstream.run_field_bits.
inline int run_field_bits(int n2) {
  int b = 0;
  while ((1 << b) <= n2) ++b;
  return b < kRunBits ? kRunBits : b;
}

enum Mode { kCategory = 0, kDirect = 1, kNone = 2 };

// ---- canonical table ------------------------------------------------------

struct CanonicalTable {
  // Decode via a W-bit prefix LUT (one lookup for codes of length <= W),
  // falling back to the standard first-code-per-length walk for longer
  // codes. W = min(max_len, 16); both table modes cap code lengths at 16
  // (JPEG adjust-bits), so the walk is a cold path for foreign tables only.
  static constexpr int kLutBits = 16;
  int max_len = 0;
  int lut_bits = 0;
  uint32_t first_code[33] = {0};   // first canonical code of each length
  int first_index[33] = {0};       // index into sorted_symbols
  int count_by_len[33] = {0};
  std::vector<int> sorted_symbols; // symbols ordered by (length, symbol)
  struct Entry { uint16_t sym; uint8_t len; };  // len 0 = LUT miss
  std::vector<Entry> lut;

  void build(const uint8_t* lengths, int n) {
    for (int l = 1; l <= 32; ++l) count_by_len[l] = 0;
    sorted_symbols.clear();
    for (int s = 0; s < n; ++s)  // >32 = corrupt container field: unusable
      if (lengths[s] > 0 && lengths[s] <= 32) count_by_len[lengths[s]]++;
    max_len = 0;
    for (int l = 32; l >= 1; --l)
      if (count_by_len[l]) { max_len = l; break; }
    // first codes (canonical: codes assigned in (length, symbol) order).
    // A corrupt table can OVER-subscribe the Kraft sum — canonical codes
    // would then spill past 2^l and the LUT fill below would write out of
    // bounds. Validate while
    // assigning; an invalid table degrades to the empty table, so every
    // decode_symbol returns -1 and the stripe fails cleanly with err=2.
    uint64_t code = 0;
    int index = 0;
    for (int l = 1; l <= max_len; ++l) {
      if (code + (uint64_t)count_by_len[l] > (1ull << l)) {
        max_len = 0;
        lut_bits = 0;
        lut.clear();
        return;
      }
      first_code[l] = (uint32_t)code;
      first_index[l] = index;
      code = (code + (uint64_t)count_by_len[l]) << 1;
      index += count_by_len[l];
    }
    sorted_symbols.resize(index);
    int spos = 0;
    for (int l = 1; l <= max_len; ++l)
      for (int s = 0; s < n; ++s)
        if (lengths[s] == l) sorted_symbols[spos++] = s;

    lut_bits = max_len < kLutBits ? max_len : kLutBits;
    lut.assign((size_t)1 << lut_bits, Entry{0, 0});
    spos = 0;
    for (int l = 1; l <= lut_bits; ++l) {
      for (int i = 0; i < count_by_len[l]; ++i, ++spos) {
        uint32_t c = first_code[l] + (uint32_t)i;
        uint32_t lo = c << (lut_bits - l);
        uint32_t hi = (c + 1) << (lut_bits - l);
        for (uint32_t idx = lo; idx < hi; ++idx)
          lut[idx] = Entry{(uint16_t)sorted_symbols[spos], (uint8_t)l};
      }
    }
  }
};

// ---- bit reader ------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  uint64_t nbytes;
  uint64_t pos = 0;  // bit position

  bool ok() const { return pos <= nbytes * 8; }

  // Next 64 bits MSB-first at the cursor, zero-padded past the end (the
  // stream's own bits can never validly read past it; the block loop plus
  // the final ok() check catch overruns exactly like bit-by-bit zero
  // padding did).
  inline uint64_t peek64() const {
    uint64_t byte = pos >> 3;
    uint64_t w = 0;
    if (byte + 8 <= nbytes) {
      memcpy(&w, data + byte, 8);
    } else if (byte < nbytes) {
      uint8_t tmp[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      memcpy(tmp, data + byte, nbytes - byte);
      memcpy(&w, tmp, 8);
    }
    w = __builtin_bswap64(w);
    return w << (pos & 7);
  }

  inline void consume(int n) { pos += n; }

  inline uint32_t read_bits(int n) {
    if (n == 0) return 0;
    uint32_t v = (uint32_t)(peek64() >> (64 - n));
    pos += n;
    return v;
  }

  inline int read_bit() { return (int)read_bits(1); }

  // Cold path: codes longer than the LUT width (foreign tables only).
  inline int decode_symbol_walk(const CanonicalTable& t) {
    uint32_t code = 0;
    for (int l = 1; l <= t.max_len; ++l) {
      code = (code << 1) | (uint32_t)read_bit();
      int c = t.count_by_len[l];
      if (c > 0 && code >= t.first_code[l] &&
          code < t.first_code[l] + (uint32_t)c) {
        return t.sorted_symbols[t.first_index[l] + (int)(code - t.first_code[l])];
      }
    }
    return -1;
  }

  // Hot path: one peek64 decodes code via LUT; caller reads trailing
  // fields from the SAME word (a symbol spans <= 40 bits total).
  inline int decode_symbol(const CanonicalTable& t, uint64_t w, int* len) {
    if (t.lut_bits) {
      CanonicalTable::Entry e = t.lut[(size_t)(w >> (64 - t.lut_bits))];
      if (e.len) {
        *len = e.len;
        return (int)e.sym;
      }
    }
    // miss: either invalid stream or code longer than lut_bits
    uint64_t start = pos;
    int sym = decode_symbol_walk(t);
    *len = (int)(pos - start);
    pos = start;
    return sym;
  }
};

inline int32_t value_from_category(int cat, uint32_t extra) {
  if (cat == 0) return 0;
  uint32_t half = 1u << (cat - 1);
  if (extra < half) return (int32_t)extra - (int32_t)((1u << cat) - 1);
  return (int32_t)extra;
}

void decode_one_stripe(const uint8_t* data, uint64_t nbytes, int bps, int n2,
                       int mode, const CanonicalTable* table, int vmin,
                       int n_alpha, const CanonicalTable* run_table,
                       int16_t* out, int* err,
                       uint64_t* consumed_bits = nullptr) {
  BitReader r{data, nbytes};
  // With the reference-convention fixed run field (8 bits; 9 for 16x16
  // blocks), one peek64 covers the whole symbol (code <=16b + payload
  // <=16b + run <=9b = 41 bits worst case, within the >= 57 usable peek
  // bits). With
  // a coded run (cfg.coded_runs), the run code is decoded from a second
  // peek after consuming the value part — still O(1) via its own LUT.
  const int rbits = run_field_bits(n2);
  auto read_run = [&](uint64_t w, int consumed) -> int {
    if (!run_table) {
      uint32_t run = (uint32_t)((w << consumed) >> (64 - rbits));
      r.consume(consumed + rbits);
      return (int)run;
    }
    r.consume(consumed);
    uint64_t w2 = r.peek64();
    int rl;
    int run = r.decode_symbol(*run_table, w2, &rl);
    if (run < 0) return -1;
    r.consume(rl);
    return run;
  };
  for (int b = 0; b < bps; ++b) {
    int16_t* blockp = out + (int64_t)b * n2;
    // The decoder only stores nonzero coefficients; zero the block here
    // (cache-warm with the stores that follow) so callers can hand in an
    // uninitialized buffer instead of paying a separate full-array fill
    // (a separate fill costs ~15% of the entropy-decode path).
    memset(blockp, 0, (size_t)n2 * sizeof(int16_t));
    int pos = 0;
    while (pos < n2) {
      int32_t v = 0;
      int run;
      uint64_t w = r.peek64();
      if (mode == kCategory) {
        int len;
        int cat = r.decode_symbol(*table, w, &len);
        // The wire's coefficient space is int16, so valid streams carry
        // categories <= 15 (the encoder's category computation saturates
        // there; the 16-entry table has no higher code). cat 16..31 is
        // only reachable with a foreign/corrupt table — values would not
        // fit the int16 output (and >31 would be shift UB), so reject
        // rather than silently truncate; the Python reference decoder
        // rejects identically.
        if (cat < 0 || cat > 15) { *err = 2; return; }
        uint32_t extra =
            cat ? (uint32_t)((w << len) >> (64 - cat)) : 0;
        run = read_run(w, len + cat);
        v = value_from_category(cat, extra);
      } else if (mode == kDirect) {
        int len;
        int sym = r.decode_symbol(*table, w, &len);
        if (sym < 0) { *err = 2; return; }
        if (sym == n_alpha) {  // ESC: raw 16-bit two's complement
          uint32_t raw = (uint32_t)((w << len) >> 48);
          v = (raw >= 0x8000u) ? (int32_t)raw - 0x10000 : (int32_t)raw;
          run = read_run(w, len + 16);
        } else {
          // int64: a hostile header can carry any i32 vmin, making the
          // int32 sum overflow (UB); and any value outside the wire's
          // int16 coefficient space must be rejected, not truncated by
          // the (int16_t) store — the Python reference decoder rejects
          // identically, keeping the decoders byte-identical on
          // rejection as well as success.
          int64_t v64 = (int64_t)sym + (int64_t)vmin;
          if (v64 < -32768 || v64 > 32767) { *err = 2; return; }
          v = (int32_t)v64;
          run = read_run(w, len);
        }
      } else {
        uint32_t raw = (uint32_t)(w >> 48);
        v = (raw >= 0x8000u) ? (int32_t)raw - 0x10000 : (int32_t)raw;
        run = read_run(w, 16);
      }
      if (run < 0) { *err = 2; return; }
      pos += run;
      if (pos < n2) blockp[pos++] = (int16_t)v;
    }
    if (!r.ok()) { *err = 3; return; }
  }
  if (consumed_bits) *consumed_bits = r.pos;
}

// Run work(lo, hi) over [0, n) on up to n_threads workers.
template <typename F>
void run_parallel(const F& work, int n, int n_threads) {
  if (n_threads <= 1 || n <= 1) {
    work(0, n);
    return;
  }
  int t = std::min(n_threads, n);
  std::vector<std::thread> pool;
  int per = (n + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    int lo = i * per, hi = std::min(n, lo + per);
    if (lo < hi) pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Binding handshake: dct_tpu_torch/native.py refuses a library whose ABI
// version differs from its own (v2: unpack writes int16 coefficients; v3:
// dctbits_unpack_index; v4: dctbits_pack_payload). Bump on ANY signature
// or contract change.
int dctbits_abi_version(void) { return 4; }

// Decode n_stripes independent substreams (offsets[i]..offsets[i+1] bytes
// each) of bps blocks into out[(stripe*bps + b)*n2 + k]. Returns 0 on
// success. Stripes run on up to n_threads worker threads.
// out is int16 — the wire values are 16-bit two's complement and the
// device decode kernels consume i16, so this halves the store traffic
// here AND the coefficient upload on the decode_to_device path. out may
// be uninitialized: each block is zeroed in the decode loop. On a nonzero
// return, out contents are unspecified past the failing block.
int dctbits_unpack_stripes(const uint8_t* blob, const uint64_t* offsets,
                           int n_stripes, int bps, int n2, int mode,
                           const uint8_t* table_lengths, int table_size,
                           const uint8_t* run_lengths, int run_table_size,
                           int vmin, int16_t* out, int n_threads) {
  CanonicalTable table;
  int n_alpha = table_size - 1;  // direct mode: last symbol is ESC
  if (mode != kNone) table.build(table_lengths, table_size);
  CanonicalTable run_table;  // run_table_size == 0: fixed 8-bit run field
  if (run_table_size > 0) run_table.build(run_lengths, run_table_size);
  const CanonicalTable* run_ptr = run_table_size > 0 ? &run_table : nullptr;

  std::vector<int> errs(n_stripes, 0);
  auto work = [&](int lo, int hi) {
    for (int s = lo; s < hi; ++s) {
      decode_one_stripe(blob + offsets[s], offsets[s + 1] - offsets[s], bps,
                        n2, mode, &table, vmin, n_alpha, run_ptr,
                        out + (int64_t)s * bps * n2, &errs[s]);
    }
  };
  run_parallel(work, n_stripes, n_threads);
  for (int s = 0; s < n_stripes; ++s)
    if (errs[s]) return errs[s];
  return 0;
}

// Integrity scan: decode each stripe into thread-local scratch and report a
// per-stripe status (0 ok; 2 bad symbol; 3 overrun; 4 consumed-bit count
// differs from the container's record). Mirrors models/recovery.py's
// Python scan: the container records each stripe's exact bit length, so
// byte damage almost surely desynchronizes the position-invariant decoder.
int dctbits_verify_stripes(const uint8_t* blob, const uint64_t* offsets,
                           int n_stripes, int bps, int n2, int mode,
                           const uint8_t* table_lengths, int table_size,
                           const uint8_t* run_lengths, int run_table_size,
                           int vmin, const uint32_t* expected_bits,
                           int32_t* status_out, int n_threads) {
  CanonicalTable table;
  int n_alpha = table_size - 1;
  if (mode != kNone) table.build(table_lengths, table_size);
  CanonicalTable run_table;
  if (run_table_size > 0) run_table.build(run_lengths, run_table_size);
  const CanonicalTable* run_ptr = run_table_size > 0 ? &run_table : nullptr;

  auto work = [&](int lo, int hi) {
    // decode_one_stripe zeroes each block itself, so the scratch needs no
    // per-stripe refill
    std::vector<int16_t> scratch((size_t)bps * n2);
    for (int s = lo; s < hi; ++s) {
      int err = 0;
      uint64_t consumed = 0;
      decode_one_stripe(blob + offsets[s], offsets[s + 1] - offsets[s], bps,
                        n2, mode, &table, vmin, n_alpha, run_ptr,
                        scratch.data(), &err, &consumed);
      if (!err && consumed != (uint64_t)expected_bits[s]) err = 4;
      status_out[s] = err;
    }
  };
  run_parallel(work, n_stripes, n_threads);
  return 0;
}

// Parse a container's packed decode index (container.py): n_stripes * bps
// MSB-first w-bit entries (1 <= w <= 16) from raw into out[n_stripes * bps],
// in one pass. Each stripe's entries must sum, in 64 bits, to its
// stripe_bits entry, and the pad bits after the last entry must be zero.
// Reads at most ceil(n * w / 8) bytes of raw, which must be <= nbytes.
// Returns 0 on success; 1 the pad bits are not zero; 2 a stripe's sum
// disagrees with stripe_bits (1 wins where both hold); 3 the arguments are
// out of range (w, n_stripes < 1, bps < 1, nbytes short), before anything
// is read or written. On 1 or 2 every entry has been written.
int dctbits_unpack_index(const uint8_t* raw, uint64_t nbytes, int n_stripes,
                         int bps, int w, const uint32_t* stripe_bits,
                         uint16_t* out) {
  if (w < 1 || w > 16 || n_stripes < 1 || bps < 1) return 3;
  const uint64_t n = (uint64_t)n_stripes * (uint64_t)bps;  // < 2^62
  if (n > (UINT64_MAX >> 4)) return 3;  // n * w must not wrap
  const uint64_t need = (n * w + 7) / 8;
  if (need > nbytes) return 3;
  const uint32_t mask = (1u << w) - 1;
  // entry i starts at bit i * w; a big-endian 32-bit window at its byte
  // holds it whole (bit offset <= 7, w <= 16). The first `fast` entries'
  // windows lie inside the index; later ones take the bytes that are
  // left, zero-filled.
  const uint64_t fast = need >= 4 ? ((need - 3) * 8 - 1) / w + 1 : 0;
  bool sums_ok = true;
  uint64_t i = 0, bit = 0;
  for (int s = 0; s < n_stripes; ++s) {
    uint64_t sum = 0;
    const uint64_t end = i + (uint64_t)bps;
    for (; i < end && i < fast; ++i, bit += w) {
      uint32_t win;
      memcpy(&win, raw + (bit >> 3), 4);
      win = __builtin_bswap32(win);
      uint32_t v = (win >> (32 - w - (bit & 7))) & mask;
      out[i] = (uint16_t)v;
      sum += v;
    }
    for (; i < end; ++i, bit += w) {
      uint32_t win = 0;
      for (uint64_t k = 0; k < 4; ++k) {
        uint64_t b = (bit >> 3) + k;
        win = (win << 8) | (b < need ? raw[b] : 0);
      }
      uint32_t v = (win >> (32 - w - (bit & 7))) & mask;
      out[i] = (uint16_t)v;
      sum += v;
    }
    sums_ok &= sum == (uint64_t)stripe_bits[s];
  }
  const int pad = (int)(need * 8 - n * w);  // 0..7
  if (pad && (raw[need - 1] & ((1u << pad) - 1))) return 1;
  return sums_ok ? 0 : 2;
}

// Serialize n packed stripes into one payload (ops/bitstream.py): stripe s
// is the first ceil(bits[s] / 8) bytes of its U 16-bit units
// (units[s * U ..]) written big-endian, the stripes back to back in out,
// and offsets[0..n] their n + 1 byte offsets. Returns 0 on success; 1 a
// bit length below 0 or above 16 * U; 2 the payload needs more than
// out_cap bytes; 3 n or U out of range (below 0, U above 2^58). Lengths
// and capacity are checked before anything is written: on a nonzero
// return neither out nor offsets is touched.
int dctbits_pack_payload(const uint16_t* units, int64_t U,
                         const int64_t* bits, int64_t n, uint8_t* out,
                         uint64_t out_cap, uint64_t* offsets) {
  if (n < 0 || U < 0 || U > (INT64_MAX >> 5)) return 3;
  for (int64_t s = 0; s < n; ++s)
    if (bits[s] < 0 || bits[s] > 16 * U) return 1;
  uint64_t total = 0;  // each stripe <= 2^59 bytes: checked as it grows
  for (int64_t s = 0; s < n; ++s) {
    total += ((uint64_t)bits[s] + 7) / 8;
    if (total > out_cap) return 2;
  }
  uint64_t off = 0;
  for (int64_t s = 0; s < n; ++s) {
    offsets[s] = off;
    const uint64_t nbytes = ((uint64_t)bits[s] + 7) / 8;
    const uint16_t* u = units + s * U;
    uint8_t* o = out + off;
    const uint64_t full = nbytes / 2;
    for (uint64_t k = 0; k < full; ++k) {
      o[2 * k] = (uint8_t)(u[k] >> 8);
      o[2 * k + 1] = (uint8_t)u[k];
    }
    if (nbytes & 1) o[nbytes - 1] = (uint8_t)(u[full] >> 8);
    off += nbytes;
  }
  offsets[n] = off;
  return 0;
}

}  // extern "C"
