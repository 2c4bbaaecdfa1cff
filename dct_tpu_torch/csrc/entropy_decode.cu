// Kernel D: the device entropy decode of indexed (version 2) containers.
//
// Replaces dct_tpu/ops/entropy_decode_pallas.py `_decode_kernel` (:124,
// launched by `decode_call` at :535). With the container's per-block decode
// index every block is an independent substream, so the unit of
// parallelism is the block: one lane decodes one block, and a warp takes 32
// consecutive blocks (a tile), which are 32 consecutive rows of the
// (n_blocks, n2) int16 output. int16 is the host decoder's type and kernel
// C's input, so D's output feeds C as it is.
//
// Per symbol, as the reference's lanes do (ops/entropy_decode.py has the
// plain version): a canonical value code of at most 16 bits, the mode's
// payload (category: `cat` extra bits with the JPEG sign rule; direct: the
// alphabet value, or after ESC a raw sign-extended 16-bit value; none: a
// raw 16-bit value), the run field (fixed `run_bits` wide, or a second
// canonical code when run_bits == 0), then the RLE expand `pos += run;
// write if pos < n2; ++pos`, until pos >= n2 or the cursor reaches the
// block's end. Bits are MSB-first.
//
// The design, against what bounded the first port (one thread a block,
// 4.6 % of the byte bound at the batch):
// - Block starts. The kernel takes each stripe's first bit (host-built
//   from the stripe byte lengths) and the (n_stripes, bps) block bits, and
//   scans them itself: a segmented warp scan over the tile's 32 blocks,
//   plus the sum of the stripe's blocks before the tile, read with 16-byte
//   loads (at most bps - 1 entries). Tiles may straddle stripes; any bps
//   works. No torch pass and no int64 start array precede the launch.
// - Word-wide bit reads. Each lane keeps a 64-bit MSB-first buffer and
//   refills it with one aligned 32-bit load (byte-swapped) whenever 32 or
//   fewer bits remain: at most two loads a symbol (value part <= 32 bits,
//   run <= 16), against one load a byte before. A word that reaches past
//   `payload_bytes` is read byte by byte, so bytes at or past it read as
//   zero and no load leaves the payload; the payload must be 16-byte
//   aligned (the wrapper checks it).
// - Table-driven Huffman decode. Each CTA builds two 2^kLutBits-entry
//   lookahead tables in shared memory, for values and coded runs. An
//   entry indexed by the next kLutBits bits holds the code length and the
//   decoded symbol (the category, the direct value or ESC, the run), or
//   kLong where no code of at most kLutBits bits matches; only then is
//   first/limit searched from kLutBits + 1 (canon_decode's order, so a
//   window that matches no code still gives length 0 and index 0). The
//   grid is persistent (as many CTAs as fit), so the tables are built once
//   a CTA, not once a tile; the direct value table stays in device memory,
//   read only for codes longer than kLutBits (the tables hold the values
//   of the shorter ones).
// - Staged, coalesced output. A warp zeroes its tile in shared memory (32
//   rows of n2 int16, padded by one word so that lanes storing the same
//   position hit different banks) with 16-byte stores, scatters only the
//   decoded symbols into it, then writes the tile's 64 n2 contiguous bytes
//   with 16-byte stores. Rows past n_blocks are not written.
//
// What bounds it on an H100: memory, in principle. At the 8 x 1088x1920
// batch (static q90) it must read ~8 MB of payload, 0.5 MB of index and
// the stripe starts, and write 33.4 MB of coefficients: ~13 us at
// 3.35 TB/s. What remains is the serial decode: a lane's symbols are a
// dependent chain (table load, shifts, refill), and the tile waits for its
// longest block. A single 1080p frame (32,400 blocks, ~1,000 warps, under
// 8 an SM) stays latency-bound whatever the stores do: there the number of
// dependent steps a symbol takes is what counts, which the tables cut.
//
// Blocks that contradict their index (the optional status output). D
// rejects nothing: it decodes each block for at most its indexed length.
// The host decoder (csrc/host/bitpack.cpp), which the reference package
// runs by default, walks a stripe from its first bit, block after block,
// and fails with error 2 (a value or run code that matches nothing) or 3
// (the walk ran past the stripe's bytes). A damaged stream can therefore
// decode to pixels here and fail there, or decode to other pixels. So
// each lane also says whether its block agrees with the index:
//   (a) its loop ended because pos >= n2, not because its bits ran out;
//   (b) it consumed exactly block_bits[b] bits (a 0-bit block never does;
//       a valid block holds at least one symbol of at least one bit);
//   (c) no value or run code went unmatched (canon_decode's length 0).
// One __ballot_sync a warp, and one atomicOr a stripe from its first
// disagreeing lane, set status[s] = 1. The caller hands in the status
// zeroed: the decode path uploads its zeros with the other operands, so
// no memset precedes the launch.
// Why a stripe whose blocks all agree decodes on the host to the same
// coefficients and no error. By induction over its blocks: the host's
// block 0 starts at the stripe's first bit, as D's does. If the host's
// block b starts where D's does, it reads the same bits with the same
// rules: the tables are canonical codes of at most 16 bits that the
// container's Kraft check made prefix-free, so the shortest matching
// length that canon_decode takes is the one code the host's LUT or walk
// finds, and it depends only on the bits it consumes; by (c) every code
// matched, so the host raises no error 2 (category symbols are 0..15,
// run symbols 0..64 and direct values inside int16 by tables_supported,
// so its other error-2 checks cannot fire either); the extra bits, the
// raw values and the fixed run field are read alike, and the expand is
// the same `pos += run; write if pos < n2; ++pos`. By (a) both stop this
// block at the same symbol, and by (b) block b + 1 starts, on both sides,
// block_bits[b] bits later. Every bit consumed lies inside its block's
// indexed range, so the bits past the stripe (the next stripe's bytes
// here, zeros on the host) are never consumed. The blocks together
// consume sum(block_bits) = stripe_bits bits, which container.deserialize
// checks and which fit the stripe's ceil(stripe_bits / 8) bytes, so the
// host's overrun check (error 3) cannot fire. A flagged stripe proves
// nothing either way: the codec then decodes the plane on the host
// (models/codec.py), whose coefficients or ValueError are the result.

#include "bindings.h"

namespace {

// Offsets of the packed table vector (TABLE_FIELDS in
// dct_tpu_torch/ops/entropy_decode.py); the direct value table follows.
constexpr int kVFirst = 0, kVLimit = 17, kVBase = 34;
constexpr int kRFirst = 51, kRLimit = 68, kRBase = 85;
constexpr int kCSym = 102, kRSym = 118, kFixed = 183;
constexpr int kFixedPad = 184;  // the fixed tables in shared memory, 16 B
constexpr int kRunAlphabet = 65;
constexpr int kEsc = 1 << 20;  // ESC slot of the direct value table
constexpr int kLutBits = 10;
constexpr int kLut = 1 << kLutBits;
constexpr int kLong = 31;  // entry length: no code of <= kLutBits bits
constexpr unsigned kFull = 0xFFFFFFFFu;
enum { kCategory = 0, kDirect = 1, kNone = 2 };

// CTA shape and shared memory for n2 coefficients a block.
template <int N2>
struct Shape {
  static constexpr int kWarps = N2 == 256 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRow = N2 + 2;            // int16 a staged row
  static constexpr int kTile = 32 * kRow;        // int16 a warp's tile
  static constexpr int kTableBytes = 4 * (2 * kLut + kFixedPad);
  static constexpr int kBytes = kTableBytes + 2 * kTile * kWarps;
  static_assert((2 * kTile) % 16 == 0 && kTableBytes % 16 == 0, "16 B");
};

// MSB-first reader: `n` valid bits at the top of `buf`, zeros below.
struct BitReader {
  const uint32_t* words;  // the payload, 16-byte aligned
  long long n_bytes;
  long long next;  // next payload word to load
  uint64_t buf;
  int n;

  // Payload bytes 4w..4w+3 as an MSB-first word, zero at or past n_bytes.
  __device__ __forceinline__ uint32_t load(long long w) const {
    const long long first = 4 * w;
    if (first + 4 <= n_bytes) return __byte_perm(__ldg(words + w), 0, 0x0123);
    uint32_t v = 0;
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(words);
    for (int k = 0; k < 4; ++k)
      v = (v << 8) | (first + k < n_bytes ? __ldg(bytes + first + k) : 0u);
    return v;
  }
  __device__ void init(const void* d, long long nb, long long bit) {
    words = static_cast<const uint32_t*>(d);
    n_bytes = nb;
    next = bit >> 5;
    buf = static_cast<uint64_t>(load(next++)) << 32;
    n = 32;
    skip(static_cast<int>(bit & 31));
  }
  // at least 33 valid bits afterwards
  __device__ __forceinline__ void refill() {
    if (n <= 32) {
      buf |= static_cast<uint64_t>(load(next++)) << (32 - n);
      n += 32;
    }
  }
  // the next k bits, 1 <= k <= 32
  __device__ __forceinline__ uint32_t peek(int k) const {
    return static_cast<uint32_t>(buf >> (64 - k));
  }
  __device__ __forceinline__ void skip(int k) {
    buf <<= k;
    n -= k;
  }
};

// Canonical decode of the 16-bit window t16 over code lengths lo..16: the
// canonical index, and the code length in *len (0, with index 0, where no
// code matches).
__device__ __forceinline__ int canon_decode(uint32_t t16, int lo,
                                            const int* first, const int* limit,
                                            const int* base, int* len) {
  for (int L = lo; L <= 16; ++L) {
    const int c = static_cast<int>(t16 >> (16 - L));
    if (c >= first[L] && c < limit[L]) {
      *len = L;
      return base[L] + c - first[L];
    }
  }
  *len = 0;
  return 0;
}

// The symbol a canonical index stands for: the category (value table,
// category mode), the direct value or ESC (direct mode), the run (run
// table); exactly the plain version's lookups, 0 outside the tables.
__device__ __forceinline__ int resolve(int idx, int len, int table, int mode,
                                       const int* s_tab, const int* vtab,
                                       int n_vtab) {
  if (table == 1) return idx < kRunAlphabet ? s_tab[kRSym + idx] : 0;
  if (mode == kCategory) return (len > 0 && idx < 16) ? s_tab[kCSym + idx] : 0;
  return idx < n_vtab ? __ldg(vtab + idx) : 0;
}

// Entry of a lookahead table: (symbol << 5) | code length, or kLong.
__device__ void build_lut(int* lut, int table, int mode, const int* s_tab,
                          const int* vtab, int n_vtab) {
  const int* first = s_tab + (table ? kRFirst : kVFirst);
  const int* limit = s_tab + (table ? kRLimit : kVLimit);
  const int* base = s_tab + (table ? kRBase : kVBase);
  for (int p = threadIdx.x; p < kLut; p += blockDim.x) {
    int e = kLong;
    for (int L = 1; L <= kLutBits; ++L) {
      const int c = p >> (kLutBits - L);
      if (c >= first[L] && c < limit[L]) {
        const int idx = base[L] + c - first[L];
        e = (resolve(idx, L, table, mode, s_tab, vtab, n_vtab) << 5) | L;
        break;
      }
    }
    lut[p] = e;
  }
}

// Lookahead decode of the next code: the symbol, and its length in *len.
// A code that matches nothing (length 0) can only come from the search
// past the tables, which sets *unmatched there: the hot path pays nothing.
__device__ __forceinline__ int table_decode(const BitReader& r, const int* lut,
                                            int table, int mode,
                                            const int* s_tab, const int* vtab,
                                            int n_vtab, int* len,
                                            bool* unmatched) {
  const int e = lut[r.peek(kLutBits)];
  if ((e & 31) != kLong) {
    *len = e & 31;
    return e >> 5;
  }
  const int* t = s_tab + (table ? kRFirst : kVFirst);
  const int idx = canon_decode(r.peek(16), kLutBits + 1, t, t + 17, t + 34,
                               len);
  *unmatched |= *len == 0;
  return resolve(idx, *len, table, mode, s_tab, vtab, n_vtab);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ int u16_sum(uint32_t w) {
  return static_cast<int>((w & 0xFFFFu) + (w >> 16));
}

// Sum of the u16 entries bb[a, e) over the warp (every lane gets it):
// 16-byte loads where the addresses allow, single entries at the ends.
__device__ long long range_sum(const uint16_t* bb, long long a, long long e,
                               int lane) {
  const long long mis =
      (reinterpret_cast<uintptr_t>(bb + a) & 15) >> 1;  // entries past 16 B
  long long k16 = a + ((8 - mis) & 7);
  if (k16 > e) k16 = e;
  long long part = lane < k16 - a ? __ldg(bb + a + lane) : 0;
  const long long n_vec = (e - k16) >> 3;
  const uint4* v = reinterpret_cast<const uint4*>(bb + k16);
  for (long long i = lane; i < n_vec; i += 32) {
    const uint4 q = __ldg(v + i);
    part += u16_sum(q.x) + u16_sum(q.y) + u16_sum(q.z) + u16_sum(q.w);
  }
  const long long tail = k16 + 8 * n_vec;
  if (lane < e - tail) part += __ldg(bb + tail + lane);
  return warp_sum(part);
}

template <int N2>
__global__ void __launch_bounds__(Shape<N2>::kThreads)
    entropy_decode_kernel(const void* __restrict__ payload,
                          long long payload_bytes,
                          const long long* __restrict__ stripe_start,
                          const uint16_t* __restrict__ block_bits, int bps,
                          const int* __restrict__ tabs, int n_vtab,
                          int16_t* __restrict__ out, long long n_blocks,
                          int mode, int run_bits, int* __restrict__ status) {
  using S = Shape<N2>;
  extern __shared__ __align__(16) int smem[];
  int* s_vlut = smem;
  int* s_rlut = smem + kLut;
  int* s_tab = smem + 2 * kLut;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int16_t* tile = reinterpret_cast<int16_t*>(smem + 2 * kLut + kFixedPad) +
                  warp * S::kTile;
  const int* vtab = tabs + kFixed;

  for (int i = threadIdx.x; i < kFixed; i += blockDim.x) s_tab[i] = tabs[i];
  __syncthreads();
  if (mode != kNone) build_lut(s_vlut, 0, mode, s_tab, vtab, n_vtab);
  if (run_bits == 0) build_lut(s_rlut, 1, mode, s_tab, vtab, n_vtab);
  __syncthreads();

  const long long n_tiles = (n_blocks + 31) >> 5;
  for (long long t = static_cast<long long>(blockIdx.x) * S::kWarps + warp;
       t < n_tiles; t += static_cast<long long>(gridDim.x) * S::kWarps) {
    const long long b0 = t << 5;
    const int rows = static_cast<int>(min(32LL, n_blocks - b0));
    uint4* tile4 = reinterpret_cast<uint4*>(tile);
    for (int i = lane; i < S::kTile / 8; i += 32)
      tile4[i] = make_uint4(0, 0, 0, 0);

    // this lane's block: stripe s, index j in it, first bit `cur`
    const long long b = b0 + lane;
    const bool live = lane < rows;
    const long long s = (live ? b : b0) / bps;
    const int j = static_cast<int>((live ? b : b0) - s * bps);
    const long long bits = live ? block_bits[b] : 0;
    long long incl = bits;  // segmented inclusive scan within the stripe
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(kFull, incl, d);
      if (d <= j && d <= lane) incl += u;
    }
    const int j0 = __shfl_sync(kFull, j, 0);  // blocks of lane 0's stripe
    long long before = 0;                     // before this tile
    if (j0 > 0) before = range_sum(block_bits, b0 - j0, b0, lane);
    long long cur = __ldg(stripe_start + s) + incl - bits +
                    (j > lane ? before : 0);
    __syncwarp();

    bool bad = live;  // (a)-(c) above, until the block's decode shows them
    if (live && bits > 0) {
      int16_t* row = tile + lane * S::kRow;
      const long long end = cur + bits;
      BitReader r;
      r.init(payload, payload_bytes, cur);
      int pos = 0;
      bool unmatched = false;
      while (pos < N2 && cur < end) {
        r.refill();
        int v, gv, ln;
        if (mode == kCategory) {
          const int cat = table_decode(r, s_vlut, 0, mode, s_tab, vtab,
                                       n_vtab, &ln, &unmatched);
          r.skip(ln);
          v = 0;
          if (cat > 0) {
            const int e = static_cast<int>(r.peek(cat));
            r.skip(cat);
            v = e < (1 << (cat - 1)) ? e - (1 << cat) + 1 : e;
          }
          gv = ln + cat;
        } else if (mode == kDirect) {
          v = table_decode(r, s_vlut, 0, mode, s_tab, vtab, n_vtab, &ln,
                           &unmatched);
          r.skip(ln);
          gv = ln;
          if (v == kEsc) {
            v = static_cast<int16_t>(r.peek(16));
            r.skip(16);
            gv += 16;
          }
        } else {
          v = static_cast<int16_t>(r.peek(16));
          r.skip(16);
          gv = 16;
        }
        r.refill();
        int run, lc;
        if (run_bits == 0) {  // coded runs
          run = table_decode(r, s_rlut, 1, mode, s_tab, vtab, n_vtab, &lc,
                             &unmatched);
        } else {
          run = static_cast<int>(r.peek(run_bits));
          lc = run_bits;
        }
        r.skip(lc);
        cur += gv + lc;
        const int wpos = pos + run;
        if (wpos < N2) {
          row[wpos] = static_cast<int16_t>(v);
          pos = wpos + 1;
        } else {
          pos = wpos;
        }
      }
      bad = !(pos >= N2 && cur == end && !unmatched);
    }
    if (status != nullptr) {
      const unsigned m = __ballot_sync(kFull, bad);
      // lanes of this lane's stripe below it: lane - j .. lane - 1
      const int lo = lane - min(j, lane);
      const unsigned below = ((1u << lane) - 1u) & ~((1u << lo) - 1u);
      if (bad && !(m & below)) atomicOr(status + s, 1);
    }
    __syncwarp();

    // the tile's rows are rows b0.. of out: 64 N2 contiguous bytes
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(tile);
    if constexpr (N2 == 4) {  // 8 bytes a row: one row a lane
      if (live) {
        const uint32_t* w = tw + lane * (S::kRow / 2);
        reinterpret_cast<uint2*>(out)[b] = make_uint2(w[0], w[1]);
      }
    } else {
      constexpr int kChunks = N2 / 8;  // 16-byte chunks a row
      uint4* o = reinterpret_cast<uint4*>(out + b0 * N2);
      for (int c = lane; c < rows * kChunks; c += 32) {
        const uint32_t* w =
            tw + (c / kChunks) * (S::kRow / 2) + (c % kChunks) * 4;
        o[c] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncwarp();
  }
}

template <int N2>
int launch(const void* payload, long long payload_bytes,
           const void* stripe_start, const void* block_bits, int bps,
           const void* tabs, int n_vtab, void* out, long long n_blocks,
           int mode, int run_bits, void* status, cudaStream_t stream) {
  using S = Shape<N2>;
  auto kernel = entropy_decode_kernel<N2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many CTAs as fit on every SM, no more than tiles need
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S::kThreads,
                                                S::kBytes);
  const long long need = ((n_blocks + 31) / 32 + S::kWarps - 1) / S::kWarps;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<unsigned>(need < fit ? need : fit), S::kThreads,
           S::kBytes, stream>>>(
      payload, payload_bytes, static_cast<const long long*>(stripe_start),
      static_cast<const uint16_t*>(block_bits), bps,
      static_cast<const int*>(tabs), n_vtab, static_cast<int16_t*>(out),
      n_blocks, mode, run_bits, static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DCT_EXPORT int dct_entropy_decode(const void* payload, long long payload_bytes,
                                  const void* stripe_start,
                                  const void* block_bits, int bps,
                                  const void* tabs, int n_vtab, void* out,
                                  long long n_blocks, int n2, int mode,
                                  int run_bits, void* status, void* stream) {
  if (mode < kCategory || mode > kNone || run_bits < 0 || run_bits > 16 ||
      bps <= 0 || n_vtab < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
#define DCT_D(N)                                                        \
  return launch<N>(payload, payload_bytes, stripe_start, block_bits, bps, \
                   tabs, n_vtab, out, n_blocks, mode, run_bits, status, s)
  switch (n2) {
    case 4: DCT_D(4);
    case 16: DCT_D(16);
    case 64: DCT_D(64);
    case 256: DCT_D(256);
  }
#undef DCT_D
  return static_cast<int>(cudaErrorInvalidValue);
}

DCT_EXPORT const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
