// Kernel B: the fused stripe encode — u8 pixels (blocks, or the padded
// planes themselves) to packed bitstream units, a persistent grid of CTAs
// that walk the stripes tile by tile.
//
// Replaces dct_tpu/ops/fused_encode_pallas.py `_fused_kernel` (:218;
// wrapper `encode_stripes_fused` :699, pallas_call :825) at every config it
// takes: 4x4, 8x8 and 16x16 blocks (n2 16, 64, 256); the category, direct
// and "none" entropy modes; the fixed run field, or the coded one at n2 <=
// 64; adaptive quantization and DC prediction on or off; stripes of any
// width. It ports the outputs, not the TPU mechanism: the pack-tier ladder,
// the acc4 rungs, lane compaction, the one-hot direct-table gather and the
// MXU scatter were workarounds for a machine without per-lane gathers,
// scatters or cumsum.
//
// What bounds it on an H100. Bytes are few: n2 pixel bytes in per block and
// the worst-case unit buffer out (units_per_block_worst(n2, coded_runs)
// 16-bit units a block: 80 B at n2 16, 320 B at 64 (384 B with coded runs),
// 1312 B at 256), whose zeros past each stripe's payload are most of the
// bytes. Operations are few too. What bounds it is latency: each CTA walks
// its stripes through a chain of dependent phases (pixels, tensor-core
// products, the integer certificate, the rescue, then the entropy rounds),
// and a few CTAs an SM overlap those chains. Measured by variants with
// parts compiled out (PERF.md sections 6-7), the certified transform of
// transform_core.cuh and its pixel loads are a little under half of B's
// time; the rest is, in order, the serial symbol chains of the densest
// segments, the gather, the rounds' masks, scans and barriers, and the
// zero tail. Both halves scale with the warps an SM holds (80 registers a
// thread allow three CTAs at 8x8). A warp-specialised schedule (a
// transform warpgroup on the next tile beside entropy warps on this one,
// double-buffered) was built and measured slower at every config: split
// off, each half has fewer warps and they still share the SM (PERF.md
// section 6). So every warp runs both halves in turn, and the design
// keeps the entropy chain short and issues each symbol once:
//
// - A persistent grid of (SMs x CTAs an SM) CTAs of 256 threads; CTA c
//   takes stripes c, c + grid, ... (stripes are equal in size, so a counter
//   would balance nothing more; a CTA a stripe measured slower). A stripe
//   is walked in tiles of kTile blocks (256 at n2 16, 128 at 64, 64 at
//   256), so shared memory is a constant of n2 and a stripe may be any
//   width. The next tile's pixels (in this
//   stripe or the CTA's next one) are copied by cp.async into the pixel
//   buffer as soon as the rescue has read it, so their DRAM latency
//   overlaps this tile's entropy stage.
// - Pixels are read as (NB, n2) blocks or straight from the padded
//   plane(s) (..., Hp, Wp), with no blocking pass before the kernel:
//   block j of a stripe, pixel row r, lies at stripe * bps * n2 + (j / bw)
//   * s_brow + (j % bw) * s_blk + r * s_row (blocks: s_blk = n2, s_row =
//   n, bw = bps; the planes: s_blk = n, s_row = Wp, s_brow = n Wp, bw =
//   Wp / n). Blocks are copied 16 bytes a copy, the planes a block row (4,
//   8 or 16 bytes) a copy, a warp's lanes on one pixel row of neighbouring
//   blocks; either way the tile lands as the packed rows the tile
//   function reads.
// - Per tile: the certified transform of transform_core.cuh into int16
//   coefficient rows (16 bytes of padding a row, so lanes that read
//   neighbouring blocks hit distinct banks), the rescue list worked through
//   by the whole CTA.
// - The entropy stage runs in rounds of 256 segments, one a thread: a
//   segment is kL consecutive zigzag positions of one block (16 at n2 16
//   and 64, 32 at 256). Threads take the segments position-major (thread =
//   g * kE + b for segment g of block b), so a warp's 32 lanes hold the
//   same positions of 32 blocks and similar work: the low-frequency
//   segments, where most symbols are, share warps, and warps of the high
//   positions finish early and give their issue slots to other CTAs.
//   - mask: each thread reads its segment (16-byte loads) into a bit mask
//     of nonzero positions; DC prediction is computed here from the raw
//     DCs (the coefficient rows are never rewritten);
//   - symbols: each thread walks its mask's set bits, two a step so that
//     their table lookups overlap (the run of a symbol is the gap to the
//     previous nonzero, in its own or an earlier segment of the block; the
//     walk is compiled for each mode and run field), and appends
//     code | payload | run to a 64-bit bit writer (one append where the
//     three fit 32 bits, as most symbols' do), which stores
//     each finished 32-bit word into the segment's slot of a
//     shared-memory staging window (plain stores; a slot holds
//     the segment's worst case, kL x (16 + 16 + run field) bits, so it
//     never overflows). Each symbol is computed once;
//   - scan: a CTA-wide exclusive scan of the segments' bit totals in
//     stream order (a warp scan, then the eight warp totals), which also
//     gives the block bit totals;
//   - gather: each word of the stripe is built and stored (4 bytes,
//     coalesced across the warp) by the segment that holds its first bit,
//     which reads on through the staged segments after it (funnel shifts)
//     for the word's tail: no search, and every word has one owner. The
//     round's partial last word is carried in shared memory into the next
//     round's first word, so no word is written twice and none is read
//     back. After the stripe's last round the words past its payload are
//     zeroed with 16-byte streaming stores: the buffer's zeros are written
//     in the same pass, never first.
//   No global atomic is used, and each output word is stored exactly once.
// - Words are stored with their 16-bit halves swapped (see bindings.h).

#include "bindings.h"
#include "transform_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Entropy modes (the `mode` argument of dct_encode_stripes).
constexpr int kCategory = 0, kDirect = 1, kNone = 2;
// Direct mode's alphabet: values [kDirectVmin, -kDirectVmin] at table
// index v - kDirectVmin, ESC at kDirectEsc (models/codec.py DIRECT_VMIN;
// the wrapper checks the 512-entry table).
constexpr int kDirectVmin = -255;
constexpr int kDirectEsc = 511;
// Shared-memory tables, one int an entry, (length << 16) | code: the value
// table (512 entries at most) and the run table (65), padded to 16 bytes.
constexpr int kMaxValues = 512;
constexpr int kRunAlphabet = 65;
constexpr int kTabInts = kMaxValues + kRunAlphabet + 3;
constexpr int kMaxCodeBits = 16;  // canonical codes are at most 16 bits

template <int N2>
struct Shape {
  static_assert(N2 == 16 || N2 == 64 || N2 == 256, "n2 16, 64 or 256");
  static constexpr int kN = N2 == 16 ? 4 : N2 == 64 ? 8 : 16;  // block side
  static constexpr int kTile = N2 == 16 ? 256 : N2 == 64 ? 128 : 64;
  static constexpr int kL = N2 == 256 ? 32 : 16;  // positions a segment
  static constexpr int kG = N2 / kL;              // segments a block
  static constexpr int kE = kThreads / kG;        // blocks a round
  // A segment's worst case: every position a symbol of a 16-bit code, a
  // 16-bit payload (ESC or category 15) and the run field (a 16-bit code
  // under coded runs, which n2 256 does not take; else run_field_bits).
  static constexpr int kRunWorst = N2 <= 64 ? kMaxCodeBits : 9;
  static constexpr int kSegWords = (kL * (32 + kRunWorst) + 31) / 32;
  static constexpr int kSlot = kSegWords | 1;  // odd: lanes' slots spread banks
  static constexpr int kZRow = N2 + 8;         // int16 a coefficient row
  static constexpr int kP = N2 < 32 ? 32 : N2;  // a packed pixel row
  static constexpr int kRows = kTile * N2 / kP;
  static constexpr int kMinBlocks = N2 == 16 ? 4 : N2 == 64 ? 3 : 2;
  // one m-tile a group below 256: with the fragments in registers, two
  // spill within B's register bounds
  using Mma = dct::MmaTile<kP, kRows, kP == 256 ? 4 : 1, kThreads>;
  // shared memory, in bytes: tables, per-segment masks, bits and offsets,
  // warp totals and carries, coefficient rows, pixels, staging (which the
  // rescue list shares: the list is dead before the first round's symbols)
  static constexpr int kScalars = 3 * kThreads + 16 + kWarps + 4;
  static constexpr int kZBytes = kTile * kZRow * 2;
  static constexpr int kPxBytes = kRows * Mma::kStride;
  static constexpr int kStageBytes = (kThreads * kSlot + 4) * 4;
  static constexpr int kBytes =
      (kTabInts + kScalars) * 4 + kZBytes + kPxBytes + kStageBytes;
  static_assert(kTile % kE == 0 && kL % 8 == 0 && kTile <= kThreads &&
                    kThreads % kTile == 0 && kN % (kThreads / kTile) == 0,
                "tiling");
  static_assert(kTile * N2 * 2 <= kStageBytes, "the rescue list fits");
  static_assert(kZBytes % 16 == 0 && kPxBytes % 16 == 0, "16-byte rows");
};

// Coefficients of the certified tile into the tile's int16 rows.
template <int N2>
struct SmemStore {
  int16_t* zz;
  __device__ __forceinline__ int at(int idx) const {
    return idx + idx / N2 * (Shape<N2>::kZRow - N2);
  }
  __device__ __forceinline__ void pair(int idx, int q0, int q1) {
    *reinterpret_cast<unsigned*>(zz + at(idx)) =
        static_cast<unsigned>(static_cast<uint16_t>(q0)) |
        static_cast<unsigned>(static_cast<uint16_t>(q1)) << 16;
  }
  __device__ __forceinline__ void one(int idx, int q) {
    zz[at(idx)] = static_cast<int16_t>(q);
  }
};

struct Tables {
  const unsigned* val;  // (length << 16) | code
  const unsigned* run;  // the same, under coded runs
  int run_bits;         // the fixed run field's width
};

// The MSB-first bits of one segment, in 32-bit words of its staging slot.
struct BitWriter {
  unsigned long long acc = 0;  // the pending bits are the low n
  int n = 0;                   // < 32 between calls
  int words = 0;
  int total = 0;
  unsigned* slot;

  // Append the low `bits` (<= 32) bits of v, which holds no bit above them.
  template <int MAX_WORDS>
  __device__ __forceinline__ void put(unsigned v, int bits) {
    acc = (acc << bits) | v;
    n += bits;
    total += bits;
    if (n >= 32) {
      n -= 32;
      if (words < MAX_WORDS) slot[words] = static_cast<unsigned>(acc >> n);
      ++words;
    }
  }
  template <int MAX_WORDS>
  __device__ __forceinline__ void finish() {
    if (n && words < MAX_WORDS)
      slot[words] = static_cast<unsigned>(acc << (32 - n));
  }
};

// The fields of a symbol of value v with `run` zeros before it
// (dct_tpu_torch/ops/bitstream.py symbol_chunks), MSB first:
//   category: code(cat) | the cat low bits of v (of v + 2^cat - 1 below 0)
//   direct:   code(v - vmin), or code(ESC) | v as 16 raw bits
//   none:     v as 16 raw bits
// then the run, in run_bits bits or as its canonical code.
struct Fields {
  unsigned head, run;  // code | payload (at most 16 + 16 bits); the run
  int head_bits, run_bits;
};

// A symbol's fields into the bit writer: one append where they fit 32
// bits together (most symbols: a short code, a short payload, the run),
// which halves the writer's serial chain, else two.
template <int MAX_WORDS>
__device__ __forceinline__ void put_symbol(BitWriter& w, const Fields& f) {
  const int bits = f.head_bits + f.run_bits;
  if (bits <= 32) {
    w.put<MAX_WORDS>(f.head << f.run_bits | f.run, bits);
  } else {
    w.put<MAX_WORDS>(f.head, f.head_bits);
    w.put<MAX_WORDS>(f.run, f.run_bits);
  }
}

template <int MODE, bool CODED>
__device__ __forceinline__ Fields symbol_fields(int v, int run,
                                                const Tables& t) {
  unsigned e, payload = 0u;
  int plen = 0;
  if constexpr (MODE == kCategory) {
    const int a = v < 0 ? -v : v;
    const int cat = min(a ? 32 - __clz(a) : 0, 15);
    const unsigned span = (1u << cat) - 1u;
    payload = static_cast<unsigned>(v < 0 ? v + static_cast<int>(span) : v) &
              span;
    plen = cat;
    e = t.val[cat];
  } else if constexpr (MODE == kDirect) {
    const int s = v - kDirectVmin;
    const bool esc = s < 0 || s >= kDirectEsc;
    e = t.val[esc ? kDirectEsc : s];
    if (esc) {
      payload = static_cast<unsigned>(v) & 0xFFFFu;
      plen = 16;
    }
  } else {
    e = 16u << 16 | (static_cast<unsigned>(v) & 0xFFFFu);
  }
  Fields f{((e & 0xFFFFu) << plen) | payload, static_cast<unsigned>(run),
           static_cast<int>(e >> 16) + plen, t.run_bits};
  if constexpr (CODED) {
    const unsigned r = t.run[run];
    f.run = r & 0xFFFFu;
    f.run_bits = static_cast<int>(r >> 16);
  }
  return f;
}

// A segment's symbols into its bit writer: each set bit of m (position
// base_p + i of the block holds a nonzero; pnz the last nonzero before
// them), then, where `terminal`, the block's terminal symbol (the
// trailing run + 1). Two symbols a step, so the table lookups of both
// overlap; only the bit writer's appends are serial.
template <int MODE, bool CODED, int N2, int MAX_WORDS>
__device__ __forceinline__ void segment_symbols(BitWriter& w, unsigned m,
                                                int pnz, bool terminal,
                                                const int16_t* zrow,
                                                int base_p, int dc,
                                                const Tables& t) {
  while (m) {
    const int p0 = base_p + __ffs(m) - 1;
    m &= m - 1u;
    const int i1 = __ffs(m) - 1;  // -1: p0 was the last
    m &= m - 1u;
    const int p1 = i1 < 0 ? p0 : base_p + i1;
    const Fields f0 = symbol_fields<MODE, CODED>(
        p0 ? static_cast<int>(zrow[p0]) : dc, p0 - pnz - 1, t);
    const Fields f1 = symbol_fields<MODE, CODED>(static_cast<int>(zrow[p1]),
                                                 i1 < 0 ? 0 : p1 - p0 - 1, t);
    put_symbol<MAX_WORDS>(w, f0);
    if (i1 >= 0) put_symbol<MAX_WORDS>(w, f1);
    pnz = p1;
  }
  if (terminal) {
    put_symbol<MAX_WORDS>(w, symbol_fields<MODE, CODED>(0, N2 - 1 - pnz, t));
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// A stream word (MSB-first) as stored: its two units with halves swapped.
__device__ __forceinline__ unsigned stored(unsigned w) {
  return __funnelshift_l(w, w, 16);
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory; 16 bytes
// bypass L1 (.cg), the smaller copies cannot (.ca).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where B reads its pixels (the block address of the header comment).
struct Pixels {
  const uint8_t* px;
  int bps;          // blocks a stripe
  int plane_width;  // 0: (NB, n2) blocks; else the planes' rows, Wp bytes
};

// Start copying blocks [j0, j0 + n) of a stripe into the tile's packed
// rows (one commit group).
template <int N2>
__device__ __forceinline__ void load_pixels(uint8_t* s_px, const Pixels& g,
                                            int stripe, int j0, int n) {
  using S = Shape<N2>;
  constexpr int P = S::kP, Q = S::Mma::kStride, K = S::kN;
  const uint8_t* base = g.px + static_cast<long long>(stripe) * g.bps * N2;
  if (g.plane_width == 0) {  // the tile's n * N2 bytes are contiguous
    const uint8_t* src = base + static_cast<long long>(j0) * N2;
    for (int i = threadIdx.x; i < n * N2 / 16; i += kThreads) {
      const int o = 16 * i;  // packed row o / P, byte o % P
      cp_async<16>(s_px + o / P * Q + o % P, src + o);
    }
  } else {  // the planes: a block row (K bytes) a copy
    // thread t copies rows r0, r0 + R, ... of tile block t % kTile, so a
    // warp's lanes copy one pixel row of neighbouring blocks (coalesced),
    // and each thread finds its block's address once
    constexpr int R = kThreads / S::kTile;  // threads a block
    const int bt = threadIdx.x % S::kTile, r0 = threadIdx.x / S::kTile;
    if (bt < n) {
      const int w = g.plane_width, bw = w / K, j = j0 + bt;
      const uint8_t* src = base + static_cast<long long>(j / bw) * K * w +
                           (j % bw) * K + static_cast<long long>(r0) * w;
      uint8_t* dst = s_px + bt * N2 / P * Q + bt * N2 % P + r0 * K;
#pragma unroll
      for (int i = 0; i < K / R; ++i, src += R * w, dst += R * K)
        cp_async<K>(dst, src);
    }
  }
  cp_async_commit();
}

// Zero words [a, e) of a row, 16-byte stores where the addresses allow,
// streaming (evict-first): nothing here reads them back.
__device__ void zero_words(unsigned* row, int a, int e) {
  const int tid = threadIdx.x;
  int k16 = a + static_cast<int>(
                    (4 - ((reinterpret_cast<uintptr_t>(row + a) & 15) >> 2)) &
                    3);
  if (k16 > e) k16 = e;
  if (tid < k16 - a) row[a + tid] = 0u;
  const int n_vec = (e - k16) >> 2;
  uint4* v = reinterpret_cast<uint4*>(row + k16);
  for (int i = tid; i < n_vec; i += kThreads)
    __stcs(v + i, make_uint4(0, 0, 0, 0));
  const int tail = k16 + 4 * n_vec;
  if (tid < e - tail) row[tail + tid] = 0u;
}

template <int N2>
__global__ void __launch_bounds__(kThreads, Shape<N2>::kMinBlocks)
    encode_stripes_kernel(const uint8_t* __restrict__ px_in,
                          const uint4* __restrict__ frag,
                          const int4* __restrict__ cert,
                          const float* __restrict__ parts,
                          const float* __restrict__ bias,
                          const float* __restrict__ recip,
                          const int* __restrict__ val_len,
                          const int* __restrict__ val_code, int n_val,
                          const int* __restrict__ run_len,
                          const int* __restrict__ run_code, int run_bits,
                          int mode, int dc_prediction, int n_stripes, int bps,
                          int plane_width, unsigned* __restrict__ words,
                          int n_words,
                          int* __restrict__ stripe_bits,
                          int* __restrict__ block_bits,
                          unsigned long long* __restrict__ rescued) {
  using S = Shape<N2>;
  using M = typename S::Mma;
  constexpr int T = S::kTile, L = S::kL, G = S::kG, E = S::kE;
  extern __shared__ __align__(16) int smem[];
  unsigned* s_val = reinterpret_cast<unsigned*>(smem);
  unsigned* s_run = s_val + kMaxValues;
  unsigned* s_mask = s_val + kTabInts;  // per segment, stream order
  int* s_bits = reinterpret_cast<int*>(s_mask + kThreads);
  int* s_off = s_bits + kThreads;       // kThreads + 1 exclusive offsets
  int* s_wsum = s_off + kThreads + 16;  // the warps' bit totals
  unsigned* s_carry = reinterpret_cast<unsigned*>(s_wsum + kWarps);  // 2
  int* s_count = s_wsum + kWarps + 2;   // the rescue list's length
  int16_t* s_zz = reinterpret_cast<int16_t*>(smem + kTabInts + S::kScalars);
  uint8_t* s_px = reinterpret_cast<uint8_t*>(s_zz) + S::kZBytes;
  unsigned* s_stage = reinterpret_cast<unsigned*>(s_px + S::kPxBytes);
  uint16_t* s_list = reinterpret_cast<uint16_t*>(s_stage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / E, b = tid % E;  // this thread's segment of a round
  const bool adaptive = recip != nullptr;
  const Tables tabs{s_val, s_run, run_bits};
  const Pixels px{px_in, bps, plane_width};

  for (int i = tid; i < n_val; i += kThreads)
    s_val[i] = static_cast<unsigned>(val_len[i]) << 16 |
               (static_cast<unsigned>(val_code[i]) & 0xFFFFu);
  if (run_len != nullptr && tid < kRunAlphabet)
    s_run[tid] = static_cast<unsigned>(run_len[tid]) << 16 |
                 (static_cast<unsigned>(run_code[tid]) & 0xFFFFu);
  if (bps > 0)  // the first tile; the grid has at most n_stripes CTAs
    load_pixels<N2>(s_px, px, blockIdx.x, 0, min(T, bps));

  long long n_rescued = 0;  // coefficients the chain computed
  for (int stripe = blockIdx.x; stripe < n_stripes; stripe += gridDim.x) {
    unsigned* row = words + static_cast<long long>(stripe) * n_words;
    int base = 0;     // the stripe's bits before this round
    int parity = 0;   // which s_carry holds the word carried in
    int prev_dc = 0;  // raw DC of the block before the tile (thread 0)
    for (int t0 = 0; t0 < bps; t0 += T) {
      const int n = min(T, bps - t0);
      const long long blk = static_cast<long long>(stripe) * bps + t0;

      // ---- 1. the certified transform (kernel A's tile) ----
      if (tid == 0) *s_count = 0;
      cp_async_wait_all();
      __syncthreads();
      const float* rc = adaptive ? recip + blk : nullptr;
      SmemStore<N2> store{s_zz};
      // the warp's fragments and constants, in registers for this tile
      // only: across the entropy stage they would cost B its CTAs an SM
      dct::TileOperands<M> ops{frag, cert};
      if constexpr (dct::TileOperands<M>::kHeld) ops.load(warp % M::kWN);
      dct::mma_tile<M>(s_px, ops, s_list, s_count,
                       [&](int r, int c, const int(&a)[2][4],
                           const dct::ColumnCert(&cc)[2]) {
                         return dct::certify_pair<N2, S::kP>(r, c, a, cc, n,
                                                             rc, store);
                       });
      __syncthreads();
      const int n_open = *s_count;
      if (n_open) {  // the same on every thread
        dct::rescue_tile<N2, S::kP, M::kStride, kThreads>(
            s_list, n_open, s_px, parts, bias, rc, store);
        n_rescued += n_open;
        __syncthreads();  // the rescued values are in; the pixels are free
      }

      // ---- 2. the next tile's pixels, in flight during the entropy stage
      {
        int nt0 = t0 + T, ns = stripe;
        if (nt0 >= bps) {
          nt0 = 0;
          ns += gridDim.x;
        }
        if (ns < n_stripes)
          load_pixels<N2>(s_px, px, ns, nt0, min(T, bps - nt0));
      }

      // ---- 3. the entropy stage, in rounds of E blocks ----
      for (int rb = 0; rb < n; rb += E) {
        const int bt = rb + b;  // this thread's block in the tile
        const bool live = bt < n;
        const int16_t* zrow = s_zz + bt * S::kZRow;

        // mask of the segment's nonzero positions; DC prediction
        unsigned m = 0u;
        int dc = 0;
        if (live) {
          const uint4* src = reinterpret_cast<const uint4*>(zrow + g * L);
#pragma unroll
          for (int i = 0; i < L / 8; ++i) {
            const uint4 q = src[i];
            const unsigned w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int at = 8 * i + 2 * j;  // positions at, at + 1
              m |= static_cast<unsigned>((w4[j] & 0xFFFFu) != 0u) << at;
              m |= static_cast<unsigned>((w4[j] >> 16) != 0u) << (at + 1);
            }
          }
          if (g == 0) {
            dc = zrow[0];
            if (dc_prediction)
              dc -= bt ? static_cast<int>(zrow[-S::kZRow]) : prev_dc;
            m = (m & ~1u) | static_cast<unsigned>(dc != 0);
          }
        }
        if (tid == 0 && rb == 0)
          prev_dc = s_zz[(n - 1) * S::kZRow];  // for the next tile
        s_mask[b * G + g] = m;
        __syncthreads();  // masks in; the previous round's gather is done

        // symbols: each set bit of the mask, then the block's terminal
        // symbol (the trailing run + 1) where its last position is zero
        BitWriter wr;
        wr.slot = s_stage + tid * S::kSlot;
        if (live) {
          int pnz = -1;  // the last nonzero position before this one
          for (int gg = g - 1; gg >= 0; --gg) {
            const unsigned mm = s_mask[b * G + gg];
            if (mm) {
              pnz = gg * L + 31 - __clz(mm);
              break;
            }
          }
          const bool terminal = g == G - 1 && !(m >> (L - 1) & 1u);
          constexpr int W = S::kSegWords;
          switch (mode * 2 + (run_len != nullptr)) {
            case 2 * kCategory:
              segment_symbols<kCategory, false, N2, W>(wr, m, pnz, terminal,
                                                       zrow, g * L, dc, tabs);
              break;
            case 2 * kCategory + 1:
              segment_symbols<kCategory, true, N2, W>(wr, m, pnz, terminal,
                                                      zrow, g * L, dc, tabs);
              break;
            case 2 * kDirect:
              segment_symbols<kDirect, false, N2, W>(wr, m, pnz, terminal,
                                                     zrow, g * L, dc, tabs);
              break;
            case 2 * kDirect + 1:
              segment_symbols<kDirect, true, N2, W>(wr, m, pnz, terminal,
                                                    zrow, g * L, dc, tabs);
              break;
            case 2 * kNone:
              segment_symbols<kNone, false, N2, W>(wr, m, pnz, terminal,
                                                   zrow, g * L, dc, tabs);
              break;
            default:
              segment_symbols<kNone, true, N2, W>(wr, m, pnz, terminal,
                                                  zrow, g * L, dc, tabs);
          }
          wr.finish<W>();
        }
        s_bits[b * G + g] = wr.total;
        __syncthreads();

        // exclusive scan of the segments' bits in stream order; blocks'
        // bit totals
        const int v = s_bits[tid];
        const int incl = warp_inclusive_scan(v, lane);
        if (lane == 31) s_wsum[warp] = incl;
        if (tid < E && rb + tid < n) {
          int tot = 0;
#pragma unroll
          for (int k = 0; k < G; ++k) tot += s_bits[tid * G + k];
          block_bits[blk + rb + tid] = tot;
        }
        __syncthreads();
        const int ws = lane < kWarps ? s_wsum[lane] : 0;
        const int wi = warp_inclusive_scan(ws, lane);
        const int before = __shfl_sync(kFull, wi - ws, warp);
        s_off[tid] = before + incl - v;
        if (tid == kThreads - 1) s_off[kThreads] = before + incl;
        __syncthreads();

        // gather: each segment stores the words whose first bit of this
        // round it holds (so every word has one owner), reading on into
        // the segments after it for the word's tail
        const int bits = s_off[kThreads];
        const int end = base + bits;
        const bool last = t0 + T >= bps && rb + E >= n;  // the stripe's
        const int w_lo = base >> 5;
        const int w_stop = last ? (end + 31) >> 5 : end >> 5;  // stored below
        if (v > 0) {
          const int off = before + incl - v;  // this segment's first bit
          int j = off ? (base + off + 31) >> 5 : w_lo;
          const int j_hi = (base + off + v - 1) >> 5;
          for (; j <= j_hi; ++j) {
            const int ws0 = 32 * j - base;  // the word's first bit
            const int hi = min(ws0 + 32, bits);
            unsigned word = j == w_lo && (base & 31) ? s_carry[parity] : 0u;
            // segment k holds bits [k_off, k_end) of the round
            int k = tid, k_off = off, k_end = off + v;
            for (int pos = max(ws0, 0);;) {
              const int sq = pos - k_off;
              const int take = min(k_end, hi) - pos;
              const int slot = (k % G) * E + k / G;
              const unsigned* st = s_stage + slot * S::kSlot + (sq >> 5);
              unsigned f = __funnelshift_l(st[1], st[0], sq & 31);
              f = f >> (32 - take) << (32 - take);
              word |= f >> (pos - ws0);
              pos += take;
              if (pos >= hi) break;
              do {  // the next segment that holds bits
                ++k;
                k_off = k_end;
                k_end = s_off[k + 1];
              } while (k_end == k_off);
            }
            if (j < w_stop) {
              if (j < n_words) row[j] = stored(word);
            } else {
              s_carry[parity ^ 1] = word;  // the partial last word
            }
          }
        }
        if (bits == 0 && last && (base & 31) && tid == 0 && w_lo < n_words)
          row[w_lo] = stored(s_carry[parity]);  // (tables with empty codes)
        base = end;
        if (bits) parity ^= 1;
      }
    }
    // the words past the payload, zeros; the stripe's bits
    zero_words(row, min((base + 31) >> 5, n_words), n_words);
    if (tid == 0) stripe_bits[stripe] = base;
  }
  if (tid == 0 && n_rescued)
    atomicAdd(rescued, static_cast<unsigned long long>(n_rescued));
}

// Per device: SMs and CTAs an SM for each n2 (0 until first asked).
int g_sms[64];
int g_ctas[64][3];

template <int N2>
int n2_slot() {
  return N2 == 16 ? 0 : N2 == 64 ? 1 : 2;
}

template <int N2>
cudaError_t occupancy(int& sms, int& ctas) {
  constexpr int smem = Shape<N2>::kBytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (g_ctas[dev][n2_slot<N2>()] == 0) {
    err = cudaFuncSetAttribute(encode_stripes_kernel<N2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    int c = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c, encode_stripes_kernel<N2>, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (c < 1) return cudaErrorInvalidConfiguration;
    g_ctas[dev][n2_slot<N2>()] = c;
  }
  sms = g_sms[dev];
  ctas = g_ctas[dev][n2_slot<N2>()];
  return cudaSuccess;
}

template <int N2>
int launch(const void* px, const void* frag, const void* cert,
           const void* parts, const void* bias, const void* recip,
           const void* val_len, const void* val_code, int n_val,
           const void* run_len, const void* run_code, int run_bits, int mode,
           int dc_prediction, int n_stripes, int bps, int plane_width,
           void* words, int n_words, void* stripe_bits, void* block_bits,
           void* rescued, cudaStream_t stream) {
  int sms = 0, ctas = 0;
  cudaError_t err = occupancy<N2>(sms, ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = min(n_stripes, sms * ctas);
  encode_stripes_kernel<N2><<<grid, kThreads, Shape<N2>::kBytes, stream>>>(
      static_cast<const uint8_t*>(px), static_cast<const uint4*>(frag),
      static_cast<const int4*>(cert), static_cast<const float*>(parts),
      static_cast<const float*>(bias), static_cast<const float*>(recip),
      static_cast<const int*>(val_len), static_cast<const int*>(val_code),
      n_val, static_cast<const int*>(run_len),
      static_cast<const int*>(run_code), run_bits, mode, dc_prediction,
      n_stripes, bps, plane_width, static_cast<unsigned*>(words), n_words,
      static_cast<int*>(stripe_bits), static_cast<int*>(block_bits),
      static_cast<unsigned long long*>(rescued));
  return static_cast<int>(cudaGetLastError());
}

template <int N2>
int info(int* out) {
  int sms = 0, ctas = 0;
  cudaError_t err = occupancy<N2>(sms, ctas);
  cudaFuncAttributes a{};
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, encode_stripes_kernel<N2>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = sms;
  out[1] = ctas;
  out[2] = a.numRegs;
  out[3] = Shape<N2>::kBytes;
  out[4] = static_cast<int>(a.localSizeBytes);
  out[5] = kThreads;
  out[6] = Shape<N2>::kTile;
  return 0;
}

// The adaptive encode's variance pass: padded u8 planes to each block's
// u8 variance code and the float32 reciprocal of its scale, which kernel B
// reads (ops/quant.py block_variance_flat, variance_code,
// scale_from_variance_code, then transform.reciprocal_scale).
//
// Replaces no Pallas kernel: the JAX package leaves the variances to XLA
// (dct_tpu/ops/quant.py), and the port ran them as ~20 eager PyTorch ops
// over a blocked u8 copy and float32 copies of every pixel. Bytes bind it:
// each pixel byte is read once, and a block writes 1 code byte and 4 bytes
// of reciprocal (n2 + 5 bytes a block against a few dozen operations), so
// its bound is the bytes over 3.35 TB/s.
//
// Design. A thread takes 16 bytes of a pixel row (16 / n neighbouring
// blocks) and the block row's n pixel rows, so a warp reads 512
// contiguous bytes a row and every load is 16 bytes, or 4-byte words where
// the row width is not a multiple of 16 (and in a row's narrower last
// chunk). A thread issues its n loads before it sums them (n x 16 bytes in
// flight), and stores its blocks' codes and reciprocals with one store of
// each (uchar4 and float4 at 4x4, uchar2 and float2 at 8x8). The grid
// covers (block row of every plane, 16-byte chunk) in one launch. The sums are integers: each byte XOR 0x80 is the int8 p - 128,
// and __dp4a against ones and against itself gives S1 = sum(p - 128) and
// S2 = sum((p - 128)^2), at most 256 * 128^2 = 2^22, so float32 holds both
// exactly. After the sums the float32 steps are quant.py's, in its order,
// each rounded once (no contraction into FMAs): mean = S1 / n2, mean_sq =
// S2 / n2, var = mean_sq - mean * mean, norm = clamp(var / 1000, 0.1, 1),
// code = rint((norm - 0.1) * (255 / 0.9)), scale = 2 - (0.1 + code *
// (0.9 / 255)), recip = 1 / scale. The constants are the float32 values
// PyTorch gives those Python scalars (tests/test_torch_variance_model.py
// reads them from this file and runs its model of these steps on them).
constexpr int kVarThreads = 256;
constexpr float kVarianceUnit = 0x1.f4p+9f;  // 1000.0
constexpr float kNormMin = 0x1.99999ap-4f;   // 0.1
constexpr float kNormMax = 0x1p+0f;          // 1.0
constexpr float kCodeScale = 0x1.1b5556p+8f; // 255.0 / 0.9
constexpr float kCodeStep = 0x1.ce9b68p-9f;  // 0.9 / 255.0

template <int N>
__device__ __forceinline__ void code_and_recip(int s1, int s2, uint8_t& code,
                                               float& recip) {
  constexpr float kN2 = N * N;
  const float mean = __fdiv_rn(__int2float_rn(s1), kN2);
  const float mean_sq = __fdiv_rn(__int2float_rn(s2), kN2);
  const float var = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
  const float norm =
      fminf(fmaxf(__fdiv_rn(var, kVarianceUnit), kNormMin), kNormMax);
  const float c = rintf(__fmul_rn(__fsub_rn(norm, kNormMin), kCodeScale));
  const float scale =
      __fsub_rn(2.0f, __fadd_rn(kNormMin, __fmul_rn(c, kCodeStep)));
  code = static_cast<uint8_t>(c);
  recip = __fdiv_rn(1.0f, scale);
}

// px: rows * n pixel rows of `width` bytes; codes and recip: one entry a
// block, raster order over every plane. All three 16-byte aligned.
template <int N>
__global__ void __launch_bounds__(kVarThreads)
    variance_codes_kernel(const uint8_t* __restrict__ px, long long rows,
                          int width, int chunks, uint8_t* __restrict__ codes,
                          float* __restrict__ recip) {
  constexpr int kBlocks = 16 / N;  // blocks a 16-byte chunk
  constexpr int kWords = N / 4;    // 4-byte words a block row
  const long long t =
      static_cast<long long>(blockIdx.x) * kVarThreads + threadIdx.x;
  if (t >= rows * chunks) return;
  const long long brow = t / chunks;
  const int x0 = static_cast<int>(t - brow * chunks) * 16;
  const int nb = min(16, width - x0) / N;  // fewer in a row's last chunk
  const uint8_t* p = px + brow * N * width + x0;
  // sums a 4-byte word column, each its own chain; a block's words are
  // added at the end
  int s1[4] = {0, 0, 0, 0}, s2[4] = {0, 0, 0, 0};
  auto add = [&](int k, unsigned w) {
    const int y = static_cast<int>(w ^ 0x80808080u);  // four int8 p - 128
    s1[k] = __dp4a(y, 0x01010101, s1[k]);
    s2[k] = __dp4a(y, y, s2[k]);
  };
  const bool whole = nb == kBlocks && width % 16 == 0;
  if (whole) {  // every load 16 bytes, all N issued before the sums
    uint4 v[N];
#pragma unroll
    for (int r = 0; r < N; ++r)
      v[r] = __ldg(reinterpret_cast<const uint4*>(p + r * width));
#pragma unroll
    for (int r = 0; r < N; ++r) {
      add(0, v[r].x);
      add(1, v[r].y);
      add(2, v[r].z);
      add(3, v[r].w);
    }
  } else {  // 4-byte loads: rows not 16-byte aligned, or the last chunk
    const int words = nb * kWords;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const unsigned* row = reinterpret_cast<const unsigned*>(p + r * width);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < words) add(k, __ldg(row + k));
    }
  }
  uint8_t c[kBlocks];
  float f[kBlocks];
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
    int a1 = 0, a2 = 0;
#pragma unroll
    for (int k = b * kWords; k < (b + 1) * kWords; ++k) {
      a1 += s1[k];
      a2 += s2[k];
    }
    code_and_recip<N>(a1, a2, c[b], f[b]);
  }
  const long long b0 = brow * (width / N) + x0 / N;
  if constexpr (kBlocks == 4) {  // b0 a multiple of 4 when width % 16 == 0
    if (whole) {
      *reinterpret_cast<uchar4*>(codes + b0) =
          make_uchar4(c[0], c[1], c[2], c[3]);
      *reinterpret_cast<float4*>(recip + b0) =
          make_float4(f[0], f[1], f[2], f[3]);
      return;
    }
  } else if constexpr (kBlocks == 2) {  // b0 even
    if (whole) {
      *reinterpret_cast<uchar2*>(codes + b0) = make_uchar2(c[0], c[1]);
      *reinterpret_cast<float2*>(recip + b0) = make_float2(f[0], f[1]);
      return;
    }
  }
#pragma unroll
  for (int b = 0; b < kBlocks; ++b)
    if (b < nb) {
      codes[b0 + b] = c[b];
      recip[b0 + b] = f[b];
    }
}

template <int N>
int launch_variance(const void* px, long long rows, int width, void* codes,
                    void* recip, cudaStream_t stream) {
  const int chunks = (width + 15) / 16;
  const long long grid = (rows * chunks + kVarThreads - 1) / kVarThreads;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  variance_codes_kernel<N><<<static_cast<unsigned>(grid), kVarThreads, 0,
                             stream>>>(
      static_cast<const uint8_t*>(px), rows, width, chunks,
      static_cast<uint8_t*>(codes), static_cast<float*>(recip));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DCT_EXPORT int dct_encode_stripes(const void* px, const void* frag,
                                  const void* cert, const void* parts,
                                  const void* bias, const void* recip,
                                  const void* val_len, const void* val_code,
                                  int n_val, const void* run_len,
                                  const void* run_code, int run_bits,
                                  int mode, int dc_prediction, int n2,
                                  int n_stripes, int bps, int plane_width,
                                  void* words, int n_words, void* stripe_bits,
                                  void* block_bits, void* rescued,
                                  void* stream) {
  if (n_val < 0 || n_val > kMaxValues || mode < kCategory || mode > kNone ||
      run_bits < 0 || run_bits > kMaxCodeBits || plane_width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_stripes == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
#define DCT_B(N)                                                              \
  if (plane_width % Shape<N>::kN)                                            \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  return launch<N>(px, frag, cert, parts, bias, recip, val_len, val_code,  \
                   n_val, run_len, run_code, run_bits, mode, dc_prediction,   \
                   n_stripes, bps, plane_width, words, n_words, stripe_bits,  \
                   block_bits, rescued, s)
  switch (n2) {
    case 16: DCT_B(16);
    case 64: DCT_B(64);
    case 256: DCT_B(256);
  }
#undef DCT_B
  return static_cast<int>(cudaErrorInvalidValue);
}

DCT_EXPORT int dct_variance_codes(const void* px, long long rows, int width,
                                  int n2, void* codes, void* recip,
                                  void* stream) {
  if (rows < 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n2) {
    case 16:
      if (width % 4 == 0) return launch_variance<4>(px, rows, width, codes, recip, s);
      break;
    case 64:
      if (width % 8 == 0) return launch_variance<8>(px, rows, width, codes, recip, s);
      break;
    case 256:
      if (width % 16 == 0) return launch_variance<16>(px, rows, width, codes, recip, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

DCT_EXPORT int dct_encode_stripes_info(int n2, void* out) {
  int* o = static_cast<int*>(out);
  switch (n2) {
    case 16: return info<16>(o);
    case 64: return info<64>(o);
    case 256: return info<256>(o);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

DCT_EXPORT const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
