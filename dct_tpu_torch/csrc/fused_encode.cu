// Kernel B: the fused stripe encode — u8 pixel blocks to packed bitstream
// units, one CTA per (frame, stripe).
//
// Replaces dct_tpu/ops/fused_encode_pallas.py `_fused_kernel` (wrapper
// `encode_stripes_fused`) at every config it takes: 4x4, 8x8 and 16x16
// blocks (n2 16, 64, 256); the category, direct and "none" entropy
// modes; the fixed run field, or the coded one at n2 <= 64; adaptive
// quantization and DC prediction on or off; stripes of any width. It ports
// the outputs, not the TPU mechanism: the pack-tier ladder, the acc4
// rungs, lane compaction, the one-hot direct-table gather and the MXU
// scatter were workarounds for a machine without per-lane gathers,
// scatters or cumsum.
//
// What bounds it on an H100: HBM sees n2 bytes of pixels in per block and
// the worst-case unit buffer out (zeroed by the CTA itself:
// units_per_block_worst(n2, coded_runs) 16-bit units a block, 80 B at n2
// 16 (96 B with coded runs), 320 B at 64 (384 B), 1312 B at 256), so bytes
// are small. The transform runs on the integer tensor cores (4 x n2 x n2
// int8 multiply-adds a block, a few microseconds at the batch) with a
// float64 certificate a coefficient and the float32 chain for the few the
// certificate leaves open; what remains is the serial dependencies of the
// entropy stage inside a stripe (a scan over the stripe's blocks and one
// over each block's symbols).
//
// The design:
// - one CTA per stripe walks it in tiles of kTile blocks (128 at n2 16 and
//   64, 64 at 256; 128 measured faster than 64 at 64), so shared memory
//   is a constant of n2 (17 KB at 16, 49 KB at 64, 89 KB at 256) and a
//   stripe may be any width;
// - per tile: pixels in (16-byte loads into packed rows, transform_core.cuh
//   MmaTile), the certified tile of transform_core.cuh — kernel A's — to
//   int16 coefficients in shared memory, the rescue list worked through
//   by the whole CTA, DC DPCM against the previous block's raw DC (carried
//   across tile edges), each block's RLE, symbol fields and bit total in
//   one warp (two 4x4 blocks a warp, one 16-lane segment each) with
//   ballots and shuffles, an exclusive scan of the block totals on top of
//   the bits of the tiles before, and placement;
// - operators: the byte planes' B fragments (4 n2^2 bytes at n2 >= 32,
//   16 KB at 64 and 256 KB at 256) are read through L1/L2, each once per
//   tile and warp for all of the warp's blocks (at 256 four m-tiles, 64
//   blocks, a read: 256 KB per 64 blocks instead of the float32 parts'
//   768 KB per 8); the transposed float32 parts only by the rescue;
// - symbols are placed with atomicOr: each field (code | payload | run,
//   at most 16 + 16 + 9 bits) touches at most three 32-bit words and
//   fields never share a bit, so the result does not depend on the order
//   of the atomics.

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
// Shared-memory table slots: value lengths and codes (512 each), run
// lengths and codes (65 each), padded to 16 bytes.
constexpr int kMaxValues = 512;
constexpr int kRunAlphabet = 65;
constexpr int kTabInts = 2 * kMaxValues + 2 * kRunAlphabet + 2;

template <int N2>
struct Shape {
  static_assert(N2 == 16 || N2 == 64 || N2 == 256, "n2 16, 64 or 256");
  static constexpr int kV = N2 >= 32 ? N2 / 32 : 1;   // values a lane holds
  static constexpr int kSeg = N2 >= 32 ? 32 : N2;     // lanes a block spans
  static constexpr int kPerWarp = 32 / kSeg;          // blocks a warp holds
  static constexpr int kTile = N2 == 256 ? 64 : 128;  // blocks a tile
  static constexpr int kP = N2 < 32 ? 32 : N2;        // a packed row
  static constexpr int kRows = kTile * N2 / kP;       // packed rows a tile
  using Mma = dct::MmaTile<kP, kRows, kP == 256 ? 4 : 2, kThreads>;
  // tables + block scalars, int16 coefficients, pixels, rescue list, count
  static constexpr int kBytes = (kTabInts + 3 * kTile) * 4 +
                                kTile * N2 * 2 + kRows * Mma::kStride +
                                kTile * N2 * 2 + 16;
  static_assert(kTile % 4 == 0, "16-byte aligned coefficient rows");
};

// Coefficients of the certified tile into the tile's int16 buffer.
struct SmemStore {
  int16_t* zz;
  __device__ __forceinline__ void pair(int idx, int q0, int q1) {
    *reinterpret_cast<unsigned*>(zz + idx) =
        static_cast<unsigned>(static_cast<uint16_t>(q0)) |
        static_cast<unsigned>(static_cast<uint16_t>(q1)) << 16;
  }
  __device__ __forceinline__ void one(int idx, int q) {
    zz[idx] = static_cast<int16_t>(q);
  }
};

struct Tables {
  const int* val_len;
  const int* val_code;
  const int* run_len;
  const int* run_code;
  int mode;
  int run_bits;  // the fixed run field's width
  bool coded_runs;
};

struct Symbol {
  unsigned long long value;  // code | payload | run, MSB first
  int bits;                  // 0 for a position that emits nothing
};

// The fields of a symbol of value v with `run` zeros before it
// (dct_tpu_torch/ops/bitstream.py symbol_chunks):
//   category: code(cat) | the cat low bits of v (of v + 2^cat - 1 below 0)
//   direct:   code(v - vmin), or code(ESC) | v as 16 raw bits
//   none:     v as 16 raw bits
// then the run, in run_bits bits or as its canonical code.
__device__ __forceinline__ Symbol make_symbol(int v, int run,
                                              const Tables& t) {
  unsigned long long code;
  int len, plen = 0;
  unsigned payload = 0u;
  if (t.mode == kCategory) {
    const int a = v < 0 ? -v : v;
    const int cat = min(a ? 32 - __clz(a) : 0, 15);
    const unsigned span = (1u << cat) - 1u;
    payload = static_cast<unsigned>(v < 0 ? v + static_cast<int>(span) : v) &
              span;
    plen = cat;
    code = static_cast<unsigned>(t.val_code[cat]);
    len = t.val_len[cat];
  } else if (t.mode == kDirect) {
    const int s = v - kDirectVmin;
    const bool esc = s < 0 || s >= kDirectEsc;
    const int idx = esc ? kDirectEsc : s;
    code = static_cast<unsigned>(t.val_code[idx]);
    len = t.val_len[idx];
    if (esc) {
      payload = static_cast<unsigned>(v) & 0xFFFFu;
      plen = 16;
    }
  } else {
    code = static_cast<unsigned>(v) & 0xFFFFu;
    len = 16;
  }
  int lr;
  unsigned rv;
  if (t.coded_runs) {
    lr = t.run_len[run];
    rv = static_cast<unsigned>(t.run_code[run]);
  } else {
    lr = t.run_bits;
    rv = static_cast<unsigned>(run);
  }
  return Symbol{(((code << plen) | payload) << lr) | rv, len + plen + lr};
}

// Positional RLE (dct_tpu/ops/rle.py rle_encode_positional): position p
// of an N2-coefficient block holding v, pnz the last nonzero position
// before p (-1 for none). Every nonzero value is a symbol; a block whose
// last position is zero ends in a terminal symbol carrying the trailing
// run + 1 (n2 for an all-zero block).
template <int N2>
__device__ __forceinline__ Symbol symbol_at(int v, int p, int pnz,
                                            const Tables& t) {
  if (v == 0 && p != N2 - 1) return Symbol{0ull, 0};
  return make_symbol(v, p - pnz - 1 + (v == 0 ? 1 : 0), t);
}

// The symbols of the kPerWarp blocks of the tile from tile-local block bw
// on (n blocks in the tile). n2 >= 64: symbol i of a lane is position
// i * 32 + lane of block bw. n2 = 16: lane l holds position l % 16 of
// block bw + l / 16; a block past n gives no symbols.
template <int N2>
__device__ __forceinline__ void block_symbols(
    const int16_t* __restrict__ s_zz, int bw, int n, int lane,
    const Tables& t, Symbol (&s)[Shape<N2>::kV]) {
  using S = Shape<N2>;
  if constexpr (S::kPerWarp > 1) {
    const int b = bw + lane / S::kSeg, p = lane % S::kSeg;
    const bool live = b < n;
    const int v = live ? s_zz[b * N2 + p] : 0;
    const unsigned seg = (__ballot_sync(kFull, v != 0) >> (lane - p)) &
                         ((1u << S::kSeg) - 1u);
    const unsigned below = seg & ((1u << p) - 1u);
    const int pnz = below ? 31 - __clz(below) : -1;
    s[0] = live ? symbol_at<N2>(v, p, pnz, t) : Symbol{0ull, 0};
  } else {
    int v[S::kV];
    unsigned m[S::kV];
#pragma unroll
    for (int i = 0; i < S::kV; ++i) {
      v[i] = s_zz[bw * N2 + i * 32 + lane];
      m[i] = __ballot_sync(kFull, v[i] != 0);
    }
    int last = -1;  // the last nonzero position of the words before i
#pragma unroll
    for (int i = 0; i < S::kV; ++i) {
      const unsigned below = m[i] & ((1u << lane) - 1u);
      const int pnz = below ? 32 * i + 31 - __clz(below) : last;
      s[i] = symbol_at<N2>(v[i], 32 * i + lane, pnz, t);
      if (m[i]) last = 32 * i + 31 - __clz(m[i]);
    }
  }
}

// Inclusive scan over segments of W lanes.
template <int W>
__device__ __forceinline__ int seg_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < W; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d, W);
    if ((lane & (W - 1)) >= d) v += u;
  }
  return v;
}

// OR a field of s.bits bits into the MSB-first word stream at bit `off`.
// Words are stored with their 16-bit halves swapped (see bindings.h).
__device__ __forceinline__ void place(Symbol s, long long off,
                                      unsigned* words, int n_words) {
  if (s.bits == 0) return;
  const int w0 = static_cast<int>(off >> 5);
  const int end = static_cast<int>(off & 31) + s.bits;  // <= 31 + 41 < 96
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int sh = 32 * (i + 1) - end;  // left shift placing the field's LSB
    if (sh >= 32) break;                // the field ended in an earlier word
    const unsigned w = sh >= 0 ? static_cast<unsigned>(s.value << sh)
                               : (-sh >= 64 ? 0u
                                            : static_cast<unsigned>(s.value >> -sh));
    if (w != 0u && w0 + i < n_words) atomicOr(words + w0 + i, __funnelshift_l(w, w, 16));
  }
}

template <int N2>
__global__ void __launch_bounds__(kThreads)
    encode_stripes_kernel(const uint8_t* __restrict__ px,
                          const uint4* __restrict__ frag,
                          const double* __restrict__ cert,
                          const float* __restrict__ parts_t,
                          const float* __restrict__ bias,
                          const float* __restrict__ recip,
                          const int* __restrict__ val_len,
                          const int* __restrict__ val_code, int n_val,
                          const int* __restrict__ run_len,
                          const int* __restrict__ run_code, int run_bits,
                          int mode, int dc_prediction, int bps,
                          unsigned* __restrict__ words, int n_words,
                          int* __restrict__ stripe_bits,
                          int* __restrict__ block_bits,
                          unsigned long long* __restrict__ rescued) {
  using S = Shape<N2>;
  using M = typename S::Mma;
  constexpr int T = S::kTile;
  extern __shared__ __align__(16) int smem[];
  int* s_tab = smem;
  int* s_val_len = s_tab;
  int* s_val_code = s_tab + kMaxValues;
  int* s_run_len = s_tab + 2 * kMaxValues;
  int* s_run_code = s_run_len + kRunAlphabet;
  int* s_bbits = s_tab + kTabInts;  // per-block bit totals of the tile
  int* s_boff = s_bbits + T;        // per-block exclusive bit offsets
  int* s_dc = s_boff + T;           // raw DCs of the tile
  int16_t* s_zz = reinterpret_cast<int16_t*>(s_dc + T);
  uint8_t* s_px = reinterpret_cast<uint8_t*>(s_zz + T * N2);  // packed rows
  uint16_t* s_list = reinterpret_cast<uint16_t*>(s_px + S::kRows * M::kStride);
  int* s_count = reinterpret_cast<int*>(s_list + T * N2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long stripe = blockIdx.x;
  const bool adaptive = recip != nullptr;
  unsigned* row = words + stripe * n_words;

  // ---- 0. zero this stripe's units; load tables ----
  for (int i = tid; i < n_words; i += kThreads) row[i] = 0u;
  for (int i = tid; i < n_val; i += kThreads) {
    s_val_len[i] = val_len[i];
    s_val_code[i] = val_code[i];
  }
  if (run_len != nullptr && tid < kRunAlphabet) {
    s_run_len[tid] = run_len[tid];
    s_run_code[tid] = run_code[tid];
  }
  const Tables tabs{s_val_len, s_val_code, s_run_len, s_run_code, mode,
                    run_bits, run_len != nullptr};

  int base_bits = 0;  // bits of the tiles before (warp 0 keeps it)
  int prev_dc = 0;    // raw DC of the block before the tile
  long long n_rescued = 0;  // coefficients the chain computed
  for (int t0 = 0; t0 < bps; t0 += T) {
    const int n = min(T, bps - t0);
    const long long blk = stripe * bps + t0;  // the tile's first block

    // ---- 1. pixels in, the certified transform (kernel A's tile) ----
    const uint4* src = reinterpret_cast<const uint4*>(px + blk * N2);
    for (int i = tid; i < n * N2 / 16; i += kThreads) {
      const int o = 16 * i;  // packed row o / P, byte o % P
      *reinterpret_cast<uint4*>(s_px + o / S::kP * M::kStride + o % S::kP) =
          __ldg(src + i);
    }
    if (tid == 0) *s_count = 0;
    __syncthreads();
    const float* rc = adaptive ? recip + blk : nullptr;
    SmemStore store{s_zz};
    dct::mma_tile<M>(s_px, frag,
                     [&](int r, int c, long long s0, long long s1) {
                       dct::certify_pair<N2, S::kP>(r, c, s0, s1, n, cert, rc,
                                                    s_list, s_count, store);
                     });
    __syncthreads();
    const int n_open = *s_count;
    dct::rescue_tile<N2, S::kP, M::kStride, kThreads>(
        s_list, n_open, s_px, parts_t, bias, rc, store);
    n_rescued += n_open;
    __syncthreads();

    // ---- 2. stripe-local DC DPCM against the previous block's raw DC ----
    if (dc_prediction) {
      for (int b = tid; b < n; b += kThreads) s_dc[b] = s_zz[b * N2];
      __syncthreads();
      for (int b = tid; b < n; b += kThreads)
        s_zz[b * N2] = static_cast<int16_t>(s_dc[b] - (b ? s_dc[b - 1] : prev_dc));
      __syncthreads();
      prev_dc = s_dc[n - 1];
    }

    // ---- 3. per block: RLE, fields, block bit totals ----
    for (int bw = warp * S::kPerWarp; bw < n; bw += kWarps * S::kPerWarp) {
      Symbol s[S::kV];
      block_symbols<N2>(s_zz, bw, n, lane, tabs, s);
      int tot = 0;
#pragma unroll
      for (int i = 0; i < S::kV; ++i) tot += s[i].bits;
#pragma unroll
      for (int d = S::kSeg / 2; d > 0; d >>= 1)
        tot += __shfl_xor_sync(kFull, tot, d);
      const int b = bw + lane / S::kSeg;
      if (lane % S::kSeg == 0 && b < n) {
        s_bbits[b] = tot;
        block_bits[blk + b] = tot;
      }
    }
    __syncthreads();

    // ---- 4. exclusive scan of the tile's block totals, on the base ----
    if (warp == 0) {
      for (int c = 0; c < n; c += 32) {
        const int idx = c + lane;
        const int v = idx < n ? s_bbits[idx] : 0;
        const int incl = seg_inclusive_scan<32>(v, lane);
        if (idx < n) s_boff[idx] = base_bits + incl - v;
        base_bits += __shfl_sync(kFull, incl, 31);
      }
    }
    __syncthreads();

    // ---- 5. per-symbol offsets (in-block scan) and placement ----
    for (int bw = warp * S::kPerWarp; bw < n; bw += kWarps * S::kPerWarp) {
      Symbol s[S::kV];
      block_symbols<N2>(s_zz, bw, n, lane, tabs, s);
      const int b = bw + lane / S::kSeg;
      long long off = b < n ? s_boff[b] : 0;
#pragma unroll
      for (int i = 0; i < S::kV; ++i) {
        const int incl = seg_inclusive_scan<S::kSeg>(s[i].bits, lane);
        place(s[i], off + incl - s[i].bits, row, n_words);
        off += __shfl_sync(kFull, incl, 31);  // kV > 1 only at n2 >= 64
      }
    }
    __syncthreads();  // the tile's buffers are free for the next one
  }
  if (tid == 0) {
    stripe_bits[stripe] = base_bits;
    if (n_rescued) atomicAdd(rescued, static_cast<unsigned long long>(n_rescued));
  }
}

template <int N2>
int launch(const void* px, const void* frag, const void* cert,
           const void* parts_t, const void* bias, const void* recip,
           const void* val_len, const void* val_code, int n_val,
           const void* run_len, const void* run_code, int run_bits, int mode,
           int dc_prediction, int n_stripes, int bps, void* words,
           int n_words, void* stripe_bits, void* block_bits, void* rescued,
           cudaStream_t stream) {
  constexpr int smem = Shape<N2>::kBytes;
  auto kernel = encode_stripes_kernel<N2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_stripes, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(px), static_cast<const uint4*>(frag),
      static_cast<const double*>(cert), static_cast<const float*>(parts_t),
      static_cast<const float*>(bias), static_cast<const float*>(recip),
      static_cast<const int*>(val_len), static_cast<const int*>(val_code),
      n_val, static_cast<const int*>(run_len),
      static_cast<const int*>(run_code), run_bits, mode, dc_prediction, bps,
      static_cast<unsigned*>(words), n_words, static_cast<int*>(stripe_bits),
      static_cast<int*>(block_bits),
      static_cast<unsigned long long*>(rescued));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DCT_EXPORT int dct_encode_stripes(const void* px, const void* frag,
                                  const void* cert, const void* parts_t,
                                  const void* bias, const void* recip,
                                  const void* val_len, const void* val_code,
                                  int n_val, const void* run_len,
                                  const void* run_code, int run_bits,
                                  int mode, int dc_prediction, int n2,
                                  int n_stripes, int bps, void* words,
                                  int n_words, void* stripe_bits,
                                  void* block_bits, void* rescued,
                                  void* stream) {
  if (n_val < 0 || n_val > kMaxValues || mode < kCategory || mode > kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_stripes == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
#define DCT_B(N)                                                              \
  return launch<N>(px, frag, cert, parts_t, bias, recip, val_len, val_code,  \
                   n_val, run_len, run_code, run_bits, mode, dc_prediction,   \
                   n_stripes, bps, words, n_words, stripe_bits, block_bits,   \
                   rescued, s)
  switch (n2) {
    case 16: DCT_B(16);
    case 64: DCT_B(64);
    case 256: DCT_B(256);
  }
#undef DCT_B
  return static_cast<int>(cudaErrorInvalidValue);
}

DCT_EXPORT const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
