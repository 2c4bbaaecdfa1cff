// Kernel B: the fused stripe encode — u8 pixel blocks to packed bitstream
// units, one CTA per (frame, stripe).
//
// Replaces dct_tpu/ops/fused_encode_pallas.py `_fused_kernel` (wrapper
// `encode_stripes_fused`) for 8x8 blocks in category mode, with the fixed
// or the coded run field, adaptive quantization and DC prediction on or
// off. It ports the outputs, not the TPU mechanism: the pack-tier ladder,
// the acc4 rungs, lane compaction and the one-hot MXU scatter were
// workarounds for a machine without per-lane scatter or cumsum.
//
// What bounds it on an H100: HBM sees 64 B of pixels in per block and the
// worst-case unit buffer (320 B per block, zeroed by the CTA itself) out,
// so bytes are small; the time goes to the transform's 3 x 64 x 64 f32
// multiply-adds per block, fed from shared memory, then to the serial
// dependencies of the entropy stage inside a stripe (a scan over the
// stripe's blocks and one over each block's symbols). The design keeps a
// whole stripe in shared memory (operator parts, pixels, int16
// coefficients: ~98 KB at 240 blocks, so two CTAs per SM), runs the
// transform through the device function kernel A uses
// (transform_core.cuh), and does each block's RLE, fields and scans in
// one warp with ballots and shuffles. Symbols are placed with atomicOr:
// each field (code | extra | run, <= 39 bits) touches at most three
// 32-bit words and fields never share a bit, so the result does not
// depend on the order of the atomics.

#include "bindings.h"
#include "transform_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kN2 = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Symbol {
  unsigned long long value;  // code | extra | run, MSB first
  int bits;                  // 0 for a position that emits nothing
};

// Positional RLE (dct_tpu/ops/rle.py rle_encode_positional) and the
// category-mode fields (dct_tpu/ops/bitstream.py symbol_chunks) of
// zigzag position p holding v; nz has bit q set where position q != 0.
__device__ __forceinline__ Symbol make_symbol(
    int v, int p, unsigned long long nz, const int* cat_len,
    const int* cat_code, const int* run_len, const int* run_code,
    bool coded_runs, int run_bits) {
  Symbol s{0ull, 0};
  const bool is_nz = v != 0, last = p == kN2 - 1;
  if (!is_nz && !last) return s;
  const unsigned long long below = nz & ((1ull << p) - 1ull);
  const int pnz = below ? 63 - __clzll(below) : -1;
  const int run = p - pnz - 1 + ((last && !is_nz) ? 1 : 0);
  const int a = v < 0 ? -v : v;
  const int cat = min(a ? 32 - __clz(a) : 0, 15);
  const unsigned span = (1u << cat) - 1u;
  const unsigned extra = static_cast<unsigned>(v < 0 ? v + (int)span : v) & span;
  int lc;
  unsigned rv;
  if (coded_runs) {
    lc = run_len[run];
    rv = static_cast<unsigned>(run_code[run]);
  } else {
    lc = run_bits;
    rv = static_cast<unsigned>(run);
  }
  const unsigned long long code = static_cast<unsigned>(cat_code[cat]);
  s.value = (((code << cat) | extra) << lc) | rv;
  s.bits = cat_len[cat] + cat + lc;
  return s;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// OR a field of s.bits bits into the MSB-first word stream at bit `off`.
// Words are stored with their 16-bit halves swapped (see bindings.h).
__device__ __forceinline__ void place(Symbol s, long long off,
                                      unsigned* words, int n_words) {
  if (s.bits == 0) return;
  const int w0 = static_cast<int>(off >> 5);
  const int end = static_cast<int>(off & 31) + s.bits;  // <= 31 + 39
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

__global__ void __launch_bounds__(kThreads)
    encode_stripes_kernel(const uint8_t* __restrict__ px,
                          const float* __restrict__ m0,
                          const float* __restrict__ m1,
                          const float* __restrict__ m2,
                          const float* __restrict__ bias, int ld,
                          const float* __restrict__ recip,
                          const int* __restrict__ cat_len,
                          const int* __restrict__ cat_code,
                          const int* __restrict__ run_len,
                          const int* __restrict__ run_code, int run_bits,
                          int dc_prediction, int bps,
                          unsigned* __restrict__ words, int n_words,
                          int* __restrict__ stripe_bits,
                          int* __restrict__ block_bits) {
  extern __shared__ float smem[];
  float* s_m0 = smem;
  float* s_m1 = s_m0 + kN2 * kN2;
  float* s_m2 = s_m1 + kN2 * kN2;
  float* s_b = s_m2 + kN2 * kN2;
  int* s_tab = reinterpret_cast<int*>(s_b + kN2);  // 16 + 16 + 65 + 65
  int* s_cat_len = s_tab;
  int* s_cat_code = s_tab + 16;
  int* s_run_len = s_tab + 32;
  int* s_run_code = s_tab + 97;
  int* s_bbits = s_tab + 162;        // per-block bit totals
  int* s_boff = s_bbits + bps;       // per-block exclusive bit offsets
  int16_t* s_zz = reinterpret_cast<int16_t*>(s_boff + bps);
  uint8_t* s_px = reinterpret_cast<uint8_t*>(s_zz + bps * kN2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long stripe = blockIdx.x;
  const bool adaptive = recip != nullptr;
  const bool coded_runs = run_len != nullptr;
  unsigned* row = words + stripe * n_words;
  const long long blk0 = stripe * bps;

  // ---- 0. zero this stripe's units; load operators, tables, pixels ----
  for (int i = tid; i < n_words; i += kThreads) row[i] = 0u;
  for (int i = tid; i < kN2 * kN2; i += kThreads) {
    const int src = (i / kN2) * ld + (i % kN2);
    s_m0[i] = m0[src];
    s_m1[i] = m1[src];
    s_m2[i] = m2[src];
  }
  if (tid < kN2) s_b[tid] = bias[tid];
  if (tid < 16) {
    s_cat_len[tid] = cat_len[tid];
    s_cat_code[tid] = cat_code[tid];
  }
  if (coded_runs && tid < 65) {
    s_run_len[tid] = run_len[tid];
    s_run_code[tid] = run_code[tid];
  }
  const uint8_t* spx = px + blk0 * kN2;
  for (int i = tid; i < bps * kN2; i += kThreads) s_px[i] = spx[i];
  __syncthreads();

  // ---- 1. transform (kernel A's device function) ----
  for (int i = tid; i < bps * kN2; i += kThreads) {
    const int b = i >> 6, k = i & 63;
    const float y = dct::split_matmul_coeff<kN2>(s_px + b * kN2, s_m0, s_m1,
                                                 s_m2, s_b, k);
    const float r = adaptive ? recip[blk0 + b] : 1.f;
    s_zz[i] = static_cast<int16_t>(dct::quantize_coeff(y, k, adaptive, r));
  }
  __syncthreads();

  // ---- 2. stripe-local DC DPCM against the previous block's raw DC ----
  if (dc_prediction) {
    for (int b = tid; b < bps; b += kThreads)
      s_boff[b] = b ? s_zz[(b - 1) * kN2] : 0;
    __syncthreads();
    for (int b = tid; b < bps; b += kThreads)
      s_zz[b * kN2] = static_cast<int16_t>(s_zz[b * kN2] - s_boff[b]);
    __syncthreads();
  }

  // ---- 3-6a. per block (one warp): RLE, fields, block bit totals ----
  for (int b = warp; b < bps; b += kWarps) {
    const int v0 = s_zz[b * kN2 + lane], v1 = s_zz[b * kN2 + 32 + lane];
    const unsigned long long nz =
        static_cast<unsigned long long>(__ballot_sync(kFull, v1 != 0)) << 32 |
        __ballot_sync(kFull, v0 != 0);
    const Symbol s0 = make_symbol(v0, lane, nz, s_cat_len, s_cat_code,
                                  s_run_len, s_run_code, coded_runs, run_bits);
    const Symbol s1 = make_symbol(v1, lane + 32, nz, s_cat_len, s_cat_code,
                                  s_run_len, s_run_code, coded_runs, run_bits);
    int t = s0.bits + s1.bits;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) t += __shfl_xor_sync(kFull, t, d);
    if (lane == 0) {
      s_bbits[b] = t;
      block_bits[blk0 + b] = t;
    }
  }
  __syncthreads();

  // ---- 6b. exclusive scan of block totals over the stripe ----
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < bps; base += 32) {
      const int idx = base + lane;
      const int v = idx < bps ? s_bbits[idx] : 0;
      const int incl = warp_inclusive_scan(v, lane);
      if (idx < bps) s_boff[idx] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) stripe_bits[stripe] = carry;
  }
  __syncthreads();

  // ---- 6c-8. per-symbol offsets (in-block scan) and placement ----
  for (int b = warp; b < bps; b += kWarps) {
    const int v0 = s_zz[b * kN2 + lane], v1 = s_zz[b * kN2 + 32 + lane];
    const unsigned long long nz =
        static_cast<unsigned long long>(__ballot_sync(kFull, v1 != 0)) << 32 |
        __ballot_sync(kFull, v0 != 0);
    const Symbol s0 = make_symbol(v0, lane, nz, s_cat_len, s_cat_code,
                                  s_run_len, s_run_code, coded_runs, run_bits);
    const Symbol s1 = make_symbol(v1, lane + 32, nz, s_cat_len, s_cat_code,
                                  s_run_len, s_run_code, coded_runs, run_bits);
    const int i0 = warp_inclusive_scan(s0.bits, lane);
    const int half = __shfl_sync(kFull, i0, 31);
    const int i1 = warp_inclusive_scan(s1.bits, lane);
    const long long base = s_boff[b];
    place(s0, base + i0 - s0.bits, row, n_words);
    place(s1, base + half + i1 - s1.bits, row, n_words);
  }
}

// Dynamic shared memory for a stripe of bps blocks: operator parts and
// bias, tables, per-block bits and offsets, int16 coefficients, pixels.
long long smem_bytes(int bps) {
  return (3LL * kN2 * kN2 + kN2) * sizeof(float) + 162LL * sizeof(int) +
         2LL * bps * sizeof(int) + static_cast<long long>(bps) * kN2 *
         (sizeof(int16_t) + sizeof(uint8_t));
}

}  // namespace

DCT_EXPORT int dct_encode_stripes(const void* px, const void* m0,
                                  const void* m1, const void* m2,
                                  const void* bias, int ld, const void* recip,
                                  const void* cat_len, const void* cat_code,
                                  const void* run_len, const void* run_code,
                                  int run_bits, int dc_prediction,
                                  int n_stripes, int bps, void* words,
                                  int n_words, void* stripe_bits,
                                  void* block_bits, void* stream) {
  const long long need = smem_bytes(bps);
  if (need > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(need);
  cudaError_t err = cudaFuncSetAttribute(
      encode_stripes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  encode_stripes_kernel<<<n_stripes, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(px), static_cast<const float*>(m0),
      static_cast<const float*>(m1), static_cast<const float*>(m2),
      static_cast<const float*>(bias), ld, static_cast<const float*>(recip),
      static_cast<const int*>(cat_len), static_cast<const int*>(cat_code),
      static_cast<const int*>(run_len), static_cast<const int*>(run_code),
      run_bits, dc_prediction, bps, static_cast<unsigned*>(words), n_words,
      static_cast<int*>(stripe_bits), static_cast<int*>(block_bits));
  return static_cast<int>(cudaGetLastError());
}

DCT_EXPORT const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
