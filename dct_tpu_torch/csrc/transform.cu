// Kernels A and C: the block transforms.
//
// A (encode) replaces dct_tpu/ops/transform_pallas.py `_encode_kernel` /
// `_encode_kernel_adaptive` (wrapper `encode_blocks_pallas`); C (decode)
// replaces `_decode_kernel` / `_decode_kernel_adaptive` (wrapper
// `decode_blocks_pallas`).
//
// What bounds them on an H100. Per 8x8 block A reads 64 B and writes
// 256 B for 3 x 64 x 64 multiply-adds (three chains over the bf16 split of
// the operator, in the order that keeps it bit-identical to kernel B:
// transform_core.cuh); C reads 128 B and writes 64 B for 64 x 64. That is
// 38 (A) and 21 (C) FMAs a byte, above the card's float32 rate over its
// memory rate (~10 a byte), so HBM is not the limit. The tensor cores stay
// out: they sum in an order of their own, A must keep giving B's integers,
// and C's coefficients need float32. On the CUDA cores two pipes bound
// them: the FMAs (128 a clock an SM) and the shared-memory loads that feed
// them, which cost the bytes they deliver to registers (128 B a clock an
// SM, broadcast or not). A thread that computes an R x C micro-tile loads
// R + C floats a step for R * C FMAs, so the loads take 4 (R + C) / (R * C)
// of the FMAs' time: 1.5x for C at 8 x 4, 1.33x for A at 4 x 4 (4 + 3 x 4
// floats for 48 FMAs). 8 x 8 would balance the two, but its tile's shared
// memory leaves one CTA an SM and it measured slower for C, as did 4 x 4;
// A's larger tiles need more than 128 registers.
//
// The design:
// - a persistent grid (two CTAs an SM) walks tiles of kBlocks blocks; each
//   CTA loads its operator(s) into shared memory once;
// - a tile's input arrives by cp.async (16 B a copy) into a ring of two
//   stages, so tile t+1 loads while tile t is staged and computed;
// - staging widens each input to float once (C also applies the adaptive
//   AC scale there) and stores it value-major — xT[j][b] for A, zT[k][b] for C — so that one
//   LDS.128 gives a thread four blocks' values. Ring rows are padded to an
//   odd number of 16-byte units, which keeps the staging reads free of bank
//   conflicts; the value-major writes go to consecutive words;
// - each thread computes an R-block x C-value micro-tile in registers. C:
//   8 blocks x 4 pixels, 32 FMAs for 3 LDS.128 a step of k. A: 4 blocks x 4
//   coefficients, 48 FMAs for 4 LDS.128 a step of j (split_matmul_tile);
// - stores are wide: C writes a thread's 4 pixels of a block as one 4-byte
//   word, A its 4 coefficients of a block as one 16-byte store.
// Every output keeps the arithmetic chain of the one-value-a-thread form:
// A split_matmul_coeff's, C z_k (AC scaled by one __fmul_rn) folded by
// __fmaf_rn over k = 0..n2-1 from 0, then + 128, round half away, clamp.
//
// A also takes 16x16 blocks (n2 = 256), which the reference's Pallas
// kernel does not (its codec runs them in XLA): kernel B takes them, and
// the analyze pass before B must give B's integers. That kernel
// (encode_blocks_256_kernel) runs B's 256 chain, split_matmul_256, with
// the operator read through L2. C stays at n2 4/16/64; 16x16 decode is
// the codec's float32 product.

#include "bindings.h"
#include "transform_core.cuh"

namespace {

constexpr int kThreads = 256;

// The tiles of one kernel: N2 values a block, IN_BYTES bytes an input
// value, R blocks x C values a thread.
template <int N2, int IN_BYTES, int R, int C>
struct Tiling {
  static constexpr int kR = R, kC = C;
  static constexpr int kGroups = N2 / C;  // threads sharing a block row
  static constexpr int kBlocks = kThreads / kGroups * R;  // blocks a tile
  static constexpr int kRowBytes = N2 * IN_BYTES;         // a block's input
  static constexpr int kRingRow =  // odd count of 16-byte units
      (kRowBytes >= 16 && (kRowBytes / 16) % 2 == 0) ? kRowBytes + 16
                                                     : kRowBytes;
  static constexpr int kRingBytes = kBlocks * kRingRow;   // one stage
  static constexpr int kChunk = kRowBytes < 16 ? kRowBytes : 16;  // a read
  static constexpr int kChunks = kRowBytes / kChunk;      // reads a row
  static constexpr int kValues = kChunk / IN_BYTES;       // values a read
  static_assert(N2 % C == 0 && kThreads % kGroups == 0, "tiling");
  static_assert(kBlocks * kRowBytes % 16 == 0, "16-byte copies");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying tile `tile` of `src` (n_blocks rows of kRowBytes) into a
// ring stage: 16-byte copies of the rows that exist, the last one cut
// short (cp.async fills the rest with zeros).
template <class G>
__device__ __forceinline__ void load_tile(uint8_t* stage,
                                          const uint8_t* __restrict__ src,
                                          long long tile, long long n_blocks) {
  const long long b0 = tile * G::kBlocks;
  const long long rows = n_blocks - b0 < G::kBlocks ? n_blocks - b0
                                                    : G::kBlocks;
  const int valid = static_cast<int>(rows) * G::kRowBytes;
  const uint8_t* base = src + b0 * G::kRowBytes;
  for (int off = threadIdx.x * 16; off < valid; off += kThreads * 16) {
    const int dst = off / G::kRowBytes * G::kRingRow + off % G::kRowBytes;
    cp_async16(stage + dst, base + off, valid - off < 16 ? valid - off : 16);
  }
}

// One staging read of BYTES (16, 8 or 4) from shared memory, as words.
template <int BYTES>
__device__ __forceinline__ void load_chunk(unsigned (&w)[BYTES / 4],
                                           const uint8_t* src) {
  if constexpr (BYTES == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x, w[1] = v.y;
  } else {
    static_assert(BYTES == 4, "staging reads of 16, 8 or 4 bytes");
    w[0] = *reinterpret_cast<const unsigned*>(src);
  }
}

template <int N2>
__device__ __forceinline__ void load_operator(float* dst, const float* src,
                                              int ld) {
  for (int i = threadIdx.x; i < N2 * N2; i += kThreads)
    dst[i] = src[(i / N2) * ld + (i % N2)];
}

// As many CTAs as fit on every SM, and no more than there are tiles.
template <class Kernel>
int grid_for(Kernel kernel, int smem, long long n_tiles) {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const long long g = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(n_tiles < g ? n_tiles : g);
}

// ---- kernel A ---------------------------------------------------------

template <int N2>
using EncTiling = Tiling<N2, 1, 4, 4>;

template <int N2>
constexpr int encode_smem() {
  using G = EncTiling<N2>;
  return 2 * G::kRingBytes + (3 * N2 * N2 + N2 * G::kBlocks + N2) * 4;
}

template <int N2, bool ADAPTIVE>
__global__ void __launch_bounds__(kThreads, 2)
    encode_blocks_kernel(const uint8_t* __restrict__ px,
                         const float* __restrict__ m0,
                         const float* __restrict__ m1,
                         const float* __restrict__ m2,
                         const float* __restrict__ bias, int ld,
                         const float* __restrict__ recip,
                         int32_t* __restrict__ out, long long n_blocks) {
  using G = EncTiling<N2>;
  constexpr int T = G::kBlocks, kR = G::kR, kC = G::kC;
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_m0 = reinterpret_cast<float*>(smem + 2 * G::kRingBytes);
  float* s_m1 = s_m0 + N2 * N2;
  float* s_m2 = s_m1 + N2 * N2;
  float* xT = s_m2 + N2 * N2;  // (N2, T): pixel j of block b at xT[j*T+b]
  float* s_b = xT + N2 * T;
  load_operator<N2>(s_m0, m0, ld);
  load_operator<N2>(s_m1, m1, ld);
  load_operator<N2>(s_m2, m2, ld);
  for (int i = threadIdx.x; i < N2; i += kThreads) s_b[i] = bias[i];

  const int k0 = threadIdx.x % G::kGroups * kC;  // this thread's tile
  const int r0 = threadIdx.x / G::kGroups * kR;
  const long long n_tiles = (n_blocks + T - 1) / T;
  long long t = blockIdx.x;
  if (t < n_tiles) load_tile<G>(smem, px, t, n_blocks);
  cp_async_commit();
  for (int s = 0; t < n_tiles; t += gridDim.x, s ^= 1) {
    if (t + gridDim.x < n_tiles)
      load_tile<G>(smem + (s ^ 1) * G::kRingBytes, px, t + gridDim.x,
                   n_blocks);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // everyone's have, and tile t-1 is computed
    const long long b0 = t * T;
    const int n = static_cast<int>(n_blocks - b0 < T ? n_blocks - b0 : T);
    for (int i = threadIdx.x; i < T * G::kChunks; i += kThreads) {
      const int b = i % T, ch = i / T;
      unsigned w[G::kChunk / 4] = {};
      if (b < n)
        load_chunk<G::kChunk>(w, smem + s * G::kRingBytes + b * G::kRingRow +
                                     ch * G::kChunk);
#pragma unroll
      for (int e = 0; e < G::kValues; ++e)
        xT[(ch * G::kValues + e) * T + b] =
            static_cast<float>((w[e / 4] >> (8 * (e % 4))) & 0xFFu);
    }
    __syncthreads();

    float y[kR][kC];
    dct::split_matmul_tile<N2, kR, kC>(xT + r0, T, s_m0, s_m1, s_m2, s_b,
                                       k0, y);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r0 + r >= n) break;
      const long long b = b0 + r0 + r;
      const float rr = ADAPTIVE ? recip[b] : 1.f;
#pragma unroll
      for (int c = 0; c < kC; c += 4) {
        int4 q;
        q.x = dct::quantize_coeff(y[r][c], k0 + c, ADAPTIVE, rr);
        q.y = dct::quantize_coeff(y[r][c + 1], k0 + c + 1, ADAPTIVE, rr);
        q.z = dct::quantize_coeff(y[r][c + 2], k0 + c + 2, ADAPTIVE, rr);
        q.w = dct::quantize_coeff(y[r][c + 3], k0 + c + 3, ADAPTIVE, rr);
        *reinterpret_cast<int4*>(out + b * N2 + k0 + c) = q;
      }
    }
  }
}

// ---- kernel A at n2 = 256 ---------------------------------------------
// 16x16 blocks: the (256, 256) operator parts do not fit the tile above's
// shared memory (768 KB), so this kernel reads them through L2 by
// dct::split_matmul_256, the chain kernel B runs at n2 = 256. A grid-
// stride loop walks tiles of k256Tile blocks; each tile's pixels are
// staged as float, and thread k computes coefficient k of every block of
// the tile (three L2 loads a step of j for 3 x k256Tile FMAs), storing
// them as consecutive int32s.

constexpr int k256Tile = 8;

template <bool ADAPTIVE>
__global__ void __launch_bounds__(kThreads, 2)
    encode_blocks_256_kernel(const uint8_t* __restrict__ px,
                             const float* __restrict__ m0,
                             const float* __restrict__ m1,
                             const float* __restrict__ m2,
                             const float* __restrict__ bias, int ld,
                             const float* __restrict__ recip,
                             int32_t* __restrict__ out, long long n_blocks) {
  static_assert(kThreads == dct::kN2Big, "a thread a coefficient");
  constexpr int T = k256Tile, N2 = dct::kN2Big;
  __shared__ __align__(16) float xT[N2 * T];  // pixel j of block r at xT[j*T+r]
  const int k = threadIdx.x;
  const long long n_tiles = (n_blocks + T - 1) / T;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long b0 = t * T;
    const int n = static_cast<int>(n_blocks - b0 < T ? n_blocks - b0 : T);
    __syncthreads();  // the tile before is computed
    dct::stage_pixels_256<T, kThreads>(xT, px + b0 * N2, n);
    __syncthreads();
    float y[T];
    dct::split_matmul_256<T>(xT, m0, m1, m2, bias, ld, k, y);
#pragma unroll
    for (int r = 0; r < T; ++r) {
      if (r >= n) break;
      const float rr = ADAPTIVE ? recip[b0 + r] : 1.f;
      out[(b0 + r) * N2 + k] = dct::quantize_coeff(y[r], k, ADAPTIVE, rr);
    }
  }
}

template <bool ADAPTIVE>
int launch_encode_256(const void* px, const void* m0, const void* m1,
                      const void* m2, const void* bias, int ld,
                      const void* recip, void* out, long long n_blocks,
                      cudaStream_t stream) {
  auto kernel = encode_blocks_256_kernel<ADAPTIVE>;
  kernel<<<grid_for(kernel, 0, (n_blocks + k256Tile - 1) / k256Tile),
           kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(px), static_cast<const float*>(m0),
      static_cast<const float*>(m1), static_cast<const float*>(m2),
      static_cast<const float*>(bias), ld, static_cast<const float*>(recip),
      static_cast<int32_t*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// ---- kernel C ---------------------------------------------------------

// The pixel of y: round_half_away(y + 128) clamped to [0, 255], in fewer
// instructions. For y + 128 >= 0 the add of 0.5 is round_half_away's own;
// below 0 both give at most 0 after the clamp. The conversion truncates
// and takes negatives to 0.
__device__ __forceinline__ unsigned pixel(float y) {
  const float t = __fadd_rn(__fadd_rn(y, 128.f), 0.5f);
  return __float2uint_rz(fminf(t, 255.f));
}

template <int N2>
using DecTiling = Tiling<N2, 2, 8, 4>;

template <int N2>
constexpr int decode_smem() {
  using G = DecTiling<N2>;
  return 2 * G::kRingBytes + (N2 * N2 + N2 * G::kBlocks) * 4;
}

template <int N2, bool ADAPTIVE>
__global__ void __launch_bounds__(kThreads, 2)
    decode_blocks_kernel(const int16_t* __restrict__ zz,
                         const float* __restrict__ m_dec, int ld,
                         const float* __restrict__ scale,
                         uint8_t* __restrict__ out, long long n_blocks) {
  using G = DecTiling<N2>;
  constexpr int T = G::kBlocks, kR = G::kR, kC = G::kC;
  extern __shared__ __align__(16) uint8_t smem[];
  // row k = coefficient, column j = pixel
  float* s_m = reinterpret_cast<float*>(smem + 2 * G::kRingBytes);
  float* zT = s_m + N2 * N2;  // (N2, T): coefficient k of block b at zT[k*T+b]
  load_operator<N2>(s_m, m_dec, ld);

  const int j0 = threadIdx.x % G::kGroups * kC;  // this thread's tile
  const int r0 = threadIdx.x / G::kGroups * kR;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(zz);
  const long long n_tiles = (n_blocks + T - 1) / T;
  long long t = blockIdx.x;
  if (t < n_tiles) load_tile<G>(smem, src, t, n_blocks);
  cp_async_commit();
  for (int s = 0; t < n_tiles; t += gridDim.x, s ^= 1) {
    if (t + gridDim.x < n_tiles)
      load_tile<G>(smem + (s ^ 1) * G::kRingBytes, src, t + gridDim.x,
                   n_blocks);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const long long b0 = t * T;
    const int n = static_cast<int>(n_blocks - b0 < T ? n_blocks - b0 : T);
    for (int i = threadIdx.x; i < T * G::kChunks; i += kThreads) {
      const int b = i % T, ch = i / T;
      unsigned w[G::kChunk / 4] = {};
      float sc = 1.f;
      if (b < n) {
        load_chunk<G::kChunk>(w, smem + s * G::kRingBytes + b * G::kRingRow +
                                     ch * G::kChunk);
        if (ADAPTIVE) sc = scale[b0 + b];
      }
#pragma unroll
      for (int e = 0; e < G::kValues; ++e) {
        float z = static_cast<float>(
            static_cast<int16_t>(w[e / 2] >> (16 * (e % 2))));
        // dequant scale on AC only, one multiply (reference op order)
        if (ADAPTIVE && ch * G::kValues + e != 0) z = __fmul_rn(z, sc);
        zT[(ch * G::kValues + e) * T + b] = z;
      }
    }
    __syncthreads();

    float y[kR][kC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) y[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N2; ++k) {
      float z[kR], w[kC];
      dct::load_f32x4(z, zT + k * T + r0);
      dct::load_f32x4(w, s_m + k * N2 + j0);
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          y[r][c] = __fmaf_rn(z[r], w[c], y[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r0 + r >= n) break;
      static_assert(kC == 4, "a thread's pixels of a block are one word");
      unsigned word = 0;
#pragma unroll
      for (int c = 0; c < kC; ++c) word |= pixel(y[r][c]) << (8 * c);
      *reinterpret_cast<unsigned*>(out + (b0 + r0 + r) * N2 + j0) = word;
    }
  }
}

template <int N2, bool ADAPTIVE>
int launch_encode(const void* px, const void* m0, const void* m1,
                  const void* m2, const void* bias, int ld, const void* recip,
                  void* out, long long n_blocks, cudaStream_t stream) {
  constexpr int smem = encode_smem<N2>();
  auto kernel = encode_blocks_kernel<N2, ADAPTIVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int T = EncTiling<N2>::kBlocks;
  kernel<<<grid_for(kernel, smem, (n_blocks + T - 1) / T), kThreads, smem,
           stream>>>(
      static_cast<const uint8_t*>(px), static_cast<const float*>(m0),
      static_cast<const float*>(m1), static_cast<const float*>(m2),
      static_cast<const float*>(bias), ld, static_cast<const float*>(recip),
      static_cast<int32_t*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <int N2, bool ADAPTIVE>
int launch_decode(const void* zz, const void* m_dec, int ld,
                  const void* scale, void* out, long long n_blocks,
                  cudaStream_t stream) {
  constexpr int smem = decode_smem<N2>();
  auto kernel = decode_blocks_kernel<N2, ADAPTIVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int T = DecTiling<N2>::kBlocks;
  kernel<<<grid_for(kernel, smem, (n_blocks + T - 1) / T), kThreads, smem,
           stream>>>(
      static_cast<const int16_t*>(zz), static_cast<const float*>(m_dec), ld,
      static_cast<const float*>(scale), static_cast<uint8_t*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DCT_EXPORT int dct_encode_blocks(const void* px, const void* m0,
                                 const void* m1, const void* m2,
                                 const void* bias, int ld, const void* recip,
                                 void* out, long long n_blocks, int n2,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool ad = recip != nullptr;
#define DCT_ENC(N)                                                          \
  return ad ? launch_encode<N, true>(px, m0, m1, m2, bias, ld, recip, out, \
                                     n_blocks, s)                          \
            : launch_encode<N, false>(px, m0, m1, m2, bias, ld, recip, out, \
                                      n_blocks, s)
  switch (n2) {
    case 4: DCT_ENC(4);
    case 16: DCT_ENC(16);
    case 64: DCT_ENC(64);
    case 256:
      return ad ? launch_encode_256<true>(px, m0, m1, m2, bias, ld, recip, out,
                                         n_blocks, s)
                : launch_encode_256<false>(px, m0, m1, m2, bias, ld, recip,
                                           out, n_blocks, s);
  }
#undef DCT_ENC
  return static_cast<int>(cudaErrorInvalidValue);
}

DCT_EXPORT int dct_decode_blocks(const void* zz, const void* m_dec, int ld,
                                 const void* scale, void* out,
                                 long long n_blocks, int n2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool ad = scale != nullptr;
#define DCT_DEC(N)                                                          \
  return ad ? launch_decode<N, true>(zz, m_dec, ld, scale, out, n_blocks, s) \
            : launch_decode<N, false>(zz, m_dec, ld, scale, out, n_blocks, s)
  switch (n2) {
    case 4: DCT_DEC(4);
    case 16: DCT_DEC(16);
    case 64: DCT_DEC(64);
  }
#undef DCT_DEC
  return static_cast<int>(cudaErrorInvalidValue);
}

DCT_EXPORT const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
