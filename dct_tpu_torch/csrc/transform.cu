// Kernels A and C: the block transforms.
//
// A (encode) replaces dct_tpu/ops/transform_pallas.py `_encode_kernel` /
// `_encode_kernel_adaptive` (wrapper `encode_blocks_pallas`); C (decode)
// replaces `_decode_kernel` / `_decode_kernel_adaptive` (wrapper
// `decode_blocks_pallas`).
//
// What bounds them on an H100. Per 8x8 block A reads 64 B and writes
// 256 B of int32 coefficients; its arithmetic runs on the integer tensor
// cores (4 x 64 x 64 int8 multiply-adds a block over the operator's byte
// planes, a few microseconds at the batch) with an integer rounding
// certificate a coefficient (transform_core.cuh), so HBM bounds it, the
// int32 output 80 % of its bytes. C reads 128 B and
// writes 64 B for 64 x 64 float32 multiply-adds, 21 a byte, above the
// card's float32 rate over its memory rate (~10 a byte), so HBM is not
// its limit: C stays on the CUDA cores, as its coefficients need float32,
// bound by the FMAs (128 a clock an SM) and the shared-memory loads that
// feed them, which cost the bytes they deliver to registers (128 B a clock
// an SM, broadcast or not). A thread that computes an R x C micro-tile
// loads R + C floats a step for R * C FMAs, 1.5x the FMAs' time at C's
// 8 x 4; 8 x 8 would balance the two, but its tile's shared memory leaves
// one CTA an SM and it measured slower, as did 4 x 4.
//
// The design:
// - a persistent grid (three CTAs an SM for A below n2 = 256, measured
//   faster than two; two otherwise) walks tiles; a tile's input arrives
//   by cp.async (16 B a copy) into a ring of two stages, so tile t+1
//   loads while tile t is computed;
// - A: the ring holds packed rows of P = max(n2, 32) pixels (32 / n2
//   blocks a row below 32) padded to P + 16 bytes, which the tensor-core
//   tile of transform_core.cuh (the one kernel B runs) reads in place: the
//   integer products, the certificate, 8-byte stores of each coefficient
//   pair straight to device memory (a warp's fill whole 32-byte sectors
//   and overlap the products), then the tile's rescue list (the float32
//   chain itself for the coefficients the certificate leaves open) worked
//   through by the whole CTA, overwriting its values. A warp's fragments
//   and per-column constants stay in registers for the whole grid below
//   n2 = 256. Two barriers a tile, a third only where a coefficient is
//   open. Staging the int32 tile in shared memory and writing it out
//   whole measured slower (PERF.md section 6), with 16-byte stores after
//   the rescue or with a bulk copy a row by the tensor memory accelerator
//   running on into the next tile: the 8-byte stores already fill whole
//   sectors and overlap the products, and a staged tile costs shared
//   memory the L1 cache (the rescue's operand) or the tile size pays
//   for. Tiles of 128 packed rows at n2 4/16/64,
//   64 at 256, whose byte planes (256 KB) are read through L2 once per
//   tile and warp for the warp's 64 blocks;
// - C: staging widens each coefficient to float once (applying the
//   adaptive AC scale there) and stores it value-major — zT[k][b] — so
//   that one LDS.128 gives a thread four blocks' values. Ring rows are
//   padded to an odd number of 16-byte units, which keeps the staging
//   reads free of bank conflicts; each thread computes an 8-block x
//   4-pixel micro-tile in registers, 32 FMAs for 3 LDS.128 a step of k,
//   and writes a block's 4 pixels as one 4-byte word. Each output keeps
//   the chain of the one-value-a-thread form: z_k (AC scaled by one
//   __fmul_rn) folded by __fmaf_rn over k = 0..n2-1 from 0, then + 128,
//   round half away, clamp.
//
// A takes 16x16 blocks (n2 = 256), which the reference's Pallas kernel
// does not (its codec runs them in XLA): kernel B takes them, and the
// analyze pass before B must give B's integers. C stays at n2 4/16/64;
// 16x16 decode is the codec's float32 product.

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
struct EncShape {
  static constexpr int kP = N2 < 32 ? 32 : N2;           // a packed row
  static constexpr int kRows = kP == 256 ? 64 : 128;     // packed rows a tile
  static constexpr int kBlocks = kRows * kP / N2;        // blocks a tile
  // two m-tiles a group below 256, one under adaptive quantization, whose
  // scaled certificate needs the registers (with two, n2 64 spills)
  template <bool ADAPTIVE>
  using Mma = dct::MmaTile<kP, kRows, kP == 256 ? 4 : ADAPTIVE ? 1 : 2,
                           kThreads>;
  static constexpr int kStride = Mma<false>::kStride;    // a packed row's bytes
  static constexpr int kStage = kRows * kStride;         // one ring stage
  static constexpr int kListBytes = kRows * kP * 2;      // uint16 indices
  static constexpr int kBytes = 2 * kStage + kListBytes + 16;
  static_assert(kStage % 16 == 0, "16-byte copies");
};

// Start copying tile `tile` of the (n_blocks, N2) pixels into a ring
// stage as packed rows: 16-byte copies of the bytes that exist, the last
// one cut short (cp.async fills the rest with zeros).
template <int N2>
__device__ __forceinline__ void load_packed(uint8_t* stage,
                                            const uint8_t* __restrict__ src,
                                            long long tile,
                                            long long n_blocks) {
  using E = EncShape<N2>;
  const long long b0 = tile * E::kBlocks;
  const long long rows = n_blocks - b0 < E::kBlocks ? n_blocks - b0
                                                    : E::kBlocks;
  const int valid = static_cast<int>(rows) * N2;
  const uint8_t* base = src + b0 * N2;
  for (int off = threadIdx.x * 16; off < valid; off += kThreads * 16)
    cp_async16(stage + off / E::kP * E::kStride + off % E::kP,
               base + off, valid - off < 16 ? valid - off : 16);
}

// Coefficients of the certified tile straight to device memory: a warp's
// 8-byte pair stores fill whole 32-byte sectors (eight rows of four
// pairs), interleaved with the products.
struct GlobalStore {
  int32_t* out;  // the tile's first block
  __device__ __forceinline__ void pair(int idx, int q0, int q1) {
    *reinterpret_cast<int2*>(out + idx) = make_int2(q0, q1);
  }
  __device__ __forceinline__ void one(int idx, int q) { out[idx] = q; }
};

template <int N2, bool ADAPTIVE>
__global__ void __launch_bounds__(kThreads, EncShape<N2>::kP == 256 ? 2 : 3)
    encode_blocks_kernel(const uint8_t* __restrict__ px,
                         const uint4* __restrict__ frag,
                         const int4* __restrict__ cert,
                         const float* __restrict__ parts,
                         const float* __restrict__ bias,
                         const float* __restrict__ recip,
                         int32_t* __restrict__ out, long long n_blocks,
                         unsigned long long* __restrict__ rescued) {
  using E = EncShape<N2>;
  using M = typename E::template Mma<ADAPTIVE>;
  using Ops = dct::TileOperands<M>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s_list = reinterpret_cast<uint16_t*>(smem + 2 * E::kStage);
  int* s_count = reinterpret_cast<int*>(s_list + E::kRows * E::kP);  // 2
  const long long n_tiles = (n_blocks + E::kBlocks - 1) / E::kBlocks;
  long long t = blockIdx.x, n_rescued = 0;
  if (threadIdx.x < 2) s_count[threadIdx.x] = 0;
  Ops ops{frag, cert};
  if constexpr (Ops::kHeld) ops.load(threadIdx.x / 32 % M::kWN);
  if (t < n_tiles) load_packed<N2>(smem, px, t, n_blocks);
  cp_async_commit();
  for (int s = 0; t < n_tiles; t += gridDim.x, s ^= 1) {
    if (t + gridDim.x < n_tiles)
      load_packed<N2>(smem + (s ^ 1) * E::kStage, px, t + gridDim.x,
                      n_blocks);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // everyone's have, and tile t-1 is done
    // tile t-1's count (read by all before the barrier) is tile t+1's
    if (threadIdx.x == 0) s_count[s ^ 1] = 0;
    const long long b0 = t * E::kBlocks;
    const int n = static_cast<int>(n_blocks - b0 < E::kBlocks ? n_blocks - b0
                                                              : E::kBlocks);
    const uint8_t* stage = smem + s * E::kStage;
    const float* rc = ADAPTIVE ? recip + b0 : nullptr;
    GlobalStore store{out + b0 * N2};
    dct::mma_tile<M>(stage, ops, s_list, s_count + s,
                     [&](int r, int c, const int(&a)[2][4],
                         const dct::ColumnCert(&cc)[2]) {
                       return dct::certify_pair<N2, E::kP>(r, c, a, cc, n, rc,
                                                           store);
                     });
    __syncthreads();  // the list is complete
    const int n_open = s_count[s];
    if (n_open) {  // the same on every thread
      dct::rescue_tile<N2, E::kP, M::kStride, kThreads>(
          s_list, n_open, stage, parts, bias, rc, store);
      n_rescued += n_open;
      __syncthreads();  // the stage is free
    }
  }
  if (threadIdx.x == 0 && n_rescued)
    atomicAdd(rescued, static_cast<unsigned long long>(n_rescued));
}

// The tile's integer products alone, for testing mma_tile and the
// certificate's plane combine: (n_rows, P) packed u8 rows -> (n_rows, P)
// int64 x @ W (fixed_point with no constant and no shift), 64 rows a CTA.
template <int P>
__global__ void __launch_bounds__(kThreads)
    mma_products_kernel(const uint8_t* __restrict__ px,
                        const uint4* __restrict__ frag,
                        long long* __restrict__ out, int n_rows) {
  constexpr int TR = 64;
  using M = dct::MmaTile<P, TR, P == 256 ? 4 : 2, kThreads>;
  using Ops = dct::TileOperands<M>;
  __shared__ __align__(16) uint8_t s_px[TR * M::kStride];
  const long long r0 = static_cast<long long>(blockIdx.x) * TR;
  const int rows = n_rows - r0 < TR ? static_cast<int>(n_rows - r0) : TR;
  for (int i = threadIdx.x; i < TR * P / 16; i += kThreads) {
    const int r = i * 16 / P, col = i * 16 % P;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      v = *reinterpret_cast<const uint4*>(px + (r0 + r) * P + col);
    *reinterpret_cast<uint4*>(s_px + r * M::kStride + col) = v;
  }
  __syncthreads();
  Ops ops{frag, nullptr};
  if constexpr (Ops::kHeld) ops.load(threadIdx.x / 32 % M::kWN);
  const dct::ColumnCert exact{0, 0, 0u, 0u, 0.f};
  dct::mma_tile<M>(s_px, ops, nullptr, nullptr,
                   [&](int r, int c, const int(&a)[2][4],
                       const dct::ColumnCert(&)[2]) {
                     if (r < rows) {
                       out[(r0 + r) * P + c] = dct::fixed_point(a[0], exact);
                       out[(r0 + r) * P + c + 1] =
                           dct::fixed_point(a[1], exact);
                     }
                     return 0u;
                   });
}

// ---- kernel C ---------------------------------------------------------

// N consecutive floats from shared memory, four at a time (one LDS.128
// each): src must be 16-byte aligned and N a multiple of 4.
template <int N>
__device__ __forceinline__ void load_f32x4(float (&dst)[N],
                                           const float* __restrict__ src) {
  static_assert(N % 4 == 0, "float4 loads");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    dst[i] = v.x;
    dst[i + 1] = v.y;
    dst[i + 2] = v.z;
    dst[i + 3] = v.w;
  }
}

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
      load_f32x4(z, zT + k * T + r0);
      load_f32x4(w, s_m + k * N2 + j0);
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
int launch_encode(const void* px, const void* frag, const void* cert,
                  const void* parts, const void* bias, const void* recip,
                  void* out, long long n_blocks, void* rescued,
                  cudaStream_t stream) {
  using E = EncShape<N2>;
  constexpr int smem = E::kBytes;
  auto kernel = encode_blocks_kernel<N2, ADAPTIVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_for(kernel, smem,
                    (n_blocks + E::kBlocks - 1) / E::kBlocks),
           kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(px), static_cast<const uint4*>(frag),
      static_cast<const int4*>(cert), static_cast<const float*>(parts),
      static_cast<const float*>(bias), static_cast<const float*>(recip),
      static_cast<int32_t*>(out), n_blocks,
      static_cast<unsigned long long*>(rescued));
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

DCT_EXPORT int dct_encode_blocks(const void* px, const void* frag,
                                 const void* cert, const void* parts,
                                 const void* bias, const void* recip,
                                 void* out, long long n_blocks, int n2,
                                 void* rescued, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool ad = recip != nullptr;
#define DCT_ENC(N)                                                          \
  return ad ? launch_encode<N, true>(px, frag, cert, parts, bias, recip,   \
                                     out, n_blocks, rescued, s)            \
            : launch_encode<N, false>(px, frag, cert, parts, bias, recip,  \
                                      out, n_blocks, rescued, s)
  switch (n2) {
    case 4: DCT_ENC(4);
    case 16: DCT_ENC(16);
    case 64: DCT_ENC(64);
    case 256: DCT_ENC(256);
  }
#undef DCT_ENC
  return static_cast<int>(cudaErrorInvalidValue);
}

DCT_EXPORT int dct_mma_products(const void* px, const void* frag, void* out,
                                int n_rows, int p, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = (n_rows + 63) / 64;
  if (grid == 0) return static_cast<int>(cudaSuccess);
#define DCT_MMA(P)                                                         \
  mma_products_kernel<P><<<grid, kThreads, 0, s>>>(                        \
      static_cast<const uint8_t*>(px), static_cast<const uint4*>(frag),    \
      static_cast<long long*>(out), n_rows);                               \
  return static_cast<int>(cudaGetLastError())
  switch (p) {
    case 32: DCT_MMA(32);
    case 64: DCT_MMA(64);
    case 256: DCT_MMA(256);
  }
#undef DCT_MMA
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
