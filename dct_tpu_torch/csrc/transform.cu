// Kernels A and C: the block transform front-ends.
//
// A (encode) replaces dct_tpu/ops/transform_pallas.py `_encode_kernel` /
// `_encode_kernel_adaptive` (wrapper `encode_blocks_pallas`); C (decode)
// replaces `_decode_kernel` / `_decode_kernel_adaptive` (wrapper
// `decode_blocks_pallas`).
//
// What bounds them on an H100: per 8x8 block, A reads 64 B and writes
// 256 B (int32) but does 3 x 64 x 64 multiply-adds in float32 CUDA cores
// (the split is exact only in f32, and there is no f32 tensor-core path
// that keeps the reference's summation order), each fed from shared
// memory: the bound is the shared-memory load rate of the operator, not
// HBM. C does 64 x 64 f32 multiply-adds per block for 128 B in and 64 B
// out — the same bound. The design keeps the operator in shared memory
// once per CTA for a grid-stride walk over tiles of blocks (the TPU's
// TILE_ROWS padding and 128-lane packing have no meaning here), stages
// each tile's inputs in shared memory, and gives each thread one output
// value at a time: a warp reads one operator row segment (consecutive
// columns, no bank conflicts) and one broadcast input value per step.

#include "bindings.h"
#include "transform_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // coefficients staged per tile (8 a thread)

inline int grid_for(long long n_tiles) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long g = static_cast<long long>(sms) * 4;
  return static_cast<int>(n_tiles < g ? n_tiles : g);
}

template <int N2>
__device__ __forceinline__ void load_operator(float* dst, const float* src,
                                              int ld) {
  for (int i = threadIdx.x; i < N2 * N2; i += blockDim.x)
    dst[i] = src[(i / N2) * ld + (i % N2)];
}

template <int N2, bool ADAPTIVE>
__global__ void __launch_bounds__(kThreads)
    encode_blocks_kernel(const uint8_t* __restrict__ px,
                         const float* __restrict__ m0,
                         const float* __restrict__ m1,
                         const float* __restrict__ m2,
                         const float* __restrict__ bias, int ld,
                         const float* __restrict__ recip,
                         int32_t* __restrict__ out, long long n_blocks) {
  extern __shared__ float smem[];
  float* s_m0 = smem;
  float* s_m1 = s_m0 + N2 * N2;
  float* s_m2 = s_m1 + N2 * N2;
  float* s_b = s_m2 + N2 * N2;
  uint8_t* s_px = reinterpret_cast<uint8_t*>(s_b + N2);
  load_operator<N2>(s_m0, m0, ld);
  load_operator<N2>(s_m1, m1, ld);
  load_operator<N2>(s_m2, m2, ld);
  for (int i = threadIdx.x; i < N2; i += blockDim.x) s_b[i] = bias[i];

  constexpr int kBlocks = kTile / N2;
  const long long n_tiles = (n_blocks + kBlocks - 1) / kBlocks;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long b0 = t * kBlocks;
    const long long left = n_blocks - b0;
    const int n = static_cast<int>(left < kBlocks ? left : kBlocks) * N2;
    __syncthreads();  // operators loaded / previous tile consumed
    for (int i = threadIdx.x; i < n; i += kThreads) s_px[i] = px[b0 * N2 + i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int b = i / N2, k = i % N2;
      const float y = dct::split_matmul_coeff<N2>(s_px + b * N2, s_m0, s_m1,
                                                  s_m2, s_b, k);
      const float r = ADAPTIVE ? recip[b0 + b] : 1.f;
      out[b0 * N2 + i] = dct::quantize_coeff(y, k, ADAPTIVE, r);
    }
  }
}

template <int N2, bool ADAPTIVE>
__global__ void __launch_bounds__(kThreads)
    decode_blocks_kernel(const int16_t* __restrict__ zz,
                         const float* __restrict__ m_dec, int ld,
                         const float* __restrict__ scale,
                         uint8_t* __restrict__ out, long long n_blocks) {
  extern __shared__ float smem[];
  float* s_m = smem;            // (N2, N2): row k = coefficient, col j = pixel
  float* s_z = s_m + N2 * N2;   // kTile scaled coefficients
  load_operator<N2>(s_m, m_dec, ld);

  constexpr int kBlocks = kTile / N2;
  const long long n_tiles = (n_blocks + kBlocks - 1) / kBlocks;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long b0 = t * kBlocks;
    const long long left = n_blocks - b0;
    const int n = static_cast<int>(left < kBlocks ? left : kBlocks) * N2;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float z = static_cast<float>(zz[b0 * N2 + i]);
      // dequant scale on AC only, one multiply (reference op order)
      if (ADAPTIVE && (i % N2) != 0) z = __fmul_rn(z, scale[b0 + i / N2]);
      s_z[i] = z;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int b = i / N2, j = i % N2;
      const float* z = s_z + b * N2;
      float y = 0.f;
#pragma unroll 8
      for (int k = 0; k < N2; ++k) y = __fmaf_rn(z[k], s_m[k * N2 + j], y);
      float p = dct::round_half_away(__fadd_rn(y, 128.f));
      p = fminf(fmaxf(p, 0.f), 255.f);
      out[b0 * N2 + i] = static_cast<uint8_t>(p);
    }
  }
}

template <int N2, bool ADAPTIVE>
int launch_encode(const void* px, const void* m0, const void* m1,
                  const void* m2, const void* bias, int ld, const void* recip,
                  void* out, long long n_blocks, cudaStream_t stream) {
  const int smem = (3 * N2 * N2 + N2) * sizeof(float) + kTile;
  auto kernel = encode_blocks_kernel<N2, ADAPTIVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = (n_blocks + kTile / N2 - 1) / (kTile / N2);
  kernel<<<grid_for(n_tiles), kThreads, smem, stream>>>(
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
  const int smem = (N2 * N2 + kTile) * sizeof(float);
  auto kernel = decode_blocks_kernel<N2, ADAPTIVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = (n_blocks + kTile / N2 - 1) / (kTile / N2);
  kernel<<<grid_for(n_tiles), kThreads, smem, stream>>>(
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
