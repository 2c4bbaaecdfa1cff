// The encode transform shared by kernel A (transform.cu, a register
// micro-tile: split_matmul_tile) and kernel B (fused_encode.cu, one
// coefficient: split_matmul_coeff), and at n2 = 256 by both through
// split_matmul_256. Both run the same float32 chain for every coefficient,
// so the two kernels give bit-identical integers by construction — the
// role dct_tpu.ops.transform.split_operand_matmul plays for the
// reference's Pallas kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dct {

// Coefficient k of one block: ((x@m0 + x@m1) + x@m2) + b. m0, m1, m2 are
// (n2, n2) row-major in shared memory (row j = input pixel, column k =
// output coefficient), each holding bf16 values as float. A u8 pixel times
// a bf16 value has at most 16 significant bits, so every product is exact
// in float32 and a fused multiply-add rounds exactly like multiply-then-
// add: only the association matters. Three accumulators, one per part,
// each summed in j order, combined left to right — never one sum over all
// 3 x n2 products.
template <int N2>
__device__ __forceinline__ float split_matmul_coeff(
    const uint8_t* __restrict__ x, const float* __restrict__ m0,
    const float* __restrict__ m1, const float* __restrict__ m2,
    const float* __restrict__ bias, int k) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 8
  for (int j = 0; j < N2; ++j) {
    const float xv = static_cast<float>(x[j]);
    a0 = __fmaf_rn(xv, m0[j * N2 + k], a0);
    a1 = __fmaf_rn(xv, m1[j * N2 + k], a1);
    a2 = __fmaf_rn(xv, m2[j * N2 + k], a2);
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), bias[k]);
}

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

// The same transform for an R-block x C-coefficient micro-tile held in
// registers: y[r][c] is coefficient k0 + c of block r, each by exactly
// split_matmul_coeff's chain (three accumulators summed in j order,
// combined left to right, then the bias), so the two give the same bits.
// xT holds the pixels as float, j-major: pixel j of block r at
// xT[j * ldx + r]. Per j a thread loads R/4 + 3C/4 float4s for 3RC FMAs.
// xT + j * ldx and the operator rows at k0 must be 16-byte aligned.
template <int N2, int R, int C>
__device__ __forceinline__ void split_matmul_tile(
    const float* __restrict__ xT, int ldx, const float* __restrict__ m0,
    const float* __restrict__ m1, const float* __restrict__ m2,
    const float* __restrict__ bias, int k0, float (&y)[R][C]) {
  float a0[R][C], a1[R][C], a2[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) a0[r][c] = a1[r][c] = a2[r][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < N2; ++j) {
    float x[R], w0[C], w1[C], w2[C];
    load_f32x4(x, xT + j * ldx);
    load_f32x4(w0, m0 + j * N2 + k0);
    load_f32x4(w1, m1 + j * N2 + k0);
    load_f32x4(w2, m2 + j * N2 + k0);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a0[r][c] = __fmaf_rn(x[r], w0[c], a0[r][c]);
        a1[r][c] = __fmaf_rn(x[r], w1[c], a1[r][c]);
        a2[r][c] = __fmaf_rn(x[r], w2[c], a2[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
      y[r][c] = __fadd_rn(__fadd_rn(__fadd_rn(a0[r][c], a1[r][c]), a2[r][c]),
                          bias[k0 + c]);
}

// 16x16 blocks (n2 = 256), shared by kernel A (encode_blocks_256_kernel)
// and kernel B at n2 = 256. The chain is the reference's K = 128 split
// (dct_tpu/ops/transform.py, the n2 = 256 branch of encode_blocks): per
// part i, lo_i sums j = 0..127 and hi_i sums j = 128..255, each in j
// order; t_i = lo_i + hi_i; then ((t_0 + t_1) + t_2) + b. Every u8 x bf16
// product is exact in float32, so the FMAs round like multiply-then-add.
// The three (256, 256) parts take 768 KB, more than shared memory holds:
// they are read through L2 (__ldg; the 768 KB stay resident in its
// 50 MB), three values a step of j, each used for all R blocks. Thread k
// computes coefficient k of the R blocks.
constexpr int kN2Big = 256;

// Stage up to R blocks of 256 u8 pixels (src, n of them) as float,
// j-major: pixel j of block r at xT[j * R + r]; blocks past n are zero.
// All threads of the CTA take part; the caller synchronises after.
template <int R, int THREADS>
__device__ __forceinline__ void stage_pixels_256(float* __restrict__ xT,
                                                 const uint8_t* __restrict__ src,
                                                 int n) {
  for (int i = threadIdx.x; i < R * kN2Big; i += THREADS) {
    const int r = i / kN2Big, j = i % kN2Big;
    xT[j * R + r] = r < n ? static_cast<float>(src[i]) : 0.f;
  }
}

// One half (j0 = 0 or 128) of the K = 128 split, for every part at once.
template <int R>
__device__ __forceinline__ void split_half_256(
    const float* __restrict__ xT, const float* __restrict__ m0,
    const float* __restrict__ m1, const float* __restrict__ m2, int ld,
    int k, int j0, float (&a)[3][R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) a[0][r] = a[1][r] = a[2][r] = 0.f;
#pragma unroll 4
  for (int j = j0; j < j0 + kN2Big / 2; ++j) {
    float x[R];
    load_f32x4(x, xT + j * R);
    const float w0 = __ldg(m0 + j * ld + k), w1 = __ldg(m1 + j * ld + k),
                w2 = __ldg(m2 + j * ld + k);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[0][r] = __fmaf_rn(x[r], w0, a[0][r]);
      a[1][r] = __fmaf_rn(x[r], w1, a[1][r]);
      a[2][r] = __fmaf_rn(x[r], w2, a[2][r]);
    }
  }
}

// Coefficient k of the R staged blocks; m0/m1/m2 (256, 256) with row
// stride ld and bias (256,) in device memory.
template <int R>
__device__ __forceinline__ void split_matmul_256(
    const float* __restrict__ xT, const float* __restrict__ m0,
    const float* __restrict__ m1, const float* __restrict__ m2,
    const float* __restrict__ bias, int ld, int k, float (&y)[R]) {
  float lo[3][R], hi[3][R];
  split_half_256<R>(xT, m0, m1, m2, ld, k, 0, lo);
  split_half_256<R>(xT, m0, m1, m2, ld, k, kN2Big / 2, hi);
  const float b = __ldg(bias + k);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float t0 = __fadd_rn(lo[0][r], hi[0][r]);
    const float t1 = __fadd_rn(lo[1][r], hi[1][r]);
    const float t2 = __fadd_rn(lo[2][r], hi[2][r]);
    y[r] = __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), b);
  }
}

// C round(): half away from zero. Never rintf (half to even). The
// intrinsic add cannot be contracted with an earlier multiply.
__device__ __forceinline__ float round_half_away(float y) {
  return truncf(__fadd_rn(y, copysignf(0.5f, y)));
}

// Adaptive AC scaling (one multiply + select, never contracted into an
// FMA: the reference's byte-identity depends on it) and rounding.
__device__ __forceinline__ int quantize_coeff(float y, int k, bool adaptive,
                                              float recip) {
  if (adaptive && k != 0) y = __fmul_rn(y, recip);
  return static_cast<int>(round_half_away(y));
}

}  // namespace dct
