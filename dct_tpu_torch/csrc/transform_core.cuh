// The encode transform of one coefficient, shared by kernel A
// (transform.cu) and kernel B (fused_encode.cu), so that the two give
// bit-identical integers by construction — the role
// dct_tpu.ops.transform.split_operand_matmul plays for the reference's
// Pallas kernels.
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
