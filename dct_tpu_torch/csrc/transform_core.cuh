// The encode transform shared by kernel A (transform.cu) and kernel B
// (fused_encode.cu): the same tile function in both, so the two give
// bit-identical integers by construction — the role
// dct_tpu.ops.transform.split_operand_matmul plays for the reference's
// Pallas kernels.
//
// The contract is the float32 chain over the bf16 split of the operator
// (testing.encode_fma_chain): per part i a sequential sum over pixels j of
// x_j * m_i[j, k] from 0 (at n2 = 256 the reference's K = 128 halves,
// then their sum), ((a0 + a1) + a2) + b, times recip on AC under adaptive
// quantization, rounded half away from zero. The tile reaches that chain's
// integer without running it for most coefficients:
//
//  (a) integer products on the tensor cores: each column k of m0 + m1 + m2
//      is an int32 column W[:, k] times 2^-e_k (tables.integer_operator),
//      held as four byte planes (three unsigned, the top one signed), so
//      S = x @ W = sum_l 2^(8 l) (x @ w_l) is four mma.m16n8k32 products
//      (u8 x u8, and u8 x s8 for the top plane) with exact int32
//      accumulators (255 * 255 * 256 < 2^31), combined in int64
//      (|S| < 2^47);
//  (b) the exact value in float64: Y* = S 2^-e_k + b_k (the scaling exact,
//      the add rounded once), times the float32 recip (rounded once);
//  (c) a rounding certificate (certify below): when no .5 boundary lies
//      within delta_k of Y*, the chain provably rounds to round(Y*);
//  (d) the rescue: the coefficients the certificate leaves open are
//      appended to a per-tile list in shared memory, and after the
//      tensor-core pass the whole CTA runs the chain itself for them
//      (chain_coeff: the same operands, the parts transposed, read with
//      __ldg), so no lane diverges into a chain while its warp multiplies;
//  (e) quantize and store, by the caller's functor (int16 into shared
//      memory for B, int32 to device memory for A).
// The rescue is part of the arithmetic, not a fallback: nothing skips it,
// and every integer the tile gives is the chain's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dct {

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// ---- (a) integer products -------------------------------------------

// D += A (16 x 32 u8, row) * B (32 x 8, col), int32 accumulators; B u8
// (planes 0-2) or s8 (plane 3).
__device__ __forceinline__ void mma_u8u8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tile's geometry. Pixels sit in shared memory as packed rows of P
// bytes (P = max(n2, 32): below 32 a row holds 32 / n2 blocks and the
// operator is block-diagonal), kStride bytes apart (P + 16: the eight
// rows a fragment load touches fall in distinct banks), TR rows a tile.
// The P x P operator is P / 8 n-tiles of 8 columns and P / 32 k-steps.
// Warps split the n-tiles (kWN of them along N) and, where there are
// fewer n-tiles than warps, the m-tiles of 16 rows (kWM along M); a warp
// holds kMC m-tiles' accumulators at once, 16 int32 registers each, and
// reads each B fragment once for all of them.
template <int P, int TR, int MC, int THREADS>
struct MmaTile {
  static constexpr int kStride = P + 16;
  static constexpr int kNT = P / 8, kKS = P / 32, kMT = TR / 16;
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kWN = kNT < kWarps ? kNT : kWarps;
  static constexpr int kWM = kWarps / kWN;
  static constexpr int kMC = MC;
  static_assert(P % 32 == 0 && TR % 16 == 0, "mma tiles");
  static_assert(kNT % kWN == 0 && kMT % (kWM * MC) == 0, "warp split");
  static_assert(TR * P <= 65536, "uint16 tile indices");
};

__device__ __forceinline__ unsigned lds32(const uint8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// The integer products of a tile: for every (packed row r, column pair
// c, c + 1) epi(r, c, s0, s1) with s = x_r @ W[:, c] exactly. Every lane
// of every warp calls epi the same number of times, in step (epi may use
// warp collectives). px: the tile's rows in shared memory; frag: the
// planes in mma_fragments' order (tables.py), read through L1/L2.
template <class G, class Epi>
__device__ __forceinline__ void mma_tile(const uint8_t* __restrict__ px,
                                         const uint4* __restrict__ frag,
                                         Epi&& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % G::kWN, wm = warp / G::kWN;
  for (int nt = wn; nt < G::kNT; nt += G::kWN) {
    for (int m0 = wm; m0 < G::kMT; m0 += G::kWM * G::kMC) {
      int acc[G::kMC][4][4];
#pragma unroll
      for (int i = 0; i < G::kMC; ++i)
#pragma unroll
        for (int l = 0; l < 4; ++l)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][l][e] = 0;
#pragma unroll 2
      for (int ks = 0; ks < G::kKS; ++ks) {
        const uint4* f = frag + ((nt * G::kKS + ks) * 32 + lane) * 2;
        const uint4 f01 = __ldg(f), f23 = __ldg(f + 1);
#pragma unroll
        for (int i = 0; i < G::kMC; ++i) {
          const uint8_t* row =
              px + ((m0 + i * G::kWM) * 16 + g) * G::kStride + ks * 32 + 4 * t;
          const unsigned a[4] = {lds32(row), lds32(row + 8 * G::kStride),
                                 lds32(row + 16),
                                 lds32(row + 8 * G::kStride + 16)};
          mma_u8u8(acc[i][0], a, f01.x, f01.y);
          mma_u8u8(acc[i][1], a, f01.z, f01.w);
          mma_u8u8(acc[i][2], a, f23.x, f23.y);
          mma_u8s8(acc[i][3], a, f23.z, f23.w);
        }
      }
#pragma unroll
      for (int i = 0; i < G::kMC; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          long long s[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 2 * h + e;  // c[x]: row g + 8 h, column 2 t + e
            s[e] = static_cast<long long>(acc[i][0][x]) +
                   static_cast<long long>(acc[i][1][x]) * 256 +
                   static_cast<long long>(acc[i][2][x]) * 65536 +
                   static_cast<long long>(acc[i][3][x]) * 16777216;
          }
          epi((m0 + i * G::kWM) * 16 + g + 8 * h, nt * 8 + 2 * t, s[0], s[1]);
        }
    }
  }
}

// ---- (b, c) the exact value and the certificate ------------------------

constexpr double kU = 1.0 / 16777216.0;                // 2^-24
constexpr double kCertRel = 2 * kU + 1.0 / 1099511627776.0;  // 2u + 2^-40

// The per-column constants (tables.certificate_constants), one column.
struct ColumnCert {
  double scale, bias, err;  // 2^-e_k, b_k, E_k
};

__device__ __forceinline__ ColumnCert column_cert(
    const double* __restrict__ cert, int p, int c) {
  return ColumnCert{__ldg(cert + c), __ldg(cert + p + c),
                    __ldg(cert + 2 * p + c)};
}

// q = round_half_away(Y*) when the chain provably rounds to it; false
// when the coefficient must be rescued. mul: the chain multiplies by r
// (AC under adaptive quantization).
//
// The proof. Let T = S 2^-e + b exactly, u = 2^-24, and y the chain's
// float32 value before the recip. Every product x_j m_i[j, k] is exact in
// float32 (8 x 8 significant bits) and passes at most n2 + 3 roundings
// (n2 - 1 in its part's sequential sum, one more for the halves' sum at
// n2 = 256, three combining adds), the bias one, so
//   |y - T| <= E = gamma_{n2+3} (255 sum_ij |m_i[j, k]| + |b_k|)
// (Higham's bound for any summation tree; x_j <= 255). The multiply
// z = fl(y r) gives |z - T r| <= E r (1 + u) + u |T r|. round_half_away
// is trunc(fl(z + h)), h = copysign(0.5, z): fl(z + h) lies within
// u (|z| + 1/2) of z + h, so when T r is farther than
//   D = |z - T r| + u (|z| + 1/2) <= E r (1 + u)^2 + (2u + u^2)|T r| + u/2
// from every half-integer, trunc(fl(z + h)) = round(T r). Y* holds T r to
// within 2^-52 |T r| (two float64 roundings), so the test below, dist >
// delta = E' r + (2u + 2^-40) |Y*| + u with E' = E (1 + 3u)(1 + 2^-40)
// from the host, covers D and the float64 roundings of Y* and of delta
// itself with room to spare. dist is exact: Y* - floor(Y*) and the
// subtraction of 0.5 are exact in float64.
__device__ __forceinline__ bool certify(long long s, const ColumnCert& cc,
                                        bool mul, float r, int& q) {
  double y = __dadd_rn(__dmul_rn(static_cast<double>(s), cc.scale), cc.bias);
  double rr = 1.0;
  if (mul) {
    rr = static_cast<double>(r);
    y = __dmul_rn(y, rr);
  }
  const double delta =
      __dadd_rn(__dadd_rn(__dmul_rn(cc.err, rr), __dmul_rn(kCertRel, fabs(y))),
                kU);
  const double fl = floor(y);
  const double frac = y - fl;
  q = static_cast<int>(fl) + (frac > 0.5 ? 1 : 0);
  return fabs(frac - 0.5) > delta;
}

// Append idx to the tile's rescue list where want (warp-collective: every
// lane calls it; one shared atomic a warp).
__device__ __forceinline__ void rescue_append(bool want, int idx,
                                              uint16_t* list, int* count) {
  const unsigned m = __ballot_sync(kFullMask, want);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(kFullMask, base, leader);
  if (want)
    list[base + __popc(m & ((1u << lane) - 1u))] = static_cast<uint16_t>(idx);
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

// The certified epilogue of mma_tile for blocks of N2 pixels: for the
// pair (r, c), (r, c + 1) of a tile whose first n blocks are live, certify
// both, store(idx, q0, q1) for a live pair (idx = r * P + c, the flat
// index of coefficient c % N2 of block idx / N2 in the tile; a value left
// open is stored too and overwritten by the rescue), and append the open
// ones to the list. recip: the tile's reciprocal scales, or nullptr.
template <int N2, int P, class Store>
__device__ __forceinline__ void certify_pair(
    int r, int c, long long s0, long long s1, int n,
    const double* __restrict__ cert, const float* __restrict__ recip,
    uint16_t* list, int* count, Store& store) {
  const int idx = r * P + c, b = idx / N2, k = c % N2;
  const bool live = b < n;
  const float rf = recip != nullptr && live ? recip[b] : 1.f;
  const bool ad = recip != nullptr;
  int q0 = 0, q1 = 0;
  bool ok0 = true, ok1 = true;
  if (live) {  // c and c + 1 lie in one block: N2 is even
    ok0 = certify(s0, column_cert(cert, P, c), ad && k != 0, rf, q0);
    ok1 = certify(s1, column_cert(cert, P, c + 1), ad, rf, q1);
    store.pair(idx, q0, q1);
  }
  rescue_append(!ok0, idx, list, count);
  rescue_append(!ok1, idx + 1, list, count);
}

// ---- (d) the rescue: the chain itself -----------------------------------

// Coefficient k of one block by the chain: x the block's N2 u8 pixels in
// shared memory (4-byte aligned), mt the (3, N2, N2) transposed parts
// (row k of part i at mt + (i N2 + k) N2, 16-byte aligned), bias (N2,).
// Per part a sequential sum over j from 0 (an FMA of an exact product
// rounds like multiply-then-add), at N2 = 256 in the K = 128 halves, then
// ((a0 + a1) + a2) + b.
__device__ __forceinline__ void chain_sums(const uint8_t* __restrict__ x,
                                           const float* __restrict__ w0,
                                           const float* __restrict__ w1,
                                           const float* __restrict__ w2,
                                           int j0, int j1, float (&a)[3]) {
  a[0] = a[1] = a[2] = 0.f;
#pragma unroll 4
  for (int j = j0; j < j1; j += 4) {
    const unsigned xw = lds32(x + j);
    const float4 v0 = __ldg(reinterpret_cast<const float4*>(w0 + j));
    const float4 v1 = __ldg(reinterpret_cast<const float4*>(w1 + j));
    const float4 v2 = __ldg(reinterpret_cast<const float4*>(w2 + j));
    const float xs[4] = {static_cast<float>(xw & 0xFFu),
                         static_cast<float>((xw >> 8) & 0xFFu),
                         static_cast<float>((xw >> 16) & 0xFFu),
                         static_cast<float>(xw >> 24)};
    const float m0[4] = {v0.x, v0.y, v0.z, v0.w};
    const float m1[4] = {v1.x, v1.y, v1.z, v1.w};
    const float m2[4] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[0] = __fmaf_rn(xs[e], m0[e], a[0]);
      a[1] = __fmaf_rn(xs[e], m1[e], a[1]);
      a[2] = __fmaf_rn(xs[e], m2[e], a[2]);
    }
  }
}

template <int N2>
__device__ __forceinline__ float chain_coeff(const uint8_t* __restrict__ x,
                                             const float* __restrict__ mt,
                                             const float* __restrict__ bias,
                                             int k) {
  const float* w0 = mt + k * N2;
  const float* w1 = w0 + N2 * N2;
  const float* w2 = w1 + N2 * N2;
  float a[3];
  if constexpr (N2 == 256) {
    float hi[3];
    chain_sums(x, w0, w1, w2, 0, N2 / 2, a);
    chain_sums(x, w0, w1, w2, N2 / 2, N2, hi);
#pragma unroll
    for (int i = 0; i < 3; ++i) a[i] = __fadd_rn(a[i], hi[i]);
  } else {
    chain_sums(x, w0, w1, w2, 0, N2, a);
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), __ldg(bias + k));
}

// The whole CTA works through the tile's rescue list: entry idx is
// coefficient idx % N2 of block idx / N2, whose pixels sit in packed row
// idx / P of px (row stride STRIDE). store.one(idx, q) overwrites the
// value certify_pair left there.
template <int N2, int P, int STRIDE, int THREADS, class Store>
__device__ __forceinline__ void rescue_tile(
    const uint16_t* list, int count, const uint8_t* px,
    const float* __restrict__ parts_t, const float* __restrict__ bias,
    const float* __restrict__ recip, Store& store) {
  for (int i = threadIdx.x; i < count; i += THREADS) {
    const int idx = list[i], b = idx / N2, k = idx % N2;
    const uint8_t* x = px + idx / P * STRIDE + idx % P / N2 * N2;
    const float y = chain_coeff<N2>(x, parts_t, bias, k);
    const bool ad = recip != nullptr;
    store.one(idx, quantize_coeff(y, k, ad, ad ? recip[b] : 1.f));
  }
}

}  // namespace dct
