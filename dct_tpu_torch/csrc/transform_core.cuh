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
//      is an int32 column W[:, k] times 2^-e_k, e_k >= 31
//      (tables.certificate_operator), held as four byte planes (three
//      unsigned, the top one signed), so S = x @ W = sum_l 2^(8 l) (x @
//      w_l) is four mma.m16n8k32 products (u8 x u8, and u8 x s8 for the top
//      plane) with exact int32 accumulators (255 * 255 * 256 < 2^31);
//  (b) the exact value in fixed point: Z = (S + add_k) >> shift_k holds
//      (T + 1/2) 2^31, T = S 2^-e_k + b_k, to within [Z, Z + 2) (int64 adds
//      and one shift; the constants are per column, tables.py
//      certificate_constants);
//  (c) a rounding certificate (certify_exact, certify_scaled below): when
//      no .5 boundary lies near T (T r under adaptive quantization), the
//      chain provably rounds to the nearest integer, read from Z;
//  (d) the rescue: the coefficients the certificate leaves open are
//      appended to a per-tile list in shared memory, and after the
//      tensor-core pass the whole CTA runs the chain itself for them
//      (rescue_tile: a group of lanes a coefficient where the list is
//      short, a lane a coefficient where it is long), so no lane diverges
//      into a chain while its warp multiplies;
//  (e) quantize and store, by the caller's functor (int16 rows in shared
//      memory for B, an int32 tile in shared memory for A).
// The rescue is part of the arithmetic, not a fallback: nothing skips it,
// and every integer the tile gives is the chain's.
//
// What the design keeps off each coefficient: no float64 (the fixed point
// is int64 adds and a shift, the certificate an unsigned compare; only
// adaptive quantization takes one int64 -> float32 conversion and a few
// float32 operations), no load of per-column constants or fragments (a
// warp's n-tile is fixed, so below P = 256 its fragments and its two
// columns' constants sit in registers, TileOperands: loaded once a kernel
// in A, once a tile in B, whose entropy stage needs the registers), and
// no warp collective (a lane with open coefficients reserves list slots
// with one shared atomic, once a group of products).
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
  static constexpr int kP = P;
  static constexpr int kStride = P + 16;
  static constexpr int kNT = P / 8, kKS = P / 32, kMT = TR / 16;
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kWN = kNT < kWarps ? kNT : kWarps;
  static constexpr int kWM = kWarps / kWN;
  static constexpr int kMC = MC;
  static_assert(P % 32 == 0 && TR % 16 == 0, "mma tiles");
  static_assert(kNT % kWN == 0 && kMT % (kWM * MC) == 0, "warp split");
  static_assert(TR * P <= 65536, "uint16 tile indices");
  static_assert(MC * 4 <= 32, "a group's open bits fit a word");
};

__device__ __forceinline__ unsigned lds32(const uint8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// ---- (b) the per-column constants ---------------------------------------

// One column's certificate constants: tables.certificate_constants, eight
// int32 a column (add low and high words, shift, thr, span, ea's bits).
struct ColumnCert {
  long long add;  // floor((b_k + 1/2) 2^e_k)
  int shift;      // e_k - 31
  unsigned thr;   // floor(D_k 2^31) + 1
  unsigned span;  // max(0, 2^31 - 1 - 2 thr)
  float ea;       // E_k's bound for the scaled certificate
};

__device__ __forceinline__ ColumnCert column_cert(
    const int4* __restrict__ cert, int c) {
  const int4 v = __ldg(cert + 2 * c), w = __ldg(cert + 2 * c + 1);
  ColumnCert cc;
  cc.add = static_cast<long long>(
      static_cast<unsigned long long>(static_cast<unsigned>(v.y)) << 32 |
      static_cast<unsigned>(v.x));
  cc.shift = v.z;
  cc.thr = static_cast<unsigned>(v.w);
  cc.span = static_cast<unsigned>(w.x);
  cc.ea = __int_as_float(w.y);
  return cc;
}

// The operands a warp reads for its n-tile: the byte-plane fragments of
// each k-step (mma_fragments' order in tables.py) and its lane's two
// columns' constants. Below P = 256 each warp owns one n-tile for the
// whole kernel (kHeld): load(nt) once, and every tile after it reuses the
// registers. At P = 256 a warp walks four n-tiles of eight k-steps, more
// than registers hold: the constants are loaded at each n-tile and the
// fragments at each k-step, from L1/L2.
template <class G>
struct TileOperands {
  static constexpr bool kHeld = G::kNT == G::kWN;
  const uint4* frag;
  const int4* cert;  // nullptr: products only, no constants
  uint4 f[kHeld ? G::kKS : 1][2];
  ColumnCert cc[2];

  __device__ __forceinline__ void load(int nt) {
    const int lane = threadIdx.x & 31;
    if constexpr (kHeld) {
#pragma unroll
      for (int ks = 0; ks < G::kKS; ++ks) {
        const uint4* p = frag + ((nt * G::kKS + ks) * 32 + lane) * 2;
        f[ks][0] = __ldg(p);
        f[ks][1] = __ldg(p + 1);
      }
    }
    if (cert != nullptr) {
      const int c = nt * 8 + 2 * (lane & 3);
      cc[0] = column_cert(cert, c);
      cc[1] = column_cert(cert, c + 1);
    }
  }
  __device__ __forceinline__ void fragments(int nt, int ks, uint4& f01,
                                            uint4& f23) const {
    if constexpr (kHeld) {
      f01 = f[ks][0];
      f23 = f[ks][1];
    } else {
      const uint4* p =
          frag + ((nt * G::kKS + ks) * 32 + (threadIdx.x & 31)) * 2;
      f01 = __ldg(p);
      f23 = __ldg(p + 1);
    }
  }
};

// The integer products of a tile and their epilogue. For every (packed
// row r, column pair c, c + 1) the lane calls
//   epi(r, c, a, cc) -> open bits (bit 0: c, bit 1: c + 1)
// with a[e][l] = x_r @ w_l[:, c + e] exactly (plane l's int32 sum) and
// cc its two columns' constants. The open coefficients of a group of
// kMC m-tiles are appended to list (flat tile indices r * P + c), the
// lane reserving its slots with one shared atomic on *count: no warp
// collective, and nothing at all where nothing is open. px: the tile's
// rows in shared memory. ops: TileOperands, loaded already where kHeld.
template <class G, class Epi>
__device__ __forceinline__ void mma_tile(const uint8_t* __restrict__ px,
                                         TileOperands<G>& ops, uint16_t* list,
                                         int* count, Epi&& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % G::kWN, wm = warp / G::kWN;
  for (int nt = wn; nt < G::kNT; nt += G::kWN) {
    if constexpr (!TileOperands<G>::kHeld) ops.load(nt);
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
        uint4 f01, f23;
        ops.fragments(nt, ks, f01, f23);
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
      unsigned open = 0u;  // bits 4 i + 2 h + e
#pragma unroll
      for (int i = 0; i < G::kMC; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int a[2][4];  // c[x]: row g + 8 h, column 2 t + e
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int l = 0; l < 4; ++l) a[e][l] = acc[i][l][2 * h + e];
          open |= epi((m0 + i * G::kWM) * 16 + g + 8 * h, nt * 8 + 2 * t, a,
                      ops.cc)
                  << (4 * i + 2 * h);
        }
      if (open) {
        int at = atomicAdd(count, __popc(open));
        do {
          const int bit = __ffs(open) - 1;
          open &= open - 1u;
          const int r =
              (m0 + (bit >> 2) * G::kWM) * 16 + g + 8 * (bit >> 1 & 1);
          list[at++] =
              static_cast<uint16_t>(r * G::kP + nt * 8 + 2 * t + (bit & 1));
        } while (open);
      }
    }
  }
}

// ---- (b, c) the fixed point and the certificate --------------------------

// Z = (S + add) >> shift, S = sum_l 2^(8 l) a[l] (|S| < 2^47). The planes
// are combined in 32 bits where they fit: a0 + 2^8 a1 < 2^32 unsigned and
// a2 + 2^8 a3 < 2^31 signed (each |a_l| <= 255 * 255 * 256), so S =
// lo + 2^16 hi takes one wide multiply-add and one add.
__device__ __forceinline__ long long fixed_point(const int (&a)[4],
                                                 const ColumnCert& cc) {
  const unsigned lo =
      static_cast<unsigned>(a[0]) + (static_cast<unsigned>(a[1]) << 8);
  const int hi = a[2] + a[3] * 256;
  const long long x = static_cast<long long>(hi) * 65536 + cc.add +
                      static_cast<long long>(lo);
  return x >> cc.shift;
}

// The certificate without a multiply (testing.certify holds the proof and
// runs the same operations on the CPU). p = (T + 1/2) 2^31 lies in
// [Z, Z + 2): add_k's floor loses less than 2^-e_k, the shift less than
// 2^-31. With q = Z >> 31 and F = Z mod 2^31, thr <= F < 2^31 - 1 - thr
// (one unsigned compare, F - thr < span) puts T within (q - 1/2, q + 1/2)
// and farther than thr 2^-31 > D_k = E_k (1 + u) + u Tmax_k + u/2 from
// both ends. The chain's y is within E_k of T, and round_half_away(y) =
// trunc(fl(y + h)), h = copysign(1/2, y): y + h is farther than
// u |y + h| <= u (|T| + E_k + 1/2) from every integer, so the add cannot
// reach one, and trunc gives q. q = floor(T + 1/2) is T's nearest integer
// (no tie is certified).
__device__ __forceinline__ bool certify_exact(long long z,
                                              const ColumnCert& cc, int& q) {
  q = static_cast<int>(z >> 31);
  return (static_cast<unsigned>(z) & 0x7FFFFFFFu) - cc.thr < cc.span;
}

constexpr long long kCertHalf = (1ll << 30) - 1;  // Z - it: T 2^31, +-1
constexpr float kCertC5 = 5.0f / 16777216.0f;      // 5u, times |z|
constexpr float kCertUC = 2.0f / 16777216.0f;      // 2u
constexpr float kRoundMagic = 12582912.0f;         // 1.5 * 2^23

// The certificate under adaptive quantization (every coefficient; r = 1
// on DC, whose chain has no multiply), in float32. t = fl(Z - (2^30 - 1))
// is T 2^31 to within u |.| + 1, z = fl(t r 2^-31) is T r to within
// (2u + u^2) |T r| + r 2^-31 (1 + u)^2. The chain's fl(y r) rounds to
// round(T r) when T r is farther than E_k r (1 + u)^2 + (2u + u^2) |T r| +
// u/2 from every half-integer. z's nearest integer comes from the
// rounding of z + 1.5 2^23 (its bits hold it, |z| < 2^22), and d = z -
// that integer is exact, so z lies 1/2 - |d| from the nearest
// half-integer; |d| < fl(1/2 - delta) loses at most 2^-25 to that last
// rounding. delta = fl(fl(fl(ea r) + fl(5u |z|)) + 2u) covers all of it,
// its own three roundings included: ea_k = (E_k (1 + u)^2 + 2^-29)
// (1 + 2^-20) rounded up, 5u against the (4u + O(u^2)) |z| that
// |T r| <= |z| (1 + 3u) + r 2^-30 needs, 2u against u/2 + 2^-25
// (testing.certify gives the steps). Every operation is an intrinsic:
// nothing is contracted into an FMA, so the CPU model gives the same bits.
__device__ __forceinline__ bool certify_scaled(long long z,
                                               const ColumnCert& cc, float r,
                                               int& q) {
  const float t = __ll2float_rn(z - kCertHalf);
  const float y = __fmul_rn(t, __fmul_rn(r, 0x1p-31f));
  const float m = __fadd_rn(y, kRoundMagic);
  const float d = __fsub_rn(y, __fsub_rn(m, kRoundMagic));
  const float delta = __fadd_rn(
      __fadd_rn(__fmul_rn(cc.ea, r), __fmul_rn(kCertC5, fabsf(y))), kCertUC);
  q = __float_as_int(m) - __float_as_int(kRoundMagic);
  return fabsf(d) < __fsub_rn(0.5f, delta);
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
// both and store(idx, q0, q1) (idx = r * P + c, the flat index of
// coefficient c % N2 of block idx / N2 in the tile; a value left open is
// stored too and overwritten by the rescue). Returns the open bits. recip:
// the tile's reciprocal scales, or nullptr.
template <int N2, int P, class Store>
__device__ __forceinline__ unsigned certify_pair(
    int r, int c, const int (&a)[2][4], const ColumnCert (&cc)[2], int n,
    const float* __restrict__ recip, Store& store) {
  const int idx = r * P + c, b = idx / N2;
  if (b >= n) return 0u;  // c and c + 1 lie in one block: N2 is even
  const long long z0 = fixed_point(a[0], cc[0]);
  const long long z1 = fixed_point(a[1], cc[1]);
  int q0, q1;
  bool ok0, ok1;
  if (recip != nullptr) {
    const float rb = recip[b];
    ok0 = certify_scaled(z0, cc[0], c % N2 ? rb : 1.f, q0);
    ok1 = certify_scaled(z1, cc[1], rb, q1);
  } else {
    ok0 = certify_exact(z0, cc[0], q0);
    ok1 = certify_exact(z1, cc[1], q1);
  }
  store.pair(idx, q0, q1);
  return (ok0 ? 0u : 1u) | (ok1 ? 0u : 2u);
}

// ---- (d) the rescue: the chain itself -----------------------------------

// Sequential sums over SPAN pixels from 0 of NP bf16 parts at once (an
// FMA of an exact product rounds like multiply-then-add): a[p] = sum_j
// x_j w[p N2^2 + j N2]. x: the pixels in shared memory (4-byte aligned);
// w: the first pixel's row in the (3, N2, N2) parts (row j = pixel,
// column k = coefficient), at the part and column wanted.
template <int N2, int SPAN, int NP, int UNROLL>
__device__ __forceinline__ void part_sums(const uint8_t* __restrict__ x,
                                          const float* __restrict__ w,
                                          float (&a)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) a[p] = 0.f;
#pragma unroll UNROLL
  for (int j = 0; j < SPAN; j += 4) {
    const unsigned xw = lds32(x + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xs = static_cast<float>((xw >> (8 * e)) & 0xFFu);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        a[p] = __fmaf_rn(xs, __ldg(w + p * N2 * N2 + (j + e) * N2), a[p]);
    }
  }
}

// The whole CTA works through the tile's rescue list: entry idx is
// coefficient k = idx % N2 of block idx / N2, whose pixels sit in packed
// row idx / P of px (row stride STRIDE); store.one(idx, q) overwrites the
// value certify_pair left there. Each coefficient is the chain: per bf16
// part a sequential sum over the pixels (at N2 = 256 the reference's K =
// 128 halves, then lo + hi), ((a0 + a1) + a2) + b. parts: (3, N2, N2) as
// above, bias (N2,), recip the tile's reciprocal scales or nullptr.
//
// Two ways to the same sums, by the list's length (the same on every
// thread). A short list is latency: a group of lanes takes a coefficient,
// one part (and half) a lane with its loads in flight together, and the
// group's first lane adds them in the chain's order. A long list is
// throughput: a lane takes a coefficient (measured faster from two passes
// of groups on, at every N2). Either way a warp's lanes step through the
// same pixel j, so its loads of a part fall in one row of N2 floats (a
// lane-per-row layout would touch a line a lane).
template <int N2, int P, int STRIDE, int THREADS, class Store>
__device__ __forceinline__ void rescue_tile(
    const uint16_t* list, int count, const uint8_t* px,
    const float* __restrict__ parts, const float* __restrict__ bias,
    const float* __restrict__ recip, Store& store) {
  constexpr int kHalves = N2 == 256 ? 2 : 1;
  constexpr int kSpan = N2 / kHalves;  // pixels a sum
  constexpr int kG = 4 * kHalves;      // lanes a coefficient, 3 kHalves busy
  const bool ad = recip != nullptr;
  if (count <= THREADS / kG) {
    const int lane = threadIdx.x & 31, sub = lane % kG, first = lane - sub;
    const int i = static_cast<int>(threadIdx.x) / kG;
    const int idx = i < count ? list[i] : 0, k = idx % N2;
    const int part = sub % 3, half = sub / 3;
    float a[1] = {0.f};
    if (i < count && sub < 3 * kHalves)
      part_sums<N2, kSpan, 1, 8>(
          px + idx / P * STRIDE + idx % P / N2 * N2 + half * kSpan,
          parts + (part * N2 + half * kSpan) * N2 + k, a);
    float s[3];
#pragma unroll
    for (int pi = 0; pi < 3; ++pi) {
      s[pi] = __shfl_sync(kFullMask, a[0], first + pi);
      if constexpr (kHalves == 2)
        s[pi] = __fadd_rn(s[pi], __shfl_sync(kFullMask, a[0], first + 3 + pi));
    }
    if (i < count && sub == 0) {
      const float y =
          __fadd_rn(__fadd_rn(__fadd_rn(s[0], s[1]), s[2]), __ldg(bias + k));
      store.one(idx, quantize_coeff(y, k, ad, ad ? recip[idx / N2] : 1.f));
    }
    return;
  }
  for (int i = threadIdx.x; i < count; i += THREADS) {
    const int idx = list[i], k = idx % N2;
    const uint8_t* x = px + idx / P * STRIDE + idx % P / N2 * N2;
    float s[3];
    part_sums<N2, kSpan, 3, 2>(x, parts + k, s);
    if constexpr (kHalves == 2) {
      float hi[3];
      part_sums<N2, kSpan, 3, 2>(x + kSpan, parts + kSpan * N2 + k, hi);
#pragma unroll
      for (int pi = 0; pi < 3; ++pi) s[pi] = __fadd_rn(s[pi], hi[pi]);
    }
    const float y =
        __fadd_rn(__fadd_rn(__fadd_rn(s[0], s[1]), s[2]), __ldg(bias + k));
    store.one(idx, quantize_coeff(y, k, ad, ad ? recip[idx / N2] : 1.f));
  }
}

}  // namespace dct
