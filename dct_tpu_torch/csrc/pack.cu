// Kernel E: the chunk packer — symbol chunks to 16-bit stream units, one
// CTA per stripe.
//
// Replaces dct_tpu/ops/pack_pallas.py `_pack_kernel` (:46, launched by
// `pack_chunks_pallas` at :121). Its input is what symbol_chunks yields:
// (n_stripes, C, 3) int32 chunk values and bit lengths (code, payload and run
// field of every positional RLE slot; dead slots have length 0 and any
// value). Chunk k of a stripe starts at the exclusive prefix sum of the
// lengths before it in the stripe's flattened chunk axis; the kernel does
// that scan itself (the JAX wrapper did it in XLA). The TPU kernel's tiling
// (TILE, _span, 128-aligned tile bases, the one-hot compare-reduce) was lane
// layout and has no counterpart here.
//
// The design, against what bounded the first port (one chunk a thread, a
// tile's DRAM loads exposed behind its scan and barriers, one L2 atomic a
// unit half, the whole unit buffer zeroed first):
// - A thread takes kPer = 4 consecutive chunks (16-byte loads of values and
//   lengths; a row whose start is not 16-byte aligned, and a row's ragged
//   end, load them one by one), so a tile is 2,048 chunks. It packs its
//   chunks MSB-first into one 64-bit field, and the tile scans the fields'
//   lengths: within the warp by shuffles, across warps through shared
//   memory, plus the stripe's bits before the tile.
// - The next tile's loads are issued before this tile's scan and barriers,
//   so their DRAM latency overlaps the work.
// - Each thread ORs its field (at most 64 bits, so at most three 32-bit
//   words) into a shared-memory window of words with shared atomics. A tile
//   of 2,048 chunks of <= 16 bits spans at most 1,025 words. The finished
//   words are written to device memory with coalesced stores; the word
//   that straddles into the next tile is carried into the other of two
//   windows, so a tile takes two barriers.
// - Only what no tile writes is zeroed: from the stripe's last word up to
//   the capacity. Units at or past `capacity` are dropped, as the plain
//   version's dump slot drops them. Fields never share a bit (values hold
//   no bit above their length), so OR equals the plain version's
//   scatter-add. Words hold two units with their halves swapped, as kernel
//   B writes them, so the buffer read as int16 is the unit stream in order.
// - Waves: at 40 registers a thread, 3 CTAs of 512 threads fit an SM (396
//   on an H100), so the batch's 1,088 stripes run in 2.75 waves and a
//   32-frame video's 4,320 in 10.9: no wave is nearly empty. A persistent
//   grid that gave every CTA the same number of stripes measured the same.
//
// What bounds it on an H100: memory. It reads every chunk's int32 value
// and length (8 B a chunk) and writes the stripe's units once; at the
// 8 x 1088x1920 batch that is ~0.4 GB of chunks and 84 MB of units,
// ~0.14 ms at 3.35 TB/s. What remains: the int32 chunk tensors themselves
// (24 B a coefficient, though a chunk needs 21 bits), which only fusing
// symbol_chunks into the packer would remove.

#include "bindings.h"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                         // chunks a thread
constexpr int kTileChunks = kThreads * kPer;    // chunks a tile
constexpr int kWin = 1040;  // window words: a tile's 1,025 + the carry
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// A thread's chunks: values and lengths of chunks i..i+3 of a row.
struct Chunks {
  int4 v, l;
};

__device__ __forceinline__ Chunks load_chunks(const int* vrow, const int* lrow,
                                              long long i, long long n,
                                              bool aligned) {
  Chunks c;
  if (aligned && i + kPer <= n) {
    c.v = __ldg(reinterpret_cast<const int4*>(vrow + i));
    c.l = __ldg(reinterpret_cast<const int4*>(lrow + i));
  } else {
    int v[kPer], l[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = i + k < n ? __ldg(vrow + i + k) : 0;
      l[k] = i + k < n ? __ldg(lrow + i + k) : 0;
    }
    c.v = make_int4(v[0], v[1], v[2], v[3]);
    c.l = make_int4(l[0], l[1], l[2], l[3]);
  }
  return c;
}

__device__ __forceinline__ void append(uint64_t& acc, int& len, int v, int l) {
  acc = (acc << l) | (static_cast<uint32_t>(v) & ((1u << l) - 1u));
  len += l;
}

// A stream word (MSB-first) as stored: its two units with halves swapped.
__device__ __forceinline__ unsigned stored(unsigned w) {
  return __funnelshift_l(w, w, 16);
}

// Zero words [a, e) of a row, 16-byte stores where the addresses allow.
__device__ void zero_words(unsigned* row, long long a, long long e, int tid) {
  long long k16 = a + ((4 - ((reinterpret_cast<uintptr_t>(row + a) & 15) >> 2))
                       & 3);
  if (k16 > e) k16 = e;
  if (tid < k16 - a) row[a + tid] = 0u;
  const long long n_vec = (e - k16) >> 2;
  uint4* v = reinterpret_cast<uint4*>(row + k16);
  for (long long i = tid; i < n_vec; i += kThreads)
    v[i] = make_uint4(0, 0, 0, 0);
  const long long tail = k16 + 4 * n_vec;
  if (tid < e - tail) row[tail + tid] = 0u;
}

__global__ void __launch_bounds__(kThreads)
    pack_chunks_kernel(const int* __restrict__ cv, const int* __restrict__ cl,
                       long long n_chunks, long long capacity,
                       unsigned* __restrict__ words, long long n_words,
                       int* __restrict__ stripe_bits) {
  __shared__ unsigned s_win[2][kWin];
  __shared__ int s_warp[kWarps];  // each warp's total bits in the tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 2 * kWin; i += kThreads) (&s_win[0][0])[i] = 0u;
  __syncthreads();

  const long long stripe = blockIdx.x;
  const int* vrow = cv + stripe * n_chunks;
  const int* lrow = cl + stripe * n_chunks;
  unsigned* row = words + stripe * n_words;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(vrow) | reinterpret_cast<uintptr_t>(lrow))
       & 15) == 0;
  // stream word g of the row, stored; units at or past capacity are dropped
  const long long last_word = (capacity - 1) >> 1;
  const unsigned last_mask = (capacity & 1) ? 0xFFFFu : kFull;
  auto put = [&](long long g, unsigned v) {
    if (g < last_word) row[g] = v;
    else if (g == last_word) row[g] = v & last_mask;
  };

  long long carry = 0;  // bits of the tiles before this one
  int buf = 0;          // the window this tile ORs into
  Chunks cur = load_chunks(vrow, lrow, kPer * tid, n_chunks, aligned);
  for (long long base = 0; base < n_chunks; base += kTileChunks) {
    const Chunks next = load_chunks(
        vrow, lrow, base + kTileChunks + kPer * tid, n_chunks, aligned);
    uint64_t acc = 0;
    int len = 0;
    append(acc, len, cur.v.x, cur.l.x);
    append(acc, len, cur.v.y, cur.l.y);
    append(acc, len, cur.v.z, cur.l.z);
    append(acc, len, cur.v.w, cur.l.w);

    const int incl = warp_inclusive_scan(len, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    const int w = lane < kWarps ? s_warp[lane] : 0;
    const int wi = warp_inclusive_scan(w, lane);
    const int warp_before = __shfl_sync(kFull, wi - w, warp);
    const int tile_bits = __shfl_sync(kFull, wi, kWarps - 1);
    const long long win_base = carry >> 5;
    unsigned* win = s_win[buf];

    if (len > 0) {
      const long long off = carry + warp_before + incl - len;
      const int t = 96 - static_cast<int>(off & 31) - len;  // 1..95
      const uint64_t hi = t >= 32 ? acc << (t - 32) : acc >> (32 - t);
      const unsigned lo = t >= 32 ? 0u : static_cast<unsigned>(acc << t);
      unsigned* dst = win + ((off >> 5) - win_base);
      const unsigned w0 = static_cast<unsigned>(hi >> 32);
      const unsigned w1 = static_cast<unsigned>(hi);
      if (w0) atomicOr(dst, stored(w0));
      if (w1) atomicOr(dst + 1, stored(w1));
      if (lo) atomicOr(dst + 2, stored(lo));
    }
    __syncthreads();

    // words before the one holding the new carry are final
    const long long end = carry + tile_bits;
    const int n_final = static_cast<int>((end >> 5) - win_base);
    for (int k = tid; k < n_final; k += kThreads) {
      put(win_base + k, win[k]);
      win[k] = 0u;
    }
    if (tid == 0) {
      s_win[buf ^ 1][0] = win[n_final];
      win[n_final] = 0u;
    }
    carry = end;
    buf ^= 1;
    cur = next;
  }
  // the partial last word, then zeros up to the capacity
  const long long used = (carry + 31) >> 5;
  if (tid == 0) {
    if (carry & 31) put(carry >> 5, s_win[buf][0]);
    stripe_bits[stripe] = static_cast<int>(carry);
  }
  if (used < n_words) zero_words(row, used, n_words, tid);
}

}  // namespace

DCT_EXPORT int dct_pack_chunks(const void* cv, const void* cl, int n_stripes,
                               long long n_chunks, long long capacity,
                               void* words, long long n_words,
                               void* stripe_bits, void* stream) {
  if (n_stripes <= 0) return 0;
  pack_chunks_kernel<<<n_stripes, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cv), static_cast<const int*>(cl), n_chunks,
      capacity, static_cast<unsigned*>(words), n_words,
      static_cast<int*>(stripe_bits));
  return static_cast<int>(cudaGetLastError());
}

DCT_EXPORT const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
