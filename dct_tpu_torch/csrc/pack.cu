// Kernel E: the chunk packer — symbol chunks to 16-bit stream units, one
// CTA per stripe.
//
// Replaces dct_tpu/ops/pack_pallas.py `_pack_kernel` (:46, launched by
// `pack_chunks_pallas` at :121). Its input is what symbol_chunks yields:
// (n_stripes, C, 3) int32 chunk values and bit lengths (code, payload and run
// field of every positional RLE slot; dead slots have length 0). Chunk k of
// a stripe starts at the exclusive prefix sum of the lengths before it in
// the stripe's flattened chunk axis; the kernel does that scan itself (the
// JAX wrapper did it in XLA). A chunk of cl <= 16 bits at bit offset `off`
// lies in the 32-bit window `cv << (32 - cl - (off & 15))` aligned at unit
// `off >> 4`: its high half goes to that unit, its low half to the next.
// The TPU kernel's tiling (TILE, _span, 128-aligned tile bases, the one-hot
// compare-reduce) was lane layout and has no counterpart here.
//
// The CTA zeroes its stripe's units, then walks the chunks in tiles of
// kThreads, one chunk per thread: a warp-shuffle scan of the lengths, a
// scan of the warp totals in shared memory, and a carry between tiles. Each
// live chunk ORs its halves into the zeroed word buffer with atomicOr.
// Fields never share a bit (values hold no bit above their length), so OR
// equals the plain version's scatter-add and the order of the atomics does
// not matter. Words hold two units with their halves swapped, as kernel B
// writes them, so the buffer read as int16 is the unit stream in order.
// Units at or past `capacity` are dropped, as the plain version's dump slot
// drops them; dead chunks write nothing.
//
// What bounds it on an H100: memory. It reads every chunk's int32 value
// and length (8 B a chunk) and writes the stripe's units once; at the
// 8 x 1088x1920 batch that is ~0.4 GB of chunks and 84 MB of units,
// ~0.14 ms at 3.35 TB/s. Loads are coalesced; what this simple design
// leaves on the table is one atomic per live unit half in L2 and two block
// barriers per tile. Staging a tile's units in shared memory, and reading
// the fields packed narrower, is later work.

#include "bindings.h"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    pack_chunks_kernel(const int* __restrict__ cv, const int* __restrict__ cl,
                       long long n_chunks, long long capacity,
                       unsigned* __restrict__ words, long long n_words,
                       int* __restrict__ stripe_bits) {
  __shared__ int s_warp[kWarps];  // exclusive prefix of each warp's total
  __shared__ int s_tile;          // the tile's total bits

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long stripe = blockIdx.x;
  const int* vrow = cv + stripe * n_chunks;
  const int* lrow = cl + stripe * n_chunks;
  unsigned* row = words + stripe * n_words;

  for (long long i = tid; i < n_words; i += kThreads) row[i] = 0u;
  __syncthreads();

  long long carry = 0;  // bits of the tiles before this one
  for (long long base = 0; base < n_chunks; base += kThreads) {
    const long long i = base + tid;
    const int len = i < n_chunks ? lrow[i] : 0;
    const unsigned long long val =
        i < n_chunks ? static_cast<unsigned>(vrow[i]) : 0ull;

    const int incl = warp_inclusive_scan(len, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < kWarps ? s_warp[lane] : 0;
      const int wi = warp_inclusive_scan(w, lane);
      if (lane < kWarps) s_warp[lane] = wi - w;
      if (lane == 31) s_tile = wi;
    }
    __syncthreads();

    if (len > 0) {
      const long long off = carry + s_warp[warp] + incl - len;
      // the plain version's window: shift clamped to [0, 31]
      const int shift = min(max(32 - len - static_cast<int>(off & 15), 0), 31);
      const unsigned window =
          static_cast<unsigned>((val << shift) & 0xFFFFFFFFull);
      const unsigned hi = window >> 16, lo = window & 0xFFFFu;
      const long long u0 = off >> 4;
      if ((u0 & 1) == 0) {  // units u0, u0 + 1 share word u0 / 2
        unsigned w = 0u;
        if (u0 < capacity) w |= hi;
        if (u0 + 1 < capacity) w |= lo << 16;
        if (w != 0u) atomicOr(row + (u0 >> 1), w);
      } else {  // u0 ends word u0 / 2, u0 + 1 starts the next
        if (hi != 0u && u0 < capacity) atomicOr(row + (u0 >> 1), hi << 16);
        if (lo != 0u && u0 + 1 < capacity) atomicOr(row + ((u0 + 1) >> 1), lo);
      }
    }
    carry += s_tile;
    __syncthreads();  // s_warp and s_tile are rewritten by the next tile
  }
  if (tid == 0) stripe_bits[stripe] = static_cast<int>(carry);
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
