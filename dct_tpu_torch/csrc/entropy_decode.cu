// Kernel D: the device entropy decode of indexed (version 2) containers.
//
// Replaces dct_tpu/ops/entropy_decode_pallas.py `_decode_kernel` (:124,
// launched by `decode_call` at :535). With the container's per-block decode
// index every block is an independent substream, so the unit of
// parallelism is the block: one thread decodes one block, from its first
// bit (the wrapper's cumsum of the index) to its last, and writes the
// block's n2 int16 zigzag coefficients, zeros included. int16 is the host
// decoder's type and kernel C's input, so D's output feeds C as it is.
//
// Per symbol, as the reference's lanes do (ops/entropy_decode.py has the
// plain version): a canonical value code of at most 16 bits, the mode's
// payload (category: `cat` extra bits with the JPEG sign rule; direct: the
// alphabet value, or after ESC a raw sign-extended 16-bit value; none: a
// raw 16-bit value), the run field (fixed `run_bits` wide, or a second
// canonical code when run_bits == 0), then the RLE expand `pos += run;
// write if pos < n2; ++pos`, until pos >= n2 or the cursor reaches the
// block's end. Bits are MSB-first. Each thread keeps a 64-bit buffer,
// refilled byte by byte to at least 57 valid bits before each symbol (a
// symbol needs at most 48); bytes past the payload read as zero, so no
// thread reads outside the payload or writes outside its block, whatever
// the index says. The tables (first/limit/base per code length for values
// and runs, the 16 category symbols, the 65 run symbols, and the direct
// value table up to kSmemVtab entries) sit in shared memory, loaded by
// each CTA; a longer direct table (only a hostile container has one) is
// read from device memory.
//
// What bounds it on an H100: memory. At the 8 x 1088x1920 batch it reads
// about 8 MB of payload and 0.5 MB of index (plus 2 MB of int64 block
// starts) and writes 33.4 MB of coefficients: about 42 MB, or about
// 12.5 us at 3.35 TB/s. What this simple design leaves on the table: each
// thread stores its own block, so a warp's stores land n2 x 2 bytes apart
// and are not coalesced; the decode is serial per block, so a single frame
// (32,400 blocks, ~8 warps per SM) runs at low occupancy. Staging blocks
// in shared memory for coalesced stores is later work.

#include "bindings.h"

namespace {

constexpr int kThreads = 128;
// Offsets of the packed table vector (TABLE_FIELDS in
// dct_tpu_torch/ops/entropy_decode.py); the direct value table follows.
constexpr int kVFirst = 0, kVLimit = 17, kVBase = 34;
constexpr int kRFirst = 51, kRLimit = 68, kRBase = 85;
constexpr int kCSym = 102, kRSym = 118, kFixed = 183;
constexpr int kRunAlphabet = 65;
constexpr int kSmemVtab = 2048;
constexpr int kEsc = 1 << 20;  // ESC slot of the direct value table
enum { kCategory = 0, kDirect = 1, kNone = 2 };

// MSB-first reader: `n` valid bits at the top of `buf`, zeros below.
struct BitReader {
  const uint8_t* data;
  long long n_bytes;
  long long next;  // next payload byte to load
  uint64_t buf;
  int n;

  __device__ void init(const uint8_t* d, long long nb, long long bit) {
    data = d;
    n_bytes = nb;
    next = bit >> 3;
    buf = 0;
    n = 0;
    refill();
    skip(static_cast<int>(bit & 7));
  }
  __device__ __forceinline__ void refill() {
    while (n <= 56) {
      const uint64_t byte = next < n_bytes ? __ldg(data + next) : 0;
      buf |= byte << (56 - n);
      n += 8;
      ++next;
    }
  }
  // the next k bits, 1 <= k <= 32
  __device__ __forceinline__ uint32_t peek(int k) const {
    return static_cast<uint32_t>(buf >> (64 - k));
  }
  __device__ __forceinline__ void skip(int k) {
    buf <<= k;
    n -= k;
  }
};

// <= 16-bit canonical decode of the window t16: the canonical index, and
// the code length in *len (0, with index 0, where no code matches).
__device__ __forceinline__ int canon_decode(uint32_t t16, const int* first,
                                            const int* limit, const int* base,
                                            int* len) {
  for (int L = 1; L <= 16; ++L) {
    const int c = static_cast<int>(t16 >> (16 - L));
    if (c >= first[L] && c < limit[L]) {
      *len = L;
      return base[L] + c - first[L];
    }
  }
  *len = 0;
  return 0;
}

__global__ void __launch_bounds__(kThreads)
    entropy_decode_kernel(const uint8_t* __restrict__ payload,
                          long long payload_bytes,
                          const long long* __restrict__ block_start,
                          const uint16_t* __restrict__ block_bits,
                          const int* __restrict__ tabs, int n_vtab,
                          int16_t* __restrict__ out, long long n_blocks,
                          int n2, int mode, int run_bits) {
  extern __shared__ int s_tab[];
  const bool vtab_in_smem = n_vtab <= kSmemVtab;
  const int n_load = kFixed + (vtab_in_smem ? n_vtab : 0);
  for (int i = threadIdx.x; i < n_load; i += blockDim.x) s_tab[i] = tabs[i];
  __syncthreads();
  const int* vtab = vtab_in_smem ? s_tab + kFixed : tabs + kFixed;

  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= n_blocks) return;
  int16_t* o = out + b * n2;
  long long cur = block_start[b];
  const long long end = cur + block_bits[b];
  BitReader r;
  r.init(payload, payload_bytes, cur);
  int pos = 0, filled = 0;  // filled: first position not yet stored
  while (pos < n2 && cur < end) {
    r.refill();
    int v, gv, ln;
    if (mode == kCategory) {
      const int idx = canon_decode(r.peek(16), s_tab + kVFirst,
                                   s_tab + kVLimit, s_tab + kVBase, &ln);
      const int cat = (ln > 0 && idx < 16) ? s_tab[kCSym + idx] : 0;
      r.skip(ln);
      v = 0;
      if (cat > 0) {
        const int e = static_cast<int>(r.peek(cat));
        r.skip(cat);
        v = e < (1 << (cat - 1)) ? e - (1 << cat) + 1 : e;
      }
      gv = ln + cat;
    } else if (mode == kDirect) {
      const int idx = canon_decode(r.peek(16), s_tab + kVFirst,
                                   s_tab + kVLimit, s_tab + kVBase, &ln);
      r.skip(ln);
      v = idx < n_vtab ? vtab[idx] : 0;
      gv = ln;
      if (v == kEsc) {
        v = static_cast<int16_t>(r.peek(16));
        r.skip(16);
        gv += 16;
      }
    } else {
      v = static_cast<int16_t>(r.peek(16));
      r.skip(16);
      gv = 16;
    }
    int run, lc;
    if (run_bits == 0) {  // coded runs
      const int ridx = canon_decode(r.peek(16), s_tab + kRFirst,
                                    s_tab + kRLimit, s_tab + kRBase, &lc);
      run = ridx < kRunAlphabet ? s_tab[kRSym + ridx] : 0;
    } else {
      run = static_cast<int>(r.peek(run_bits));
      lc = run_bits;
    }
    r.skip(lc);
    cur += gv + lc;
    const int wpos = pos + run;
    if (wpos < n2) {
      for (; filled < wpos; ++filled) o[filled] = 0;
      o[wpos] = static_cast<int16_t>(v);
      filled = pos = wpos + 1;
    } else {
      pos = wpos;
    }
  }
  for (; filled < n2; ++filled) o[filled] = 0;
}

}  // namespace

DCT_EXPORT int dct_entropy_decode(const void* payload, long long payload_bytes,
                                  const void* block_start,
                                  const void* block_bits, const void* tabs,
                                  int n_vtab, void* out, long long n_blocks,
                                  int n2, int mode, int run_bits,
                                  void* stream) {
  const size_t smem =
      sizeof(int) * (kFixed + (n_vtab <= kSmemVtab ? n_vtab : 0));
  const long long grid = (n_blocks + kThreads - 1) / kThreads;
  entropy_decode_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), payload_bytes,
      static_cast<const long long*>(block_start),
      static_cast<const uint16_t*>(block_bits),
      static_cast<const int*>(tabs), n_vtab, static_cast<int16_t*>(out),
      n_blocks, n2, mode, run_bits);
  return static_cast<int>(cudaGetLastError());
}

DCT_EXPORT const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
