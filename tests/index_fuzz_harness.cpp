// index_fuzz_harness.cpp — runs dctbits_unpack_index (the port's
// csrc/host/bitpack.cpp) on the cases of one file, for a build under
// AddressSanitizer and UndefinedBehaviorSanitizer
// (tests/test_torch_native_fuzz.py).
//
// Each buffer is allocated at exactly the size the entry point is given,
// so a read past nbytes or past n_stripes stripe lengths, or a write past
// n_stripes * bps entries, is a sanitizer report. Where the arguments
// name more than 2^24 entries, or more stripe lengths than the case
// carries, the output (or the lengths) is a null pointer: the call must
// refuse them before touching either.
//
// Case file (little-endian), cases back to back:
//   i32 w, i32 n_stripes, i32 bps, u64 nbytes, u32 n_lengths,
//   n_lengths x u32 stripe lengths, nbytes bytes of index.
// Prints one line a case: "rc=<code>" and, where entries were written
// (codes 0-2), " sum=<sum of the entries>".

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" int dctbits_unpack_index(const uint8_t* raw, uint64_t nbytes,
                                    int n_stripes, int bps, int w,
                                    const uint32_t* stripe_bits,
                                    uint16_t* out);

template <typename T>
static bool take(FILE* f, T* v) {
  return fread(v, sizeof(T), 1, f) == 1;
}

int main(int argc, char** argv) {
  if (argc != 2) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  int32_t w, n_stripes, bps;
  uint64_t nbytes;
  uint32_t n_lengths;
  while (take(f, &w)) {
    if (!take(f, &n_stripes) || !take(f, &bps) || !take(f, &nbytes) ||
        !take(f, &n_lengths))
      return 2;
    uint32_t* lengths = nullptr;
    if (n_lengths) {
      lengths = static_cast<uint32_t*>(malloc(4 * (size_t)n_lengths));
      if (fread(lengths, 4, n_lengths, f) != n_lengths) return 2;
    }
    uint8_t* raw = static_cast<uint8_t*>(malloc(nbytes));
    if (nbytes && fread(raw, 1, nbytes, f) != nbytes) return 2;
    const int64_t n = (int64_t)n_stripes * bps;
    const bool sized = n_stripes >= 1 && bps >= 1 && n <= (1 << 24) &&
                       (uint32_t)n_stripes <= n_lengths;
    uint16_t* out =
        sized ? static_cast<uint16_t*>(malloc(2 * (size_t)n)) : nullptr;
    int rc = dctbits_unpack_index(raw, nbytes, n_stripes, bps, w,
                                  sized ? lengths : nullptr, out);
    printf("rc=%d", rc);
    if (rc <= 2 && out) {
      uint64_t sum = 0;
      for (int64_t i = 0; i < n; ++i) sum += out[i];
      printf(" sum=%llu", (unsigned long long)sum);
    }
    printf("\n");
    free(out);
    free(raw);
    free(lengths);
  }
  fclose(f);
  return 0;
}
