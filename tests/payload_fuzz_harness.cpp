// payload_fuzz_harness.cpp — runs dctbits_pack_payload (the port's
// csrc/host/bitpack.cpp) on the cases of one file, for a build under
// AddressSanitizer and UndefinedBehaviorSanitizer
// (tests/test_torch_native_fuzz.py).
//
// Each buffer is allocated at exactly the size the case gives it: the
// units and bit lengths the case carries, out_cap bytes of output and
// n + 1 offsets, so a read or a write past any of them is a sanitizer
// report. Where the case carries none, or n is out of range, the pointer
// is null: the call must refuse it before touching it.
//
// Case file (little-endian), cases back to back:
//   i64 n, i64 U, u64 out_cap, u64 n_bits, u64 n_units,
//   n_bits x i64 bit lengths, n_units x u16 units.
// Prints one line a case: "rc=0 out=<hex of the payload> offsets=<the
// n + 1 offsets>", or "rc=<code> untouched" where the call wrote nothing
// ("touched" where it did).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" int dctbits_pack_payload(const uint16_t* units, int64_t U,
                                    const int64_t* bits, int64_t n,
                                    uint8_t* out, uint64_t out_cap,
                                    uint64_t* offsets);

template <typename T>
static bool take(FILE* f, T* v) {
  return fread(v, sizeof(T), 1, f) == 1;
}

template <typename T>
static T* load(FILE* f, uint64_t count, bool* ok) {
  if (!count) return nullptr;
  T* p = static_cast<T*>(malloc(sizeof(T) * count));
  *ok = *ok && fread(p, sizeof(T), count, f) == count;
  return p;
}

int main(int argc, char** argv) {
  if (argc != 2) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  int64_t n, U;
  uint64_t cap, n_bits, n_units;
  while (take(f, &n)) {
    if (!take(f, &U) || !take(f, &cap) || !take(f, &n_bits) ||
        !take(f, &n_units))
      return 2;
    bool ok = true;
    int64_t* bits = load<int64_t>(f, n_bits, &ok);
    uint16_t* units = load<uint16_t>(f, n_units, &ok);
    if (!ok) return 2;
    const bool sized = n >= 0 && n <= (1 << 24);
    const size_t n_off = sized ? (size_t)n + 1 : 0;
    uint8_t* out = static_cast<uint8_t*>(malloc(cap ? cap : 1));
    uint64_t* offsets =
        sized ? static_cast<uint64_t*>(malloc(8 * n_off)) : nullptr;
    memset(out, 0xAB, cap);
    if (offsets) memset(offsets, 0xAB, 8 * n_off);
    int rc = dctbits_pack_payload(units, U, bits, n, out, cap, offsets);
    printf("rc=%d", rc);
    if (rc == 0) {
      printf(" out=");
      for (uint64_t i = 0; i < offsets[n]; ++i) printf("%02x", out[i]);
      printf(" offsets=");
      for (size_t i = 0; i < n_off; ++i)
        printf(i ? ",%llu" : "%llu", (unsigned long long)offsets[i]);
    } else {
      bool same = true;
      for (uint64_t i = 0; i < cap; ++i) same = same && out[i] == 0xAB;
      for (size_t i = 0; i < 8 * n_off; ++i)
        same = same && reinterpret_cast<uint8_t*>(offsets)[i] == 0xAB;
      printf(same ? " untouched" : " touched");
    }
    printf("\n");
    free(offsets);
    free(out);
    free(units);
    free(bits);
  }
  fclose(f);
  return 0;
}
