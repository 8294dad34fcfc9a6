// Native host-side runtime for lsdradixsort.
//
// The framework's counterpart of the reference's C++ host layer:
//   * CPU golden models (reference: LSDRadixSort.cu:25-69 LSD sort,
//     cu:128-139 exclusive prefix sum, cu:643-658 per-block histograms,
//     cu:483-494 transpose) — used as both correctness oracles and the
//     CPU-vs-accelerator baseline the benchmark harness reports
//     (reference: cu:984-990).
//   * Seeded RNG data generation (reference: Utils.h:24-33).
//   * Element-wise verification (reference: CheckArrays, Utils.cpp:62-68).
//
// Not a port: the sort is a cache-friendly byte-radix with per-pass counters
// and ping-pong buffers, written for modern x86/ARM hosts, and everything is
// exposed as a flat C ABI consumed via ctypes (no pybind11 dependency).
//
// Build: make -C native    (produces liblsdnative.so)

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Seeded RNG (splitmix64 -> uniform in [lo, hi]); deterministic across
// platforms, unlike std::default_random_engine. Reference: Utils.h:24-33.
// ---------------------------------------------------------------------------
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void lsd_fill_random_u32(uint32_t* out, int64_t n, uint64_t seed,
                         uint32_t lo, uint32_t hi) {
  uint64_t s = seed * 0x2545F4914F6CDD1Dull + 0x9E3779B97F4A7C15ull;
  const uint64_t span = (uint64_t)(hi - lo) + 1;  // hi inclusive
  for (int64_t i = 0; i < n; ++i) {
    uint64_t r = splitmix64(s);
    out[i] = span ? lo + (uint32_t)(r % span) : (uint32_t)r;
  }
}

// ---------------------------------------------------------------------------
// CheckArrays: first mismatching index, or -1 if equal.
// Reference: Utils.cpp:62-68 (asserts a[i]==b[i] for all i).
// ---------------------------------------------------------------------------
int64_t lsd_check_arrays_u32(const uint32_t* a, const uint32_t* b, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    if (a[i] != b[i]) return i;
  return -1;
}

int64_t lsd_check_sorted_u32(const uint32_t* a, int64_t n) {
  for (int64_t i = 1; i < n; ++i)
    if (a[i - 1] > a[i]) return i;
  return -1;
}

// ---------------------------------------------------------------------------
// Exclusive prefix sum. Reference: PrefixSum, LSDRadixSort.cu:128-139.
// ---------------------------------------------------------------------------
void lsd_exclusive_prefix_sum_u32(const uint32_t* in, uint32_t* out,
                                  int64_t n) {
  uint32_t acc = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t v = in[i];
    out[i] = acc;
    acc += v;  // wraps mod 2^32, same as the reference's uint32 arithmetic
  }
}

// ---------------------------------------------------------------------------
// Per-block digit histograms: out[b * (1<<r) + digit] counts r-bit digit
// `group` in keys[b*block : (b+1)*block]. Requires n % block == 0, r <= 16.
// Reference: BuildHistogramsCPU, LSDRadixSort.cu:643-658.
// ---------------------------------------------------------------------------
void lsd_block_histograms_u32(const uint32_t* keys, int64_t n, int64_t block,
                              int r, int group, uint32_t* out) {
  const uint32_t mask = (uint32_t)((1u << r) - 1);
  const int shift = r * group;
  const int64_t bins = (int64_t)1 << r;
  const int64_t nb = n / block;
  memset(out, 0, sizeof(uint32_t) * (size_t)(nb * bins));
  for (int64_t b = 0; b < nb; ++b) {
    uint32_t* h = out + b * bins;
    const uint32_t* p = keys + b * block;
    for (int64_t i = 0; i < block; ++i) ++h[(p[i] >> shift) & mask];
  }
}

// ---------------------------------------------------------------------------
// Matrix transpose (rows x cols, row-major u32).
// Reference: Transpose, LSDRadixSort.cu:483-494.
// ---------------------------------------------------------------------------
void lsd_transpose_u32(const uint32_t* in, uint32_t* out, int64_t rows,
                       int64_t cols) {
  // simple blocked transpose for cache friendliness
  const int64_t B = 64;
  for (int64_t r0 = 0; r0 < rows; r0 += B)
    for (int64_t c0 = 0; c0 < cols; c0 += B) {
      int64_t r1 = r0 + B < rows ? r0 + B : rows;
      int64_t c1 = c0 + B < cols ? c0 + B : cols;
      for (int64_t r = r0; r < r1; ++r)
        for (int64_t c = c0; c < c1; ++c) out[c * rows + r] = in[r * cols + c];
    }
}

// ---------------------------------------------------------------------------
// Stable LSD radix sort, keys only. Byte-radix (r=8, 4 passes) regardless of
// the `r` the device pipeline uses — it is the host oracle/baseline, and byte
// passes are the fast CPU configuration. Semantics match the reference's
// LSDRadixSort (cu:25-69): ascending, stable, full 32 bits.
// `tmp` must hold n u32. Result is left in `keys`.
// ---------------------------------------------------------------------------
void lsd_radix_sort_u32(uint32_t* keys, uint32_t* tmp, int64_t n) {
  uint32_t* a = keys;
  uint32_t* b = tmp;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 8;
    int64_t count[256] = {0};
    for (int64_t i = 0; i < n; ++i) ++count[(a[i] >> shift) & 0xFF];
    int64_t off[256];
    int64_t acc = 0;
    for (int d = 0; d < 256; ++d) { off[d] = acc; acc += count[d]; }
    for (int64_t i = 0; i < n; ++i) b[off[(a[i] >> shift) & 0xFF]++] = a[i];
    uint32_t* t = a; a = b; b = t;
  }
  // 4 passes = even number of swaps, result already back in `keys`
}

// Stable LSD radix sort of (key, value) pairs; both u32, n elements each.
void lsd_radix_sort_kv_u32(uint32_t* keys, uint32_t* vals, uint32_t* tmpk,
                           uint32_t* tmpv, int64_t n) {
  uint32_t *ak = keys, *av = vals, *bk = tmpk, *bv = tmpv;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 8;
    int64_t count[256] = {0};
    for (int64_t i = 0; i < n; ++i) ++count[(ak[i] >> shift) & 0xFF];
    int64_t off[256];
    int64_t acc = 0;
    for (int d = 0; d < 256; ++d) { off[d] = acc; acc += count[d]; }
    for (int64_t i = 0; i < n; ++i) {
      int64_t dst = off[(ak[i] >> shift) & 0xFF]++;
      bk[dst] = ak[i];
      bv[dst] = av[i];
    }
    uint32_t* t;
    t = ak; ak = bk; bk = t;
    t = av; av = bv; bv = t;
  }
}

// Single LSD pass (histogram -> scan -> stable permute) for digit `group`
// of width r bits: the oracle for the device per-pass pipeline.
// Reference: LSDRadixSortPass, LSDRadixSort.cu:25-54.
void lsd_radix_sort_pass_u32(const uint32_t* in, uint32_t* out, int64_t n,
                             int r, int group) {
  const uint32_t mask = (uint32_t)((1u << r) - 1);
  const int shift = r * group;
  const int64_t bins = (int64_t)1 << r;
  std::vector<int64_t> off((size_t)bins, 0);
  for (int64_t i = 0; i < n; ++i) ++off[(in[i] >> shift) & mask];
  int64_t acc = 0;
  for (int64_t d = 0; d < bins; ++d) {
    int64_t c = off[(size_t)d];
    off[(size_t)d] = acc;
    acc += c;
  }
  for (int64_t i = 0; i < n; ++i) out[off[(in[i] >> shift) & mask]++] = in[i];
}

}  // extern "C"
