// motiondata: the port's native host-side data runtime.
//
// npy (v1/v2) float32 loading, strided window slicing, normalization
// statistics and deterministic epoch index shuffles, multithreaded C++
// behind a C ABI that bridgerl_tpu_torch/runtime/native.py binds with
// ctypes. Host code only: nothing here touches the card.
//
// Built at first use by native.py::ensure_built with
//   g++ -O3 -std=c++17 -fPIC -pthread -shared
// into bridgerl_tpu_torch/_build/ (never into the source tree).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// Parallel-for over [0, n) in contiguous chunks.
template <typename F>
void parallel_for(int64_t n, F&& fn) {
  int nt = hw_threads();
  if (n < 1024 || nt <= 1) {
    fn(int64_t{0}, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([lo, hi, &fn] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// Minimal npy header parse: returns element count and shape (up to 4 dims).
// Only little-endian float32 ('<f4'), C-order arrays are supported.
bool parse_npy_header(FILE* f, int64_t shape[4], int* ndim, int64_t* count) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (static_cast<uint32_t>(b[3]) << 24);
  }
  std::string header(hlen, '\0');
  if (fread(header.data(), 1, hlen, f) != hlen) return false;
  if (header.find("'<f4'") == std::string::npos) return false;
  if (header.find("'fortran_order': False") == std::string::npos) return false;
  size_t p = header.find("'shape': (");
  if (p == std::string::npos) return false;
  p += 10;
  size_t end = header.find(')', p);
  std::string dims = header.substr(p, end - p);
  *ndim = 0;
  *count = 1;
  const char* s = dims.c_str();
  char* next = nullptr;
  while (*s && *ndim < 4) {
    long long v = strtoll(s, &next, 10);
    if (next == s) break;
    shape[(*ndim)++] = v;
    *count *= v;
    s = next;
    while (*s == ',' || *s == ' ') ++s;
  }
  return *ndim > 0;
}

}  // namespace

extern "C" {

// Load a float32 npy file. Returns 0 on success; caller frees with md_free.
int md_load_npy_f32(const char* path, float** data, int64_t shape[4], int* ndim) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  int64_t count = 0;
  if (!parse_npy_header(f, shape, ndim, &count)) {
    fclose(f);
    return 2;
  }
  float* buf = static_cast<float*>(malloc(count * sizeof(float)));
  if (!buf) {
    fclose(f);
    return 3;
  }
  if (fread(buf, sizeof(float), count, f) != static_cast<size_t>(count)) {
    free(buf);
    fclose(f);
    return 4;
  }
  fclose(f);
  *data = buf;
  return 0;
}

void md_free(void* p) { free(p); }

// Number of windows for (T, window, stride); 0 if T < window.
int64_t md_num_windows(int64_t T, int64_t window, int64_t stride) {
  if (T < window) return 0;
  return (T - window) / stride + 1;
}

// Strided window slicing: motion (T, D) -> out (K, window, D), K as above.
// Multithreaded over windows; pure memcpy per row.
int md_slice_windows(const float* motion, int64_t T, int64_t D, int64_t window,
                     int64_t stride, float* out) {
  int64_t K = md_num_windows(T, window, stride);
  if (K <= 0) return 0;
  parallel_for(K, [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      const float* src = motion + k * stride * D;
      float* dst = out + k * window * D;
      memcpy(dst, src, window * D * sizeof(float));
    }
  });
  return 0;
}

// Per-dim mean/std over flattened frames: data (N, D) -> mean (D), std (D)+eps.
// Two-pass, threaded over rows with per-thread accumulators.
void md_mean_std(const float* data, int64_t n, int64_t d, float* mean,
                 float* stdv, float eps) {
  int nt = hw_threads();
  std::vector<double> sums(static_cast<size_t>(nt) * d, 0.0);
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back([&, t, lo, hi] {
      double* acc = sums.data() + static_cast<size_t>(t) * d;
      for (int64_t i = lo; i < hi; ++i)
        for (int64_t j = 0; j < d; ++j) acc[j] += data[i * d + j];
    });
  }
  for (auto& th : ts) th.join();
  for (int64_t j = 0; j < d; ++j) {
    double s = 0.0;
    for (int t = 0; t < nt; ++t) s += sums[static_cast<size_t>(t) * d + j];
    mean[j] = static_cast<float>(s / n);
  }
  std::fill(sums.begin(), sums.end(), 0.0);
  ts.clear();
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back([&, t, lo, hi] {
      double* acc = sums.data() + static_cast<size_t>(t) * d;
      for (int64_t i = lo; i < hi; ++i)
        for (int64_t j = 0; j < d; ++j) {
          double v = data[i * d + j] - mean[j];
          acc[j] += v * v;
        }
    });
  }
  for (auto& th : ts) th.join();
  for (int64_t j = 0; j < d; ++j) {
    double s = 0.0;
    for (int t = 0; t < nt; ++t) s += sums[static_cast<size_t>(t) * d + j];
    stdv[j] = static_cast<float>(__builtin_sqrt(s / n) + eps);
  }
}

// Fisher-Yates shuffle of [0, n) with splitmix64 PRNG (deterministic by seed).
void md_shuffle_indices(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t x = seed + 0x9E3779B97F4A7C15ULL;
  auto next = [&x]() {
    x += 0x9E3779B97F4A7C15ULL;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  };
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(next() % static_cast<uint64_t>(i + 1));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

// Normalize in place: (N, D) -> (x - mean) / std, threaded.
void md_normalize(float* data, int64_t n, int64_t d, const float* mean,
                  const float* stdv) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      for (int64_t j = 0; j < d; ++j)
        data[i * d + j] = (data[i * d + j] - mean[j]) / stdv[j];
  });
}

}  // extern "C"
