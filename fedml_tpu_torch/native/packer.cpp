// Native client-data packer — the host-side hot loop of every round, the
// port's own copy of fedml_tpu/native/packer.cpp (same C interface, same
// bytes out; held equal to the numpy packer by tests/test_torch_data_plane.py).
//
// Role: a round's sampled clients are packed into ONE dense [K, B, bs, ...]
// block that is copied to the card; this file is that packing loop in C++
// (std::thread fan-out over clients, memcpy row gather, splitmix64/Fisher-Yates
// shuffle) so the host never bottlenecks the device at 3400-client scale.
//
// Contract (row-major, preallocated outputs, bytes-typed rows so any dtype
// works):
//   x        [N, x_row_bytes]          y        [N, y_row_bytes]
//   idx      concatenated client index lists; offsets[K+1] frames client k
//   out_x    [K, B*bs, x_row_bytes]    out_y    [K, B*bs, y_row_bytes]
//   out_mask [K, B*bs] float32         out_num  [K] float32
// Each client's indices are shuffled with splitmix64(seeds[k]) Fisher-Yates
// (seeds are derived from the CLIENT ID by the caller, so packing a client
// alone or in a group yields the same rows — required for the
// distributed ≡ standalone equivalence oracle), truncated to B*bs,
// gathered, zero-padded. Returns 0 on success.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

void pack_one_client(
    const char* x, int64_t x_row_bytes,
    const char* y, int64_t y_row_bytes,
    const int64_t* idx, int64_t n_idx,
    int64_t capacity,  // B * bs
    uint64_t seed, int assume_zeroed,
    char* out_x, char* out_y, float* out_mask, float* out_num) {
  // Fisher-Yates shuffle of a local copy of the index list
  std::vector<int64_t> order(idx, idx + n_idx);
  uint64_t s = seed;
  for (int64_t i = n_idx - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(splitmix64(s) % static_cast<uint64_t>(i + 1));
    std::swap(order[i], order[j]);
  }
  int64_t n = std::min(n_idx, capacity);
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out_x + i * x_row_bytes, x + order[i] * x_row_bytes,
                static_cast<size_t>(x_row_bytes));
    std::memcpy(out_y + i * y_row_bytes, y + order[i] * y_row_bytes,
                static_cast<size_t>(y_row_bytes));
    out_mask[i] = 1.0f;
  }
  // padding: with calloc'd (pre-zeroed) buffers the pages are already zero
  // and touching them would only fault them in — skip the memset then.
  if (n < capacity && !assume_zeroed) {
    std::memset(out_x + n * x_row_bytes, 0,
                static_cast<size_t>((capacity - n) * x_row_bytes));
    std::memset(out_y + n * y_row_bytes, 0,
                static_cast<size_t>((capacity - n) * y_row_bytes));
    std::memset(out_mask + n, 0, static_cast<size_t>(capacity - n) * sizeof(float));
  }
  *out_num = static_cast<float>(n);
}

}  // namespace

extern "C" {

int fedml_pack_clients(
    const char* x, int64_t x_row_bytes,
    const char* y, int64_t y_row_bytes,
    const int64_t* idx_concat, const int64_t* idx_offsets, int64_t K,
    int64_t capacity, const uint64_t* seeds, int assume_zeroed,
    char* out_x, char* out_y, float* out_mask, float* out_num,
    int n_threads) {
  if (K <= 0 || capacity <= 0 || x_row_bytes <= 0 || y_row_bytes <= 0) return 1;
  int hw = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (hw < 1) hw = 1;
  hw = std::min<int64_t>(hw, K);

  auto work = [&](int64_t k0, int64_t k1) {
    for (int64_t k = k0; k < k1; ++k) {
      const int64_t* idx = idx_concat + idx_offsets[k];
      int64_t n_idx = idx_offsets[k + 1] - idx_offsets[k];
      pack_one_client(x, x_row_bytes, y, y_row_bytes, idx, n_idx, capacity, seeds[k],
                      assume_zeroed,
                      out_x + k * capacity * x_row_bytes,
                      out_y + k * capacity * y_row_bytes,
                      out_mask + k * capacity, out_num + k);
    }
  };

  if (hw == 1) {
    work(0, K);
    return 0;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (K + hw - 1) / hw;
  for (int t = 0; t < hw; ++t) {
    int64_t k0 = t * chunk, k1 = std::min<int64_t>(K, k0 + chunk);
    if (k0 >= k1) break;
    ts.emplace_back(work, k0, k1);
  }
  for (auto& t : ts) t.join();
  return 0;
}

// Dirichlet-style partition shuffle helper: shuffles ``n`` int64 indices
// in-place with splitmix64 — exported so partitioning large datasets can
// skip numpy's RandomState overhead.
void fedml_shuffle_indices(int64_t* idx, int64_t n, uint64_t seed) {
  uint64_t s = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(splitmix64(s) % static_cast<uint64_t>(i + 1));
    std::swap(idx[i], idx[j]);
  }
}

}  // extern "C"
