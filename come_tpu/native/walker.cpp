// Host-side multithreaded random-walk / corpus feeder.
//
// Host-side analog of the reference's multiprocessing walk writer
// (reference utils/graph_utils.py::write_walks_to_disk + _write_walks_to_disk
// [R], SURVEY.md C3): where the reference forked a process pool that streamed
// walk text files to disk, this C++ library generates walk batches directly
// into caller-provided buffers from std::thread workers — used when the graph
// lives host-side (too big for one chip's HBM) to keep the device fed while
// it trains on the previous batch.  The on-device lax.scan walker
// (come_tpu/sampling/walks.py) remains the default for device-resident CSR.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libcomewalk.so walker.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64 — tiny, fast, per-walk seedable PRNG
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// map 64 random bits to [0, n) without modulo bias (Lemire)
static inline uint32_t bounded(uint64_t r, uint32_t n) {
  return static_cast<uint32_t>((static_cast<__uint128_t>(r) * n) >> 64);
}

}  // namespace

extern "C" {

// Walks `num_walks` truncated random walks of `length` steps over the CSR
// graph; out must hold num_walks*length int32s (row-major [num_walks, length]).
// restart_prob in [0,1) restarts a walk at its origin (deepwalk's alpha).
void come_random_walks(const int32_t* indptr, const int32_t* indices,
                       int64_t num_nodes, const int32_t* starts,
                       int64_t num_walks, int32_t length, uint64_t seed,
                       float restart_prob, int32_t* out,
                       int32_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int64_t> next(0);
  const int64_t chunk = 256;
  const uint32_t restart_u32 =
      restart_prob <= 0.f
          ? 0u
          : static_cast<uint32_t>(restart_prob * 4294967296.0);

  auto worker = [&]() {
    for (;;) {
      int64_t begin = next.fetch_add(chunk);
      if (begin >= num_walks) break;
      int64_t end = begin + chunk < num_walks ? begin + chunk : num_walks;
      for (int64_t w = begin; w < end; ++w) {
        uint64_t rng = seed ^ (0x2545F4914F6CDD1Dull * (uint64_t)(w + 1));
        int32_t v = starts[w];
        const int32_t origin = v;
        int32_t* row = out + w * length;
        row[0] = v;
        for (int32_t t = 1; t < length; ++t) {
          uint64_t r = splitmix64(rng);
          if (restart_u32 && static_cast<uint32_t>(r >> 32) < restart_u32) {
            v = origin;
          } else {
            const int32_t lo = indptr[v];
            const int32_t deg = indptr[v + 1] - lo;
            if (deg > 0) v = indices[lo + bounded(r, (uint32_t)deg)];
            // deg == 0: isolated node stays put (matches device walker)
          }
          row[t] = v;
        }
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int32_t i = 0; i < num_threads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Degree histogram helper (used by loaders to validate big graphs quickly).
void come_degree_counts(const int32_t* indptr, int64_t num_nodes,
                        int32_t* out_degrees) {
  for (int64_t v = 0; v < num_nodes; ++v)
    out_degrees[v] = indptr[v + 1] - indptr[v];
}

}  // extern "C"
