// Fast approximate TSP for camera ordering.
//
// Native replacement for the reference's fast-tsp submodule
// (fast_tsp.find_tour, call site strategies/clm_offload/engine.py:179):
// order bsz (<= 64) cameras to minimize the total Hamming distance between
// consecutive visibility bitmaps, maximizing SH-row retention between
// microbatches. Open-path TSP (the tour is not closed — the last->first edge
// cost is irrelevant to retention).
//
// Algorithm: greedy nearest-neighbor from every start node, keep the best,
// then 2-opt until convergence or the time budget expires. For n <= 64 this
// reaches (near-)optimal well under the reference's 1 ms budget.
//
// C ABI for ctypes:
//   void find_tour(const int32_t* dist, int n, double time_budget_s,
//                  int32_t* tour_out);

#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

inline int64_t path_cost(const int32_t* d, int n, const std::vector<int>& t) {
  int64_t c = 0;
  for (int i = 0; i + 1 < n; ++i) c += d[t[i] * n + t[i + 1]];
  return c;
}

}  // namespace

extern "C" {

void find_tour(const int32_t* dist, int n, double time_budget_s,
               int32_t* tour_out) {
  if (n <= 0) return;
  if (n == 1) {
    tour_out[0] = 0;
    return;
  }
  auto deadline = Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                     std::chrono::duration<double>(time_budget_s));

  std::vector<int> best;
  int64_t best_cost = INT64_MAX;

  // greedy nearest neighbor from every start
  std::vector<int> tour(n);
  std::vector<char> used(n);
  for (int s = 0; s < n; ++s) {
    std::fill(used.begin(), used.end(), 0);
    tour[0] = s;
    used[s] = 1;
    for (int i = 1; i < n; ++i) {
      int prev = tour[i - 1];
      int arg = -1;
      int32_t bd = INT32_MAX;
      for (int j = 0; j < n; ++j) {
        if (!used[j] && dist[prev * n + j] < bd) {
          bd = dist[prev * n + j];
          arg = j;
        }
      }
      tour[i] = arg;
      used[arg] = 1;
    }
    int64_t c = path_cost(dist, n, tour);
    if (c < best_cost) {
      best_cost = c;
      best = tour;
    }
  }

  // 2-opt (open path): reverse segment [i, j]
  bool improved = true;
  while (improved && Clock::now() < deadline) {
    improved = false;
    for (int i = 0; i < n - 1; ++i) {
      for (int j = i + 1; j < n; ++j) {
        // edges (i-1, i) and (j, j+1) -> (i-1, j) and (i, j+1)
        int64_t delta = 0;
        if (i > 0)
          delta += dist[best[i - 1] * n + best[j]] -
                   dist[best[i - 1] * n + best[i]];
        if (j < n - 1)
          delta += dist[best[i] * n + best[j + 1]] -
                   dist[best[j] * n + best[j + 1]];
        if (delta < 0) {
          for (int a = i, b = j; a < b; ++a, --b) std::swap(best[a], best[b]);
          improved = true;
        }
      }
    }
  }

  for (int i = 0; i < n; ++i) tour_out[i] = best[i];
}

}  // extern "C"
