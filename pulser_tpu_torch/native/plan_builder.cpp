// Native evolution-plan compiler.
//
// Builds the fixed-step integration grid for the solvers in
// pulser_tpu_torch/ops/solver.py: union of coefficient knots and evaluation
// times, subdivision of long intervals, tolerance-deduplication and
// the post-step -> output-slot mapping.  This is the host-side "graph
// builder" of the runtime (the reference has no native equivalent —
// its scheduling lives inside QuTiP/scipy — so this replaces the
// Python/numpy loop-heavy implementation, which costs ~45 ms per
// solve at 3204 knots).
//
// Exposed as a plain C ABI consumed through ctypes
// (pulser_tpu_torch/native/__init__.py); falls back to the Python
// implementation when the shared object is unavailable.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kDedupeTol = 1e-12;
constexpr double kSnapTol = 1e-9;

}  // namespace

extern "C" {

// Computes an upper bound for the grid size so the caller can size
// the output buffer.
int64_t pt_grid_capacity(const double* knots, int64_t n_knots,
                         const double* evals, int64_t n_evals,
                         double max_step) {
  std::vector<double> merged;
  merged.reserve(static_cast<size_t>(n_knots + n_evals));
  merged.insert(merged.end(), knots, knots + n_knots);
  merged.insert(merged.end(), evals, evals + n_evals);
  std::sort(merged.begin(), merged.end());
  int64_t cap = 1;
  for (size_t i = 1; i < merged.size(); ++i) {
    const double seg = merged[i] - merged[i - 1];
    if (seg <= 0) continue;
    cap += static_cast<int64_t>(
               std::ceil(seg / (max_step * (1 + 1e-9)))) +
           1;
  }
  return cap;
}

// Builds the integration grid: union(knots, evals), long intervals
// subdivided evenly to <= max_step, deduplicated within kDedupeTol.
// Returns the number of grid points written (<= capacity), or -1 if
// the capacity is insufficient.
int64_t pt_build_grid(const double* knots, int64_t n_knots,
                      const double* evals, int64_t n_evals,
                      double max_step, double* out_grid,
                      int64_t capacity) {
  std::vector<double> merged;
  merged.reserve(static_cast<size_t>(n_knots + n_evals));
  merged.insert(merged.end(), knots, knots + n_knots);
  merged.insert(merged.end(), evals, evals + n_evals);
  std::sort(merged.begin(), merged.end());
  // Unique within exact equality first (np.union1d semantics)
  merged.erase(std::unique(merged.begin(), merged.end()),
               merged.end());

  int64_t count = 0;
  auto push = [&](double t) -> bool {
    if (count > 0 && t - out_grid[count - 1] <= kDedupeTol) {
      return true;  // tolerance-dedupe
    }
    if (count >= capacity) return false;
    out_grid[count++] = t;
    return true;
  };

  if (merged.empty()) return 0;
  if (!push(merged[0])) return -1;
  const double inv_step = 1.0 / (max_step * (1 + 1e-9));
  for (size_t i = 1; i < merged.size(); ++i) {
    const double a = merged[i - 1];
    const double b = merged[i];
    const int64_t m = std::max<int64_t>(
        1, static_cast<int64_t>(std::ceil((b - a) * inv_step)));
    // Evenly subdivide [a, b] (matching np.linspace semantics)
    for (int64_t j = 1; j <= m; ++j) {
      const double t =
          (j == m) ? b
                   : a + (b - a) * (static_cast<double>(j) /
                                    static_cast<double>(m));
      if (!push(t)) return -1;
    }
  }
  return count;
}

// Maps each post-step time to its evaluation slot: store_idx has
// n_grid-1 entries, initialised to n_evals (the dump row); the step
// ending at (within kSnapTol of) eval slot s gets store_idx = s.
// Returns 0 on success, -1 if an eval time is not on the grid.
int64_t pt_store_indices(const double* grid, int64_t n_grid,
                         const double* evals, int64_t n_evals,
                         int32_t* store_idx) {
  for (int64_t i = 0; i + 1 < n_grid; ++i) {
    store_idx[i] = static_cast<int32_t>(n_evals);
  }
  for (int64_t s = 0; s < n_evals; ++s) {
    const double t = evals[s];
    const double* pos = std::lower_bound(grid, grid + n_grid, t);
    int64_t p = pos - grid;
    int64_t found = -1;
    for (int64_t cand = p - 1; cand <= p + 1; ++cand) {
      if (cand >= 0 && cand < n_grid &&
          std::fabs(grid[cand] - t) < kSnapTol) {
        found = cand;
        break;
      }
    }
    if (found < 0) return -1;
    if (found > 0) {
      store_idx[found - 1] = static_cast<int32_t>(s);
    }
  }
  return 0;
}

// Merges near-duplicate (tol) ascending eval times:
// writes unique values to out_unique and the original->unique slot
// mapping to out_map; returns the unique count.
int64_t pt_merge_eval_times(const double* evals, int64_t n_evals,
                            double tol, double* out_unique,
                            int32_t* out_map) {
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n_evals; ++i) {
    if (n_unique == 0 ||
        evals[i] - out_unique[n_unique - 1] > tol) {
      out_unique[n_unique++] = evals[i];
    }
    out_map[i] = static_cast<int32_t>(n_unique - 1);
  }
  return n_unique;
}

}  // extern "C"
