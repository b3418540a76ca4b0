// Native host-side index builders, the port's own copy of the JAX
// package's native/src/petal_native.cpp.
//
// The card owns the query path; this library owns the host-side runtime
// piece the reference implements natively: index CONSTRUCTION with the
// reference's exact semantics —
//   * ball tree: recursive mid-split build, Lomuto quickselect median
//     partition (ball_tree.rs:545-569), strictly-greater-wins max-spread
//     column (:577-613), mean centroid + max-distance radius (:445-461);
//   * vantage-point tree: last-element vantage point, distance sort,
//     median radius, MAX-radius singleton leaves
//     (vantage_point_tree.rs:146-197).
//
// Written from the documented semantics (SURVEY.md §2.3/§2.4), not
// translated line-by-line; the recursion is an explicit work stack and
// node geometry is written into caller-provided SoA arrays (the same flat
// layout the device queries consume).
//
// C ABI only; bound from Python via ctypes
// (petal_neighbors_tpu_torch.native, which compiles it with g++).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

enum MetricKind : int32_t { kEuclidean = 0, kCosine = 1, kMinkowski = 2 };

template <typename T>
struct Metric {
  MetricKind kind;
  T p;  // Minkowski exponent

  T distance(const T* a, const T* b, int64_t d) const {
    switch (kind) {
      case kEuclidean: {
        T acc = 0;
        for (int64_t i = 0; i < d; ++i) {
          const T diff = a[i] - b[i];
          acc += diff * diff;
        }
        return std::sqrt(acc);
      }
      case kCosine: {
        T dot = 0, na = 0, nb = 0;
        for (int64_t i = 0; i < d; ++i) {
          dot += a[i] * b[i];
          na += a[i] * a[i];
          nb += b[i] * b[i];
        }
        return T(1) - dot / (std::sqrt(na) * std::sqrt(nb));
      }
      case kMinkowski:
      default: {
        T acc = 0;
        for (int64_t i = 0; i < d; ++i) {
          acc += std::pow(std::fabs(a[i] - b[i]), p);
        }
        return std::pow(acc, T(1) / p);
      }
    }
  }
};

// IEEE maxNum fold from zero: NaN distances are ignored, an all-NaN node
// gets radius 0 (the reference's FloatCore::max fold, ball_tree.rs:458).
template <typename T>
T max_num_fold(T acc, T v) {
  return std::isnan(v) ? acc : std::max(acc, v);
}

// ---------------------------------------------------------------------------
// ball tree
// ---------------------------------------------------------------------------

// Median partition of idx[first..last] by column values; exact Lomuto
// sweep semantics of the reference so tied values land identically.
template <typename T>
void halve_node_indices(int64_t* idx, int64_t len, const T* points,
                        int64_t d, int64_t col) {
  if (len <= 1) return;
  int64_t first = 0, last = len - 1;
  const int64_t mid = len / 2;
  for (;;) {
    int64_t cur = first;
    const T pivot = points[idx[last] * d + col];
    for (int64_t i = first; i < last; ++i) {
      if (points[idx[i] * d + col] < pivot) {
        std::swap(idx[i], idx[cur]);
        ++cur;
      }
    }
    std::swap(idx[cur], idx[last]);
    if (cur == mid) return;
    if (cur < mid) {
      first = cur + 1;
    } else {
      last = cur - 1;
    }
  }
}

// Column with the maximum spread over the members; strictly-greater wins,
// so the first maximum (and never a NaN spread) is selected.
template <typename T>
int64_t max_spread_column(const T* points, int64_t d, const int64_t* idx,
                          int64_t len) {
  int64_t best_col = 0;
  T best = std::numeric_limits<T>::quiet_NaN();
  for (int64_t c = 0; c < d; ++c) {
    T lo = points[idx[0] * d + c];
    T hi = lo;
    for (int64_t i = 1; i < len; ++i) {
      const T v = points[idx[i] * d + c];
      lo = std::min(lo, v);
      hi = std::max(hi, v);
    }
    const T spread = hi - lo;
    if (c == 0) {
      best = spread;
    } else if (spread > best) {  // NaN > x is false: NaN never wins
      best = spread;
      best_col = c;
    }
  }
  return best_col;
}

template <typename T>
void init_node(const T* points, int64_t d, const int64_t* idx, int64_t len,
               const Metric<T>& metric, T* centroid, T* radius) {
  std::vector<double> sum(d, 0.0);  // f64 accumulation (host builders)
  for (int64_t i = 0; i < len; ++i) {
    const T* row = points + idx[i] * d;
    for (int64_t c = 0; c < d; ++c) sum[c] += double(row[c]);
  }
  for (int64_t c = 0; c < d; ++c) centroid[c] = T(sum[c] / double(len));
  T r = 0;
  for (int64_t i = 0; i < len; ++i) {
    r = max_num_fold(r, metric.distance(centroid, points + idx[i] * d, d));
  }
  *radius = r;
}

template <typename T>
int ball_build(const T* points, int64_t n, int64_t d, int32_t metric_kind,
               T minkowski_p, int64_t n_nodes, int64_t* idx, T* centroids,
               T* radii) {
  const Metric<T> metric{MetricKind(metric_kind), minkowski_p};
  for (int64_t i = 0; i < n; ++i) idx[i] = i;

  struct Item {
    int64_t node, start, end;
  };
  std::vector<Item> stack;
  stack.push_back({0, 0, n});
  while (!stack.empty()) {
    const Item it = stack.back();
    stack.pop_back();
    const int64_t len = it.end - it.start;
    if (len <= 0) return 1;  // invariant break: empty node range
    init_node(points, d, idx + it.start, len, metric,
              centroids + it.node * d, radii + it.node);
    const int64_t left = 2 * it.node + 1;
    if (left >= n_nodes) continue;  // leaf
    const int64_t col =
        max_spread_column(points, d, idx + it.start, len);
    halve_node_indices(idx + it.start, len, points, d, col);
    const int64_t mid = (it.start + it.end) / 2;
    stack.push_back({left + 1, mid, it.end});
    stack.push_back({left, it.start, mid});
  }
  return 0;
}

// ---------------------------------------------------------------------------
// vantage-point tree
// ---------------------------------------------------------------------------

template <typename T>
struct VpOut {
  int64_t* vp;
  T* radius;
  int64_t* near;
  int64_t* far;
};

constexpr int64_t kNull = -1;

template <typename T>
int vp_build(const T* points, int64_t n, int64_t d, int32_t metric_kind,
             T minkowski_p, int64_t* vp, T* radius, int64_t* near,
             int64_t* far, int64_t* root_out, int64_t* depth_out) {
  const Metric<T> metric{MetricKind(metric_kind), minkowski_p};
  std::vector<int64_t> ids(n);
  for (int64_t i = 0; i < n; ++i) ids[i] = i;
  std::vector<T> dist(n);

  struct Item {
    int64_t begin, end;    // slice of ids
    int64_t parent, slot;  // slot: 0 root, 1 near, 2 far
    int64_t depth;
  };
  std::vector<Item> stack;
  stack.push_back({0, n, kNull, 0, 0});
  int64_t n_nodes = 0;
  int64_t max_depth = 0;

  while (!stack.empty()) {
    const Item it = stack.back();
    stack.pop_back();
    max_depth = std::max(max_depth, it.depth);
    const int64_t len = it.end - it.begin;
    int64_t node = kNull;
    if (len > 0) {
      node = n_nodes++;
      if (len == 1) {
        vp[node] = ids[it.begin];
        radius[node] = std::numeric_limits<T>::max();  // leaf (vp_tree:158)
        near[node] = far[node] = kNull;
      } else {
        const int64_t v = ids[it.end - 1];  // vantage = last (vp_tree:169)
        const int64_t rest_begin = it.begin, rest_end = it.end - 1;
        for (int64_t i = rest_begin; i < rest_end; ++i) {
          dist[i] = metric.distance(points + ids[i] * d, points + v * d, d);
        }
        // stable sort (ids, dist) jointly by distance; NaN sorts last
        // (OrderedFloat total-order policy)
        {
          const int64_t m = rest_end - rest_begin;
          std::vector<int64_t> perm(m);
          for (int64_t i = 0; i < m; ++i) perm[i] = i;
          std::stable_sort(perm.begin(), perm.end(),
                           [&](int64_t a, int64_t b) {
                             const T da = dist[rest_begin + a];
                             const T db = dist[rest_begin + b];
                             const bool na = std::isnan(da);
                             const bool nb = std::isnan(db);
                             if (na != nb) return nb;  // NaN last
                             return da < db;
                           });
          std::vector<int64_t> tmp_ids(m);
          std::vector<T> tmp_d(m);
          for (int64_t i = 0; i < m; ++i) {
            tmp_ids[i] = ids[rest_begin + perm[i]];
            tmp_d[i] = dist[rest_begin + perm[i]];
          }
          std::copy(tmp_ids.begin(), tmp_ids.end(), ids.begin() + rest_begin);
          std::copy(tmp_d.begin(), tmp_d.end(), dist.begin() + rest_begin);
        }
        const int64_t half = (rest_end - rest_begin) / 2;
        vp[node] = v;
        radius[node] = dist[rest_begin + half];  // median (vp_tree:180-182)
        near[node] = far[node] = kNull;
        // far pushed first so near is built (and numbered) first,
        // matching the reference's recursion order (vp_tree:192-193)
        stack.push_back({rest_begin + half, rest_end, node, 2, it.depth + 1});
        stack.push_back({rest_begin, rest_begin + half, node, 1, it.depth + 1});
      }
    }
    if (it.slot == 0) {
      *root_out = node;
    } else if (it.slot == 1) {
      near[it.parent] = node;
    } else {
      far[it.parent] = node;
    }
  }
  *depth_out = max_depth;
  return 0;
}

}  // namespace

extern "C" {

int pn_ball_build_f32(const float* points, int64_t n, int64_t d,
                      int32_t metric, float p, int64_t n_nodes, int64_t* idx,
                      float* centroids, float* radii) {
  return ball_build<float>(points, n, d, metric, p, n_nodes, idx, centroids,
                           radii);
}

int pn_ball_build_f64(const double* points, int64_t n, int64_t d,
                      int32_t metric, double p, int64_t n_nodes, int64_t* idx,
                      double* centroids, double* radii) {
  return ball_build<double>(points, n, d, metric, p, n_nodes, idx, centroids,
                            radii);
}

int pn_vp_build_f32(const float* points, int64_t n, int64_t d, int32_t metric,
                    float p, int64_t* vp, float* radius, int64_t* near,
                    int64_t* far, int64_t* root, int64_t* depth) {
  return vp_build<float>(points, n, d, metric, p, vp, radius, near, far, root,
                         depth);
}

int pn_vp_build_f64(const double* points, int64_t n, int64_t d, int32_t metric,
                    double p, int64_t* vp, double* radius, int64_t* near,
                    int64_t* far, int64_t* root, int64_t* depth) {
  return vp_build<double>(points, n, d, metric, p, vp, radius, near, far, root,
                          depth);
}

}  // extern "C"
