// lp_knn.cu — exact k-NN under Minkowski (L_p), Manhattan and Chebyshev
// distances, FP32 SIMT.
//
// Replaces _lp_kernel / lp_knn_pallas of
// petal_neighbors_tpu/ops/pallas/lp_kernel.py (:111, :186): for each query q
// and every point row x, the reduced distance
//     s = sum_f |q_f - x_f|^p      (Minkowski p >= 1, Manhattan p = 1)
//     s = max_f |q_f - x_f|        (Chebyshev)
// plus the row's additive mask (0, or +inf on NaN and padding rows, from
// pad_for_lp), and per query the exact k smallest (s, id), 1 <= k <= 4096,
// sorted ascending, ties by id; (+inf, -1) past the finite scores.  Every
// comparison is `<`, so NaN (a NaN query) and +inf (a masked row, or a real
// sum that overflowed) are never selected, as in the TPU kernel's
// `m < tau` with tau = +inf.  The caller takes the p-th root.
//
// Design: the TPU kernel's batch-merge top-k is the merge scheme, so this
// file instantiates knn_merge_kernel (knn_tiles.cuh) with an Lp score
// operation: the tile product scan_tiles accumulates the operation's step
// over the d features of each (query, row) pair in a 4 x 4 register tile
// per thread, the score is the sum plus the staged mask, and the sorted
// working set, survivor buffers, row ranges and shared bound are merge's.
// Lp scores are non-negative f32, so merge's order-bits bound holds as it
// is.  The score has no cancellation (no ||q||^2 + ||x||^2 - 2 q.x form),
// so the caller needs no rescore and no proof.
//
// Per element (FADD for the difference, then):
//   LpSum1 (p = 1):   FADD with |.| as an operand modifier            2
//   LpMax (Chebyshev): max.NaN with |.|, NaN-propagating as jnp.max   2
//   LpCube (p = 3):   FMUL |t|*t, FFMA (.)*t + a                      3
//   LpInt (other integer p <= 64): square-and-multiply on |t| (odd p)
//                     or t (even p), a uniform loop over the bits of p
//   LpReal (other p): exp2f(p * __log2f(|t|)), two SFU operations; |t| = 0
//                     gives log2 -inf, exp2 0, so the term is 0 as it
//                     should be.  Error per term: __log2f's 2^-22.6
//                     absolute (|t| in [0.5, 2]) or 2 ulp, times p, through
//                     exp2 (relative error ln 2 times that), plus exp2f's
//                     2 ulp: about (2 + 1.4 p max(1, |log2 |t||)) 2^-23
//                     relative, so 2.5e-6 at p = 2.5 for |t| in [1/4, 4].
// What bounds it on this card: the SIMT issue rate, 2 or 3 instructions per
// (query, row, feature) for p = 1, Chebyshev and p = 3 (the SFU rate, 16 per
// clock per SM, for non-integer p); the points stream once per query tile
// through shared memory, far under that.  There is no tensor-core form:
// |t|^p for odd or non-integer p and the max are not products.
//
// The C entry points return a cudaError_t; the launch returns
// cudaGetLastError() right after the launch.

#include "knn_tiles.cuh"

namespace {

constexpr int OP_SUM1 = 0;   // p = 1 (Manhattan, Minkowski(1))
constexpr int OP_MAX = 1;    // Chebyshev
constexpr int OP_CUBE = 2;   // p = 3
constexpr int OP_INT = 3;    // integer 2 <= p <= 64 other than 3
constexpr int OP_REAL = 4;   // any other p > 1

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The Lp operations: step accumulates one feature's contribution, finish
// adds the row's mask.  step(a, 0, 0) == a for every operation.
struct LpBase {
  static constexpr bool kAddQueryNorm = false;
  __device__ __forceinline__ float finish(float acc, float mask) const {
    return acc + mask;
  }
};

struct LpSum1 : LpBase {
  __device__ __forceinline__ float step(float a, float q, float x) const {
    return a + fabsf(q - x);
  }
};

struct LpMax : LpBase {
  __device__ __forceinline__ float step(float a, float q, float x) const {
    return max_nan(a, fabsf(q - x));
  }
};

struct LpCube : LpBase {
  __device__ __forceinline__ float step(float a, float q, float x) const {
    const float t = q - x;
    return fmaf(fabsf(t) * t, t, a);
  }
};

struct LpInt : LpBase {
  int p;
  __device__ __forceinline__ float step(float a, float q, float x) const {
    const float t = q - x;
    float b = (p & 1) ? fabsf(t) : t;
    float r = (p & 1) ? b : 1.f;
    for (int e = p >> 1; e > 0; e >>= 1) {
      b *= b;
      if (e & 1) r *= b;
    }
    return a + r;
  }
};

struct LpReal : LpBase {
  float p;
  __device__ __forceinline__ float step(float a, float q, float x) const {
    return a + exp2f(p * __log2f(fabsf(q - x)));
  }
};

cudaError_t occupancy(int op, int d, int* per_sm) {
  switch (op) {
    case OP_SUM1: return merge_occupancy<LpSum1>(d, per_sm);
    case OP_MAX: return merge_occupancy<LpMax>(d, per_sm);
    case OP_CUBE: return merge_occupancy<LpCube>(d, per_sm);
    case OP_INT: return merge_occupancy<LpInt>(d, per_sm);
    case OP_REAL: return merge_occupancy<LpReal>(d, per_sm);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The kernel's fixed sizes: queries per block (counters are sized by it)
// and the largest k.
void lp_constants(int* tq, int* max_k) {
  *tq = TQ;
  *max_k = MERGE_MAX_K;
}

// The launch plan: how many row ranges to split into (choose_splits).
// op: 0 p = 1, 1 Chebyshev, 2 p = 3, 3 other integer p, 4 other p.
int lp_plan(int op, long long n, int q, int d, int* splits) {
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = card_limits(&sms, &optin);
  if (err == cudaSuccess) err = occupancy(op, d, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  *splits = choose_splits(per_sm, sms, n, q, 1);
  return 0;
}

// op as lp_plan; p the exponent (read by ops 3 and 4: an integer in
// [2, 64] for op 3, p > 1 for op 4).  points (n, d), queries (q, d) and
// mask (n,) float32, row-major, points' NaN rows zeroed and masked +inf;
// outputs out_d (q, k) float32 ascending and out_i (q, k) int32.  Scratch
// part_d (splits, q, 2, k) float32, part_i (splits, q, 2, k) int32, part_f
// (splits, q) int32 (unused when splits == 1), bound (q,) uint32 set to
// all ones, and zeroed counters (ceil(q / TQ),) int32.  1 <= k <= 4096,
// q >= 1, n < 2^31; splits as lp_plan returned it.  Returns the launch's
// cudaError_t (0 on success).
int lp_launch(int op, float p, const float* points, const float* queries,
              const float* mask, float* out_d, int* out_i, float* part_d,
              int* part_i, int* part_f, unsigned* bound, int* counters,
              long long n, int q, int d, int k, int splits, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (op) {
    case OP_SUM1:
      err = merge_launch(LpSum1{}, points, queries, mask, out_d, out_i,
                         part_d, part_i, part_f, bound, counters, n, q, d, k,
                         splits, stream);
      break;
    case OP_MAX:
      err = merge_launch(LpMax{}, points, queries, mask, out_d, out_i,
                         part_d, part_i, part_f, bound, counters, n, q, d, k,
                         splits, stream);
      break;
    case OP_CUBE:
      err = merge_launch(LpCube{}, points, queries, mask, out_d, out_i,
                         part_d, part_i, part_f, bound, counters, n, q, d, k,
                         splits, stream);
      break;
    case OP_INT: {
      const int pi = static_cast<int>(p);
      if (static_cast<float>(pi) != p || pi < 2 || pi > 64) break;
      LpInt op_int;
      op_int.p = pi;
      err = merge_launch(op_int, points, queries, mask, out_d, out_i, part_d,
                         part_i, part_f, bound, counters, n, q, d, k, splits,
                         stream);
      break;
    }
    case OP_REAL: {
      if (!(p > 1.f)) break;
      LpReal op_real;
      op_real.p = p;
      err = merge_launch(op_real, points, queries, mask, out_d, out_i,
                         part_d, part_i, part_f, bound, counters, n, q, d, k,
                         splits, stream);
      break;
    }
  }
  return static_cast<int>(err);
}

}  // extern "C"
