// knn_minima.cu — the minima kernels of the opt-in schemes.
//
// Replaces two kernels of petal_neighbors_tpu/ops/pallas/knn_kernel.py:
//   MODE_SUBCHUNK  _minima_kernel (:804, subchunk_minima :841, the
//                  "two_phase" scheme): out[q, c] = min of u over rows
//                  [128c, 128c + 128), shape (Q, ceil(N / 128)), on the
//                  FP32 SIMT product scan_tiles (knn_tiles.cuh);
//   MODE_BLOCK     _bcap_minima_kernel (:706, bcap_minima :755, the "bcap2"
//                  scheme): out[q, b] = min of u over rows [16b, 16b + 16),
//                  shape (Q, ceil(N / 16)), on the split-bf16 tensor-core
//                  product (knn_tc.cuh's scan_minima), the TPU kernel's own
//                  jnp.dot(precision=HIGHEST) (:735-739),
// with u = ||x||^2 - 2 q.x, the u-domain score of knn_fold.cu.
// Rows past N count as +inf (both products give +inf norms there), and NaN
// and padding rows carry +inf norms, so their u is +inf for a finite query.
// A NaN query scores NaN at every row, and the minimum propagates NaN
// (min.NaN), as jnp.min does: its minima are NaN.  The TPU kernel for bcap2
// reads block-interleaved, -2-prescaled planes so that a block minimum is a
// lane-wise minimum; here the block minima come out of the mma registers
// (knn_tc.cuh), so the kernel reads the padded points as they are.
//
// What bounds them on this card: the product, 2*Q*N*d FLOP: on the SIMT
// cores at 67 TFLOP/s (subchunk), or six bf16 products on the tensor cores
// at 989 TFLOP/s (block).  Writing the minima is Q*N/128 or Q*N/16 floats,
// far under the product time.  There is no selection and no state across
// tiles: each block writes its own columns of the output, so blocks need
// no arrival counter, no partial working sets and no last-block merge (the
// TPU grid's ("parallel", "parallel")).
//
// Design:
//   * subchunk: scan_tiles hands each thread a 4 x 4 register tile of sums:
//     queries rbase..rbase+3 (half-warp) by rows xg, xg+16, xg+32, xg+48 of
//     a 64-row tile (lane xg of the half-warp); a subchunk is two
//     consecutive tiles.  A lane folds its 4 rows in registers, then its 4
//     query values take a transposed half-warp reduction (5 shuffles: lane
//     xg ends with query xg / 4); the first tile's minimum stays in a
//     register for the second.
//   * block: scan_minima reduces each 128 x 128 tile to 128 x 8 block
//     minima in the mma registers, with every chunk's query planes resident
//     at d <= 128 (hoist); the block's threads write them out, 32 bytes a
//     query.
//   * grid = query tiles x row ranges, the ranges chosen from the card's SM
//     count and occupancy (choose_splits, as the k-NN kernels' plan), whole
//     subchunks or whole 128-row tiles, so no output column is split
//     between two blocks.
//
// The C entry points return a cudaError_t; the launch returns
// cudaGetLastError() right after the launch.

#include "knn_tc.cuh"

namespace {

constexpr int MODE_SUBCHUNK = 0;
constexpr int MODE_BLOCK = 1;

constexpr int SUBCHUNK = 128;   // rows per two_phase subchunk
constexpr int BLOCK = 16;       // rows per bcap2 block
static_assert(BLOCK == tc::BLOCK, "a bcap2 block is a scan_minima block");

using tc::min_nan;

// Transposed minimum over a half-warp: lane xg holds 4 values; afterwards
// the result of lane xg is the minimum over the half-warp's 16 lanes of
// value xg / 4.  Each step with lane offset `off` keeps the upper or the
// lower half of a lane's values, by the bit `off` of xg, and takes the
// other half from its partner.  Every lane of the warp calls it.
__device__ __forceinline__ float transpose_min(float (&v)[4], int xg) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int h = 2 >> s;
    const int off = 8 >> s;
    const bool up = (xg & off) != 0;
#pragma unroll
    for (int e = 0; e < h; ++e) {
      const float send = up ? v[e] : v[e + h];
      const float keep = up ? v[e + h] : v[e];
      v[e] = min_nan(keep, __shfl_xor_sync(FULL, send, off));
    }
  }
  // the lane offsets left: a plain reduction of the one value kept
#pragma unroll
  for (int off = 2; off > 0; off >>= 1)
    v[0] = min_nan(v[0], __shfl_xor_sync(FULL, v[0], off));
  return v[0];
}

// grid = (ceil(q / TQ), splits).  Block (bx, by) scans the rows of range by
// for queries [bx*TQ, bx*TQ + TQ) and writes their subchunk minima of the
// columns that range covers.  out (q, ncols) row-major.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
subchunk_kernel(const float* __restrict__ points,
                const float* __restrict__ queries,
                const float* __restrict__ norms, float* __restrict__ out,
                long long n, int q, int d, long long ncols, int splits) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int xg = lane & 15;
  const int rbase = (threadIdx.x >> 5) * 8 + (lane >> 4) * 4;
  // lane xg writes the minima of query rbase + xg / 4
  const int wq = q0 + rbase + (xg >> 2);
  float* orow = out + static_cast<long long>(wq) * ncols;

  // row ranges of whole subchunks (two tiles)
  constexpr int UNIT = SUBCHUNK / TN;
  const long long ntiles = (n + TN - 1) / TN;
  const long long units = (ntiles + UNIT - 1) / UNIT;
  const long long per = (units + splits - 1) / splits * UNIT;
  const long long t_begin = min(ntiles, per * split);
  const long long t_end = min(ntiles, t_begin + per);

  float cm[4];   // the running minimum of each of the 4 queries
#pragma unroll
  for (int j = 0; j < 4; ++j) cm[j] = INFINITY;

  const DotScore score{};
  scan_tiles<VEC>(points, queries, norms, n, q, d, q0, t_begin, t_end, smem,
                  score,
                  [&](long long t, const float* xnb, float (&acc)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cm[j] = min_nan(cm[j], score.finish(acc[j][i], xnb[xg + 16 * i]));
    // the subchunk ends with its second tile, or with the last tile
    if ((t & 1) || t + 1 == t_end) {
      float v[4] = {cm[0], cm[1], cm[2], cm[3]};
      const float m = transpose_min(v, xg);
      if ((xg & 3) == 0 && wq < q) orow[t >> 1] = m;
#pragma unroll
      for (int j = 0; j < 4; ++j) cm[j] = INFINITY;
    }
  });
}

// grid = (ceil(q / tc::TQ), splits).  Block (bx, by) scans range by, whole
// 128-row tiles, for queries [bx*tc::TQ, + tc::TQ) and writes their block
// minima of the columns that range covers.  out (q, ncols) row-major.
template <bool VEC>
__global__ void __launch_bounds__(tc::THREADS, 1)
block_kernel(const float* __restrict__ points,
             const float* __restrict__ queries,
             const float* __restrict__ norms, float* __restrict__ out,
             long long n, int q, int d, long long ncols, int splits) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * tc::TQ;
  const long long ntiles = (n + tc::TN - 1) / tc::TN;
  const long long per = (ntiles + splits - 1) / splits;
  const long long t_begin = min(ntiles, per * blockIdx.y);
  const long long t_end = min(ntiles, t_begin + per);
  tc::scan_minima<VEC>(points, queries, norms, n, q, d, q0,
                       t_begin * tc::TN, t_end * tc::TN, tc::hoists(d), smem,
                       [&](long long row0, int, const float* bm) {
    for (int e = threadIdx.x; e < tc::TQ * tc::BS; e += tc::THREADS) {
      const int r = e / tc::BS;
      const long long col = row0 / BLOCK + e % tc::BS;
      if (q0 + r < q && col < ncols)
        out[static_cast<long long>(q0 + r) * ncols + col] = bm[e];
    }
  });
}

long long minima_cols(int mode, long long n) {
  const int rows = mode == MODE_SUBCHUNK ? SUBCHUNK : BLOCK;
  return (n + rows - 1) / rows;
}

// Shared memory of one block of `mode` at width d, and the attribute that
// allows it.
template <class K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t prepare(int mode, int d, size_t* smem) {
  *smem = mode == MODE_SUBCHUNK ? tile_smem_bytes(d)
                                : tc::minima_smem_bytes(d, tc::hoists(d));
  cudaError_t err = mode == MODE_SUBCHUNK
                        ? set_smem(subchunk_kernel<true>, *smem)
                        : set_smem(block_kernel<true>, *smem);
  if (err != cudaSuccess) return err;
  return mode == MODE_SUBCHUNK ? set_smem(subchunk_kernel<false>, *smem)
                               : set_smem(block_kernel<false>, *smem);
}

}  // namespace

extern "C" {

// The kernels' fixed sizes: queries per block (subchunk, block), rows per
// subchunk (two_phase) and per block (bcap2).
void minima_constants(int* tq_subchunk, int* tq_block, int* subchunk,
                      int* block) {
  *tq_subchunk = TQ;
  *tq_block = tc::TQ;
  *subchunk = SUBCHUNK;
  *block = BLOCK;
}

// The launch plan: how many row ranges to split into (choose_splits, from
// the card's SM count and the kernel's occupancy).  mode: 0 subchunk, 1
// block.
int minima_plan(int mode, long long n, int q, int d, int* splits) {
  if (mode != MODE_SUBCHUNK && mode != MODE_BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0, sms = 0;
  cudaError_t err = card_limits(&sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = 0;
  err = prepare(mode, d, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = mode == MODE_SUBCHUNK
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, subchunk_kernel<true>, THREADS, smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, block_kernel<true>, tc::THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *splits = mode == MODE_SUBCHUNK
                ? choose_splits(per_sm, sms, n, q, SUBCHUNK / TN)
                : choose_splits(per_sm, sms, n, q, tc::TN / TN, tc::TQ);
  return 0;
}

// mode: 0 subchunk, 1 block.  points (n, d), queries (q, d), norms (n,)
// float32, row-major; out (q, ceil(n / 128)) or (q, ceil(n / 16)) float32.
// q >= 1, n >= 1, n < 2^31; splits as minima_plan returned it for the same
// mode, n, q and d.  Returns the launch's cudaError_t (0 on success).
int minima_launch(int mode, const float* points, const float* queries,
                  const float* norms, float* out, long long n, int q, int d,
                  int splits, void* stream) {
  if ((mode != MODE_SUBCHUNK && mode != MODE_BLOCK) || q < 1 || n < 1 ||
      d < 1 || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = prepare(mode, d, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ncols = minima_cols(mode, n);
  if (mode == MODE_SUBCHUNK) {
    const dim3 grid((q + TQ - 1) / TQ, splits);
    if (vec)
      subchunk_kernel<true><<<grid, THREADS, smem, s>>>(
          points, queries, norms, out, n, q, d, ncols, splits);
    else
      subchunk_kernel<false><<<grid, THREADS, smem, s>>>(
          points, queries, norms, out, n, q, d, ncols, splits);
  } else {
    const dim3 grid((q + tc::TQ - 1) / tc::TQ, splits);
    if (vec)
      block_kernel<true><<<grid, tc::THREADS, smem, s>>>(
          points, queries, norms, out, n, q, d, ncols, splits);
    else
      block_kernel<false><<<grid, tc::THREADS, smem, s>>>(
          points, queries, norms, out, n, q, d, ncols, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
