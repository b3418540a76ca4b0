// knn_minima.cu — the minima kernels of the opt-in schemes, FP32 SIMT.
//
// Replaces two kernels of petal_neighbors_tpu/ops/pallas/knn_kernel.py:
//   MODE_SUBCHUNK  _minima_kernel (:804, subchunk_minima :841, the
//                  "two_phase" scheme): out[q, c] = min of u over rows
//                  [128c, 128c + 128), shape (Q, ceil(N / 128));
//   MODE_BLOCK     _bcap_minima_kernel (:706, bcap_minima :755, the "bcap2"
//                  scheme): out[q, b] = min of u over rows [16b, 16b + 16),
//                  shape (Q, ceil(N / 16)),
// with u = ||x||^2 - 2 q.x, the u-domain score of knn_fold.cu (DotScore).
// Rows past N count as +inf (scan_tiles stages +inf norms there), and NaN
// and padding rows carry +inf norms, so their u is +inf for a finite query.
// A NaN query scores NaN at every row, and the minimum propagates NaN
// (min.NaN), as jnp.min does: its minima are NaN.  The TPU kernel for bcap2
// reads block-interleaved, -2-prescaled planes so that a block minimum is a
// lane-wise minimum; here a 16-row block is one slot of a half-warp (below),
// so the kernel reads the padded points as they are.
//
// What bounds them on this card: the FP32 product on the SIMT cores,
// 2*Q*N*d FLOP, the same tile product (scan_tiles) as the k-NN kernels.
// Writing the minima is Q*N/128 or Q*N/16 floats, far under the FMA time.
// There is no selection and no state across tiles: each block writes its
// own columns of the output, so blocks need no arrival counter, no partial
// working sets and no last-block merge (the TPU grid's ("parallel",
// "parallel")).
//
// Design:
//   * scan_tiles hands each thread a 4 x 4 register tile of sums: queries
//     rbase..rbase+3 (half-warp) by rows xg, xg+16, xg+32, xg+48 of a
//     64-row tile (lane xg of the half-warp).  So row block i (rows
//     16i..16i+15) of the tile is slot i of the half-warp's 16 lanes, and a
//     subchunk is two consecutive tiles.
//   * the minima over the 16 lanes are a transposed half-warp reduction:
//     each shuffle step halves the values a lane keeps, so the 16 block
//     minima of a half-warp's 4 queries (4 queries x 4 blocks) take 15
//     shuffles, and lane xg ends with query xg / 4, block xg % 4.  A
//     subchunk first folds a lane's 4 rows in registers, then its 4 query
//     values take 5 shuffles; the first tile's minimum stays in a register
//     for the second.
//   * grid = query tiles x row ranges, the ranges chosen from the card's SM
//     count and occupancy (choose_splits, as the k-NN kernels' plan); a
//     subchunk range starts on an even tile, so no subchunk is split
//     between two blocks.
//
// The C entry points return a cudaError_t; the launch returns
// cudaGetLastError() right after the launch.

#include "knn_tiles.cuh"

namespace {

constexpr int MODE_SUBCHUNK = 0;
constexpr int MODE_BLOCK = 1;

constexpr int SUBCHUNK = 128;   // rows per two_phase subchunk
constexpr int BLOCK = 16;       // rows per bcap2 block

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Transposed minimum over a half-warp: lane xg holds N values (N = 16 or
// 4); afterwards v[0] of lane xg is the minimum over the half-warp's 16
// lanes of value xg * N / 16.  Each step with lane offset `off` keeps the
// upper or the lower half of a lane's values, by the bit `off` of xg, and
// takes the other half from its partner.  Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ float transpose_min(float (&v)[N], int xg) {
  static_assert(N == 4 || N == 16, "a half-warp holds 4 or 16 values");
  constexpr int STEPS = N == 16 ? 4 : 2;   // log2(N) halving steps
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int h = N >> (s + 1);
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
  for (int off = 8 >> STEPS; off > 0; off >>= 1)
    v[0] = min_nan(v[0], __shfl_xor_sync(FULL, v[0], off));
  return v[0];
}

// grid = (ceil(q / TQ), splits).  Block (bx, by) scans the rows of range by
// for queries [bx*TQ, bx*TQ + TQ) and writes their minima of the columns
// that range covers.  out (q, ncols) row-major.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS)
minima_kernel(const float* __restrict__ points,
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

  // row ranges of whole units: a subchunk (two tiles) or one tile
  constexpr int UNIT = MODE == MODE_SUBCHUNK ? SUBCHUNK / TN : 1;
  const long long ntiles = (n + TN - 1) / TN;
  const long long units = (ntiles + UNIT - 1) / UNIT;
  const long long per = (units + splits - 1) / splits * UNIT;
  const long long t_begin = min(ntiles, per * split);
  const long long t_end = min(ntiles, t_begin + per);

  float cm[4];   // subchunk: the running minimum of each of the 4 queries
#pragma unroll
  for (int j = 0; j < 4; ++j) cm[j] = INFINITY;

  const DotScore score{};
  scan_tiles<VEC>(points, queries, norms, n, q, d, q0, t_begin, t_end, smem,
                  score,
                  [&](long long t, const float* xnb, float (&acc)[4][4]) {
    if constexpr (MODE == MODE_SUBCHUNK) {
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
    } else {
      float v[16];   // value 4 j + i: query j, block i of the tile
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[4 * j + i] = score.finish(acc[j][i], xnb[xg + 16 * i]);
      const float m = transpose_min(v, xg);
      const long long b = t * (TN / BLOCK) + (xg & 3);
      if (wq < q && b < ncols) orow[b] = m;
    }
  });
}

long long minima_cols(int mode, long long n) {
  const int rows = mode == MODE_SUBCHUNK ? SUBCHUNK : BLOCK;
  return (n + rows - 1) / rows;
}

template <int MODE>
cudaError_t set_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      minima_kernel<MODE, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(minima_kernel<MODE, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t prepare(int mode, size_t smem) {
  return mode == MODE_SUBCHUNK ? set_smem<MODE_SUBCHUNK>(smem)
                               : set_smem<MODE_BLOCK>(smem);
}

}  // namespace

extern "C" {

// The kernels' fixed sizes: queries per block, rows per tile, rows per
// subchunk (two_phase) and per block (bcap2).
void minima_constants(int* tq, int* tn, int* subchunk, int* block) {
  *tq = TQ;
  *tn = TN;
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
  const size_t smem = tile_smem_bytes(d);
  err = prepare(mode, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = mode == MODE_SUBCHUNK
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, minima_kernel<MODE_SUBCHUNK, true>, THREADS, smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, minima_kernel<MODE_BLOCK, true>, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *splits = choose_splits(per_sm, sms, n, q,
                          mode == MODE_SUBCHUNK ? SUBCHUNK / TN : 1);
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
  const size_t smem = tile_smem_bytes(d);
  cudaError_t err = prepare(mode, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const dim3 grid((q + TQ - 1) / TQ, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ncols = minima_cols(mode, n);
  if (mode == MODE_SUBCHUNK) {
    if (vec)
      minima_kernel<MODE_SUBCHUNK, true><<<grid, THREADS, smem, s>>>(
          points, queries, norms, out, n, q, d, ncols, splits);
    else
      minima_kernel<MODE_SUBCHUNK, false><<<grid, THREADS, smem, s>>>(
          points, queries, norms, out, n, q, d, ncols, splits);
  } else {
    if (vec)
      minima_kernel<MODE_BLOCK, true><<<grid, THREADS, smem, s>>>(
          points, queries, norms, out, n, q, d, ncols, splits);
    else
      minima_kernel<MODE_BLOCK, false><<<grid, THREADS, smem, s>>>(
          points, queries, norms, out, n, q, d, ncols, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
