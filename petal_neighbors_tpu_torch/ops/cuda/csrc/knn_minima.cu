// knn_minima.cu — the minima kernels of the opt-in schemes.
//
// Replaces two kernels of petal_neighbors_tpu/ops/pallas/knn_kernel.py:
//   MODE_SUBCHUNK  _minima_kernel (:804, subchunk_minima :841, the
//                  "two_phase" scheme): out[q, c] = min of u over rows
//                  [128c, 128c + 128), shape (Q, ceil(N / 128));
//   MODE_BLOCK     _bcap_minima_kernel (:706, bcap_minima :755, the "bcap2"
//                  scheme): out[q, b] = min of u over rows [16b, 16b + 16),
//                  shape (Q, ceil(N / 16)),
// with u = ||x||^2 - 2 q.x, the u-domain score of knn_fold.cu.  Both run on
// the split-bf16 tensor-core product (knn_tc.cuh's scan_minima), the TPU
// kernels' own jnp.dot(precision=HIGHEST) (:824-827, :735-739).
// Rows past N count as +inf (the product gives +inf norms there), and NaN
// and padding rows carry +inf norms, so their u is +inf for a finite query.
// A NaN query scores NaN at every row, and the minimum propagates NaN
// (min.NaN), as jnp.min does: its minima are NaN.  The TPU kernel for bcap2
// reads block-interleaved, -2-prescaled planes so that a block minimum is a
// lane-wise minimum; here the block minima come out of the mma registers
// (knn_tc.cuh), so the kernel reads the padded points' piece planes
// (split_planes.cu) as they are.
//
// What bounds them on this card: the product, six bf16 products of
// 2*Q*N*d FLOP on the tensor cores at 989 TFLOP/s.  Writing the minima is
// Q*N/128 or Q*N/16 floats, far under the product time.  There is no
// selection and no state across tiles: each block writes its own columns
// of the output, so blocks need no arrival counter, no partial working
// sets and no last-block merge (the TPU grid's ("parallel", "parallel")).
//
// Design: scan_minima reduces each 128 x 128 tile to 128 x 8 block minima
// in the mma registers, with every chunk's query planes resident at d <=
// 128 (tc::hoists).  A 128-row subchunk is one such tile, so the two
// modes differ only in the epilogue:
//   * block: the block's threads write the 8 minima of each query, 32
//     bytes a query;
//   * subchunk: one thread a query takes the min.NaN of its 8 block
//     minima and writes column row0 / 128.  The subchunk minima are
//     therefore the block minima's, bit for bit (min is exact).
// grid = query tiles x row ranges, the ranges chosen from the card's SM
// count and occupancy (choose_splits, as the k-NN kernels' plan), whole
// 128-row tiles, so no output column is split between two blocks.  An
// earlier version ran the subchunk minima on the FP32 SIMT product
// (knn_tiles.cuh's scan_tiles), at 87.80 ms for 10,240 queries over 1M x
// 128 on an H100 (PERF.md, PR 11); the route proves two_phase on the
// tensor-core tier's bound since.
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
static_assert(SUBCHUNK == tc::TN, "a two_phase subchunk is one tile");
static_assert(tc::THREADS >= tc::TQ, "a thread a query (subchunk)");

using tc::min_nan;

// grid = (ceil(q / tc::TQ), splits).  Block (bx, by) scans range by, whole
// 128-row tiles, for queries [bx*tc::TQ, + tc::TQ) and writes their minima
// of the columns that range covers: MODE_BLOCK 8 a tile, MODE_SUBCHUNK 1.
// out (q, ncols) row-major.
template <int MODE>
__global__ void __launch_bounds__(tc::THREADS, 1)
minima_kernel(const char* __restrict__ xplanes,
              const char* __restrict__ qplanes,
              const float* __restrict__ norms, float* __restrict__ out,
              long long n, int q, int d, long long ncols, int splits) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * tc::TQ;
  const long long ntiles = (n + tc::TN - 1) / tc::TN;
  const long long per = (ntiles + splits - 1) / splits;
  const long long t_begin = min(ntiles, per * blockIdx.y);
  const long long t_end = min(ntiles, t_begin + per);
  tc::scan_minima(xplanes, qplanes, norms, n, d, q0, t_begin * tc::TN,
                  t_end * tc::TN, tc::hoists(d), smem,
                  [&](long long row0, int, const float* bm) {
    if constexpr (MODE == MODE_SUBCHUNK) {
      // rows past n inside the tile are +inf already (scan_minima)
      const int r = threadIdx.x;
      if (r < tc::TQ && q0 + r < q) {
        float m = bm[r * tc::BS];
#pragma unroll
        for (int b = 1; b < tc::BS; ++b) m = min_nan(m, bm[r * tc::BS + b]);
        out[static_cast<long long>(q0 + r) * ncols + row0 / SUBCHUNK] = m;
      }
    } else {
      for (int e = threadIdx.x; e < tc::TQ * tc::BS; e += tc::THREADS) {
        const int r = e / tc::BS;
        const long long col = row0 / BLOCK + e % tc::BS;
        if (q0 + r < q && col < ncols)
          out[static_cast<long long>(q0 + r) * ncols + col] = bm[e];
      }
    }
  });
}

long long minima_cols(int mode, long long n) {
  const int rows = mode == MODE_SUBCHUNK ? SUBCHUNK : BLOCK;
  return (n + rows - 1) / rows;
}

// Shared memory of one block at width d (either mode), and the attribute
// that allows it.
template <int MODE>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(minima_kernel<MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t prepare(int mode, int d, size_t* smem) {
  *smem = tc::minima_smem_bytes(d, tc::hoists(d));
  return mode == MODE_SUBCHUNK ? set_smem<MODE_SUBCHUNK>(*smem)
                               : set_smem<MODE_BLOCK>(*smem);
}

template <int MODE>
void launch(dim3 grid, size_t smem, cudaStream_t s, const char* xplanes,
            const char* qplanes, const float* norms, float* out, long long n,
            int q, int d, long long ncols, int splits) {
  minima_kernel<MODE><<<grid, tc::THREADS, smem, s>>>(
      xplanes, qplanes, norms, out, n, q, d, ncols, splits);
}

}  // namespace

extern "C" {

// The kernels' fixed sizes: queries per block (subchunk, block; one tile
// since both run on scan_minima), rows per subchunk (two_phase) and per
// block (bcap2).
void minima_constants(int* tq_subchunk, int* tq_block, int* subchunk,
                      int* block) {
  *tq_subchunk = tc::TQ;
  *tq_block = tc::TQ;
  *subchunk = SUBCHUNK;
  *block = BLOCK;
}

// The launch plan: how many row ranges of whole 128-row tiles to split
// into (choose_splits, from the card's SM count and the kernel's
// occupancy).  mode: 0 subchunk, 1 block.
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
                  &per_sm, minima_kernel<MODE_SUBCHUNK>, tc::THREADS, smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, minima_kernel<MODE_BLOCK>, tc::THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *splits = choose_splits(per_sm, sms, n, q, tc::TN / TN, tc::TQ);
  return 0;
}

// mode: 0 subchunk, 1 block.  xplanes, qplanes: the piece planes
// (split_planes.cu) of the points (n, d) and the queries (q, d); norms (n,)
// float32; out (q, ceil(n / 128)) or (q, ceil(n / 16)) float32.  q >= 1,
// n >= 1, n < 2^31; splits as minima_plan returned it for the same mode,
// n, q and d.  Returns the launch's cudaError_t (0 on success).
int minima_launch(int mode, const char* xplanes, const char* qplanes,
                  const float* norms, float* out, long long n, int q, int d,
                  int splits, void* stream) {
  if ((mode != MODE_SUBCHUNK && mode != MODE_BLOCK) || q < 1 || n < 1 ||
      d < 1 || splits < 1 || splits > MAX_SPLITS || xplanes == nullptr ||
      qplanes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = prepare(mode, d, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ncols = minima_cols(mode, n);
  const dim3 grid((q + tc::TQ - 1) / tc::TQ, splits);
  if (mode == MODE_SUBCHUNK)
    launch<MODE_SUBCHUNK>(grid, smem, s, xplanes, qplanes, norms, out, n, q,
                          d, ncols, splits);
  else
    launch<MODE_BLOCK>(grid, smem, s, xplanes, qplanes, norms, out, n, q, d,
                       ncols, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
