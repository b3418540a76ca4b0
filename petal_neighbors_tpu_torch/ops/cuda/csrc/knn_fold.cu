// knn_fold.cu — the fold family of streaming top-k kernels, FP32 SIMT.
//
// Replaces three kernels of petal_neighbors_tpu/ops/pallas/knn_kernel.py,
// one template instantiated per mode:
//   MODE_FOLD   _knn_kernel (:186, the "fold" scheme, with _fold_min :97):
//               the exact k smallest u per query.
//   MODE_CAPPED _knn_kernel_capped (:429): at most `passes` extractions per
//               tile of rows, plus a per-query threshold thr below which no
//               point outside the working set can lie.
//   MODE_BCAP   _knn_kernel_bcap (:546): the capped scheme over the minima
//               of blocks of BLOCK = 16 contiguous rows; returns block ids.
// and, as a kernel of its own on the same tile product (scan_tiles),
//   knn_merge_kernel  _knn_kernel_merge + _bitonic_merge_sorted (:336,
//               :287): the exact k smallest u per query for k up to 4096,
//               output sorted ascending.
//
// What they compute: for each query q and every point row x,
//     u = ||x||^2 - 2 q.x
// and, per query, a working set of k (u, id) entries; ||q||^2 is added back
// at the end and the result clamped at 0 (rdist).  Output order inside a
// row is unspecified (the caller re-ranks).  Rows that pad_for_pallas
// zeroed carry +inf norms, so their u is +inf.  A NaN query row gives NaN
// scores, which fail every `<` comparison, so the row keeps (+inf, -1).
//
// Capped and bcap semantics (as the TPU kernels, tile by tile in order):
// the first k candidates of the range (rows, or blocks for bcap) seed the
// working set and leave the extraction; each tile of `tile_tiles` x 64 rows
// then folds its `passes` smallest remaining candidates (ties to the
// smaller id) into the set, each only while it is below the set's maximum;
// miss = min over tiles of the tile's (passes+1)-th smallest candidate.
// thr = min(max of the set, miss) + ||q||^2.  Every point outside the set
// has u >= thr - ||q||^2: the caller's proof certifies the top-k with it.
//
// What bounds them on this card: FP32 arithmetic on the SIMT cores,
// 2*Q*N*d FLOP (one FMA per query, row and feature).  The point set is
// streamed once per query tile through shared memory: N*d*4 bytes per 64
// queries, far under the FMA time.  Tensor-core tiers (TF32, split bf16)
// come in a later change, each with its own proof bound.
//
// Design:
//   * one block = TQ = 64 queries, 256 threads = 8 warps; warp w owns
//     queries 8w..8w+7.  Each half-warp owns 4 of them, and each of its 16
//     lanes holds a 4 x 4 register tile of scores (4 queries x 4 points:
//     rows xg, xg+16, xg+32, xg+48 of the tile), so one half-warp holds all
//     TN = 64 scores of its 4 queries, and row block i (rows 16i..16i+15)
//     is slot i of the 16 lanes: a bcap block minimum is a half-warp
//     shuffle reduction.
//   * a block streams its rows in tiles of TN = 64, staged in shared
//     memory with their norms, in chunks of DC = 128 features,
//     double-buffered with cp.async.  Rows are padded to a stride of
//     DC + 4 floats so that float4 reads of 8 rows hit distinct banks.
//   * fold: each query keeps an unsorted working set of k (u, id) entries
//     and its current maximum tau.  A score enters only if u < tau; then
//     the half-warp takes the smallest remaining candidate (ties to the
//     smaller id), replaces the working set's maximum (ties to the smaller
//     slot), recomputes the maximum, and repeats while the smallest
//     remaining candidate is below tau.  While the set still has +inf
//     slots they fill in order, without a scan.
//   * capped / bcap: each query keeps a sorted list of the passes+1
//     smallest candidates of the current tile, one entry per lane of its
//     half-warp (insertion = ballot + shuffle-up); at the tile's end its
//     first `passes` entries are folded into the set and entry `passes`
//     lowers miss.
//   * the TPU runs its grid in order on one core; this card runs blocks in
//     parallel on 132 SMs, and Q/64 query tiles rarely fill them evenly
//     (10,240 queries make 160 tiles).  So the host may split the rows into
//     S ranges of whole tiles (grid = query tiles x S), chosen from the
//     card's SM count and occupancy.  Each block scans its range into its
//     own working set and stores it; the last block of a query tile to
//     finish (an atomic count) folds the other ranges' sets into its own
//     with the fold step (and takes the least miss) and writes the output.
//     For capped and bcap each range seeds its own set, as if it were the
//     whole index.  One launch, no second kernel.
//   * the working set lives in shared memory when it still lets two blocks
//     share an SM, and otherwise in the global scratch part_d / part_i.
//   * merge (k up to 4096; fold re-scans its k slots for every entrant,
//     O(k) per survivor): each query's working set is kept SORTED in
//     global scratch, two slots of k that take turns, with its k-th value
//     tau in a register (+inf until k entries are in).  A tile's scores
//     below tau go to the query's MERGE_W = 128 slots in shared memory
//     (ballot + popc, no atomics).  When a tile's survivors would not fit
//     in some buffer, every buffer of the block at least half full is
//     flushed in that tile, so the warps' merges overlap instead of each
//     stalling the block at the tile barrier in turn: the half-warp sorts
//     the buffer (bitonic, 16 lanes) and merges it with the set into the
//     other slot (merge_into: the set streams through once, coalesced,
//     8 loads per lane per step with the next step's issued ahead; each
//     buffer entry is ranked in the window it falls in by a half-warp
//     count, and each set entry goes to its index plus the count of buffer
//     entries ranked at or below it).  About k (1 + ln(N / (S k)))
//     survivors per query and range.  Row ranges as above; the last block
//     merges the ranges' sorted sets on the merge path (merge_path).
//     Ties: (u, id) order throughout.  Merge is bound by the FP32 SIMT
//     product like the others; its merges add global-memory traffic of
//     about 16 k bytes per flush.
//
// The C entry points return a cudaError_t; the launch returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MODE_FOLD = 0;
constexpr int MODE_CAPPED = 1;
constexpr int MODE_BCAP = 2;

constexpr int TQ = 64;        // queries per block
constexpr int TN = 64;        // point rows per tile
constexpr int BLOCK = 16;     // rows per bcap block
constexpr int DC = 128;       // features staged per chunk
constexpr int DS = DC + 4;    // shared-memory row stride in floats
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_SPLITS = 64;  // a batch of one query tile spreads over SMs
constexpr int MIN_TILES_PER_SPLIT = 64;
constexpr int MAX_PASSES = 15;  // the list of passes+1 entries spans 16 lanes
constexpr int MAX_K = 1024;
constexpr int MODE_MERGE = 3;
constexpr int MERGE_W = 128;      // survivor slots per query (merge)
constexpr int MERGE_MAX_K = 4096;
constexpr int MERGE_U = 8;        // set entries a lane loads per merge step
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// (a, ia) before (b, ib) in (value, id) order.
__device__ __forceinline__ bool lex_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// Stage rows [row0, row0 + rows) x features [c0, c0 + w) of a row-major
// (total, d) matrix into dst (stride DS), zero-filling rows past `total`
// and the columns [w, wpad).
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long total, long long row0,
                                           int rows, int d, int c0, int w,
                                           int wpad) {
  if (VEC) {
    const int per_row = wpad >> 2;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) << 2;
      const long long g = row0 + r;
      const bool ok = g < total;
      cp_async16(dst + r * DS + c, ok ? src + g * d + c0 + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * wpad; idx += THREADS) {
      const int r = idx / wpad;
      const int c = idx - r * wpad;
      const long long g = row0 + r;
      const bool ok = g < total && c < w;
      cp_async4(dst + r * DS + c, ok ? src + g * d + c0 + c : src,
                ok ? 4 : 0);
    }
  }
}

// The smallest of the half-warp's candidates (v, cid), ties to the smaller
// id (jnp.argmin's first index: ids grow with the column).
__device__ __forceinline__ void half_warp_argmin(const float (&v)[4],
                                                 const int (&cid)[4],
                                                 float& m, int& id) {
  m = v[0];
  id = cid[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (lex_less(v[i], cid[i], m, id)) {
      m = v[i];
      id = cid[i];
    }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(FULL, m, off);
    const int oid = __shfl_xor_sync(FULL, id, off);
    if (lex_less(om, oid, m, id)) {
      m = om;
      id = oid;
    }
  }
}

// This lane's share of the maximum of a full working set of k slots.
// `live` is false for query rows past q, whose slots must not be read.
__device__ __forceinline__ void lane_max(const float* wd, int k, bool live,
                                         int xg, float& mx, int& mp) {
  mx = -INFINITY;
  mp = k;
  for (int e = xg; live && e < k; e += 16) {
    const float wv = wd[e];
    if (wv > mx) {
      mx = wv;
      mp = e;
    }
  }
}

// The half-warp's maximum from the lanes' shares, ties to the smaller slot
// (jnp.argmax's first index).  Every lane of the warp calls this.
__device__ __forceinline__ void reduce_max(float& mx, int& mp) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float omx = __shfl_xor_sync(FULL, mx, off);
    const int omp = __shfl_xor_sync(FULL, mp, off);
    if (omx > mx || (omx == mx && omp < mp)) {
      mx = omx;
      mp = omp;
    }
  }
}

// The fold step for one query per half-warp: lane xg holds 4 candidates
// (v[i], cid[i]); the half-warp's 64 candidates enter the working set
// (wd, wi) of k slots in ascending order while they beat its maximum tau.
// Every lane of the warp calls this (shuffles span the warp); the two
// half-warps fold their own queries.  A candidate with NaN score must be
// passed as +inf.
__device__ __forceinline__ void fold_query(float (&v)[4], const int (&cid)[4],
                                           float& tau, int& amax, int& fill,
                                           float* wd, int* wi, int k,
                                           int xg) {
  bool hit = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) hit |= v[i] < tau;
  if (!__any_sync(FULL, hit)) return;
  while (true) {
    float m;
    int id;
    half_warp_argmin(v, cid, m, id);
    const bool take = m < tau;
    if (!__any_sync(FULL, take)) return;
    if (take) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (cid[i] == id) v[i] = INFINITY;   // consumed
      if (xg == 0) {
        wd[amax] = m;
        wi[amax] = id;
      }
      fill += fill < k;
    }
    __syncwarp();
    // new maximum of the working set; unfilled +inf slots come in order
    float mx;
    int mp;
    if (fill < k) {
      mx = INFINITY;
      mp = fill;
    } else {
      lane_max(wd, k, true, xg, mx, mp);
    }
    reduce_max(mx, mp);
    if (take) {
      tau = mx;
      amax = mp;
    }
    __syncwarp();
  }
}

// Insert (m, id) into the half-warp's sorted list (lane e holds entry e,
// entry 15 falls off) where `ins`; every lane of the warp calls this.
__device__ __forceinline__ void list_insert(float& lv, int& li, float m,
                                            int id, bool ins, int xg,
                                            int qg) {
  const bool before = lex_less(lv, li, m, id);
  const unsigned bal = __ballot_sync(FULL, before);
  const int pos = __popc((bal >> (qg * 16)) & 0xffffu);
  const float pv = __shfl_up_sync(FULL, lv, 1, 16);
  const int pi = __shfl_up_sync(FULL, li, 1, 16);
  if (ins) {
    if (xg == pos) {
      lv = m;
      li = id;
    } else if (xg > pos) {
      lv = pv;
      li = pi;
    }
  }
}

// Capped: the half-warp's 64 candidates of one query enter the list of
// the tile's passes+1 smallest, smallest first, while they come before
// its last entry.  +inf never enters.
__device__ __forceinline__ void capped_insert(float (&v)[4],
                                              const int (&cid)[4], float& lv,
                                              int& li, int passes, int xg,
                                              int qg) {
  float thv = __shfl_sync(FULL, lv, passes, 16);
  int thi = __shfl_sync(FULL, li, passes, 16);
  bool hit = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    hit |= v[i] < INFINITY && lex_less(v[i], cid[i], thv, thi);
  if (!__any_sync(FULL, hit)) return;
  while (true) {
    float m;
    int id;
    half_warp_argmin(v, cid, m, id);
    const bool ins = m < INFINITY && lex_less(m, id, thv, thi);
    if (!__any_sync(FULL, ins)) return;
    if (ins) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (cid[i] == id) v[i] = INFINITY;   // consumed
    }
    list_insert(lv, li, m, id, ins, xg, qg);
    thv = __shfl_sync(FULL, lv, passes, 16);
    thi = __shfl_sync(FULL, li, passes, 16);
  }
}

// Capped / bcap tile end: fold the list's first `passes` entries into the
// working set (each while it beats tau), lower miss by entry `passes`, and
// empty the list.  `first` recomputes tau from the seeded set.
__device__ __forceinline__ void flush_list(float& lv, int& li, float& tau,
                                           int& amax, float& miss, float* wd,
                                           int* wi, int k, int passes,
                                           bool live, bool first, int xg) {
  __syncwarp();   // seeds written by other lanes
  if (first) {
    float mx;
    int mp;
    lane_max(wd, k, live, xg, mx, mp);
    reduce_max(mx, mp);
    if (live) {
      tau = mx;
      amax = mp;
    }
  }
  for (int e = 0; e < passes; ++e) {
    const float m = __shfl_sync(FULL, lv, e, 16);
    const int id = __shfl_sync(FULL, li, e, 16);
    const bool take = m < tau;
    if (!__any_sync(FULL, take)) break;
    if (take && xg == 0) {
      wd[amax] = m;
      wi[amax] = id;
    }
    __syncwarp();
    float mx;
    int mp;
    lane_max(wd, k, live, xg, mx, mp);
    reduce_max(mx, mp);
    if (take) {
      tau = mx;
      amax = mp;
    }
    __syncwarp();
  }
  const float last = __shfl_sync(FULL, lv, passes, 16);
  if (last < miss) miss = last;
  lv = INFINITY;
  li = INT_MAX;
}

// Floats of shared memory the tile staging takes at width d: two point
// tiles, one or two query tiles, two norm rows.
__host__ __device__ __forceinline__ int tile_floats(int d) {
  const int nch = (d + DC - 1) / DC;
  return 2 * TN * DS + (nch > 1 ? 2 : 1) * TQ * DS + 2 * TN;
}

// The shared FP32 SIMT tile product of every kernel in this file: stream
// the tiles [t_begin, t_end) of TN rows (and the block's TQ queries from
// q0) through shared memory at `smem`, in chunks of DC features,
// double-buffered with cp.async, and after each tile's last chunk call
//     on_tile(t, xnb, acc)
// on every thread of the block, between two __syncthreads: acc[j][i] is
// q_(q0 + rbase + j) . x_(t*TN + xg + 16 i) summed over all d features,
// and xnb the tile's TN norms (+inf past n).  acc is zeroed afterwards.
template <bool VEC, class OnTile>
__device__ __forceinline__ void scan_tiles(
    const float* __restrict__ points, const float* __restrict__ queries,
    const float* __restrict__ norms, long long n, int q, int d, int q0,
    long long t_begin, long long t_end, float* smem, OnTile&& on_tile) {
  const int nch = (d + DC - 1) / DC;
  const int qbufs = nch > 1 ? 2 : 1;
  float* xs = smem;                         // [2][TN][DS]
  float* qs = xs + 2 * TN * DS;             // [qbufs][TQ][DS]
  float* xn = qs + qbufs * TQ * DS;         // [2][TN]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int xg = lane & 15;
  const int rbase = warp * 8 + (lane >> 4) * 4;
  const long long nst = (t_end - t_begin) * nch;

  auto issue = [&](long long s) {
    const long long t = t_begin + s / nch;
    const int c = static_cast<int>(s % nch);
    const int buf = static_cast<int>(s & 1);
    const int c0 = c * DC;
    const int w = min(DC, d - c0);
    const int wpad = (w + 3) & ~3;
    stage_rows<VEC>(xs + buf * TN * DS, points, n, t * TN, TN, d, c0, w,
                    wpad);
    if (nch > 1 || s == 0)
      stage_rows<VEC>(qs + (nch > 1 ? buf : 0) * TQ * DS, queries, q, q0, TQ,
                      d, c0, w, wpad);
    if (c == nch - 1) {
      float* dst = xn + buf * TN;
      for (int i = tid; i < TN; i += THREADS) {
        const long long g = t * TN + i;
        if (g < n)
          cp_async4(dst + i, norms + g, 4);
        else
          dst[i] = INFINITY;
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  if (nst > 0) issue(0);
  cp_async_commit();
  for (long long s = 0; s < nst; ++s) {
    if (s + 1 < nst) issue(s + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const int c = static_cast<int>(s % nch);
    const int buf = static_cast<int>(s & 1);
    const int wpad = (min(DC, d - c * DC) + 3) & ~3;
    const float* xb = xs + buf * TN * DS;
    const float* qb = qs + (nch > 1 ? buf : 0) * TQ * DS;
#pragma unroll 2
    for (int kk = 0; kk < wpad; kk += 4) {
      float4 qv[4], xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qv[j] = *reinterpret_cast<const float4*>(qb + (rbase + j) * DS + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xb + (xg + 16 * i) * DS + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[j][i];
          a = fmaf(qv[j].x, xv[i].x, a);
          a = fmaf(qv[j].y, xv[i].y, a);
          a = fmaf(qv[j].z, xv[i].z, a);
          a = fmaf(qv[j].w, xv[i].w, a);
          acc[j][i] = a;
        }
    }

    if (c == nch - 1) {
      on_tile(t_begin + s / nch, xn + buf * TN, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
    __syncthreads();
  }
}

// grid = (ceil(q / TQ), splits).  Block (bx, by) scans the rows of range
// by into the working sets of queries [bx*TQ, bx*TQ + TQ).  part_d/part_i
// (splits, q, k) hold the working sets when they are not in shared memory
// and receive each range's set when splits > 1; part_m (splits, q) each
// range's miss (capped, bcap); counters (ceil(q / TQ),), zeroed, elect the
// last block of each query tile to merge.  Ranges are whole tiles of
// tile_tiles x TN rows (1 for fold).
template <int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ points, const float* __restrict__ queries,
           const float* __restrict__ norms, float* __restrict__ out_d,
           int* __restrict__ out_i, float* __restrict__ out_t,
           float* __restrict__ part_d, int* __restrict__ part_i,
           float* __restrict__ part_m, int* __restrict__ counters,
           long long n, int q, int d, int k, int tile_tiles, int passes,
           int splits, int ws_in_smem) {
  extern __shared__ float4 smem4[];
  __shared__ int is_last;
  __shared__ float thr_s[TQ];
  float* smem = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const long long qk = static_cast<long long>(q) * k;
  float* ws_d;
  int* ws_i;
  if (ws_in_smem) {
    ws_d = smem + tile_floats(d);           // [TQ][k]
    ws_i = reinterpret_cast<int*>(ws_d + TQ * k);
  } else {
    ws_d = part_d + split * qk + static_cast<long long>(q0) * k;
    ws_i = part_i + split * qk + static_cast<long long>(q0) * k;
  }

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qg = lane >> 4;                 // half-warp
  const int xg = lane & 15;                 // lane within the half-warp
  const int rbase = warp * 8 + qg * 4;      // this thread's 4 query rows

  // working-set init: (+inf, -1); rows past q are never touched
  const int valid_rows = min(TQ, q - q0);
  for (int e = tid; e < valid_rows * k; e += THREADS) {
    ws_d[e] = INFINITY;
    ws_i[e] = -1;
  }

  float tau[4], miss[4], lv[4];
  int amax[4], fill[4], li[4];
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    live[j] = q0 + rbase + j < q;
    // rows past q get tau = -inf: nothing is ever below it
    tau[j] = live[j] ? INFINITY : -INFINITY;
    amax[j] = 0;
    // capped / bcap sets are full from the seed on (+inf slots included)
    fill[j] = (MODE == MODE_FOLD || !live[j]) ? 0 : k;
    miss[j] = INFINITY;
    lv[j] = INFINITY;
    li[j] = INT_MAX;
  }
  bool first_flush = true;

  // this block's tile range, whole tiles of tile_tiles
  const long long ntiles = (n + TN - 1) / TN;
  const long long units = (ntiles + tile_tiles - 1) / tile_tiles;
  const long long per = (units + splits - 1) / splits * tile_tiles;
  const long long t_begin = min(ntiles, per * split);
  const long long t_end = min(ntiles, t_begin + per);

  scan_tiles<VEC>(points, queries, norms, n, q, d, q0, t_begin, t_end, smem,
                  [&](long long t, const float* xnb, float (&acc)[4][4]) {
      // ---- the tile's scores into the working sets ----------------------
      const int tile0 = static_cast<int>(t * TN);
      int cid[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cid[i] = tile0 + xg + 16 * i;
      float v[4][4];
      bool qnan[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float u = xnb[xg + 16 * i] - 2.f * acc[j][i];
          v[j][i] = (u < INFINITY) ? u : INFINITY;   // NaN -> +inf
          // a NaN query gives NaN at every row, a finite one at none
          if (i == 0) qnan[j] = u != u;
        }
      }
      if (MODE == MODE_FOLD) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fold_query(v[j], cid, tau[j], amax[j], fill[j],
                     ws_d + (rbase + j) * k, ws_i + (rbase + j) * k, k, xg);
      } else if (MODE == MODE_CAPPED) {
        const long long rel0 = (t - t_begin) * TN;   // row offset in range
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (rel0 < k) {
            // seed columns: straight into the working set, out of the list
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const long long rel = rel0 + xg + 16 * i;
              if (rel < k) {
                if (live[j] && cid[i] < n && !qnan[j]) {
                  ws_d[(rbase + j) * k + rel] = v[j][i];
                  ws_i[(rbase + j) * k + rel] = cid[i];
                }
                v[j][i] = INFINITY;
              }
            }
          }
          capped_insert(v[j], cid, lv[j], li[j], passes, xg, qg);
        }
      } else {   // MODE_BCAP
        const long long relb0 = (t - t_begin) * (TN / BLOCK);
        const int bid0 = static_cast<int>(t * (TN / BLOCK));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float bm[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float b = v[j][i];
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) {
              const float o = __shfl_xor_sync(FULL, b, off);
              b = o < b ? o : b;
            }
            bm[i] = b;
          }
          float thv = __shfl_sync(FULL, lv[j], passes, 16);
          int thi = __shfl_sync(FULL, li[j], passes, 16);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int bid = bid0 + i;
            if (relb0 + i < k) {
              if (xg == 0 && live[j] &&
                  static_cast<long long>(bid) * BLOCK < n) {
                ws_d[(rbase + j) * k + relb0 + i] =
                    qnan[j] ? INFINITY : bm[i];
                ws_i[(rbase + j) * k + relb0 + i] = qnan[j] ? -1 : bid;
              }
              continue;
            }
            const bool ins = bm[i] < INFINITY && lex_less(bm[i], bid, thv, thi);
            if (!__any_sync(FULL, ins)) continue;
            list_insert(lv[j], li[j], bm[i], bid, ins, xg, qg);
            thv = __shfl_sync(FULL, lv[j], passes, 16);
            thi = __shfl_sync(FULL, li[j], passes, 16);
          }
        }
      }
      if (MODE != MODE_FOLD &&
          ((t - t_begin + 1) % tile_tiles == 0 || t + 1 == t_end)) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          flush_list(lv[j], li[j], tau[j], amax[j], miss[j],
                     ws_d + (rbase + j) * k, ws_i + (rbase + j) * k, k,
                     passes, live[j], first_flush, xg);
        first_flush = false;
      }
  });

  if (splits > 1) {
    // ---- publish this range's working sets; the last block merges -------
    if (ws_in_smem) {
      float* pd = part_d + split * qk + static_cast<long long>(q0) * k;
      int* pi = part_i + split * qk + static_cast<long long>(q0) * k;
      for (int e = tid; e < valid_rows * k; e += THREADS) {
        pd[e] = ws_d[e];
        pi[e] = ws_i[e];
      }
    }
    if (MODE != MODE_FOLD && xg == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (live[j])
          part_m[static_cast<long long>(split) * q + q0 + rbase + j] = miss[j];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      is_last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    for (int other = 0; other < splits; ++other) {
      if (other == split) continue;
      if (MODE != MODE_FOLD) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (live[j]) {
            const float om = __ldcg(
                part_m + static_cast<long long>(other) * q + q0 + rbase + j);
            if (om < miss[j]) miss[j] = om;
          }
      }
      for (int e0 = 0; e0 < k; e0 += 64) {
        int cid[4][4];
        float v[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gq = q0 + rbase + j;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = e0 + xg + 16 * i;
            const long long at = other * qk + static_cast<long long>(gq) * k + e;
            const bool ok = gq < q && e < k;
            v[j][i] = ok ? __ldcg(part_d + at) : INFINITY;
            cid[j][i] = ok ? __ldcg(part_i + at) : -1;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fold_query(v[j], cid[j], tau[j], amax[j], fill[j],
                     ws_d + (rbase + j) * k, ws_i + (rbase + j) * k, k, xg);
      }
    }
  }
  if (MODE != MODE_FOLD && xg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      thr_s[rbase + j] = miss[j] < tau[j] ? miss[j] : tau[j];
  }
  __syncthreads();

  // ---- output: rd = max(u + ||q||^2, 0); unfilled slots stay (+inf, -1)
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int gq = q0 + r;
    if (gq >= q) break;
    const float* qrow = queries + static_cast<long long>(gq) * d;
    float qn = 0.f;
    for (int f = lane; f < d; f += 32) qn = fmaf(qrow[f], qrow[f], qn);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) qn += __shfl_xor_sync(FULL, qn, off);
    float* od = out_d + static_cast<long long>(gq) * k;
    int* oi = out_i + static_cast<long long>(gq) * k;
    for (int e = lane; e < k; e += 32) {
      const int id = ws_i[r * k + e];
      const float rd = ws_d[r * k + e] + qn;
      od[e] = id < 0 ? INFINITY : (rd < 0.f ? 0.f : rd);
      oi[e] = id;
    }
    if (MODE != MODE_FOLD && lane == 0) out_t[gq] = thr_s[r] + qn;
  }
}

// ---- merge -------------------------------------------------------------

// Sort one query's survivor buffer (MERGE_W slots, the first cnt filled)
// ascending in (u, id) order by a bitonic network over the half-warp's 16
// lanes, the empty slots as (+inf, INT_MAX).  Every lane of the warp calls
// this; where `act` is false the half-warp leaves its buffer alone.
__device__ __forceinline__ void sort_buffer(float* bd, int* bi, int cnt,
                                            bool act, int xg) {
  if (act)
    for (int e = cnt + xg; e < MERGE_W; e += 16) {
      bd[e] = INFINITY;
      bi[e] = INT_MAX;
    }
  __syncwarp();
  for (int size = 2; size <= MERGE_W; size <<= 1)
    for (int s = size >> 1; s > 0; s >>= 1) {
      if (act)
        for (int t = xg; t < MERGE_W / 2; t += 16) {
          const int i = 2 * s * (t / s) + (t % s);
          const int j = i + s;
          const float a = bd[i], b = bd[j];
          const int ia = bi[i], ib = bi[j];
          if (lex_less(b, ib, a, ia) == ((i & size) == 0)) {
            bd[i] = b;
            bi[i] = ib;
            bd[j] = a;
            bi[j] = ia;
          }
        }
      __syncwarp();
    }
}

// f32 -> unsigned with the same order (no NaN here), and back: the
// per-query shared bound of merge, kept with atomicMin.
__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned b) {
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

// Half-warp merge of a sorted list A in global memory (na entries) with the
// sorted buffer B in shared memory (nb <= MERGE_W) into O in global memory
// (not aliasing A), keeping the first m <= na + nb.  A streams through
// once, 16 x MERGE_U consecutive entries a step, the next step's loads
// issued before this step's work.
// The B entries that fall in a step's window (before the next step's first
// entry) get their rank in A there: each lane counts its entries before the
// B entry and the half-warp sums the counts, so every lane holds the rank.
// Every entry then goes to its index plus the count of the other list's
// entries before it ((u, id) order; ids are distinct); for an A entry that
// is the B entries ranked at or below it, counted as the ranks come.  Every
// lane of the warp calls this (shuffles); where `act` is false the
// half-warp does nothing.
__device__ __forceinline__ void merge_into(const float* ad, const int* ai,
                                           int na, const float* bd,
                                           const int* bi, int nb, float* od,
                                           int* oi, int m, bool act, int xg) {
  constexpr int SPAN = 16 * MERGE_U;
  const int own = act ? (na + SPAN - 1) / SPAN : 0;
  const int steps = max(own, __shfl_xor_sync(FULL, own, 16));
  float a[MERGE_U], a2[MERGE_U];
  int ia[MERGE_U], ia2[MERGE_U];
  auto load = [&](int w0, float (&x)[MERGE_U], int (&ix)[MERGE_U]) {
#pragma unroll
    for (int u = 0; u < MERGE_U; ++u) {
      const int e = w0 + u * 16 + xg;
      x[u] = INFINITY;
      ix[u] = INT_MAX;
      if (act && e < na) {
        x[u] = ad[e];
        ix[u] = ai[e];
      }
    }
  };
  load(0, a, ia);
  int lo = 0;   // B entries placed so far (ranked before this window)
  for (int t = 0; t < steps; ++t) {
    const int w0 = t * SPAN;
    load(w0 + SPAN, a2, ia2);
    // B entries ranked in this window: before A[w0 + SPAN], or all the
    // rest in A's last window
    const float nx = __shfl_sync(FULL, a2[0], 0, 16);
    const int nix = __shfl_sync(FULL, ia2[0], 0, 16);
    const bool last = w0 + SPAN >= na;
    int hi = lo;
    if (act && w0 < na)
      while (hi < nb && (last || lex_less(bd[hi], bi[hi], nx, nix))) ++hi;
    const int mine = hi - lo;
    const int most = max(mine, __shfl_xor_sync(FULL, mine, 16));
    int off[MERGE_U];   // B entries ranked at or below each A entry
#pragma unroll
    for (int u = 0; u < MERGE_U; ++u) off[u] = lo;
    for (int jj = 0; jj < most; ++jj) {
      const int j = lo + jj;
      const bool live = jj < mine;
      const float b = live ? bd[j] : 0.f;
      const int ib = live ? bi[j] : 0;
      int c = 0;
#pragma unroll
      for (int u = 0; u < MERGE_U; ++u) c += live && lex_less(a[u], ia[u], b, ib);
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1) c += __shfl_xor_sync(FULL, c, sh);
      if (live) {
#pragma unroll
        for (int u = 0; u < MERGE_U; ++u) off[u] += c <= u * 16 + xg;
        if (xg == 0 && w0 + c + j < m) {
          od[w0 + c + j] = b;
          oi[w0 + c + j] = ib;
        }
      }
    }
    if (act && w0 < na) {
#pragma unroll
      for (int u = 0; u < MERGE_U; ++u) {
        const int e = w0 + u * 16 + xg;
        if (e < na && e + off[u] < m) {
          od[e + off[u]] = a[u];
          oi[e + off[u]] = ia[u];
        }
      }
    }
    lo = hi;
#pragma unroll
    for (int u = 0; u < MERGE_U; ++u) {
      a[u] = a2[u];
      ia[u] = ia2[u];
    }
  }
  // A empty: B goes as it is
  if (act && na == 0)
    for (int j = xg; j < nb && j < m; j += 16) {
      od[j] = bd[j];
      oi[j] = bi[j];
    }
}

// Lane xg of a half-warp writes outputs [m*xg/16, m*(xg+1)/16) of the
// (u, id)-ordered merge of the sorted lists A (na entries) and B (nb, in
// global memory written by another block, read with __ldcg), m <= na + nb,
// into O (not aliasing A or B).  Each lane finds where its outputs start
// by a binary search on the merge path, then merges sequentially.
__device__ __forceinline__ void merge_path(const float* ad, const int* ai,
                                           int na, const float* bd,
                                           const int* bi, int nb, float* od,
                                           int* oi, int m, int xg) {
  const int p0 = static_cast<int>(static_cast<long long>(m) * xg / 16);
  const int p1 = static_cast<int>(static_cast<long long>(m) * (xg + 1) / 16);
  int lo = max(0, p0 - nb), hi = min(p0, na);
  while (lo < hi) {   // the count taken from A among the first p0 outputs
    const int i = (lo + hi) >> 1;
    const int j = p0 - i;
    if (!lex_less(__ldcg(bd + j - 1), __ldcg(bi + j - 1), ad[i], ai[i]))
      lo = i + 1;
    else
      hi = i;
  }
  int i = lo, j = p0 - lo;
  for (int p = p0; p < p1; ++p) {
    bool from_a = j >= nb;
    float b = 0.f;
    int ib = 0;
    if (!from_a) {
      b = __ldcg(bd + j);
      ib = __ldcg(bi + j);
      from_a = i < na && !lex_less(b, ib, ad[i], ai[i]);
    }
    if (from_a) {
      od[p] = ad[i];
      oi[p] = ai[i];
      ++i;
    } else {
      od[p] = b;
      oi[p] = ib;
      ++j;
    }
  }
}

// grid = (ceil(q / TQ), splits).  Block (bx, by) scans the rows of range
// by for queries [bx*TQ, bx*TQ + TQ).  Each query keeps a sorted working
// set of at most k (u, id) in global scratch, two slots that take turns
// (part_d / part_i, (splits, q, 2, k)), its size `fill` and its k-th
// value tau (+inf until full); a tile's scores below tau go to the query's
// MERGE_W-slot buffer in shared memory, and a buffer that cannot take
// another tile's survivors is sorted and merged into the set.  With
// splits > 1 each range publishes fill*2 + slot in part_f (splits, q) and
// the last block of a query tile (counters) merges the other ranges' sets
// into its own.  The ranges of a query share a bound, bound[q] (order
// bits, all ones before any range has k entries): each range that holds k
// entries lowers it to its k-th value, and a flush takes it into tau.  A
// range's k-th value bounds the query's final k-th from above, so the
// bound drops nothing that belongs to the top k (a point tied with it may
// give way to another of the same u).  Output: the sorted set, rd =
// max(u + ||q||^2, 0), and (+inf, -1) past fill.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
knn_merge_kernel(const float* __restrict__ points,
                 const float* __restrict__ queries,
                 const float* __restrict__ norms, float* __restrict__ out_d,
                 int* __restrict__ out_i, float* __restrict__ part_d,
                 int* __restrict__ part_i, int* __restrict__ part_f,
                 unsigned* __restrict__ bound, int* __restrict__ counters,
                 long long n, int q, int d, int k, int splits) {
  extern __shared__ float4 smem4[];
  __shared__ int is_last;
  __shared__ int fin[TQ];                   // fill*2 + slot per query row
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf_d = smem + tile_floats(d);     // [TQ][MERGE_W]
  int* buf_i = reinterpret_cast<int*>(buf_d + TQ * MERGE_W);
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qg = lane >> 4;
  const int xg = lane & 15;
  const int rbase = warp * 8 + qg * 4;
  const unsigned below = (1u << xg) - 1u;   // lanes under xg in its half

  // the two slots of query row r of range `sp`
  auto set_d = [&](int sp, int r, int slot) {
    return part_d + ((static_cast<long long>(sp) * q + q0 + r) * 2 + slot) * k;
  };
  auto set_i = [&](int sp, int r, int slot) {
    return part_i + ((static_cast<long long>(sp) * q + q0 + r) * 2 + slot) * k;
  };

  float tau[4];
  int fill[4], cnt[4], slot[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // rows past q get tau = -inf: nothing is ever below it
    tau[j] = q0 + rbase + j < q ? INFINITY : -INFINITY;
    fill[j] = cnt[j] = slot[j] = 0;
  }

  // merge query j's buffer into its set where `act`; the whole warp calls
  auto flush = [&](int j, bool act) {
    float* bd = buf_d + (rbase + j) * MERGE_W;
    int* bi = buf_i + (rbase + j) * MERGE_W;
    sort_buffer(bd, bi, cnt[j], act, xg);
    const int m = min(k, fill[j] + cnt[j]);
    merge_into(set_d(split, rbase + j, slot[j]),
               set_i(split, rbase + j, slot[j]), fill[j], bd, bi, cnt[j],
               set_d(split, rbase + j, slot[j] ^ 1),
               set_i(split, rbase + j, slot[j] ^ 1), m, act, xg);
    __syncwarp();
    if (act) {
      slot[j] ^= 1;
      fill[j] = m;
      cnt[j] = 0;
      unsigned* bq = bound + q0 + rbase + j;
      if (m == k) {
        const float kth = set_d(split, rbase + j, slot[j])[k - 1];
        if (kth < tau[j]) tau[j] = kth;
        if (xg == 0) atomicMin(bq, order_bits(kth));
      }
      const float shared = from_order_bits(__ldcg(bq));
      if (shared < tau[j]) tau[j] = shared;
    }
    __syncwarp();
  };

  const long long ntiles = (n + TN - 1) / TN;
  const long long per = (ntiles + splits - 1) / splits;
  const long long t_begin = min(ntiles, per * split);
  const long long t_end = min(ntiles, t_begin + per);

  scan_tiles<VEC>(points, queries, norms, n, q, d, q0, t_begin, t_end, smem,
                  [&](long long t, const float* xnb, float (&acc)[4][4]) {
    const int tile0 = static_cast<int>(t * TN);
    float v[4][4];
    bool need[4];
    bool any_need = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float u = xnb[xg + 16 * i] - 2.f * acc[j][i];
        v[j][i] = (u < INFINITY) ? u : INFINITY;   // NaN -> +inf
        c += __popc((__ballot_sync(FULL, v[j][i] < tau[j]) >> (qg * 16)) &
                    0xffffu);
      }
      need[j] = cnt[j] + c > MERGE_W;
      any_need |= need[j];
    }
    // a buffer that cannot take this tile's survivors flushes, and with it
    // every buffer at least half full: the warps' merges overlap
    if (__syncthreads_or(any_need)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool go = need[j] || 2 * cnt[j] >= MERGE_W;
        if (__any_sync(FULL, go)) flush(j, go);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* bd = buf_d + (rbase + j) * MERGE_W;
      int* bi = buf_i + (rbase + j) * MERGE_W;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hit = v[j][i] < tau[j];
        const unsigned mine =
            (__ballot_sync(FULL, hit) >> (qg * 16)) & 0xffffu;
        if (hit) {
          const int at = cnt[j] + __popc(mine & below);
          bd[at] = v[j][i];
          bi[at] = tile0 + xg + 16 * i;
        }
        cnt[j] += __popc(mine);
      }
    }
  });

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool need = cnt[j] > 0;
    if (__any_sync(FULL, need)) flush(j, need);
  }

  if (splits > 1) {
    if (xg == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q0 + rbase + j < q)
          part_f[static_cast<long long>(split) * q + q0 + rbase + j] =
              fill[j] * 2 + slot[j];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      is_last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rbase + j;
      const bool live = q0 + r < q;
      for (int other = 0; other < splits; ++other) {
        if (other == split) continue;
        const int meta =
            live ? __ldcg(part_f + static_cast<long long>(other) * q + q0 + r)
                 : 0;
        const int ofill = meta >> 1;
        const int m = min(k, fill[j] + ofill);
        if (live && ofill > 0)
          merge_path(set_d(split, r, slot[j]), set_i(split, r, slot[j]),
                     fill[j], set_d(other, r, meta & 1),
                     set_i(other, r, meta & 1), ofill,
                     set_d(split, r, slot[j] ^ 1),
                     set_i(split, r, slot[j] ^ 1), m, xg);
        __syncwarp();
        if (live && ofill > 0) {
          slot[j] ^= 1;
          fill[j] = m;
        }
      }
    }
  }
  if (xg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) fin[rbase + j] = fill[j] * 2 + slot[j];
  }
  __syncthreads();

  // ---- output: rd = max(u + ||q||^2, 0); past fill (+inf, -1) ----------
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int gq = q0 + r;
    if (gq >= q) break;
    const float* qrow = queries + static_cast<long long>(gq) * d;
    float qn = 0.f;
    for (int f = lane; f < d; f += 32) qn = fmaf(qrow[f], qrow[f], qn);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) qn += __shfl_xor_sync(FULL, qn, off);
    const int nf = fin[r] >> 1;
    const float* sd = set_d(split, r, fin[r] & 1);
    const int* si = set_i(split, r, fin[r] & 1);
    float* od = out_d + static_cast<long long>(gq) * k;
    int* oi = out_i + static_cast<long long>(gq) * k;
    for (int e = lane; e < k; e += 32) {
      if (e < nf) {
        const float rd = sd[e] + qn;
        od[e] = rd < 0.f ? 0.f : rd;
        oi[e] = si[e];
      } else {
        od[e] = INFINITY;
        oi[e] = -1;
      }
    }
  }
}

size_t tile_smem_bytes(int d) {
  return sizeof(float) * static_cast<size_t>(tile_floats(d));
}

template <int MODE>
cudaError_t set_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<MODE, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(knn_kernel<MODE, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t set_merge_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_merge_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(knn_merge_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Shared memory of one block, and the attribute that allows it: the tile
// staging plus the working sets (fold, capped, bcap, when ws_in_smem) or
// the survivor buffers (merge).
cudaError_t prepare(int mode, int d, int k, int ws_in_smem, size_t* smem) {
  *smem = tile_smem_bytes(d) +
          (mode == MODE_MERGE ? static_cast<size_t>(TQ) * MERGE_W * 8
           : ws_in_smem       ? static_cast<size_t>(TQ) * k * 8
                              : 0);
  switch (mode) {
    case MODE_FOLD: return set_smem<MODE_FOLD>(*smem);
    case MODE_CAPPED: return set_smem<MODE_CAPPED>(*smem);
    case MODE_BCAP: return set_smem<MODE_BCAP>(*smem);
    case MODE_MERGE: return set_merge_smem(*smem);
  }
  return cudaErrorInvalidValue;
}

cudaError_t occupancy(int mode, int* per_sm, size_t smem) {
  switch (mode) {
    case MODE_FOLD:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, knn_kernel<MODE_FOLD, true>, THREADS, smem);
    case MODE_CAPPED:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, knn_kernel<MODE_CAPPED, true>, THREADS, smem);
    case MODE_BCAP:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, knn_kernel<MODE_BCAP, true>, THREADS, smem);
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, knn_merge_kernel<true>, THREADS, smem);
}

template <int MODE>
void launch(bool vec, dim3 grid, size_t smem, cudaStream_t stream,
            const float* points, const float* queries, const float* norms,
            float* out_d, int* out_i, float* out_t, float* part_d,
            int* part_i, float* part_m, int* counters, long long n, int q,
            int d, int k, int tile_tiles, int passes, int splits,
            int ws_in_smem) {
  if (vec)
    knn_kernel<MODE, true><<<grid, THREADS, smem, stream>>>(
        points, queries, norms, out_d, out_i, out_t, part_d, part_i, part_m,
        counters, n, q, d, k, tile_tiles, passes, splits, ws_in_smem);
  else
    knn_kernel<MODE, false><<<grid, THREADS, smem, stream>>>(
        points, queries, norms, out_d, out_i, out_t, part_d, part_i, part_m,
        counters, n, q, d, k, tile_tiles, passes, splits, ws_in_smem);
}

}  // namespace

extern "C" {

// The kernels' fixed sizes: queries per block (counters are sized by it),
// rows per tile (capped tiles are multiples of it), rows per bcap block,
// and the largest passes and k (fold, capped and bcap; merge).
void knn_constants(int* tq, int* tn, int* block, int* max_passes,
                   int* max_k, int* merge_max_k) {
  *tq = TQ;
  *tn = TN;
  *block = BLOCK;
  *max_passes = MAX_PASSES;
  *max_k = MAX_K;
  *merge_max_k = MERGE_MAX_K;
}

// The launch plan for a problem: where the working set lives (shared
// memory when two blocks still fit on an SM; always global for merge) and
// how many row ranges to split into.  The split minimizes the waves of
// blocks over the card's resident-block slots per unit of work (within 5%
// of the best, fewest splits), keeping each range at least
// MIN_TILES_PER_SPLIT tiles of rows and a whole number of tile_tiles.
// mode: 0 fold, 1 capped, 2 bcap, 3 merge (tile_tiles 1).
int knn_plan(int mode, long long n, int q, int d, int k, int tile_tiles,
             int* splits, int* ws_in_smem) {
  if (mode < MODE_FOLD || mode > MODE_MERGE || tile_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ws = static_cast<size_t>(TQ) * k * 8;
  *ws_in_smem = mode != MODE_MERGE &&
                tile_smem_bytes(d) + ws + 1024 <= static_cast<size_t>(optin) / 2;
  size_t smem = 0;
  err = prepare(mode, d, k, *ws_in_smem, &smem);
  int per_sm = 0;
  if (err == cudaSuccess) err = occupancy(mode, &per_sm, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long qtiles = (q + TQ - 1) / TQ;
  const long long ntiles = (n + TN - 1) / TN;
  const long long units = (ntiles + tile_tiles - 1) / tile_tiles;
  const long long min_units =
      (MIN_TILES_PER_SPLIT + tile_tiles - 1) / tile_tiles;
  long long max_splits = units / min_units;
  max_splits = max_splits < 1 ? 1 : (max_splits > MAX_SPLITS ? MAX_SPLITS
                                                              : max_splits);
  double best = 1e30;
  double cost[MAX_SPLITS + 1];
  for (long long s = 1; s <= max_splits; ++s) {
    const long long waves = (qtiles * s + slots - 1) / slots;
    cost[s] = static_cast<double>(waves) / s;
    if (cost[s] < best) best = cost[s];
  }
  *splits = 1;
  for (long long s = 1; s <= max_splits; ++s)
    if (cost[s] <= 1.05 * best) {
      *splits = static_cast<int>(s);
      break;
    }
  return 0;
}

// mode: 0 fold, 1 capped, 2 bcap.  points (n, d), queries (q, d), norms
// (n,) float32, row-major; outputs out_d (q, k) float32, out_i (q, k)
// int32 and, for capped and bcap, out_t (q,) float32.  Scratch part_d
// (splits, q, k) float32 and part_i (splits, q, k) int32 (unused when
// splits == 1 and ws_in_smem), part_m (splits, q) float32 (capped, bcap)
// and zeroed counters (ceil(q / TQ),) int32.  1 <= k <= MAX_K, q >= 1,
// n < 2^31; capped: k <= tile_tiles * TN; bcap: k <= tile_tiles * TN /
// BLOCK; 0 <= passes <= MAX_PASSES.  splits and ws_in_smem as knn_plan
// returned them for the same mode, n, q, d, k and tile_tiles.  Returns the
// launch's cudaError_t (0 on success).
int knn_launch(int mode, const float* points, const float* queries,
               const float* norms, float* out_d, int* out_i, float* out_t,
               float* part_d, int* part_i, float* part_m, int* counters,
               long long n, int q, int d, int k, int tile_tiles, int passes,
               int splits, int ws_in_smem, void* stream) {
  const long long cap = mode == MODE_CAPPED ? static_cast<long long>(tile_tiles) * TN
                        : mode == MODE_BCAP ? static_cast<long long>(tile_tiles) * (TN / BLOCK)
                                            : MAX_K;
  if (mode < MODE_FOLD || mode > MODE_BCAP || k < 1 || k > MAX_K ||
      k > cap || tile_tiles < 1 || (mode == MODE_FOLD && tile_tiles != 1) ||
      passes < 0 || passes > MAX_PASSES || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = prepare(mode, d, k, ws_in_smem, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const dim3 grid((q + TQ - 1) / TQ, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_FOLD:
      launch<MODE_FOLD>(vec, grid, smem, s, points, queries, norms, out_d,
                        out_i, out_t, part_d, part_i, part_m, counters, n, q,
                        d, k, tile_tiles, passes, splits, ws_in_smem);
      break;
    case MODE_CAPPED:
      launch<MODE_CAPPED>(vec, grid, smem, s, points, queries, norms, out_d,
                          out_i, out_t, part_d, part_i, part_m, counters, n,
                          q, d, k, tile_tiles, passes, splits, ws_in_smem);
      break;
    default:
      launch<MODE_BCAP>(vec, grid, smem, s, points, queries, norms, out_d,
                        out_i, out_t, part_d, part_i, part_m, counters, n, q,
                        d, k, tile_tiles, passes, splits, ws_in_smem);
  }
  return static_cast<int>(cudaGetLastError());
}

// The merge kernel.  Inputs as knn_launch; outputs out_d (q, k) float32
// ascending and out_i (q, k) int32.  Scratch part_d (splits, q, 2, k)
// float32, part_i (splits, q, 2, k) int32, part_f (splits, q) int32 (unused
// when splits == 1), bound (q,) uint32 set to all ones, and zeroed
// counters (ceil(q / TQ),) int32.  1 <= k <= MERGE_MAX_K, q >= 1,
// n < 2^31; splits as knn_plan returned it for mode 3.  Returns the
// launch's cudaError_t (0 on success).
int knn_merge_launch(const float* points, const float* queries,
                     const float* norms, float* out_d, int* out_i,
                     float* part_d, int* part_i, int* part_f,
                     unsigned* bound, int* counters, long long n, int q,
                     int d, int k, int splits, void* stream) {
  if (k < 1 || k > MERGE_MAX_K || q < 1 || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = prepare(MODE_MERGE, d, k, 0, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const dim3 grid((q + TQ - 1) / TQ, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    knn_merge_kernel<true><<<grid, THREADS, smem, s>>>(
        points, queries, norms, out_d, out_i, part_d, part_i, part_f, bound,
        counters, n, q, d, k, splits);
  else
    knn_merge_kernel<false><<<grid, THREADS, smem, s>>>(
        points, queries, norms, out_d, out_i, part_d, part_i, part_f, bound,
        counters, n, q, d, k, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
