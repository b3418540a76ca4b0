// knn_fold.cu — the fold family of streaming top-k kernels.
//
// Replaces four kernels of petal_neighbors_tpu/ops/pallas/knn_kernel.py,
// one template instantiated per mode:
//   MODE_FOLD   _knn_kernel (:186, the "fold" scheme, with _fold_min :97):
//               the exact k smallest u per query.
//   MODE_FOLD_LAZY _knn_kernel_lazy (:116, the opt-in "fold_lazy" scheme):
//               fold's results bit for bit; a tile first takes one fused
//               test (below) before any per-candidate work.
//   MODE_CAPPED _knn_kernel_capped (:429): at most `passes` extractions per
//               tile of rows, plus a per-query threshold thr below which no
//               point outside the working set can lie.
//   MODE_BCAP   _knn_kernel_bcap (:546): the capped scheme over the minima
//               of blocks of BLOCK = 16 contiguous rows; returns block ids.
// fold scores on the FP32 SIMT tile product scan_tiles (knn_tiles.cuh),
// fold_lazy on its wider sibling wide::scan (lazy_kernel below; the same
// FP32 sums, bit for bit); capped and bcap on the split-bf16 tensor-core
// product (knn_tc.cuh) on piece planes split once (split_planes.cu), the
// TPU kernels' "highest" arithmetic: capped reads its u
// tile (tc::scan), bcap only the 16-row block minima reduced in the
// accumulator registers (tc::scan_minima), bit for bit knn_minima.cu's.  The Euclidean merge
// (_knn_kernel_merge) lives in knn_select.cu, on the tensor-core product.
// MODE_FOLD serves fold's large batches; small ones (the route's repairs)
// run knn_select.cu's radix select over the same u (fold_pass_kernel), as
// knn_kernel.py's fold_path decides.
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
// What bounds them on this card: fold and fold_lazy, FP32 arithmetic on
// the SIMT cores, 2*Q*N*d FLOP (one FMA per query, row and feature); capped
// and bcap, six bf16 products on the tensor cores, 6 * 2*Q*N*d FLOP at 989
// TFLOP/s.  The point set is streamed once per query tile through shared
// memory: N*d*4 bytes per 64 queries (128 for fold_lazy), far under the
// arithmetic time; capped and bcap stream the points' bf16 piece planes
// (split_planes.cu, made once per index: 6 bytes an element) per 128
// queries, and take the queries' planes, split once per call.
//
// Design:
//   * one block = TQ = 64 queries, 256 threads = 8 warps (capped and bcap:
//     128 queries, 512 threads, the tensor-core product's tile; fold_lazy:
//     below); warp w
//     owns queries 8w..8w+7.  Each half-warp owns 4 of them, and each of
//     its 16 lanes holds 4 x 4 scores (4 queries x 4 points: rows xg,
//     xg+16, xg+32, xg+48 of a 64-row tile), so one half-warp holds all
//     TN = 64 scores of its 4 queries.  On the SIMT product the scores are
//     the lane's own register tile; capped reads them from the tensor-core
//     product's u tile in shared memory (128 rows, two 64-row tiles of
//     selection), which decouples the mma fragment layout from the
//     selection.  bcap reads the 4 block minima of each 64-row half of the
//     product's 128 x 8 block-minima array (every lane of a half-warp the
//     same 4 of its query).
//   * the SIMT product streams rows in tiles of TN = 64, staged in shared
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
//   * fold_lazy: the TPU kernel's point is one fused reduce per tile (the
//     tile minimum against each query's tau) before the u tile and the
//     extraction loop.  Here that is one warp-wide vote over the warp's 16
//     queries and 128 rows (__reduce_or_sync of a mask of the queries that
//     hit): only for a query that hit in either half-warp do the NaN
//     conversion and a fold_query call (with its own vote) run.  It has
//     its own kernel (lazy_kernel) on the wide product of knn_tiles.cuh:
//     128 queries x 128-row tiles on 256 threads, an 8 x 8 register tile
//     a thread (a half-warp owns 8 queries, 8 candidates a lane),
//     64-feature chunks in a 3-stage cp.async ring, one barrier a chunk
//     and none around the vote.  It reads each index row once per 128
//     queries and issues 16 shared-memory loads per 256 FFMA (fold's
//     scan_tiles: 8 per 64).  The scores are summed in fold's order and
//     every comparison is fold's, so its rdist are fold's bit for bit; at
//     a tie on a row's largest rdist the ids kept may differ, as between
//     fold's two paths.  Tried on an H100 and slower: a producer warp
//     with an mbarrier ring in place of the barriers (a ninth warp caps a
//     thread at 168 registers, and the tile spilled), two blocks an SM
//     (128 registers: spilled), 32-feature chunks (twice the barriers),
//     fragments prefetched a step ahead, and the generic staging loop's
//     division per copy (the full chunks' copies now step without one).
//   * capped / bcap: each query keeps a sorted list of the passes+1
//     smallest candidates of the current tile, one entry per lane of its
//     half-warp (insertion = ballot + shuffle-up); at the tile's end its
//     first `passes` entries are folded into the set and entry `passes`
//     lowers miss.  bcap with passes < LANE_LIST (the route's k=10 runs 2)
//     fills that list only at the tile's end: until then each lane keeps
//     its own sorted list of LANE_LIST candidates in registers, of one
//     query and every fourth block, with no vote or shuffle per candidate,
//     and the four lanes of a query merge theirs.  Either way the list
//     holds the tile's passes+1 smallest (value, id), whatever the order
//     the candidates came in.
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
//   * the working set lives in shared memory when it still lets as many
//     blocks share an SM as without it (two for fold, one for the others),
//     and otherwise in the global scratch part_d / part_i.
//
// The C entry points return a cudaError_t; the launch returns
// cudaGetLastError() right after the launch.

#include "knn_tc.cuh"

namespace {

constexpr int MODE_FOLD = 0;
constexpr int MODE_CAPPED = 1;
constexpr int MODE_BCAP = 2;
constexpr int MODE_FOLD_LAZY = 4;   // 3 was merge, now knn_select.cu

// fold and fold_lazy keep the exact top k (no seed, no list, no threshold)
__host__ __device__ constexpr bool folds(int mode) {
  return mode == MODE_FOLD || mode == MODE_FOLD_LAZY;
}

constexpr int BLOCK = 16;     // rows per bcap block
constexpr int MAX_PASSES = 15;  // the list of passes+1 entries spans 16 lanes
// bcap with passes < LANE_LIST keeps a list in each lane's registers
constexpr int LANE_LIST = 4;
constexpr int MAX_K = 1024;

// The smallest of the half-warp's candidates (v, cid), R a lane, ties to
// the smaller id (jnp.argmin's first index: ids grow with the column).
template <int R>
__device__ __forceinline__ void half_warp_argmin(const float (&v)[R],
                                                 const int (&cid)[R],
                                                 float& m, int& id) {
  m = v[0];
  id = cid[0];
#pragma unroll
  for (int i = 1; i < R; ++i)
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

// The fold step for one query per half-warp: lane xg holds R candidates
// (v[i], cid[i]); the half-warp's 16 R candidates enter the working set
// (wd, wi) of k slots in ascending order while they beat its maximum tau.
// Every lane of the warp calls this (shuffles span the warp); the two
// half-warps fold their own queries.  A candidate with NaN score must be
// passed as +inf.
template <int R>
__device__ __forceinline__ void fold_query(float (&v)[R], const int (&cid)[R],
                                           float& tau, int& amax, int& fill,
                                           float* wd, int* wi, int k,
                                           int xg) {
  bool hit = false;
#pragma unroll
  for (int i = 0; i < R; ++i) hit |= v[i] < tau;
  if (!__any_sync(FULL, hit)) return;
  while (true) {
    float m;
    int id;
    half_warp_argmin(v, cid, m, id);
    const bool take = m < tau;
    if (!__any_sync(FULL, take)) return;
    if (take) {
#pragma unroll
      for (int i = 0; i < R; ++i)
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

// grid = (ceil(q / QT), splits), QT = block_queries(MODE).  Block (bx, by)
// scans the rows of range by into the working sets of queries
// [bx*QT, bx*QT + QT).  part_d/part_i
// (splits, q, k) hold the working sets when they are not in shared memory
// and receive each range's set when splits > 1; part_m (splits, q) each
// range's miss (capped, bcap); counters (ceil(q / QT),), zeroed, elect the
// last block of each query tile to merge.  Ranges are whole tiles of
// tile_tiles x TN rows (1 for fold).
// Queries and threads per block of a mode: capped's and bcap's tensor-core
// product takes tc::TQ = 128 queries on 512 threads, fold's SIMT product
// TQ = 64 on 256 (a half-warp owns 4 queries in knn_kernel), and
// fold_lazy's wide product wide::TQ = 128 on 256 (lazy_kernel, 8 queries a
// half-warp).
__host__ __device__ constexpr bool on_tc(int mode) {
  return mode == MODE_CAPPED || mode == MODE_BCAP;
}
__host__ __device__ constexpr int block_queries(int mode) {
  return on_tc(mode) ? tc::TQ : mode == MODE_FOLD_LAZY ? wide::TQ : TQ;
}
__host__ __device__ constexpr int block_threads(int mode) {
  return on_tc(mode) ? tc::THREADS
                     : mode == MODE_FOLD_LAZY ? wide::THREADS : THREADS;
}
static_assert(tc::THREADS == 4 * tc::TQ && THREADS == 4 * TQ,
              "a half-warp owns 4 queries");
static_assert(tc::BLOCK == BLOCK && tc::TN == 2 * TN,
              "a tensor-core tile is two 64-row tiles of selection");

// Floats of shared memory the tile product of `mode` takes at width d
// (bcap and fold_lazy keep the queries resident where they can).
__host__ __device__ __forceinline__ int product_floats(int mode, int d) {
  return mode == MODE_CAPPED ? tc::smem_floats(d)
         : mode == MODE_BCAP ? tc::minima_smem_floats(d, tc::hoists(d))
         : mode == MODE_FOLD_LAZY ? wide::smem_floats(d)
                                  : tile_floats(d);
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(block_threads(MODE))
knn_kernel(const float* __restrict__ points, const float* __restrict__ queries,
           const float* __restrict__ norms, const char* __restrict__ xplanes,
           const char* __restrict__ qplanes, float* __restrict__ out_d,
           int* __restrict__ out_i, float* __restrict__ out_t,
           float* __restrict__ part_d, int* __restrict__ part_i,
           float* __restrict__ part_m, int* __restrict__ counters,
           long long n, int q, int d, int k, int tile_tiles, int passes,
           int splits, int ws_in_smem) {
  extern __shared__ float4 smem4[];
  __shared__ int is_last;
  constexpr int QT = block_queries(MODE);
  constexpr int NT = block_threads(MODE);
  __shared__ float thr_s[QT];
  float* smem = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const long long qk = static_cast<long long>(q) * k;
  float* ws_d;
  int* ws_i;
  if (ws_in_smem) {
    // [QT][k] after the tile product's own shared memory
    ws_d = smem + product_floats(MODE, d);
    ws_i = reinterpret_cast<int*>(ws_d + QT * k);
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
  const int valid_rows = min(QT, q - q0);
  for (int e = tid; e < valid_rows * k; e += NT) {
    ws_d[e] = INFINITY;
    ws_i[e] = -1;
  }

  float tau[4], miss[4], lv[4];
  int amax[4], fill[4], li[4];
  bool live[4];
  // bcap, passes < LANE_LIST: this lane's sorted (value, id) list of the
  // LANE_LIST smallest candidates it read in the current tile
  float own_v[LANE_LIST];
  int own_i[LANE_LIST];
#pragma unroll
  for (int e = 0; e < LANE_LIST; ++e) {
    own_v[e] = INFINITY;
    own_i[e] = INT_MAX;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    live[j] = q0 + rbase + j < q;
    // rows past q get tau = -inf: nothing is ever below it
    tau[j] = live[j] ? INFINITY : -INFINITY;
    amax[j] = 0;
    // capped / bcap sets are full from the seed on (+inf slots included)
    fill[j] = (folds(MODE) || !live[j]) ? 0 : k;
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

  // ---- capped, bcap: at the end of each tile of tile_tiles x TN rows, or
  // of the range, the lists fold into the working sets ---------------------
  auto tile_end = [&](long long t) {
    if ((t - t_begin + 1) % tile_tiles == 0 || t + 1 == t_end) {
      if (MODE == MODE_BCAP && passes < LANE_LIST) {
        // the four lanes of query j (lanes 4j .. 4j+3 of the half-warp)
        // merge their lists: entry e, the least of their heads, goes to
        // lane e of the half-warp's list, and its lane pops it
        for (int e = 0; e <= passes; ++e) {
          float m = own_v[0];
          int id = own_i[0];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float om = __shfl_xor_sync(FULL, m, off);
            const int oid = __shfl_xor_sync(FULL, id, off);
            if (lex_less(om, oid, m, id)) {
              m = om;
              id = oid;
            }
          }
          if (own_v[0] == m && own_i[0] == id) {
#pragma unroll
            for (int f = 0; f + 1 < LANE_LIST; ++f) {
              own_v[f] = own_v[f + 1];
              own_i[f] = own_i[f + 1];
            }
            own_v[LANE_LIST - 1] = INFINITY;
            own_i[LANE_LIST - 1] = INT_MAX;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float vj = __shfl_sync(FULL, m, 4 * j, 16);
            const int ij = __shfl_sync(FULL, id, 4 * j, 16);
            if (xg == e) {
              lv[j] = vj;
              li[j] = ij;
            }
          }
        }
#pragma unroll
        for (int f = 0; f < LANE_LIST; ++f) {
          own_v[f] = INFINITY;
          own_i[f] = INT_MAX;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        flush_list(lv[j], li[j], tau[j], amax[j], miss[j],
                   ws_d + (rbase + j) * k, ws_i + (rbase + j) * k, k,
                   passes, live[j], first_flush, xg);
      first_flush = false;
    }
  };

  // ---- fold, capped: a 64-row tile's scores into the working sets;
  // uval(j, i) is u of query rbase + j and row t*TN + xg + 16 i -----------
  auto tile_body = [&](long long t, auto&& uval) {
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
          const float u = uval(j, i);
          v[j][i] = (u < INFINITY) ? u : INFINITY;   // NaN -> +inf
          // a NaN query gives NaN at every row, a finite one at none
          if (i == 0) qnan[j] = u != u;
        }
      }
      if (folds(MODE)) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fold_query(v[j], cid, tau[j], amax[j], fill[j],
                     ws_d + (rbase + j) * k, ws_i + (rbase + j) * k, k, xg);
      } else {   // MODE_CAPPED
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
        tile_end(t);
      }
  };

  // ---- bcap: a 64-row tile's 4 block minima into the lists.  bb[j * tc::BS
  // + i] is the least u of query rbase + j over rows t*TN + 16 i .. + 15
  // (NaN for a NaN query).  The range's first k blocks seed the working
  // set.  With passes < LANE_LIST lane xg takes query xg / 4's block xg % 4
  // into its own list (no vote, no shuffle); the lists merge at the tile's
  // end (tile_end).  Otherwise each query's blocks enter the half-warp's
  // list one by one, as capped's candidates do. --------------------------
  auto bcap_body = [&](long long t, const float* bb) {
    const long long relb0 = (t - t_begin) * (TN / BLOCK);
    const int bid0 = static_cast<int>(t * (TN / BLOCK));
    if (relb0 < k && xg == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a NaN query's minima are all NaN, a finite one's none
        const bool qnan = bb[j * tc::BS] != bb[j * tc::BS];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bid = bid0 + i;
          const float b = bb[j * tc::BS + i];
          if (relb0 + i < k && live[j] &&
              static_cast<long long>(bid) * BLOCK < n) {
            ws_d[(rbase + j) * k + relb0 + i] =
                qnan || !(b < INFINITY) ? INFINITY : b;
            ws_i[(rbase + j) * k + relb0 + i] = qnan ? -1 : bid;
          }
        }
      }
    }
    if (passes < LANE_LIST) {
      const int i = xg & 3;
      const float c = bb[(xg >> 2) * tc::BS + i];
      const int id = bid0 + i;
      // NaN and +inf never enter
      if (relb0 + i >= k && c < INFINITY &&
          lex_less(c, id, own_v[LANE_LIST - 1], own_i[LANE_LIST - 1])) {
#pragma unroll
        for (int e = LANE_LIST - 1; e > 0; --e) {
          const bool before = lex_less(c, id, own_v[e - 1], own_i[e - 1]);
          if (before || lex_less(c, id, own_v[e], own_i[e])) {
            own_v[e] = before ? own_v[e - 1] : c;
            own_i[e] = before ? own_i[e - 1] : id;
          }
        }
        if (lex_less(c, id, own_v[0], own_i[0])) {
          own_v[0] = c;
          own_i[0] = id;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float thv = __shfl_sync(FULL, lv[j], passes, 16);
        int thi = __shfl_sync(FULL, li[j], passes, 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bid = bid0 + i;
          const float b = bb[j * tc::BS + i];
          const bool ins = relb0 + i >= k && b < INFINITY &&
                           lex_less(b, bid, thv, thi);
          if (!__any_sync(FULL, ins)) continue;
          list_insert(lv[j], li[j], b, bid, ins, xg, qg);
          thv = __shfl_sync(FULL, lv[j], passes, 16);
          thi = __shfl_sync(FULL, li[j], passes, 16);
        }
      }
    }
    tile_end(t);
  };

  if constexpr (MODE == MODE_CAPPED) {
    // the tensor-core product: 128-row tiles, each two 64-row tiles of
    // selection read from its u tile
    tc::scan(xplanes, qplanes, norms, n, d, q0, t_begin * TN, t_end * TN,
             smem,
                  [&](long long row0, int rows, const float* us) {
      for (int h = 0; h * TN < rows; ++h) {
        const float* ub = us + (rbase * tc::US + h * TN + xg);
        tile_body(row0 / TN + h, [&](int j, int i) {
          return ub[j * tc::US + 16 * i];
        });
      }
    });
  } else if constexpr (MODE == MODE_BCAP) {
    // the same 128-row tiles, read as block minima
    tc::scan_minima(xplanes, qplanes, norms, n, d, q0, t_begin * TN,
                    t_end * TN, tc::hoists(d), smem,
                         [&](long long row0, int rows, const float* bm) {
      for (int h = 0; h * TN < rows; ++h) {
        bcap_body(row0 / TN + h, bm + rbase * tc::BS + h * (TN / BLOCK));
      }
    });
  } else {
    const DotScore score{};
    scan_tiles<VEC>(points, queries, norms, n, q, d, q0, t_begin, t_end,
                    smem, score,
                    [&](long long t, const float* xnb, float (&acc)[4][4]) {
      tile_body(t, [&](int j, int i) {
        return score.finish(acc[j][i], xnb[xg + 16 * i]);
      });
    });
  }

  if (splits > 1) {
    // ---- publish this range's working sets; the last block merges -------
    if (ws_in_smem) {
      float* pd = part_d + split * qk + static_cast<long long>(q0) * k;
      int* pi = part_i + split * qk + static_cast<long long>(q0) * k;
      for (int e = tid; e < valid_rows * k; e += NT) {
        pd[e] = ws_d[e];
        pi[e] = ws_i[e];
      }
    }
    if (!folds(MODE) && xg == 0) {
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
      if (!folds(MODE)) {
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
  if (!folds(MODE) && xg == 0) {
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
    if (!folds(MODE) && lane == 0) out_t[gq] = thr_s[r] + qn;
  }
}

// fold_lazy on the wide product (knn_tiles.cuh's wide::scan): grid =
// (ceil(q / wide::TQ), splits); block (bx, by) folds the rows of range by,
// whole 128-row tiles, into the working sets of queries [bx*wide::TQ, +
// wide::TQ).  A half-warp owns 8 queries, lane xg holds 8 scores of each
// (rows xg + 16 i of the tile).  Scratch, ranges and the last block's fold
// of the other ranges' sets as knn_kernel's, at this block's size.
template <bool VEC>
__global__ void __launch_bounds__(wide::THREADS, 1)
lazy_kernel(const float* __restrict__ points,
            const float* __restrict__ queries,
            const float* __restrict__ norms, float* __restrict__ out_d,
            int* __restrict__ out_i, float* __restrict__ part_d,
            int* __restrict__ part_i, int* __restrict__ counters, long long n,
            int q, int d, int k, int splits, int ws_in_smem) {
  constexpr int QT = wide::TQ;
  constexpr int NT = wide::THREADS;
  constexpr int R = wide::R;
  extern __shared__ float4 smem4[];
  __shared__ int is_last;
  float* smem = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const long long qk = static_cast<long long>(q) * k;
  float* ws_d;
  int* ws_i;
  if (ws_in_smem) {
    ws_d = smem + wide::smem_floats(d);   // [QT][k] after the product's
    ws_i = reinterpret_cast<int*>(ws_d + QT * k);
  } else {
    ws_d = part_d + split * qk + static_cast<long long>(q0) * k;
    ws_i = part_i + split * qk + static_cast<long long>(q0) * k;
  }

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int xg = lane & 15;
  const int rbase = warp * 16 + (lane >> 4) * R;   // this thread's queries

  // working-set init: (+inf, -1); rows past q are never touched
  const int valid_rows = min(QT, q - q0);
  for (int e = tid; e < valid_rows * k; e += NT) {
    ws_d[e] = INFINITY;
    ws_i[e] = -1;
  }
  float tau[R];
  int amax[R], fill[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    // rows past q get tau = -inf: nothing is ever below it
    tau[j] = q0 + rbase + j < q ? INFINITY : -INFINITY;
    amax[j] = 0;
    fill[j] = 0;
  }

  const long long ntiles = (n + wide::TN - 1) / wide::TN;
  const long long per = (ntiles + splits - 1) / splits;
  const long long t_begin = min(ntiles, per * split);
  const long long t_end = min(ntiles, t_begin + per);
  const DotScore score{};
  wide::scan<VEC>(points, queries, norms, n, q, d, q0, t_begin, t_end, smem,
                  [&](long long t, const float* xnb, float (&acc)[R][R]) {
    float xr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) xr[i] = xnb[xg + 16 * i];
    // one fused test for the warp's 16 queries, with the queries that hit
    // (bit j: query rbase + j of either half-warp): a NaN score fails it,
    // as its +inf stand-in fails fold_query's
    unsigned mask = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      bool h = false;
#pragma unroll
      for (int i = 0; i < R; ++i)
        h |= score.finish(acc[j][i], xr[i]) < tau[j];
      mask |= static_cast<unsigned>(h) << j;
    }
    mask = __reduce_or_sync(FULL, mask);
    if (!mask) return;
    int cid[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      cid[i] = static_cast<int>(t * wide::TN) + xg + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!((mask >> j) & 1u)) continue;
      float v[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float u = score.finish(acc[j][i], xr[i]);
        v[i] = (u < INFINITY) ? u : INFINITY;   // NaN -> +inf
      }
      fold_query(v, cid, tau[j], amax[j], fill[j], ws_d + (rbase + j) * k,
                 ws_i + (rbase + j) * k, k, xg);
    }
  });

  if (splits > 1) {
    // ---- publish this range's working sets; the last block folds the
    // other ranges' into its own ---------------------------------------
    if (ws_in_smem) {
      float* pd = part_d + split * qk + static_cast<long long>(q0) * k;
      int* pi = part_i + split * qk + static_cast<long long>(q0) * k;
      for (int e = tid; e < valid_rows * k; e += NT) {
        pd[e] = ws_d[e];
        pi[e] = ws_i[e];
      }
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
      // unrolled, so that tau, amax and fill stay in registers
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int gq = q0 + rbase + j;
        const float* od = part_d + other * qk + static_cast<long long>(gq) * k;
        const int* oi = part_i + other * qk + static_cast<long long>(gq) * k;
        for (int e0 = 0; e0 < k; e0 += 16 * R) {
          float v[R];
          int cid[R];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int e = e0 + xg + 16 * i;
            const bool ok = gq < q && e < k;
            v[i] = ok ? __ldcg(od + e) : INFINITY;
            cid[i] = ok ? __ldcg(oi + e) : -1;
          }
          fold_query(v, cid, tau[j], amax[j], fill[j],
                     ws_d + (rbase + j) * k, ws_i + (rbase + j) * k, k, xg);
        }
      }
    }
  }
  __syncthreads();

  // ---- output: rd = max(u + ||q||^2, 0), ||q||^2 summed as knn_kernel
  // sums it; unfilled slots stay (+inf, -1) -----------------------------
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
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
  }
}

template <class K>
cudaError_t set_smem(K vec, K scalar, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      vec, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(scalar,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int MODE>
cudaError_t set_smem(size_t smem) {
  return set_smem(knn_kernel<MODE, true>, knn_kernel<MODE, false>, smem);
}

// Shared memory of the tile product of `mode` at width d.
size_t product_smem_bytes(int mode, int d) {
  return sizeof(float) * static_cast<size_t>(product_floats(mode, d));
}

// Shared memory of one fold, fold_lazy, capped or bcap block, and the
// attribute that allows it: the tile product plus the working sets when
// ws_in_smem.

cudaError_t prepare(int mode, int d, int k, int ws_in_smem, size_t* smem) {
  *smem = product_smem_bytes(mode, d) +
          (ws_in_smem ? static_cast<size_t>(block_queries(mode)) * k * 8 : 0);
  switch (mode) {
    case MODE_FOLD: return set_smem<MODE_FOLD>(*smem);
    case MODE_CAPPED: return set_smem<MODE_CAPPED>(*smem);
    case MODE_BCAP: return set_smem<MODE_BCAP>(*smem);
    case MODE_FOLD_LAZY:
      return set_smem(lazy_kernel<true>, lazy_kernel<false>, *smem);
  }
  return cudaErrorInvalidValue;
}

cudaError_t occupancy(int mode, int* per_sm, size_t smem) {
  switch (mode) {
    case MODE_FOLD:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, knn_kernel<MODE_FOLD, true>, block_threads(MODE_FOLD), smem);
    case MODE_CAPPED:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, knn_kernel<MODE_CAPPED, true>, block_threads(MODE_CAPPED), smem);
    case MODE_BCAP:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, knn_kernel<MODE_BCAP, true>, block_threads(MODE_BCAP), smem);
    case MODE_FOLD_LAZY:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, lazy_kernel<true>, block_threads(MODE_FOLD_LAZY), smem);
  }
  return cudaErrorInvalidValue;
}

template <int MODE>
void launch(bool vec, dim3 grid, size_t smem, cudaStream_t stream,
            const float* points, const float* queries, const float* norms,
            const char* xplanes, const char* qplanes, float* out_d,
            int* out_i, float* out_t, float* part_d, int* part_i,
            float* part_m, int* counters, long long n, int q, int d, int k,
            int tile_tiles, int passes, int splits, int ws_in_smem) {
  if (vec)
    knn_kernel<MODE, true><<<grid, block_threads(MODE), smem, stream>>>(
        points, queries, norms, xplanes, qplanes, out_d, out_i, out_t,
        part_d, part_i, part_m, counters, n, q, d, k, tile_tiles, passes,
        splits, ws_in_smem);
  else
    knn_kernel<MODE, false><<<grid, block_threads(MODE), smem, stream>>>(
        points, queries, norms, xplanes, qplanes, out_d, out_i, out_t,
        part_d, part_i, part_m, counters, n, q, d, k, tile_tiles, passes,
        splits, ws_in_smem);
}

}  // namespace

extern "C" {

// The kernels' fixed sizes: queries per block (counters are sized by it;
// fold's, and fold_lazy's wide block), rows per tile (capped tiles are
// multiples of it), rows per bcap block, and the largest passes and k.
void knn_constants(int* tq, int* lazy_tq, int* tn, int* block,
                   int* max_passes, int* max_k) {
  *tq = TQ;
  *lazy_tq = wide::TQ;
  *tn = TN;
  *block = BLOCK;
  *max_passes = MAX_PASSES;
  *max_k = MAX_K;
}

// The tensor-core product's tile: queries and rows per tile, features per
// staged chunk, bf16 pieces per element and piece products per pair; one
// warpgroup's wgmma (query rows, point rows) and the plane buffers of a
// streamed operand.
void knn_tc_constants(int* tq, int* tn, int* dc, int* pieces, int* products,
                      int* wg_m, int* wg_n, int* bufs) {
  *tq = tc::TQ;
  *tn = tc::TN;
  *dc = tc::DC;
  *pieces = tc::PIECES;
  *products = tc::PRODUCTS;
  *wg_m = tc::WG_M;
  *wg_n = tc::WG_N;
  *bufs = tc::BUFS;
}

// The launch plan for a problem: where the working set lives (shared
// memory when the block still fits as many times on an SM as without it)
// and how many row ranges to split into (choose_splits; fold_lazy's ranges
// are whole 128-row tiles).  mode: 0 fold, 1 capped, 2 bcap, 4 fold_lazy
// (tile_tiles 1 for the folds).
int knn_plan(int mode, long long n, int q, int d, int k, int tile_tiles,
             int* splits, int* ws_in_smem) {
  if (mode < MODE_FOLD || mode > MODE_FOLD_LAZY || mode == 3 ||
      tile_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0, sms = 0;
  cudaError_t err = card_limits(&sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the working sets go to shared memory while the block still fits as
  // many times on an SM as without them (twice for fold's SIMT product,
  // once for the tensor-core and the wide ones)
  const size_t ws = static_cast<size_t>(block_queries(mode)) * k * 8;
  const size_t share = mode == MODE_FOLD ? optin / 2 : optin;
  *ws_in_smem = product_smem_bytes(mode, d) + ws + 1024 <= share;
  int per_sm = 0;
  size_t smem = 0;
  err = prepare(mode, d, k, *ws_in_smem, &smem);
  if (err == cudaSuccess) err = occupancy(mode, &per_sm, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *splits = choose_splits(per_sm, sms, n, q,
                          mode == MODE_FOLD_LAZY ? wide::TN / TN : tile_tiles,
                          block_queries(mode));
  return 0;
}

// mode: 0 fold, 1 capped, 2 bcap, 4 fold_lazy.  points (n, d), queries
// (q, d), norms (n,) float32, row-major; for capped and bcap also xplanes
// and qplanes, the points' and the queries' piece planes (split_planes.cu;
// null for the folds); outputs out_d (q, k) float32,
// out_i (q, k) int32 and, for capped and bcap, out_t (q,) float32.
// Scratch part_d (splits, q, k) float32 and part_i (splits, q, k) int32
// (unused when splits == 1 and ws_in_smem), part_m (splits, q) float32
// (capped, bcap) and zeroed counters (ceil(q / QT),) int32, QT =
// block_queries(mode) (knn_constants' tq, or its lazy_tq for fold_lazy,
// or knn_tc_constants' tq for capped and bcap).  1 <= k <=
// MAX_K, q >= 1, n < 2^31; capped: k <= tile_tiles * TN; bcap: k <=
// tile_tiles * TN / BLOCK; the folds: tile_tiles 1; 0 <= passes <=
// MAX_PASSES.  splits and ws_in_smem as knn_plan
// returned them for the same mode, n, q, d, k and tile_tiles.  Returns the
// launch's cudaError_t (0 on success).
int knn_launch(int mode, const float* points, const float* queries,
               const float* norms, const char* xplanes, const char* qplanes,
               float* out_d, int* out_i, float* out_t,
               float* part_d, int* part_i, float* part_m, int* counters,
               long long n, int q, int d, int k, int tile_tiles, int passes,
               int splits, int ws_in_smem, void* stream) {
  const long long cap = mode == MODE_CAPPED ? static_cast<long long>(tile_tiles) * TN
                        : mode == MODE_BCAP ? static_cast<long long>(tile_tiles) * (TN / BLOCK)
                                            : MAX_K;
  if (mode < MODE_FOLD || mode == 3 || mode > MODE_FOLD_LAZY ||
      k < 1 || k > MAX_K || k > cap || tile_tiles < 1 ||
      (folds(mode) && tile_tiles != 1) ||
      passes < 0 || passes > MAX_PASSES || splits < 1 || splits > MAX_SPLITS ||
      (on_tc(mode) && (xplanes == nullptr || qplanes == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = prepare(mode, d, k, ws_in_smem, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const int qt = block_queries(mode);
  const dim3 grid((q + qt - 1) / qt, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_FOLD:
      launch<MODE_FOLD>(vec, grid, smem, s, points, queries, norms, xplanes,
                        qplanes, out_d, out_i, out_t, part_d, part_i, part_m,
                        counters, n, q, d, k, tile_tiles, passes, splits,
                        ws_in_smem);
      break;
    case MODE_CAPPED:
      launch<MODE_CAPPED>(vec, grid, smem, s, points, queries, norms,
                          xplanes, qplanes, out_d, out_i, out_t, part_d,
                          part_i, part_m, counters, n, q, d, k, tile_tiles,
                          passes, splits, ws_in_smem);
      break;
    case MODE_FOLD_LAZY:
      if (vec)
        lazy_kernel<true><<<grid, wide::THREADS, smem, s>>>(
            points, queries, norms, out_d, out_i, part_d, part_i, counters,
            n, q, d, k, splits, ws_in_smem);
      else
        lazy_kernel<false><<<grid, wide::THREADS, smem, s>>>(
            points, queries, norms, out_d, out_i, part_d, part_i, counters,
            n, q, d, k, splits, ws_in_smem);
      break;
    default:
      launch<MODE_BCAP>(vec, grid, smem, s, points, queries, norms, xplanes,
                        qplanes, out_d, out_i, out_t, part_d, part_i, part_m,
                        counters, n, q, d, k, tile_tiles, passes, splits,
                        ws_in_smem);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
