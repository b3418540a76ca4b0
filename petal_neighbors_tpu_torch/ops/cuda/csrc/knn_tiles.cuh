// knn_tiles.cuh — the FP32 SIMT tile product that knn_fold.cu (fold,
// fold_lazy, bcap), knn_minima.cu and lp_knn.cu (the Lp / Chebyshev kernel)
// share, the merge selection of lp_knn.cu, and the helpers of the
// tensor-core kernels (knn_tc.cuh).
//
// scan_tiles streams a block's TQ = 64 queries against tiles of TN = 64
// point rows through shared memory and hands every thread a 4 x 4 register
// tile of per-pair sums over all d features.  What a pair contributes per
// feature, and how a finished sum and the row's staged value (the norm, or
// the additive +inf mask) become a score, is the `Score` operation:
//   DotScore (knn_fold.cu): acc += q*x, score u = ||x||^2 - 2 acc;
//   the Lp operations (lp_knn.cu): acc += |q - x|^p (or max), score =
//   acc + mask.
// knn_merge_kernel keeps each query's exact k smallest scores, sorted, for
// k up to 4096, over any Score (lp_knn.cu runs it; the Euclidean merge is
// knn_select.cu's radix select).  See knn_fold.cu for the design of
// scan_tiles; the merge's is noted at knn_merge_kernel below.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;        // queries per block
constexpr int TN = 64;        // point rows per tile
constexpr int DC = 128;       // features staged per chunk
constexpr int DS = DC + 4;    // shared-memory row stride in floats
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_SPLITS = 64;  // a batch of one query tile spreads over SMs
constexpr int MIN_TILES_PER_SPLIT = 64;
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

// The u-domain score of the Euclidean kernels: acc is q.x, xn = ||x||^2
// (+inf on NaN and padding rows); ||q||^2 is added back at the output.
struct DotScore {
  static constexpr bool kAddQueryNorm = true;
  __device__ __forceinline__ float step(float a, float q, float x) const {
    return fmaf(q, x, a);
  }
  __device__ __forceinline__ float finish(float acc, float xn) const {
    return xn - 2.f * acc;
  }
};

// Stage rows [row0, row0 + rows) x features [c0, c0 + w) of a row-major
// (total, d) matrix into dst (stride STRIDE), zero-filling rows past
// `total` and the columns [w, wpad).
template <bool VEC, int STRIDE = DS>
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
      cp_async16(dst + r * STRIDE + c, ok ? src + g * d + c0 + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * wpad; idx += THREADS) {
      const int r = idx / wpad;
      const int c = idx - r * wpad;
      const long long g = row0 + r;
      const bool ok = g < total && c < w;
      cp_async4(dst + r * STRIDE + c, ok ? src + g * d + c0 + c : src,
                ok ? 4 : 0);
    }
  }
}

// Floats of shared memory the tile staging takes at width d: two point
// tiles, one or two query tiles, two norm rows.
__host__ __device__ __forceinline__ int tile_floats(int d) {
  const int nch = (d + DC - 1) / DC;
  return 2 * TN * DS + (nch > 1 ? 2 : 1) * TQ * DS + 2 * TN;
}

// The shared FP32 SIMT tile product of every kernel: stream the tiles
// [t_begin, t_end) of TN rows (and the block's TQ queries from q0) through
// shared memory at `smem`, in chunks of DC features, double-buffered with
// cp.async, and after each tile's last chunk call
//     on_tile(t, xnb, acc)
// on every thread of the block, between two __syncthreads: acc[j][i] is the
// Score's sum (score.step over all d features, from 0) of query
// q0 + rbase + j and row t*TN + xg + 16 i, and xnb the tile's TN staged row
// values (`norms`: norms or mask; +inf past n).  acc is zeroed afterwards.
// Zero-filled features (past d, or past a ragged chunk) add step(a, 0, 0),
// which every Score keeps at a.
template <bool VEC, class Score, class OnTile>
__device__ __forceinline__ void scan_tiles(
    const float* __restrict__ points, const float* __restrict__ queries,
    const float* __restrict__ norms, long long n, int q, int d, int q0,
    long long t_begin, long long t_end, float* smem, const Score& score,
    OnTile&& on_tile) {
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
          a = score.step(a, qv[j].x, xv[i].x);
          a = score.step(a, qv[j].y, xv[i].y);
          a = score.step(a, qv[j].z, xv[i].z);
          a = score.step(a, qv[j].w, xv[i].w);
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

// ---- the wide FP32 product (fold_lazy) ----------------------------------
//
// wide::scan is scan_tiles' product on a larger tile: a block's TQ = 128
// queries against tiles of TN = 128 point rows, 256 threads, each with an
// 8 x 8 register tile of sums (queries rbase .. rbase + 7, rbase = 16 warp
// + 8 half-warp; rows xg, xg + 16, .., xg + 112 of the tile, xg the lane in
// its half-warp), so a half-warp holds all 128 scores of its 8 queries.
// Per 4 features a thread reads 8 row and 8 query float4 from shared
// memory for 256 FFMA (scan_tiles: 8 for 64).  The rows stream through a
// ring of STAGES = 3 chunks of DC = 64 features (cp.async; one barrier a
// chunk, the next-but-one chunk's copies in flight during this chunk's
// product); the query chunks stay resident at d <= HOIST_D and ride the
// ring beside the rows above it.  Rows are padded to DC + 4 floats, so the
// float4 reads of 8 neighbouring rows hit distinct banks.  One block an SM
// (its shared memory and registers), 8 warps.
//
// Bits: every (query, row) pair is summed as scan_tiles sums it, one
// fmaf(q_f, x_f, acc) a feature in ascending order from 0, zero-filled
// features only past d (a ragged last chunk pads to a multiple of 4, as
// there), never split or reordered, so DotScore's u is scan_tiles' bit for
// bit at every d, tile, range and launch.
namespace wide {

constexpr int TQ = 128;       // queries per block
constexpr int TN = 128;       // point rows per tile
constexpr int DC = 64;        // features per chunk
constexpr int DS = DC + 4;    // shared-memory row stride in floats
constexpr int STAGES = 3;     // chunks in the cp.async ring
constexpr int THREADS = 256;  // 8 warps; a half-warp owns 8 queries
constexpr int R = 8;          // queries and rows of a thread's tile
constexpr int HOIST_D = 128;  // widest d whose query chunks stay resident
static_assert(TQ == 16 * THREADS / 32 && TN == 16 * R, "tile mapping");
static_assert(STAGES == 3, "the loop waits for all but the newest copies");
static_assert(THREADS == ::THREADS, "stage_rows spreads over ::THREADS");

__host__ __device__ __forceinline__ bool hoists(int d) { return d <= HOIST_D; }

// Copy rows [row0, row0 + rows) x features [c0, c0 + w) of a row-major
// (total, d) matrix into dst (stride DS), rows past `total` zero-filled.
// A full chunk (VEC, w == DC) gives each thread one column of 4 features
// and every 16th row from tid / 16, with no division and one address step
// a copy; other chunks (the ragged last one, d % 4 != 0) take stage_rows.
template <bool VEC>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long total, long long row0,
                                      int rows, int d, int c0, int w) {
  if (VEC && w == DC) {
    constexpr int PER_ROW = DC / 4, STEP = THREADS / PER_ROW;
    const int tid = threadIdx.x;
    const int col = (tid % PER_ROW) * 4;
    long long g = row0 + tid / PER_ROW;
    const float* from = src + g * d + c0 + col;
    float* to = dst + (tid / PER_ROW) * DS + col;
    for (int r = tid / PER_ROW; r < rows; r += STEP) {
      const bool ok = g < total;
      cp_async16(to, ok ? from : src, ok ? 16 : 0);
      g += STEP;
      from += static_cast<long long>(STEP) * d;
      to += STEP * DS;
    }
  } else {
    stage_rows<VEC, DS>(dst, src, total, row0, rows, d, c0, w,
                        (w + 3) & ~3);
  }
}

// Floats of shared memory wide::scan takes at width d: the query chunks
// (all of them, or a ring), the row ring and its norm rows.
__host__ __device__ __forceinline__ int smem_floats(int d) {
  const int qchunks = hoists(d) ? (d + DC - 1) / DC : STAGES;
  return (qchunks * TQ + STAGES * TN) * DS + STAGES * TN;
}

// Stream the tiles [t_begin, t_end) of TN rows (and the block's TQ queries
// from q0) and after each tile's last chunk call
//     on_tile(t, xnb, acc)
// on every thread of the block: acc[j][i] is DotScore's sum of query
// q0 + rbase + j and row t*TN + xg + 16 i, and xnb the tile's TN norms
// (+inf past n).  acc is zeroed afterwards.  on_tile runs without a
// barrier around it: it may read only xnb, its registers and memory of
// its own (the warps meet again at the next chunk's barrier, and a ring
// slot is refilled only past that barrier).
template <bool VEC, class OnTile>
__device__ __forceinline__ void scan(const float* __restrict__ points,
                                     const float* __restrict__ queries,
                                     const float* __restrict__ norms,
                                     long long n, int q, int d, int q0,
                                     long long t_begin, long long t_end,
                                     float* smem, OnTile&& on_tile) {
  const int nch = (d + DC - 1) / DC;
  const bool hoist = hoists(d);
  float* qs = smem;                                        // [..][TQ][DS]
  float* xs = qs + (hoist ? nch : STAGES) * TQ * DS;       // [STAGES][TN][DS]
  float* xn = xs + STAGES * TN * DS;                       // [STAGES][TN]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int xg = lane & 15;
  const int rbase = (tid >> 5) * 16 + (lane >> 4) * R;
  const long long nst = (t_end - t_begin) * nch;

  auto width = [&](int c) { return min(DC, d - c * DC); };
  // the copies' position in the stream of chunks: tile, chunk, ring slot
  long long it = t_begin;
  int ic = 0, islot = 0;
  auto issue = [&]() {
    const int w = width(ic);
    stage<VEC>(xs + islot * TN * DS, points, n, it * TN, TN, d, ic * DC, w);
    if (!hoist)
      stage<VEC>(qs + islot * TQ * DS, queries, q, q0, TQ, d, ic * DC, w);
    if (ic == nch - 1) {
      float* dst = xn + islot * TN;
      for (int i = tid; i < TN; i += THREADS) {
        const long long g = it * TN + i;
        if (g < n)
          cp_async4(dst + i, norms + g, 4);
        else
          dst[i] = INFINITY;
      }
    }
    islot = islot + 1 == STAGES ? 0 : islot + 1;
    if (++ic == nch) {
      ic = 0;
      ++it;
    }
  };

  float acc[R][R];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[j][i] = 0.f;

  // the resident query chunks ride in the first group
  if (hoist && nst > 0)
    for (int c = 0; c < nch; ++c) {
      const int w = width(c);
      stage<VEC>(qs + c * TQ * DS, queries, q, q0, TQ, d, c * DC, w);
    }
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nst) issue();
    cp_async_commit();
  }
  long long t = t_begin;
  int c = 0, slot = 0;
  for (long long s = 0; s < nst; ++s) {
    // chunk s has landed (only chunk s + 1 may still be in flight), and
    // every thread is past chunk s - 1, whose slot is refilled below
    cp_async_wait_one();
    __syncthreads();
    if (s + STAGES - 1 < nst) issue();
    cp_async_commit();

    const int wpad = (width(c) + 3) & ~3;
    const float* xb = xs + slot * TN * DS + xg * DS;
    const float* qb = qs + (hoist ? c : slot) * TQ * DS + rbase * DS;
    // not unrolled: unrolled by 2 it ran slower on an H100
#pragma unroll 1
    for (int kk = 0; kk < wpad; kk += 4) {
      float4 xv[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xb + 16 * i * DS + kk);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qb + j * DS + kk);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float a = acc[j][i];
          a = fmaf(qv.x, xv[i].x, a);
          a = fmaf(qv.y, xv[i].y, a);
          a = fmaf(qv.z, xv[i].z, a);
          a = fmaf(qv.w, xv[i].w, a);
          acc[j][i] = a;
        }
      }
    }

    if (c == nch - 1) {
      on_tile(t, static_cast<const float*>(xn + slot * TN), acc);
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[j][i] = 0.f;
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    if (++c == nch) {
      c = 0;
      ++t;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();   // the caller may reuse shared memory
}

size_t smem_bytes(int d) {
  return sizeof(float) * static_cast<size_t>(smem_floats(d));
}

}  // namespace wide

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

// Design (k up to 4096; fold re-scans its k slots for every entrant, O(k)
// per survivor): each query's working set is kept SORTED in global
// scratch, two slots of k that take turns, with its k-th value tau in a
// register (+inf until k entries are in).  A tile's scores below tau go to
// the query's MERGE_W = 128 slots in shared memory (ballot + popc, no
// atomics).  When a tile's survivors would not fit in some buffer, every
// buffer of the block at least half full is flushed in that tile, so the
// warps' merges overlap instead of each stalling the block at the tile
// barrier in turn: the half-warp sorts the buffer (bitonic, 16 lanes) and
// merges it with the set into the other slot (merge_into: the set streams
// through once, coalesced, 8 loads per lane per step with the next step's
// issued ahead; each buffer entry is ranked in the window it falls in by a
// half-warp count, and each set entry goes to its index plus the count of
// buffer entries ranked at or below it).  About k (1 + ln(N / (S k)))
// survivors per query and range.  Row ranges as knn_fold.cu's; the last
// block merges the ranges' sorted sets on the merge path (merge_path).
// Ties: (score, id) order throughout.  The merges add global-memory
// traffic of about 16 k bytes per flush.
//
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
// give way to another of the same u).  Output: the sorted set, with
// Score::kAddQueryNorm rd = max(u + ||q||^2, 0) and otherwise the score
// itself, and (+inf, -1) past fill.
template <bool VEC, class Score>
__global__ void __launch_bounds__(THREADS)
knn_merge_kernel(const float* __restrict__ points,
                 const float* __restrict__ queries,
                 const float* __restrict__ norms, float* __restrict__ out_d,
                 int* __restrict__ out_i, float* __restrict__ part_d,
                 int* __restrict__ part_i, int* __restrict__ part_f,
                 unsigned* __restrict__ bound, int* __restrict__ counters,
                 long long n, int q, int d, int k, int splits, Score score) {
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
                  score,
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
        const float u = score.finish(acc[j][i], xnb[xg + 16 * i]);
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

  // ---- output: the sorted set; past fill (+inf, -1) --------------------
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int gq = q0 + r;
    if (gq >= q) break;
    float qn = 0.f;
    if constexpr (Score::kAddQueryNorm) {
      const float* qrow = queries + static_cast<long long>(gq) * d;
      for (int f = lane; f < d; f += 32) qn = fmaf(qrow[f], qrow[f], qn);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        qn += __shfl_xor_sync(FULL, qn, off);
    }
    const int nf = fin[r] >> 1;
    const float* sd = set_d(split, r, fin[r] & 1);
    const int* si = set_i(split, r, fin[r] & 1);
    float* od = out_d + static_cast<long long>(gq) * k;
    int* oi = out_i + static_cast<long long>(gq) * k;
    for (int e = lane; e < k; e += 32) {
      if (e < nf) {
        if constexpr (Score::kAddQueryNorm) {
          const float rd = sd[e] + qn;
          od[e] = rd < 0.f ? 0.f : rd;
        } else {
          od[e] = sd[e];
        }
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

// Shared memory of one merge block: the tile staging and the survivor
// buffers.
size_t merge_smem_bytes(int d) {
  return tile_smem_bytes(d) + static_cast<size_t>(TQ) * MERGE_W * 8;
}

template <class Score>
cudaError_t set_merge_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_merge_kernel<true, Score>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(knn_merge_kernel<false, Score>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The card's SM count and the largest shared memory a block may opt in to.
cudaError_t card_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Row ranges for a launch of ceil(q / tq) query tiles with per_sm resident
// blocks per SM: the split minimizes the waves of blocks over the card's
// resident-block slots per unit of work (within 5% of the best, fewest
// splits), keeping each range at least MIN_TILES_PER_SPLIT tiles of rows
// and a whole number of tile_tiles, and at most `cap` ranges.
int choose_splits(int per_sm, int sms, long long n, int q, int tile_tiles,
                  int tq = TQ, int cap = MAX_SPLITS) {
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long qtiles = (q + tq - 1) / tq;
  const long long ntiles = (n + TN - 1) / TN;
  const long long units = (ntiles + tile_tiles - 1) / tile_tiles;
  const long long min_units =
      (MIN_TILES_PER_SPLIT + tile_tiles - 1) / tile_tiles;
  long long max_splits = units / min_units;
  max_splits = max_splits < 1 ? 1 : (max_splits > cap ? cap : max_splits);
  auto cost = [&](long long s) {
    return static_cast<double>((qtiles * s + slots - 1) / slots) / s;
  };
  double best = 1e30;
  for (long long s = 1; s <= max_splits; ++s)
    if (cost(s) < best) best = cost(s);
  for (long long s = 1; s <= max_splits; ++s)
    if (cost(s) <= 1.05 * best) return static_cast<int>(s);
  return 1;
}

// The merge kernel over `score`: the launch of knn_merge_launch and
// lp_launch.  Returns the launch's cudaError_t.
template <class Score>
cudaError_t merge_launch(const Score& score, const float* points,
                         const float* queries, const float* norms,
                         float* out_d, int* out_i, float* part_d,
                         int* part_i, int* part_f, unsigned* bound,
                         int* counters, long long n, int q, int d, int k,
                         int splits, void* stream) {
  if (k < 1 || k > MERGE_MAX_K || q < 1 || splits < 1 || splits > MAX_SPLITS)
    return cudaErrorInvalidValue;
  const size_t smem = merge_smem_bytes(d);
  cudaError_t err = set_merge_smem<Score>(smem);
  if (err != cudaSuccess) return err;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const dim3 grid((q + TQ - 1) / TQ, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    knn_merge_kernel<true, Score><<<grid, THREADS, smem, s>>>(
        points, queries, norms, out_d, out_i, part_d, part_i, part_f, bound,
        counters, n, q, d, k, splits, score);
  else
    knn_merge_kernel<false, Score><<<grid, THREADS, smem, s>>>(
        points, queries, norms, out_d, out_i, part_d, part_i, part_f, bound,
        counters, n, q, d, k, splits, score);
  return cudaGetLastError();
}

// The resident merge blocks per SM over `score` at width d.
template <class Score>
cudaError_t merge_occupancy(int d, int* per_sm) {
  const size_t smem = merge_smem_bytes(d);
  cudaError_t err = set_merge_smem<Score>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, knn_merge_kernel<true, Score>, THREADS, smem);
}

}  // namespace
