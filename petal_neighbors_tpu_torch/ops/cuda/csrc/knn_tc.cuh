// knn_tc.cuh — the split-bf16 tensor-core tile product of the capped and
// bcap kernels (knn_fold.cu, MODE_CAPPED and MODE_BCAP), the block minima
// (knn_minima.cu, MODE_BLOCK) and the Euclidean merge passes
// (knn_select.cu).
//
// What it computes: for a block's TQ = 128 queries and a tile of TN = 128
// point rows, u = ||x||^2 - 2 q.x.  Two epilogues hand it on:
//   * scan: u itself, written to a shared-memory tile that the selection
//     reads in its own mapping (capped, merge);
//   * scan_minima: only the minimum of u over each 16-row block of the
//     tile, reduced in the mma registers (bcap, the block minima).
// The TPU kernels it stands in for (_knn_kernel_capped, _knn_kernel_merge,
// _knn_kernel_bcap, _bcap_minima_kernel, petal_neighbors_tpu/ops/pallas/
// knn_kernel.py:475-478, :366-369, :613-617, :735-739) call
// jnp.dot(precision=HIGHEST), a six-pass bf16 product on the MXU
// ("highest": 6-pass f32-effective, knn_kernel.py:59-62).  This is the same
// arithmetic on Hopper's tensor cores:
//   * each f32 operand element x is split into three bf16 pieces, each
//     rounded to nearest: hi = bf16(x), mid = bf16(x - hi),
//     lo = bf16(x - hi - mid).  For a normal f32 (exponent >= -110)
//     hi + mid + lo == x exactly: x - hi and x - hi - mid are exact in f32
//     and the last remainder has at most 8 significant bits;
//   * q.x is the sum of the six products hh, hm, mh, hl, lh and mm, each of
//     pieces whose product is exact in f32, accumulated in f32 by
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32; the dropped ml, lm
//     and ll terms are at most 2^-23 |q_i x_i| together.  The route's proof
//     bound for this tier is derived in ops/bruteforce.py (_proof_err).
//   * not 3xTF32: its two pieces hold 22 of f32's 24 bits (about 2^-20
//     relative), above the "highest" bound, at the same effective peak.
//
// Design.  Block = 512 threads, 16 warps in a 4 x 4 grid over a TQ = 128
// query x TN = 128 row output tile; a warp owns 32 queries x 32 rows, 2 x 4
// m16n8 accumulators (32 f32 registers).  Features go DC = 32 at a time:
//   1. each thread loads 8 features of one query row and 8 of one point row
//      of the next chunk from global memory into registers (in flight
//      while this chunk's product runs);
//   2. it splits this chunk's 16 values into the three bf16 piece planes
//      of one of two shared-memory buffers (16-byte stores), so each
//      element is split once per block;
//   3. one barrier; the warps read their fragments with ldmatrix (6 x4
//      loads for A and 6 for B per k-step of 16) and issue the 48 mma of
//      the six products, product-major so that an accumulator's next mma
//      is 8 mma behind its last.
// Plane rows are 40 bf16 (80 bytes) apart, so the eight rows of an
// ldmatrix 8 x 8 matrix fall on distinct banks.  Shared memory of scan: 2 x
// 6 planes of 128 x 40 bf16 (122,880 bytes) and the u tile 128 x 132 f32
// (67,584): 190,464 bytes, one block per SM.
//
// scan_minima keeps no u tile.  A warp's 32 x 32 accumulators cover two
// 16-row blocks for 32 queries; lane (g, t) holds rows 2t and 2t + 1 of
// each n8 piece, so a block minimum is three register minima per query row
// and a transposed reduction over the quad (six shuffles leave each lane
// two of its eight minima).  The minima go to a 128 x 8 f32 array (4 KB).
// The room the u tile leaves holds every chunk's query planes at d <=
// HOIST_D: they are split once per block instead of once per row tile, and
// each chunk stages only the point rows (184,320 bytes of planes at d =
// 128).  Wider rows stream both, as scan does.  Two blocks an SM would
// need at most 64 registers a thread; the fragments alone take 80.
//
// Why this shape: splitting the f32 fragments in registers, in every warp
// that read them (four warps read each element), over 64-query tiles, was
// the first version; on the card its split and its staging, not the mma,
// took most of a product pass (variants with one product instead of six
// were little faster).  Splitting once per block into planes, and reading
// fragments with ldmatrix, is what took capped and merge under their
// library calls (PERF.md, PR 8).
//
// Bit-identical u: every (query, row) pair is accumulated in the same order
// (k-steps ascending, the six products in the order above, one m16n8k16
// accumulator element per pair) whatever the tile, range, epilogue or
// launch, so the same pair gives the same u bits on every pass; the
// merge's radix select depends on it, and bcap's block minima are the
// block-minima kernel's bit for bit.  NaN queries give NaN u; rows past n
// and NaN rows (+inf norms) give +inf u (NaN for a NaN query); a block
// minimum propagates NaN (min.NaN).
//
// -Xptxas -v of the kernels that use it is printed by the build (see
// chip_smoke.py's build phase); PERF.md records registers and spills.

#pragma once

#include <cuda_bf16.h>

#include "knn_tiles.cuh"

namespace {
namespace tc {

constexpr int TQ = 128;       // queries per block
constexpr int TN = 128;       // point rows per product tile
constexpr int DC = 32;        // features per chunk
constexpr int PS = DC + 8;    // bf16 piece-plane row stride (80 bytes)
constexpr int US = TN + 4;    // u tile row stride in floats
constexpr int THREADS = 512;  // 16 warps, 4 x 4 over the TQ x TN tile
constexpr int PIECES = 3;     // bf16 pieces per operand element
constexpr int PRODUCTS = 6;   // piece products summed per element pair
constexpr int PLANE = TN * PS;           // bf16 of one piece plane
constexpr int BLOCK = 16;     // rows per block of scan_minima
constexpr int BS = TN / BLOCK;  // block minima per query per tile
constexpr int HOIST_D = 128;  // widest d whose query planes stay resident
static_assert(TQ == TN, "query and point planes share a shape");

// Whether scan_minima keeps every chunk's query planes for the whole scan.
__host__ __device__ __forceinline__ bool hoists(int d) { return d <= HOIST_D; }

// Floats of the piece planes: two buffers of the point chunk's three, and
// of the query chunk's three, or one set per chunk when hoisted.
__host__ __device__ __forceinline__ int plane_floats(int d, bool hoist) {
  const int qbufs = hoist ? (d + DC - 1) / DC : 2;
  return ((2 + qbufs) * PIECES * PLANE * 2) / 4;
}

// Floats of shared memory scan takes (at any width d): the planes,
// streamed, and the u tile.
__host__ __device__ __forceinline__ int smem_floats(int d) {
  return plane_floats(d, false) + TQ * US;
}

// Floats of shared memory scan_minima takes at width d (hoist as the
// caller runs it): the planes and the TQ x BS block minima.
__host__ __device__ __forceinline__ int minima_smem_floats(int d, bool hoist) {
  return plane_floats(d, hoist) + TQ * BS;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values -> their (hi, mid, lo) bf16 pieces, packed in pairs (the
// first value in the low half, as mma.sync reads a fragment register).
__device__ __forceinline__ void split2(float x, float y, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hb);
  const float rx = __fsub_rn(x, hf.x), ry = __fsub_rn(y, hf.y);
  const __nv_bfloat162 mb = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(mb);
  const __nv_bfloat162 lb =
      __floats2bfloat162_rn(__fsub_rn(rx, mf.x), __fsub_rn(ry, mf.y));
  h = bf2_bits(hb);
  m = bf2_bits(mb);
  l = bf2_bits(lb);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  // not volatile: the compiler may interleave independent accumulators
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l addresses row l % 8
// of matrix l / 8, and register i of lane (g, t) gets matrix i's row g,
// elements 2t and 2t + 1: an mma fragment.
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The product of one chunk (wk features, zero-filled to a multiple of 16)
// from its piece planes (qp: the queries', xp: the points'; piece p at
// + p * PLANE) into the warp's accumulators: warp w owns queries
// 32 (w & 3) .. + 31 and rows 32 (w >> 2) .. + 31 of the tile.
__device__ __forceinline__ void chunk_product(const __nv_bfloat16* qp,
                                              const __nv_bfloat16* xp,
                                              int wk, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = lane >> 3, r8 = lane & 7;
  // A (16 x 16 per mi): matrices (rows 0-7, k 0-7), (8-15, 0-7),
  // (0-7, 8-15), (8-15, 8-15); B (two n8 blocks per load): (n 0-7, k 0-7),
  // (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
  const __nv_bfloat16* qa =
      qp + ((warp & 3) * 32 + (m & 1) * 8 + r8) * PS + (m >> 1) * 8;
  const __nv_bfloat16* xa =
      xp + ((warp >> 2) * 32 + (m >> 1) * 8 + r8) * PS + (m & 1) * 8;
  for (int kk = 0; kk < wk; kk += 16) {
    uint32_t a[PIECES][2][4], b[PIECES][4][2];
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix4(a[p][mi], qa + p * PLANE + mi * 16 * PS + kk);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix4(r, xa + p * PLANE + nj * 16 * PS + kk);
        b[p][2 * nj][0] = r[0];
        b[p][2 * nj][1] = r[1];
        b[p][2 * nj + 1][0] = r[2];
        b[p][2 * nj + 1][1] = r[3];
      }
    }
    // product-major: each product's 8 mma are independent, so an
    // accumulator's next product issues 8 mma after its last one
#define TC_PRODUCT(PA, PB)                                            \
  _Pragma("unroll") for (int mi = 0; mi < 2; ++mi)                    \
  _Pragma("unroll") for (int ni = 0; ni < 4; ++ni)                    \
      mma_bf16(acc[mi][ni], a[PA][mi], b[PB][ni][0], b[PB][ni][1]);
    TC_PRODUCT(0, 0)   // hh
    TC_PRODUCT(0, 1)   // hm
    TC_PRODUCT(1, 0)   // mh
    TC_PRODUCT(0, 2)   // hl
    TC_PRODUCT(2, 0)   // lh
    TC_PRODUCT(1, 1)   // mm
#undef TC_PRODUCT
  }
}

// Thread tid's share of a chunk: 8 features (seg * 8 ..) of row tid / 4.
// Loads them from global memory (zeros past `total` rows and past d).
template <bool VEC>
__device__ __forceinline__ void load8(float (&v)[8], const float* src,
                                      long long total, long long row, int d,
                                      int c0) {
  const int k0 = c0 + (threadIdx.x & 3) * 8;
  const float* p = src + row * d + k0;
  if (VEC && row < total && k0 + 8 <= d) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = (row < total && k0 + i < d) ? __ldg(p + i) : 0.f;
  }
}

// Split the thread's 8 features into the three piece planes at `plane`
// (row tid / 4, columns seg * 8 .. + 7: one 16-byte store a piece).
__device__ __forceinline__ void split_store(const float (&v)[8],
                                            __nv_bfloat16* plane) {
  uint4 h, m, l;
  split2(v[0], v[1], h.x, m.x, l.x);
  split2(v[2], v[3], h.y, m.y, l.y);
  split2(v[4], v[5], h.z, m.z, l.z);
  split2(v[6], v[7], h.w, m.w, l.w);
  __nv_bfloat16* at = plane + (threadIdx.x >> 2) * PS + (threadIdx.x & 3) * 8;
  *reinterpret_cast<uint4*>(at) = h;
  *reinterpret_cast<uint4*>(at + PLANE) = m;
  *reinterpret_cast<uint4*>(at + 2 * PLANE) = l;
}

// Stream the rows [r_begin, r_end) in tiles of TN (the last one short) for
// the block's TQ queries from q0, and after each tile call
//     on_tile(row0, rows, us)
// on every thread of the block, between two __syncthreads: us (stride US)
// holds u of query q0 + r and row row0 + c at us[r * US + c] for c < rows
// (rows <= TN; columns past `rows` belong to no one and are not to be
// read).  Rows past n give +inf u (NaN for a NaN query).
//
// Each chunk: every thread loads its 8 query and 8 point features of the
// next chunk into registers (global loads in flight during this chunk's
// product), splits this chunk's into the piece planes of one of two
// buffers, one barrier, then the warps' mma.  A buffer is refilled two
// chunks after its product began, past a barrier that every warp crossed
// after finishing that product.
template <bool VEC, class OnTile>
__device__ __forceinline__ void scan(const float* __restrict__ points,
                                     const float* __restrict__ queries,
                                     const float* __restrict__ norms,
                                     long long n, int q, int d, int q0,
                                     long long r_begin, long long r_end,
                                     float* smem, OnTile&& on_tile) {
  const int nch = (d + DC - 1) / DC;
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(smem);
  // [2 buffers][queries, points][PIECES][TN][PS]
  float* us = smem + (2 * 2 * PIECES * PLANE * 2) / 4;   // [TQ][US]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long ntiles = r_end > r_begin ? (r_end - r_begin + TN - 1) / TN
                                           : 0;
  const long long nst = ntiles * nch;

  float xv[8], qv[8];
  auto load = [&](long long s) {
    const long long row0 = r_begin + (s / nch) * TN;
    const int c0 = static_cast<int>(s % nch) * DC;
    load8<VEC>(xv, points, n, row0 + (tid >> 2), d, c0);
    load8<VEC>(qv, queries, q, q0 + (tid >> 2), d, c0);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (nst > 0) load(0);
  for (long long s = 0; s < nst; ++s) {
    __nv_bfloat16* qp = planes + (s & 1) * 2 * PIECES * PLANE;
    __nv_bfloat16* xp = qp + PIECES * PLANE;
    split_store(qv, qp);
    split_store(xv, xp);
    if (s + 1 < nst) load(s + 1);
    __syncthreads();

    const int c = static_cast<int>(s % nch);
    const int wk = (min(DC, d - c * DC) + 15) & ~15;
    chunk_product(qp, xp, wk, acc);

    if (c == nch - 1) {
      // epilogue: u = ||x||^2 - 2 acc into the u tile; c0..c3 of an m16n8
      // accumulator are (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
      // The previous tile's on_tile is over: every thread has crossed this
      // chunk's barrier since.
      const long long row0 = r_begin + (s / nch) * TN;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = (warp >> 2) * 32 + ni * 8 + 2 * t4;
        const long long rx = row0 + col;
        const float x0 = rx < n ? __ldg(norms + rx) : INFINITY;
        const float x1 = rx + 1 < n ? __ldg(norms + rx + 1) : INFINITY;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = (warp & 3) * 32 + mi * 16 + g;
          float* a = acc[mi][ni];
          *reinterpret_cast<float2*>(us + r * US + col) =
              make_float2(x0 - 2.f * a[0], x1 - 2.f * a[1]);
          *reinterpret_cast<float2*>(us + (r + 8) * US + col) =
              make_float2(x0 - 2.f * a[2], x1 - 2.f * a[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = 0.f;
        }
      }
      __syncthreads();
      const long long left = r_end - row0;
      on_tile(row0, left < TN ? static_cast<int>(left) : TN,
              static_cast<const float*>(us));
    }
  }
  __syncthreads();   // the caller may reuse shared memory
}

// As scan, but after each tile
//     on_tile(row0, rows, bm)
// gets only the block minima: bm[r * BS + b] is the minimum of u of query
// q0 + r over rows row0 + 16 b .. + 15 (NaN for a NaN query; +inf where
// every row is past n or has a +inf norm).  Blocks at or past `rows`
// belong to no one.  smem: minima_smem_floats(d, hoist) floats.
//
// The loop is scan's (the same chunks, loads, split and chunk_product, so
// the same u bits), with two differences: hoist (only where hoists(d))
// splits every chunk's query planes once, before the loop, and the chunks
// then stage only the point rows; and the epilogue below.  Planes:
// [query chunks, or 2 buffers][PIECES][TN][PS], then [2 point
// buffers][PIECES][TN][PS].  scan keeps its own loop: one loop shared by
// both, with the hoist as a branch, made capped 1.7% slower on an H100.
template <bool VEC, class OnTile>
__device__ __forceinline__ void scan_minima(const float* __restrict__ points,
                                            const float* __restrict__ queries,
                                            const float* __restrict__ norms,
                                            long long n, int q, int d, int q0,
                                            long long r_begin,
                                            long long r_end, bool hoist,
                                            float* smem, OnTile&& on_tile) {
  const int nch = (d + DC - 1) / DC;
  __nv_bfloat16* qplanes = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xplanes = qplanes + (hoist ? nch : 2) * PIECES * PLANE;
  float* bm = smem + plane_floats(d, hoist);   // [TQ][BS]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long ntiles = r_end > r_begin ? (r_end - r_begin + TN - 1) / TN
                                           : 0;
  const long long nst = ntiles * nch;

  float xv[8], qv[8];
  if (hoist) {
    for (int c = 0; c < nch; ++c) {
      load8<VEC>(qv, queries, q, q0 + (tid >> 2), d, c * DC);
      split_store(qv, qplanes + c * PIECES * PLANE);
    }
  }
  auto load = [&](long long s) {
    const long long row0 = r_begin + (s / nch) * TN;
    const int c0 = static_cast<int>(s % nch) * DC;
    load8<VEC>(xv, points, n, row0 + (tid >> 2), d, c0);
    if (!hoist) load8<VEC>(qv, queries, q, q0 + (tid >> 2), d, c0);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (nst > 0) load(0);
  for (long long s = 0; s < nst; ++s) {
    const int c = static_cast<int>(s % nch);
    __nv_bfloat16* qp = qplanes + (hoist ? c : (s & 1)) * PIECES * PLANE;
    __nv_bfloat16* xp = xplanes + (s & 1) * PIECES * PLANE;
    if (!hoist) split_store(qv, qp);
    split_store(xv, xp);
    if (s + 1 < nst) load(s + 1);
    __syncthreads();

    const int wk = (min(DC, d - c * DC) + 15) & ~15;
    chunk_product(qp, xp, wk, acc);
    if (c != nch - 1) continue;

    const long long row0 = r_begin + (s / nch) * TN;
    // u as scan makes it (the same expression, so the same bits); the
    // warp's columns 0-15 are block 0 (n8 pieces 0, 1), 16-31 block 1.
    float xn[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const long long rx = row0 + (warp >> 2) * 32 + ni * 8 + 2 * t4;
      xn[ni][0] = rx < n ? __ldg(norms + rx) : INFINITY;
      xn[ni][1] = rx + 1 < n ? __ldg(norms + rx + 1) : INFINITY;
    }
    // v[4 mi + 2 h + b]: the lane's least u of query row mi * 16 + h * 8 + g
    // (of the warp's 32) over block b
    float v[8];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float* a0 = acc[mi][2 * b];
          const float* a1 = acc[mi][2 * b + 1];
          const float u00 = xn[2 * b][0] - 2.f * a0[2 * h];
          const float u01 = xn[2 * b][1] - 2.f * a0[2 * h + 1];
          const float u10 = xn[2 * b + 1][0] - 2.f * a1[2 * h];
          const float u11 = xn[2 * b + 1][1] - 2.f * a1[2 * h + 1];
          v[4 * mi + 2 * h + b] = min_nan(min_nan(u00, u01),
                                          min_nan(u10, u11));
        }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    // transposed minimum over the quad: lanes t and t ^ 1 split by mi,
    // then t and t ^ 2 by h; lane t ends with mi = t & 1, h = t >> 1
    {
      const bool up = t4 & 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float send = up ? v[j] : v[4 + j];
        const float keep = up ? v[4 + j] : v[j];
        v[j] = min_nan(keep, __shfl_xor_sync(FULL, send, 1));
      }
    }
    {
      const bool up = t4 & 2;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float send = up ? v[b] : v[2 + b];
        const float keep = up ? v[2 + b] : v[b];
        v[b] = min_nan(keep, __shfl_xor_sync(FULL, send, 2));
      }
    }
    // the previous tile's on_tile is over (as in scan)
    const int r = (warp & 3) * 32 + (t4 & 1) * 16 + (t4 >> 1) * 8 + g;
    *reinterpret_cast<float2*>(bm + r * BS + (warp >> 2) * 2) =
        make_float2(v[0], v[1]);
    __syncthreads();
    const long long left = r_end - row0;
    on_tile(row0, left < TN ? static_cast<int>(left) : TN,
            static_cast<const float*>(bm));
  }
  __syncthreads();   // the caller may reuse shared memory
}

// Shared memory of one block of scan, and of scan_minima, at width d.
size_t smem_bytes(int d) {
  return sizeof(float) * static_cast<size_t>(smem_floats(d));
}
size_t minima_smem_bytes(int d, bool hoist) {
  return sizeof(float) * static_cast<size_t>(minima_smem_floats(d, hoist));
}

}  // namespace tc
}  // namespace
