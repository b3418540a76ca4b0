// knn_tc.cuh — the split-bf16 tensor-core tile product of the capped and
// bcap kernels (knn_fold.cu, MODE_CAPPED and MODE_BCAP), the block and
// subchunk minima (knn_minima.cu) and the Euclidean merge passes
// (knn_select.cu), one core with two epilogues.
//
// What it computes: for a block's TQ = 128 queries and a tile of TN = 128
// point rows, u = ||x||^2 - 2 q.x.  Two epilogues hand it on:
//   * scan: u itself, written to a shared-memory tile that the selection
//     reads in its own mapping (capped, merge, the probe);
//   * scan_minima: only the minimum of u over each 16-row block of the
//     tile, reduced in the accumulator registers (bcap, the block and
//     subchunk minima).
// The TPU kernels it stands in for (_knn_kernel_capped, _knn_kernel_merge,
// _knn_kernel_bcap, _bcap_minima_kernel, _minima_kernel,
// petal_neighbors_tpu/ops/pallas/knn_kernel.py:475-478, :366-369,
// :613-617, :735-739, :824-827) call jnp.dot(precision=HIGHEST), a six-pass
// bf16 product on the MXU ("highest": 6-pass f32-effective,
// knn_kernel.py:59-62).  This is the same arithmetic on Hopper's tensor
// cores:
//   * each f32 operand element x is split into three bf16 pieces, each
//     rounded to nearest: hi = bf16(x), mid = bf16(x - hi),
//     lo = bf16(x - hi - mid).  For a normal f32 (exponent >= -110)
//     hi + mid + lo == x exactly: x - hi and x - hi - mid are exact in f32
//     and the last remainder has at most 8 significant bits;
//   * q.x is the sum of the six products hh, hm, mh, hl, lh and mm, each of
//     pieces whose product is exact in f32, accumulated in f32 16 features
//     at a time (one wgmma.m64n64k16 a product, k-step and warpgroup); the
//     dropped ml, lm and ll terms are at most 2^-23 |q_i x_i| together.  The
//     route's proof bound for this tier is derived in knn_kernel.py
//     (tc_proof_err) and held on the card by knn_kernel.tc_probe;
//   * not 3xTF32: its two pieces hold 22 of f32's 24 bits (about 2^-20
//     relative), above the "highest" bound, at the same effective peak.
//
// What bounds it: the tensor cores, 6 x 2 x 128 x 128 x 16 FLOP a tile and
// k-step at the card's 989 TFLOP/s bf16 (0.194 ps a (query, row) pair and
// 16-feature step).  The wgmma alone reaches it: the loop of six products
// a k-step on planes in shared memory, with nothing else, ran at 980
// TFLOP/s on an H100 (four warpgroups of m64n64k16).  Around it, shared
// memory is the scarce resource: a k-step of a tile reads 96 KB of piece
// planes (four warpgroups, six 2 KB query and six 2 KB point operands
// each), 125 bytes a clock at the tensor-core rate against the SM's 128,
// and every split, mbarrier and u-tile access competes with those reads.
//
// The pipeline.  Block = 512 threads, four warpgroups.  Features go DC = 32
// at a time (a "chunk"); every thread takes part in every stage:
//   1. staging: each thread loads its 8 point features (and 8 query
//      features where the query planes are not resident) of chunk s + 1
//      from global memory into registers while chunk s is split and
//      issued: the loads are in flight a whole chunk and take no shared
//      memory;
//   2. split: each thread turns its 8 features of one row of chunk s into
//      the three bf16 piece planes of one of BUFS = 3 plane buffers,
//      written in wgmma's canonical K-major 64-byte-swizzled layout (8-row
//      groups of 512 bytes, 16-byte chunk j of row r at j ^ ((r >> 1) &
//      3)), so that the tensor cores read them straight from shared
//      memory; the query planes are split once per block where they fit
//      (scan: d <= 96, scan_minima: d <= 128) and with each chunk
//      otherwise;
//   3. product: each warpgroup issues its 64 x 64 quarter of the tile
//      (wgmma.mma_async.m64n64k16, both operands by descriptor, 32 f32
//      accumulators a thread) and goes on at once; the hand-offs are
//      mbarriers, "full" (all 16 warps split the buffer) and "empty" (all
//      16 warps' wgmma on it completed), no block-wide barrier a chunk.
//      Up to two chunks wait on the tensor cores behind the one they run
//      while the threads split the next;
//   4. epilogue: at the next tile's first chunk the warpgroups write u (or
//      the block minima) from their accumulators and issue that chunk,
//      and the caller's selection runs once the next tile's first three
//      chunks (all it has, if fewer) are on the tensor cores.  The tensor
//      cores wait only while the accumulators are written out.
// Shared memory: the query planes (3 x 24 KB streamed, or 24 KB a chunk
// resident), 3 point plane buffers (72 KB), the u tile 128 x 132 f32 (66
// KB) or the 128 x 8 minima, 1 KB for alignment: scan 216,064 bytes above
// d = 96 (one block an SM; capped's working set then lives in global
// memory), scan_minima 177,152 at d <= 128.  The u tile is not
// double-buffered: a second one would not fit beside the planes.
//
// Why this shape.  The first version split the f32 fragments in registers,
// in every warp that read them, over 64-query tiles; on the card its split
// and its staging, not the mma, took most of a product pass.  The next one
// split once per block into padded planes and read fragments with
// ldmatrix for mma.sync.m16n8k16 (Ampere's synchronous instruction) on 16
// warps, each chunk loaded, split, barriered and multiplied in series, and
// the tile's epilogue and selection run with no mma in flight: 31% of its
// tier (PERF.md §5).  A wgmma variant of it, tried then, swapped the
// instruction inside that same barrier-per-chunk loop and ran slower.
// This one keeps the arithmetic and changes the pipeline around it:
// asynchronous wgmma from swizzled planes that the split writes directly,
// mbarrier hand-offs, three buffers, and the selection run while the next
// tile's product is on the tensor cores.  Measured on an H100 (the block
// minima at 10,240 queries over 1M x 128, PERF.md §6), staging the point
// rows in shared memory cost more than it saved: a ring of TMA boxes
// (cp.async.bulk.tensor, two 16 KB stages) took 43.3 ms and one
// cp.async.bulk a row 61.3 ms, against 37.6 ms with the rows loaded into
// registers a chunk ahead, since a staged chunk adds 32 KB of shared-memory
// traffic to the 192 KB its product reads.  Each warpgroup takes 64 x 64
// (32 accumulators) rather than 64 x 128: with 64 accumulators live beside
// the selection's state, capped and bcap spilled 470-720 bytes a thread.
// The loop counts its chunk's tile and offset rather than dividing the
// chunk index (a 64-bit division is some 70 instructions), and brings each
// thread's point features two chunks ahead into L2 (prefetch.global.L2):
// GIST's capped 40.2 -> 30.3 ms, SIFT's bcap within 1%.
//
// Measured (H100 80GB HBM3, 700 W, PERF.md §6): against the six-product
// tier, the block minima at 10,240 queries over 1M x 128 take 38.2 ms
// (15.90 ms bound, 42%), bcap at k_scan 18 44.1 ms (36%), capped over GIST
// (1,000 queries, 1M x 960) 30.4 ms (11.65 ms bound, 38%); the mma.sync
// loop before this one took 49.4, 52.7 and 39.9 ms (32%, 30%, 29%).  What
// is left: the threads' share of a chunk (split, hand-offs, the drain of
// the one accumulator set at each tile's end) still outlasts its product,
// so the tensor cores run about 40% of the time; and ptxas serializes the
// wgmma of knn_select.cu's pass kernels (its note C7518, a dependence in a
// divergent path of the merge's selection), which run at 96% of their
// mma.sync times.
//
// Bit-identical u: every (query, row) pair is accumulated in the same order
// (k-steps ascending, the six products in the order above, one accumulator
// element per pair, the same instruction) whatever the tile, range,
// epilogue, warpgroup or launch, so the same pair gives the same u
// bits on every pass; the merge's radix select depends on it, and bcap's
// block minima are the block-minima kernel's bit for bit.  NaN queries
// give NaN u; rows past n and NaN rows (+inf norms) give +inf u (NaN for a
// NaN query); a block minimum propagates NaN (min.NaN).
//
// -Xptxas -v of the kernels that use it is printed by the build (see
// chip_smoke.py's build phase); PERF.md records registers and spills.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "knn_tiles.cuh"

namespace {
namespace tc {

constexpr int TQ = 128;       // queries per block
constexpr int TN = 128;       // point rows per product tile
constexpr int DC = 32;        // features per chunk
constexpr int US = TN + 4;    // u tile row stride in floats
constexpr int THREADS = 512;  // four warpgroups
constexpr int PIECES = 3;     // bf16 pieces per operand element
constexpr int PRODUCTS = 6;   // piece products summed per element pair
constexpr int BLOCK = 16;     // rows per block of scan_minima
constexpr int BS = TN / BLOCK;  // block minima per query per tile
constexpr int HOIST_D = 128;  // widest d whose query planes scan_minima keeps
constexpr int WG_M = 64;      // query rows of one warpgroup's wgmma
constexpr int WG_N = 64;      // point rows of one wgmma
constexpr int BUFS = 3;       // plane buffers of a streamed operand
constexpr int ROW_B = DC * 2;             // bytes of a plane row: 64
constexpr int GROUP_B = 8 * ROW_B;        // an 8-row swizzle group: 512
constexpr int PLANE_B = TN * ROW_B;       // one piece plane: 8,192
constexpr int CHUNK_B = PIECES * PLANE_B; // one operand's chunk: 24,576
constexpr int ALIGN_B = 1024;             // swizzle groups start aligned
static_assert(TQ == TN, "query and point planes share a shape");
static_assert(THREADS * 8 == TN * DC, "a thread splits 8 features of a row");
static_assert(THREADS == 4 * 128 && TQ == 2 * WG_M && TN == 2 * WG_N,
              "four warpgroups, each a 64 x 64 quarter of the tile");

__host__ __device__ __forceinline__ int chunks(int d) {
  return (d + DC - 1) / DC;
}

// Whether scan_minima keeps every chunk's query planes for the whole scan.
__host__ __device__ __forceinline__ bool hoists(int d) { return d <= HOIST_D; }

// Whether scan keeps them: where they take no more room than its BUFS
// streamed buffers (d <= 96; the u tile leaves no room for more).
__host__ __device__ __forceinline__ bool scan_hoists(int d) {
  return chunks(d) <= BUFS;
}

// Bytes of the plane buffers: alignment slack, the query planes (a chunk
// each when hoisted, else BUFS) and BUFS point plane buffers.
__host__ __device__ __forceinline__ int pipe_bytes(int d, bool hoist) {
  return ALIGN_B + ((hoist ? chunks(d) : BUFS) + BUFS) * CHUNK_B;
}

// Floats of shared memory scan takes at width d: the planes and the u
// tile.
__host__ __device__ __forceinline__ int smem_floats(int d) {
  return pipe_bytes(d, scan_hoists(d)) / 4 + TQ * US;
}

// Floats of shared memory scan_minima takes at width d (hoist as the
// caller runs it): the planes and the TQ x BS block minima.
__host__ __device__ __forceinline__ int minima_smem_floats(int d, bool hoist) {
  return pipe_bytes(d, hoist) / 4 + TQ * BS;
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
// first value in the low half: the lower feature at the lower address).
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

// ---- PTX: shared addresses, mbarriers, bulk copies, wgmma ---------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive where `pred` holds (a predicate, not a branch: no divergent path
// may lie between a wgmma and its wait).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// Wait until the phase of the given parity has completed (the loop inside
// the asm, so that no divergent branch precedes a wgmma).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Where `pred` holds: bring the 32 bytes at p into L2 (a predicate, not a
// branch).
__device__ __forceinline__ void prefetch_l2_if(const float* p, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p prefetch.global.L2 [%0];\n}\n" ::"l"(p),
      "r"(static_cast<int>(pred)));
}

// Generic-proxy shared-memory writes before it are seen by the async
// proxy (wgmma's operand reads) after a later barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across it.
__device__ __forceinline__ void touch(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of a K-major operand in the 64-byte swizzle: start
// address, leading byte offset 1 (unused), stride byte offset GROUP_B
// between 8-row groups, layout type 2 (64B swizzle), in 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(GROUP_B >> 4) << 32) |
         (2ull << 62);
}

// d (64 x 64, f32) += A (64 x 16, bf16, descriptor a) B^T (64 x 16, bf16,
// descriptor b), both K-major.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// The product of one chunk (nk k-steps of 16 features) from its piece
// planes (qp: this warpgroup's 64 query rows, xp: its 64 point rows; piece
// p at + p * PLANE_B) into the warpgroup's accumulators, issued and
// committed as one group.  k-steps ascending, each the six products
// hh, hm, mh, hl, lh, mm in that order.
__device__ __forceinline__ void issue(float (&acc)[32], const char* qp,
                                      const char* xp, int nk) {
  const uint64_t dq = desc(qp), dx = desc(xp);
  constexpr uint64_t P = PLANE_B >> 4;   // next piece, in descriptor units
  __syncwarp();
  touch(acc);
  wgmma_fence();
  for (int kk = 0; kk < nk; ++kk) {
    const uint64_t k = 2 * kk;           // 32 bytes a k-step
    wgmma(acc, dq + k, dx + k);                  // hh
    wgmma(acc, dq + k, dx + P + k);              // hm
    wgmma(acc, dq + P + k, dx + k);              // mh
    wgmma(acc, dq + k, dx + 2 * P + k);          // hl
    wgmma(acc, dq + 2 * P + k, dx + k);          // lh
    wgmma(acc, dq + P + k, dx + P + k);          // mm
  }
  wgmma_commit();
  touch(acc);
}

// Thread tid's share of a chunk: 8 features (seg * 8 ..) of row tid / 4.
// Loads them from global memory (zeros past `total` rows and past d).
template <bool VEC>
__device__ __forceinline__ void load8(float (&v)[8], const float* src,
                                      long long total, long long row, int d,
                                      int c0) {
  const int k0 = c0 + (threadIdx.x & 3) * 8;
  const float* p = src + row * d + k0;
  if constexpr (VEC) {
    // d % 4 == 0: each half is all in or all out (selects, not branches)
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 lo = row < total && k0 + 4 <= d
                          ? __ldg(reinterpret_cast<const float4*>(p)) : z;
    const float4 hi = row < total && k0 + 8 <= d
                          ? __ldg(reinterpret_cast<const float4*>(p) + 1) : z;
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = (row < total && k0 + i < d) ? __ldg(p + i) : 0.f;
  }
}

// Byte offset of (row, 16-byte chunk seg) in a piece plane: the canonical
// K-major layout in the 64-byte swizzle.
__device__ __forceinline__ int plane_off(int row, int seg) {
  return (row >> 3) * GROUP_B + (row & 7) * ROW_B +
         ((seg ^ ((row >> 1) & 3)) << 4);
}

// Split the thread's 8 features into the three piece planes at `plane`
// (one 16-byte store a piece, at byte offset `off`).
__device__ __forceinline__ void split_store(const float (&v)[8], char* plane,
                                            int off) {
  uint4 h, m, l;
  split2(v[0], v[1], h.x, m.x, l.x);
  split2(v[2], v[3], h.y, m.y, l.y);
  split2(v[4], v[5], h.z, m.z, l.z);
  split2(v[6], v[7], h.w, m.w, l.w);
  *reinterpret_cast<uint4*>(plane + off) = h;
  *reinterpret_cast<uint4*>(plane + PLANE_B + off) = m;
  *reinterpret_cast<uint4*>(plane + 2 * PLANE_B + off) = l;
}

// A tile's epilogue write (rows row0 ..): each warpgroup waits for its
// product, then writes its 64 x 64 quarter of u into the u tile (MINIMA
// false) or its 64 queries' minima over its 4 blocks (MINIMA true), and
// zeroes its accumulators.  Between two __syncthreads: the first ends the
// previous tile's on_tile everywhere, the second publishes the tile.
template <bool MINIMA>
__device__ __forceinline__ void write_tile(float (&acc)[32], float* out,
                                           const float* __restrict__ norms,
                                           long long n, long long row0,
                                           int wg) {
  // acc[4 j + 2 h + e]: query row 64 (wg & 1) + 16 (warp & 3) + g + 8 h,
  // point row 64 (wg >> 1) + 8 j + 2 t4 + e of the tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r = (wg & 1) * WG_M + (warp & 3) * 16 + g;
  const int c0 = (wg >> 1) * WG_N;
  float xn[8][2];   // the norms of the lane's columns, read before the wait
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const long long rx = row0 + c0 + 8 * j + 2 * t4;
    xn[j][0] = rx < n ? __ldg(norms + rx) : INFINITY;
    xn[j][1] = rx + 1 < n ? __ldg(norms + rx + 1) : INFINITY;
  }
  __syncthreads();
  wgmma_wait<0>();
  touch(acc);
  if constexpr (MINIMA) {
    // v[h][b]: the lane's least u of its query row h over block b (of 4)
    float v[2][4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* a0 = acc + 8 * b + 2 * h;
        const float* a1 = acc + 8 * b + 4 + 2 * h;
        const float u00 = xn[2 * b][0] - 2.f * a0[0];
        const float u01 = xn[2 * b][1] - 2.f * a0[1];
        const float u10 = xn[2 * b + 1][0] - 2.f * a1[0];
        const float u11 = xn[2 * b + 1][1] - 2.f * a1[1];
        v[h][b] = min_nan(min_nan(u00, u01), min_nan(u10, u11));
      }
    // transposed minimum over the quad: lanes t4 and t4 ^ 1 split the
    // blocks, then t4 and t4 ^ 2 the rows; lane t4 ends with row
    // h = t4 >> 1, blocks 2 (t4 & 1) and + 1
    const bool up1 = t4 & 1, up2 = t4 & 2;
    float w[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float send = up1 ? v[h][j] : v[h][2 + j];
        const float keep = up1 ? v[h][2 + j] : v[h][j];
        w[h][j] = min_nan(keep, __shfl_xor_sync(FULL, send, 1));
      }
    float z[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float send = up2 ? w[0][j] : w[1][j];
      const float keep = up2 ? w[1][j] : w[0][j];
      z[j] = min_nan(keep, __shfl_xor_sync(FULL, send, 2));
    }
    *reinterpret_cast<float2*>(out + (r + (up2 ? 8 : 0)) * BS +
                               (wg >> 1) * (WG_N / BLOCK) + (up1 ? 2 : 0)) =
        make_float2(z[0], z[1]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(out + r * US + col) = make_float2(
          xn[j][0] - 2.f * acc[4 * j], xn[j][1] - 2.f * acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (r + 8) * US + col) = make_float2(
          xn[j][0] - 2.f * acc[4 * j + 2], xn[j][1] - 2.f * acc[4 * j + 3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  __syncthreads();
}

// The core: stream the rows [r_begin, r_end) in tiles of TN for the
// block's TQ queries from q0 through the pipeline above, and after each
// tile call on_tile(row0, rows, out) on every thread of the block, between
// two __syncthreads, with out the u tile (MINIMA false: u of query q0 + r
// and row row0 + c at out[r * US + c]) or the block minima (MINIMA true:
// out[r * BS + b] the least u over rows row0 + 16 b .. + 15).  Columns or
// blocks at or past `rows` belong to no one.  Rows past n give +inf u (NaN
// for a NaN query).  hoist: the query planes of every chunk stay resident.
// VEC: d % 4 == 0 and 16-byte aligned rows (16-byte loads).
template <bool VEC, bool MINIMA, class OnTile>
__device__ __forceinline__ void run(const float* __restrict__ points,
                                    const float* __restrict__ queries,
                                    const float* __restrict__ norms,
                                    long long n, int q, int d, int q0,
                                    long long r_begin, long long r_end,
                                    bool hoist, float* smem,
                                    OnTile&& on_tile) {
  __shared__ uint64_t full_bar[BUFS], empty_bar[BUFS];
  const int nch = chunks(d);
  char* base = reinterpret_cast<char*>(smem);
  base += (ALIGN_B - (smem_u32(base) & (ALIGN_B - 1))) & (ALIGN_B - 1);
  char* qplanes = base;   // [chunks or BUFS][PIECES][TN rows]
  char* xplanes = qplanes + (hoist ? nch : BUFS) * CHUNK_B;   // [BUFS][...]
  float* out = reinterpret_cast<float*>(xplanes + BUFS * CHUNK_B);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the warpgroup, read from lane 0 so that the compiler sees it uniform
  const int wg = __shfl_sync(FULL, tid >> 7, 0);
  // its operands: 64 query rows (wg & 1) and 64 point rows (wg >> 1)
  const int qoff = (wg & 1) * (WG_M / 8) * GROUP_B;
  const int xoff = (wg >> 1) * (WG_N / 8) * GROUP_B;
  const int row = tid >> 2;   // this thread's share of a chunk: 8 features
  const int poff = plane_off(row, tid & 3);
  const long long ntiles = r_end > r_begin ? (r_end - r_begin + TN - 1) / TN
                                           : 0;
  const long long nst = ntiles * nch;

  if (tid == 0) {
    for (int i = 0; i < BUFS; ++i) {
      mbar_init(&full_bar[i], THREADS / 32);   // every warp split
      mbar_init(&empty_bar[i], THREADS / 32);  // every warp's wgmma read
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float xv[8], qv[8];
  if (hoist) {
    for (int c = 0; c < nch; ++c) {
      load8<VEC>(qv, queries, q, q0 + row, d, c * DC);
      split_store(qv, qplanes + c * CHUNK_B, poff);
    }
    fence_proxy_async();
  }
  __syncthreads();

  // A chunk's place: tile t of the range, chunk c of the tile (kept by
  // counting, not by dividing the chunk index: a 64-bit division is some
  // 70 instructions).
  long long t = 0;
  int c = 0;
  // the thread's 8 point features of chunk (tt, cc), and its 8 query
  // features where the query planes are not hoisted, into registers a
  // chunk ahead of their split, and its point features of the chunk after
  // into L2
  auto prefetch = [&](long long tt, int cc) {
    const bool wrap = cc + 1 == nch;
    const long long pr = r_begin + (wrap ? tt + 1 : tt) * TN + row;
    const int pk = (wrap ? 0 : cc + 1) * DC + (tid & 3) * 8;
    prefetch_l2_if(points + pr * d + pk, pr < n && pk < d);
    load8<VEC>(xv, points, n, r_begin + tt * TN + row, d, cc * DC);
    if (!hoist) load8<VEC>(qv, queries, q, q0 + row, d, cc * DC);
  };
  if (nst > 0) prefetch(0, 0);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // buffers are freed in chunk order: rel is the next chunk to free, relb
  // its buffer
  long long rel = 0;
  int relb = 0;
  auto release = [&](long long upto) {
    __syncwarp();
    for (; rel < upto; ++rel) {
      mbar_arrive_if(&empty_bar[relb], lane == 0);
      relb = relb + 1 == BUFS ? 0 : relb + 1;
    }
  };
  // A tile's on_tile waits until the next tile's chunk `late` is issued:
  // up to BUFS chunks on the tensor cores while it runs.  s == nst is a
  // last pass with nothing to split or issue.
  const int late = nch < BUFS ? nch - 1 : BUFS - 1;
  int b = 0;          // s % BUFS
  unsigned pb = 0;    // (s / BUFS) & 1
  for (long long s = 0; s <= nst; ++s) {
    const bool tail = s == nst;
    char* xp = xplanes + b * CHUNK_B;
    char* qp = qplanes + (hoist ? c : b) * CHUNK_B;

    // 1. split chunk s into buffer b, once the wgmma that read it is done,
    // and load the next chunk's features
    if (!tail) {
      if (s >= BUFS) mbar_wait(&empty_bar[b], pb ^ 1);
      split_store(xv, xp, poff);
      if (!hoist) split_store(qv, qp, poff);
      fence_proxy_async();
      __syncwarp();
      mbar_arrive_if(&full_bar[b], lane == 0);
      if (s + 1 < nst) {
        if (c + 1 < nch)
          prefetch(t, c + 1);
        else
          prefetch(t + 1, 0);
      }
    }

    // 2. at a tile's first chunk the previous tile's accumulators go out
    // (freeing the buffers of its last chunks); then chunk s is issued
    if (c == 0 && t > 0) {
      write_tile<MINIMA>(acc, out, norms, n, r_begin + (t - 1) * TN, wg);
      release(s);
    }
    if (!tail) {
      mbar_wait(&full_bar[b], pb);
      issue(acc, qp + qoff, xp + xoff, (min(DC, d - c * DC) + 15) >> 4);
    }

    // 3. the previous tile's selection, with this tile's product running
    if (t > 0 && (c == late || tail)) {
      const long long row0 = r_begin + (t - 1) * TN;
      const long long left = r_end - row0;
      on_tile(row0, left < TN ? static_cast<int>(left) : TN,
              static_cast<const float*>(out));
    }
    if (tail) break;

    // 4. free the buffers of the chunks done: all but the BUFS - 1 newest
    __syncwarp();
    wgmma_wait<BUFS - 1>();
    touch(acc);
    release(s - BUFS + 2);

    if (++c == nch) {
      c = 0;
      ++t;
    }
    if (++b == BUFS) {
      b = 0;
      pb ^= 1;
    }
  }
  __syncthreads();   // the caller may reuse shared memory
}

// Stream the rows [r_begin, r_end) in tiles of TN (the last one short) for
// the block's TQ queries from q0, and after each tile call
//     on_tile(row0, rows, us)
// on every thread of the block, between two __syncthreads: us (stride US)
// holds u of query q0 + r and row row0 + c at us[r * US + c] for c < rows
// (rows <= TN; columns past `rows` belong to no one and are not to be
// read).  Rows past n give +inf u (NaN for a NaN query).  smem:
// smem_floats(d) floats.
template <bool VEC, class OnTile>
__device__ __forceinline__ void scan(const float* __restrict__ points,
                                     const float* __restrict__ queries,
                                     const float* __restrict__ norms,
                                     long long n, int q, int d, int q0,
                                     long long r_begin, long long r_end,
                                     float* smem, OnTile&& on_tile) {
  run<VEC, false>(points, queries, norms, n, q, d, q0, r_begin, r_end,
                  scan_hoists(d), smem, on_tile);
}

// As scan, but after each tile
//     on_tile(row0, rows, bm)
// gets only the block minima: bm[r * BS + b] is the minimum of u of query
// q0 + r over rows row0 + 16 b .. + 15 (NaN for a NaN query; +inf where
// every row is past n or has a +inf norm).  Blocks at or past `rows`
// belong to no one.  The same core, pipeline and u as scan; hoist (only
// where hoists(d)) keeps every chunk's query planes.  smem:
// minima_smem_floats(d, hoist) floats.
template <bool VEC, class OnTile>
__device__ __forceinline__ void scan_minima(const float* __restrict__ points,
                                            const float* __restrict__ queries,
                                            const float* __restrict__ norms,
                                            long long n, int q, int d, int q0,
                                            long long r_begin,
                                            long long r_end, bool hoist,
                                            float* smem, OnTile&& on_tile) {
  run<VEC, true>(points, queries, norms, n, q, d, q0, r_begin, r_end, hoist,
                 smem, on_tile);
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
