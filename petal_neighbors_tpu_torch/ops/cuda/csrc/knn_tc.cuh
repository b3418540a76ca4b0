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
//     and the last remainder has at most 8 significant bits.  The split is
//     split_planes.cu's, made before the core runs: an index splits its
//     rows once at build, a call its queries once;
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
// each), 125 bytes a clock at the tensor-core rate against the SM's 128.
// Where the query planes stream (d > 96 in scan, > 128 in scan_minima) a
// chunk also brings 48 KB from L2, 131 FLOP a byte: at GIST's d = 960 the
// copies' L2 traffic, not the tensor cores, sets the pace.
//
// The pipeline.  Block = 512 threads, four warpgroups.  Features go DC = 32
// at a time (a "chunk"); the operands arrive as finished piece planes
// (split_planes.cu: 128-row tile by chunk, 24,576 bytes each, the hi, mid
// and lo planes in wgmma's canonical K-major 64-byte-swizzled layout:
// 8-row groups of 512 bytes, 16-byte segment j of row r at j ^ ((r >> 1) &
// 3)), so no thread loads, splits or stores an operand element:
//   1. copies: lane 0 of warp 0 brings each chunk into one of BUFS = 3
//      plane buffers by cp.async.bulk, completing on the buffer's "full"
//      mbarrier by transaction bytes: the point planes as six 4 KB pieces
//      (each plane's two 64-row halves: a range may start at an odd
//      multiple of 64 rows) and, where the query planes are not resident,
//      the query chunk (24 KB); it does so once the buffer's "empty"
//      mbarrier says that every warp's wgmma on the chunk before is done.
//      The whole of warp 0 waits on "empty", so that the wait loop's branch
//      stays uniform in the warp (a divergent one, one thread waiting,
//      made ptxas serialize every wgmma of the kernel, C7520).  The query
//      planes of every chunk come in once per block where they fit (scan:
//      d <= 96, scan_minima: d <= 128);
//   2. product: each warpgroup waits on "full", then issues its 64 x 64
//      quarter of the tile (wgmma.mma_async.m64n64k16, both operands by
//      descriptor, 32 f32 accumulators a thread) as one committed group of
//      straight-line wgmma (six a k-step, one or two k-steps a chunk: a
//      template argument, since a loop over a run-time count made ptxas
//      close a group at each pass and so drain the tensor cores at every
//      wait), and goes on at once;
//   3. hand-off: after issuing chunk s a warp waits until chunk s - 1's
//      product is done (all but the newest group) and arrives on its
//      buffer's "empty"; the copies therefore run two chunks ahead of the
//      product, with chunk s on the tensor cores;
//   4. epilogue: at the next tile's first chunk the warpgroups drain their
//      product, free the tile's buffers (so the next chunks' copies start
//      during the write), write u (or the block minima) from their
//      accumulators and issue that chunk; the caller's selection runs once
//      the next tile's third chunk (its last, if fewer) is issued.  The
//      tensor cores wait only while the accumulators are written out.
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
// ldmatrix for mma.sync.m16n8k16 on 16 warps, each chunk loaded, split,
// barriered and multiplied in series: 31% of its tier.  The one before
// this (asynchronous wgmma, every thread loading its rows a chunk ahead and
// splitting them into the buffers, 36-42% of its tier) left the point
// planes of an index to be made once as a lever not taken (6 bytes an
// element against 4, to save half a split; its own measurement then: a
// ring of TMA boxes of f32 rows 43.3 ms and one cp.async.bulk a row 61.3,
// against 37.6 with the rows through registers, since staged f32 rows add
// the split's shared-memory reads).  Pre-split planes add no shared-memory
// traffic (the copy engine writes what the split wrote, only wgmma reads
// it).  The gain over that core is two changes' in turn (kernel times,
// H100 80GB HBM3, 700 W, PERF.md §6).  The group fix (step 2's one
// straight group a chunk) alone, in the register-split core: bcap at
// SIFT's k_scan 18 43.1 -> 41.6 ms, capped at GIST 30.3 -> 28.6 (the two
// sides in separate calls).  The planes over the fix, in one call: bcap
// 41.6 -> 40.2, capped at SIFT's k_scan 18 61.5 -> 54.0 and k_scan 108
// 67.4 -> 60.0, at GIST 28.6 -> 25.4, at the GloVe shape 67.8 -> 59.5,
// the block and subchunk minima 36.9 -> 34.8 and 37.5 -> 34.6, merge 31.0
// -> 28.6; the d <= 16 callers 1.83 -> 1.85 (VP config 2, d = 2) and
// 26.4 -> 26.8 (the MST core pass, d = 8).  So the lever not taken then
// pays now: the planes save both operands' split, not half of one, for
// 1.5x the index's float32 bytes on the card.  Tried and not kept: the
// planes without the group fix (8-26% slower than the register split: the
// copy's latency sat where the split's registers had been a chunk ahead),
// four buffers for scan_minima, the wait for all but two groups, an L2
// prefetch of the point planes a ring ahead (all no faster or slower), and
// one 24 KB copy a chunk where the range is tile-aligned (block minima
// 34.7 -> 29.5 ms, bcap 39.9 -> 43.0).  Each warpgroup takes
// 64 x 64 (32 accumulators) rather than 64 x 128: with 64 accumulators
// live beside the selection's state, capped and bcap spilled 470-720
// bytes a thread.  The loop counts its chunk's tile and offset rather
// than dividing the chunk index (a 64-bit division is some 70
// instructions).
//
// What is left: the drain of the one accumulator set at each tile's end
// (the tensor cores idle while u is written out) and the selection at
// d = 100 and k_scan 108, which outlasts the two chunks queued beside it;
// and ptxas serializes the wgmma of knn_select.cu's pass kernels (its note
// C7518, a dependence in a divergent path of the merge's selection).
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
constexpr int BUFS = 3;       // plane buffers of the copies' ring
constexpr int ROW_B = DC * 2;             // bytes of a plane row: 64
constexpr int GROUP_B = 8 * ROW_B;        // an 8-row swizzle group: 512
constexpr int PLANE_B = TN * ROW_B;       // one piece plane: 8,192
constexpr int HALF_B = PLANE_B / 2;       // its 64 rows of one wgmma: 4,096
constexpr int CHUNK_B = PIECES * PLANE_B; // one operand's chunk: 24,576
constexpr int ALIGN_B = 1024;             // swizzle groups start aligned
static_assert(TQ == TN, "query and point planes share a shape");
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

// As mbar_wait where `pred` holds, the other threads going on at once;
// `pred` the same in every lane of a warp, or the wait loop's branch
// diverges and ptxas serializes the warp's wgmma.
__device__ __forceinline__ void mbar_wait_if(uint64_t* bar, unsigned parity,
                                             bool pred) {
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.b32 q, %2, 0;\nsetp.eq.b32 p, %2, 0;\n"
      "WAIT:\n"
      "@q mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "r"(static_cast<int>(pred))
      : "memory");
}

// Where `pred` holds: arrive on `bar` and add `bytes` to the transaction
// count its phase waits for.
__device__ __forceinline__ void mbar_expect_if(uint64_t* bar, unsigned bytes,
                                               bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"(static_cast<int>(pred))
      : "memory");
}

// Where `pred` holds: copy `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global memory at src to shared memory at dst by the copy
// engine, completing them on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy_if(void* dst, const void* src,
                                             unsigned bytes, uint64_t* bar,
                                             bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n}\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "r"(static_cast<int>(pred))
      : "memory");
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

// NK k-steps of 16 features from the piece planes at descriptors dq, dx
// (piece p at + p * P), ascending, each the six products hh, hm, mh, hl,
// lh, mm in that order; unrolled, so that the chunk's wgmma are one
// straight run.
template <int NK>
__device__ __forceinline__ void ksteps(float (&acc)[32], uint64_t dq,
                                       uint64_t dx) {
  constexpr uint64_t P = PLANE_B >> 4;   // next piece, in descriptor units
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t k = 2 * kk;           // 32 bytes a k-step
    wgmma(acc, dq + k, dx + k);                  // hh
    wgmma(acc, dq + k, dx + P + k);              // hm
    wgmma(acc, dq + P + k, dx + k);              // mh
    wgmma(acc, dq + k, dx + 2 * P + k);          // hl
    wgmma(acc, dq + 2 * P + k, dx + k);          // lh
    wgmma(acc, dq + P + k, dx + P + k);          // mm
  }
}

// The product of one chunk (nk = 1 or 2 k-steps) from its piece planes
// (qp: this warpgroup's 64 query rows, xp: its 64 point rows; piece p at
// + p * PLANE_B) into the warpgroup's accumulators, issued and committed
// as one group.  Each path is straight and commits its own group: a loop
// over a run-time k-step count made ptxas close a group at every pass
// (and a commit after the paths join, one more), so that the wait for
// all but the two newest groups drained the tensor cores to half a chunk
// at every step.
__device__ __forceinline__ void issue(float (&acc)[32], const char* qp,
                                      const char* xp, int nk) {
  const uint64_t dq = desc(qp), dx = desc(xp);
  __syncwarp();
  touch(acc);
  wgmma_fence();
  if (nk == 2) {
    ksteps<2>(acc, dq, dx);
    wgmma_commit();
  } else {
    ksteps<1>(acc, dq, dx);
    wgmma_commit();
  }
  touch(acc);
}

// A tile's epilogue write (rows row0 ..): each warpgroup waits for its
// product, calls drained() (every wgmma of the block done: the plane
// buffers are free), then writes its 64 x 64 quarter of u into the u tile
// (MINIMA false) or its 64 queries' minima over its 4 blocks (MINIMA true),
// and zeroes its accumulators.  Between two __syncthreads: the first ends
// the previous tile's on_tile everywhere, the second publishes the tile.
template <bool MINIMA, class Drained>
__device__ __forceinline__ void write_tile(float (&acc)[32], float* out,
                                           const float* __restrict__ norms,
                                           long long n, long long row0,
                                           int wg, Drained&& drained) {
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
  drained();
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
// for a NaN query).  xplanes, qplanes: the points' and the queries' piece
// planes (split_planes.cu: 128-row tile by DC-feature chunk, CHUNK_B bytes
// each, zero past the rows and past d); q0 is a multiple of TQ.  hoist:
// the query planes of every chunk stay resident.
template <bool MINIMA, class OnTile>
__device__ __forceinline__ void run(const char* __restrict__ xplanes,
                                    const char* __restrict__ qplanes,
                                    const float* __restrict__ norms,
                                    long long n, int d, int q0,
                                    long long r_begin, long long r_end,
                                    bool hoist, float* smem,
                                    OnTile&& on_tile) {
  __shared__ uint64_t full_bar[BUFS], empty_bar[BUFS], query_bar;
  const int nch = chunks(d);
  char* base = reinterpret_cast<char*>(smem);
  base += (ALIGN_B - (smem_u32(base) & (ALIGN_B - 1))) & (ALIGN_B - 1);
  char* qbuf = base;   // [chunks or BUFS][PIECES][TN rows]
  char* xbuf = qbuf + (hoist ? nch : BUFS) * CHUNK_B;   // [BUFS][...]
  float* out = reinterpret_cast<float*>(xbuf + BUFS * CHUNK_B);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the warpgroup, read from lane 0 so that the compiler sees it uniform
  const int wg = __shfl_sync(FULL, tid >> 7, 0);
  // warp 0 waits for the buffers to empty (the whole warp, so that the
  // wait loop's branch stays uniform in it), and its lane 0 issues the
  // copies (a predicate)
  const bool producer = __shfl_sync(FULL, tid >> 5, 0) == 0;
  const bool elect = tid == 0;
  // its operands: 64 query rows (wg & 1) and 64 point rows (wg >> 1)
  const int qoff = (wg & 1) * (WG_M / 8) * GROUP_B;
  const int xoff = (wg >> 1) * (WG_N / 8) * GROUP_B;
  const long long ntiles = r_end > r_begin ? (r_end - r_begin + TN - 1) / TN
                                           : 0;
  const long long nst = ntiles * nch;
  const long long xtiles = (n + TN - 1) / TN;   // the points' plane tiles
  const char* qsrc = qplanes + static_cast<long long>(q0 / TQ) * nch * CHUNK_B;

  if (tid == 0) {
    for (int i = 0; i < BUFS; ++i) {
      mbar_init(&full_bar[i], 1);              // the copies' arrival
      mbar_init(&empty_bar[i], THREADS / 32);  // every warp's wgmma read
    }
    mbar_init(&query_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (hoist) {
    mbar_expect_if(&query_bar, nch * CHUNK_B, elect);
    for (int c = 0; c < nch; ++c)
      bulk_copy_if(qbuf + c * CHUNK_B, qsrc + c * CHUNK_B, CHUNK_B,
                   &query_bar, elect);
  }

  // The copies: chunk cp (tile ct, chunk cc of the tile) into buffer cb
  // (phase parity cpb), once the wgmma of the chunk BUFS before it have
  // all read that buffer.  A 128-row tile of the range is two 64-row
  // halves, each a HALF_B piece of every plane of the tile that holds it
  // (a range may start at an odd multiple of 64 rows; a half past the
  // points' last tile reads that tile again, rows past n whose u is
  // +inf); the streamed query chunk is one contiguous CHUNK_B.
  long long cp = 0, ct = 0;
  int cc = 0, cb = 0;
  unsigned cpb = 0;
  auto produce = [&](long long upto) {
    for (; cp < upto; ++cp) {
      mbar_wait_if(&empty_bar[cb], cpb ^ 1, producer && cp >= BUFS);
      mbar_expect_if(&full_bar[cb], (hoist ? 1 : 2) * CHUNK_B, elect);
      char* xp = xbuf + cb * CHUNK_B;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = r_begin + ct * TN + h * WG_N;
        const long long tile = min(r / TN, xtiles - 1);
        const char* src = xplanes + (tile * nch + cc) * CHUNK_B +
                          ((r / WG_N) & 1) * HALF_B;
#pragma unroll
        for (int p = 0; p < PIECES; ++p)
          bulk_copy_if(xp + p * PLANE_B + h * HALF_B, src + p * PLANE_B,
                       HALF_B, &full_bar[cb], elect);
      }
      bulk_copy_if(qbuf + cb * CHUNK_B, qsrc + cc * CHUNK_B, CHUNK_B,
                   &full_bar[cb], elect && !hoist);
      if (++cc == nch) {
        cc = 0;
        ++ct;
      }
      if (++cb == BUFS) {
        cb = 0;
        cpb ^= 1;
      }
    }
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // buffers are freed in chunk order: rel is the next chunk to free, relb
  // its buffer; each release lets the copies run BUFS chunks past it
  long long rel = 0;
  int relb = 0;
  auto release = [&](long long upto) {
    __syncwarp();
    for (; rel < upto; ++rel) {
      mbar_arrive_if(&empty_bar[relb], lane == 0);
      relb = relb + 1 == BUFS ? 0 : relb + 1;
    }
    produce(min(rel + BUFS, nst));
  };
  produce(min(static_cast<long long>(BUFS), nst));
  if (hoist) mbar_wait(&query_bar, 0);

  // A chunk's place: tile t of the range, chunk c of the tile (kept by
  // counting, not by dividing the chunk index: a 64-bit division is some
  // 70 instructions).
  long long t = 0;
  int c = 0;
  // A tile's on_tile waits until the next tile's chunk `late` is issued,
  // so that the tensor cores have it and the chunk before it while the
  // selection runs.  s == nst is a last pass with nothing to issue.
  const int late = nch < BUFS ? nch - 1 : BUFS - 1;
  int b = 0;          // s % BUFS
  unsigned pb = 0;    // (s / BUFS) & 1
  for (long long s = 0; s <= nst; ++s) {
    const bool tail = s == nst;

    // 1. at a tile's first chunk the previous tile's accumulators go out,
    // the buffers of its last chunks freed (and refilled) as soon as the
    // product has drained; then chunk s is issued once its copies have
    // landed
    if (c == 0 && t > 0)
      write_tile<MINIMA>(acc, out, norms, n, r_begin + (t - 1) * TN, wg,
                         [&] { release(s); });
    if (!tail) {
      mbar_wait(&full_bar[b], pb);
      issue(acc, qbuf + (hoist ? c : b) * CHUNK_B + qoff,
            xbuf + b * CHUNK_B + xoff, (min(DC, d - c * DC) + 15) >> 4);
    }

    // 2. the previous tile's selection, with this tile's product running
    if (t > 0 && (c == late || tail)) {
      const long long row0 = r_begin + (t - 1) * TN;
      const long long left = r_end - row0;
      on_tile(row0, left < TN ? static_cast<int>(left) : TN,
              static_cast<const float*>(out));
    }
    if (tail) break;

    // 3. free the buffer of the chunk before this one once its product is
    // done, and copy into it
    __syncwarp();
    wgmma_wait<1>();
    touch(acc);
    release(s);

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
// read).  Rows past n give +inf u (NaN for a NaN query).  xplanes and
// qplanes as run takes them.  smem: smem_floats(d) floats.
template <class OnTile>
__device__ __forceinline__ void scan(const char* __restrict__ xplanes,
                                     const char* __restrict__ qplanes,
                                     const float* __restrict__ norms,
                                     long long n, int d, int q0,
                                     long long r_begin, long long r_end,
                                     float* smem, OnTile&& on_tile) {
  run<false>(xplanes, qplanes, norms, n, d, q0, r_begin, r_end,
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
template <class OnTile>
__device__ __forceinline__ void scan_minima(const char* __restrict__ xplanes,
                                            const char* __restrict__ qplanes,
                                            const float* __restrict__ norms,
                                            long long n, int d, int q0,
                                            long long r_begin,
                                            long long r_end, bool hoist,
                                            float* smem, OnTile&& on_tile) {
  run<true>(xplanes, qplanes, norms, n, d, q0, r_begin, r_end, hoist, smem,
            on_tile);
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
