// mst_scan.cu — the Borůvka scan round's minimum outgoing edge per row.
//
// Computes the function of _scan_minout (petal_neighbors_tpu/trees/
// boruvka.py:330), which the JAX package leaves to XLA (no Pallas kernel):
// for each query row i, over corpus rows j with comp[j] != compq[i],
//
//   w(i, j) = max(max(rd(i, j), cq_rd[i]), core_rd[j]),
//   rd(i, j) = sum over f of (q[i, f] - x[j, f])^2, summed in order of f,
//
// bw[i] = the least w and bj[i] = the least j that reaches it; (+inf, -1)
// when no j gives a finite w (every j in i's component, or +inf cores).
// Arithmetic, the plain PyTorch version's (mst_kernel.scan_minout_
// reference) to the bit:
//   float32: t = q - x rounded, then acc = fma(t, t, acc) rounded once
//            (__fsub_rn, __fmaf_rn; the first feature __fmul_rn(t, t),
//            the bits of fma(t, t, +0)); the plain version rounds the
//            same exact sum once (mst_kernel._fma_rn).
//   float64: every difference, square and sum rounded on its own
//            (__dsub_rn, __dmul_rn, __dadd_rn: no FMA contraction).
// Then max(max(rd, cq), core), +inf for the same label, a strict "<" in
// ascending j, and the lexicographic (w, j) merge.  Finite inputs only
// (the MST raises on NaN points).
//
// What bounds it on this card: the FP32 instructions on the SIMT lanes.
// In float32 a pair costs 2 a feature (the sub and one FFMA) and 6 more
// (two max, the label compare, the compare with the running best, which
// takes the label test into its predicate, and its two updates): 2d + 6,
// 22 at d = 8; 10^12 pairs (a round at 1M points) at 33.5e12 lane
// instructions a second is 0.66 s.  The bytes are negligible: the corpus
// (32 MB at 1M x 8) is read once per 64-query block from L2, and nothing
// of the (q x n) tile reaches device memory.
//
// Design, the direct kernel (float32, d = 1 to 8, known at compile time):
// each warp holds 8 query rows in registers (every lane the same 8, d
// floats each, with their cores, labels and running (w, j)), and its 32
// lanes split the corpus: lane l takes rows l, l + 32, ... of each
// 256-row stage, in ascending j.  A row costs a lane d / 4 16-byte and one
// 8-byte shared read (features in planes of 4, 2 or 1 floats, then the
// row's (core, label) pair) for 8 queries' 8 x (2d + 6) instructions, so
// the loop issues little else than the pair arithmetic.  Stages are copied
// by cp.async (16-byte copies for planes of 4) into a ring of 3, one
// barrier a stage, so two stages are in flight while one is scanned.  A
// block is 8 warps (64 query rows, 2 blocks an SM at up to 128 registers);
// at 1M rows that is 15,625 blocks, at 16,384 rows 256.  The 32 lanes of
// a query merge their (w, j) lexicographically by warp shuffles.  No
// integer division is left in the loop (planes and rows are compile-time
// shifts and multiplies).
//
// The tile kernel (float64, and float32 at d > 8): a block of 256 threads
// takes 64 query rows and walks the corpus in tiles of 64 rows; each
// thread holds a 4 x 4 register tile of sums, fed by two shared-memory
// reads a feature; features are staged 32 at a time, transposed, so any d
// runs.
//
// One launch computes every row; no state crosses blocks.  The C entry
// points return a cudaError_t; the launch returns cudaGetLastError() right
// after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TQ = 64;        // query rows per block (both kernels)
constexpr int THREADS = 256;  // threads per block (both kernels)

// ---- the direct kernel ---------------------------------------------------

namespace direct {

constexpr int WARPS = THREADS / 32;
constexpr int RQ = 8;           // query rows a warp, held by every lane
constexpr int QB = WARPS * RQ;  // query rows a block
constexpr int TN = 256;         // corpus rows a stage
constexpr int STAGES = 3;       // the cp.async ring
constexpr int D_MAX = 8;        // the largest d compiled
static_assert(TN % 32 == 0 && TN == THREADS,
              "whole rows a lane; one (core, label) copy a thread");

template <int VW>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

// d features as planes of VW floats: 16-byte planes where 4 divides d
template <int D>
struct Planes {
  static constexpr int VW = D % 4 == 0 ? 4 : (D % 2 == 0 ? 2 : 1);
  static constexpr int NP = D / VW;
  using V = typename Vec<VW>::T;
};

template <int D>
struct Smem {
  typename Planes<D>::V x[STAGES][Planes<D>::NP][TN];
  float2 cc[STAGES][TN];  // (core_rd, label bits) of each row
};

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(B)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void unpack(float v, float* x) { x[0] = v; }
__device__ __forceinline__ void unpack(float2 v, float* x) {
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void unpack(float4 v, float* x) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// Copy corpus rows [j0, j0 + TN) into stage s: each row's features into
// the planes, its (core, label) pair beside them.  Rows past n get zero
// features and a +inf core (never taken) by plain stores.
template <int D>
__device__ __forceinline__ void stage(Smem<D>& sm, int s,
                                      const float* __restrict__ pts,
                                      const float* __restrict__ core_rd,
                                      const int* __restrict__ comp, int j0,
                                      int n, int tid) {
  using P = Planes<D>;
  using V = typename P::V;
#pragma unroll
  for (int c = 0; c < P::NP; ++c) {  // TN * NP chunks, NP a thread
    const int e = c * THREADS + tid;
    const int row = e / P::NP;  // consecutive threads, consecutive chunks
    const int p = e - row * P::NP;
    const int j = j0 + row;
    V* dst = &sm.x[s][p][row];
    if (j < n)
      cp_async<4 * P::VW>(dst, pts + static_cast<long long>(j) * D +
                                   p * P::VW);
    else
      *dst = V{};
  }
  const int j = j0 + tid;
  if (j < n) {
    cp_async<4>(&sm.cc[s][tid].x, core_rd + j);
    cp_async<4>(&sm.cc[s][tid].y, comp + j);
  } else {
    sm.cc[s][tid] = make_float2(__int_as_float(0x7f800000),
                                __int_as_float(-2));
  }
}

// grid = ceil(nq / QB).  Block b writes bw, bj of rows [b*QB, b*QB + QB).
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
direct_kernel(const float* __restrict__ pts,
              const float* __restrict__ core_rd, const int* __restrict__ comp,
              const float* __restrict__ q, const float* __restrict__ cq_rd,
              const int* __restrict__ compq, float* __restrict__ bw_out,
              int* __restrict__ bj_out, int n, int nq) {
  using P = Planes<D>;
  __shared__ __align__(16) Smem<D> sm;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * QB + (tid >> 5) * RQ;
  const float INF = __int_as_float(0x7f800000);

  float qv[RQ][D], cq[RQ], bw[RQ];
  int cmpq[RQ], bj[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = q0 + r;
    const bool ok = i < nq;
#pragma unroll
    for (int f = 0; f < D; ++f)
      qv[r][f] = ok ? q[static_cast<long long>(i) * D + f] : 0.0f;
    cq[r] = ok ? cq_rd[i] : INF;  // a padded query never takes a row
    cmpq[r] = ok ? compq[i] : -1;
    bw[r] = INF;
    bj[r] = -1;
  }

  const int tiles = (n + TN - 1) / TN;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) stage<D>(sm, s, pts, core_rd, comp, s * TN, n, tid);
    cp_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_wait<STAGES - 2>();  // this thread's copies of stage t landed
    __syncthreads();        // everyone's; and stage t - 1 is scanned
    const int next = t + STAGES - 1;
    if (next < tiles)
      stage<D>(sm, next % STAGES, pts, core_rd, comp, next * TN, n, tid);
    cp_commit();  // an empty group past the end keeps the count

    const int s = t % STAGES;
    const int j0 = t * TN;
#pragma unroll 2
    for (int k = 0; k < TN / 32; ++k) {  // ascending j: "<" keeps the lowest
      const int row = k * 32 + lane;
      float x[D];
#pragma unroll
      for (int p = 0; p < P::NP; ++p) unpack(sm.x[s][p][row], x + p * P::VW);
      const float2 cc = sm.cc[s][row];
      const int xm = __float_as_int(cc.y);
      const int j = j0 + row;
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float t0 = __fsub_rn(qv[r][0], x[0]);
        float acc = __fmul_rn(t0, t0);
#pragma unroll
        for (int f = 1; f < D; ++f) {
          const float tf = __fsub_rn(qv[r][f], x[f]);
          acc = __fmaf_rn(tf, tf, acc);
        }
        const float w = fmaxf(fmaxf(acc, cq[r]), cc.x);
        if (xm != cmpq[r] && w < bw[r]) {
          bw[r] = w;
          bj[r] = j;
        }
      }
    }
  }
  cp_wait<0>();

  // merge the 32 lanes of each query: least w, then least j (a +inf w
  // always carries j = -1, so equal +inf entries change nothing)
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ow = __shfl_xor_sync(0xffffffffu, bw[r], off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj[r], off);
      if (ow < bw[r] || (ow == bw[r] && oj < bj[r])) {
        bw[r] = ow;
        bj[r] = oj;
      }
    }
    const int i = q0 + r;
    if (lane == 0 && i < nq) {
      bw_out[i] = bw[r];
      bj_out[i] = bj[r];
    }
  }
}

template <int D>
bool aligned(const void* pts) {
  return reinterpret_cast<std::uintptr_t>(pts) % (4 * Planes<D>::VW) == 0;
}

template <int D>
int launch(const float* pts, const float* core_rd, const int* comp,
           const float* q, const float* cq_rd, const int* compq, float* bw,
           int* bj, int n, int nq, cudaStream_t stream) {
  const dim3 grid((nq + QB - 1) / QB);
  direct_kernel<D><<<grid, THREADS, 0, stream>>>(pts, core_rd, comp, q,
                                                 cq_rd, compq, bw, bj, n, nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace direct

// ---- the tile kernel -----------------------------------------------------

namespace tile {

constexpr int TN = 64;   // corpus rows per tile
constexpr int DC = 32;   // features staged at a time
constexpr int R = 4;     // a thread's queries and corpus rows
static_assert((TQ / R) * (TN / R) == THREADS, "one 4 x 4 tile a thread");
static_assert(TN / R == 16, "the merge shuffles within 16 lanes");

// float32: the fused step (fma(t, t, +0) is t * t, so the sums start at
// +0); float64: every step rounded on its own, never contracted.
struct F32 {
  using T = float;
  static __device__ __forceinline__ float inf() {
    return __int_as_float(0x7f800000);
  }
  static __device__ __forceinline__ float sq_add(float acc, float a,
                                                 float b) {
    const float t = __fsub_rn(a, b);
    return __fmaf_rn(t, t, acc);
  }
  static __device__ __forceinline__ float max(float a, float b) {
    return fmaxf(a, b);
  }
  // four consecutive shared values in one 16-byte read
  static __device__ __forceinline__ void load4(const float* p, float v[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

struct F64 {
  using T = double;
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  static __device__ __forceinline__ double sq_add(double acc, double a,
                                                  double b) {
    const double t = __dsub_rn(a, b);
    return __dadd_rn(acc, __dmul_rn(t, t));
  }
  static __device__ __forceinline__ double max(double a, double b) {
    return fmax(a, b);
  }
  static __device__ __forceinline__ void load4(const double* p,
                                               double v[4]) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
};

// grid = ceil(nq / TQ).  Block b writes bw, bj of rows [b*TQ, b*TQ + TQ).
template <typename A>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const typename A::T* __restrict__ pts,
            const typename A::T* __restrict__ core_rd,
            const int* __restrict__ comp, const typename A::T* __restrict__ q,
            const typename A::T* __restrict__ cq_rd,
            const int* __restrict__ compq, typename A::T* __restrict__ bw_out,
            int* __restrict__ bj_out, int n, int nq, int d) {
  using T = typename A::T;
  __shared__ __align__(16) T qs[DC][TQ];
  __shared__ __align__(16) T xs[DC][TN];
  __shared__ __align__(16) T xcore[TN];
  __shared__ __align__(16) int xcomp[TN];

  const int tid = threadIdx.x;
  const int tx = tid % (TN / R);   // column group: rows tx*4 .. tx*4+3
  const int ty = tid / (TN / R);   // query group: rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * TQ;
  const T INF = A::inf();

  T cq[R], bw[R];
  int cmpq[R], bj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + ty * R + r;
    cq[r] = i < nq ? cq_rd[i] : INF;
    cmpq[r] = i < nq ? compq[i] : -1;
    bw[r] = INF;
    bj[r] = -1;
  }
  const bool q_resident = d <= DC;

  for (int j0 = 0; j0 < n; j0 += TN) {
    T acc[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = T(0);

    for (int f0 = 0; f0 < d; f0 += DC) {
      const int dc = min(DC, d - f0);
      __syncthreads();   // the previous chunk's reads are done
      if (!q_resident || j0 == 0) {
        for (int e = tid; e < TQ * dc; e += THREADS) {
          const int row = e / dc, f = e - row * dc, i = q0 + row;
          qs[f][row] = i < nq ? q[static_cast<long long>(i) * d + f0 + f]
                              : T(0);
        }
      }
      for (int e = tid; e < TN * dc; e += THREADS) {
        const int row = e / dc, f = e - row * dc, j = j0 + row;
        xs[f][row] = j < n ? pts[static_cast<long long>(j) * d + f0 + f]
                           : T(0);
      }
      if (f0 == 0 && tid < TN) {
        const int j = j0 + tid;
        // rows past n: +inf core and a label no query has, never taken
        xcore[tid] = j < n ? core_rd[j] : INF;
        xcomp[tid] = j < n ? comp[j] : -2;
      }
      __syncthreads();
      for (int f = 0; f < dc; ++f) {
        T qv[R], xv[R];
        A::load4(&qs[f][ty * R], qv);
        A::load4(&xs[f][tx * R], xv);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c)
            acc[r][c] = A::sq_add(acc[r][c], qv[r], xv[c]);
      }
    }

    T xc[R];
    int xm[R];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      xc[c] = xcore[tx * R + c];
      xm[c] = xcomp[tx * R + c];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) {   // ascending j: "<" keeps the lowest
        T w = A::max(A::max(acc[r][c], cq[r]), xc[c]);
        if (xm[c] == cmpq[r]) w = INF;
        if (w < bw[r]) {
          bw[r] = w;
          bj[r] = j0 + tx * R + c;
        }
      }
  }

  // merge the 16 column groups of each query, as the direct kernel's lanes
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = TN / R / 2; off > 0; off >>= 1) {
      const T ow = __shfl_xor_sync(0xffffffffu, bw[r], off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj[r], off);
      if (ow < bw[r] || (ow == bw[r] && oj < bj[r])) {
        bw[r] = ow;
        bj[r] = oj;
      }
    }
    const int i = q0 + ty * R + r;
    if (tx == 0 && i < nq) {
      bw_out[i] = bw[r];
      bj_out[i] = bj[r];
    }
  }
}

template <typename A>
int launch(const void* pts, const void* core_rd, const void* comp,
           const void* q, const void* cq_rd, const void* compq, void* bw,
           void* bj, int n, int nq, int d, cudaStream_t stream) {
  using T = typename A::T;
  const dim3 grid((nq + TQ - 1) / TQ);
  tile_kernel<A><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(pts), static_cast<const T*>(core_rd),
      static_cast<const int*>(comp), static_cast<const T*>(q),
      static_cast<const T*>(cq_rd), static_cast<const int*>(compq),
      static_cast<T*>(bw), static_cast<int*>(bj), n, nq, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile

// float32: the direct kernel at d <= D_MAX, else the tile kernel.  The
// direct kernel's 16-byte copies want a corpus aligned to 16 bytes
// (mst_kernel.scan_minout copies one that is not); another is refused.
template <int D>
int launch_f32(const void* pts, const void* core_rd, const void* comp,
               const void* q, const void* cq_rd, const void* compq, void* bw,
               void* bj, int n, int nq, int d, cudaStream_t s) {
  if constexpr (D <= direct::D_MAX) {
    if (d == D) {
      if (!direct::aligned<D>(pts))
        return static_cast<int>(cudaErrorMisalignedAddress);
      return direct::launch<D>(
          static_cast<const float*>(pts), static_cast<const float*>(core_rd),
          static_cast<const int*>(comp), static_cast<const float*>(q),
          static_cast<const float*>(cq_rd), static_cast<const int*>(compq),
          static_cast<float*>(bw), static_cast<int*>(bj), n, nq, s);
    }
    return launch_f32<D + 1>(pts, core_rd, comp, q, cq_rd, compq, bw, bj, n,
                             nq, d, s);
  } else {
    return tile::launch<tile::F32>(pts, core_rd, comp, q, cq_rd, compq, bw,
                                   bj, n, nq, d, s);
  }
}

}  // namespace

extern "C" {

// The kernels' fixed sizes: query rows per block and corpus rows per
// stage (the direct kernel's; the tile kernel's 64 and 64 divide them),
// features the tile kernel stages at a time, threads per block.
void mst_constants(int* tq, int* tn, int* dc, int* threads) {
  *tq = direct::QB;  // the tile kernel's TQ is the same
  *tn = direct::TN;
  *dc = tile::DC;
  *threads = THREADS;
}

// pts (n, d), core_rd (n,), comp (n,) int32, q (nq, d), cq_rd (nq,),
// compq (nq,) int32, all contiguous on one card (pts aligned to 16
// bytes), float32 (f64 = 0) or float64 (f64 = 1); writes bw (nq,) in the
// same type and bj (nq,) int32.  n, nq >= 1, d >= 1.
int mst_scan_launch(int f64, const void* pts, const void* core_rd,
                    const void* comp, const void* q, const void* cq_rd,
                    const void* compq, void* bw, void* bj, int n, int nq,
                    int d, void* stream) {
  if (n < 1 || nq < 1 || d < 1 || (f64 != 0 && f64 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return f64 ? tile::launch<tile::F64>(pts, core_rd, comp, q, cq_rd, compq,
                                       bw, bj, n, nq, d, s)
             : launch_f32<1>(pts, core_rd, comp, q, cq_rd, compq, bw, bj, n,
                             nq, d, s);
}

}  // extern "C"
