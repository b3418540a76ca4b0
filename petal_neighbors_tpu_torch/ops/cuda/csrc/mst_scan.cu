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
// Every difference, square and sum is rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no FMA contraction), the order the plain PyTorch
// version (mst_kernel.scan_minout_reference) computes in, so the two agree
// bit for bit.  float32 or float64 (the same template, rounded in its own
// type).  Finite inputs only (the MST raises on NaN points).
//
// What bounds it on this card: the FP32 instructions on the SIMT lanes.
// Each pair costs 3 a feature (sub, mul, add) and about 7 more (two max,
// the component compare and its select, the compare with the running best
// and its two updates): 3d + 7, 31 at d = 8; 10^12 pairs (a round at
// 1M points) at 33.5e12 lane instructions a second is about 0.9 s.  The
// bytes are negligible: the corpus is read once per 64-query block
// (mostly from L2), and nothing of the (q x n) tile reaches device memory.
//
// Design: a block of 256 threads takes 64 query rows and walks the whole
// corpus in tiles of 64 rows; each thread holds a 4 x 4 register tile of
// sums (4 queries x 4 corpus rows), fed by two 16-byte shared-memory reads
// a feature.  Features are staged 32 at a time, transposed, so any d runs;
// at d <= 32 the query rows are staged once.  Each thread keeps a running
// (w, j) for its 4 queries over its own columns, which it visits in
// ascending j, so a strict "<" keeps the lowest j at a tie; the 16 threads
// that share a query merge their (w, j) lexicographically by warp
// shuffles.  One launch computes every row; no state crosses blocks.
//
// The C entry points return a cudaError_t; the launch returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;        // query rows per block
constexpr int TN = 64;        // corpus rows per tile
constexpr int DC = 32;        // features staged at a time
constexpr int R = 4;          // a thread's queries and corpus rows
constexpr int THREADS = 256;  // (TQ / R) x (TN / R)
static_assert((TQ / R) * (TN / R) == THREADS, "one 4 x 4 tile a thread");
static_assert(TN / R == 16, "the merge shuffles within 16 lanes");

// Correctly rounded arithmetic in each type, never fused into an FMA.
struct F32 {
  using T = float;
  static __device__ __forceinline__ float inf() {
    return __int_as_float(0x7f800000);
  }
  static __device__ __forceinline__ float sq_add(float acc, float a,
                                                 float b) {
    const float t = __fsub_rn(a, b);
    return __fadd_rn(acc, __fmul_rn(t, t));
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
scan_minout_kernel(const typename A::T* __restrict__ pts,
                   const typename A::T* __restrict__ core_rd,
                   const int* __restrict__ comp,
                   const typename A::T* __restrict__ q,
                   const typename A::T* __restrict__ cq_rd,
                   const int* __restrict__ compq,
                   typename A::T* __restrict__ bw_out,
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

  // merge the 16 column groups of each query: least w, then least j (a
  // +inf w always carries j = -1, so equal +inf entries change nothing)
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
  scan_minout_kernel<A><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(pts), static_cast<const T*>(core_rd),
      static_cast<const int*>(comp), static_cast<const T*>(q),
      static_cast<const T*>(cq_rd), static_cast<const int*>(compq),
      static_cast<T*>(bw), static_cast<int*>(bj), n, nq, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The kernel's fixed sizes: query rows per block, corpus rows per tile,
// features staged at a time, threads per block.
void mst_constants(int* tq, int* tn, int* dc, int* threads) {
  *tq = TQ;
  *tn = TN;
  *dc = DC;
  *threads = THREADS;
}

// pts (n, d), core_rd (n,), comp (n,) int32, q (nq, d), cq_rd (nq,),
// compq (nq,) int32, all contiguous on one card, float32 (f64 = 0) or
// float64 (f64 = 1); writes bw (nq,) in the same type and bj (nq,) int32.
// n, nq >= 1, d >= 1.
int mst_scan_launch(int f64, const void* pts, const void* core_rd,
                    const void* comp, const void* q, const void* cq_rd,
                    const void* compq, void* bw, void* bj, int n, int nq,
                    int d, void* stream) {
  if (n < 1 || nq < 1 || d < 1 || (f64 != 0 && f64 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return f64 ? launch<F64>(pts, core_rd, comp, q, cq_rd, compq, bw, bj, n,
                           nq, d, s)
             : launch<F32>(pts, core_rd, comp, q, cq_rd, compq, bw, bj, n,
                           nq, d, s);
}

}  // extern "C"
