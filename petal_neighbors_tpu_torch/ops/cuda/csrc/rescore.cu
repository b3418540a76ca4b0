// rescore.cu — the direct-form rescore: each candidate row gathered from
// device memory once and its squared distance to the query summed in
// registers.
//
// No TPU kernel: the JAX package writes the rescore in plain jnp
// (petal_neighbors_tpu/ops/topk.py rescore_exact, ops/bruteforce.py
// _rescore_large and _bcap_rescore), and XLA fuses its gather, difference,
// square and sum into one loop on the TPU.  PyTorch's eager mode does not:
// it ran them as four passes over a (Q, W, d) tensor in device memory.
//
// What it computes: out[q, c] = sum_i (queries[q, i] - points[r, i])^2 for
// candidate c of query q, where r = ids[q, c / B] * B + c % B (B = 1: the id
// is the row; B = 16: bcap's 16-row blocks; B = 128: two_phase's
// subchunks), in the points' type (float32 or float64, accumulated in the
// same type), and +inf where the id is negative, r is at or past n_rows,
// norms are given and norms[r] is not finite (the padding and NaN rows the
// index zeroes), or the sum is NaN.
//
// What bounds it: bytes.  Each candidate row meets one query, a quarter of
// a FLOP a byte in float32, so the bound is the gathered rows read once at
// 3.35 TB/s: 10,000 x 1,008 rows at d = 256 are 10.3 GB, 3.08 ms.  The
// design reads each row once and writes each rd once: a block of THREADS
// threads takes one query, held in shared memory, and a tile of its
// candidates; a group of `lanes` lanes (a power of two up to 32, the most
// that give each lane at least one 16-byte piece of the row) scores one row,
// each lane a running sum over its pieces (16-byte loads where d and the
// base pointer allow them, scalars elsewhere), then a shuffle tree over the
// group; each group keeps UNROLL rows in flight.  The wrapper picks lanes
// and the tile from d and the shape (ops/cuda/rescore_kernel.py).
//
// Rounding: against the exact sum of the rounded differences' squares, a
// result is within (t + log2 lanes) units of 2^-24 relative (2^-53 in
// float64), t the terms one lane sums in fused multiply-adds (4 ceil(d /
// (4 lanes)) with 16-byte float32 pieces): 37 units, 2.2e-6, at d = 960 on
// a warp, the same order as torch.sum's and under the benchmark's 5e-6.
//
// The C entry point returns the launch's cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// rows a lane group keeps in flight
constexpr int UNROLL = 4;

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// One piece of a row: a 16-byte vector (VEC) or a scalar, its load and its
// terms added to a running sum in fused multiply-adds, in feature order.
template <typename T, bool VEC>
struct Piece {
  using type = T;
  static constexpr int N = 1;
  __device__ static T zero() { return T(0); }
  __device__ static T load(const T* p) { return __ldg(p); }
  __device__ static T add(T acc, T x, T q) {
    const T t = q - x;
    return fmadd(t, t, acc);
  }
};

template <>
struct Piece<float, true> {
  using type = float4;
  static constexpr int N = 4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float4 load(const float4* p) { return __ldg(p); }
  __device__ static float add(float acc, float4 x, float4 q) {
    const float a = q.x - x.x, b = q.y - x.y, c = q.z - x.z, e = q.w - x.w;
    acc = fmaf(a, a, acc);
    acc = fmaf(b, b, acc);
    acc = fmaf(c, c, acc);
    return fmaf(e, e, acc);
  }
};

template <>
struct Piece<double, true> {
  using type = double2;
  static constexpr int N = 2;
  __device__ static double2 zero() { return make_double2(0.0, 0.0); }
  __device__ static double2 load(const double2* p) { return __ldg(p); }
  __device__ static double add(double acc, double2 x, double2 q) {
    const double a = q.x - x.x, b = q.y - x.y;
    acc = fma(a, a, acc);
    return fma(b, b, acc);
  }
};

// grid = q * tiles: block (q, tile) scores candidates [tile * tile_rows,
// + tile_rows) of query q, of its rows_q = width * block.  Group g of warp
// w takes candidate base + (u * WARPS + w) * groups + g at step u.
template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(THREADS)
rescore_kernel(const T* __restrict__ points, long long n_rows, int d,
               const T* __restrict__ queries, const I* __restrict__ ids,
               long long ids_stride, int width, int block,
               const T* __restrict__ norms, T* __restrict__ out, int lanes,
               int tile_rows, int tiles) {
  using P = Piece<T, VEC>;
  using V = typename P::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  const long long q = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const T* qrow = queries + q * d;
  for (int i = threadIdx.x; i < d; i += THREADS) sq[i] = qrow[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane & (lanes - 1), groups = 32 / lanes;
  const int group = lane / lanes;
  const int nvec = d / P::N;
  const V* svec = reinterpret_cast<const V*>(sq);
  const int rows_q = width * block;
  const int begin = tile * tile_rows;
  const int end = min(begin + tile_rows, rows_q);
  const I* qids = ids + q * ids_stride;
  T* qout = out + q * rows_q;
  // every lane of the block runs the same steps (the shuffles take the
  // whole warp); a candidate past the tile is scored as missing, unwritten
  for (int base = begin; base < end; base += WARPS * groups * UNROLL) {
    const V* prow[UNROLL];
    bool ok[UNROLL];
    int c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      c[u] = base + (u * WARPS + warp) * groups + group;
      ok[u] = false;
      prow[u] = reinterpret_cast<const V*>(points);
      if (c[u] < end) {
        const long long id = static_cast<long long>(qids[c[u] / block]);
        const long long r = id * block + c[u] % block;
        ok[u] = id >= 0 && r < n_rows &&
                (norms == nullptr || isfinite(norms[r]));
        if (ok[u]) prow[u] = reinterpret_cast<const V*>(points + r * d);
      }
    }
    T acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = T(0);
    for (int v = gl; v < nvec; v += lanes) {
      const V qv = svec[v];
      V x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        x[u] = ok[u] ? P::load(prow[u] + v) : P::zero();
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc[u] = P::add(acc[u], x[u], qv);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      for (int o = lanes >> 1; o > 0; o >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
      if (gl == 0 && c[u] < end)
        qout[c[u]] = ok[u] && !isnan(acc[u]) ? acc[u] : T(INFINITY);
    }
  }
}

template <typename T, typename I, bool VEC>
int launch(const void* points, long long n_rows, int d, const void* queries,
           const void* ids, long long ids_stride, int width, int block,
           const void* norms, void* out, int q, int lanes, int tile_rows,
           int tiles, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(d) * sizeof(T) + 15) / 16 * 16;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rescore_kernel<T, I, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(q) * tiles);
  rescore_kernel<T, I, VEC><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(points), n_rows, d, static_cast<const T*>(queries),
      static_cast<const I*>(ids), ids_stride, width, block,
      static_cast<const T*>(norms), static_cast<T*>(out), lanes, tile_rows,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int launch_vec(int vec, const void* points, long long n_rows, int d,
               const void* queries, const void* ids, long long ids_stride,
               int width, int block, const void* norms, void* out, int q,
               int lanes, int tile_rows, int tiles, cudaStream_t stream) {
  return vec ? launch<T, I, true>(points, n_rows, d, queries, ids, ids_stride,
                                  width, block, norms, out, q, lanes,
                                  tile_rows, tiles, stream)
             : launch<T, I, false>(points, n_rows, d, queries, ids,
                                   ids_stride, width, block, norms, out, q,
                                   lanes, tile_rows, tiles, stream);
}

}  // namespace

extern "C" {

// Threads a block and rows a lane group keeps in flight.
void rescore_constants(int* threads, int* unroll) {
  *threads = THREADS;
  *unroll = UNROLL;
}

// points (n_rows, d) row-major, float32 (f64 = 0) or float64 (f64 = 1);
// queries (q, d) row-major of the same type; ids (q, width) int32 (i64 = 0)
// or int64 (i64 = 1), row i at ids + i * ids_stride; norms (n_rows,) of the
// points' type or null; out (q, width * block) row-major.  vec: d pieces
// of 16 bytes and points 16-byte aligned.  lanes a power of two up to 32;
// tile_rows a multiple of THREADS / lanes * UNROLL; q * tiles blocks.
int rescore_launch(int f64, int i64, int vec, const void* points,
                   long long n_rows, int d, const void* queries,
                   const void* ids, long long ids_stride, int width, int block,
                   const void* norms, void* out, int q, int lanes,
                   int tile_rows, int tiles, void* stream) {
  const int size = f64 ? 8 : 4;
  if (q < 1 || width < 1 || block < 1 || d < 0 || tiles < 1 ||
      tile_rows < 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      static_cast<long long>(width) * block > 0x7fffffffLL ||
      static_cast<long long>(q) * tiles > 0x7fffffffLL ||
      (vec && ((d * size) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(points) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return i64 ? launch_vec<double, long long>(vec, points, n_rows, d, queries,
                                               ids, ids_stride, width, block,
                                               norms, out, q, lanes, tile_rows,
                                               tiles, s)
               : launch_vec<double, int>(vec, points, n_rows, d, queries, ids,
                                         ids_stride, width, block, norms, out,
                                         q, lanes, tile_rows, tiles, s);
  return i64 ? launch_vec<float, long long>(vec, points, n_rows, d, queries,
                                            ids, ids_stride, width, block,
                                            norms, out, q, lanes, tile_rows,
                                            tiles, s)
             : launch_vec<float, int>(vec, points, n_rows, d, queries, ids,
                                      ids_stride, width, block, norms, out, q,
                                      lanes, tile_rows, tiles, s);
}

}  // extern "C"
