// row_sort.cu — row sorts of (f32 key, int32 payload) pairs, one block per
// row, for the large-k re-rank.
//
// Replaces two kernels of petal_neighbors_tpu/ops/pallas/:
//   bitonic_sort  sort_kernel.py _sort_kernel (:36, bitonic_sort_pairs :70):
//                 the classic bitonic network over the row padded to a
//                 power of two with (+inf, -1).
//   rank_sort     rank_sort_kernel.py _rank_sort_kernel (:48,
//                 rank_sort_pairs :107): counting rank,
//                     rank[i] = #{j : key_j < key_i or (key_j == key_i and j < i)}
//                 then out[rank[i]] = (key_i, val_i).
//
// Contract (both): keys are NaN-free; each row sorts ascending by key and
// the payload follows its key.  Both order ties by input position, so the
// output equals a stable sort bit for bit.  The bitonic network compares
// (key, position) with the key mapped to an order-preserving unsigned
// integer (-0.0 taken as +0.0, so it ties with +0.0 as `<` says), packed
// into one 64-bit word: the network then moves 8 bytes per element
// (2048 x 8 B = 16 KB of shared memory at width 2048) and the payload and
// key are gathered from the input by position at the end.  Its padding
// carries positions past the row, so it sorts after every real element,
// +inf keys included, and is never written.  The counting rank needs no
// padding: ranks of the row's own elements form a permutation of
// [0, width), so the scatter has no collisions.  The TPU kernel's padding
// to 128 lanes has no counterpart.
//
// What bounds them on this card: bytes.  Each row is read once and written
// once (8 bytes per element each way); the network's log2(S)(log2(S)+1)/2
// stages and the rank's width^2 compares run in shared memory and
// registers.  Neither is near that bound in this first version: the rank
// sort does width^2 compares per row (one block per row, each thread
// holding up to 32 elements in registers and reading the row from shared
// memory as broadcasts, one compare and one add per pair), the network
// one __syncthreads per stage.
//
// The C entry points return cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WIDTH = 8192;      // 64 KB of packed words per row
constexpr int RANK_THREADS = 256;

// f32 -> unsigned with the same order for non-NaN values; -0.0 maps as
// +0.0 and +inf above every finite value.
__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// grid = rows; block = min(S / 2, 1024) threads; S = power of two >= width.
__global__ void bitonic_sort_kernel(const float* __restrict__ keys,
                                    const int* __restrict__ vals,
                                    float* __restrict__ out_k,
                                    int* __restrict__ out_v, int width,
                                    int S) {
  extern __shared__ unsigned long long w[];
  const long long row = blockIdx.x;
  const float* kr = keys + row * width;
  const int* vr = vals + row * width;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    // padding: +inf above every real key, positions past the row
    const unsigned kb = i < width ? order_bits(kr[i]) : 0xffffffffu;
    w[i] = (static_cast<unsigned long long>(kb) << 32) | static_cast<unsigned>(i);
  }
  __syncthreads();
  for (int size = 2; size <= S; size <<= 1) {
    for (int s = size >> 1; s > 0; s >>= 1) {
      for (int t = threadIdx.x; t < (S >> 1); t += blockDim.x) {
        const int i = 2 * s * (t / s) + (t % s);
        const int j = i + s;
        const unsigned long long a = w[i], b = w[j];
        const bool asc = (i & size) == 0;
        if ((b < a) == asc) {
          w[i] = b;
          w[j] = a;
        }
      }
      __syncthreads();
    }
  }
  float* ok = out_k + row * width;
  int* ov = out_v + row * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const int src = static_cast<int>(w[i] & 0xffffffffu);
    ok[i] = kr[src];
    ov[i] = vr[src];
  }
}

// Add to rank[r] the count of j in [j0, j1) with kb[j] < thr[r].
template <int PER>
__device__ __forceinline__ void count_below(const unsigned* kb, int j0,
                                            int j1, const unsigned (&thr)[PER],
                                            int (&rank)[PER]) {
  for (int j = j0; j < j1; ++j) {
    const unsigned x = kb[j];
#pragma unroll
    for (int r = 0; r < PER; ++r) rank[r] += x < thr[r];
  }
}

// grid = rows; block = RANK_THREADS; PER * RANK_THREADS >= width.  Thread
// t ranks elements i = t + r * RANK_THREADS (r < PER) of the row against
// the whole row in shared memory, held as order bits, so that
//     j before i  <=>  kb[j] < kb[i] + (j < i)
// (kb[i] + 1 cannot wrap: +inf maps below 0xffffffff).  Every thread reads
// the same kb[j] at once (a broadcast).  Within the row's block rb of
// RANK_THREADS keys, j < i is fixed for r != rb, and for r == rb it is
// fixed below and above the thread's own warp: only 32 of every
// RANK_THREADS keys need the per-thread test.
template <int PER>
__global__ void __launch_bounds__(RANK_THREADS)
rank_sort_kernel(const float* __restrict__ keys, const int* __restrict__ vals,
                 float* __restrict__ out_k, int* __restrict__ out_v,
                 int width) {
  extern __shared__ unsigned kb[];
  const long long row = blockIdx.x;
  const float* kr = keys + row * width;
  const int tid = threadIdx.x;
  for (int i = tid; i < width; i += RANK_THREADS) kb[i] = order_bits(kr[i]);
  __syncthreads();
  unsigned lo[PER], hi[PER], thr[PER];
  int rank[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int i = tid + r * RANK_THREADS;
    lo[r] = i < width ? kb[i] : 0u;
    hi[r] = lo[r] + 1u;
    rank[r] = 0;
  }
  const int w0 = tid & ~31;                 // this warp's first thread
  for (int jb = 0, rb = 0; jb < width; jb += RANK_THREADS, ++rb) {
    const int jend = min(width, jb + RANK_THREADS);
    // keys of this block below the warp: j < i unless r < rb
#pragma unroll
    for (int r = 0; r < PER; ++r) thr[r] = rb <= r ? hi[r] : lo[r];
    count_below<PER>(kb, jb, min(jend, jb + w0), thr, rank);
    // the warp's own 32 keys: per thread where r == rb
    for (int j = jb + w0; j < min(jend, jb + w0 + 32); ++j) {
      const unsigned x = kb[j];
      const bool below = j - jb < tid;
#pragma unroll
      for (int r = 0; r < PER; ++r)
        rank[r] += x < ((rb < r || (rb == r && below)) ? hi[r] : lo[r]);
    }
    // keys above the warp: j < i only if r > rb
#pragma unroll
    for (int r = 0; r < PER; ++r) thr[r] = rb < r ? hi[r] : lo[r];
    count_below<PER>(kb, min(jend, jb + w0 + 32), jend, thr, rank);
  }
  float* ok = out_k + row * width;
  int* ov = out_v + row * width;
  const int* vr = vals + row * width;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int i = tid + r * RANK_THREADS;
    if (i < width) {
      ok[rank[r]] = kr[i];
      ov[rank[r]] = vr[i];
    }
  }
}

template <int PER>
cudaError_t rank_launch(const float* keys, const int* vals, float* out_k,
                        int* out_v, long long rows, int width,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(width) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      rank_sort_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rank_sort_kernel<PER><<<static_cast<unsigned>(rows), RANK_THREADS, smem,
                          stream>>>(keys, vals, out_k, out_v, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest row either sort takes.
int row_sort_max_width() { return MAX_WIDTH; }

// keys (rows, width) float32, vals (rows, width) int32, row-major; outputs
// of the same shapes, not aliasing the inputs.  1 <= width <= MAX_WIDTH.
// Returns the launch's cudaError_t (0 on success).
int bitonic_sort_launch(const float* keys, const int* vals, float* out_k,
                        int* out_v, long long rows, int width, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || width < 1 || width > MAX_WIDTH)
    return static_cast<int>(cudaErrorInvalidValue);
  int S = 2;
  while (S < width) S <<= 1;
  const size_t smem = static_cast<size_t>(S) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = S / 2 < 32 ? 32 : (S / 2 > 1024 ? 1024 : S / 2);
  bitonic_sort_kernel<<<static_cast<unsigned>(rows), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      keys, vals, out_k, out_v, width, S);
  return static_cast<int>(cudaGetLastError());
}

int rank_sort_launch(const float* keys, const int* vals, float* out_k,
                     int* out_v, long long rows, int width, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || width < 1 || width > MAX_WIDTH)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // elements per thread: the fewest of 4, 8, 12, 16, 32 that cover the row
  const int per = (width + RANK_THREADS - 1) / RANK_THREADS;
  cudaError_t err =
      per <= 4    ? rank_launch<4>(keys, vals, out_k, out_v, rows, width, s)
      : per <= 8  ? rank_launch<8>(keys, vals, out_k, out_v, rows, width, s)
      : per <= 12 ? rank_launch<12>(keys, vals, out_k, out_v, rows, width, s)
      : per <= 16 ? rank_launch<16>(keys, vals, out_k, out_v, rows, width, s)
                  : rank_launch<32>(keys, vals, out_k, out_v, rows, width, s);
  return static_cast<int>(err);
}

}  // extern "C"
