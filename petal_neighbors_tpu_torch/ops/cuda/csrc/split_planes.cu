// split_planes.cu — the tensor-core core's operands, split once into the
// piece planes it reads (knn_tc.cuh).
//
// No TPU kernel: the JAX kernels (petal_neighbors_tpu/ops/pallas/
// knn_kernel.py) hand f32 blocks to jnp.dot(precision=HIGHEST), whose
// six-pass bf16 split is the MXU's own.  On the card the split is ours:
// each f32 element x becomes three bf16 pieces, each rounded to nearest,
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (for a normal
// f32, hi + mid + lo == x exactly).  Until this kernel the core's threads
// split every operand chunk inside its product loop, the index's rows once
// per 128-query block; now an index splits its rows once at build and a
// call its queries once, and the core brings the finished planes into
// shared memory by bulk copies.
//
// Layout, for an f32 array (rows, d): 128-row tile (tc::TN) by 32-feature
// chunk (tc::DC), tile-major; each (tile, chunk) is tc::CHUNK_B = 24,576
// contiguous bytes, the hi, mid and lo planes of 8,192 bytes in that order,
// each in wgmma's canonical K-major 64-byte-swizzled order: row r's 16-byte
// segment j (features 8 j .. 8 j + 7 of the chunk, the lower feature at the
// lower address) at byte (r >> 3) * 512 + (r & 7) * 64 + ((j ^ ((r >> 1) &
// 3)) << 4), which is plane_off below.  Rows past `rows` and features past
// d are zero.
//
// What bounds it: bytes, 4 read and 6 written an element, once (SIFT's 1M x
// 128 index 1.28 GB, about 0.4 ms at 3.35 TB/s).  Each thread reads 8
// features of one row (two 16-byte loads where the row allows them) and
// writes three 16-byte pieces; a warp's stores fill one 512-byte swizzle
// group of each plane.
//
// The C entry points return the launch's cudaGetLastError().

#include <cuda_bf16.h>

#include "knn_tc.cuh"

namespace {

// a thread splits 8 features (16 bytes of a piece) of a row
constexpr int SPLIT_THREADS = tc::TN * tc::DC / 8;

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

// Byte offset of (row, 16-byte segment seg) in a piece plane: the
// canonical K-major layout in the 64-byte swizzle.
__device__ __forceinline__ int plane_off(int row, int seg) {
  return (row >> 3) * tc::GROUP_B + (row & 7) * tc::ROW_B +
         ((seg ^ ((row >> 1) & 3)) << 4);
}

// grid = (tiles, chunks): block (t, c) splits rows [TN t, + TN) and
// features [DC c, + DC) of src (rows, d) into the chunk's CHUNK_B bytes at
// planes + (t * chunks + c) * CHUNK_B (tc's sizes).  Thread i: segment
// i & 3 of row i >> 2.  VEC: d % 4 == 0 and src 16-byte aligned (16-byte
// loads).
template <bool VEC>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const float* __restrict__ src, long long rows, int d,
             char* __restrict__ planes) {
  const int tid = threadIdx.x;
  const int row = tid >> 2, seg = tid & 3;
  const long long r = static_cast<long long>(blockIdx.x) * tc::TN + row;
  const int k0 = blockIdx.y * tc::DC + seg * 8;
  const float* p = src + r * d + k0;
  float v[8];
  if constexpr (VEC) {
    // d % 4 == 0: each half is all in or all out
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a = r < rows && k0 + 4 <= d
                         ? __ldg(reinterpret_cast<const float4*>(p)) : z;
    const float4 b = r < rows && k0 + 8 <= d
                         ? __ldg(reinterpret_cast<const float4*>(p) + 1) : z;
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = (r < rows && k0 + i < d) ? __ldg(p + i) : 0.f;
  }
  uint4 h, m, l;
  split2(v[0], v[1], h.x, m.x, l.x);
  split2(v[2], v[3], h.y, m.y, l.y);
  split2(v[4], v[5], h.z, m.z, l.z);
  split2(v[6], v[7], h.w, m.w, l.w);
  char* out = planes +
              (static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y) *
                  tc::CHUNK_B +
              plane_off(row, seg);
  *reinterpret_cast<uint4*>(out) = h;
  *reinterpret_cast<uint4*>(out + tc::PLANE_B) = m;
  *reinterpret_cast<uint4*>(out + 2 * tc::PLANE_B) = l;
}

}  // namespace

extern "C" {

// The layout's sizes: rows a tile, features a chunk, pieces an element and
// bytes of one (tile, chunk).
void split_planes_constants(int* tn, int* dc, int* pieces, int* chunk_b) {
  *tn = tc::TN;
  *dc = tc::DC;
  *pieces = tc::PIECES;
  *chunk_b = tc::CHUNK_B;
}

// src (rows, d) float32 row-major -> planes, ceil(rows / TN) x
// ceil(d / DC) x CHUNK_B bytes (tc's sizes), 16-byte aligned.  rows >= 1,
// d >= 1.
int split_planes_launch(const float* src, long long rows, int d, void* planes,
                        void* stream) {
  const long long tiles = (rows + tc::TN - 1) / tc::TN;
  if (rows < 1 || d < 1 || tiles > 0x7fffffffLL ||
      tc::chunks(d) > 65535 ||
      reinterpret_cast<uintptr_t>(planes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), tc::chunks(d));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* out = static_cast<char*>(planes);
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0)
    split_kernel<true><<<grid, SPLIT_THREADS, 0, s>>>(src, rows, d, out);
  else
    split_kernel<false><<<grid, SPLIT_THREADS, 0, s>>>(src, rows, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
