// knn_few.cu — exact k-NN for a few live queries in one pass over the index.
//
// Replaces no TPU kernel.  The TPU kernels run a query tile whatever the
// batch; on this card a single query (or the route's repair of one to a few
// uncovered queries) ran on kernels built for wide tiles: capped and bcap on
// the tensor-core product's 128 query rows (knn_tc.cuh), fold's streaming
// kernel on a 64-query SIMT tile over at most 64 row ranges, fold's select
// path in two product passes.  With one live query each of them sat about
// 10x over the least time the card needs to read the index once.  This
// kernel is knn_fold's path (knn_kernel.py) for the shapes where it is
// faster (knn_kernel.fold_path's "few", a rule read from a sweep on the
// card); the route takes fold at those shapes whatever scheme it picked,
// and fold's other paths keep every other shape.
//
// What it computes, fold's contract: for each query q and every point row x
//     u = ||x||^2 - 2 q.x
// in FP32 on the SIMT cores, each pair summed with fmaf over the features
// in ascending order from 0 (DotScore's order in knn_tiles.cuh), so that u
// is the streaming fold kernel's bit for bit; then the exact k smallest
// rows per query.  Output, per query:
//   out_d (k,)  u + ||q||^2 clamped at 0 (||q||^2 summed as knn_fold.cu's
//               output sums it), +inf in empty slots;
//   out_i (k,)  row ids, -1 in empty slots.
// Rows in no promised order.  Rows with +inf norms (NaN and padding rows)
// and a NaN query's NaN scores never enter.  Ties at the k-th value keep
// any of the tied ids.
//
// What bounds it: the index's bytes, read once (4*N*d; 3.84 GB at 1M x 960
// takes 1.146 ms at 3.35 TB/s).  The arithmetic, 2*Q*N*d FP32 FLOP, stays
// under that for up to 16 queries a pass (0.46 ms at 16 x 1M x 960 at 67
// TFLOP/s), and the tensor cores do not pay with 1 to 16 live rows.
//
// Design:
//   * grid = (splits, query groups of QG = 1, 2, 4, 8 or 16): each block
//     streams a contiguous range of tiles of TR = NT * RR rows, the ranges
//     filling the card's SMs (few_plan: every resident slot of every SM,
//     at least MIN_TILES tiles a range).  A group's queries (zero rows
//     past the last) stay resident in shared memory, read as broadcasts.
//   * rows come in chunks of DCF features (a tile's rows x one chunk is a
//     stage, its rows padded to DCF + 4 floats so that the float4 reads of
//     8 lanes hit distinct banks) through a ring of cp.async stages of
//     16-byte copies (4-byte copies where d or the pointers are not
//     16-byte aligned), norms beside each tile's first chunk (rr_of,
//     stages_of and chunk_of set the shape by group).  Each thread owns RR rows of a tile and keeps QG x RR
//     sums in registers across the chunks: per 4 features one float4 of
//     each row and one broadcast float4 of each query, 4*QG*RR FMA.
//   * selection: each query keeps a buffer of (u, id) in shared memory
//     and a threshold, +inf at first.  After each tile, in rounds of one
//     candidate a thread, a candidate under the threshold is appended (one
//     shared atomic a warp).  When a buffer holds more than its keep width KW
//     (at least 2k) its warp selects the k smallest by bisection over the
//     ordered float bits, keeps them in place, and the k-th becomes the
//     threshold; so only rows under a running k-th do any work past a
//     compare.  A range ends with its exact k smallest in part (splits, q,
//     k), (+inf, -1) where it had fewer.
//   * merge_kernel (one block a query) selects the exact k smallest of the
//     splits x k entries by a radix select on the ordered bits, four 8-bit
//     passes with warp-aggregated histogram counts, and writes the
//     outputs.
//
// The C entry points return a cudaError_t; the launch returns
// cudaGetLastError() right after its two launches.

#include "knn_tiles.cuh"

namespace {
namespace few {

constexpr int NT = 128;                    // threads a scan block
constexpr int NW = NT / 32;
constexpr int QG_MAX = 16;                 // queries a group
constexpr int K_MAX = 128;
constexpr int MIN_TILES = 4;               // tiles a range, at least
constexpr int MERGE_NT = 256;
static_assert(MERGE_NT == 256, "one histogram bin a thread");

// The scan's shape by group (measured on an H100 at 1M x 128 and 1M x
// 960): rows a thread, 1 to 4 as the group widens so that each broadcast
// query float4 serves more rows; two stages of 64 KB (rows x chunk), whose
// row segments of 512, 256 and 128 bytes read the index near its byte
// rate (64-byte segments took 40% longer at 8 queries x 960); at 16
// queries three stages of 32 KB, so that the resident queries (61 KB at
// d = 960) still fit.
__host__ __device__ constexpr int rr_of(int qg) {
  return qg >= 8 ? 4 : (qg >= 4 ? 2 : 1);
}
__host__ __device__ constexpr int stages_of(int qg) {
  return qg >= 16 ? 3 : 2;
}
__host__ __device__ constexpr int chunk_of(int qg) {   // features a chunk
  return (qg >= 16 ? 8192 : 16384) / (NT * rr_of(qg));
}
// the smallest power of two >= min(q, QG_MAX)
__host__ __device__ inline int group_of(int q) {
  int g = 1;
  while (g < q && g < QG_MAX) g <<= 1;
  return g;
}
// keep width: a compaction runs once a buffer holds more
__host__ __device__ inline int keep_of(int k) {
  const int w = 2 * k > 64 ? 2 * k : 64;
  return (w + 31) & ~31;
}

size_t smem_bytes(int qg, int d, int k) {
  const int tr = NT * rr_of(qg);
  const int dsf = chunk_of(qg) + 4;
  const int dq = (d + 3) & ~3;
  const int cap = keep_of(k) + NT;   // a round appends at most NT a query
  return sizeof(float) * (static_cast<size_t>(stages_of(qg)) * tr * (dsf + 1) +
                          static_cast<size_t>(qg) * dq) +
         8 * static_cast<size_t>(qg) * (cap + 1);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Select the k smallest of the m > k entries of one query's buffer (u, id)
// in place, by one warp: T, the k-th smallest ordered key, by bisection
// between the least and the largest; then the entries under T and the
// first k - (count under T) equal to it, in buffer order.  Returns T's
// float, the new threshold.
__device__ float compact(float* bu, int* bi, int m, int k, int lane) {
  unsigned lo = 0xffffffffu, hi = 0;
  for (int e = lane; e < m; e += 32) {
    const unsigned key = order_bits(bu[e]);
    lo = key < lo ? key : lo;
    hi = key > hi ? key : hi;
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  while (lo < hi) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    unsigned c = 0;
    for (int e = lane; e < m; e += 32) c += order_bits(bu[e]) <= mid;
    c = __reduce_add_sync(FULL, c);
    if (c >= static_cast<unsigned>(k)) hi = mid; else lo = mid + 1;
  }
  const unsigned t = lo;
  unsigned below = 0;
  for (int e = lane; e < m; e += 32) below += order_bits(bu[e]) < t;
  const int need_eq = k - static_cast<int>(__reduce_add_sync(FULL, below));
  const unsigned before = (1u << lane) - 1u;
  int w = 0, eq_seen = 0;
  for (int base = 0; base < m; base += 32) {
    const int e = base + lane;
    const bool ok = e < m;
    const float u = ok ? bu[e] : 0.f;
    const int id = ok ? bi[e] : -1;
    const unsigned key = order_bits(u);
    const bool eq = ok && key == t;
    const unsigned meq = __ballot_sync(FULL, eq);
    const bool keep = (ok && key < t) ||
                      (eq && eq_seen + __popc(meq & before) < need_eq);
    const unsigned mk = __ballot_sync(FULL, keep);
    __syncwarp();
    if (keep) {
      const int p = w + __popc(mk & before);
      bu[p] = u;
      bi[p] = id;
    }
    w += __popc(mk);
    eq_seen += __popc(meq);
    __syncwarp();
  }
  return from_order_bits(t);
}

// Append (u, id) to query j's buffer where `pass`; every lane of the warp
// calls this with the same j.
__device__ __forceinline__ void offer(float* bu, int* bi, int* cnt, bool pass,
                                      float u, int id, int lane) {
  const unsigned m = __ballot_sync(FULL, pass);
  if (m == 0) return;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt, __popc(m));
  base = __shfl_sync(FULL, base, leader);
  if (pass) {
    const int p = base + __popc(m & ((1u << lane) - 1u));
    bu[p] = u;
    bi[p] = id;
  }
}

// grid = (splits, ceil(q / QG)); block (s, g) scans tiles [s * per, (s + 1)
// * per) of TR rows for queries [g * QG, g * QG + QG) and writes their k
// smallest (u, id) of the range to part_u / part_i (splits, q, k).
template <int QG, bool VEC>
__global__ void __launch_bounds__(NT)
scan_kernel(const float* __restrict__ points, const float* __restrict__ queries,
            const float* __restrict__ norms, float* __restrict__ part_u,
            int* __restrict__ part_i, long long n, int q, int d, int k,
            long long per) {
  constexpr int RR = rr_of(QG);
  constexpr int TR = NT * RR;
  constexpr int DCF = chunk_of(QG);
  constexpr int STAGES = stages_of(QG);
  constexpr int DSF = DCF + 4;
  static_assert(DCF % 4 == 0 && DCF >= 4, "chunk of whole float4s");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [STAGES][TR][DSF]
  float* xnr = ring + STAGES * TR * DSF;            // [STAGES][TR]
  float* qs = xnr + STAGES * TR;                    // [QG][dq]
  const int dq = (d + 3) & ~3;
  const int kw = keep_of(k);
  const int cap = kw + NT;
  float* bu = qs + QG * dq;                         // [QG][cap]
  int* bi = reinterpret_cast<int*>(bu + QG * cap);  // [QG][cap]
  int* cnt = bi + QG * cap;                         // [QG]
  float* thr = reinterpret_cast<float*>(cnt + QG);  // [QG]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int g0 = blockIdx.y * QG;
  const int live = min(QG, q - g0);
  const long long ntiles = (n + TR - 1) / TR;
  const long long t_begin = min(ntiles, per * split);
  const long long t_end = min(ntiles, t_begin + per);
  const int nch = (d + DCF - 1) / DCF;
  const long long steps = (t_end - t_begin) * nch;

  // the group's queries, resident; zero past d and past the last query
  if (VEC) {
    const int per_row = dq >> 2;
    for (int idx = tid; idx < QG * per_row; idx += NT) {
      const int j = idx / per_row;
      const int c = (idx - j * per_row) << 2;
      const bool ok = j < live;
      cp_async16(qs + j * dq + c,
                 ok ? queries + static_cast<long long>(g0 + j) * d + c
                    : queries, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < QG * dq; idx += NT) {
      const int j = idx / dq;
      const int c = idx - j * dq;
      const bool ok = j < live && c < d;
      cp_async4(qs + idx,
                ok ? queries + static_cast<long long>(g0 + j) * d + c
                   : queries, ok ? 4 : 0);
    }
  }
  for (int j = tid; j < QG; j += NT) {
    cnt[j] = 0;
    thr[j] = INFINITY;
  }

  // stage step s (tile t_begin + s / nch, chunk s % nch) into its slot
  auto issue = [&](long long s) {
    if (s < steps) {
      const long long row0 = (t_begin + s / nch) * TR;
      const int c = static_cast<int>(s % nch);
      const int c0 = c * DCF;
      const int w = min(DCF, d - c0);
      const int slot = static_cast<int>(s % STAGES);
      float* dst = ring + slot * TR * DSF;
      if (VEC && w == DCF) {   // a full chunk: the copies step without a division
        constexpr int PER = DCF / 4;
#pragma unroll
        for (int it = 0; it < TR * PER / NT; ++it) {
          const int idx = tid + it * NT;
          const int r = idx / PER;
          const int cc = (idx % PER) << 2;
          const long long g = row0 + r;
          const bool ok = g < n;
          cp_async16(dst + r * DSF + cc, ok ? points + g * d + c0 + cc : points,
                     ok ? 16 : 0);
        }
      } else if (VEC) {
        const int per_row = w >> 2;
        for (int idx = tid; idx < TR * per_row; idx += NT) {
          const int r = idx / per_row;
          const int cc = (idx - r * per_row) << 2;
          const long long g = row0 + r;
          const bool ok = g < n;
          cp_async16(dst + r * DSF + cc, ok ? points + g * d + c0 + cc : points,
                     ok ? 16 : 0);
        }
      } else {
        const int wpad = (w + 3) & ~3;
        for (int idx = tid; idx < TR * wpad; idx += NT) {
          const int r = idx / wpad;
          const int cc = idx - r * wpad;
          const long long g = row0 + r;
          const bool ok = g < n && cc < w;
          cp_async4(dst + r * DSF + cc, ok ? points + g * d + c0 + cc : points,
                    ok ? 4 : 0);
        }
      }
      if (c == 0)
        for (int r = tid; r < TR; r += NT) {
          const long long g = row0 + r;
          cp_async4(xnr + slot * TR + r, g < n ? norms + g : norms,
                    g < n ? 4 : 0);
        }
    }
    cp_async_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  float acc[QG][RR];
  float xn[RR];
#pragma unroll
  for (int j = 0; j < QG; ++j)
#pragma unroll
    for (int i = 0; i < RR; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int i = 0; i < RR; ++i) xn[i] = 0.f;

  for (long long s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();    // step s landed; step s - 1's slot is free
    issue(s + STAGES - 1);
    const int slot = static_cast<int>(s % STAGES);
    const int c = static_cast<int>(s % nch);
    const int c0 = c * DCF;
    const int wpad = (min(DCF, d - c0) + 3) & ~3;
    const float* xs = ring + slot * TR * DSF;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < RR; ++i) xn[i] = xnr[slot * TR + tid + NT * i];
    }
    const float* qc = qs + c0;
#pragma unroll 2
    for (int f = 0; f < wpad; f += 4) {
      float4 xv[RR];
#pragma unroll
      for (int i = 0; i < RR; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (tid + NT * i) * DSF + f);
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qc + j * dq + f);
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          acc[j][i] = fmaf(qv.x, xv[i].x, acc[j][i]);
          acc[j][i] = fmaf(qv.y, xv[i].y, acc[j][i]);
          acc[j][i] = fmaf(qv.z, xv[i].z, acc[j][i]);
          acc[j][i] = fmaf(qv.w, xv[i].w, acc[j][i]);
        }
      }
    }
    if (c != nch - 1) continue;

    // ---- the tile's scores, offered in rounds of one a thread
    const long long row0 = (t_begin + s / nch) * TR;
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const long long row = row0 + tid + NT * i;
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        if (j >= live) break;
        const float u = row < n ? xn[i] - 2.f * acc[j][i] : INFINITY;
        offer(bu + j * cap, bi + j * cap, cnt + j, u < thr[j], u,
              static_cast<int>(row), lane);
      }
      __syncthreads();
      for (int j = warp; j < live; j += NW)
        if (cnt[j] > kw) {
          const float t = compact(bu + j * cap, bi + j * cap, cnt[j], k,
                                  lane);
          if (lane == 0) {
            cnt[j] = k;
            thr[j] = t;
          }
        }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < QG; ++j)
#pragma unroll
      for (int i = 0; i < RR; ++i) acc[j][i] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- the range's k smallest, (+inf, -1) past its count
  for (int j = warp; j < live; j += NW) {
    int m = cnt[j];
    if (m > k) {
      compact(bu + j * cap, bi + j * cap, m, k, lane);
      m = k;
    }
    const long long at =
        (static_cast<long long>(split) * q + g0 + j) * k;
    for (int e = lane; e < k; e += 32) {
      part_u[at + e] = e < m ? bu[j * cap + e] : INFINITY;
      part_i[at + e] = e < m ? bi[j * cap + e] : -1;
    }
  }
}

// grid = (q,): query blockIdx.x's exact k smallest of its splits x k
// entries (radix select on the ordered bits, 8 bits a pass), written with
// rd = max(u + ||q||^2, 0).
__global__ void __launch_bounds__(MERGE_NT)
merge_kernel(const float* __restrict__ part_u, const int* __restrict__ part_i,
             const float* __restrict__ queries, float* __restrict__ out_d,
             int* __restrict__ out_i, int q, int d, int k, int splits) {
  __shared__ int hist[256];
  __shared__ unsigned s_prefix, s_mask;
  __shared__ int s_need, s_lt, s_eq;
  __shared__ float s_qn;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = blockIdx.x;
  const int m = splits * k;
  const long long stride = static_cast<long long>(q) * k;
  auto entry = [&](int e) {
    const int s = e / k;
    return s * stride + static_cast<long long>(gq) * k + (e - s * k);
  };
  if (tid == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_need = k;
    s_lt = 0;
    s_eq = 0;
  }
  if (tid < 32) {   // ||q||^2 as knn_fold.cu's output sums it
    const float* qrow = queries + static_cast<long long>(gq) * d;
    float qn = 0.f;
    for (int f = lane; f < d; f += 32) qn = fmaf(qrow[f], qrow[f], qn);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) qn += __shfl_xor_sync(FULL, qn, off);
    if (lane == 0) s_qn = qn;
  }
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;
    __syncthreads();
    const unsigned prefix = s_prefix, mask = s_mask;
    for (int base = 0; base < m; base += MERGE_NT) {
      const int e = base + tid;
      int bin = -1;
      if (e < m) {
        const unsigned key = order_bits(__ldcg(part_u + entry(e)));
        if ((key & mask) == prefix) bin = static_cast<int>((key >> shift) & 255u);
      }
      const unsigned peers = __match_any_sync(FULL, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {   // the bin holding the need-th smallest
      int c[8], sum = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        c[b] = hist[lane * 8 + b];
        sum += c[b];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += t;
      }
      const int need = s_need;
      const unsigned hit = __ballot_sync(FULL, incl >= need);
      if (lane == __ffs(hit) - 1) {
        int run = incl - sum;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (run + c[b] >= need) {
            s_prefix = prefix | (static_cast<unsigned>(lane * 8 + b) << shift);
            s_mask = mask | (255u << shift);
            s_need = need - run;
            break;
          }
          run += c[b];
        }
      }
    }
    __syncthreads();
  }
  const unsigned t = s_prefix;
  const int need_eq = s_need;
  const int n_lt = k - need_eq;
  const float qn = s_qn;
  float* od = out_d + static_cast<long long>(gq) * k;
  int* oi = out_i + static_cast<long long>(gq) * k;
  for (int e = tid; e < m; e += MERGE_NT) {
    const float u = __ldcg(part_u + entry(e));
    const unsigned key = order_bits(u);
    int p = -1;
    if (key < t) {
      p = atomicAdd(&s_lt, 1);
    } else if (key == t) {
      const int r = atomicAdd(&s_eq, 1);
      if (r < need_eq) p = n_lt + r;
    }
    if (p >= 0) {
      const int id = __ldcg(part_i + entry(e));
      const float rd = u + qn;
      od[p] = id < 0 ? INFINITY : (rd < 0.f ? 0.f : rd);
      oi[p] = id;
    }
  }
}

template <int QG>
cudaError_t set_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<QG, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(scan_kernel<QG, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int QG>
cudaError_t occupancy(size_t smem, int* per_sm) {
  cudaError_t err = set_smem<QG>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, scan_kernel<QG, true>, NT, smem);
}

cudaError_t set_smem_of(int qg, size_t smem) {
  switch (qg) {
    case 1: return set_smem<1>(smem);
    case 2: return set_smem<2>(smem);
    case 4: return set_smem<4>(smem);
    case 8: return set_smem<8>(smem);
    default: return set_smem<16>(smem);
  }
}

cudaError_t occupancy_of(int qg, size_t smem, int* per_sm) {
  switch (qg) {
    case 1: return occupancy<1>(smem, per_sm);
    case 2: return occupancy<2>(smem, per_sm);
    case 4: return occupancy<4>(smem, per_sm);
    case 8: return occupancy<8>(smem, per_sm);
    default: return occupancy<16>(smem, per_sm);
  }
}

template <int QG>
void scan(bool vec, dim3 grid, size_t smem, cudaStream_t s,
          const float* points, const float* queries, const float* norms,
          float* part_u, int* part_i, long long n, int q, int d, int k,
          long long per) {
  if (vec)
    scan_kernel<QG, true><<<grid, NT, smem, s>>>(
        points, queries, norms, part_u, part_i, n, q, d, k, per);
  else
    scan_kernel<QG, false><<<grid, NT, smem, s>>>(
        points, queries, norms, part_u, part_i, n, q, d, k, per);
}

void scan_of(int qg, bool vec, dim3 grid, size_t smem, cudaStream_t s,
             const float* points, const float* queries, const float* norms,
             float* part_u, int* part_i, long long n, int q, int d, int k,
             long long per) {
  switch (qg) {
    case 1: scan<1>(vec, grid, smem, s, points, queries, norms, part_u,
                    part_i, n, q, d, k, per); break;
    case 2: scan<2>(vec, grid, smem, s, points, queries, norms, part_u,
                    part_i, n, q, d, k, per); break;
    case 4: scan<4>(vec, grid, smem, s, points, queries, norms, part_u,
                    part_i, n, q, d, k, per); break;
    case 8: scan<8>(vec, grid, smem, s, points, queries, norms, part_u,
                    part_i, n, q, d, k, per); break;
    default: scan<16>(vec, grid, smem, s, points, queries, norms, part_u,
                      part_i, n, q, d, k, per);
  }
}

}  // namespace few
}  // namespace

extern "C" {

// The largest k.
int few_k_max() { return few::K_MAX; }

// The launch plan: rows a tile, the row ranges (splits) and the scan
// block's shared memory for n rows, q queries, width d and k.  Returns
// cudaErrorInvalidValue where the shape is out of range or the block's
// shared memory exceeds the card's opt-in limit.
int few_plan(long long n, int q, int d, int k, int* tile_rows, int* splits,
             int* smem) {
  if (n < 1 || n >= (1ll << 31) || q < 1 || d < 1 || k < 1 ||
      k > few::K_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, optin = 0;
  cudaError_t err = card_limits(&sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qg = few::group_of(q);
  const size_t bytes = few::smem_bytes(qg, d, k);
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  err = few::occupancy_of(qg, bytes, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tr = few::NT * few::rr_of(qg);
  const long long ntiles = (n + tr - 1) / tr;
  long long s = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long most = ntiles / few::MIN_TILES;
  s = s > most ? most : s;
  s = s < 1 ? 1 : s;
  const long long per = (ntiles + s - 1) / s;
  *splits = static_cast<int>((ntiles + per - 1) / per);  // none empty
  *tile_rows = tr;
  *smem = static_cast<int>(bytes);
  return 0;
}

// points (n, d), queries (q, d), norms (n,) float32 row-major; scratch
// part_u (splits, q, k) float32 and part_i (splits, q, k) int32; outputs
// out_d (q, k) float32 and out_i (q, k) int32.  splits as few_plan
// returned it for the same n, q, d and k.  Two launches on `stream`: the
// scan, then the merge.
int few_launch(const float* points, const float* queries, const float* norms,
               float* part_u, int* part_i, float* out_d, int* out_i,
               long long n, int q, int d, int k, int splits, void* stream) {
  if (n < 1 || n >= (1ll << 31) || q < 1 || d < 1 || k < 1 ||
      k > few::K_MAX || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qg = few::group_of(q);
  const size_t smem = few::smem_bytes(qg, d, k);
  cudaError_t err = few::set_smem_of(qg, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tr = few::NT * few::rr_of(qg);
  const long long ntiles = (n + tr - 1) / tr;
  const long long per = (ntiles + splits - 1) / splits;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(splits, (q + qg - 1) / qg);
  few::scan_of(qg, vec, grid, smem, s, points, queries, norms, part_u, part_i,
               n, q, d, k, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  few::merge_kernel<<<q, few::MERGE_NT, 0, s>>>(part_u, part_i, queries,
                                                out_d, out_i, q, d, k,
                                                splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
