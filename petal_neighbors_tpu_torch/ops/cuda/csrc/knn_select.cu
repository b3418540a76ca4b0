// knn_select.cu — the Euclidean merge: the exact k smallest (u, id) per
// query for k up to 4096, sorted, by radix select on the split-bf16
// tensor-core product (knn_tc.cuh).  Also the product's probe entry, and
// fold's select path: the same passes on fold's FP32 SIMT product.
//
// fold's select path replaces _knn_kernel (+ _fold_min) of
// petal_neighbors_tpu/ops/pallas/knn_kernel.py (:186, :97) for the batches
// the route gives fold at 1M rows: the repair of a few queries over the
// whole index.  knn_fold.cu's streaming fold runs them as one or three
// query tiles over at most 64 row ranges (64 blocks on 132 SMs), re-finds
// a working set's maximum after every insertion, and folds the ranges'
// sets in one block per query tile: 72.04 ms for 56 queries at k = 1008
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py), 340 times its bound.  Here the same u (fold_pass_kernel:
// scan_tiles with DotScore, bit for bit knn_fold.cu's) goes through the
// radix select below over up to FP32_MAX_SPLITS ranges, and
// fold_out_kernel adds ||q||^2 as knn_fold.cu does.  The host
// (knn_kernel.py's fold_path) sends large batches to the streaming kernel,
// where two product passes cost more than fold's one.
//
// Replaces _knn_kernel_merge + _bitonic_merge_sorted of
// petal_neighbors_tpu/ops/pallas/knn_kernel.py (:336, :287), as
// knn_pallas(scheme="merge") serves it at "highest": each query keeps a
// sorted working set that every tile's survivors are merged into.  The
// first port (knn_tiles.cuh's knn_merge_kernel, still the Lp kernel's) did
// the same with 128-slot shared-memory buffers streamed through a sorted
// set in global memory: hundreds of flushes a query at k = 3072, each a
// chain of dependent steps on one half-warp, 63-73% of its time.  This
// design selects instead of merging, and what it keeps per query is a
// handful of counters until the very end.
//
// Words.  Each (u, row) with finite u is the 64-bit word
// (order_bits(u) << 32) | row, distinct within a query (rows are), so
// "the k smallest words" is exactly the k smallest (u, id) in (u, id)
// order, ties included.  NaN and +inf u (NaN queries, NaN and padding
// rows) make no word, so they never count: a NaN query returns (+inf, -1)
// and k beyond the finite rows gives a (+inf, -1) tail, as the plain
// version's running top-k does.  The product gives the same u bits on every
// pass (knn_tc.cuh), so a word is the same on every pass.
//
// Passes (each "product pass" recomputes the tile product over all rows):
//   1. minima (product pass): the least word of every group of G rows
//      (G a power of two, 16 to 128, chosen by the host so that there are
//      at least 1.5 k groups where it can), into a (Q, groups) matrix.
//   2. bound: per query, by radix select over its group minima (8 digits
//      of 8 bits, from global memory), hi = the k-th smallest minimum and
//      lo = the least one.  k distinct words lie at or below hi, so the
//      k-th smallest word does too.  On uniform data about
//      1.4 k words lie at or below hi (at G = 128 and 1M rows, up to 1.45 k
//      for k = 4096); with many equal u about k G.
//   3. collect (product pass): every word w <= hi of the query goes to its
//      list (an atomic count per query, a warp's appends aggregated by one
//      atomic), while it has room (width W = min(8192, k + max(k, 1024)));
//      every word in [lo, hi] also counts in the query's 256-bin histogram
//      of (w - lo) >> shift.
//   4. pick: a query whose count of words <= hi fits W is done: its list
//      holds every word <= hi, so its k smallest.  Otherwise the bin that
//      holds its k-th word becomes [lo, hi] (the counts below it are added
//      to `below`), shift drops by 8 and 3-4 repeat for the open queries
//      only (a block whose 128 queries are all done returns at once).  A bin
//      of one word is always done, so this ends within 8 collect passes;
//      on random data after the first.  The host reads one flag per pass.
//   5. one launch of row_sort.cu's block sort on the words of the lists
//      (word_sort_launch), the first k kept.
// Histograms and lists live in global memory: a query's atomics are only
// those of its words at or below hi, about 1.4 k per pass.  The passes read
// the product's u tile cheaply: the minima in f32 (a shuffle reduction and
// a ballot for the group's first column), and collect tests each u against
// the query's f32 image of hi first (one compare and a warp vote), making
// words only for the few that pass.  (Making a 64-bit word of every u
// cost a large share of a pass in the first version.)
//
// What bounds it on this card: the tile product, 6 * 2*Q*N*d FLOP per
// product pass at 989 TFLOP/s bf16 (3.18 ms a pass at 2,048 queries x 1M x
// 128); two passes on random data.  Row ranges split the grid as in
// knn_fold.cu (choose_splits), the query tiles of one range running
// together so that they share its rows in L2; nothing depends on the
// split.
//
// The C entry points return the launch's cudaGetLastError().

#include "knn_tc.cuh"

namespace {

typedef unsigned long long word_t;

constexpr int BINS = 256;
constexpr int MAX_LIST = 8192;       // row_sort.cu's widest row
constexpr word_t NONE = ~0ull;       // above every word
constexpr int PASS_MINIMA = 0;
constexpr int PASS_COLLECT = 1;
// fold's select path splits a batch of few query tiles over up to about
// four times the card's 132 SMs (MIN_TILES_PER_SPLIT still holds)
constexpr int FP32_MAX_SPLITS = 512;

__device__ __forceinline__ word_t make_word(float u, long long row) {
  return (static_cast<word_t>(order_bits(u == 0.f ? 0.f : u)) << 32) |
         static_cast<unsigned>(row);
}

__device__ __forceinline__ word_t wmin(word_t a, word_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int bit_length(word_t x) {
  return x ? 64 - __clzll(static_cast<long long>(x)) : 0;
}

// The block's range of 128-row tiles: [r_begin, r_end) in rows.
__device__ __forceinline__ void tile_range(long long n, int splits,
                                           long long& r_begin,
                                           long long& r_end) {
  const long long ntiles = (n + tc::TN - 1) / tc::TN;
  const long long per = (ntiles + splits - 1) / splits;
  const long long t0 = min(ntiles, per * blockIdx.y);
  r_begin = t0 * tc::TN;
  r_end = min(ntiles, t0 + per) * tc::TN;
}

// grid = (ceil(q / TQ), splits).
// PASS_MINIMA: minima (q, groups) <- the least word of each group of
//   2^glog rows (NONE for a group with no finite u).
// PASS_COLLECT: per query (lo, hi, shift, done): the words <= hi appended
//   to list (q, width) while pos < width, counted in cnt (q,); the words
//   in [lo, hi] counted in hist (q, BINS) at bin (w - lo) >> shift.
template <int PASS>
__global__ void __launch_bounds__(tc::THREADS, 1)
select_pass_kernel(const char* __restrict__ xplanes,
                   const char* __restrict__ qplanes,
                   const float* __restrict__ norms, long long n, int q,
                   int d, int splits, word_t* __restrict__ minima,
                   int groups, int glog, const word_t* __restrict__ lo,
                   const word_t* __restrict__ hi,
                   const int* __restrict__ shift,
                   const int* __restrict__ done, int* __restrict__ hist,
                   int* __restrict__ cnt, word_t* __restrict__ list,
                   int width) {
  extern __shared__ float4 smem4[];
  __shared__ word_t lo_s[tc::TQ], hi_s[tc::TQ];
  __shared__ int sh_s[tc::TQ];
  __shared__ float uhi_s[tc::TQ];   // the largest u a word <= hi can have
  __shared__ int open_s;
  float* smem = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * tc::TQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  if (PASS == PASS_COLLECT) {
    if (tid == 0) open_s = 0;
    __syncthreads();
    if (tid < tc::TQ) {
      const int gq = q0 + tid;
      const bool open = gq < q && !done[gq];
      // a done query or a row past q: the empty interval, nothing <= hi
      lo_s[tid] = open ? lo[gq] : NONE;
      hi_s[tid] = open ? hi[gq] : 0;
      sh_s[tid] = open ? shift[gq] : 0;
      const unsigned hb = open ? static_cast<unsigned>(hi[gq] >> 32) : 0u;
      uhi_s[tid] = !open ? -INFINITY
                   : hb >= order_bits(INFINITY) ? INFINITY
                                                : from_order_bits(hb);
      if (open) open_s = 1;
    }
    __syncthreads();
    if (!open_s) return;
  }

  long long r_begin, r_end;
  tile_range(n, splits, r_begin, r_end);

  tc::scan(xplanes, qplanes, norms, n, d, q0, r_begin, r_end, smem,
           [&](long long row0, int rows, const float* us) {
    if (PASS == PASS_MINIMA) {
      // warp w: query rows w, w + 16, ...; lane l: columns l + 32 j.  The
      // group minimum in f32 (NaN and +inf excluded), then its first
      // column by a ballot: the least word of the group
      const int gsz = 1 << glog;
      static_assert(tc::TN == 128, "four columns a lane");
      for (int r = warp; r < tc::TQ; r += tc::THREADS / 32) {
        float v[4], m[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          const float u = us[r * tc::US + c];
          v[j] = m[j] = (c < rows && u < INFINITY) ? u : INFINITY;
        }
        if (gsz >= 64) {
          m[0] = fminf(m[0], m[1]);
          m[2] = fminf(m[2], m[3]);
        }
        if (gsz >= 128) m[0] = fminf(m[0], m[2]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          if (o < gsz) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              m[j] = fminf(m[j], __shfl_xor_sync(FULL, m[j], o));
          }
        unsigned bal[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float gm = gsz >= 128 ? m[0] : (gsz >= 64 ? m[j & 2] : m[j]);
          bal[j] = __ballot_sync(FULL, v[j] < INFINITY && v[j] == gm);
        }
        const int gq = q0 + r;
        const unsigned seg =
            gsz >= 32 ? FULL : ((1u << gsz) - 1u) << (lane & ~(gsz - 1));
        const int span = gsz > 32 ? gsz / 32 : 1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          const long long g = (row0 + c) >> glog;
          if ((c & (gsz - 1)) || g >= groups || gq >= q) continue;
          word_t w = NONE;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const unsigned b = bal[jj] & seg;
            if (jj >= j && jj < j + span && b && w == NONE)
              w = make_word(m[j], row0 + 32 * jj + __ffs(b) - 1);
          }
          minima[static_cast<long long>(gq) * groups + g] = w;
        }
      }
    } else {
      // e = element (r, c) of the tile, row-major: a warp's 32 lanes are
      // 32 columns of one query row.  u above the query's f32 bound cannot
      // make a word <= hi: one compare and a vote for nearly every element
      for (int e = tid; e < tc::TQ * tc::TN; e += tc::THREADS) {
        const int r = e / tc::TN, c = e % tc::TN;
        const float u = us[r * tc::US + c];
        const bool cand = c < rows && u <= uhi_s[r] && u < INFINITY;
        if (!__any_sync(FULL, cand)) continue;
        word_t w = NONE;
        bool take = false;
        if (cand) {
          w = make_word(u, row0 + c);
          take = w <= hi_s[r];
        }
        const long long gq = q0 + r;
        if (take && w >= lo_s[r])
          atomicAdd(hist + gq * BINS + static_cast<int>((w - lo_s[r]) >> sh_s[r]),
                    1);
        const unsigned bal = __ballot_sync(FULL, take);
        if (bal) {
          int base = 0;
          if (lane == 0) base = atomicAdd(cnt + gq, __popc(bal));
          base = __shfl_sync(FULL, base, 0);
          const int pos = base + __popc(bal & ((1u << lane) - 1u));
          if (take && pos < width) list[gq * width + pos] = w;
        }
      }
    }
  });
}

// The same two passes on fold's FP32 SIMT product (scan_tiles with
// DotScore, knn_tiles.cuh): TQ = 64 queries x TN = 64 rows a tile on
// THREADS = 256, u = ||x||^2 - 2 acc as knn_fold.cu's MODE_FOLD makes it,
// so every pass, and fold's streaming kernel, see the same u bits.  The
// passes read u straight from each thread's 4 x 4 register tile: lane xg of
// a half-warp holds rows xg + 16 i (i < 4) of its 4 queries rbase + j, so
// a group of G = 16, 32 or 64 rows (never more here: a group stays inside
// one 64-row tile, and so inside one block's range) is slot i, slots
// {0, 1} / {2, 3}, or all four slots of the half-warp's 16 lanes: its
// minimum is a shuffle reduction and its first row a ballot.  In collect a
// half-warp's appends for one query share one atomic.
// grid = (ceil(q / TQ), splits); ranges of whole 64-row tiles.
template <int PASS, bool VEC>
__global__ void __launch_bounds__(THREADS)
fold_pass_kernel(const float* __restrict__ points,
                 const float* __restrict__ queries,
                 const float* __restrict__ norms, long long n, int q, int d,
                 int splits, word_t* __restrict__ minima, int groups,
                 int glog, const word_t* __restrict__ lo,
                 const word_t* __restrict__ hi, const int* __restrict__ shift,
                 const int* __restrict__ done, int* __restrict__ hist,
                 int* __restrict__ cnt, word_t* __restrict__ list,
                 int width) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int qg = lane >> 4, xg = lane & 15;
  const int rbase = warp * 8 + qg * 4;
  const unsigned below = (1u << xg) - 1u;   // lanes under xg in its half

  // collect: this thread's 4 queries' intervals; a done query or a row
  // past q gets the empty interval (nothing <= hi)
  word_t lo_r[4], hi_r[4];
  int sh_r[4];
  float uhi_r[4];   // the largest u a word <= hi can have
  if (PASS == PASS_COLLECT) {
    bool open_any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gq = q0 + rbase + j;
      const bool open = gq < q && !done[gq];
      lo_r[j] = open ? lo[gq] : NONE;
      hi_r[j] = open ? hi[gq] : 0;
      sh_r[j] = open ? shift[gq] : 0;
      const unsigned hb = static_cast<unsigned>(hi_r[j] >> 32);
      uhi_r[j] = !open ? -INFINITY
                 : hb >= order_bits(INFINITY) ? INFINITY
                                              : from_order_bits(hb);
      open_any |= open;
    }
    if (!__syncthreads_or(open_any)) return;
  }

  const long long ntiles = (n + TN - 1) / TN;
  const long long per = (ntiles + splits - 1) / splits;
  const long long t_begin = min(ntiles, per * blockIdx.y);
  const long long t_end = min(ntiles, t_begin + per);
  const int gsz = 1 << glog;
  const int span = gsz / 16;   // slots a group takes: 1, 2 or 4

  const DotScore score{};
  scan_tiles<VEC>(points, queries, norms, n, q, d, q0, t_begin, t_end, smem,
                  score,
                  [&](long long t, const float* xnb, float (&acc)[4][4]) {
    const long long row0 = t * TN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gq = q0 + rbase + j;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float u = score.finish(acc[j][i], xnb[xg + 16 * i]);
        v[i] = u < INFINITY ? u : INFINITY;   // NaN and +inf: no word
      }
      if (PASS == PASS_MINIMA) {
        float m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = v[i];
        if (span >= 2) {
          m[0] = fminf(m[0], m[1]);
          m[2] = fminf(m[2], m[3]);
        }
        if (span >= 4) m[0] = fminf(m[0], m[2]);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i % span == 0)
              m[i] = fminf(m[i], __shfl_xor_sync(FULL, m[i], o));
        // the group's first row at its minimum: slots in order, then lanes
#pragma unroll
        for (int i0 = 0; i0 < 4; ++i0) {
          if (i0 % span) continue;
          const float gm = m[i0];
          int first = -1;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i < i0 || i >= i0 + span) continue;
            const unsigned mine =
                (__ballot_sync(FULL, v[i] < INFINITY && v[i] == gm) >>
                 (qg * 16)) & 0xffffu;
            if (first < 0 && mine) first = 16 * i + __ffs(mine) - 1;
          }
          const long long g = (row0 + 16 * i0) >> glog;
          if (xg == 0 && gq < q && g < groups)
            minima[gq * groups + g] =
                first < 0 ? NONE : make_word(gm, row0 + first);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool cand = v[i] <= uhi_r[j] && v[i] < INFINITY;
          if (!__any_sync(FULL, cand)) continue;
          word_t w = NONE;
          bool take = false;
          if (cand) {
            w = make_word(v[i], row0 + xg + 16 * i);
            take = w <= hi_r[j];
          }
          if (take && w >= lo_r[j])
            atomicAdd(hist + gq * BINS +
                          static_cast<int>((w - lo_r[j]) >> sh_r[j]),
                      1);
          const unsigned mine =
              (__ballot_sync(FULL, take) >> (qg * 16)) & 0xffffu;
          int base = 0;
          if (xg == 0 && mine) base = atomicAdd(cnt + gq, __popc(mine));
          base = __shfl_sync(FULL, base, 0, 16);
          const int pos = base + __popc(mine & below);
          if (take && pos < width) list[gq * width + pos] = w;
        }
      }
    }
  });
}

// One block per query: lo = its least group minimum, hi = its k-th
// smallest (NONE when fewer than k groups), by radix select over the row
// of minima, 8 digits of 8 bits; shift spans [lo, hi] with 256 bins.  A
// query with no finite word is done with an empty list.
__global__ void __launch_bounds__(256)
bound_kernel(const word_t* __restrict__ minima, int groups, int k,
             word_t* __restrict__ lo, word_t* __restrict__ hi,
             int* __restrict__ shift, int* __restrict__ below,
             int* __restrict__ done, int* __restrict__ cnt) {
  __shared__ int h[BINS];
  __shared__ word_t red[256];
  __shared__ word_t prefix_s;
  __shared__ int rem_s;
  const int tid = threadIdx.x;
  const word_t* row = minima + static_cast<long long>(blockIdx.x) * groups;
  word_t mn = NONE;
  for (int i = tid; i < groups; i += 256) mn = wmin(mn, row[i]);
  red[tid] = mn;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (tid < s) red[tid] = wmin(red[tid], red[tid + s]);
    __syncthreads();
  }
  mn = red[0];
  word_t kth = NONE;
  if (k <= groups && mn != NONE) {
    if (tid == 0) {
      prefix_s = 0;
      rem_s = k;
    }
    word_t mask = 0;
    for (int sh = 56; sh >= 0; sh -= 8) {
      h[tid] = 0;
      __syncthreads();
      const word_t prefix = prefix_s;
      for (int i = tid; i < groups; i += 256) {
        const word_t w = row[i];
        if ((w & mask) == prefix) atomicAdd(&h[(w >> sh) & 255], 1);
      }
      __syncthreads();
      if (tid == 0) {
        int cum = 0, b = 0;
        while (cum + h[b] < rem_s) cum += h[b++];
        rem_s -= cum;
        prefix_s = prefix | (static_cast<word_t>(b) << sh);
      }
      mask |= 0xffull << sh;
      __syncthreads();
    }
    kth = prefix_s;
  }
  if (tid == 0) {
    const int qi = blockIdx.x;
    lo[qi] = mn;
    hi[qi] = kth;
    shift[qi] = max(0, bit_length(kth - mn) - 8);
    below[qi] = 0;
    done[qi] = mn == NONE;
    cnt[qi] = 0;
  }
}

// One block per open query after a collect pass: done when its count of
// words <= hi fits the list (flags[1] keeps the largest such count);
// otherwise the bin of its k-th word becomes [lo, hi], the histogram and
// the count are cleared for the next pass, and flags[0] is set.
__global__ void __launch_bounds__(BINS)
pick_kernel(int* __restrict__ hist, int* __restrict__ cnt,
            word_t* __restrict__ lo, word_t* __restrict__ hi,
            int* __restrict__ shift, int* __restrict__ below,
            int* __restrict__ done, int* __restrict__ flags, int k,
            int width) {
  __shared__ int scan_s[BINS];
  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  if (done[qi]) return;
  const int total = cnt[qi];
  if (total <= width) {
    if (tid == 0) {
      done[qi] = 1;
      atomicMax(flags + 1, total);
    }
    return;
  }
  int* hq = hist + static_cast<long long>(qi) * BINS;
  const int c = hq[tid];
  scan_s[tid] = c;
  __syncthreads();
  for (int off = 1; off < BINS; off <<= 1) {   // inclusive scan
    const int v = tid >= off ? scan_s[tid - off] : 0;
    __syncthreads();
    scan_s[tid] += v;
    __syncthreads();
  }
  const int b0 = below[qi];
  const int incl = scan_s[tid];
  if (b0 + incl >= k && b0 + incl - c < k) {
    const int sh = shift[qi];
    const word_t nlo = lo[qi] + (static_cast<word_t>(tid) << sh);
    const word_t top = nlo + ((1ull << sh) - 1ull);
    const word_t nhi = top < hi[qi] ? top : hi[qi];
    lo[qi] = nlo;
    hi[qi] = nhi;
    below[qi] = b0 + incl - c;
    shift[qi] = max(0, bit_length(nhi - nlo) - 8);
    cnt[qi] = 0;
    flags[0] = 1;
  }
  hq[tid] = 0;
}

// fold's output from the FP32 select's sorted (u, id): rd = max(u +
// ||q||^2, 0), ||q||^2 summed as knn_fold.cu's output sums it (lane-strided
// fmaf, then an xor-shuffle sum), so the select and the streaming kernel
// give the same rdist bits; (+inf, -1) slots stay.  One warp per query.
__global__ void __launch_bounds__(256)
fold_out_kernel(const float* __restrict__ queries, int q, int d, int k,
                float* __restrict__ out_d, const int* __restrict__ out_i) {
  const long long gq = (static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gq >= q) return;   // whole warps
  const float* qrow = queries + gq * d;
  float qn = 0.f;
  for (int f = lane; f < d; f += 32) qn = fmaf(qrow[f], qrow[f], qn);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qn += __shfl_xor_sync(FULL, qn, off);
  float* od = out_d + gq * k;
  const int* oi = out_i + gq * k;
  for (int e = lane; e < k; e += 32) {
    const float rd = od[e] + qn;
    od[e] = oi[e] < 0 ? INFINITY : (rd < 0.f ? 0.f : rd);
  }
}

// The product alone: out (q, n) <- u, for the integrity probe.
__global__ void __launch_bounds__(tc::THREADS)
tc_u_kernel(const char* __restrict__ xplanes, const char* __restrict__ qplanes,
            const float* __restrict__ norms, float* __restrict__ out,
            long long n, int q, int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * tc::TQ;
  const long long r_end = (n + tc::TN - 1) / tc::TN * tc::TN;
  tc::scan(xplanes, qplanes, norms, n, d, q0, 0, r_end, smem,
           [&](long long row0, int rows, const float* us) {
    for (int e = threadIdx.x; e < tc::TQ * tc::TN; e += tc::THREADS) {
      const int r = e / tc::TN, c = e % tc::TN;
      if (q0 + r < q && c < rows && row0 + c < n)
        out[static_cast<long long>(q0 + r) * n + row0 + c] =
            us[r * tc::US + c];
    }
  });
}

bool vec_ok(const float* points, const float* queries, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(queries) % 16 == 0;
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int PASS>
cudaError_t pass_launch(const char* xplanes, const char* qplanes,
                        const float* norms, long long n, int q, int d,
                        int splits, word_t* minima, int groups, int glog,
                        const word_t* lo, const word_t* hi, const int* shift,
                        const int* done, int* hist, int* cnt, word_t* list,
                        int width, void* stream) {
  if (q < 1 || n < 1 || splits < 1 || splits > MAX_SPLITS ||
      xplanes == nullptr || qplanes == nullptr)
    return cudaErrorInvalidValue;
  const size_t smem = tc::smem_bytes(d);
  cudaError_t err = allow_smem(select_pass_kernel<PASS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q + tc::TQ - 1) / tc::TQ, splits);
  select_pass_kernel<PASS><<<grid, tc::THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      xplanes, qplanes, norms, n, q, d, splits, minima, groups, glog, lo, hi,
      shift, done, hist, cnt, list, width);
  return cudaGetLastError();
}

// The FP32 passes (fold's select path) over up to FP32_MAX_SPLITS ranges.
template <int PASS>
cudaError_t fp32_pass_launch(const float* points, const float* queries,
                             const float* norms, long long n, int q, int d,
                             int splits, word_t* minima, int groups, int glog,
                             const word_t* lo, const word_t* hi,
                             const int* shift, const int* done, int* hist,
                             int* cnt, word_t* list, int width, void* stream) {
  if (q < 1 || n < 1 || splits < 1 || splits > FP32_MAX_SPLITS)
    return cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(d);
  const bool vec = vec_ok(points, queries, d);
  cudaError_t err = vec ? allow_smem(fold_pass_kernel<PASS, true>, smem)
                        : allow_smem(fold_pass_kernel<PASS, false>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q + TQ - 1) / TQ, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    fold_pass_kernel<PASS, true><<<grid, THREADS, smem, s>>>(
        points, queries, norms, n, q, d, splits, minima, groups, glog, lo, hi,
        shift, done, hist, cnt, list, width);
  else
    fold_pass_kernel<PASS, false><<<grid, THREADS, smem, s>>>(
        points, queries, norms, n, q, d, splits, minima, groups, glog, lo, hi,
        shift, done, hist, cnt, list, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The histogram's bins and the widest list.
void knn_select_constants(int* bins, int* max_list) {
  *bins = BINS;
  *max_list = MAX_LIST;
}

// Row ranges for the passes over n rows and q queries at width d.
int knn_select_plan(long long n, int q, int d, int* splits) {
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = card_limits(&sms, &optin);
  const size_t smem = tc::smem_bytes(d);
  if (err == cudaSuccess)
    err = allow_smem(select_pass_kernel<PASS_COLLECT>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, select_pass_kernel<PASS_COLLECT>, tc::THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // choose_splits counts 64-row tiles; a range here is whole 128-row tiles
  *splits = choose_splits(per_sm, sms, n, q, tc::TN / TN, tc::TQ);
  return 0;
}

// Pass 1.  xplanes, qplanes: the piece planes (split_planes.cu) of the
// points (n, d) and the queries (q, d); norms (n,) float32; minima (q,
// groups) uint64, groups = ceil(n / 2^glog), 4 <= glog <= 7.
int knn_select_minima_launch(const char* xplanes, const char* qplanes,
                             const float* norms, word_t* minima, long long n,
                             int q, int d, int groups, int glog, int splits,
                             void* stream) {
  if (glog < 4 || glog > 7 || groups != (n + (1LL << glog) - 1) >> glog)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pass_launch<PASS_MINIMA>(
      xplanes, qplanes, norms, n, q, d, splits, minima, groups, glog, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, stream));
}

// Pass 2.  State vectors (q,): lo, hi uint64, shift, below, done, cnt int32.
int knn_select_bound_launch(const word_t* minima, int q, int groups, int k,
                            word_t* lo, word_t* hi, int* shift, int* below,
                            int* done, int* cnt, void* stream) {
  if (q < 1 || groups < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  bound_kernel<<<q, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      minima, groups, k, lo, hi, shift, below, done, cnt);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3.  hist (q, BINS) int32 zeroed, cnt zeroed (by the bound or the
// pick), list (q, width) uint64, width <= MAX_LIST.
int knn_select_collect_launch(const char* xplanes, const char* qplanes,
                              const float* norms, const word_t* lo,
                              const word_t* hi, const int* shift,
                              const int* done, int* hist, int* cnt,
                              word_t* list, long long n, int q, int d,
                              int width, int splits, void* stream) {
  if (width < 1 || width > MAX_LIST)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pass_launch<PASS_COLLECT>(
      xplanes, qplanes, norms, n, q, d, splits, nullptr, 0, 0, lo, hi, shift,
      done, hist, cnt, list, width, stream));
}

// Pass 4.  flags (2,) int32: [0] zeroed before the call, set if a query
// stays open; [1] the largest list of a done query.
int knn_select_pick_launch(int* hist, int* cnt, word_t* lo, word_t* hi,
                           int* shift, int* below, int* done, int* flags,
                           int q, int k, int width, void* stream) {
  if (q < 1) return static_cast<int>(cudaErrorInvalidValue);
  pick_kernel<<<q, BINS, 0, static_cast<cudaStream_t>(stream)>>>(
      hist, cnt, lo, hi, shift, below, done, flags, k, width);
  return static_cast<int>(cudaGetLastError());
}

// fold's select path: the same passes on the FP32 SIMT product.  Row
// ranges for n rows and q queries at width d, up to FP32_MAX_SPLITS.
int knn_select_fp32_plan(long long n, int q, int d, int* splits) {
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = card_limits(&sms, &optin);
  const size_t smem = tile_smem_bytes(d);
  if (err == cudaSuccess)
    err = allow_smem(fold_pass_kernel<PASS_COLLECT, true>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fold_pass_kernel<PASS_COLLECT, true>, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *splits = choose_splits(per_sm, sms, n, q, 1, TQ, FP32_MAX_SPLITS);
  return 0;
}

// Pass 1 on the FP32 product, as knn_select_minima_launch; 4 <= glog <= 6.
int knn_select_fp32_minima_launch(const float* points, const float* queries,
                                  const float* norms, word_t* minima,
                                  long long n, int q, int d, int groups,
                                  int glog, int splits, void* stream) {
  if (glog < 4 || glog > 6 || groups != (n + (1LL << glog) - 1) >> glog)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fp32_pass_launch<PASS_MINIMA>(
      points, queries, norms, n, q, d, splits, minima, groups, glog, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, stream));
}

// Pass 3 on the FP32 product, as knn_select_collect_launch.
int knn_select_fp32_collect_launch(const float* points, const float* queries,
                                   const float* norms, const word_t* lo,
                                   const word_t* hi, const int* shift,
                                   const int* done, int* hist, int* cnt,
                                   word_t* list, long long n, int q, int d,
                                   int width, int splits, void* stream) {
  if (width < 1 || width > MAX_LIST)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fp32_pass_launch<PASS_COLLECT>(
      points, queries, norms, n, q, d, splits, nullptr, 0, 0, lo, hi, shift,
      done, hist, cnt, list, width, stream));
}

// fold's rdist in place: out_d (q, k) float32 u -> max(u + ||q||^2, 0), and
// +inf where out_i (q, k) int32 is -1; queries (q, d) float32.
int knn_select_fold_out_launch(const float* queries, float* out_d,
                               const int* out_i, int q, int d, int k,
                               void* stream) {
  if (q < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(q) + 7) / 8;
  fold_out_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(queries, q, d, k,
                                                         out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core product alone: out (q, n) float32 <- u (the probe), from
// the piece planes of the points (n, d) and the queries (q, d).
int knn_tc_u_launch(const char* xplanes, const char* qplanes,
                    const float* norms, float* out, long long n, int q, int d,
                    void* stream) {
  if (q < 1 || n < 1 || xplanes == nullptr || qplanes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tc::smem_bytes(d);
  cudaError_t err = allow_smem(tc_u_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((q + tc::TQ - 1) / tc::TQ);
  tc_u_kernel<<<grid, tc::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      xplanes, qplanes, norms, out, n, q, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
