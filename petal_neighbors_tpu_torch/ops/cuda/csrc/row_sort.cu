// row_sort.cu — the row sort of (f32 key, int32 payload) pairs for the
// large-k re-rank: one stable block sort for Hopper, launched by both entry
// points.
//
// Replaces two kernels of petal_neighbors_tpu/ops/pallas/:
//   bitonic_sort  sort_kernel.py _sort_kernel (:36, bitonic_sort_pairs :70):
//                 a bitonic network over the row padded to a power of two.
//   rank_sort     rank_sort_kernel.py _rank_sort_kernel (:48,
//                 rank_sort_pairs :107): a counting rank,
//                     rank[i] = #{j : key_j < key_i or (key_j == key_i and j < i)}.
// Both compute one function, so the card runs one sort for both; each entry
// point keeps its name and its launch count on the Python side.
//
// Contract: keys are NaN-free (+inf allowed, -0.0 ties with +0.0 as `<`
// says) and 1 <= width <= 8192.  Each row sorts ascending by key, the
// payload follows its key, and ties go by input position: the output equals
// a stable sort and a gather, bit for bit, payloads included.
//
// Words.  Element i of a row becomes the 64-bit word
// (order_bits(key) << 13) | i, distinct within the row, so any sort of the
// words is the stable sort.  A compare-exchange is one 64-bit compare (two
// 32-bit ones) and selects, and a word moves as one 64-bit shuffle or
// shared-memory access.  (The same word held as an exact double sorts
// slower: sm_90a has no FP64 min or max, so fmin and fmax compile to
// compares and selects too, with more moves around them.)  The key and the
// payload are gathered from the input by position at the end (the key row
// was read at the start and the rescore has just written both: cache
// hits), so the sorted key keeps its bits, -0.0 included.
//
// Design: a register bitonic network per warp, then merge-path merges.
//   1. A warp sorts 256 words, 8 a lane in registers (lane l ends holding
//      ranks 8l .. 8l+7), by a bitonic network of 36 stages: the 21 whose
//      stride is below 8 are compare-exchanges between a lane's own
//      registers, the 15 with strides 8 to 128 one __shfl_xor_sync per word.
//      No shared memory and no barrier.  The words are loaded coalesced
//      (lane l, slot r: element 32r + l of the warp's run): the network does
//      not care where a word starts.
//   2. A row of at most 256 is one warp's work: 8 rows per 256-thread block.
//      Each warp stages its sorted positions in its own slice of shared
//      memory (a __syncwarp, no block barrier) so that the gather and the
//      stores run over consecutive output columns.
//   3. A wider row takes ceil(width / 256) warps, one block per row.  The
//      warps' sorted runs merge pairwise through shared memory: each thread
//      finds where its 8 outputs start by a merge-path binary search and
//      merges them serially from shared memory into its registers.  That is
//      ceil(log2(warps)) rounds of two barriers each.  A row is padded only
//      to the next multiple of 256, with words above every real one: 3072
//      is 12 runs and 4 rounds, not a 4096-wide network.
//
// Why a network and not a block radix sort: a radix pass ranks each element
// among those of its digit, which costs a warp match or shared-memory
// atomics that serialize where many keys share a digit, and these rows are
// the distances of one query's nearest candidates, whose top bytes are
// nearly all alike.  The network's work does not depend on the keys.
//
// What bounds it on this card: bytes, 16 per element (key and payload read
// once and written once).  What the two old kernels lost, and what this
// does about it: the counting rank did width^2 compare-adds per row, about
// 40 times the work of a sort, where a row now costs 36 network stages and
// a few merge rounds per element; the old bitonic network ran every one of
// its log2(S)(log2(S)+1)/2 stages (66 at 2048) through shared memory with a
// barrier each, in 1024-thread blocks (two a SM), over rows padded to a
// power of two, where now 36 stages stay in registers, blocks take 32 to
// 1024 threads by width and rows pad to a multiple of 256.  Shared memory
// is 9 words per 8 (one pad word keeps a lane's 8 stores on distinct banks):
// 18 KB at width 2048, 27 KB at 3072, 72 KB at 8192.
//
// A third entry point, word_sort_launch, sorts the Euclidean merge's lists
// (knn_select.cu): rows of 64-bit words (order_bits(u) << 32 | id) that are
// distinct already, so they are sorted as they are, and the first columns
// are written back as (u, id).
//
// The C entry points return cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_WIDTH = 8192;          // positions fit 13 bits
constexpr int POS_BITS = 13;
constexpr int E = 8;                     // words per lane
constexpr int LOG_RUN = 8;
constexpr int RUN = 32 * E;              // one warp's sorted run
constexpr int WARP_ROWS = 8;             // rows per block at width <= RUN
constexpr unsigned FULL = 0xffffffffu;

static_assert(RUN == 1 << LOG_RUN, "a warp's run is 32 * E words");
static_assert(MAX_WIDTH == 1 << POS_BITS, "positions fill POS_BITS");

// f32 -> unsigned with the same order for non-NaN values; -0.0 maps as
// +0.0 and +inf (0xff800000) below every padding word's 0xffffffff.
__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

typedef unsigned long long word_t;

// (kb << 13) | pos: ordered as (kb, pos).
__device__ __forceinline__ word_t make_word(unsigned kb, int pos) {
  return (static_cast<word_t>(kb) << POS_BITS) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ int word_pos(word_t w) {
  return static_cast<int>(w & (MAX_WIDTH - 1));
}

// Shared-memory slot of sequence index i: one pad word per E.
__device__ __forceinline__ int phys(int i) { return i + i / E; }

// Lane `lane` takes elements base + 32 r + lane (r < E) of the row as words;
// slots at or past `width` take padding words (key bits 0xffffffff, their
// own index), distinct and above every real word.
__device__ __forceinline__ void load_words(word_t (&w)[E], const float* kr,
                                           int width, int base, int lane) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = base + 32 * r + lane;
    w[r] = make_word(i < width ? order_bits(__ldg(kr + i)) : 0xffffffffu, i);
  }
}

// The word entry point's words: slot i of a row of `count` list words
// (the rest padding, key bits 0xffffffff and their own index, above every
// word of a finite key).
__device__ __forceinline__ void load_list(word_t (&w)[E], const word_t* wr,
                                          int count, int base, int lane) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = base + 32 * r + lane;
    w[r] = i < count ? wr[i] : (0xffffffffull << 32) | static_cast<unsigned>(i);
  }
}

// Sort the warp's 32 * E words ascending: lane l ends holding ranks
// l * E .. l * E + E - 1.  Bitonic network over the index i = l * E + r:
// size k = 2^m, stride j; the pair (i, i ^ j) ascends where (i & k) == 0.
__device__ __forceinline__ void warp_sort(word_t (&w)[E], int lane) {
#pragma unroll
  for (int m = 1; m <= LOG_RUN; ++m) {
    const int k = 1 << m;
    // a fixed trip count, so that every stage unrolls to register indices
#pragma unroll
    for (int jb = LOG_RUN - 1; jb >= 0; --jb) {
      if (jb >= m) continue;
      const int j = 1 << jb;
      if (j < E) {
        // both words in this lane's registers
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if (r & j) continue;
          const bool asc =
              k < E ? (r & k) == 0 : ((lane * E) & k) == 0;
          const word_t a = w[r], b = w[r | j];
          const bool swap = (b < a) == asc;
          w[r] = swap ? b : a;
          w[r | j] = swap ? a : b;
        }
      } else {
        // the partner is the same register of lane ^ (j / E)
        const int lj = j / E;
        const bool keep_min =
            ((lane & lj) == 0) == (((lane * E) & k) == 0);
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const word_t o = __shfl_xor_sync(FULL, w[r], lj);
          w[r] = (o < w[r]) == keep_min ? o : w[r];
        }
      }
    }
  }
}

__device__ __forceinline__ void store_words(word_t* sw, const word_t (&w)[E],
                                            int first) {
#pragma unroll
  for (int r = 0; r < E; ++r) sw[phys(first + r)] = w[r];
}

// One merge round over a sequence of `cap` words in shared memory made of
// sorted runs of `run` words (the last may be short): the thread whose
// outputs are sequence indices out0 .. out0 + E - 1 of the merged pair of
// runs takes them into w.  Words are distinct, so `<` decides every step.
__device__ __forceinline__ void merge_step(word_t (&w)[E], const word_t* sw,
                                           int out0, int run, int cap) {
  const word_t inf = ~0ull;           // above every word
  const int base = out0 & ~(2 * run - 1);
  const int diag = out0 - base;
  const int a0 = base, la = min(run, cap - base);
  const int b0 = base + run, lb = max(0, min(run, cap - base - run));
  // merge path: the number of outputs before out0 that come from run A
  int lo = max(0, diag - lb), hi = min(diag, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sw[phys(a0 + mid)] < sw[phys(b0 + diag - 1 - mid)])
      lo = mid + 1;
    else
      hi = mid;
  }
  int ia = lo, ib = diag - lo;
  word_t va = ia < la ? sw[phys(a0 + ia)] : inf;
  word_t vb = ib < lb ? sw[phys(b0 + ib)] : inf;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const bool take_a = va < vb;
    w[r] = take_a ? va : vb;
    if (take_a) {
      ++ia;
      va = ia < la ? sw[phys(a0 + ia)] : inf;
    } else {
      ++ib;
      vb = ib < lb ? sw[phys(b0 + ib)] : inf;
    }
  }
}

// Sorted sequence index i of the row goes to output column i: the key and
// the payload at the word's position.  Thread t of n takes t, t + n, ...
__device__ __forceinline__ void write_row(const word_t* sw, const float* kr,
                                          const int* vr, float* ok, int* ov,
                                          int width, int t, int n) {
  for (int i = t; i < width; i += n) {
    const int src = word_pos(sw[phys(i)]);
    ok[i] = __ldg(kr + src);
    ov[i] = __ldg(vr + src);
  }
}

// The word entry point's output: columns [0, out_cols) of the sorted row as
// (key, payload) = (the key of the word's order bits, its low 32 bits);
// padding words give (+inf, -1).
__device__ __forceinline__ void write_list(const word_t* sw, float* ok,
                                           int* ov, int out_cols, int t,
                                           int n) {
  for (int i = t; i < out_cols; i += n) {
    const word_t w = sw[phys(i)];
    const unsigned b = static_cast<unsigned>(w >> 32);
    const bool pad = b == 0xffffffffu;
    ok[i] = pad ? INFINITY
                : __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
    ov[i] = pad ? -1 : static_cast<int>(w & 0xffffffffu);
  }
}

// WARP_PER_ROW: block = WARP_ROWS warps, warp w sorting row
// blockIdx.x * WARP_ROWS + w (width <= RUN).  Otherwise: block = the row's
// ceil(width / RUN) warps, one row per block, dynamic shared memory of
// phys(cap) words, cap = blockDim.x * E.
// WORDS: the rows are list words (words, row stride `stride`, counts[row]
// of them; the rest padding) and the output keeps out_cols columns
// (write_list); otherwise keys and vals of `width` columns (write_row).
template <bool WARP_PER_ROW, bool WORDS>
__global__ void __launch_bounds__(1024)
block_sort_kernel(const float* __restrict__ keys, const int* __restrict__ vals,
                  const word_t* __restrict__ words,
                  const int* __restrict__ counts, long long stride,
                  float* __restrict__ out_k, int* __restrict__ out_v,
                  long long rows, int width, int out_cols) {
  extern __shared__ word_t sw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long row =
      WARP_PER_ROW ? static_cast<long long>(blockIdx.x) * WARP_ROWS + warp
                   : static_cast<long long>(blockIdx.x);
  if (WARP_PER_ROW && row >= rows) return;   // whole warps; no block barrier
  const float* kr = keys + row * width;
  word_t w[E];
  if (WORDS)
    load_list(w, words + row * stride, counts[row],
              WARP_PER_ROW ? 0 : warp * RUN, lane);
  else
    load_words(w, kr, width, WARP_PER_ROW ? 0 : warp * RUN, lane);
  warp_sort(w, lane);
  const int* vr = vals + row * width;
  float* ok = out_k + row * (WORDS ? out_cols : width);
  int* ov = out_v + row * (WORDS ? out_cols : width);
  if (WARP_PER_ROW) {
    word_t* mine = sw + warp * phys(RUN);
    store_words(mine, w, lane * E);
    __syncwarp();
    if (WORDS)
      write_list(mine, ok, ov, out_cols, lane, 32);
    else
      write_row(mine, kr, vr, ok, ov, width, lane, 32);
    return;
  }
  const int cap = blockDim.x * E;
  for (int run = RUN; run < cap; run <<= 1) {
    store_words(sw, w, tid * E);
    __syncthreads();
    merge_step(w, sw, tid * E, run, cap);
    __syncthreads();
  }
  store_words(sw, w, tid * E);
  __syncthreads();
  if (WORDS)
    write_list(sw, ok, ov, out_cols, tid, blockDim.x);
  else
    write_row(sw, kr, vr, ok, ov, width, tid, blockDim.x);
}

template <bool WORDS>
cudaError_t sort_launch(const float* keys, const int* vals,
                        const word_t* words, const int* counts,
                        long long stride, float* out_k, int* out_v,
                        long long rows, int width, int out_cols,
                        cudaStream_t stream) {
  if (rows < 1 || width < 1 || width > MAX_WIDTH)
    return cudaErrorInvalidValue;
  const int warps = (width + RUN - 1) / RUN;
  if (warps == 1) {
    const long long blocks = (rows + WARP_ROWS - 1) / WARP_ROWS;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const size_t smem = sizeof(word_t) * WARP_ROWS * (RUN + RUN / E);
    block_sort_kernel<true, WORDS><<<static_cast<unsigned>(blocks),
                                     WARP_ROWS * 32, smem, stream>>>(
        keys, vals, words, counts, stride, out_k, out_v, rows, width,
        out_cols);
    return cudaGetLastError();
  }
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int cap = warps * RUN;
  const size_t smem = sizeof(word_t) * (cap + cap / E);
  const cudaError_t err = cudaFuncSetAttribute(
      block_sort_kernel<false, WORDS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  block_sort_kernel<false, WORDS><<<static_cast<unsigned>(rows), warps * 32,
                                    smem, stream>>>(
      keys, vals, words, counts, stride, out_k, out_v, rows, width, out_cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest row either entry point takes.
int row_sort_max_width() { return MAX_WIDTH; }

// keys (rows, width) float32, vals (rows, width) int32, row-major; outputs
// of the same shapes, not aliasing the inputs.  1 <= width <= MAX_WIDTH.
// Both launch the block sort above; returns the launch's cudaError_t (0 on
// success).
int bitonic_sort_launch(const float* keys, const int* vals, float* out_k,
                        int* out_v, long long rows, int width, void* stream) {
  return static_cast<int>(sort_launch<false>(
      keys, vals, nullptr, nullptr, width, out_k, out_v, rows, width, width,
      static_cast<cudaStream_t>(stream)));
}

int rank_sort_launch(const float* keys, const int* vals, float* out_k,
                     int* out_v, long long rows, int width, void* stream) {
  return static_cast<int>(sort_launch<false>(
      keys, vals, nullptr, nullptr, width, out_k, out_v, rows, width, width,
      static_cast<cudaStream_t>(stream)));
}

// The Euclidean merge's lists (knn_select.cu): words (rows, stride)
// uint64 (order_bits(u) << 32 | id), counts (rows,) int32 <= width of them
// real; sorts each row's first `width` slots (the rest of the count
// padding) and writes columns [0, out_cols) of it, out_cols <= width, to
// out_k (rows, out_cols) float32 and out_v (rows, out_cols) int32, padding
// as (+inf, -1).
int word_sort_launch(const unsigned long long* words, const int* counts,
                     long long stride, float* out_k, int* out_v,
                     long long rows, int width, int out_cols, void* stream) {
  if (out_cols < 1 || out_cols > width || stride < width)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sort_launch<true>(
      nullptr, nullptr, words, counts, stride, out_k, out_v, rows, width,
      out_cols, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
