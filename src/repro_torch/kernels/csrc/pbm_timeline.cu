// Buffer-pool kernels of the batched simulator, written for Hopper (sm_90a).
//
// Three kernels, one C entry point each (plus one for the second key type of
// the eviction kernel), and the page-split kernels of the same three
// functions for rows beyond one block (one C entry point each, two to four
// launches; see "Page-split candidate selection" below), whose head paths
// for the eviction and grant kernels also take one C entry point a stage,
// for a split across processes.  Plain C
// interface, no PyTorch headers: the Python
// side (repro_torch/kernels/pbm_timeline.py) loads the library with ctypes,
// hands in device pointers and PyTorch's current stream, and checks the
// returned cudaError_t.  The kernels allocate nothing and never synchronise.
//
// Shared design
// -------------
// * One thread block per lane (blockIdx.x = lane of the sweep).  A sweep has
//   6-24 lanes, so most of the card's 132 SMs stay idle; the simulator's step
//   is bound by launch latency, not by these kernels, and a lane's whole page
//   row fits one SM's shared memory, which keeps every phase of one selection
//   inside one block.  Phases that the TPU kernels ran as a sequential grid
//   axis carrying accumulators in scratch memory are separated here by
//   __syncthreads().
// * All three are "walk the pages in service order with a running byte sum".
//   Service order is (key descending, page index ascending).  The TPU kernels
//   avoid a sort by contracting a 512 x 512 "q precedes p" tile against the
//   sizes on the matrix unit, O(P^2).  Here each page becomes one 64-bit word
//       [takes no part : 1][~order-preserving key : 32][page index : 31]
//   so the ascending order of the words is the service order, ties by index
//   included, with the pages that take no part (not wanted / padding up to
//   the power of two) at the end.  All three need only the head of that
//   order, at most 384 entries in the simulator (min(vmax, P) <= 256,
//   min(vmax, pops) and h_cap * pops): they SELECT the m smallest words
//   exactly (a radix select on the key field, ties by a prefix count in
//   index order) and sort only those; a lane whose head is longer than
//   kHeadCap, or for which the head alone does not decide the answer, sorts
//   its whole row in shared memory inside the same kernel (bitonic,
//   O(P log^2 P)).  Keys are compared as integers
//   built from their own bits: an integer key never passes through a float
//   (queue keys use ~30 bits; [2^24, 2^24 + 1] must stay distinct), and a
//   float key maps monotonically (-0.0 is read as +0.0 first, so equal
//   floats stay tied and fall to the index).
// * Bytes are accumulated in float64 and compared with the f32 thresholds
//   widened to double.  Page sizes are whole byte counts, so every partial
//   sum is exact and independent of the order it is taken in (the block scan
//   adds in another order than a sequential sum); the plain PyTorch versions
//   (repro_torch/kernels/ref.py) do the same and agree bit for bit.  On a
//   whole-row path a thread owns a contiguous run of the sorted row, the
//   block scans the threads' totals, and each later pass re-walks its run
//   from the thread's offset; on a head path a thread holds one entry.
// * No tensor cores: an f32 tensor-core product would round sizes to TF32.
//   No stack frame and no local memory: per-thread state is scalars, every
//   array lives in shared memory.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxRun = 16;          // sorted entries one thread owns, at most
constexpr int kMaxThreads = 1024;
constexpr int kMaxHCap = 256;
constexpr int kHeadCap = 1024;       // longest head a lane sorts alone
constexpr int kBins = 256;           // radix select: 8-bit digits
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kOutBit = 1ull << 63;
constexpr uint32_t kIdxMask = 0x7fffffffu;
constexpr uint32_t kNotQueued = 0xffffffffu;   // key field of a page not wanted
constexpr long long kNoMin = 0x7fffffffffffffffLL;

template <typename K> __device__ __forceinline__ K lowest_key();
template <> __device__ __forceinline__ int lowest_key<int>() {
  return (int)0x80000000;
}
template <> __device__ __forceinline__ float lowest_key<float>() {
  return __uint_as_float(0xff800000u);               // -inf
}

__device__ __forceinline__ uint32_t ord_key(int k) {
  return (uint32_t)k ^ 0x80000000u;
}
__device__ __forceinline__ uint32_t ord_key(float k) {
  const uint32_t b = __float_as_uint(k + 0.0f);      // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <typename K>
__device__ __forceinline__ uint64_t sort_word(bool takes_part, K key, int idx) {
  if (!takes_part) return kOutBit | (uint32_t)idx;
  return ((uint64_t)(~ord_key(key)) << 31) | (uint32_t)idx;
}

// Ascending bitonic sort of s[0..n), n a power of two >= 32.
__device__ void bitonic_sort(uint64_t* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int b = a | j;
        const bool up = (a & k) == 0;
        const uint64_t x = s[a], y = s[b];
        if ((x > y) == up) {
          s[a] = y;
          s[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive prefix of `total` over the block's threads, in thread order.
// s_wtot: 32 doubles of shared memory.  Every thread must call it.
__device__ double block_exclusive(double total, double* s_wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double incl = warp_inclusive(total, lane);
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) s_wtot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    const double w = warp_inclusive(lane < n_warps ? s_wtot[lane] : 0.0, lane);
    s_wtot[lane] = w;
  }
  __syncthreads();
  return excl + (warp > 0 ? s_wtot[warp - 1] : 0.0);
}

// ---------------------------------------------------------------------------
// The head of the service order (fifo_grant, wake_solve, batched_evict's
// first min(vmax, P)).  The lane's row is staged once
// in shared memory as one 32-bit key field per page (the middle field of its
// sort word), the m smallest (key field, index) pairs are selected exactly,
// and only those m words are sorted.  Layout of the dynamic shared memory on
// this path: the staged row (4 P bytes, later reused for the output row),
// then two buffers of head_slots(n) words.  The row is staged by plain
// loads, four in flight a thread: a 1-D bulk copy of it (cp.async.bulk into
// an mbarrier, then the fields made in place) measured slower at 768 and
// 3072 pages and 2 % faster at 8832 (tools/time_queue_kernels.py).
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ size_t head_offset(int P) {
  return ((size_t)4 * P + 15) & ~(size_t)15;
}
__host__ __device__ __forceinline__ int head_slots(int n) {
  return n < kHeadCap ? n : kHeadCap;
}

// A queue key's field: 0x7fffffff - k for a wanted page (k >= 0), above
// every such value for a page not wanted.
__device__ __forceinline__ uint32_t queue_field(int k) {
  return k >= 0 ? ~ord_key(k) : kNotQueued;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int pow2_at_least(int m) {     // m >= 1
  return m <= 32 ? 32 : 1 << (32 - __clz(m - 1));
}

// The head as a test on a page's key field u: the page is in it iff
// (u >> shift) < prefix, or (u >> shift) == prefix and fewer than `need`
// pages of lower index share that prefix (n_eq pages share it).
struct Head {
  uint32_t prefix;
  int shift;
  int need;
  int n_eq;
};

// Radix select of the m smallest fields of s_u[0..P), 1 <= m <= n_part,
// n_part the pages taking part: for a queue the wanted pages (fields below
// 2^31), when m = n_part the head is every wanted page and no pass runs;
// batched_evict passes n_part = P and m < P, its fields spanning 32 bits.
// Otherwise passes of 8 bits from the top, each a block histogram of the
// pages still in play whose scan picks the digit that holds the m-th
// smallest.  Queue keys share their top digits (stamp * 32768 + tie), so
// the lanes of a warp that fall in one bin add to it once
// (__match_any_sync).  Stops as soon as every page of the picked prefix is
// needed.  s_hist: 2 * kBins ints, s_pick: 3 ints.  Every thread must call
// it.
__device__ Head select_head(const uint32_t* s_u, int P, int m, int n_part,
                            int* s_hist, int* s_pick) {
  // tested here, on m as passed: in fifo_grant itself a `lim == n_part`
  // read true for a lim clamped below n_part (nvcc 12.9, a device printf)
  if (m >= n_part) return Head{1u, 31, 0, P - n_part};
  const int lane = threadIdx.x & 31;
  Head h{0u, 32, m, P};
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const int iters = (P + blockDim.x - 1) / blockDim.x;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    int* hist = s_hist + (pass & 1) * kBins;
    int* next = s_hist + ((pass + 1) & 1) * kBins;
    for (int it = 0; it < iters; ++it) {          // the same count in a warp
      const int p = it * blockDim.x + threadIdx.x;
      uint32_t bin = kBins;                       // not in play
      if (p < P) {
        const uint32_t u = s_u[p];
        if ((uint32_t)((uint64_t)u >> (shift + 8)) == h.prefix)
          bin = (u >> shift) & (kBins - 1);
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin < kBins && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], __popc(peers));
    }
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) next[i] = 0;
    __syncthreads();
    if (threadIdx.x < 32) {                       // lane: bins [8 lane, +8)
      int sum = 0;
      for (int b = 0; b < 8; ++b) sum += hist[8 * lane + b];
      const int incl = warp_inclusive(sum, lane);
      int c = incl - sum;
      if (c < h.need && h.need <= incl) {
        for (int b = 8 * lane;; ++b) {
          const int cnt = hist[b];
          if (h.need <= c + cnt) {
            s_pick[0] = b;
            s_pick[1] = c;
            s_pick[2] = cnt;
            break;
          }
          c += cnt;
        }
      }
    }
    __syncthreads();
    h.prefix = (h.prefix << 8) | (uint32_t)s_pick[0];
    h.need -= s_pick[1];
    h.n_eq = s_pick[2];
    h.shift = shift;
    if (h.need == h.n_eq) break;                  // the whole prefix is in
  }
  return h;
}

// Writes the sort words of the head's pages to s_cand, in no particular
// order (*s_count must be 0 and ends at the head's length).  Pages that share
// the picked prefix are ranked in index order by a block prefix count: warp
// w owns pages [w seg, (w + 1) seg), its lanes interleaved.  Every thread
// must call it.
__device__ void compact_head(const uint32_t* s_u, int P, Head h,
                             uint64_t* s_cand, int* s_count, double* s_wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = 32 * ((P + blockDim.x - 1) / blockDim.x);
  const int p0 = warp * seg;
  const unsigned below = lanemask_lt();
  const bool all_eq = h.need == h.n_eq;
  const bool ranked = h.need > 0 && !all_eq;      // the same in every thread
  int eq_before = 0;
  if (ranked) {
    int cnt = 0;
    for (int j = 0; j < seg; j += 32) {
      const int p = p0 + j + lane;
      cnt += __popc(__ballot_sync(
          kFull, p < P && (s_u[p] >> h.shift) == h.prefix));
    }
    // lane 0 of each warp carries its warp's count
    const double excl = block_exclusive(lane == 0 ? (double)cnt : 0.0, s_wtot);
    eq_before = (int)__shfl_sync(kFull, excl, 0);
  }
  for (int j = 0; j < seg; j += 32) {
    const int p = p0 + j + lane;
    const uint32_t u = p < P ? s_u[p] : kNotQueued;
    const uint32_t hi = u >> h.shift;
    const bool eq = p < P && hi == h.prefix;
    const unsigned eqs = __ballot_sync(kFull, eq);
    const bool in = p < P && (hi < h.prefix ||
                              (eq && (all_eq || (ranked &&
                               eq_before + __popc(eqs & below) < h.need))));
    eq_before += __popc(eqs);
    const unsigned ins = __ballot_sync(kFull, in);
    int at = 0;
    if (lane == 0 && ins) at = atomicAdd(s_count, __popc(ins));
    at = __shfl_sync(kFull, at, 0);
    if (in)
      s_cand[at + __popc(ins & below)] = ((uint64_t)u << 31) | (uint32_t)p;
  }
}

// Ascending bitonic sort of n words (a power of two, 32 <= n <= blockDim),
// thread t holding word t in x; returns the thread's word of the sorted
// order.  Steps within a warp are shuffles; the log2(n / 32) * (log2(n / 32)
// + 1) / 2 steps across warps go through buf0 / buf1 in turn (n words each),
// one barrier each.  Every thread must call it.
__device__ uint64_t sort_head(uint64_t x, int n, uint64_t* buf0,
                              uint64_t* buf1) {
  const int t = threadIdx.x;
  const bool act = t < n;                         // whole warps
  bool flip = false;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      uint64_t y = x;
      if (j >= 32) {
        uint64_t* buf = flip ? buf1 : buf0;
        flip = !flip;
        if (act) buf[t] = x;
        __syncthreads();
        if (act) y = buf[t ^ j];
      } else if (act) {
        y = __shfl_xor_sync(kFull, x, j);
      }
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      x = keep_min ? (y < x ? y : x) : (y < x ? x : y);
    }
  }
  return x;
}

// n_k = min(k pop, min_{j <= k} (cnt_j + (k - j) pop)) for k = 1..h_cap:
// the closed form of wake_solve's n_k = min(cnt_k, n_{k-1} + pop), n_0 = 0
// (the plain version's `ramp`).  Thread k - 1 passes cnt_k; s_n[k - 1] gets
// min(n_k, cap), which keeps every comparison with a rank + 1 <= cap.  A
// prefix minimum of cnt_j - j pop: warp scans, then the warps' minima.
// blockDim >= h_cap; every thread must call it.
__device__ void grant_counts(long long cnt, int h_cap, long long pop, int cap,
                             int* s_n, long long* s_wmin) {
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  long long a = k < h_cap ? cnt - (long long)(k + 1) * pop : kNoMin;
  if (warp * 32 < h_cap) {
    for (int o = 1; o < 32; o <<= 1) {
      const long long b = __shfl_up_sync(kFull, a, o);
      if (lane >= o && b < a) a = b;
    }
    if (lane == 31) s_wmin[warp] = a;
  }
  __syncthreads();
  if (k < h_cap) {
    for (int w = 0; w < warp; ++w) a = s_wmin[w] < a ? s_wmin[w] : a;
    const long long nk = (long long)(k + 1) * pop + (a < 0 ? a : 0);
    s_n[k] = (int)(nk < cap ? nk : cap);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// batched_evict — replaces src/repro/kernels/pbm_timeline.py:316
// batched_evict_kernel (body _kernel): per lane, the evict mask = evictable
// pages taken in service order among the first m = min(vmax, P) while the
// bytes freed BEFORE the page are < need_free, and need_free > 0.  A page
// that is not evictable sorts with the key type's minimum (-inf / INT_MIN),
// as in the plain version: an evictable page whose key IS that minimum ties
// with those pages by index and can fall outside the first m.
//
// Bound: bytes.  It must read L*P*(4 + 1) + 4*P and write L*P bytes, a
// fraction of a microsecond at 3.35 TB/s, so in practice one launch and the
// block's barriers.
// Why only the head is sorted: no page past position m of the service order
// is evicted, and whether one before it is depends on the positions before
// it alone.  So the kernel selects the m smallest (key field, index) pairs
// (select_head / compact_head, as fifo_grant; m <= 256 in the simulator) and
// sorts only those, where sorting the row took 55-105 barriers.  Unlike a
// queue, EVERY page takes part: the key field spans all 32 bits (a negative
// f32 key, and any key at the type's minimum, lies at or above 2^31), so
// select_head is given n_part = P, and a lane with vmax >= P takes every
// page without a selection (select_head's m >= n_part shortcut admits only
// fields below 2^31, which is right for a queue and wrong here).  Ties at
// the m-th entry are ranked by index inside compact_head.  A lane with m >
// kHeadCap sorts its whole row instead (bitonic, a thread a contiguous run).
// ---------------------------------------------------------------------------

// A page's key field: the middle field of its sort word, with a page that is
// not evictable at the key type's minimum.  Ascending (field, index) is the
// service order, ties by index included.
template <typename K>
__device__ __forceinline__ uint32_t evict_field(bool ev, K k) {
  return ~ord_key(ev ? k : lowest_key<K>());
}

// The walk of batched_evict's whole-row path over words[0..n), its sorted
// row (in shared memory, or a lane's row of the page-split path's global
// buffer): a thread owns a contiguous run, the block scans the runs' freed
// bytes.  Padding words carry an index >= P.  Every thread must call it.
__device__ __forceinline__ void evict_walk(
    const uint64_t* words, int n, const float* __restrict__ sz_row,
    const uint8_t* __restrict__ ev_row, double need_d, int m, int P,
    double* s_wtot, uint8_t* __restrict__ out_row) {
  const int run_len = (n + blockDim.x - 1) / blockDim.x;
  const int base = threadIdx.x * run_len;
  double total = 0.0;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i < m) {
      const int idx = (int)(words[i] & kIdxMask);
      if (ev_row[idx]) total += (double)sz_row[idx];
    }
  }
  double before = block_exclusive(total, s_wtot);
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i >= n) break;
    const int idx = (int)(words[i] & kIdxMask);
    if (idx >= P) continue;                   // padding
    const bool ev = i < m && ev_row[idx];
    out_row[idx] = (ev && before < need_d) ? 1 : 0;
    if (ev) before += (double)sz_row[idx];
  }
}

template <typename K>
__device__ __forceinline__ void evict_whole_row(
    const K* __restrict__ key_row, const float* __restrict__ sz_row,
    const uint8_t* __restrict__ ev_row, double need_d, int m, int P, int n,
    uint64_t* s_word, double* s_wtot, uint8_t* __restrict__ out_row) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool ev = i < P && ev_row[i];
    s_word[i] = sort_word<K>(i < P, ev ? key_row[i] : lowest_key<K>(), i);
  }
  __syncthreads();
  bitonic_sort(s_word, n);
  evict_walk(s_word, n, sz_row, ev_row, need_d, m, P, s_wtot, out_row);
}

template <typename K>
__global__ void __launch_bounds__(kMaxThreads)
batched_evict_kernel(const K* __restrict__ key, const float* __restrict__ sizes,
                     int sizes_stride, const uint8_t* __restrict__ evictable,
                     const float* __restrict__ need_free,
                     uint8_t* __restrict__ out, int P, int vmax, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_wtot[32];
  __shared__ int s_hist[2 * kBins];
  __shared__ int s_pick[3];
  __shared__ int s_count;           // head entries compacted

  const int lane = blockIdx.x, t = threadIdx.x;
  const size_t row = (size_t)lane * P;
  const K* key_row = key + row;
  const uint8_t* ev_row = evictable + row;
  const float* sz_row = sizes + (size_t)lane * sizes_stride;
  uint8_t* out_row = out + row;
  const float need = need_free[lane];
  const int m = vmax < P ? vmax : P;  // candidates: the first m of the order
  if (!(need > 0.0f) || m <= 0) {     // block-uniform: nothing to free
    for (int p = t; p < P; p += blockDim.x) out_row[p] = 0;
    return;
  }
  const double need_d = (double)need;
  if (m > kHeadCap) {                 // block-uniform
    evict_whole_row<K>(key_row, sz_row, ev_row, need_d, m, P, n,
                       reinterpret_cast<uint64_t*>(smem), s_wtot, out_row);
    return;
  }

  uint64_t* s_cand = reinterpret_cast<uint64_t*>(smem + head_offset(P));
  uint64_t* s_swap = s_cand + head_slots(n);
  uint64_t x = ~0ull;
  if (vmax >= P) {                    // the head is every page (m = P)
    if (t < P) x = ((uint64_t)evict_field<K>(ev_row[t], key_row[t]) << 31) |
                   (uint32_t)t;
  } else {
    if (t == 0) s_count = 0;
    uint32_t* s_u = reinterpret_cast<uint32_t*>(smem);
#pragma unroll 4
    for (int p = t; p < P; p += blockDim.x)
      s_u[p] = evict_field<K>(ev_row[p], key_row[p]);
    __syncthreads();
    const Head h = select_head(s_u, P, m, P, s_hist, s_pick);
    compact_head(s_u, P, h, s_cand, &s_count, s_wtot);
    __syncthreads();
    if (t < m) x = s_cand[t];
  }
  uint8_t* s_mask = smem;             // s_u is read no more
  for (int p = t; p < P; p += blockDim.x) s_mask[p] = 0;
  x = sort_head(x, pow2_at_least(m), s_cand, s_swap);

  const int idx = (int)(x & kIdxMask);
  const bool ev = t < m && ev_row[idx];
  const double sz = ev ? (double)sz_row[idx] : 0.0;
  const double before = block_exclusive(sz, s_wtot);     // exclusive
  if (ev && before < need_d) s_mask[idx] = 1;
  __syncthreads();
  for (int p = t; p < P; p += blockDim.x) out_row[p] = s_mask[p];
}

// ---------------------------------------------------------------------------
// fifo_grant — replaces src/repro/kernels/pbm_timeline.py:269
// fifo_grant_kernel (body _grant_kernel): per lane, pop the request queue in
// service order with strict head-of-line admission against `budget` bytes
// and min(pops, vmax) pops; key < 0 = not wanted.  Outputs the grant mask,
// the granted bytes and the number of grants.
//
// Bound: bytes, L*P*4 + 4*P in and L*P + 8*L out, a fraction of a
// microsecond; in practice the launch and the block's barriers.
// Why only the head is sorted: no position at or past lim = min(vmax, P,
// pops, wanted pages) is granted, and whether one before it is depends on
// the positions before it alone, so the first lim words of the service
// order decide every output.  The kernel selects those lim pages
// (select_head: a radix select, ~a dozen barriers, O(P) a pass) and sorts
// them alone, where sorting the row took 55-105 barriers.  The head of line
// is the smallest position whose running byte sum does not fit (a
// shared-memory atomicMin): the TPU kernel's second O(P^2) pass ("any
// non-fitting predecessor") disappears, and the granted bytes are the
// running sum at the last grant.  Every other page gets 0 in one coalesced
// pass over the row.  A lane with lim > kHeadCap sorts its whole row
// instead (bitonic, a thread a contiguous run of it).
// ---------------------------------------------------------------------------
// The walk of fifo_grant's whole-row path over words[0..n), its sorted row
// (shared memory, or the page-split path's global buffer), the first lim
// positions grantable; *s_head must hold INT_MAX.  Every thread must call it.
__device__ __forceinline__ void grant_walk(
    const uint64_t* words, int n, const float* __restrict__ sz_row,
    double budget_d, int lim, int P, double* s_wtot, int* s_head,
    uint8_t* __restrict__ mask_row, float* __restrict__ bytes,
    int* __restrict__ n_granted) {
  const int run_len = (n + blockDim.x - 1) / blockDim.x;
  const int base = threadIdx.x * run_len;
  double total = 0.0;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i < lim) total += (double)sz_row[words[i] & kIdxMask];
  }
  const double offset = block_exclusive(total, s_wtot);
  double csum = offset;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i >= lim) break;
    csum += (double)sz_row[words[i] & kIdxMask];
    if (!(csum <= budget_d)) {
      atomicMin(s_head, i);
      break;                          // later positions are larger
    }
  }
  __syncthreads();

  const int n_grant = *s_head < lim ? *s_head : lim;
  if (threadIdx.x == 0) {
    *n_granted = n_grant;
    if (n_grant == 0) *bytes = 0.0f;
  }
  csum = offset;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i >= n) break;
    const int idx = (int)(words[i] & kIdxMask);
    if (idx >= P) continue;                   // padding
    mask_row[idx] = i < n_grant ? 1 : 0;
    if (i < n_grant) {
      csum += (double)sz_row[idx];
      if (i == n_grant - 1) *bytes = (float)csum;
    }
  }
}

__device__ __forceinline__ void grant_whole_row(
    const int* __restrict__ key_row, const float* __restrict__ sz_row,
    double budget_d, int lim, int P, int n, uint64_t* s_word, double* s_wtot,
    int* s_head, uint8_t* __restrict__ mask_row, float* __restrict__ bytes,
    int* __restrict__ n_granted) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i < P ? key_row[i] : -1;
    s_word[i] = sort_word<int>(k >= 0, k, i);
  }
  __syncthreads();
  bitonic_sort(s_word, n);
  grant_walk(s_word, n, sz_row, budget_d, lim, P, s_wtot, s_head, mask_row,
             bytes, n_granted);
}

__global__ void __launch_bounds__(kMaxThreads)
fifo_grant_kernel(const int* __restrict__ key, const float* __restrict__ sizes,
                  int sizes_stride, const float* __restrict__ budget,
                  const int* __restrict__ pops, uint8_t* __restrict__ mask_out,
                  float* __restrict__ bytes_out, int* __restrict__ n_out,
                  int P, int vmax, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_wtot[32];
  __shared__ int s_hist[2 * kBins];
  __shared__ int s_pick[3];
  __shared__ int s_part;            // pages taking part (wanted)
  __shared__ int s_count;           // head entries compacted
  __shared__ int s_head;            // first sorted position that does not fit

  const int lane = blockIdx.x, t = threadIdx.x;
  const int* key_row = key + (size_t)lane * P;
  const float* sz_row = sizes + (size_t)lane * sizes_stride;
  uint8_t* mask_row = mask_out + (size_t)lane * P;
  if (t == 0) {
    s_part = 0;
    s_count = 0;
    s_head = 0x7fffffff;
  }
  __syncthreads();
  uint32_t* s_u = reinterpret_cast<uint32_t*>(smem);
  int mine = 0;
#pragma unroll 4
  for (int p = t; p < P; p += blockDim.x) {
    const int k = key_row[p];
    s_u[p] = queue_field(k);
    mine += k >= 0;
  }
  mine = __reduce_add_sync(kFull, mine);
  if ((t & 31) == 0 && mine) atomicAdd(&s_part, mine);
  __syncthreads();
  const int n_part = s_part;
  int lim = vmax < P ? vmax : P;      // positions that may be granted at all
  const int n_pops = pops[lane];
  lim = n_pops < lim ? n_pops : lim;
  lim = lim < n_part ? lim : n_part;
  lim = lim > 0 ? lim : 0;
  const double budget_d = (double)budget[lane];
  if (lim > kHeadCap) {               // block-uniform
    grant_whole_row(key_row, sz_row, budget_d, lim, P, n,
                    reinterpret_cast<uint64_t*>(smem), s_wtot, &s_head,
                    mask_row, bytes_out + lane, n_out + lane);
    return;
  }
  if (lim == 0) {                     // nothing can be granted
    for (int p = t; p < P; p += blockDim.x) mask_row[p] = 0;
    if (t == 0) {
      bytes_out[lane] = 0.0f;
      n_out[lane] = 0;
    }
    return;
  }

  uint64_t* s_cand = reinterpret_cast<uint64_t*>(smem + head_offset(P));
  uint64_t* s_swap = s_cand + head_slots(n);
  const Head h = select_head(s_u, P, lim, n_part, s_hist, s_pick);
  compact_head(s_u, P, h, s_cand, &s_count, s_wtot);
  __syncthreads();
  uint64_t x = t < lim ? s_cand[t] : ~0ull;
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(smem);    // s_u is read no more
  for (int p = t; p < P; p += blockDim.x) s_mask[p] = 0;
  x = sort_head(x, pow2_at_least(lim), s_cand, s_swap);

  const int idx = (int)(x & kIdxMask);
  const double sz = t < lim ? (double)sz_row[idx] : 0.0;
  const double csum = block_exclusive(sz, s_wtot) + sz;   // inclusive
  const unsigned late = __ballot_sync(kFull, t < lim && !(csum <= budget_d));
  if (late && (t & 31) == __ffs(late) - 1) atomicMin(&s_head, t);
  __syncthreads();
  const int n_grant = s_head < lim ? s_head : lim;
  if (t < n_grant) s_mask[idx] = 1;
  if (t == n_grant - 1) bytes_out[lane] = (float)csum;
  if (t == 0) {
    n_out[lane] = n_grant;
    if (n_grant == 0) bytes_out[lane] = 0.0f;
  }
  __syncthreads();
  for (int p = t; p < P; p += blockDim.x) mask_row[p] = s_mask[p];
}

// ---------------------------------------------------------------------------
// wake_solve — replaces src/repro/kernels/pbm_timeline.py:367
// wake_solve_kernel (body _wake_kernel): per lane, with the queue frozen, the
// fine step at which the serial I/O server grants each wanted page.
// cnt_k = wanted entries whose prefix-inclusive bytes fit credit0 + k*inc,
// k = 1..h_cap; n_k = min(cnt_k, n_{k-1} + pops); a page at service rank r
// gets 1 + #{k : n_k < r + 1}; sentinel h_cap + 1.
//
// Bound: bytes, L*P*4 + 4*P in and 4*L*P out, a fraction of a
// microsecond; in practice the launch and the block's barriers.
// Why only the head is sorted: n_k <= k * pops, so every page at rank
// >= m = min(wanted, h_cap * pops) gets the sentinel; with sizes >= 0 the
// prefix is non-decreasing, so the head's own prefix counts give
// min(cnt_k, m), which decides every comparison n_k < r + 1 <= m; and with
// inc >= 0 the thresholds, a rounded f32 multiply then a rounded f32 add
// (__fmul_rn / __fadd_rn, never an FMA), are non-decreasing in k, so cnt_k
// and n_k are too.  The staging pass reads every wanted page's size to
// check the second condition.  So the kernel selects
// and sorts the head alone (select_head, as fifo_grant), takes its prefix
// in f64, finds cnt_k by a binary search of the head's prefixes (thread
// k - 1), n_k by its closed form (a block prefix minimum), and each entry's
// step by a binary search of n_k: O(log) an entry, not O(h_cap).  Every
// other page gets h_cap + 1 in one coalesced pass over the row.  A lane
// with m > kHeadCap, inc < 0 or NaN, or a wanted page whose size is
// negative or not finite sorts its whole row and counts cnt_k over all of
// it (a warp per k) and each step over all h_cap values of n_k.
// ---------------------------------------------------------------------------
// The walk of wake_solve's whole-row path over words[0..n), its sorted row
// (shared memory, or the page-split path's global buffer).  csum may alias
// words (entry i is read before it is written, by the thread that owns it);
// idx holds n ints.  Every thread must call it.
__device__ __forceinline__ void wake_walk(
    const uint64_t* words, double* csum_buf, int* idx_buf, int n,
    const float* __restrict__ sz_row, int n_part, long long pop, int h_cap,
    int P, const double* s_thr, int* s_cnt, int* s_n, long long* s_wmin,
    double* s_wtot, int* __restrict__ out_row) {
  const int run_len = (n + blockDim.x - 1) / blockDim.x;
  const int base = threadIdx.x * run_len;
  double total = 0.0;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i < n_part) total += (double)sz_row[words[i] & kIdxMask];
  }
  double csum = block_exclusive(total, s_wtot);
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i >= n) break;
    const int idx = (int)(words[i] & kIdxMask);
    idx_buf[i] = idx;
    if (i < n_part) csum += (double)sz_row[idx];
    csum_buf[i] = csum;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < h_cap; k += blockDim.x >> 5) {
    const double thr = s_thr[k];
    int fit = 0;
    for (int i = lane; i < n_part; i += 32) fit += csum_buf[i] <= thr;
    fit = __reduce_add_sync(kFull, fit);
    if (lane == 0) s_cnt[k] = fit;
  }
  __syncthreads();
  const int t = threadIdx.x;
  grant_counts(t < h_cap ? s_cnt[t] : 0, h_cap, pop, n_part, s_n, s_wmin);
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i >= n) break;
    const int idx = idx_buf[i];
    if (idx >= P) continue;                    // padding
    int step = h_cap + 1;
    if (i < n_part) {
      step = 1;
      for (int k = 0; k < h_cap; ++k) step += s_n[k] <= i;
    }
    out_row[idx] = step;
  }
}

__device__ __forceinline__ void wake_whole_row(
    const int* __restrict__ key_row, const float* __restrict__ sz_row,
    int n_part, long long pop, int h_cap, int P, int n, unsigned char* smem,
    const double* s_thr, int* s_cnt, int* s_n, long long* s_wmin,
    double* s_wtot, int* __restrict__ out_row) {
  uint64_t* s_word = reinterpret_cast<uint64_t*>(smem);
  double* s_csum = reinterpret_cast<double*>(smem);    // s_word, entry by entry
  int* s_idx = reinterpret_cast<int*>(smem + 8 * (size_t)n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i < P ? key_row[i] : -1;
    s_word[i] = sort_word<int>(k >= 0, k, i);
  }
  __syncthreads();
  bitonic_sort(s_word, n);
  wake_walk(s_word, s_csum, s_idx, n, sz_row, n_part, pop, h_cap, P, s_thr,
            s_cnt, s_n, s_wmin, s_wtot, out_row);
}

__global__ void __launch_bounds__(kMaxThreads)
wake_solve_kernel(const int* __restrict__ key, const float* __restrict__ sizes,
                  int sizes_stride, const float* __restrict__ credit0,
                  const float* __restrict__ inc, const int* __restrict__ pops,
                  int* __restrict__ out, int P, int h_cap, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_wtot[32];
  __shared__ double s_thr[kMaxHCap];
  __shared__ int s_cnt[kMaxHCap];
  __shared__ int s_n[kMaxHCap];
  __shared__ long long s_wmin[kMaxHCap / 32];
  __shared__ int s_hist[2 * kBins];
  __shared__ int s_pick[3];
  __shared__ int s_part;            // pages taking part (wanted)
  __shared__ int s_count;           // head entries compacted

  const int lane = blockIdx.x, t = threadIdx.x;
  const int* key_row = key + (size_t)lane * P;
  const float* sz_row = sizes + (size_t)lane * sizes_stride;
  int* out_row = out + (size_t)lane * P;
  const float c0 = credit0[lane];
  const float step_inc = inc[lane];
  const int n_pops = pops[lane];
  const long long pop = n_pops > 0 ? n_pops : 0;
  if (t == 0) {
    s_part = 0;
    s_count = 0;
  }
  for (int k = t; k < h_cap; k += blockDim.x)
    s_thr[k] = (double)__fadd_rn(c0, __fmul_rn((float)(k + 1), step_inc));
  __syncthreads();
  uint32_t* s_u = reinterpret_cast<uint32_t*>(smem);
  int mine = 0;
  bool bad = false;                 // a wanted size < 0, NaN or infinite
#pragma unroll 4
  for (int p = t; p < P; p += blockDim.x) {
    const int k = key_row[p];
    const float s = sz_row[p];
    s_u[p] = queue_field(k);
    if (k >= 0) {
      ++mine;
      bad |= !(s >= 0.0f && s <= FLT_MAX);
    }
  }
  mine = __reduce_add_sync(kFull, mine);
  if ((t & 31) == 0 && mine) atomicAdd(&s_part, mine);
  const bool any_bad = __syncthreads_or(bad);
  const int n_part = s_part;
  const long long reach = (long long)h_cap * pop;
  const int m = reach < n_part ? (int)reach : n_part;
  if (m == 0) {                     // nothing is granted within h_cap
    for (int p = t; p < P; p += blockDim.x) out_row[p] = h_cap + 1;
    return;
  }
  if (m > kHeadCap || !(step_inc >= 0.0f) || any_bad) {   // block-uniform
    wake_whole_row(key_row, sz_row, n_part, pop, h_cap, P, n, smem, s_thr,
                   s_cnt, s_n, s_wmin, s_wtot, out_row);
    return;
  }

  uint64_t* s_cand = reinterpret_cast<uint64_t*>(smem + head_offset(P));
  uint64_t* s_swap = s_cand + head_slots(n);
  const Head h = select_head(s_u, P, m, n_part, s_hist, s_pick);
  compact_head(s_u, P, h, s_cand, &s_count, s_wtot);
  __syncthreads();
  uint64_t x = t < m ? s_cand[t] : ~0ull;
  int* s_out = reinterpret_cast<int*>(smem);              // s_u is read no more
  for (int p = t; p < P; p += blockDim.x) s_out[p] = h_cap + 1;
  x = sort_head(x, pow2_at_least(m), s_cand, s_swap);

  const int idx = (int)(x & kIdxMask);
  const double sz = t < m ? (double)sz_row[idx] : 0.0;
  const double csum = block_exclusive(sz, s_wtot) + sz;   // inclusive
  double* s_csum = reinterpret_cast<double*>(s_swap);
  if (t < m) s_csum[t] = csum;
  __syncthreads();
  long long cnt = 0;
  if (t < h_cap) {                  // cnt_{t+1}: head prefixes <= threshold
    const double thr = s_thr[t];
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_csum[mid] <= thr) lo = mid + 1;
      else hi = mid;
    }
    cnt = lo;
  }
  grant_counts(cnt, h_cap, pop, m, s_n, s_wmin);
  if (t < m) {                      // step = 1 + #{k : n_k <= rank}
    int lo = 0, hi = h_cap;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_n[mid] <= t) lo = mid + 1;
      else hi = mid;
    }
    s_out[idx] = 1 + lo;
  }
  __syncthreads();
  for (int p = t; p < P; p += blockDim.x) out_row[p] = s_out[p];
}

// ---------------------------------------------------------------------------
// Page-split candidate selection: the same three functions when a lane's row
// does not fit one block (P > kMaxRun * kMaxThreads), or when a split into
// page shards is asked for (the counterpart of the JAX package's page_axis,
// src/repro/kernels/ops.py:115-168).  The row is cut into n shards of p_loc
// = P / n pages, each one block.
//
// Head paths, two launches.  Stage 1 (grid lane x shard) stages its slice's
// key fields (evict_field / queue_field, as the single-stage kernels), radix
// selects the slice's first min(head, p_loc) (field, index) pairs
// (select_head / compact_head) and writes them as sort words carrying the
// GLOBAL page index to a work buffer (L, n, m_slots), unused slots ~0.  It
// also writes its slice of the output's default (no evict, no grant, the
// sentinel) and the slice's wanted pages and bad sizes (stats).  Why this is
// exact: a page among the lane's first m of the service order has fewer
// than m pages before it, so fewer than m in its own slice: it is among its
// slice's first m.  Stage 2 (one block a lane) sorts the n * m_slots words
// in shared memory (bitonic; ~0 sorts last) and runs the single-stage
// kernels' head logic on the first m, scattering its answers to (L, P).
//
// Whole-row paths, three launches: batched_evict with min(vmax, P) >
// kHeadCap, fifo_grant with min(vmax, P) > kHeadCap (both known on the
// host), and the wake_solve lanes whose head does not decide (m > kHeadCap,
// inc < 0 or NaN, a bad wanted size: known on the device, so wake_solve
// always launches these kernels and a lane that does not need them returns
// at once).  Each block sorts its slice's words in shared memory (the
// padding at ~0, past every page), a rank kernel places every word at its
// global rank (its rank in its own slice plus a binary search in every
// other slice: the words are distinct, the index is in them), and the walk
// of the single-stage whole-row path runs over the lane's sorted row in
// global memory.
//
// Across processes (the ranks of a torch.distributed page group, each
// holding the replicated (L, P) row): the head paths of batched_evict and
// fifo_grant run as two C calls with an all-gather between them.  Stage 1
// launches only the rank's own n_loc shards, shard s of rank j being global
// shard s0 + s with s0 = j * n_loc, into the rank's own (L, n_loc, m_slots)
// buffer (fifo_grant's stats (L, n_loc, 2) follow in the same buffer, so one
// collective carries both); it writes no output.  The all-gather stacks the
// ranks' buffers rank-major, (n_rank, L, n_loc, ...), and stage 2 reads
// that layout in place through a rank stride (no transpose: the candidates'
// order does not matter to a sort, and the stats are summed), zeroes the
// whole output row itself, and computes the same answer on every rank.  A
// whole-row path takes no collective: every rank sorts the row it holds.
// ---------------------------------------------------------------------------

enum { kGateAll = 0, kGateNeed = 1, kGateWake = 2 };

// Which lanes take a whole-row path: every lane, the lanes with need_free >
// 0, or wake_solve's rule on its lane totals.
struct Gate {
  int mode;
  int n_sh;
  int h_cap;
  int force;                        // every busy wake_solve lane
  const float* need_free;
  const int* stats;                 // (L, n_sh, 2): wanted pages, bad size
  const int* pops;
  const float* inc;
};

// A wake_solve lane's wanted pages and bad-size flag, over its shards.
__device__ __forceinline__ void lane_totals(const int* stats, int n_sh,
                                            int lane, int* part, int* bad) {
  const int* st = stats + (size_t)lane * n_sh * 2;
  int p = 0, b = 0;
  for (int s = 0; s < n_sh; ++s) {
    p += st[2 * s];
    b |= st[2 * s + 1];
  }
  *part = p;
  *bad = b;
}

__device__ __forceinline__ int wake_head(int n_part, int h_cap, int n_pops) {
  const long long reach = (long long)h_cap * (n_pops > 0 ? n_pops : 0);
  return reach < n_part ? (int)reach : n_part;
}

__device__ __forceinline__ bool wake_needs_row(int m, int force, float inc,
                                               int bad) {
  return m > 0 && (force || m > kHeadCap || !(inc >= 0.0f) || bad);
}

__device__ __forceinline__ bool takes_row(const Gate& g, int lane) {
  if (g.mode == kGateNeed) return g.need_free[lane] > 0.0f;
  if (g.mode == kGateWake) {
    int part, bad;
    lane_totals(g.stats, g.n_sh, lane, &part, &bad);
    return wake_needs_row(wake_head(part, g.h_cap, g.pops[lane]), g.force,
                          g.inc[lane], bad);
  }
  return true;
}

// Stage 1's selection: the first m of the slice's (field, index) order,
// s_u[0..p_loc) the slice's key fields and n_part its pages taking part, as
// sort words with the global index base + p in dst[0..m_slots), the rest ~0.
// every_page: the whole slice (batched_evict with vmax >= p_loc, whose
// fields span 32 bits).  *s_count must be 0.  Every thread must call it.
__device__ void slice_head(const uint32_t* s_u, int p_loc, int m, int n_part,
                           bool every_page, int base, uint64_t* s_cand,
                           int* s_count, int* s_hist, int* s_pick,
                           double* s_wtot, uint64_t* __restrict__ dst,
                           int m_slots) {
  const int t = threadIdx.x;
  if (every_page) {
    for (int i = t; i < m_slots; i += blockDim.x)
      dst[i] = i < p_loc ? (((uint64_t)s_u[i] << 31) | (uint32_t)(base + i))
                         : ~0ull;
    return;
  }
  int count = 0;
  if (m > 0 && n_part > 0) {          // block-uniform
    const Head h = select_head(s_u, p_loc, m, n_part, s_hist, s_pick);
    compact_head(s_u, p_loc, h, s_cand, s_count, s_wtot);
    __syncthreads();
    count = *s_count;
  }
  for (int i = t; i < m_slots; i += blockDim.x)
    dst[i] = i < count ? s_cand[i] + (uint32_t)base : ~0ull;
}

template <typename K>
__global__ void __launch_bounds__(kMaxThreads)
split_evict_cand(const K* __restrict__ key,
                 const uint8_t* __restrict__ evictable,
                 const float* __restrict__ need_free,
                 uint8_t* __restrict__ out, uint64_t* __restrict__ cand, int P,
                 int p_loc, int s0, int vmax, int m_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_wtot[32];
  __shared__ int s_hist[2 * kBins];
  __shared__ int s_pick[3];
  __shared__ int s_count;
  const int lane = blockIdx.x, s = blockIdx.y, t = threadIdx.x;
  const int base = (s0 + s) * p_loc;
  const size_t row = (size_t)lane * P + base;
  uint64_t* dst = cand + ((size_t)lane * gridDim.y + s) * m_slots;
  if (out != nullptr)                 // else stage 2 zeroes the row
    for (int p = t; p < p_loc; p += blockDim.x) out[row + p] = 0;
  const int m = vmax < p_loc ? vmax : p_loc;
  if (!(need_free[lane] > 0.0f) || m <= 0) {    // block-uniform
    for (int i = t; i < m_slots; i += blockDim.x) dst[i] = ~0ull;
    return;
  }
  if (t == 0) s_count = 0;
  uint32_t* s_u = reinterpret_cast<uint32_t*>(smem);
  for (int p = t; p < p_loc; p += blockDim.x)
    s_u[p] = evict_field<K>(evictable[row + p], key[row + p]);
  __syncthreads();
  slice_head(s_u, p_loc, m, p_loc, vmax >= p_loc, base,
             reinterpret_cast<uint64_t*>(smem + head_offset(p_loc)),
             &s_count, s_hist, s_pick, s_wtot, dst, m_slots);
}

// Stage 1 of the two queue kernels: the slice's key fields, its wanted
// pages (stats[0]) and, for wake_solve, whether a wanted size is negative
// or not finite (stats[1]); head = min(vmax, pops) or h_cap * pops.
template <bool kWake>
__global__ void __launch_bounds__(kMaxThreads)
split_queue_cand(const int* __restrict__ key, const float* __restrict__ sizes,
                 int sizes_stride, const int* __restrict__ pops,
                 void* __restrict__ out, uint64_t* __restrict__ cand,
                 int* __restrict__ stats, int P, int p_loc, int s0, int vmax,
                 int h_cap, int m_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_wtot[32];
  __shared__ int s_hist[2 * kBins];
  __shared__ int s_pick[3];
  __shared__ int s_count;
  __shared__ int s_part;
  const int lane = blockIdx.x, s = blockIdx.y, t = threadIdx.x;
  const int base = (s0 + s) * p_loc;
  const size_t row = (size_t)lane * P + base;
  const float* sz = sizes + (size_t)lane * sizes_stride + base;
  if (t == 0) {
    s_count = 0;
    s_part = 0;
  }
  __syncthreads();
  uint32_t* s_u = reinterpret_cast<uint32_t*>(smem);
  int mine = 0;
  bool bad = false;
  for (int p = t; p < p_loc; p += blockDim.x) {
    const int k = key[row + p];
    s_u[p] = queue_field(k);
    if (k >= 0) {
      ++mine;
      if (kWake) bad |= !(sz[p] >= 0.0f && sz[p] <= FLT_MAX);
    }
    if (kWake) reinterpret_cast<int*>(out)[row + p] = h_cap + 1;
    else if (out != nullptr) reinterpret_cast<uint8_t*>(out)[row + p] = 0;
  }
  mine = __reduce_add_sync(kFull, mine);
  if ((t & 31) == 0 && mine) atomicAdd(&s_part, mine);
  const bool any_bad = __syncthreads_or(bad);
  const int n_part = s_part;
  if (t == 0) {
    int* st = stats + ((size_t)lane * gridDim.y + s) * 2;
    st[0] = n_part;
    st[1] = any_bad ? 1 : 0;
  }
  const int n_pops = pops[lane] > 0 ? pops[lane] : 0;
  long long head = kWake ? (long long)h_cap * n_pops
                         : (vmax < n_pops ? vmax : n_pops);
  const int m = head < m_slots ? (int)head : m_slots;
  slice_head(s_u, p_loc, m, n_part, false, base,
             reinterpret_cast<uint64_t*>(smem + head_offset(p_loc)),
             &s_count, s_hist, s_pick, s_wtot,
             cand + ((size_t)lane * gridDim.y + s) * m_slots, m_slots);
}

// Whole-row paths, first launch: each block sorts its slice's sort words
// (n_pad a power of two >= p_loc, the padding ~0) and writes the first
// p_loc to work (L, n, p_loc).
template <typename K, bool kQueue>
__global__ void __launch_bounds__(kMaxThreads)
split_sort_slices(const K* __restrict__ key,
                  const uint8_t* __restrict__ evictable, Gate g,
                  uint64_t* __restrict__ work, int P, int p_loc, int n_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = blockIdx.x, s = blockIdx.y;
  if (!takes_row(g, lane)) return;    // block-uniform
  uint64_t* s_word = reinterpret_cast<uint64_t*>(smem);
  const int base = s * p_loc;
  const size_t row = (size_t)lane * P + base;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    uint64_t w = ~0ull;
    if (i < p_loc) {
      const K k = key[row + i];
      if (kQueue) {
        w = sort_word<K>(k >= 0, k, base + i);
      } else {
        w = sort_word<K>(true, evictable[row + i] ? k : lowest_key<K>(),
                         base + i);
      }
    }
    s_word[i] = w;
  }
  __syncthreads();
  bitonic_sort(s_word, n_pad);
  uint64_t* dst = work + ((size_t)lane * gridDim.y + s) * p_loc;
  for (int i = threadIdx.x; i < p_loc; i += blockDim.x) dst[i] = s_word[i];
}

// Whole-row paths, second launch: every word of slice s at its global rank,
// its rank in the slice plus the words below it in each other slice.
__global__ void __launch_bounds__(256)
split_rank(const uint64_t* __restrict__ work, Gate g,
           uint64_t* __restrict__ sorted, int P, int p_loc) {
  const int lane = blockIdx.x, s = blockIdx.y, n_sh = gridDim.y;
  if (!takes_row(g, lane)) return;    // block-uniform
  const uint64_t* w = work + (size_t)lane * P;
  for (int i = threadIdx.x; i < p_loc; i += blockDim.x) {
    const uint64_t x = w[(size_t)s * p_loc + i];
    int rank = i;
    for (int o = 0; o < n_sh; ++o) {
      if (o == s) continue;
      const uint64_t* other = w + (size_t)o * p_loc;
      int lo = 0, hi = p_loc;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (other[mid] < x) lo = mid + 1;
        else hi = mid;
      }
      rank += lo;
    }
    sorted[(size_t)lane * P + rank] = x;
  }
}

// Where stage 2 reads the candidates: n_rank blocks of words (one a rank,
// rank_stride words apart), each laid out (L, per) with per = n_cand /
// n_rank words a lane.  One rank (the one-launch path) is the (L, n_cand)
// buffer itself.
struct Ranks {
  int n;
  long long stride;
};

__device__ __forceinline__ size_t ranked(Ranks r, int lane, int per, int i) {
  const int k = i / per;
  return (size_t)k * r.stride + (size_t)lane * per + (i - k * per);
}

// Stage 2 of a head path: the lane's n_cand candidate words sorted in
// shared memory (c_pad a power of two >= n_cand); returns thread t's word
// of the sorted order for t < m, else ~0.  Every thread must call it.
__device__ uint64_t sorted_candidate(const uint64_t* __restrict__ cand,
                                     Ranks rk, int lane, int n_cand,
                                     int c_pad, int m, uint64_t* s_c) {
  const int per = n_cand / rk.n;
  for (int i = threadIdx.x; i < c_pad; i += blockDim.x)
    s_c[i] = i < n_cand ? cand[ranked(rk, lane, per, i)] : ~0ull;
  __syncthreads();
  bitonic_sort(s_c, c_pad);
  const uint64_t x = (int)threadIdx.x < m ? s_c[threadIdx.x] : ~0ull;
  __syncthreads();                    // s_c may be reused
  return x;
}

// A rank's stage 2 writes the whole output row: its stage 1 wrote none.
// The zeros land before the answer's ones, which follow a __syncthreads().
__device__ __forceinline__ void zero_row(uint8_t* __restrict__ row, int P) {
  for (int p = threadIdx.x; p < P; p += blockDim.x) row[p] = 0;
}

__global__ void __launch_bounds__(kMaxThreads)
split_evict_finish(const uint64_t* __restrict__ cand,
                   const uint64_t* __restrict__ sorted,
                   const float* __restrict__ sizes, int sizes_stride,
                   const uint8_t* __restrict__ evictable,
                   const float* __restrict__ need_free,
                   uint8_t* __restrict__ out, int P, int vmax, int n_cand,
                   int c_pad, Ranks rk, int zero) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_wtot[32];
  const int lane = blockIdx.x, t = threadIdx.x;
  const size_t row = (size_t)lane * P;
  const uint8_t* ev_row = evictable + row;
  const float* sz_row = sizes + (size_t)lane * sizes_stride;
  uint8_t* out_row = out + row;
  const float need = need_free[lane];
  const int m = vmax < P ? vmax : P;
  const bool idle = !(need > 0.0f) || m <= 0;
  if (sorted != nullptr) {            // whole row: writes every page
    if (idle) {
      for (int p = t; p < P; p += blockDim.x) out_row[p] = 0;
      return;
    }
    evict_walk(sorted + row, P, sz_row, ev_row, (double)need, m, P, s_wtot,
               out_row);
    return;
  }
  if (zero) zero_row(out_row, P);
  if (idle) return;                   // stage 1 wrote the zeros, or zero
  const uint64_t x = sorted_candidate(cand, rk, lane, n_cand, c_pad, m,
                                      reinterpret_cast<uint64_t*>(smem));
  const int idx = (int)(x & kIdxMask);
  const bool ev = t < m && ev_row[idx];
  const double sz = ev ? (double)sz_row[idx] : 0.0;
  const double before = block_exclusive(sz, s_wtot);     // exclusive
  if (ev && before < (double)need) out_row[idx] = 1;
}

__global__ void __launch_bounds__(kMaxThreads)
split_grant_finish(const uint64_t* __restrict__ cand,
                   const int* __restrict__ stats,
                   const uint64_t* __restrict__ sorted,
                   const float* __restrict__ sizes, int sizes_stride,
                   const float* __restrict__ budget,
                   const int* __restrict__ pops,
                   uint8_t* __restrict__ mask_out, float* __restrict__ bytes_out,
                   int* __restrict__ n_out, int P, int vmax, int n_sh,
                   int n_cand, int c_pad, Ranks rk, int zero) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_wtot[32];
  __shared__ int s_head;
  __shared__ int s_part;
  const int lane = blockIdx.x, t = threadIdx.x;
  const size_t row = (size_t)lane * P;
  const float* sz_row = sizes + (size_t)lane * sizes_stride;
  uint8_t* mask_row = mask_out + row;
  const double budget_d = (double)budget[lane];
  if (t == 0) {
    s_head = 0x7fffffff;
    if (sorted != nullptr) {          // wanted words (bit 63 clear) lead
      const uint64_t* w = sorted + row;
      int lo = 0, hi = P;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (w[mid] < kOutBit) lo = mid + 1;
        else hi = mid;
      }
      s_part = lo;
    } else {                          // stats: 2 ints a shard, rank-major
      const int n_loc = n_sh / rk.n;
      const Ranks st{rk.n, 2 * rk.stride};
      int part = 0;
      for (int s = 0; s < n_sh; ++s) part += stats[ranked(st, lane, 2 * n_loc, 2 * s)];
      s_part = part;
    }
  }
  if (zero) zero_row(mask_row, P);
  __syncthreads();
  int lim = vmax < P ? vmax : P;
  const int n_pops = pops[lane];
  lim = n_pops < lim ? n_pops : lim;
  lim = lim < s_part ? lim : s_part;
  lim = lim > 0 ? lim : 0;
  if (sorted != nullptr) {            // whole row: writes every page
    grant_walk(sorted + row, P, sz_row, budget_d, lim, P, s_wtot, &s_head,
               mask_row, bytes_out + lane, n_out + lane);
    return;
  }
  if (lim == 0) {                     // stage 1 wrote the zeros, or zero
    if (t == 0) {
      bytes_out[lane] = 0.0f;
      n_out[lane] = 0;
    }
    return;
  }
  const uint64_t x = sorted_candidate(cand, rk, lane, n_cand, c_pad, lim,
                                      reinterpret_cast<uint64_t*>(smem));
  const int idx = (int)(x & kIdxMask);
  const double sz = t < lim ? (double)sz_row[idx] : 0.0;
  const double csum = block_exclusive(sz, s_wtot) + sz;   // inclusive
  const unsigned late = __ballot_sync(kFull, t < lim && !(csum <= budget_d));
  if (late && (t & 31) == __ffs(late) - 1) atomicMin(&s_head, t);
  __syncthreads();
  const int n_grant = s_head < lim ? s_head : lim;
  if (t < n_grant) mask_row[idx] = 1;
  if (t == n_grant - 1) bytes_out[lane] = (float)csum;
  if (t == 0) {
    n_out[lane] = n_grant;
    if (n_grant == 0) bytes_out[lane] = 0.0f;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
split_wake_finish(const uint64_t* __restrict__ cand,
                  const int* __restrict__ stats, uint64_t* sorted,
                  int* __restrict__ idx_buf, const float* __restrict__ sizes,
                  int sizes_stride, const float* __restrict__ credit0,
                  const float* __restrict__ inc, const int* __restrict__ pops,
                  int* __restrict__ out, int P, int h_cap, int n_sh,
                  int n_cand, int c_pad, int force) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_wtot[32];
  __shared__ double s_thr[kMaxHCap];
  __shared__ int s_cnt[kMaxHCap];
  __shared__ int s_n[kMaxHCap];
  __shared__ long long s_wmin[kMaxHCap / 32];
  const int lane = blockIdx.x, t = threadIdx.x;
  const size_t row = (size_t)lane * P;
  const float* sz_row = sizes + (size_t)lane * sizes_stride;
  int* out_row = out + row;
  const float c0 = credit0[lane];
  const float step_inc = inc[lane];
  const int n_pops = pops[lane];
  const long long pop = n_pops > 0 ? n_pops : 0;
  for (int k = t; k < h_cap; k += blockDim.x)
    s_thr[k] = (double)__fadd_rn(c0, __fmul_rn((float)(k + 1), step_inc));
  __syncthreads();
  int n_part, bad;
  lane_totals(stats, n_sh, lane, &n_part, &bad);
  const int m = wake_head(n_part, h_cap, n_pops);
  if (m == 0) return;                 // stage 1 wrote the sentinel
  if (wake_needs_row(m, force, step_inc, bad)) {   // block-uniform
    uint64_t* w = sorted + row;
    wake_walk(w, reinterpret_cast<double*>(w), idx_buf + row, P, sz_row,
              n_part, pop, h_cap, P, s_thr, s_cnt, s_n, s_wmin, s_wtot,
              out_row);
    return;
  }
  const uint64_t x = sorted_candidate(cand, Ranks{1, 0}, lane, n_cand, c_pad,
                                      m, reinterpret_cast<uint64_t*>(smem));
  const int idx = (int)(x & kIdxMask);
  const double sz = t < m ? (double)sz_row[idx] : 0.0;
  const double csum = block_exclusive(sz, s_wtot) + sz;   // inclusive
  double* s_csum = reinterpret_cast<double*>(smem);
  if (t < m) s_csum[t] = csum;
  __syncthreads();
  long long cnt = 0;
  if (t < h_cap) {                  // cnt_{t+1}: head prefixes <= threshold
    const double thr = s_thr[t];
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_csum[mid] <= thr) lo = mid + 1;
      else hi = mid;
    }
    cnt = lo;
  }
  grant_counts(cnt, h_cap, pop, m, s_n, s_wmin);
  if (t < m) {                      // step = 1 + #{k : n_k <= rank}
    int lo = 0, hi = h_cap;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_n[mid] <= t) lo = mid + 1;
      else hi = mid;
    }
    out_row[idx] = 1 + lo;
  }
}

// Opt a kernel in to all the shared memory a block may take (227 KB on
// Hopper; above 48 KB only as dynamic shared memory, on request) and report
// how much of it is left for the dynamic part beside the kernel's static
// arrays.
template <typename Kern>
inline cudaError_t allow_large_smem(Kern kern, int* max_dyn) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  *max_dyn = optin - (int)attr.sharedSizeBytes;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *max_dyn);
}

inline int threads_for(int n) { return n < kMaxThreads ? n : kMaxThreads; }

// Dynamic shared memory of a block: the larger of the whole-row path's
// (`row_bytes` per sorted entry) and the head path's.
inline size_t smem_for(int P, int n, int row_bytes) {
  const size_t whole = (size_t)row_bytes * n;
  const size_t head = head_offset(P) + 16 * (size_t)head_slots(n);
  return whole > head ? whole : head;
}

inline int slice_threads(int p_loc) {
  int n = 32;
  while (n < p_loc && n < kMaxThreads) n <<= 1;
  return n;
}

inline int pad_pow2(int n) {
  int p = 32;
  while (p < n) p <<= 1;
  return p;
}

inline size_t cand_smem(int p_loc, int m_slots) {
  return head_offset(p_loc) + 8 * (size_t)m_slots;
}

// Stage 1 of a head path over shards s0 .. s0 + n_loc - 1 of n_sh (all of
// them in one process; a rank's own across processes, with out = nullptr).
template <typename K>
void evict_cand(const void* key, const void* evictable, const void* need_free,
                void* out, int L, int P, int vmax, int n_sh, int s0, int n_loc,
                int m_slots, void* cand, cudaStream_t st) {
  const int p_loc = P / n_sh;
  split_evict_cand<K><<<dim3(L, n_loc), slice_threads(p_loc),
                        cand_smem(p_loc, m_slots), st>>>(
      (const K*)key, (const uint8_t*)evictable, (const float*)need_free,
      (uint8_t*)out, (uint64_t*)cand, P, p_loc, s0, vmax, m_slots);
}

void evict_finish(const void* cand, const void* sizes, int sizes_stride,
                  const void* evictable, const void* need_free, void* out,
                  int L, int P, int vmax, int n_cand, Ranks rk, int zero,
                  cudaStream_t st) {
  const int c_pad = pad_pow2(n_cand);
  split_evict_finish<<<L, kMaxThreads, 8 * (size_t)c_pad, st>>>(
      (const uint64_t*)cand, nullptr, (const float*)sizes, sizes_stride,
      (const uint8_t*)evictable, (const float*)need_free, (uint8_t*)out, P,
      vmax, n_cand, c_pad, rk, zero);
}

void grant_cand(const void* key, const void* sizes, int sizes_stride,
                const void* pops, void* mask_out, void* cand, void* stats,
                int L, int P, int vmax, int n_sh, int s0, int n_loc,
                int m_slots, cudaStream_t st) {
  const int p_loc = P / n_sh;
  split_queue_cand<false><<<dim3(L, n_loc), slice_threads(p_loc),
                            cand_smem(p_loc, m_slots), st>>>(
      (const int*)key, (const float*)sizes, sizes_stride, (const int*)pops,
      mask_out, (uint64_t*)cand, (int*)stats, P, p_loc, s0, vmax, 0, m_slots);
}

void grant_finish(const void* cand, const void* stats, const void* sizes,
                  int sizes_stride, const void* budget, const void* pops,
                  void* mask_out, void* bytes_out, void* n_out, int L, int P,
                  int vmax, int n_sh, int n_cand, Ranks rk, int zero,
                  cudaStream_t st) {
  const int c_pad = pad_pow2(n_cand);
  split_grant_finish<<<L, kMaxThreads, 8 * (size_t)c_pad, st>>>(
      (const uint64_t*)cand, (const int*)stats, nullptr, (const float*)sizes,
      sizes_stride, (const float*)budget, (const int*)pops,
      (uint8_t*)mask_out, (float*)bytes_out, (int*)n_out, P, vmax, n_sh,
      n_cand, c_pad, rk, zero);
}

template <typename K>
int split_evict(const void* key, const void* sizes, int sizes_stride,
                const void* evictable, const void* need_free, void* out,
                int L, int P, int vmax, int n_sh, int m_slots, void* cand,
                void* work, void* sorted, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int p_loc = P / n_sh;
  const dim3 grid(L, n_sh);
  if (cand != nullptr) {
    evict_cand<K>(key, evictable, need_free, out, L, P, vmax, n_sh, 0, n_sh,
                  m_slots, cand, st);
    evict_finish(cand, sizes, sizes_stride, evictable, need_free, out, L, P,
                 vmax, n_sh * m_slots, Ranks{1, 0}, 0, st);
    return (int)cudaGetLastError();
  }
  Gate g{kGateNeed, n_sh, 0, 0, (const float*)need_free, nullptr, nullptr,
         nullptr};
  const int n_pad = pad_pow2(p_loc);
  split_sort_slices<K, false><<<grid, slice_threads(n_pad), 8 * (size_t)n_pad,
                                st>>>((const K*)key, (const uint8_t*)evictable,
                                      g, (uint64_t*)work, P, p_loc, n_pad);
  split_rank<<<grid, 256, 0, st>>>((const uint64_t*)work, g,
                                   (uint64_t*)sorted, P, p_loc);
  split_evict_finish<<<L, kMaxThreads, 0, st>>>(
      nullptr, (const uint64_t*)sorted, (const float*)sizes, sizes_stride,
      (const uint8_t*)evictable, (const float*)need_free, (uint8_t*)out, P,
      vmax, 0, 0, Ranks{1, 0}, 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pbm_max_h_cap() { return kMaxHCap; }
// Most sorted entries a row may have: kMaxRun per thread of a full block.
int pbm_max_sort_len() { return kMaxRun * kMaxThreads; }
// Longest head that the three kernels select and sort alone.
int pbm_head_cap() { return kHeadCap; }

// Once, after the library is loaded: raise every kernel's dynamic shared
// memory limit and write the three limits (evict, grant, wake) to max_dyn.
int pbm_init(int* max_dyn) {
  int other = 0;
  cudaError_t e = allow_large_smem(batched_evict_kernel<float>, &max_dyn[0]);
  if (e != cudaSuccess) return (int)e;
  e = allow_large_smem(batched_evict_kernel<int>, &other);
  if (e != cudaSuccess) return (int)e;
  if (other < max_dyn[0]) max_dyn[0] = other;
  e = allow_large_smem(fifo_grant_kernel, &max_dyn[1]);
  if (e != cudaSuccess) return (int)e;
  e = allow_large_smem(wake_solve_kernel, &max_dyn[2]);
  if (e != cudaSuccess) return (int)e;
  // the page-split kernels: max_dyn[3] is the least of their limits
  int lim[9];
  e = allow_large_smem(split_evict_cand<float>, &lim[0]);
  if (e == cudaSuccess) e = allow_large_smem(split_evict_cand<int>, &lim[1]);
  if (e == cudaSuccess) e = allow_large_smem(split_queue_cand<false>, &lim[2]);
  if (e == cudaSuccess) e = allow_large_smem(split_queue_cand<true>, &lim[3]);
  if (e == cudaSuccess)
    e = allow_large_smem(split_sort_slices<float, false>, &lim[4]);
  if (e == cudaSuccess)
    e = allow_large_smem(split_sort_slices<int, false>, &lim[5]);
  if (e == cudaSuccess)
    e = allow_large_smem(split_sort_slices<int, true>, &lim[6]);
  if (e == cudaSuccess) e = allow_large_smem(split_evict_finish, &lim[7]);
  if (e == cudaSuccess) e = allow_large_smem(split_grant_finish, &lim[8]);
  if (e == cudaSuccess) e = allow_large_smem(split_wake_finish, &max_dyn[3]);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < 9; ++i)
    if (lim[i] < max_dyn[3]) max_dyn[3] = lim[i];
  return 0;
}

// `n` is the sorted row length: a power of two, >= 32 and >= P.  A block
// takes 8 * n bytes of dynamic shared memory (12 * n for wake_solve),
// a little more for a short row's head path.

int pbm_batched_evict_f32(const void* key, const void* sizes, int sizes_stride,
                          const void* evictable, const void* need_free,
                          void* out, int L, int P, int vmax, int n,
                          void* stream) {
  batched_evict_kernel<float>
      <<<L, threads_for(n), smem_for(P, n, 8), (cudaStream_t)stream>>>(
          (const float*)key, (const float*)sizes, sizes_stride,
          (const uint8_t*)evictable, (const float*)need_free, (uint8_t*)out, P,
          vmax, n);
  return (int)cudaGetLastError();
}

int pbm_batched_evict_i32(const void* key, const void* sizes, int sizes_stride,
                          const void* evictable, const void* need_free,
                          void* out, int L, int P, int vmax, int n,
                          void* stream) {
  batched_evict_kernel<int>
      <<<L, threads_for(n), smem_for(P, n, 8), (cudaStream_t)stream>>>(
          (const int*)key, (const float*)sizes, sizes_stride,
          (const uint8_t*)evictable, (const float*)need_free, (uint8_t*)out, P,
          vmax, n);
  return (int)cudaGetLastError();
}

int pbm_fifo_grant(const void* key, const void* sizes, int sizes_stride,
                   const void* budget, const void* pops, void* mask_out,
                   void* bytes_out, void* n_out, int L, int P, int vmax, int n,
                   void* stream) {
  fifo_grant_kernel<<<L, threads_for(n), smem_for(P, n, 8),
                      (cudaStream_t)stream>>>(
      (const int*)key, (const float*)sizes, sizes_stride, (const float*)budget,
      (const int*)pops, (uint8_t*)mask_out, (float*)bytes_out, (int*)n_out, P,
      vmax, n);
  return (int)cudaGetLastError();
}

int pbm_wake_solve(const void* key, const void* sizes, int sizes_stride,
                   const void* credit0, const void* inc, const void* pops,
                   void* out, int L, int P, int h_cap, int n, void* stream) {
  // a thread per k of the recursion: at least h_cap threads
  int threads = threads_for(n);
  const int for_k = (h_cap + 31) & ~31;
  if (threads < for_k) threads = for_k;
  wake_solve_kernel<<<L, threads, smem_for(P, n, 12), (cudaStream_t)stream>>>(
      (const int*)key, (const float*)sizes, sizes_stride, (const float*)credit0,
      (const float*)inc, (const int*)pops, (int*)out, P, h_cap, n);
  return (int)cudaGetLastError();
}

// The page-split path (P = n_sh * p_loc).  A head path passes `cand` (L,
// n_sh, m_slots) words (and, for the queues, `stats` (L, n_sh, 2) ints) and
// no `work` / `sorted`; a whole-row path passes `work` and `sorted`, (L, P)
// words each, and no `cand`.  wake_solve passes all of them, and `idx` (L,
// P) ints: its lanes choose on the device.  Two to four launches on
// `stream`; the first error is returned.

int pbm_split_evict_f32(const void* key, const void* sizes, int sizes_stride,
                        const void* evictable, const void* need_free, void* out,
                        int L, int P, int vmax, int n_sh, int m_slots,
                        void* cand, void* work, void* sorted, void* stream) {
  return split_evict<float>(key, sizes, sizes_stride, evictable, need_free,
                            out, L, P, vmax, n_sh, m_slots, cand, work, sorted,
                            stream);
}

int pbm_split_evict_i32(const void* key, const void* sizes, int sizes_stride,
                        const void* evictable, const void* need_free, void* out,
                        int L, int P, int vmax, int n_sh, int m_slots,
                        void* cand, void* work, void* sorted, void* stream) {
  return split_evict<int>(key, sizes, sizes_stride, evictable, need_free, out,
                          L, P, vmax, n_sh, m_slots, cand, work, sorted,
                          stream);
}

int pbm_split_grant(const void* key, const void* sizes, int sizes_stride,
                    const void* budget, const void* pops, void* mask_out,
                    void* bytes_out, void* n_out, int L, int P, int vmax,
                    int n_sh, int m_slots, void* cand, void* stats, void* work,
                    void* sorted, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int p_loc = P / n_sh;
  const dim3 grid(L, n_sh);
  if (cand != nullptr) {
    grant_cand(key, sizes, sizes_stride, pops, mask_out, cand, stats, L, P,
               vmax, n_sh, 0, n_sh, m_slots, st);
    grant_finish(cand, stats, sizes, sizes_stride, budget, pops, mask_out,
                 bytes_out, n_out, L, P, vmax, n_sh, n_sh * m_slots,
                 Ranks{1, 0}, 0, st);
    return (int)cudaGetLastError();
  }
  Gate g{kGateAll, n_sh, 0, 0, nullptr, nullptr, nullptr, nullptr};
  const int n_pad = pad_pow2(p_loc);
  split_sort_slices<int, true><<<grid, slice_threads(n_pad), 8 * (size_t)n_pad,
                                 st>>>((const int*)key, nullptr, g,
                                       (uint64_t*)work, P, p_loc, n_pad);
  split_rank<<<grid, 256, 0, st>>>((const uint64_t*)work, g,
                                   (uint64_t*)sorted, P, p_loc);
  split_grant_finish<<<L, kMaxThreads, 0, st>>>(
      nullptr, nullptr, (const uint64_t*)sorted, (const float*)sizes,
      sizes_stride, (const float*)budget, (const int*)pops, (uint8_t*)mask_out,
      (float*)bytes_out, (int*)n_out, P, vmax, n_sh, 0, 0, Ranks{1, 0}, 0);
  return (int)cudaGetLastError();
}

int pbm_split_wake(const void* key, const void* sizes, int sizes_stride,
                   const void* credit0, const void* inc, const void* pops,
                   void* out, int L, int P, int h_cap, int n_sh, int m_slots,
                   void* cand, void* stats, void* work, void* sorted,
                   void* idx, int force, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int p_loc = P / n_sh;
  const dim3 grid(L, n_sh);
  split_queue_cand<true><<<grid, slice_threads(p_loc),
                           cand_smem(p_loc, m_slots), st>>>(
      (const int*)key, (const float*)sizes, sizes_stride, (const int*)pops, out,
      (uint64_t*)cand, (int*)stats, P, p_loc, 0, 0, h_cap, m_slots);
  Gate g{kGateWake, n_sh, h_cap, force, nullptr, (const int*)stats,
         (const int*)pops, (const float*)inc};
  const int n_pad = pad_pow2(p_loc);
  split_sort_slices<int, true><<<grid, slice_threads(n_pad), 8 * (size_t)n_pad,
                                 st>>>((const int*)key, nullptr, g,
                                       (uint64_t*)work, P, p_loc, n_pad);
  split_rank<<<grid, 256, 0, st>>>((const uint64_t*)work, g,
                                   (uint64_t*)sorted, P, p_loc);
  const int n_cand = n_sh * m_slots, c_pad = pad_pow2(n_cand);
  split_wake_finish<<<L, kMaxThreads, 8 * (size_t)c_pad, st>>>(
      (const uint64_t*)cand, (const int*)stats, (uint64_t*)sorted, (int*)idx,
      (const float*)sizes, sizes_stride, (const float*)credit0,
      (const float*)inc, (const int*)pops, (int*)out, P, h_cap, n_sh, n_cand,
      c_pad, force);
  return (int)cudaGetLastError();
}

// The head paths of batched_evict and fifo_grant across the ranks of a
// page group, one C call a stage.  Stage 1 (`*_cand`) fills the rank's
// shards s0 .. s0 + n_loc - 1 of n_sh: `cand` (L, n_loc, m_slots) words
// and, for fifo_grant, `stats` (L, n_loc, 2) ints; it writes no output.
// Stage 2 (`*_finish`) reads the n_rank ranks' buffers, rank_stride words
// apart (`cand`; fifo_grant's `stats` 2 * rank_stride ints apart), zeroes
// every output row and writes the answer.  One launch each.

int pbm_split_evict_cand_f32(const void* key, const void* evictable,
                             const void* need_free, int L, int P, int vmax,
                             int n_sh, int s0, int n_loc, int m_slots,
                             void* cand, void* stream) {
  evict_cand<float>(key, evictable, need_free, nullptr, L, P, vmax, n_sh, s0,
                    n_loc, m_slots, cand, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int pbm_split_evict_cand_i32(const void* key, const void* evictable,
                             const void* need_free, int L, int P, int vmax,
                             int n_sh, int s0, int n_loc, int m_slots,
                             void* cand, void* stream) {
  evict_cand<int>(key, evictable, need_free, nullptr, L, P, vmax, n_sh, s0,
                  n_loc, m_slots, cand, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int pbm_split_evict_finish(const void* cand, const void* sizes,
                           int sizes_stride, const void* evictable,
                           const void* need_free, void* out, int L, int P,
                           int vmax, int n_cand, int n_rank,
                           long long rank_stride, void* stream) {
  evict_finish(cand, sizes, sizes_stride, evictable, need_free, out, L, P,
               vmax, n_cand, Ranks{n_rank, rank_stride}, 1,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int pbm_split_grant_cand(const void* key, const void* sizes, int sizes_stride,
                         const void* pops, void* cand, void* stats, int L,
                         int P, int vmax, int n_sh, int s0, int n_loc,
                         int m_slots, void* stream) {
  grant_cand(key, sizes, sizes_stride, pops, nullptr, cand, stats, L, P, vmax,
             n_sh, s0, n_loc, m_slots, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int pbm_split_grant_finish(const void* cand, const void* stats,
                           const void* sizes, int sizes_stride,
                           const void* budget, const void* pops,
                           void* mask_out, void* bytes_out, void* n_out, int L,
                           int P, int vmax, int n_sh, int n_cand, int n_rank,
                           long long rank_stride, void* stream) {
  grant_finish(cand, stats, sizes, sizes_stride, budget, pops, mask_out,
               bytes_out, n_out, L, P, vmax, n_sh, n_cand,
               Ranks{n_rank, rank_stride}, 1, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
