// Buffer-pool kernels of the batched simulator, written for Hopper (sm_90a).
//
// Three kernels, one C entry point each (plus one for the second key type of
// the eviction kernel).  Plain C interface, no PyTorch headers: the Python
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
//   sizes on the matrix unit, O(P^2); here the block SORTS the lane's row once
//   in shared memory (bitonic, O(P log^2 P), a few microseconds) and the rest
//   is a prefix sum.  Each page becomes one 64-bit word
//       [takes no part : 1][~order-preserving key : 32][page index : 31]
//   so an ascending sort of the words is the service order, ties by index
//   included, with the pages that take no part (not wanted / padding up to
//   the power of two) at the end.  Keys are compared as
//   integers built from their own bits: an integer key never passes through
//   a float (queue keys use ~30 bits; [2^24, 2^24 + 1] must stay distinct),
//   and a float key maps monotonically (-0.0 is read as +0.0 first, so equal
//   floats stay tied and fall to the index).
// * Bytes are accumulated in float64 and compared with the f32 thresholds
//   widened to double.  Page sizes are whole byte counts, so every partial
//   sum is exact and independent of the order it is taken in (the block scan
//   adds in another order than a sequential sum); the plain PyTorch versions
//   (repro_torch/kernels/ref.py) do the same and agree bit for bit.  The
//   prefix is never stored: a thread owns a contiguous run of the sorted row,
//   the block scans the threads' totals, and each later pass re-walks its run
//   from the thread's offset, reading sizes through the sorted indices.
// * No tensor cores: an f32 tensor-core product would round sizes to TF32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRun = 16;          // sorted entries one thread owns, at most
constexpr int kMaxThreads = 1024;
constexpr int kMaxHCap = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kOutBit = 1ull << 63;
constexpr uint32_t kIdxMask = 0x7fffffffu;

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

__device__ __forceinline__ double warp_inclusive(double v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(kFull, v, o);
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
// batched_evict — replaces src/repro/kernels/pbm_timeline.py
// batched_evict_kernel (body _kernel): per lane, the evict mask = evictable
// pages taken in service order among the top `vmax` while the bytes freed
// BEFORE the page are < need_free, and need_free > 0.  A page that is not
// evictable sorts with the key type's minimum (-inf / INT_MIN), as in the
// plain version: an evictable page whose key IS that minimum ties with those
// pages by index and can fall outside the top `vmax`.
//
// Bound: bytes.  It must read L*P*(4 + 1) + 4*P and write L*P bytes, a
// fraction of a microsecond at 3.35 TB/s, so in practice one launch.  Its own
// time is the sort of the row; a lane with nothing to free skips it, and only
// the first min(vmax, P) sorted pages are summed.
// ---------------------------------------------------------------------------
template <typename K>
__global__ void __launch_bounds__(kMaxThreads)
batched_evict_kernel(const K* __restrict__ key, const float* __restrict__ sizes,
                     int sizes_stride, const uint8_t* __restrict__ evictable,
                     const float* __restrict__ need_free,
                     uint8_t* __restrict__ out, int P, int vmax, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_word = reinterpret_cast<uint64_t*>(smem);
  __shared__ double s_wtot[32];

  const int lane = blockIdx.x;
  const size_t row = (size_t)lane * P;
  const float need = need_free[lane];
  if (!(need > 0.0f)) {               // block-uniform: nothing to free
    for (int p = threadIdx.x; p < P; p += blockDim.x) out[row + p] = 0;
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool ev = i < P && evictable[row + i];
    s_word[i] = sort_word<K>(i < P, ev ? key[row + i] : lowest_key<K>(), i);
  }
  __syncthreads();
  bitonic_sort(s_word, n);

  const float* sz_row = sizes + (size_t)lane * sizes_stride;
  const int cap = vmax < P ? vmax : P;        // candidates: sorted [0, cap)
  const int run_len = n / blockDim.x;
  const int base = threadIdx.x * run_len;
  double total = 0.0;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i < cap) {
      const int idx = (int)(s_word[i] & kIdxMask);
      if (evictable[row + idx]) total += (double)sz_row[idx];
    }
  }
  double before = block_exclusive(total, s_wtot);
  const double need_d = (double)need;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    const int idx = (int)(s_word[i] & kIdxMask);
    if (idx >= P) continue;                   // padding
    const bool ev = i < cap && evictable[row + idx];
    out[row + idx] = (ev && before < need_d) ? 1 : 0;
    if (ev) before += (double)sz_row[idx];
  }
}

// ---------------------------------------------------------------------------
// fifo_grant — replaces src/repro/kernels/pbm_timeline.py fifo_grant_kernel
// (body _grant_kernel): per lane, pop the request queue in service order with
// strict head-of-line admission against `budget` bytes and min(pops, vmax)
// pops; key < 0 = not wanted.  Outputs the grant mask, the granted bytes and
// the number of grants.
//
// Bound: bytes, L*P*4 + 4*P in and L*P + 8*L out: one launch.  After the sort
// a wanted page's rank is its position, so "fits" is one comparison of the
// running byte sum, and the head of line is the smallest position that does
// not fit (a shared-memory atomicMin): the TPU kernel's second O(P^2) pass
// ("any non-fitting predecessor") disappears.  The granted pages are exactly
// the positions below the head, so the granted bytes are the running sum at
// the last of them: no reduction over sizes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxThreads)
fifo_grant_kernel(const int* __restrict__ key, const float* __restrict__ sizes,
                  int sizes_stride, const float* __restrict__ budget,
                  const int* __restrict__ pops, uint8_t* __restrict__ mask_out,
                  float* __restrict__ bytes_out, int* __restrict__ n_out,
                  int P, int vmax, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_word = reinterpret_cast<uint64_t*>(smem);
  __shared__ double s_wtot[32];
  __shared__ int s_part;            // pages taking part (wanted)
  __shared__ int s_head;            // first sorted position that does not fit

  const int lane = blockIdx.x;
  const size_t row = (size_t)lane * P;
  if (threadIdx.x == 0) {
    s_part = 0;
    s_head = 0x7fffffff;
  }
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i < P ? key[row + i] : -1;
    mine += (k >= 0);
    s_word[i] = sort_word<int>(k >= 0, k, i);
  }
  if (mine) atomicAdd(&s_part, mine);
  __syncthreads();
  if (s_part == 0) {                  // block-uniform: empty queue
    for (int p = threadIdx.x; p < P; p += blockDim.x) mask_out[row + p] = 0;
    if (threadIdx.x == 0) {
      bytes_out[lane] = 0.0f;
      n_out[lane] = 0;
    }
    return;
  }
  bitonic_sort(s_word, n);

  const float* sz_row = sizes + (size_t)lane * sizes_stride;
  int lim = vmax < P ? vmax : P;      // positions that may be granted at all
  const int n_pops = pops[lane];
  lim = n_pops < lim ? n_pops : lim;
  lim = lim < s_part ? lim : s_part;
  lim = lim > 0 ? lim : 0;
  const int run_len = n / blockDim.x;
  const int base = threadIdx.x * run_len;
  double total = 0.0;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i < lim) total += (double)sz_row[s_word[i] & kIdxMask];
  }
  const double offset = block_exclusive(total, s_wtot);
  const double budget_d = (double)budget[lane];
  double csum = offset;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    if (i >= lim) break;
    csum += (double)sz_row[s_word[i] & kIdxMask];
    if (!(csum <= budget_d)) {
      atomicMin(&s_head, i);
      break;                          // later positions are larger
    }
  }
  __syncthreads();

  const int n_grant = s_head < lim ? s_head : lim;
  if (threadIdx.x == 0) {
    n_out[lane] = n_grant;
    if (n_grant == 0) bytes_out[lane] = 0.0f;
  }
  csum = offset;
  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    const int idx = (int)(s_word[i] & kIdxMask);
    if (idx >= P) continue;                   // padding
    mask_out[row + idx] = i < n_grant ? 1 : 0;
    if (i < n_grant) {
      csum += (double)sz_row[idx];
      if (i == n_grant - 1) bytes_out[lane] = (float)csum;
    }
  }
}

// ---------------------------------------------------------------------------
// wake_solve — replaces src/repro/kernels/pbm_timeline.py wake_solve_kernel
// (body _wake_kernel): per lane, with the queue frozen, the fine step at
// which the serial I/O server grants each wanted page.  rank and
// prefix-inclusive bytes for ALL wanted pages; cnt_k = entries whose prefix
// fits credit0 + k*inc, k = 1..h_cap; n_k = min(cnt_k, n_{k-1} + pops);
// per page 1 + #{k : n_k < rank + 1}; sentinel h_cap + 1.
//
// Bound: bytes, L*P*4 + 4*P in and 4*L*P out: one launch.  The three
// sequential grid phases of the TPU kernel are three block phases here:
// (1) sort and running byte sum, each thread counting which of its pages fit
// each cnt_k (a warp reduction, then one integer shared-memory atomic per
// warp and k: order-free); (2) the h_cap steps of the recursion in one
// thread (the TPU's h_cap x h_cap min-plus tile is 64 dependent integer
// operations here); (3) one pass over n_k per page.  credit0 + k*inc is a
// rounded f32 multiply then a rounded f32 add (__fmul_rn / __fadd_rn), never
// a fused multiply-add, to reproduce the reference's threshold bit for bit.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxThreads)
wake_solve_kernel(const int* __restrict__ key, const float* __restrict__ sizes,
                  int sizes_stride, const float* __restrict__ credit0,
                  const float* __restrict__ inc, const int* __restrict__ pops,
                  int* __restrict__ out, int P, int h_cap, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_word = reinterpret_cast<uint64_t*>(smem);
  __shared__ double s_wtot[32];
  __shared__ double s_thr[kMaxHCap];
  __shared__ int s_cnt[kMaxHCap];
  __shared__ long long s_nk[kMaxHCap];
  __shared__ int s_part;            // pages taking part (wanted)

  const int lane = blockIdx.x;
  const size_t row = (size_t)lane * P;
  const float c0 = credit0[lane];
  const float step_inc = inc[lane];
  if (threadIdx.x == 0) s_part = 0;
  for (int k = threadIdx.x; k < h_cap; k += blockDim.x) {
    s_thr[k] = (double)__fadd_rn(c0, __fmul_rn((float)(k + 1), step_inc));
    s_cnt[k] = 0;
  }
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i < P ? key[row + i] : -1;
    mine += (k >= 0);
    s_word[i] = sort_word<int>(k >= 0, k, i);
  }
  if (mine) atomicAdd(&s_part, mine);
  __syncthreads();
  const int n_part = s_part;
  if (n_part == 0) {                  // block-uniform: empty queue
    for (int p = threadIdx.x; p < P; p += blockDim.x) out[row + p] = h_cap + 1;
    return;
  }
  bitonic_sort(s_word, n);

  const float* sz_row = sizes + (size_t)lane * sizes_stride;
  const int run_len = n / blockDim.x;          // <= kMaxRun
  const int base = threadIdx.x * run_len;
  double csum[kMaxRun];
  double total = 0.0;
#pragma unroll
  for (int c = 0; c < kMaxRun; ++c) {
    const int i = base + c;
    if (c < run_len && i < n_part)
      total += (double)sz_row[s_word[i] & kIdxMask];
    csum[c] = total;                           // inclusive, within the run
  }
  const double offset = block_exclusive(total, s_wtot);
  const int lane_id = threadIdx.x & 31;
  for (int k = 0; k < h_cap; ++k) {
    const double thr = s_thr[k];
    int fit = 0;
#pragma unroll
    for (int c = 0; c < kMaxRun; ++c)
      fit += (c < run_len && base + c < n_part && offset + csum[c] <= thr);
    fit = __reduce_add_sync(kFull, fit);
    if (lane_id == 0 && fit) atomicAdd(&s_cnt[k], fit);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int n_pops = pops[lane];
    const long long pop = n_pops > 0 ? n_pops : 0;
    long long granted = 0;
    for (int k = 0; k < h_cap; ++k) {
      const long long c = s_cnt[k];
      granted = c < granted + pop ? c : granted + pop;
      s_nk[k] = granted;
    }
  }
  __syncthreads();

  for (int c = 0; c < run_len; ++c) {
    const int i = base + c;
    const int idx = (int)(s_word[i] & kIdxMask);
    if (idx >= P) continue;                    // padding
    int step = h_cap + 1;
    if (i < n_part) {
      step = 1;
      for (int k = 0; k < h_cap; ++k) step += (s_nk[k] < (long long)i + 1);
    }
    out[row + idx] = step;
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

}  // namespace

extern "C" {

int pbm_max_h_cap() { return kMaxHCap; }
// Most sorted entries a row may have: kMaxRun per thread of a full block.
int pbm_max_sort_len() { return kMaxRun * kMaxThreads; }

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
  return (int)e;
}

// `n` is the sorted row length: a power of two, >= 32 and >= P; each block
// takes 8 * n bytes of dynamic shared memory.

int pbm_batched_evict_f32(const void* key, const void* sizes, int sizes_stride,
                          const void* evictable, const void* need_free,
                          void* out, int L, int P, int vmax, int n,
                          void* stream) {
  batched_evict_kernel<float>
      <<<L, threads_for(n), 8 * (size_t)n, (cudaStream_t)stream>>>(
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
      <<<L, threads_for(n), 8 * (size_t)n, (cudaStream_t)stream>>>(
          (const int*)key, (const float*)sizes, sizes_stride,
          (const uint8_t*)evictable, (const float*)need_free, (uint8_t*)out, P,
          vmax, n);
  return (int)cudaGetLastError();
}

int pbm_fifo_grant(const void* key, const void* sizes, int sizes_stride,
                   const void* budget, const void* pops, void* mask_out,
                   void* bytes_out, void* n_out, int L, int P, int vmax, int n,
                   void* stream) {
  fifo_grant_kernel<<<L, threads_for(n), 8 * (size_t)n,
                      (cudaStream_t)stream>>>(
      (const int*)key, (const float*)sizes, sizes_stride, (const float*)budget,
      (const int*)pops, (uint8_t*)mask_out, (float*)bytes_out, (int*)n_out, P,
      vmax, n);
  return (int)cudaGetLastError();
}

int pbm_wake_solve(const void* key, const void* sizes, int sizes_stride,
                   const void* credit0, const void* inc, const void* pops,
                   void* out, int L, int P, int h_cap, int n, void* stream) {
  wake_solve_kernel<<<L, threads_for(n), 8 * (size_t)n,
                      (cudaStream_t)stream>>>(
      (const int*)key, (const float*)sizes, sizes_stride, (const float*)credit0,
      (const float*)inc, (const int*)pops, (int*)out, P, h_cap, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
