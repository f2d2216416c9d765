// Paged decode attention, written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/paged_attention.py paged_attention_kernel (body
// _kernel): one decode step of grouped-query attention that reads K/V through
// a page table.  Plain C interface, no PyTorch headers: the Python side
// (repro_torch/kernels/paged_attention.py) loads the library with ctypes,
// hands in device pointers, scratch it allocated and PyTorch's current
// stream, and checks the returned cudaError_t.  The kernels allocate nothing
// and never synchronise.
//
//   q          (B, H, dh)                    f32 or bf16
//   k/v_pages  (n_pages, page_size, Hk, dh)  q's type
//   page_table (B, pages_per_seq)            i32 pool page ids
//   seq_lens   (B,)                          i32
//   out        (B, H, dh)                    q's type
//
// Bound: bytes.  One decode step must read q, the K and V rows of the
// positions it attends to and write the output: 2 * seq_len * Hk * dh * elem
// bytes dominate, ~4 flops per byte read in f32, far below the ~20 at which
// the card's f32 units would set the pace.  What a bytes-bound kernel needs
// is enough blocks on the card and enough loads in flight in each; the
// first port had neither (one block per (sequence, KV head), 2 blocks at
// B = 1, each walking its pages load - barrier - compute - barrier, ~12 us
// a page).  This kernel has both and is then held back by its instruction
// count (the FMAs and shared-memory reads of scores and P V at G <= 16, a
// few warps an SM), not by its bytes.
//
// Design (flash-decoding)
// -----------------------
// * The page axis is split.  paged_attention_split runs one block per
//   (split, sequence b, KV head kh); a split is a contiguous range of
//   pages_per_split table pages, chosen by the wrapper from the shapes alone
//   (B, Hk, pages_per_seq and the SM count; seq_lens is never read on the
//   host).  The G = H / Hk query heads of the group are the block's rows, in
//   the Pallas layout q.reshape(B, Hk, G, dh), so head h = kh * G + g.
// * Each split writes an f32 partial to scratch: the running max m, the
//   denominator l and the unnormalised numerator acc (G x dh);
//   paged_attention_combine then merges the splits of each (b, h):
//   M = max m_s, out = sum exp(m_s - M) acc_s / max(sum exp(m_s - M) l_s,
//   1e-30).  With one split the first kernel writes the output itself.
// * Inside a block the split's token rows stream through a ring of kStages
//   stages of kRows rows (not whole pages: kernel_limits' f32 page of 64 x
//   256 is 128 KB of K and V) by cp.async, 16 bytes a thread, several rows
//   per barrier; a row's address comes from the split's page ids, which
//   the block reads into shared memory once.  While one stage is scored,
//   the next kStages - 1 are in flight.  Rows past the split's tokens are
//   zero-filled.
// * P V: each thread owns 4 columns of up to 8 query heads, so one V load
//   feeds every head it holds and the row's FMAs are independent.
// * Scores: 8 lanes per token row, each over 8-element slices of dh and
//   two rows, f32 FMAs, reduced by three shuffles; scaled by dh^-0.5 AFTER
//   the dot as the Pallas body does; positions >= seq_len score -1e30.
//   m, l and acc are updated per stage exactly as paged_attention.py:76-86.  bf16 rows stay
//   bf16 in shared memory and widen to f32 as they are read.
// * The oracle's semantics hold split or not.  Only pages that hold a
//   position < seq_len are read (the oracle gathers every page of the table
//   and masks; for finite pool contents the result is the same);
//   seq_len > pages_per_seq * page_size makes every position of the table
//   valid.  seq_len <= 0 follows the oracle, not the Pallas body: every page
//   of the table is read, every score is -1e30, the softmax is uniform and
//   the output is the mean of the table's V rows (every non-empty split
//   reports m = -1e30, so all carry weight 1).  Repeated page ids read the
//   same page.  A split that starts past the pages a sequence reads writes
//   m = -inf, l = 0, acc = 0: its weight exp(-inf - M) is 0, and M is
//   finite because split 0 always holds a page, so exp(-inf - (-inf)) never
//   forms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;            // token rows per stage (= warp width)
constexpr int kStages = 3;           // stages in the ring
constexpr int kLanesPerRow = 8;      // lanes that share one row's dot
static_assert(kRows == kWarps * 2 * (32 / kLanesPerRow), "two rows a lane");
constexpr int kMaxGroup = 16;        // query heads per KV head
constexpr int kMaxHeadDim = 256;
constexpr int kMaxPageSize = 64;
constexpr int kMaxSplits = 256;
// query heads a thread accumulates in P V: the group over the fewest
// thread groups (2, at dh = 256)
constexpr int kMaxGPer = kMaxGroup / (kThreads / (kMaxHeadDim / 4));
constexpr int kVec = 8;              // dh % kVec == 0
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// kVec consecutive elements of shared memory as f32.
__device__ __forceinline__ void read8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
// bf16 is the top half of an f32: widen by shifting, exactly, without
// taking the address of the loaded word (which would put it on the stack).
__device__ __forceinline__ void read8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  x[0] = __uint_as_float(raw.x << 16);
  x[1] = __uint_as_float(raw.x & 0xffff0000u);
  x[2] = __uint_as_float(raw.y << 16);
  x[3] = __uint_as_float(raw.y & 0xffff0000u);
  x[4] = __uint_as_float(raw.z << 16);
  x[5] = __uint_as_float(raw.z & 0xffff0000u);
  x[6] = __uint_as_float(raw.w << 16);
  x[7] = __uint_as_float(raw.w & 0xffff0000u);
}

// 4 consecutive elements of shared memory as f32.
__device__ __forceinline__ void read4(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void read4(const __nv_bfloat16* p, float* x) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(raw.x << 16);
  x[1] = __uint_as_float(raw.x & 0xffff0000u);
  x[2] = __uint_as_float(raw.y << 16);
  x[3] = __uint_as_float(raw.y & 0xffff0000u);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Dynamic shared memory: kStages x (K rows, V rows) of kRows x dh in T, the
// group's queries (G x dh f32), the scores / probabilities (G x kRows f32),
// the split's page ids (pages_per_split i32).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
paged_attention_split(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ page_table,
                   const int* __restrict__ seq_lens, T* __restrict__ out,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int H, int Hk, int dh, int page_size, int pages_per_seq,
                   int pages_per_split, int n_splits, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_m[kMaxGroup], s_l[kMaxGroup], s_alpha[kMaxGroup];
  const int G = H / Hk;
  const int tile = kRows * dh;                       // elements
  T* sKV = reinterpret_cast<T*>(smem_raw);           // stage st: K, then V
  float* sQ = reinterpret_cast<float*>(sKV + (size_t)kStages * 2 * tile);
  float* sP = sQ + G * dh;
  int* s_pages = reinterpret_cast<int*>(sP + G * kRows);  // the split's ids

  const int split = blockIdx.x;
  const int b = blockIdx.y / Hk, kh = blockIdx.y % Hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seq_len = seq_lens[b];
  int n_read = pages_per_seq;            // seq_len <= 0: the whole table
  if (seq_len > 0) {
    const int need = (seq_len + page_size - 1) / page_size;
    n_read = need < pages_per_seq ? need : pages_per_seq;
  }
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, n_read);
  const int n_tok = max(0, p_end - p_begin) * page_size;
  const int n_chunks = (n_tok + kRows - 1) / kRows;

  const size_t grp = ((size_t)b * H + (size_t)kh * G) * dh;
  for (int i = tid; i < G * dh; i += kThreads) sQ[i] = to_f32(q[grp + i]);
  if (tid < G) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.0f;
  }
  // the split's page ids, read once: a copy's address then waits on no
  // global load
  const int* table = page_table + (size_t)b * pages_per_seq + p_begin;
  for (int i = tid; i < p_end - p_begin; i += kThreads) s_pages[i] = table[i];
  __syncthreads();
  const size_t row_stride = (size_t)Hk * dh;          // slot to slot
  const size_t page_stride = (size_t)page_size * row_stride;
  constexpr int kPer16 = 16 / sizeof(T);              // elements a copy
  // each copying thread owns one 16-byte piece of a row, K and V both
  const int pieces = dh / kPer16, rows_per_pass = kThreads / pieces;
  const int my_piece = tid % pieces, my_row = tid / pieces;

  // Rows past the split's tokens are zero-filled, not skipped: the P V
  // loop below runs over all kRows rows with their probabilities at 0.
  auto issue = [&](int c) {
    if (my_row >= rows_per_pass) return;
    T* dst = sKV + (size_t)(c % kStages) * 2 * tile + my_piece * kPer16;
    for (int r = my_row; r < kRows; r += rows_per_pass) {
      const int tok = c * kRows + r;
      T* dk = dst + r * dh;
      if (tok < n_tok) {
        const int pi = tok / page_size;
        const size_t src = (size_t)s_pages[pi] * page_stride +
                           (size_t)(tok - pi * page_size) * row_stride +
                           (size_t)kh * dh + my_piece * kPer16;
        cp_async16(dk, k_pages + src);
        cp_async16(dk + tile, v_pages + src);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dk + tile) = make_uint4(0, 0, 0, 0);
      }
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();                  // empty groups keep the count even
  }

  // P V: each thread owns 4 consecutive columns of up to kMaxGPer query
  // heads (g = gg, gg + g_groups, ...), so one V load feeds several heads
  // and the FMAs of a row are independent of each other.
  const int n_dvec = dh / 4, g_groups = kThreads / n_dvec;
  const int dvec = tid % n_dvec, gg = tid / n_dvec;
  const bool pv_thread = gg < g_groups;
  float acc[kMaxGPer][4];
#pragma unroll
  for (int i = 0; i < kMaxGPer; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[i][x] = 0.0f;

  const int sub = lane / kLanesPerRow, part = lane % kLanesPerRow;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + kStages - 1 < n_chunks) issue(c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();       // stage c has landed
    __syncthreads();
    const T* sK = sKV + (size_t)(c % kStages) * 2 * tile;
    const T* sV = sK + tile;
    const int nt = min(kRows, n_tok - c * kRows);
    const int pos0 = p_begin * page_size + c * kRows;

    // scores: 8 lanes a row, each lane two rows (ra and ra + 4) so that
    // each slice of q read from shared memory serves both
    {
      const int ra = warp * (kRows / kWarps) + sub, rb = ra + 4;
      float da[kMaxGroup], db[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) da[g] = db[g] = 0.0f;
      for (int d = part * kVec; d < dh; d += kLanesPerRow * kVec) {
        float ka[kVec], kb[kVec];
        read8(sK + ra * dh + d, ka);
        read8(sK + rb * dh + d, kb);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            float qx[kVec];
            read8(sQ + g * dh + d, qx);
#pragma unroll
            for (int i = 0; i < kVec; ++i) {
              da[g] = fmaf(qx[i], ka[i], da[g]);
              db[g] = fmaf(qx[i], kb[i], db[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
#pragma unroll
          for (int o = 1; o < kLanesPerRow; o <<= 1) {
            da[g] += __shfl_xor_sync(kFull, da[g], o);
            db[g] += __shfl_xor_sync(kFull, db[g], o);
          }
          if (part == 0) {
            sP[g * kRows + ra] = ra >= nt ? -INFINITY
                : (pos0 + ra < seq_len ? da[g] * scale : kNegInf);
            sP[g * kRows + rb] = rb >= nt ? -INFINITY
                : (pos0 + rb < seq_len ? db[g] * scale : kNegInf);
          }
        }
      }
    }
    __syncthreads();

    // the online softmax of this stage, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* row = sP + g * kRows;
      const float x = row[lane];
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float e = expf(x - m_new);
      row[lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    if (pv_thread) {
#pragma unroll
      for (int i = 0; i < kMaxGPer; ++i) {
        const int g = gg + i * g_groups;
        if (g < G) {
          const float a = s_alpha[g];
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[i][x] *= a;
        }
      }
#pragma unroll 4
      for (int t = 0; t < kRows; ++t) {
        float v[4];
        read4(sV + t * dh + 4 * dvec, v);
#pragma unroll
        for (int i = 0; i < kMaxGPer; ++i) {
          const int g = gg + i * g_groups;
          if (g < G) {
            const float p = sP[g * kRows + t];
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[i][x] = fmaf(p, v[x], acc[i][x]);
          }
        }
      }
    }
    __syncthreads();                    // the stage and sP are consumed
  }
  cp_async_wait<0>();

  if (!pv_thread) return;
  const size_t bh0 = (size_t)b * H + (size_t)kh * G;
#pragma unroll
  for (int i = 0; i < kMaxGPer; ++i) {
    const int g = gg + i * g_groups;
    if (g >= G) continue;
    const size_t bh = bh0 + g;
    if (n_splits == 1) {
      const float inv = 1.0f / fmaxf(s_l[g], 1e-30f);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        store(out + bh * dh + 4 * dvec + x, acc[i][x] * inv);
      continue;
    }
    if (dvec == 0) {
      float* ml = part_ml + (bh * n_splits + split) * 2;
      ml[0] = n_chunks ? s_m[g] : -INFINITY;
      ml[1] = s_l[g];
    }
    float* dst = part_acc + (bh * n_splits + split) * dh + 4 * dvec;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// One block per (b, h): merge the splits' partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int dh, int n_splits) {
  __shared__ float s_w[kMaxSplits];
  __shared__ float s_den;
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_splits * 2;
  const int tid = threadIdx.x;
  if (tid < 32) {
    float mx = -INFINITY;
    for (int s = tid; s < n_splits; s += 32) mx = fmaxf(mx, ml[2 * s]);
    mx = warp_max(mx);                  // finite: split 0 holds a page
    float den = 0.0f;
    for (int s = tid; s < n_splits; s += 32) {
      const float w = expf(ml[2 * s] - mx);
      s_w[s] = w;
      den = fmaf(w, ml[2 * s + 1], den);
    }
    den = warp_sum(den);
    if (tid == 0) s_den = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const float* acc = part_acc + bh * n_splits * dh;
  for (int d = tid; d < dh; d += kThreads) {
    float x = 0.0f;
    for (int s = 0; s < n_splits; ++s)
      x = fmaf(s_w[s], acc[(size_t)s * dh + d], x);
    store(out + bh * dh + d, x / s_den);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* seq_lens, void* out,
           void* part_ml, void* part_acc, int B, int H, int Hk, int dh,
           int page_size, int pages_per_seq, int pages_per_split,
           int n_splits, float scale, int smem_bytes, void* stream) {
  if (n_splits < 1 || n_splits > kMaxSplits || pages_per_split < 1 ||
      (n_splits - 1) * pages_per_split >= pages_per_seq ||
      n_splits * pages_per_split < pages_per_seq)
    return (int)cudaErrorInvalidValue;  // not a partition of the table
  cudaStream_t st = (cudaStream_t)stream;
  paged_attention_split<T>
      <<<dim3(n_splits, B * Hk), kThreads, (size_t)smem_bytes, st>>>(
          (const T*)q, (const T*)k_pages, (const T*)v_pages,
          (const int*)page_table, (const int*)seq_lens, (T*)out,
          (float*)part_ml, (float*)part_acc, H, Hk, dh, page_size,
          pages_per_seq, pages_per_split, n_splits, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return (int)e;
  paged_attention_combine<T><<<B * H, kThreads, 0, st>>>(
      (const float*)part_ml, (const float*)part_acc, (T*)out, dh, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The shapes the kernel takes: G, dh and page_size at most these; dh a
// multiple of the vector width; at most this many splits; the token rows
// of one stage and the stages of the ring (the wrapper sizes shared memory
// from them).
void pa_limits(int* out) {
  out[0] = kMaxGroup;
  out[1] = kMaxHeadDim;
  out[2] = kMaxPageSize;
  out[3] = kVec;
  out[4] = kMaxSplits;
  out[5] = kRows;
  out[6] = kStages;
}

// Once per device, after the library is loaded: raise both instantiations'
// dynamic shared memory limit and write the smaller of the two to max_dyn.
int paged_attention_init(int* max_dyn) {
  *max_dyn = 1 << 30;
  cudaError_t e = allow_smem(paged_attention_split<float>, max_dyn);
  if (e != cudaSuccess) return (int)e;
  return (int)allow_smem(paged_attention_split<__nv_bfloat16>, max_dyn);
}

// part_ml (B, H, n_splits, 2) and part_acc (B, H, n_splits, dh) f32 scratch
// (unused at one split); smem_bytes = kStages * 2 * kRows * dh * elem +
// 4 * (G * dh + G * kRows + pages_per_split).
int pa_paged_attention_f32(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* seq_lens, void* out, void* part_ml,
                           void* part_acc, int B, int H, int Hk, int dh,
                           int page_size, int pages_per_seq,
                           int pages_per_split, int n_splits, float scale,
                           int smem_bytes, void* stream) {
  return launch<float>(q, k_pages, v_pages, page_table, seq_lens, out,
                       part_ml, part_acc, B, H, Hk, dh, page_size,
                       pages_per_seq, pages_per_split, n_splits, scale,
                       smem_bytes, stream);
}

int pa_paged_attention_bf16(const void* q, const void* k_pages,
                            const void* v_pages, const void* page_table,
                            const void* seq_lens, void* out, void* part_ml,
                            void* part_acc, int B, int H, int Hk, int dh,
                            int page_size, int pages_per_seq,
                            int pages_per_split, int n_splits, float scale,
                            int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, seq_lens,
                               out, part_ml, part_acc, B, H, Hk, dh,
                               page_size, pages_per_seq, pages_per_split,
                               n_splits, scale, smem_bytes, stream);
}

}  // extern "C"
