// Paged decode attention, written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/paged_attention.py paged_attention_kernel (body
// _kernel): one decode step of grouped-query attention that reads K/V through
// a page table.  Plain C interface, no PyTorch headers: the Python side
// (repro_torch/kernels/paged_attention.py) loads the library with ctypes,
// hands in device pointers and PyTorch's current stream, and checks the
// returned cudaError_t.  The kernel allocates nothing and never synchronises.
//
//   q          (B, H, dh)                    f32 or bf16
//   k/v_pages  (n_pages, page_size, Hk, dh)  q's type
//   page_table (B, pages_per_seq)            i32 pool page ids
//   seq_lens   (B,)                          i32
//   out        (B, H, dh)                    q's type
//
// Design
// ------
// * One thread block per (sequence b, KV head kh): the G = H / Hk query heads
//   of the group are the block's rows, in the Pallas layout
//   q.reshape(B, Hk, G, dh), so head h = kh * G + g.  The TPU kernel's
//   sequential page axis (which carried the online-softmax state in VMEM
//   scratch) is a loop inside the block; the running max m, denominator l and
//   numerator acc (G x dh) stay in shared memory / registers across it.
// * Per page: every thread reads the page id itself (the TPU prefetched the
//   table as scalars), then the K and V tiles (page_size x dh) of this KV head
//   are loaded into shared memory with plain coalesced 16-byte loads, bf16
//   widened to f32.  Scores (G x page_size) are f32 FMA dots, one warp per
//   (g, slot) pair, scaled by dh^-0.5 AFTER the dot as the Pallas body does;
//   positions >= seq_len score -1e30; m, l and acc are updated exactly as
//   paged_attention.py:76-86; the output is acc / max(l, 1e-30) in q's type.
// * Only pages that hold a position < seq_len are read (the oracle gathers
//   every page of the table and masks; for finite pool contents the result is
//   the same).  seq_len > pages_per_seq * page_size makes every position of
//   the table valid, as in the oracle.  seq_len <= 0 follows the oracle, not
//   the Pallas body: every score is -1e30, the softmax is uniform over the
//   whole table and the output is the mean of its V rows (the Pallas body
//   masks the probabilities and returns 0).
// * No tensor cores: TF32's 10-bit mantissa cannot meet the f32 tolerance.
//
// Bound: bytes.  One decode step must read q, the K and V rows of the
// positions it attends to and write the output: 2 * seq_len * Hk * dh * elem
// bytes dominate, ~4 flops per byte read in f32.  This first kernel keeps one
// block per (b, kh) and walks its pages one after another without
// overlapping a page's loads with the previous page's arithmetic, so a long
// sequence is latency bound on one SM; splitting the page loop across blocks
// and double-buffering the tiles (cp.async / TMA) are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;        // query heads per KV head
constexpr int kMaxHeadDim = 256;
constexpr int kMaxPageSize = 64;
constexpr int kMaxAcc = kMaxGroup * kMaxHeadDim / kThreads;  // per thread
constexpr int kVec = 8;              // elements per load; dh % kVec == 0
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);                       // round to nearest even
}

// kVec consecutive elements (16-byte aligned) into kVec floats of shared
// memory (16-byte aligned).
__device__ __forceinline__ void load_vec(const float* __restrict__ src,
                                         float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  reinterpret_cast<float4*>(dst)[0] = a;
  reinterpret_cast<float4*>(dst)[1] = b;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ src,
                                         float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]);
  const float2 f3 = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Dynamic shared memory, in floats: K tile, V tile (page_size x dh each),
// the group's queries (G x dh), the scores / probabilities (G x page_size).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ page_table,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int H, int Hk, int dh, int page_size, int pages_per_seq,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_m[kMaxGroup], s_l[kMaxGroup], s_alpha[kMaxGroup];
  const int G = H / Hk;
  float* sK = smem;
  float* sV = sK + page_size * dh;
  float* sQ = sV + page_size * dh;
  float* sP = sQ + G * dh;

  const int b = blockIdx.x / Hk, kh = blockIdx.x % Hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seq_len = seq_lens[b];
  int n_read = pages_per_seq;            // seq_len <= 0: the whole table
  if (seq_len > 0) {
    const int need = (seq_len + page_size - 1) / page_size;
    n_read = need < pages_per_seq ? need : pages_per_seq;
  }

  const size_t grp = ((size_t)b * H + (size_t)kh * G) * dh;
  for (int i = tid; i < G * dh; i += kThreads) sQ[i] = to_f32(q[grp + i]);
  if (tid < G) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.0f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.0f;

  const size_t row_stride = (size_t)Hk * dh;          // slot to slot
  const size_t page_stride = (size_t)page_size * row_stride;
  const int vecs_per_row = dh / kVec;
  const int n_vecs = page_size * vecs_per_row;
  const int n_pairs = G * page_size;
  const int* table = page_table + (size_t)b * pages_per_seq;

  for (int p = 0; p < n_read; ++p) {
    const size_t base = (size_t)table[p] * page_stride + (size_t)kh * dh;
    __syncthreads();                     // the last page's tiles are consumed
    for (int i = tid; i < n_vecs; i += kThreads) {
      const int s = i / vecs_per_row, d = (i - s * vecs_per_row) * kVec;
      const size_t off = base + s * row_stride + d;
      load_vec(k_pages + off, sK + s * dh + d);
      load_vec(v_pages + off, sV + s * dh + d);
    }
    __syncthreads();

    for (int pair = warp; pair < n_pairs; pair += kWarps) {
      const int g = pair / page_size, s = pair - g * page_size;
      const float* qr = sQ + g * dh;
      const float* kr = sK + s * dh;
      float dot = 0.0f;
      for (int d = lane; d < dh; d += 32) dot = fmaf(qr[d], kr[d], dot);
      dot = warp_sum(dot);
      if (lane == 0)
        sP[pair] = (p * page_size + s < seq_len) ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* row = sP + g * page_size;
      float mx = kNegInf;
      for (int s = lane; s < page_size; s += 32) mx = fmaxf(mx, row[s]);
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.0f;
      for (int s = lane; s < page_size; s += 32) {
        const float e = expf(row[s] - m_new);
        row[s] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int e = tid + j * kThreads;
      if (e < G * dh) {
        const int g = e / dh, d = e - g * dh;
        const float* pr = sP + g * page_size;
        float pv = 0.0f;
        for (int s = 0; s < page_size; ++s) pv = fmaf(pr[s], sV[s * dh + d], pv);
        acc[j] = acc[j] * s_alpha[g] + pv;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int e = tid + j * kThreads;
    if (e < G * dh) {
      const float denom = fmaxf(s_l[e / dh], 1e-30f);
      out[grp + e] = from_f32<T>(acc[j] / denom);
    }
  }
}

// Opt both instantiations in to all the shared memory a block may take (227
// KB on Hopper; above 48 KB only as dynamic shared memory, on request) and
// report what is left for the dynamic part beside the static arrays.
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

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* seq_lens, void* out, int B,
           int H, int Hk, int dh, int page_size, int pages_per_seq,
           float scale, int smem_bytes, void* stream) {
  paged_attention_kernel<T>
      <<<B * Hk, kThreads, (size_t)smem_bytes, (cudaStream_t)stream>>>(
          (const T*)q, (const T*)k_pages, (const T*)v_pages,
          (const int*)page_table, (const int*)seq_lens, (T*)out, H, Hk, dh,
          page_size, pages_per_seq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The shapes the kernel takes: G, dh and page_size at most these; dh a
// multiple of the vector width.
void pa_limits(int* out) {
  out[0] = kMaxGroup;
  out[1] = kMaxHeadDim;
  out[2] = kMaxPageSize;
  out[3] = kVec;
}

// Once per device, after the library is loaded: raise both instantiations'
// dynamic shared memory limit and write the smaller of the two to max_dyn.
int paged_attention_init(int* max_dyn) {
  int other = 0;
  cudaError_t e = allow_large_smem(paged_attention_kernel<float>, max_dyn);
  if (e != cudaSuccess) return (int)e;
  e = allow_large_smem(paged_attention_kernel<__nv_bfloat16>, &other);
  if (other < *max_dyn) *max_dyn = other;
  return (int)e;
}

// One block of kThreads per (b, kv head); smem_bytes =
// 4 * (2 * page_size * dh + G * dh + G * page_size).
int pa_paged_attention_f32(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* seq_lens, void* out, int B, int H,
                           int Hk, int dh, int page_size, int pages_per_seq,
                           float scale, int smem_bytes, void* stream) {
  return launch<float>(q, k_pages, v_pages, page_table, seq_lens, out, B, H,
                       Hk, dh, page_size, pages_per_seq, scale, smem_bytes,
                       stream);
}

int pa_paged_attention_bf16(const void* q, const void* k_pages,
                            const void* v_pages, const void* page_table,
                            const void* seq_lens, void* out, int B, int H,
                            int Hk, int dh, int page_size, int pages_per_seq,
                            float scale, int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, seq_lens, out,
                               B, H, Hk, dh, page_size, pages_per_seq, scale,
                               smem_bytes, stream);
}

}  // extern "C"
