// Flash attention (prefill), written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py flash_attention_kernel (body
// _kernel): causal / sliding-window / full attention with an online softmax
// and f32 accumulation.  Plain C interface, no PyTorch headers: the Python
// side (repro_torch/kernels/flash_attention.py) loads the library with
// ctypes, hands in device pointers and PyTorch's current stream, and checks
// the returned cudaError_t.  The kernel allocates nothing and never
// synchronises.
//
//   q    (B, T, H, dh)    f32 or bf16
//   k/v  (B, S, Hk, dh)   q's type; GQA heads as given, head h reads KV head
//                         h / (H / Hk) (what jnp.repeat's expansion gives)
//   out  (B, T, H, dh)    q's type
//
// Semantics are the oracle's (repro.kernels.ref.flash_attention_ref): query
// t and key s are rel = t - s + offset apart (offset = S - T for the oracle,
// the caller's q_offset for the model's blocked_attention); causal keeps
// rel >= 0, a window (>= 0; -1 = none) keeps rel < window; scores are
// dot * dh^-0.5 (scale after the dot, as the Pallas body), masked scores
// -1e30.  A row with every key masked gets the oracle's uniform softmax over
// the S keys (the mean of V; the Pallas body returns 0 there): masked scores
// are -1e30 and the probabilities are NOT masked, so such a row sees exp(0)
// on every key, while any valid score drives the masked terms to exactly 0.
// Keys past S (the ragged last tile) score -inf and weigh exactly 0.
//
// Design
// ------
// * One block of 256 threads per (64-query tile, head, batch row).  The TPU
//   kernel's sequential kv grid axis, which carried m, l, acc in VMEM
//   scratch, is a loop inside the block; m, l (per row) and acc (64 x dh)
//   stay in registers across it.  Query tiles are launched latest first
//   (under a causal mask they carry the most keys).
// * The key range a tile needs is computed from the mask: whole tiles above
//   the diagonal and behind the window are skipped (flash_attention.py
//   52-60); a tile holding a fully masked row walks all keys (see above).
// * Per key tile: K (64 x dh) into shared memory, S = Q K^T as a 4 x 4
//   register tile per thread (f32 FMAs), the online softmax of
//   flash_attention.py 80-91 with row max / sum over the 16 threads that
//   share a row (shuffles), P into shared memory, V into the buffer K held,
//   O += P V with each thread owning 4 rows x dh/16 columns.
// * Shared-memory rows are padded to an odd stride (dh + 1, 65), so the
//   column-strided reads of K and P hit 32 different banks.
// * bf16 is widened to f32 at the 16-byte load; no tensor cores: TF32's
//   10-bit mantissa cannot meet the f32 tolerance of 3e-5.
//
// Bound.  Causal prefill at the model's widths is operations bound: 4 * B *
// H * dh flops per (query, attended key) pair against 2 bytes per element
// read once; at T = 4096 that is ~1000 flops per byte.  This first kernel
// runs FFMA out of shared memory at 64 x 64 tiles; tensor cores (wgmma on
// bf16 tiles), TMA loads and larger tiles are for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kThreads = 256;        // a 16 x 16 grid of threads
constexpr int kMaxHeadDim = 256;
constexpr int kVec = 8;              // elements per load; dh % kVec == 0
constexpr int kLdP = kBK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load_vec(const float* __restrict__ src,
                                         float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ src,
                                         float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// rows [0, 64) of a (rows, row_stride) array from element `base`, dh
// columns, into shared memory at stride ld; rows at or past n_rows are 0.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          size_t base, size_t row_stride,
                                          int n_rows, int dh, int ld,
                                          float* dst) {
  const int vpr = dh / kVec;
  for (int i = threadIdx.x; i < 64 * vpr; i += kThreads) {
    const int r = i / vpr, d = (i - r * vpr) * kVec;
    float tmp[kVec];
    if (r < n_rows) {
      load_vec(src + base + (size_t)r * row_stride + d, tmp);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) tmp[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * ld + d + j] = tmp[j];
  }
}

// NJ = output columns per thread: dh <= 16 * NJ.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int T_,
                       int S, int H, int Hk, int dh, int causal, int window,
                       int offset, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* sQ = smem;                  // kBQ x ld
  float* sKV = sQ + kBQ * ld;        // kBK x ld: K, then V
  float* sP = sKV + kBK * ld;        // kBQ x kLdP

  const int nq = (T_ + kBQ - 1) / kBQ;
  const int t0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Hk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t_last = min(t0 + kBQ, T_) - 1;

  // keys [lo(t), hi(t)) are valid for row t; both bounds grow with t
  auto lo = [&](int t) { return window >= 0 ? max(0, t + offset - window + 1) : 0; };
  auto hi = [&](int t) { return causal ? min(S, t + offset + 1) : S; };
  const int row = t0 + tid;
  const bool empty_row = tid < kBQ && row <= t_last && lo(row) >= hi(row);
  int s_begin = lo(t0), s_end = hi(t_last);
  if (__syncthreads_or(empty_row)) {
    s_begin = 0;
    s_end = S;
  }

  const size_t q_row = (size_t)H * dh, kv_row = (size_t)Hk * dh;
  load_tile(q, ((size_t)b * T_ + t0) * q_row + (size_t)h * dh, q_row,
            T_ - t0, dh, ld, sQ);

  float o[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.0f;
  }

  const size_t kv_base = (size_t)b * S * kv_row + (size_t)kh * dh;
  for (int s0 = (s_begin / kBK) * kBK; s0 < s_end; s0 += kBK) {
    __syncthreads();                   // Q is loaded / the last V is consumed
    load_tile(k, kv_base + (size_t)s0 * kv_row, kv_row, S - s0, dh, ld, sKV);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKV[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (s >= S) {
          x = -INFINITY;
        } else {
          const int rel = t - s + offset;
          bool ok = !causal || rel >= 0;
          if (window >= 0) ok = ok && rel < window;
          if (!ok) x = kNegInf;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();                   // K is consumed; P is written
    load_tile(v, kv_base + (size_t)s0 * kv_row, kv_row, S - s0, dh, ld, sKV);
    __syncthreads();

#pragma unroll 4
    for (int s = 0; s < kBK; ++s) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kLdP + s];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < dh ? sKV[s * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t > t_last) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* dst = out + ((size_t)b * T_ + t) * q_row + (size_t)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) store(dst + d, o[i][j] * inv);
    }
  }
}

inline size_t smem_bytes(int dh) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (dh + 1) + (size_t)kBQ * kLdP);
}

template <typename T>
cudaError_t init_type(int* max_dyn) {
  cudaError_t e;
  if ((e = allow_smem(flash_attention_kernel<T, 2>, max_dyn))) return e;
  if ((e = allow_smem(flash_attention_kernel<T, 4>, max_dyn))) return e;
  if ((e = allow_smem(flash_attention_kernel<T, 8>, max_dyn))) return e;
  if ((e = allow_smem(flash_attention_kernel<T, 10>, max_dyn))) return e;
  return allow_smem(flash_attention_kernel<T, 16>, max_dyn);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T_, int S, int H, int Hk, int dh, int causal, int window,
           int offset, float scale, void* stream) {
  if (B < 1 || T_ < 1 || S < 1 || Hk < 1 || H % Hk || dh % kVec ||
      dh < kVec || dh > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T_ + kBQ - 1) / kBQ, H, B);
  const size_t smem = smem_bytes(dh);
  cudaStream_t st = (cudaStream_t)stream;
  const T* qq = (const T*)q;
  const T* kk = (const T*)k;
  const T* vv = (const T*)v;
  T* oo = (T*)out;
#define FA_LAUNCH(NJ)                                                       \
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, st>>>(              \
      qq, kk, vv, oo, T_, S, H, Hk, dh, causal, window, offset, scale)
  if (dh <= 32) FA_LAUNCH(2);
  else if (dh <= 64) FA_LAUNCH(4);
  else if (dh <= 128) FA_LAUNCH(8);
  else if (dh <= 160) FA_LAUNCH(10);
  else FA_LAUNCH(16);
#undef FA_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, after the library is loaded: let every instantiation take
// all the dynamic shared memory a block may, and write the least of them to
// max_dyn (the wrapper checks smem_bytes(dh) against it).
int flash_attention_init(int* max_dyn) {
  *max_dyn = 1 << 30;
  cudaError_t e = init_type<float>(max_dyn);
  if (e != cudaSuccess) return (int)e;
  return (int)init_type<__nv_bfloat16>(max_dyn);
}

// window < 0: no window.  causal: 0 or 1.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int T, int S, int H, int Hk, int dh,
                        int causal, int window, int offset, float scale,
                        void* stream) {
  return launch<float>(q, k, v, out, B, T, S, H, Hk, dh, causal, window,
                       offset, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int T, int S, int H, int Hk, int dh,
                         int causal, int window, int offset, float scale,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, T, S, H, Hk, dh, causal,
                               window, offset, scale, stream);
}

}  // extern "C"
