// Chunkwise mLSTM / gated linear attention, written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mlstm.py mlstm_chunked_kernel (body _kernel;
// oracle repro.kernels.ref.gla_ref):
//   C_t = a_t C_{t-1} + i_t k_t v_t^T     n_t = a_t n_{t-1} + i_t k_t
//   y_t = (q_t C_t) / max(|q_t . n_t|, 1)          q scaled by K^-0.5
// per (batch, head), chunk by chunk, C (K x P) and n (K) carried in f32.
// Plain C interface, no PyTorch headers: the Python side
// (repro_torch/kernels/mlstm.py) loads the library with ctypes, hands in
// device pointers and PyTorch's current stream, and checks the returned
// cudaError_t.  The kernel allocates nothing and never synchronises.
//
//   q/k  (B, T, H, K)   f32 or bf16
//   v    (B, T, H, P)   q's type
//   a/i  (B, T, H)      f32: forget decay in (0, 1], input gate (up to e^10)
//   y    (B, T, H, P)   q's type
//
// Design
// ------
// * The Pallas kernel keeps the whole state C (K x P) in VMEM.  At
//   xLSTM-350M's width K = P = 512 that is 1 MB of f32, far above a block's
//   227 KB of shared memory.  So P is split over blocks: one block of 256
//   threads per (32-column slice of P, head, batch row) owns C[:, p0:p0+32]
//   (64 KB at K = 512) in shared memory across the loop over chunks, and
//   recomputes the normaliser n (K), which does not depend on P.  At B = 4
//   that is 4 x 4 x 16 = 256 blocks instead of 16.
// * Per chunk of 64 steps, as mlstm.py 309-348: warp 0 forms cum = the
//   running sum of log(max(a, 1e-20)); the K contraction is tiled by 32:
//   each (q, k) tile pair accumulates Q K^T (64 x 64, 16 per thread),
//   q . C (64 x 32, 8 per thread) and q . n (64) in registers; then
//     W[q, s] = (q_q . k_s) exp(cum_q - cum_s) i_s     for s <= q only
//     y[q, p] = (sum_s W[q, s] v[s, p] + exp(cum_q) q_q . C[:, p])
//               / max(|sum_s W[q, s] + exp(cum_q) q_q . n|, 1)
//   and, with k tiles read once more,
//     C[k, p] = C[k, p] exp(cum_last) + sum_s k_s[k] exp(cum_last - cum_s) i_s v[s, p]
//     n[k]    = n[k] exp(cum_last) + sum_s k_s[k] exp(cum_last - cum_s) i_s.
//   Every product is an f32 FMA out of shared memory; the input gate goes up
//   to e^10 = 2.2e4, so nothing is kept in a narrower type.
// * A ragged last chunk reads a = 1, i = 0 and zeros past T (mlstm.py
//   366-373) and writes no row past T.
//
// Bound.  The recurrence does 4 flops per (step, head, k, p) on ~6 bytes
// per (step, head, element) in bf16: ~K flops per byte, operations bound at
// K = 512 on CUDA cores.  The P split repeats Q K^T once per slice (16 times
// at P = 512), the price of fitting C on chip; tensor cores and a shared
// Q K^T pass are for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kQ = 64;               // chunk length
constexpr int kPt = 32;              // columns of P per block
constexpr int kKt = 32;              // K contraction tile
constexpr int kThreads = 256;
constexpr int kLdT = kKt + 1;
constexpr int kLdW = kQ + 1;

// rows [0, 64) x columns [k0, k0 + 32) of a (B, T, H, K) tensor at batch b,
// head h, steps c0.. into dst (64 x kLdT), times mul[row] when given; zero
// past T and past K.
template <typename T>
__device__ __forceinline__ void load_ktile(const T* __restrict__ src, int b,
                                           int h, int c0, int k0, int T_,
                                           int H, int K, float scale,
                                           const float* mul, float* dst) {
  for (int i = threadIdx.x; i < kQ * kKt; i += kThreads) {
    const int r = i / kKt, kk = i - r * kKt, t = c0 + r, kc = k0 + kk;
    float x = 0.0f;
    if (t < T_ && kc < K)
      x = to_f32(src[(((size_t)b * T_ + t) * H + h) * K + kc]) * scale;
    if (mul) x *= mul[r];
    dst[r * kLdT + kk] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ a,
             const float* __restrict__ ig, T* __restrict__ y, int T_, int H,
             int K, int P, float scale) {
  extern __shared__ float smem[];
  float* sC = smem;                    // K x kPt, the carried state slice
  float* sN = sC + K * kPt;            // K, the carried normaliser
  float* sQt = sN + K;                 // kQ x kLdT
  float* sKt = sQt + kQ * kLdT;        // kQ x kLdT
  float* sV = sKt + kQ * kLdT;         // kQ x kPt
  float* sW = sV + kQ * kPt;           // kQ x kLdW
  float* sCum = sW + kQ * kLdW;        // kQ: a, then cum
  float* sI = sCum + kQ;               // kQ: input gate
  float* sDst = sI + kQ;               // kQ: exp(cum)
  float* sDte = sDst + kQ;             // kQ: exp(cum_last - cum) * i
  float* sNrm = sDte + kQ;             // kQ: q . n, then max(|nrm|, 1)

  const int p0 = blockIdx.x * kPt, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  // thread layouts: Q K^T entries (tid / 64 + 4 j, tid % 64), j < 16;
  // (q, p) entries (tid / 32 + 8 j, tid % 32), j < 8
  const int s_own = tid & 63, q_base = tid >> 6;
  const int p_own = tid & 31, qp_base = tid >> 5;
  for (int i = tid; i < K * kPt; i += kThreads) sC[i] = 0.0f;
  for (int i = tid; i < K; i += kThreads) sN[i] = 0.0f;

  for (int c0 = 0; c0 < T_; c0 += kQ) {
    __syncthreads();                   // the last chunk's reads are done
    for (int i = tid; i < kQ * kPt; i += kThreads) {
      const int r = i / kPt, p = i - r * kPt, t = c0 + r;
      sV[i] = (t < T_ && p0 + p < P)
                  ? to_f32(v[(((size_t)b * T_ + t) * H + h) * P + p0 + p])
                  : 0.0f;
    }
    if (tid < kQ) {
      const int t = c0 + tid;
      const size_t off = ((size_t)b * T_ + t) * H + h;
      sCum[tid] = t < T_ ? a[off] : 1.0f;
      sI[tid] = t < T_ ? ig[off] : 0.0f;
    }
    __syncthreads();
    if (tid < 32) chunk_cumlog(sCum, sCum);
    __syncthreads();
    const float total = sCum[kQ - 1];
    if (tid < kQ) {
      sDst[tid] = expf(sCum[tid]);
      sDte[tid] = expf(total - sCum[tid]) * sI[tid];
    }

    float qk[16], qc[8], qn = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) qk[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) qc[j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kKt) {
      load_ktile(q, b, h, c0, k0, T_, H, K, scale, nullptr, sQt);
      load_ktile(k, b, h, c0, k0, T_, H, K, 1.0f, nullptr, sKt);
      __syncthreads();
      const int nk = min(kKt, K - k0);
      for (int kk = 0; kk < nk; ++kk) {
        const float kv = sKt[s_own * kLdT + kk];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          qk[j] = fmaf(sQt[(q_base + 4 * j) * kLdT + kk], kv, qk[j]);
        const float cv = sC[(k0 + kk) * kPt + p_own];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          qc[j] = fmaf(sQt[(qp_base + 8 * j) * kLdT + kk], cv, qc[j]);
      }
      if (tid < kQ)
        for (int kk = 0; kk < nk; ++kk)
          qn = fmaf(sQt[tid * kLdT + kk], sN[k0 + kk], qn);
      __syncthreads();                 // the tiles are consumed
    }

#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int qq = q_base + 4 * j;
      sW[qq * kLdW + s_own] =
          s_own <= qq ? qk[j] * expf(sCum[qq] - sCum[s_own]) * sI[s_own]
                      : 0.0f;
    }
    if (tid < kQ) sNrm[tid] = qn;
    __syncthreads();
    {   // normaliser: warp w takes rows 8w .. 8w + 7
      const int lane = tid & 31, warp = tid >> 5;
      for (int r = 0; r < 8; ++r) {
        const int qq = warp * 8 + r;
        float s = sW[qq * kLdW + lane] + sW[qq * kLdW + lane + 32];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (lane == 0) sNrm[qq] = fmaxf(fabsf(s + sDst[qq] * sNrm[qq]), 1.0f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qq = qp_base + 8 * j, t = c0 + qq;
      const float* wq = sW + qq * kLdW;
      float acc = 0.0f;
      for (int s = 0; s <= qq; ++s) acc = fmaf(wq[s], sV[s * kPt + p_own], acc);
      acc = fmaf(sDst[qq], qc[j], acc);
      if (t < T_ && p0 + p_own < P)
        store(y + (((size_t)b * T_ + t) * H + h) * P + p0 + p_own,
              acc / sNrm[qq]);
    }

    const float decay = expf(total);
    for (int k0 = 0; k0 < K; k0 += kKt) {
      // no barrier needed before this load: sKt was last read before the
      // barrier that ended the contraction loop
      load_ktile(k, b, h, c0, k0, T_, H, K, 1.0f, sDte, sKt);
      __syncthreads();
      const int nk = min(kKt, K - k0);
#pragma unroll
      for (int j = 0; j < kKt / 8; ++j) {
        const int kk = qp_base + 8 * j;
        if (kk < nk) {
          float acc = 0.0f;
          for (int s = 0; s < kQ; ++s)
            acc = fmaf(sKt[s * kLdT + kk], sV[s * kPt + p_own], acc);
          float* c = sC + (k0 + kk) * kPt + p_own;
          *c = fmaf(*c, decay, acc);
        }
      }
      if (tid < nk) {
        float acc = 0.0f;
        for (int s = 0; s < kQ; ++s) acc += sKt[s * kLdT + tid];
        sN[k0 + tid] = fmaf(sN[k0 + tid], decay, acc);
      }
      __syncthreads();                 // the tile is consumed
    }
  }
}

inline size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)K * kPt + K + 2 * kQ * kLdT + kQ * kPt +
                          kQ * kLdW + 5 * kQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* a,
           const void* i, void* y, int B, int T_, int H, int K, int P,
           float scale, void* stream) {
  if (B < 1 || T_ < 1 || H < 1 || K < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kPt - 1) / kPt, H, B);
  mlstm_kernel<T><<<grid, kThreads, smem_bytes(K), (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)a, (const float*)i,
      (T*)y, T_, H, K, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, after the library is loaded: let both instantiations
// take all the dynamic shared memory a block may, and write the smaller
// limit to max_dyn.
int mlstm_init(int* max_dyn) {
  *max_dyn = 1 << 30;
  cudaError_t e = allow_smem(mlstm_kernel<float>, max_dyn);
  if (e != cudaSuccess) return (int)e;
  return (int)allow_smem(mlstm_kernel<__nv_bfloat16>, max_dyn);
}

int mlstm_f32(const void* q, const void* k, const void* v, const void* a,
              const void* i, void* y, int B, int T, int H, int K, int P,
              float scale, void* stream) {
  return launch<float>(q, k, v, a, i, y, B, T, H, K, P, scale, stream);
}

int mlstm_bf16(const void* q, const void* k, const void* v, const void* a,
               const void* i, void* y, int B, int T, int H, int K, int P,
               float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, a, i, y, B, T, H, K, P, scale,
                               stream);
}

}  // extern "C"
