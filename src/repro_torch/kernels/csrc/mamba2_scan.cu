// Chunked SSD (Mamba2) scan, written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mamba2_scan.py mamba2_scan_kernel (body
// _kernel): the selective scan h_t = a_t h_{t-1} + B_t x_t^T, y_t = C_t . h_t
// per (batch, head), evaluated chunk by chunk with the (P x N) state carried
// in f32.  Plain C interface, no PyTorch headers: the Python side
// (repro_torch/kernels/mamba2_scan.py) loads the library with ctypes, hands
// in device pointers and PyTorch's current stream, and checks the returned
// cudaError_t.  The kernel allocates nothing and never synchronises.
//
//   xh   (B, T, H, P)   f32 or bf16
//   a    (B, T, H)      f32 per-step decay in (0, 1]
//   b/c  (B, T, N)      xh's type, shared by the heads (ngroups = 1)
//   y    (B, T, H, P)   xh's type
//
// Design
// ------
// * One block of 256 threads per (head, batch row).  The TPU kernel's
//   sequential chunk grid axis, which carried h in VMEM scratch, is a loop
//   inside the block over chunks of 64 steps; h (P x N, f32; 16 KB at
//   Zamba2's 64 x 64) stays in shared memory across it.
// * Per chunk, as mamba2_scan.py 194-224: warp 0 forms cum = the running
//   sum of log(max(a, 1e-20)) (a warp scan; log-space sums, not a running
//   product of a, which underflows at large dt); then
//     W[q, s]  = (C_q . B_s) exp(cum_q - cum_s)   for s <= q only (the
//                exponent is <= 0 there; above the diagonal it is positive
//                and would overflow, so it is never evaluated)
//     y[q, p]  = sum_s W[q, s] x[s, p] + exp(cum_q) (C_q . h[p, :])
//     h[p, n]  = h[p, n] exp(cum_last) + sum_s exp(cum_last - cum_s) x[s, p] B_s[n]
//   every product an f32 FMA out of shared memory.
// * A ragged last chunk reads a = 1 and zeros past T (mamba2_scan.py 93-97)
//   and writes no row past T.
// * Shared-memory rows read down a column are padded to an odd stride, so
//   those reads hit 32 different banks.
//
// Bound.  The scan does O(T H P N) work on O(T (H P + N)) bytes: 4 flops per
// (step, head, p, n) for the recurrence against ~4 bytes per (step, head,
// p) in bf16, ~N flops per byte, under the card's ~20 (f32) per byte, so it
// is bytes bound at the model's N = 64 in principle; the chunked form does
// ~3x the recurrence's flops on CUDA cores to run in parallel over a chunk,
// which makes this kernel operations bound in practice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kQ = 64;               // chunk length
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_scan_kernel(const T* __restrict__ xh, const float* __restrict__ a,
                   const T* __restrict__ bmat, const T* __restrict__ cmat,
                   T* __restrict__ y, int T_, int H, int P, int N) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldw = kQ + 1;
  float* sX = smem;                    // kQ x P
  float* sB = sX + kQ * P;             // kQ x ldn
  float* sC = sB + kQ * ldn;           // kQ x ldn
  float* sW = sC + kQ * ldn;           // kQ x ldw
  float* sH = sW + kQ * ldw;           // P x ldn, the carried state
  float* sA = sH + P * ldn;            // kQ: a, then cum
  float* sDst = sA + kQ;               // kQ: exp(cum)
  float* sDte = sDst + kQ;             // kQ: exp(cum_last - cum)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < P * ldn; i += kThreads) sH[i] = 0.0f;

  for (int c0 = 0; c0 < T_; c0 += kQ) {
    __syncthreads();                   // the last chunk's reads are done
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int q = i / P, p = i - q * P, t = c0 + q;
      sX[i] = t < T_ ? to_f32(xh[(((size_t)b * T_ + t) * H + h) * P + p]) : 0.0f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int q = i / N, n = i - q * N, t = c0 + q;
      const size_t off = ((size_t)b * T_ + t) * N + n;
      sB[q * ldn + n] = t < T_ ? to_f32(bmat[off]) : 0.0f;
      sC[q * ldn + n] = t < T_ ? to_f32(cmat[off]) : 0.0f;
    }
    if (tid < kQ) {
      const int t = c0 + tid;
      sA[tid] = t < T_ ? a[((size_t)b * T_ + t) * H + h] : 1.0f;
    }
    __syncthreads();
    if (tid < 32) chunk_cumlog(sA, sA);   // in place: each lane reads first
    __syncthreads();
    const float total = sA[kQ - 1];
    if (tid < kQ) {
      sDst[tid] = expf(sA[tid]);
      sDte[tid] = expf(total - sA[tid]);
    }
    for (int i = tid; i < kQ * kQ; i += kThreads) {
      const int q = i / kQ, s = i - q * kQ;
      float w = 0.0f;
      if (s <= q) {
        const float* cq = sC + q * ldn;
        const float* bs = sB + s * ldn;
        for (int n = 0; n < N; ++n) w = fmaf(cq[n], bs[n], w);
        w *= expf(sA[q] - sA[s]);
      }
      sW[q * ldw + s] = w;
    }
    __syncthreads();

    for (int i = tid; i < kQ * P; i += kThreads) {
      const int q = i / P, p = i - q * P, t = c0 + q;
      const float* wq = sW + q * ldw;
      float acc = 0.0f;
      for (int s = 0; s <= q; ++s) acc = fmaf(wq[s], sX[s * P + p], acc);
      const float* cq = sC + q * ldn;
      const float* hp = sH + p * ldn;
      float ch = 0.0f;
      for (int n = 0; n < N; ++n) ch = fmaf(cq[n], hp[n], ch);
      acc = fmaf(sDst[q], ch, acc);
      if (t < T_) store(y + (((size_t)b * T_ + t) * H + h) * P + p, acc);
    }
    __syncthreads();                   // h is read; now it moves on

    const float decay = expf(total);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      float acc = 0.0f;
      for (int s = 0; s < kQ; ++s)
        acc = fmaf(sX[s * P + p] * sDte[s], sB[s * ldn + n], acc);
      sH[p * ldn + n] = fmaf(sH[p * ldn + n], decay, acc);
    }
  }
}

inline size_t smem_bytes(int P, int N) {
  return sizeof(float) * ((size_t)kQ * P + 2 * (size_t)kQ * (N + 1) +
                          (size_t)kQ * (kQ + 1) + (size_t)P * (N + 1) + 3 * kQ);
}

template <typename T>
int launch(const void* xh, const void* a, const void* b, const void* c,
           void* y, int B, int T_, int H, int P, int N, void* stream) {
  if (B < 1 || T_ < 1 || H < 1 || P < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  mamba2_scan_kernel<T><<<dim3(H, B), kThreads, smem_bytes(P, N),
                          (cudaStream_t)stream>>>(
      (const T*)xh, (const float*)a, (const T*)b, (const T*)c, (T*)y, T_, H, P,
      N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, after the library is loaded: let both instantiations
// take all the dynamic shared memory a block may, and write the smaller
// limit to max_dyn.
int mamba2_scan_init(int* max_dyn) {
  *max_dyn = 1 << 30;
  cudaError_t e = allow_smem(mamba2_scan_kernel<float>, max_dyn);
  if (e != cudaSuccess) return (int)e;
  return (int)allow_smem(mamba2_scan_kernel<__nv_bfloat16>, max_dyn);
}

int mamba2_scan_f32(const void* xh, const void* a, const void* b,
                    const void* c, void* y, int B, int T, int H, int P, int N,
                    void* stream) {
  return launch<float>(xh, a, b, c, y, B, T, H, P, N, stream);
}

int mamba2_scan_bf16(const void* xh, const void* a, const void* b,
                     const void* c, void* y, int B, int T, int H, int P,
                     int N, void* stream) {
  return launch<__nv_bfloat16>(xh, a, b, c, y, B, T, H, P, N, stream);
}

}  // extern "C"
