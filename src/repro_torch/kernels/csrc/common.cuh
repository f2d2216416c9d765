// Device helpers shared by the attention and model-stack kernels
// (paged_attention.cu, flash_attention.cu, mamba2_scan.cu, mlstm.cu, and
// through them hopper.cuh and mma.cuh), in an anonymous namespace of each
// source that includes it.  _build.library_path hashes this header with the
// source, so an edit here rebuilds every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The shared-window address of a pointer into shared memory, as PTX's
// shared-state-space operands take it.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);                         // round to nearest even
}

// Warp 0: cum[q] = sum_{r <= q} log(max(a[r], 1e-20)) over a chunk's 64
// steps, two per lane.  In place (cum == a) is allowed: each lane reads its
// two steps before any lane writes.
__device__ __forceinline__ void chunk_cumlog(const float* a, float* cum) {
  const int lane = threadIdx.x & 31;
  const float v0 = logf(fmaxf(a[2 * lane], 1e-20f));
  const float v1 = logf(fmaxf(a[2 * lane + 1], 1e-20f));
  float s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += n;
  }
  float excl = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) excl = 0.0f;
  cum[2 * lane] = excl + v0;
  cum[2 * lane + 1] = excl + v0 + v1;
}

// Raise `kern`'s dynamic shared-memory limit on the current device to what
// the opt-in maximum leaves after its static part, and lower *max_dyn to
// that amount.
template <typename Kern>
inline cudaError_t allow_smem(Kern kern, int* max_dyn) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  const int dyn = optin - (int)attr.sharedSizeBytes;
  if (dyn < *max_dyn) *max_dyn = dyn;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              dyn);
}

}  // namespace
