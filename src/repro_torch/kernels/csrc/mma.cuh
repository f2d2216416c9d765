// Warp-level tensor-core building blocks shared by the kernels that run
// their products on mma.sync (mamba2_scan.cu, mlstm.cu, flash_attention.cu's
// f32 arm): cp.async copies into shared memory, ldmatrix, the m16n8k16 bf16
// product, the split of an f32 pair into two bf16 pairs (hi + lo) that such
// a kernel uses for the operands it makes itself, and the m16n8k8 TF32
// product with its own split (3xTF32).  Inline PTX only, in an anonymous
// namespace of each source that includes it; smem_u32 comes from common.cuh,
// which hopper.cuh includes too, so the two headers can meet in one source.
// _build.library_path hashes every header under csrc/, so an edit here
// rebuilds every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"   // smem_u32

namespace {

// 16 bytes global -> shared, asynchronously; zeros in their place when
// !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until none of this thread's groups is pending.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// d += a b, one m16n8k16 tile: bf16 in, f32 accumulate.  Not volatile:
// a function of its operands, which the compiler may schedule freely (the
// products of independent tiles between two dependent ones)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi): x0 in the
// low half of each, as an mma fragment register holds the lower column
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// x as two TF32 values, each rounded to nearest with ties away (as
// cvt.rna): hi = tf32(x), lo = tf32(x - hi), by adding half a TF32 unit and
// clearing the 13 low bits (two integer operations each, where cvt.rna's
// NaN handling costs some eight).  hi + lo carries ~22 bits of x's 24, and
// the product of two such pairs without lo * lo is within ~2^-21 of x y.
// x must be finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d += a b, one m16n8k8 tile: TF32 in, f32 accumulate.  A (16 x 8, row):
// a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4); B (8 x 8, col):
// b0 (c, g), b1 (c + 4, g); D: d0, d1 (g, 2 c, 2 c + 1), d2, d3 (g + 8, ..),
// with g = lane / 4 and c = lane % 4.  Not volatile, as mma_bf16.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to ~f32 accuracy on the tensor cores (3xTF32, CUTLASS's
// OpMultiplyAddFastF32): a_lo b_hi + a_hi b_lo, the small terms first, then
// a_hi b_hi; a_lo b_lo (~2^-22 of the product) is dropped
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ahi,
                                           const uint32_t* alo, uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

}  // namespace
