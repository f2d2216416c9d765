// Flash attention (prefill), written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py flash_attention_kernel (body
// _kernel): causal / sliding-window / full attention with an online softmax
// and f32 accumulation.  Plain C interface, no PyTorch headers: the Python
// side (repro_torch/kernels/flash_attention.py) loads the library with
// ctypes, hands in device pointers and PyTorch's current stream, and checks
// the returned cudaError_t.  The kernels allocate nothing and never
// synchronise.
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
// Bound.  Causal prefill at the model's widths is operations bound: 4 * B *
// H * dh flops per (query, attended key) pair against 2 bytes per element
// read once; at T = 4096 that is ~1000 flops per byte, three times the
// ~295 at which the H100's bf16 tensor cores, not its memory, set the pace.
//
// bf16: tensor cores (flash_attention_tc, the main path)
// ------------------------------------------------------
// * One block of two consumer warpgroups (256 threads) per (128-query tile,
//   head, batch row), query tiles launched latest first (under a causal
//   mask they carry the most keys).  Each warpgroup owns 64 query rows; the
//   TPU kernel's sequential kv grid axis is a loop inside the block, and
//   the running max, sum and the 64 x dh output stay in registers.
// * S = Q K^T is wgmma m64nBKk16 with Q and K read from shared memory,
//   K-major; the f32 accumulator stays in registers.  The online softmax
//   runs there too: each row lives in one quad of threads, so the row max
//   is two shuffles; the sum is kept per thread and reduced once at the
//   end.  Scores are scaled after the dot (by dh^-0.5 * log2 e, so exp2).
// * O += P V is a second wgmma: P, rounded to bf16, is the register A
//   operand (the m64nN accumulator layout is the A fragment's), V is read
//   from shared memory MN-major with the transpose bit.
// * Q and every K and V tile arrive by TMA through 4-D tensor maps
//   (dh, heads, sequence, batch): rows past T or S and columns past dh
//   arrive as zeros and never as the next batch row's keys.  The head
//   dimension is padded to 64, 128, 192 or 256 (DHP) by that zero fill in
//   shared memory, so every multiple of 8 up to 256 runs here; dh 160
//   (Zamba2's shared block) computes on 192 columns.  (The wrapper pads a
//   dh off 8 with zero columns, and runs a bf16 call past 256 on the f32
//   kernel on operands upcast to f32.)
// * K and V tiles go through a ring of two stages, each with a "full"
//   mbarrier per operand (TMA transaction bytes) and an "empty" mbarrier
//   that all 256 threads arrive at when the stage's products are done; one
//   elected thread refills a stage as soon as it is empty, so the next
//   tile's loads overlap this tile's arithmetic.  No plain global load is
//   left in the key loop.
// * Key tiles of 128 (DHP <= 128) or 64 (DHP 192, 256: the 64 x 256 f32
//   output alone is 128 registers a thread) keep the accumulators in
//   registers; shared memory is Q plus two stages, at most 193 KB (DHP 256).
// * Whole tiles above the diagonal and behind the window are skipped per
//   block; a block holding a row with every key masked walks all keys.  The
//   element mask is applied only on a tile that crosses the diagonal, the
//   window's edge or S, for the warpgroup's rows.
//
// f32: P V as 3xTF32 on the tensor cores (flash_attention_f32)
// ------------------------------------------------------------
// One TF32 product keeps 10 bits of mantissa and misses the f32 bar of 3e-5;
// three of them on the split operands (x = hi + lo, each rounded to TF32)
// keep ~22 bits (a_lo b_hi + a_hi b_lo + a_hi b_hi, CUTLASS's
// OpMultiplyAddFastF32), at 495 / 3 = 165 TFLOP/s of f32-exact work where
// FFMA gives 67.  That is how P V runs: mma.sync.m16n8k8 TF32, three
// products a fragment pair, each output tile's sum over a key tile formed in
// a fresh accumulator and added to O in f32 (summed in O itself through the
// tensor cores, the largest difference from the plain version on the input
// below doubled).  S = Q K^T does not: the softmax's exponent amplifies a
// score's rounding, so where the scores are large the f32 bar against the
// plain version holds only for scores rounded as its f32 product rounds
// them, a chain of fmaf over d in order.  On the training path's input at
// the reference's draw (2 x 1,024 tokens, 12 / 2 heads of 128; scores of
// std 55, up to 298; NVIDIA H100 80GB HBM3, 700 W) the plain version is
// 9.1e-4 from an f64 attention, 3xTF32 scores 6.6e-4 from it, and those left
// 32,113 elements outside 3e-5 of the plain version; scores by in-order FFMA
// none.  So S is FFMA, in order (tests/test_torch_width_split.py shows the
// same on the CPU).
// * One block of four warps per (64-query tile, head, batch row), on a 1-D
//   grid that launches the latest query tile of every (head, batch row)
//   first (under a causal mask the heaviest, so that the last wave holds
//   the lightest and the SMs finish together); a warp owns 16 query rows,
//   its scores (16 x BK), running max and sum and its 16 x dh output in
//   registers.
// * Q, and the K and V tiles in two stages, arrive as f32 through cp.async
//   (zeros past T and S): tile j + 1 loads while tile j computes.  Rows are
//   padded to a stride = 4 mod 32 floats, so that a warp's float4 reads of
//   Q and K and its fragment reads of V hit 32 banks.
// * A thread forms the scores of its accumulator fragment (rows g, g + 8;
//   keys 8 n + 2 c, 8 n + 2 c + 1), four d a float4 read.  P V's reduction
//   index (the keys) is permuted inside each k8 step: slot c holds key 2 c
//   and slot c + 4 key 2 c + 1, on A and B alike, so that the scores'
//   fragment is P's A fragment as it stands, with no shuffle.  P and V are
//   split in registers (split_tf32: two integer operations an element
//   where cvt.rna's NaN handling costs some eight).
// * The online softmax stays f32 on the CUDA cores (expf, rows in a quad);
//   masks, skipped tiles and the all-masked row are as the bf16 kernel's.
// * Key tiles of 64 (dh <= 64), 32 (dh <= 128) or 16 (up to 256: the 16 x
//   256 f32 output alone is 128 registers a thread); each width bucket (64,
//   128, 160, 192, 256) has an instantiation that takes any multiple of 8
//   up to it, and the first three an exact one whose loop bounds and
//   strides are constants (at 192 and 256 that one spilled).
// * Past 256 (kSliced) the output's columns go in slices of 256, one block
//   a slice, the slice the grid's fastest index: each block forms the
//   scores over the whole dh (the same in-order FFMA chain, Q and K tiles at
//   the full width in shared memory) and P V for its slice's columns (V
//   tiles at the slice's width), key tiles of 8 so that Q, K and V fit: at
//   dh 512 a block takes 181,760 bytes.  The scores are formed once a
//   slice.
// Bound: operations; B5's f32 rows in PERF.md state it at 165 TFLOP/s (the
// f32-exact tensor-core rate) beside FFMA's 67.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxHeadDim = 256;     // bf16 (wgmma); the f32 register tile
constexpr int kWideBK = 8;           // keys per tile of the f32 arm past it
constexpr int kVec = 8;              // dh % kVec == 0
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------- f32: 3xTF32 kernel ----

constexpr int kBQ = 64;              // query rows per block: a warp per 16
constexpr int kF32Threads = 2 * kBQ;

// the row stride (floats) of the Q, K and V tiles: 4 mod 32, so that a
// warp's float4 reads of Q and K rows and its fragment reads of V hit 32
// banks
__host__ __device__ __forceinline__ int ld_f32(int dh) {
  return dh + (36 - dh % 32) % 32;
}
// acc += the dot product of a and b, x to w in order (fmaf)
__device__ __forceinline__ void fma4(float& acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}
// keys per tile of the kernel that takes dh
inline int f32_bk(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 32 : 16; }

// rows [0, rows) of a (.., stride) f32 array from element `base`, dh
// columns, into shared memory at stride ld, 16 bytes a copy; rows at or past
// n_rows are zeros
__device__ __forceinline__ void load_rows_f32(const float* __restrict__ src,
                                              size_t base, size_t stride,
                                              int n_rows, int rows, int dh,
                                              float* dst, int ld) {
  const int ppr = dh / 4;
  for (int i = threadIdx.x; i < rows * ppr; i += kF32Threads) {
    const int r = i / ppr, c = 4 * (i - r * ppr);
    const bool ok = r < n_rows;
    cp_async16(dst + r * ld + c, src + base + (size_t)(ok ? r : 0) * stride + c,
               ok);
  }
}

// DHMAX: the widest dh of this instantiation; BK: keys per tile; kExact:
// dh == DHMAX, so that loop bounds and strides are constants (a third
// faster at dh 128 on an H100).  Two blocks an SM up to dh 192 (shared memory holds no
// more), one at 256: named, so that ptxas may take the registers they leave.
// kSliced (dh past DHMAX = kMaxHeadDim): the scores take the whole dh, the
// block's output the columns [c0, c0 + DHMAX) of one slice, its V tiles
// those columns alone; the slices are the grid's fastest index.
template <int DHMAX, int BK, bool kExact, bool kSliced = false>
__global__ void __launch_bounds__(kF32Threads, DHMAX >= 256 ? 1 : 2)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int T_, int S, int H, int Hk, int dh_, int causal,
                    int window, int offset, float scale) {
  constexpr int NT = BK / 8;         // n8 tiles of the scores (keys)
  constexpr int NO = DHMAX / 8;      // n8 tiles of the output (columns)
  extern __shared__ __align__(16) float fsm[];
  const int dh = kExact ? DHMAX : dh_;          // the scores' width
  int ns = 1;                                   // output slices
  if constexpr (kSliced) ns = (dh + DHMAX - 1) / DHMAX;
  const int sl = kSliced ? (int)blockIdx.x % ns : 0;
  const int bid = kSliced ? (int)blockIdx.x / ns : (int)blockIdx.x;
  const int c0 = sl * DHMAX, dv = kSliced ? min(DHMAX, dh - c0) : dh;
  const int ld = ld_f32(dh), ldv = kSliced ? ld_f32(DHMAX) : ld;
  const int nd = dv / 8;
  float* sQ = fsm;                   // kBQ x ld
  float* sK = sQ + kBQ * ld;         // 2 stages of BK x ld
  float* sV = sK + 2 * BK * ld;      // 2 stages of BK x ldv

  // a 1-D grid, the latest query tile of every (head, batch row) first:
  // under a causal mask the blocks launched first carry the most keys, and
  // the last wave holds the lightest ones
  const int nq = (T_ + kBQ - 1) / kBQ, HB = (int)gridDim.x / ns / nq;
  const int rank = bid / HB, hb = bid - rank * HB;
  const int t0 = (nq - 1 - rank) * kBQ;
  const int h = hb % H, b = hb / H;
  const int kh = h / (H / Hk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
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
  const int first = s_begin / BK;
  const int n_tiles = (s_end + BK - 1) / BK - first;

  const size_t q_row = (size_t)H * dh, kv_row = (size_t)Hk * dh;
  const size_t kv_base = (size_t)b * S * kv_row + (size_t)kh * dh;
  auto load_kv = [&](int j) {
    const int s0 = (first + j) * BK, st = j & 1;
    load_rows_f32(k, kv_base + (size_t)s0 * kv_row, kv_row, S - s0, BK, dh,
                  sK + st * BK * ld, ld);
    load_rows_f32(v, kv_base + c0 + (size_t)s0 * kv_row, kv_row, S - s0, BK,
                  dv, sV + st * BK * ldv, ldv);
  };
  load_rows_f32(q, ((size_t)b * T_ + t0) * q_row + (size_t)h * dh, q_row,
                T_ - t0, kBQ, dh, sQ, ld);
  load_kv(0);
  cp_async_commit();

  // this thread's rows r_lo, r_hi; its warp's rows [w0, w0 + 15]
  const int w0 = t0 + 16 * warp, r_lo = w0 + g, r_hi = r_lo + 8;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;
  const float* q_lo = sQ + (16 * warp + g) * ld;
  const float* q_hi = q_lo + 8 * ld;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, s0 = (first + j) * BK;
    cp_async_wait_all();
    __syncthreads();                 // tile j is in; tile j - 1 is consumed
    if (j + 1 < n_tiles) load_kv(j + 1);
    cp_async_commit();
    const float* ks = sK + st * BK * ld + 2 * tq * ld;
    const float* vs = sV + st * BK * ldv + 2 * tq * ldv + g;

    // S = Q K^T by FFMA, each score a chain of fmaf over d in order, as
    // the plain version's f32 product forms it (see the design notes): the
    // thread's fragment of the scores, rows g, g + 8 and keys 8 n + 2 c,
    // + 1, four d a float4 read
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll(kExact ? 1 : 2)   // unrolled, the exact forms spilled
    for (int d = 0; d < dh; d += 4) {
      const float4 xa = *reinterpret_cast<const float4*>(q_lo + d);
      const float4 xb = *reinterpret_cast<const float4*>(q_hi + d);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 k0 = *reinterpret_cast<const float4*>(ks + 8 * n * ld + d);
        const float4 k1 =
            *reinterpret_cast<const float4*>(ks + (8 * n + 1) * ld + d);
        fma4(s[n][0], xa, k0);
        fma4(s[n][1], xa, k1);
        fma4(s[n][2], xb, k0);
        fma4(s[n][3], xb, k1);
      }
    }

    // scale, mask where the tile crosses an edge, row max over the quad
    const bool whole = s0 + BK <= S &&
                       (!causal || s0 + BK - 1 <= w0 + offset) &&
                       (window < 0 || s0 >= w0 + 15 + offset - window + 1);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (!whole) {
          const int key = s0 + 8 * n + 2 * tq + (e & 1);
          const int t = (e & 2) ? r_hi : r_lo;
          if (key >= S) {
            x = -INFINITY;
          } else {
            const int rel = t - key + offset;
            bool ok = !causal || rel >= 0;
            if (window >= 0) ok = ok && rel < window;
            if (!ok) x = kNegInf;
          }
        }
        s[n][e] = x;
        if (e & 2) mx_hi = fmaxf(mx_hi, x);
        else mx_lo = fmaxf(mx_lo, x);
      }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, w));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - ((e & 2) ? mn_hi : mn_lo));
        s[n][e] = p;
        if (e & 2) sum_hi += p;
        else sum_lo += p;
      }
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= a_lo;
      o[n][1] *= a_lo;
      o[n][2] *= a_hi;
      o[n][3] *= a_hi;
    }

    // O += P V over the tile's keys, k8 step kk = score tile kk: slot c <->
    // key 8 kk + 2 c, slot c + 4 <-> 8 kk + 2 c + 1, so P's A fragment is
    // the accumulator (d0, d2, d1, d3) and V's rows are read to match.  Each
    // output tile sums the tile's steps in a fresh accumulator, then adds it
    // to O in f32
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      split_tf32(s[kk][0], ph[kk][0], pl[kk][0]);
      split_tf32(s[kk][2], ph[kk][1], pl[kk][1]);
      split_tf32(s[kk][1], ph[kk][2], pl[kk][2]);
      split_tf32(s[kk][3], ph[kk][3], pl[kk][3]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (kExact || n < nd) {
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          const float* vr = vs + 8 * kk * ldv + 8 * n;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[0], bh0, bl0);
          split_tf32(vr[ldv], bh1, bl1);
          mma_3xtf32(t, ph[kk], pl[kk], bh0, bh1, bl0, bl1);
        }
        o[n][0] += t[0];
        o[n][1] += t[1];
        o[n][2] += t[2];
        o[n][3] += t[3];
      }
    }
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, w);
    l_hi += __shfl_xor_sync(kFull, l_hi, w);
  }
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
  float* dst_lo = out + ((size_t)b * T_ + r_lo) * q_row + (size_t)h * dh + c0;
  float* dst_hi = dst_lo + 8 * q_row;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (kExact || n < nd) {
      const int d = 8 * n + 2 * tq;
      if (r_lo <= t_last)
        *reinterpret_cast<float2*>(dst_lo + d) =
            make_float2(o[n][0] * inv_lo, o[n][1] * inv_lo);
      if (r_hi <= t_last)
        *reinterpret_cast<float2*>(dst_hi + d) =
            make_float2(o[n][2] * inv_hi, o[n][3] * inv_hi);
    }
  }
}

// ------------------------------------------------ bf16 tensor-core kernel ----

constexpr int kTcBQ = 128;           // query rows per block: two warpgroups
constexpr int kTcThreads = 256;
constexpr int kStages = 2;           // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int DHP, int BK>
struct TcShape {
  static constexpr int kChunks = DHP / 64;             // 128-byte column chunks
  static constexpr int kQBytes = kTcBQ * DHP * 2;
  static constexpr int kTileBytes = BK * DHP * 2;      // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // lo: low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// DHP: head dimension padded to a multiple of 64; BK: keys per tile.
template <int DHP, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int T_, int S, int H,
                   int Hk, int dh, int causal, int window, int offset,
                   float scale_log2) {
  using Shape = TcShape<DHP, BK>;
  constexpr int kChunks = Shape::kChunks;
  constexpr int NS = BK / 2;         // score registers a thread
  constexpr int NO = DHP / 2;        // output registers a thread
  constexpr int KS = BK / 16;        // k16 steps of P V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[kStages], bar_v[kStages],
      bar_empty[kStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* sQ = smem;
  auto sK = [&](int st) { return smem + Shape::kQBytes + st * Shape::kStageBytes; };
  auto sV = [&](int st) { return sK(st) + Shape::kTileBytes; };

  const int nq = (T_ + kTcBQ - 1) / kTcBQ;
  const int t0 = (nq - 1 - (int)blockIdx.x) * kTcBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Hk);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int t_last = min(t0 + kTcBQ, T_) - 1;

  // keys [lo(t), hi(t)) are valid for row t; both bounds grow with t
  auto lo = [&](int t) { return window >= 0 ? max(0, t + offset - window + 1) : 0; };
  auto hi = [&](int t) { return causal ? min(S, t + offset + 1) : S; };
  const int row = t0 + tid;
  const bool empty_row = tid < kTcBQ && row <= t_last && lo(row) >= hi(row);
  int s_begin = lo(t0), s_end = hi(t_last);
  if (__syncthreads_or(empty_row)) {
    s_begin = 0;
    s_end = S;
  }
  const int first = s_begin / BK;
  const int n_tiles = (s_end + BK - 1) / BK - first;

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&bar_k[i], 1);
      mbar_init(&bar_v[i], 1);
      mbar_init(&bar_empty[i], kTcThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one elected thread issues every copy
  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  auto load_tile = [&](int j) {
    const int st = j % kStages, s0 = (first + j) * BK;
    mbar_expect_tx(&bar_k[st], Shape::kTileBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(sK(st) + c * BK * 128, map_k, &bar_k[st], c * 64, kh, s0, b);
    mbar_expect_tx(&bar_v[st], Shape::kTileBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(sV(st) + c * BK * 128, map_v, &bar_v[st], c * 64, kh, s0, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&bar_q, Shape::kQBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(sQ + c * kTcBQ * 128, &tq, &bar_q, c * 64, h, t0, b);
    for (int j = 0; j < min(kStages, n_tiles); ++j) load_tile(j);
  }

  // this thread's two rows, and its warpgroup's rows [w0, w1]
  const int r_lo = t0 + wg * 64 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const int w0 = t0 + wg * 64, w1 = w0 + 63;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;

  const uint8_t* q_wg = sQ + wg * 64 * 128;
  mbar_wait(&bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const int s0 = (first + j) * BK;

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.0f;
    mbar_wait(&bar_k[st], ph);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_qk<BK>(s, gmma_desc(q_wg + c * kTcBQ * 128 + kk * 32, 16, 1024),
                     gmma_desc(sK(st) + c * BK * 128 + kk * 32, 16, 1024),
                     (c | kk) != 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(s[i]);

    // scale, mask where the tile crosses an edge, row max over the quad
    const bool whole = s0 + BK <= S && (!causal || s0 + BK - 1 <= w0 + offset) &&
                       (window < 0 || s0 >= w1 + offset - window + 1);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = s[i] * scale_log2;
      if (!whole) {
        const int key = s0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int t = (i & 2) ? r_hi : r_lo;
        if (key >= S) {
          x = -INFINITY;
        } else {
          const int rel = t - key + offset;
          bool ok = !causal || rel >= 0;
          if (window >= 0) ok = ok && rel < window;
          if (!ok) x = kNegInf;
        }
      }
      s[i] = x;
      if (i & 2) mx_hi = fmaxf(mx_hi, x);
      else mx_lo = fmaxf(mx_lo, x);
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, w));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = exp2f(s[i] - ((i & 2) ? mn_hi : mn_lo));
      s[i] = p;
      if (i & 2) sum_hi += p;
      else sum_lo += p;
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? a_hi : a_lo;

    // P (bf16) as the register A operand of P V: k16 step kk holds keys
    // 16 kk .. 16 kk + 15, i.e. the score registers 8 kk .. 8 kk + 7
    uint32_t pa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    mbar_wait(&bar_v[st], ph);
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_pv<DHP>(o, pa[kk], gmma_desc(sV(st) + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);

    mbar_arrive(&bar_empty[st]);
    if (tid == 0 && j + kStages < n_tiles) {
      mbar_wait(&bar_empty[st], ph);       // both warpgroups are done with it
      load_tile(j + kStages);
    }
    __syncwarp();                          // warp 0 reconverges for wgmma
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, w);
    l_hi += __shfl_xor_sync(kFull, l_hi, w);
  }
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
  const size_t q_row = (size_t)H * dh;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int t = (i & 2) ? r_hi : r_lo;
    const int d = 8 * (i >> 2) + 2 * (lane & 3);
    if (t > t_last || d >= dh) continue;
    const float inv = (i & 2) ? inv_hi : inv_lo;
    *reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * T_ + t) * q_row + (size_t)h * dh + d) =
        __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
  }
}

// ------------------------------------------------------------------ host ----

inline size_t smem_bytes_f32(int dh) {
  if (dh > kMaxHeadDim)              // Q and K at dh, V at one slice
    return sizeof(float) * ((size_t)(kBQ + 2 * kWideBK) * ld_f32(dh) +
                            (size_t)2 * kWideBK * ld_f32(kMaxHeadDim));
  return sizeof(float) * (size_t)(kBQ + 4 * f32_bk(dh)) * ld_f32(dh);
}

// (dh bucket, keys per tile, an exact form at dh == bucket)
#define FA_F32_SHAPES(X) \
  X(64, 64, true) X(128, 32, true) X(160, 16, true) X(192, 16, false) \
  X(256, 16, false)

cudaError_t init_f32(int* max_dyn) {
  cudaError_t e = cudaSuccess;
#define FA_ALLOW(D, BK, EXACT)                                              \
  if (e == cudaSuccess)                                                     \
    e = allow_smem(flash_attention_f32<D, BK, false>, max_dyn);             \
  if (EXACT && e == cudaSuccess)                                            \
    e = allow_smem(flash_attention_f32<D, BK, EXACT>, max_dyn);
  FA_F32_SHAPES(FA_ALLOW)
#undef FA_ALLOW
  if (e == cudaSuccess)
    e = allow_smem(flash_attention_f32<kMaxHeadDim, kWideBK, false, true>,
                   max_dyn);
  return e;
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int T_, int S, int H, int Hk, int dh, int causal, int window,
               int offset, float scale, void* stream) {
  if (B < 1 || T_ < 1 || S < 1 || Hk < 1 || H % Hk || dh % kVec ||
      dh < kVec)
    return (int)cudaErrorInvalidValue;
  // query tiles x heads x batch rows (x output slices past kMaxHeadDim),
  // latest tile first
  const int ns = (dh + kMaxHeadDim - 1) / kMaxHeadDim;
  const dim3 grid((T_ + kBQ - 1) / kBQ * H * B * ns);
  const size_t smem = smem_bytes_f32(dh);
  cudaStream_t st = (cudaStream_t)stream;
  const float* qq = (const float*)q;
  const float* kk = (const float*)k;
  const float* vv = (const float*)v;
  float* oo = (float*)out;
  // the narrowest instantiation that takes dh; its exact form at dh == D
#define FA_LAUNCH(D, BK, EXACT)                                             \
  if (dh <= D) {                                                            \
    if (EXACT && dh == D)                                                   \
      flash_attention_f32<D, BK, EXACT><<<grid, kF32Threads, smem, st>>>(   \
          qq, kk, vv, oo, T_, S, H, Hk, dh, causal, window, offset, scale); \
    else                                                                    \
      flash_attention_f32<D, BK, false><<<grid, kF32Threads, smem, st>>>(   \
          qq, kk, vv, oo, T_, S, H, Hk, dh, causal, window, offset, scale); \
    return (int)cudaGetLastError();                                         \
  }
  FA_F32_SHAPES(FA_LAUNCH)
#undef FA_LAUNCH
  flash_attention_f32<kMaxHeadDim, kWideBK, false, true>
      <<<grid, kF32Threads, smem, st>>>(qq, kk, vv, oo, T_, S, H, Hk, dh,
                                        causal, window, offset, scale);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// the library links against nothing but the CUDA runtime.
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 (B, L, heads, dh) tensor as a 4-D map (dh, heads, L, B) with boxes
// of 64 columns x `rows` rows of one head, 128-byte swizzle, zeros outside.
bool make_map(CUtensorMap* map, const void* base, int B, int L, int heads,
              int dh, int rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)L * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)base, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DHP, int BK>
int launch_tc_shape(const void* q, const void* k, const void* v, void* out,
                    int B, int T_, int S, int H, int Hk, int dh, int causal,
                    int window, int offset, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, T_, H, dh, kTcBQ) ||
      !make_map(&tk, k, B, S, Hk, dh, BK) || !make_map(&tv, v, B, S, Hk, dh, BK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T_ + kTcBQ - 1) / kTcBQ, H, B);
  flash_attention_tc<DHP, BK><<<grid, kTcThreads, TcShape<DHP, BK>::kSmem, st>>>(
      tq, tk, tv, (__nv_bfloat16*)out, T_, S, H, Hk, dh, causal, window,
      offset, scale * kLog2e);
  return (int)cudaGetLastError();
}

int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int T_, int S, int H, int Hk, int dh, int causal, int window,
              int offset, float scale, void* stream) {
  if (B < 1 || T_ < 1 || S < 1 || Hk < 1 || H % Hk || dh % kVec ||
      dh < kVec || dh > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dh <= 64)
    return launch_tc_shape<64, 128>(q, k, v, out, B, T_, S, H, Hk, dh, causal,
                                    window, offset, scale, st);
  if (dh <= 128)
    return launch_tc_shape<128, 128>(q, k, v, out, B, T_, S, H, Hk, dh, causal,
                                     window, offset, scale, st);
  if (dh <= 192)
    return launch_tc_shape<192, 64>(q, k, v, out, B, T_, S, H, Hk, dh, causal,
                                    window, offset, scale, st);
  return launch_tc_shape<256, 64>(q, k, v, out, B, T_, S, H, Hk, dh, causal,
                                  window, offset, scale, st);
}

cudaError_t init_tc(int* max_dyn) {
  cudaError_t e;
  if ((e = allow_smem(flash_attention_tc<64, 128>, max_dyn))) return e;
  if ((e = allow_smem(flash_attention_tc<128, 128>, max_dyn))) return e;
  if ((e = allow_smem(flash_attention_tc<192, 64>, max_dyn))) return e;
  return allow_smem(flash_attention_tc<256, 64>, max_dyn);
}

}  // namespace

extern "C" {

// Once per device, after the library is loaded: let every kernel take all
// the dynamic shared memory a block may, and write the least of what is
// left beside their static parts to max_dyn (the wrapper checks its
// smem_bytes(dh, dtype) against it).
int flash_attention_init(int* max_dyn) {
  *max_dyn = 1 << 30;
  cudaError_t e = init_f32(max_dyn);
  if (e != cudaSuccess) return (int)e;
  return (int)init_tc(max_dyn);
}

// window < 0: no window.  causal: 0 or 1.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int T, int S, int H, int Hk, int dh,
                        int causal, int window, int offset, float scale,
                        void* stream) {
  return launch_f32(q, k, v, out, B, T, S, H, Hk, dh, causal, window, offset,
                    scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int T, int S, int H, int Hk, int dh,
                         int causal, int window, int offset, float scale,
                         void* stream) {
  return launch_tc(q, k, v, out, B, T, S, H, Hk, dh, causal, window, offset,
                   scale, stream);
}

}  // extern "C"
