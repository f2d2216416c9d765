// Chunked SSD (Mamba2) scan, written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mamba2_scan.py mamba2_scan_kernel (body
// _kernel): the selective scan h_t = a_t h_{t-1} + B_t x_t^T, y_t = C_t . h_t
// per (batch, head), evaluated chunk by chunk with the (P x N) state in f32.
// Plain C interface, no PyTorch headers: the Python side
// (repro_torch/kernels/mamba2_scan.py) loads the library with ctypes, hands
// in device pointers, a work buffer it allocated and PyTorch's current
// stream, and checks the returned cudaError_t.  The kernels allocate nothing
// and never synchronise.
//
//   xh   (B, T, H, P)   f32 or bf16
//   a    (B, T, H)      f32 per-step decay in (0, 1]
//   b/c  (B, T, N)      xh's type, shared by the heads (ngroups = 1)
//   y    (B, T, H, P)   xh's type
//   work f32: the chunk states (B, nc, H, P, N), then the chunk decays
//        (B, nc, H); nc = ceil(T / Q)
//   part f32 (S, B, T, H, P): each state slice's share of y, when S > 1
//
// Design: the SSD split, three launches, each parallel over (batch, chunk)
// or (batch, head), where the TPU kernel walked the chunks of a (batch,
// head) in order with h in VMEM scratch.  Per chunk of Q steps, cum = the
// running sum of log(max(a, 1e-20)) (log space: a running product of a
// underflows at large dt) and total = its last value:
//   1. chunk_state (a block per (chunk, batch, group of heads)):
//      S_c = (X o exp(total - cum))^T B, a P x N f32 tile written to work,
//      and exp(total) beside it.  B is loaded once for all the heads.
//   2. state_pass (per (batch, head), parallel over the P x N elements):
//      h_c = h_{c-1} exp(total_c) + S_c, h_{c-1} in f32, written in place of
//      S_c: a short elementwise recurrence, kAhead chunks in flight a thread.
//   3. chunk_scan (a block per (chunk, batch, group of heads)):
//      y = ((C B^T) o L) X + exp(cum) (C h_{c-1}^T), L[q, s] = exp(cum_q -
//      cum_s) for s <= q only (the exponent is <= 0 there and positive above
//      the diagonal, where it is never evaluated).  C B^T is shared by the
//      heads: it is computed once a block and serves every head of it.
// A ragged last chunk reads a = 1 and zeros past T and writes no row past T.
//
// The state width is cut into S slices of at most kMaxN columns (NS each,
// the last one narrower): y = C h^T + (C B^T o L) X is a sum over n, every
// column of h evolves on its own under a decay that does not depend on n.
// So with S > 1 the blocks of the two chunk passes take one slice each
// (grid z = head groups x S): chunk_state writes its columns of the chunk
// states, the state pass runs on all P N of them as before, chunk_scan
// writes its slice's share of y in f32 to `part`, and a fourth launch
// (sum_slices) adds the shares in slice order and rounds once.  No atomic,
// so repeats are bit-equal.  With S = 1 (N <= kMaxN) the three launches and
// their work are as they were.
//
// bf16 (the model's path): Q = 128, 8 warps, every product on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate), operands through
// cp.async into padded shared memory (rows 16 bytes apart modulo 128, so an
// ldmatrix phase hits 32 banks) and ldmatrix (.trans for the operands
// stored with the reduced index outermost), the next head's X and h loaded
// while one computes (two buffers).  C, B and X are exact
// in bf16; the operands made in the kernel — X o exp(total - cum), W =
// (C B^T) o L and h_{c-1} — are each carried as a pair hi + lo of bf16 (hi
// = bf16(v), lo = bf16(v - hi), ~2^-17 of v) and enter two products, so no
// product rounds an operand to 2^-9.  C B^T's fragments are formed once a
// block and kept in shared memory in the mma accumulator layout, from
// which W's A fragments are made per head without a shuffle.
// f32: Q = 64, the same three passes in FFMA out of shared memory (TF32
// would not hold the 2e-3 bar).
//
// Bound: bytes.  The work is O(T H P (Q + N)) flops on O(T H P) bytes of x
// and y plus the chunk states, 4 P N bytes a (chunk, head) written, then
// read and written, then read: at Q = 128 and P = N = 64 about as many bytes
// as x and y together.  The tensor cores' rate is far above what that asks.
// Measured (tools/time_ssd_passes.py), the two chunk passes run well below
// the memory rate: each (chunk, head) reads and writes rows of 128 bytes
// that lie H P elements apart, and a block steps through its heads one at
// a time, a barrier or two each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kQ = 128;                 // bf16 chunk length
constexpr int kWarps = kQ / 16;         // a warp per 16 rows of a chunk
constexpr int kThreads = 32 * kWarps;
constexpr int kQ32 = 64;                // f32 chunk length
constexpr int kThreads32 = 256;
constexpr int kMaxP = 64;               // widths the kernels take: multiples
constexpr int kMaxN = 128;              // of 16 up to these
constexpr int kStages = 2;              // bf16: one head computed, one
                                        // loading (buf ^ 1 alternates them)
constexpr int kPassThreads = 256;       // state_pass
constexpr int kAhead = 16;              // state_pass: chunks in flight

// ------------------------------------------------------------ helpers ----

// g exp(cq - cs) where s <= q (the exponent is <= 0 there), else 0; the
// exponent is clamped at 0 so that no branch evaluates a positive one.
// __expf (ex2.approx): ~1e-6 relative at the exponents of a chunk
__device__ __forceinline__ float decayed(bool keep, float g, float cq,
                                         float cs) {
  const float w = g * __expf(fminf(cq - cs, 0.0f));
  return keep ? w : 0.0f;
}

// One warp: cum[q] = sum_{r <= q} log(max(a[r], 1e-20)) over a chunk's Q
// steps, Q / 32 consecutive steps a lane; a step at or past `valid` reads a
// = 1.  Returns the chunk's total (every lane).  cum may alias a: each lane
// reads its steps before it writes them.
template <int Q>
__device__ __forceinline__ float warp_cumlog(const float* a, float* cum,
                                             int valid) {
  constexpr int R = Q / 32;
  const int lane = threadIdx.x & 31;
  float v[R];
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = R * lane + r;
    v[r] = q < valid ? logf(fmaxf(a[q], 1e-20f)) : 0.0f;
    s += v[r];
  }
  float incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  float run = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) run = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    run += v[r];
    cum[R * lane + r] = run;
  }
  return __shfl_sync(kFull, incl, 31);
}

__device__ __forceinline__ size_t state_off(int b, int c, int h, int nc,
                                            int H, int P, int N) {
  return (((size_t)b * nc + c) * H + h) * (size_t)P * N;
}

// --------------------------------------------------- bf16: chunk state ----
//
// Shared memory: B (kQ x ldn bf16), X in kStages buffers (kQ x ldp bf16:
// this head's, which becomes hi, and the next head's in flight), lo (kQ x
// ldp bf16), a in kStages buffers (kQ f32), exp(total - cum) (kQ f32).
// ldn = N + 8, ldp = P + 8.

inline size_t state_bf16_smem(int P, int N) {
  return 2 * (size_t)kQ * ((N + 8) + (kStages + 1) * (P + 8)) +
         4 * (size_t)kQ * (kStages + 1);
}

// A thread's share of copying rows of `pieces` 16-byte pieces (pieces <=
// 32): piece k of rows q0, q0 + step, ...  The division is made once a
// kernel, not once a head.
struct RowCopy {
  int k, q0, step;
  __device__ explicit RowCopy(int pieces) {
    step = blockDim.x / pieces;
    k = threadIdx.x % pieces;
    q0 = threadIdx.x < step * pieces ? threadIdx.x / pieces : 1 << 30;
  }
};

__device__ __forceinline__ void load_x_a(const bf16* __restrict__ xh,
                                         const float* __restrict__ a,
                                         bf16* sx, float* sa, int b, int h,
                                         int t0, int T, int H, int P,
                                         int ldp, const RowCopy& xc) {
  for (int q = xc.q0; q < kQ; q += xc.step) {     // P / 8 pieces a row
    const int t = t0 + q;
    const bool ok = t < T;
    cp_async16(sx + q * ldp + 8 * xc.k,
               xh + (((size_t)b * T + (ok ? t : 0)) * H + h) * P + 8 * xc.k,
               ok);
  }
  for (int q = threadIdx.x; q < kQ; q += blockDim.x)
    if (t0 + q < T) cp_async4(sa + q, a + ((size_t)b * T + t0 + q) * H + h);
}

// rows [t0, t0 + kQ) x the nw columns at src of a (B, T, ld) array
__device__ __forceinline__ void load_rows_bf16(const bf16* __restrict__ src,
                                               bf16* dst, int b, int t0,
                                               int T, int nw, int ldn,
                                               int ld) {
  const RowCopy rc(nw / 8);
  for (int q = rc.q0; q < kQ; q += rc.step) {
    const int t = t0 + q;
    const bool ok = t < T;
    cp_async16(dst + q * ldn + 8 * rc.k,
               src + ((size_t)b * T + (ok ? t : 0)) * ld + 8 * rc.k, ok);
  }
}

// The state slice of a block of a chunk pass: grid z = head group x S
struct Slice {
  int n0, nw, h0, h1;
  __device__ Slice(int N, int NS, int S, int H, int hpb) {
    const int z = blockIdx.z, sl = z % S;
    n0 = sl * NS;
    nw = min(NS, N - n0);
    h0 = (z / S) * hpb;
    h1 = min(H, h0 + hpb);
  }
};

__global__ void __launch_bounds__(kThreads, 2)
chunk_state_bf16(const bf16* __restrict__ xh, const float* __restrict__ a,
                 const bf16* __restrict__ bmat, float* __restrict__ state,
                 float* __restrict__ decay, int T, int H, int P, int N,
                 int NS, int S, int nc, int hpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice sl(N, NS, S, H, hpb);
  const int nw = sl.nw, ldn = nw + 8, ldp = P + 8;
  bf16* sB = reinterpret_cast<bf16*>(smem);
  bf16* sX = sB + kQ * ldn;                       // kStages buffers
  bf16* sLo = sX + kStages * kQ * ldp;
  float* sA = reinterpret_cast<float*>(sLo + kQ * ldp);   // kStages buffers
  float* sDte = sA + kStages * kQ;

  const int c = blockIdx.x, b = blockIdx.y, t0 = c * kQ;
  const int h0 = sl.h0, h1 = sl.h1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // a cp.async group per head, one ahead (B rides in the first); the
  // buffer the next head loads into was last read by the head before this
  // one, which every thread finished before the barrier
  const RowCopy xc(P / 8);
  load_rows_bf16(bmat + sl.n0, sB, b, t0, T, nw, ldn, N);
  load_x_a(xh, a, sX, sA, b, h0, t0, T, H, P, ldp, xc);
  cp_async_commit();
  for (int h = h0, buf = 0; h < h1; ++h, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (h + 1 < h1)
      load_x_a(xh, a, sX + (buf ^ 1) * kQ * ldp, sA + (buf ^ 1) * kQ, b,
               h + 1, t0, T, H, P, ldp, xc);
    cp_async_commit();
    bf16* x = sX + buf * kQ * ldp;
    if (warp == 0) {
      const float total = warp_cumlog<kQ>(sA + buf * kQ, sDte, T - t0);
      __syncwarp();
      for (int q = lane; q < kQ; q += 32) sDte[q] = expf(total - sDte[q]);
      if (lane == 0 && sl.n0 == 0)
        decay[((size_t)b * nc + c) * H + h] = expf(total);
    }
    __syncthreads();
    // X o exp(total - cum) as hi (in place of X) + lo: lane j of a warp
    // takes columns (2 j, 2 j + 1) of rows warp, warp + kWarps, ...
    if (lane < P / 2) {
      for (int s = warp; s < kQ; s += kWarps) {
        uint32_t* px = reinterpret_cast<uint32_t*>(x + s * ldp) + lane;
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(px));
        const float w = sDte[s];
        uint32_t hi, lo;
        split2(v.x * w, v.y * w, hi, lo);
        *px = hi;
        reinterpret_cast<uint32_t*>(sLo + s * ldp)[lane] = lo;
      }
    }
    __syncthreads();
    // S (P x N) = Xw^T B: a warp takes 16 rows (p) x 32 columns (n) at a
    // time; A = Xw^T and B are stored with the reduced index s outermost,
    // so both come through ldmatrix.trans
    const int n_groups = (nw + 31) / 32, items = (P / 16) * n_groups;
    const int mi = lane >> 3, r = lane & 7;
    for (int it = warp; it < items; it += kWarps) {
      const int mt = it / n_groups, ng = it - mt * n_groups;
      const int n_pairs = min(2, (nw - 32 * ng) / 16);  // of n8 tiles
      float acc[4][4] = {};
      for (int ks = 0; ks < kQ / 16; ++ks) {
        uint32_t ahi[4], alo[4];
        const int srow = 16 * ks + ((mi >> 1) << 3) + r;
        const int pcol = 16 * mt + ((mi & 1) << 3);
        ldsm_x4_t(ahi, x + srow * ldp + pcol);
        ldsm_x4_t(alo, sLo + srow * ldp + pcol);
        uint32_t bb[2][4];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          if (jp < n_pairs)
            ldsm_x4_t(bb[jp], sB + (16 * ks + ((mi & 1) << 3) + r) * ldn +
                                  32 * ng + 16 * jp + ((mi >> 1) << 3));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          if (jp < n_pairs) {
            mma_bf16(acc[2 * jp], ahi, bb[jp][0], bb[jp][1]);
            mma_bf16(acc[2 * jp + 1], ahi, bb[jp][2], bb[jp][3]);
          }
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          if (jp < n_pairs) {
            mma_bf16(acc[2 * jp], alo, bb[jp][0], bb[jp][1]);
            mma_bf16(acc[2 * jp + 1], alo, bb[jp][2], bb[jp][3]);
          }
        }
      }
      float* out = state + state_off(b, c, h, nc, H, P, N) + sl.n0;
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < 2 * n_pairs) {
          const int n = 32 * ng + 8 * j + 2 * tq, p = 16 * mt + g;
          *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
              make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(out + (size_t)(p + 8) * N + n) =
              make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
  }
}

// ---------------------------------------------------- bf16: chunk scan ----
//
// Shared memory: C and B (kQ x ldn bf16 each), then per buffer X (kQ x ldp
// bf16), C B^T (below), per buffer h_{c-1} (P x ldh f32, ldh = N + 8) and a
// (kQ f32), and cum (kQ f32).  C B^T is kept in the accumulator layout of
// its 16 x 16 tiles on and below the diagonal: tile (row r, column k), k <=
// r, at slot r (r + 1) / 2 + k, lane l's 8 values (two n8 tiles x 4)
// together, so a warp reads its lanes' own values back.
//
// The work of a row tile r grows with r (W X over k <= r).  Warps 2i and
// 2i + 1 share row tiles i and kWarps - 1 - i, each taking half of the P
// columns: every warp does kWarps + 1 tiles of W X, where a warp per row
// tile did 1 to kWarps.

constexpr int kGTiles = kWarps * (kWarps + 1) / 2;

inline size_t scan_bf16_smem(int P, int N) {
  return 2 * (size_t)kQ * (2 * (N + 8) + kStages * (P + 8)) +
         4 * (size_t)kGTiles * 32 * 8 + 4 * (size_t)kStages * P * (N + 8) +
         4 * (size_t)kQ * (kStages + 1);
}

__global__ void __launch_bounds__(kThreads, 1)
chunk_scan_bf16(const bf16* __restrict__ xh, const float* __restrict__ a,
                const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
                const float* __restrict__ state, bf16* __restrict__ y,
                float* __restrict__ part, int T, int H, int P, int N, int NS,
                int S, int nc, int hpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice sl(N, NS, S, H, hpb);
  const int nw = sl.nw, ldn = nw + 8, ldp = P + 8, ldh = nw + 8;
  bf16* sC = reinterpret_cast<bf16*>(smem);
  bf16* sB = sC + kQ * ldn;
  bf16* sX = sB + kQ * ldn;                       // kStages buffers
  float4* sG = reinterpret_cast<float4*>(sX + kStages * kQ * ldp);
  float* sH = reinterpret_cast<float*>(sG + kGTiles * 32 * 2);
  float* sA = sH + kStages * P * ldh;             // kStages buffers
  float* sCum = sA + kStages * kQ;

  const int c = blockIdx.x, b = blockIdx.y, t0 = c * kQ;
  const int h0 = sl.h0, h1 = sl.h1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = lane >> 3, r = lane & 7, g = lane >> 2, tq = lane & 3;
  // this slice's share of y (S > 1), else y itself
  float* share = part ? part + (size_t)(blockIdx.z % S) * gridDim.y * T * H * P
                      : nullptr;

  const RowCopy xc(P / 8), hc(nw / 4);
  auto load_head = [&](int h, int buf) {
    load_x_a(xh, a, sX + buf * kQ * ldp, sA + buf * kQ, b, h, t0, T, H, P,
             ldp, xc);
    const float* src =
        state + state_off(b, c, h, nc, H, P, N) + sl.n0 + 4 * hc.k;
    float* dst = sH + buf * P * ldh + 4 * hc.k;
    for (int p = hc.q0; p < P; p += hc.step)      // nw / 4 pieces a row
      cp_async16(dst + p * ldh, src + (size_t)p * N, true);
  };
  // as chunk_state_bf16: a cp.async group per head, one ahead
  load_rows_bf16(cmat + sl.n0, sC, b, t0, T, nw, ldn, N);
  load_rows_bf16(bmat + sl.n0, sB, b, t0, T, nw, ldn, N);
  load_head(h0, 0);
  cp_async_commit();

  const int pair = warp >> 1;
  const int rt[2] = {pair, kWarps - 1 - pair};    // this warp's row tiles
  const int ntile = P / 16;                       // n8 tiles of half of P
  const int col0 = (warp & 1) * (P / 2);          // ... from this column
  for (int h = h0, buf = 0; h < h1; ++h, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (h + 1 < h1) load_head(h + 1, buf ^ 1);
    cp_async_commit();
    if (h == h0) {               // C B^T: warp w forms row tile w, once
      float G[2 * kWarps][4];
#pragma unroll
      for (int j = 0; j < 2 * kWarps; ++j)
        G[j][0] = G[j][1] = G[j][2] = G[j][3] = 0.0f;
      for (int ks = 0; ks < nw / 16; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, sC + (16 * warp + ((mi & 1) << 3) + r) * ldn + 16 * ks +
                        ((mi >> 1) << 3));
#pragma unroll
        for (int jp = 0; jp < kWarps; ++jp) {
          if (jp <= warp) {
            uint32_t bb[4];
            ldsm_x4(bb, sB + (16 * jp + ((mi >> 1) << 3) + r) * ldn +
                            16 * ks + ((mi & 1) << 3));
            mma_bf16(G[2 * jp], af, bb[0], bb[1]);
            mma_bf16(G[2 * jp + 1], af, bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        if (k <= warp) {
          float4* slot = sG + 2 * ((warp * (warp + 1) / 2 + k) * 32 + lane);
          slot[0] = make_float4(G[2 * k][0], G[2 * k][1], G[2 * k][2],
                                G[2 * k][3]);
          slot[1] = make_float4(G[2 * k + 1][0], G[2 * k + 1][1],
                                G[2 * k + 1][2], G[2 * k + 1][3]);
        }
      }
    }
    if (warp == 0) warp_cumlog<kQ>(sA + buf * kQ, sCum, T - t0);
    __syncthreads();             // cum, and on the first head C B^T, are in

    const bf16* x = sX + buf * kQ * ldp;
    const float* hs = sH + buf * P * ldh;
    float cq[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      cq[u][0] = sCum[16 * rt[u] + g];
      cq[u][1] = sCum[16 * rt[u] + g + 8];
    }
    float acc[2][kMaxP / 16][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < kMaxP / 16; ++j)
        acc[u][j][0] = acc[u][j][1] = acc[u][j][2] = acc[u][j][3] = 0.0f;
    // C h^T (K = nw): A = C's rows of each row tile, B = h (p, n), n
    // innermost, read once for both row tiles
    for (int ks = 0; ks < nw / 16; ++ks) {
      uint32_t hi[kMaxP / 16][2], lo[kMaxP / 16][2];
#pragma unroll
      for (int j = 0; j < kMaxP / 16; ++j) {
        if (j < ntile) {
          const float* hr = hs + (col0 + 8 * j + g) * ldh + 16 * ks + 2 * tq;
          const float2 v0 = *reinterpret_cast<const float2*>(hr);
          const float2 v1 = *reinterpret_cast<const float2*>(hr + 8);
          split2(v0.x, v0.y, hi[j][0], lo[j][0]);
          split2(v1.x, v1.y, hi[j][1], lo[j][1]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t af[4];
        ldsm_x4(af, sC + (16 * rt[u] + ((mi & 1) << 3) + r) * ldn + 16 * ks +
                        ((mi >> 1) << 3));
#pragma unroll
        for (int j = 0; j < kMaxP / 16; ++j)
          if (j < ntile) mma_bf16(acc[u][j], af, hi[j][0], hi[j][1]);
#pragma unroll
        for (int j = 0; j < kMaxP / 16; ++j)
          if (j < ntile) mma_bf16(acc[u][j], af, lo[j][0], lo[j][1]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float e0 = expf(cq[u][0]), e1 = expf(cq[u][1]);
#pragma unroll
      for (int j = 0; j < kMaxP / 16; ++j) {
        acc[u][j][0] *= e0;
        acc[u][j][1] *= e0;
        acc[u][j][2] *= e1;
        acc[u][j][3] *= e1;
      }
    }
    // W X (K = s <= q): W from C B^T and L, X stored (s, p), s outermost:
    // ldmatrix.trans; row tile rt[1] takes every s tile up to its own, rt[0]
    // the first pair + 1 of them
#pragma unroll
    for (int ks = 0; ks < kWarps; ++ks) {
      if (ks <= rt[1]) {
        uint32_t bb[kMaxP / 32][4];
#pragma unroll
        for (int jp = 0; jp < kMaxP / 32; ++jp)
          if (2 * jp < ntile)
            ldsm_x4_t(bb[jp], x + (16 * ks + ((mi & 1) << 3) + r) * ldp +
                                  col0 + 16 * jp + ((mi >> 1) << 3));
        const int s0 = 16 * ks + 2 * tq;
        const float c0 = sCum[s0], c1 = sCum[s0 + 1];
        const float c2 = sCum[s0 + 8], c3 = sCum[s0 + 9];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (ks <= rt[u]) {
            const float4* slot =
                sG + 2 * ((rt[u] * (rt[u] + 1) / 2 + ks) * 32 + lane);
            const float4 ga = slot[0], gb = slot[1];
            const int q0 = 16 * rt[u] + g, q1 = q0 + 8;
            // a0: (q0; s0, s0 + 1), a1: (q1; s0, s0 + 1), a2 / a3: s0 + 8, 9
            uint32_t whi[4], wlo[4];
            split2(decayed(s0 <= q0, ga.x, cq[u][0], c0),
                   decayed(s0 + 1 <= q0, ga.y, cq[u][0], c1), whi[0], wlo[0]);
            split2(decayed(s0 <= q1, ga.z, cq[u][1], c0),
                   decayed(s0 + 1 <= q1, ga.w, cq[u][1], c1), whi[1], wlo[1]);
            split2(decayed(s0 + 8 <= q0, gb.x, cq[u][0], c2),
                   decayed(s0 + 9 <= q0, gb.y, cq[u][0], c3), whi[2], wlo[2]);
            split2(decayed(s0 + 8 <= q1, gb.z, cq[u][1], c2),
                   decayed(s0 + 9 <= q1, gb.w, cq[u][1], c3), whi[3], wlo[3]);
#pragma unroll
            for (int jp = 0; jp < kMaxP / 32; ++jp) {
              if (2 * jp < ntile)
                mma_bf16(acc[u][2 * jp], whi, bb[jp][0], bb[jp][1]);
              if (2 * jp + 1 < ntile)
                mma_bf16(acc[u][2 * jp + 1], whi, bb[jp][2], bb[jp][3]);
            }
#pragma unroll
            for (int jp = 0; jp < kMaxP / 32; ++jp) {
              if (2 * jp < ntile)
                mma_bf16(acc[u][2 * jp], wlo, bb[jp][0], bb[jp][1]);
              if (2 * jp + 1 < ntile)
                mma_bf16(acc[u][2 * jp + 1], wlo, bb[jp][2], bb[jp][3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ta = t0 + 16 * rt[u] + g, tb = ta + 8;
#pragma unroll
      for (int j = 0; j < kMaxP / 16; ++j) {
        if (j < ntile) {
          const int p = col0 + 8 * j + 2 * tq;
          const size_t ia = (((size_t)b * T + ta) * H + h) * P + p;
          const size_t ib = (((size_t)b * T + tb) * H + h) * P + p;
          if (share) {
            if (ta < T)
              *reinterpret_cast<float2*>(share + ia) =
                  make_float2(acc[u][j][0], acc[u][j][1]);
            if (tb < T)
              *reinterpret_cast<float2*>(share + ib) =
                  make_float2(acc[u][j][2], acc[u][j][3]);
          } else {
            if (ta < T)
              *reinterpret_cast<__nv_bfloat162*>(y + ia) =
                  __floats2bfloat162_rn(acc[u][j][0], acc[u][j][1]);
            if (tb < T)
              *reinterpret_cast<__nv_bfloat162*>(y + ib) =
                  __floats2bfloat162_rn(acc[u][j][2], acc[u][j][3]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------- f32: chunk state ----
//
// Shared memory: B (kQ32 x N), X (kQ32 x P), a, exp(total - cum) (kQ32).

inline size_t state_f32_smem(int P, int N) {
  return 4 * ((size_t)kQ32 * (N + P) + 2 * kQ32);
}

__global__ void __launch_bounds__(kThreads32)
chunk_state_f32(const float* __restrict__ xh, const float* __restrict__ a,
                const float* __restrict__ bmat, float* __restrict__ state,
                float* __restrict__ decay, int T, int H, int P, int N, int NS,
                int S, int nc, int hpb) {
  extern __shared__ float fsm[];
  const Slice sl(N, NS, S, H, hpb);
  const int nw = sl.nw;
  float* sB = fsm;                                // kQ32 x nw
  float* sX = sB + kQ32 * nw;                     // kQ32 x P
  float* sA = sX + kQ32 * P;
  float* sDte = sA + kQ32;
  const int c = blockIdx.x, b = blockIdx.y, t0 = c * kQ32;
  const int h0 = sl.h0, h1 = sl.h1;
  const int tid = threadIdx.x;
  for (int i = tid; i < kQ32 * nw; i += kThreads32) {
    const int q = i / nw, t = t0 + q;
    sB[i] = t < T ? bmat[((size_t)b * T + t) * N + sl.n0 + (i - q * nw)]
                  : 0.0f;
  }
  for (int h = h0; h < h1; ++h) {
    __syncthreads();                              // the last head is done
    for (int i = tid; i < kQ32 * P; i += kThreads32) {
      const int q = i / P, t = t0 + q;
      sX[i] = t < T ? xh[(((size_t)b * T + t) * H + h) * P + (i - q * P)]
                    : 0.0f;
    }
    if (tid < kQ32 && t0 + tid < T)
      sA[tid] = a[((size_t)b * T + t0 + tid) * H + h];
    __syncthreads();
    if (tid < 32) {
      const float total = warp_cumlog<kQ32>(sA, sDte, T - t0);
      __syncwarp();
      for (int q = tid; q < kQ32; q += 32) sDte[q] = expf(total - sDte[q]);
      if (tid == 0 && sl.n0 == 0)
        decay[((size_t)b * nc + c) * H + h] = expf(total);
    }
    __syncthreads();
    float* out = state + state_off(b, c, h, nc, H, P, N) + sl.n0;
    for (int i = tid; i < P * nw; i += kThreads32) {
      const int p = i / nw, n = i - p * nw;
      float acc = 0.0f;
      for (int s = 0; s < kQ32; ++s)
        acc = fmaf(sX[s * P + p] * sDte[s], sB[s * nw + n], acc);
      out[(size_t)p * N + n] = acc;
    }
  }
}

// ----------------------------------------------------- f32: chunk scan ----
//
// Shared memory: C (kQ32 x (N + 1)), C B^T and W (kQ32 x (kQ32 + 1) each), X
// (kQ32 x P), h_{c-1} (P x (N + 1)), cum and exp(cum) (kQ32).  B passes
// through W's place while C B^T is formed.  Rows read down a column are
// padded to an odd stride, so those reads hit 32 different banks.

inline size_t scan_f32_smem(int P, int N) {
  const size_t w = (size_t)kQ32 * (kQ32 + 1);
  const size_t bw = (size_t)kQ32 * (N + 1) > w ? (size_t)kQ32 * (N + 1) : w;
  return 4 * ((size_t)kQ32 * (N + 1) + w + bw + (size_t)kQ32 * P +
              (size_t)P * (N + 1) + 2 * kQ32);
}

__global__ void __launch_bounds__(kThreads32)
chunk_scan_f32(const float* __restrict__ xh, const float* __restrict__ a,
               const float* __restrict__ bmat, const float* __restrict__ cmat,
               const float* __restrict__ state, float* __restrict__ y,
               float* __restrict__ part, int T, int H, int P, int N, int NS,
               int S, int nc, int hpb) {
  extern __shared__ float fsm[];
  const Slice sl(N, NS, S, H, hpb);
  const int nw = sl.nw, ldn = nw + 1, ldw = kQ32 + 1;
  const size_t w_size = (size_t)kQ32 * ldw;
  const size_t bw = (size_t)kQ32 * ldn > w_size ? (size_t)kQ32 * ldn : w_size;
  float* sC = fsm;                                // kQ32 x ldn
  float* sG = sC + kQ32 * ldn;                    // kQ32 x ldw
  float* sW = sG + w_size;                        // kQ32 x ldw (B first)
  float* sX = sW + bw;                            // kQ32 x P
  float* sH = sX + kQ32 * P;                      // P x ldn
  float* sCum = sH + P * ldn;
  float* sDst = sCum + kQ32;
  const int c = blockIdx.x, b = blockIdx.y, t0 = c * kQ32;
  const int h0 = sl.h0, h1 = sl.h1;
  const int tid = threadIdx.x;
  // this slice's share of y (S > 1), else y itself
  float* dst = part ? part + (size_t)(blockIdx.z % S) * gridDim.y * T * H * P
                    : y;

  for (int i = tid; i < kQ32 * nw; i += kThreads32) {
    const int q = i / nw, n = i - q * nw, t = t0 + q;
    const size_t off = ((size_t)b * T + t) * N + sl.n0 + n;
    sC[q * ldn + n] = t < T ? cmat[off] : 0.0f;
    sW[q * ldn + n] = t < T ? bmat[off] : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < kQ32 * kQ32; i += kThreads32) {
    const int q = i / kQ32, s = i - q * kQ32;
    float g = 0.0f;
    if (s <= q) {
      const float* cq = sC + q * ldn;
      const float* bs = sW + s * ldn;
      for (int n = 0; n < nw; ++n) g = fmaf(cq[n], bs[n], g);
    }
    sG[q * ldw + s] = g;
  }
  for (int h = h0; h < h1; ++h) {
    __syncthreads();                              // the last head is done
    for (int i = tid; i < kQ32 * P; i += kThreads32) {
      const int q = i / P, t = t0 + q;
      sX[i] = t < T ? xh[(((size_t)b * T + t) * H + h) * P + (i - q * P)]
                    : 0.0f;
    }
    const float* src = state + state_off(b, c, h, nc, H, P, N) + sl.n0;
    for (int i = tid; i < P * nw; i += kThreads32) {
      const int p = i / nw, n = i - p * nw;
      sH[p * ldn + n] = src[(size_t)p * N + n];
    }
    if (tid < kQ32 && t0 + tid < T)
      sCum[tid] = a[((size_t)b * T + t0 + tid) * H + h];
    __syncthreads();
    if (tid < 32) {
      warp_cumlog<kQ32>(sCum, sCum, T - t0);
      __syncwarp();
      for (int q = tid; q < kQ32; q += 32) sDst[q] = expf(sCum[q]);
    }
    __syncthreads();
    for (int i = tid; i < kQ32 * kQ32; i += kThreads32) {
      const int q = i / kQ32, s = i - q * kQ32;
      sW[q * ldw + s] = decayed(s <= q, sG[q * ldw + s], sCum[q], sCum[s]);
    }
    __syncthreads();
    for (int i = tid; i < kQ32 * P; i += kThreads32) {
      const int q = i / P, p = i - q * P, t = t0 + q;
      const float* wq = sW + q * ldw;
      float acc = 0.0f;
      for (int s = 0; s <= q; ++s) acc = fmaf(wq[s], sX[s * P + p], acc);
      const float* cq = sC + q * ldn;
      const float* hp = sH + p * ldn;
      float ch = 0.0f;
      for (int n = 0; n < nw; ++n) ch = fmaf(cq[n], hp[n], ch);
      acc = fmaf(sDst[q], ch, acc);
      if (t < T) dst[(((size_t)b * T + t) * H + h) * P + p] = acc;
    }
  }
}

// -------------------------------------------------------- state pass ----
//
// Per (batch, head), four consecutive state elements a thread: h = 0, then
// over the chunks in order, slot c <- h (= h_{c-1}) and h <- h exp(total_c)
// + S_c.  The S and decay loads do not depend on h: kAhead chunks of them
// are loaded at once (registers indexed at compile time), then stepped.

__global__ void __launch_bounds__(kPassThreads, 2)
state_pass(float* __restrict__ state, const float* __restrict__ decay, int H,
           int PN, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  if (e >= PN) return;
  float4* slot = reinterpret_cast<float4*>(state + ((size_t)b * nc * H + h) *
                                                       PN + e);
  const size_t step = (size_t)H * PN / 4;         // one chunk further
  const float* dec = decay + (size_t)b * nc * H + h;
  float4 hv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 sv[kAhead];
    float dv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        sv[i] = slot[(c0 + i) * step];
        dv[i] = dec[(size_t)(c0 + i) * H];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        slot[(c0 + i) * step] = hv;
        hv.x = fmaf(hv.x, dv[i], sv[i].x);
        hv.y = fmaf(hv.y, dv[i], sv[i].y);
        hv.z = fmaf(hv.z, dv[i], sv[i].z);
        hv.w = fmaf(hv.w, dv[i], sv[i].w);
      }
    }
  }
}

// --------------------------------------------------------- sum_slices ----
//
// y = the S slices' shares of it added in slice order, in f32, rounded once
// to y's type; four elements a thread (P is a multiple of 16).

constexpr int kSumThreads = 256;

__device__ __forceinline__ void store4(float* y, size_t i, float4 v) {
  reinterpret_cast<float4*>(y)[i] = v;
}
__device__ __forceinline__ void store4(bf16* y, size_t i, float4 v) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(y) + 2 * i;
  p[0] = __floats2bfloat162_rn(v.x, v.y);
  p[1] = __floats2bfloat162_rn(v.z, v.w);
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum_slices(const float4* __restrict__ part, T* __restrict__ y, int S,
           size_t n4) {
  const size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n4) return;
  float4 acc = part[i];
  for (int s = 1; s < S; ++s) {
    const float4 v = part[(size_t)s * n4 + i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  store4(y, i, acc);
}

// ------------------------------------------------------------ launch ----

inline int heads_per_block(int B, int nc, int H) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // every head of a chunk in one block (C B^T formed once), unless that
  // leaves SMs idle: then the heads are split over ceil(sms / (B nc)) blocks
  const long long chunks = (long long)B * nc;
  int groups = chunks >= sms ? 1 : (int)((sms + chunks - 1) / chunks);
  groups = groups < H ? groups : H;
  return (H + groups - 1) / groups;
}

// P and a slice width NS: multiples of 16 up to kMaxP and kMaxN
inline bool shape_ok(int B, int T, int H, int P, int NS) {
  return B >= 1 && T >= 1 && H >= 1 && P >= 16 && NS >= 16 && P % 16 == 0 &&
         NS % 16 == 0 && P <= kMaxP && NS <= kMaxN;
}

template <typename T>
int launch(const void* xh, const void* a, const void* b, const void* c,
           void* y, int B, int T_, int H, int P, int N, int NS, void* work,
           void* part, void* stream) {
  if (!shape_ok(B, T_, H, P, NS) || N < NS || N % 16)
    return (int)cudaErrorInvalidValue;
  const int S = (N + NS - 1) / NS;
  if (S > 1 && !part) return (int)cudaErrorInvalidValue;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int Q = kBf16 ? kQ : kQ32;
  const int nc = (T_ + Q - 1) / Q;
  float* state = (float*)work;
  float* decay = state + (size_t)B * nc * H * P * N;
  float* share = S > 1 ? (float*)part : nullptr;
  const int hpb = heads_per_block(B * S, nc, H);
  const dim3 grid(nc, B, (H + hpb - 1) / hpb * S);
  cudaStream_t s = (cudaStream_t)stream;
  if (kBf16) {
    chunk_state_bf16<<<grid, kThreads, state_bf16_smem(P, NS), s>>>(
        (const bf16*)xh, (const float*)a, (const bf16*)b, state, decay, T_, H,
        P, N, NS, S, nc, hpb);
  } else {
    chunk_state_f32<<<grid, kThreads32, state_f32_smem(P, NS), s>>>(
        (const float*)xh, (const float*)a, (const float*)b, state, decay, T_,
        H, P, N, NS, S, nc, hpb);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int PN = P * N;
  state_pass<<<dim3((PN / 4 + kPassThreads - 1) / kPassThreads, H, B),
               kPassThreads, 0, s>>>(state, decay, H, PN, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (kBf16) {
    chunk_scan_bf16<<<grid, kThreads, scan_bf16_smem(P, NS), s>>>(
        (const bf16*)xh, (const float*)a, (const bf16*)b, (const bf16*)c,
        state, (bf16*)y, share, T_, H, P, N, NS, S, nc, hpb);
  } else {
    chunk_scan_f32<<<grid, kThreads32, scan_f32_smem(P, NS), s>>>(
        (const float*)xh, (const float*)a, (const float*)b, (const float*)c,
        state, (float*)y, share, T_, H, P, N, NS, S, nc, hpb);
  }
  if (S == 1) return (int)cudaGetLastError();
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n4 = (size_t)B * T_ * H * P / 4;
  sum_slices<T><<<(unsigned)((n4 + kSumThreads - 1) / kSumThreads),
                  kSumThreads, 0, s>>>((const float4*)part, (T*)y, S, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, after the library is loaded: let the four kernels that
// take dynamic shared memory have all a block may, and write the smallest
// limit to max_dyn.
int mamba2_scan_init(int* max_dyn) {
  *max_dyn = 1 << 30;
  cudaError_t e = allow_smem(chunk_state_bf16, max_dyn);
  if (e == cudaSuccess) e = allow_smem(chunk_scan_bf16, max_dyn);
  if (e == cudaSuccess) e = allow_smem(chunk_state_f32, max_dyn);
  if (e == cudaSuccess) e = allow_smem(chunk_scan_f32, max_dyn);
  return (int)e;
}

// Chunk length of the bf16 (bf16 != 0) or the f32 path.
int mamba2_scan_chunk(int bf16) { return bf16 ? kQ : kQ32; }

// Largest dynamic shared memory a block of the path takes at a head width P
// and a state slice of N columns, or -1 for a shape the kernels do not take
// (P, N multiples of 16, P <= 64, N <= 128).
int mamba2_scan_smem_bytes(int bf16, int P, int N) {
  if (!shape_ok(1, 1, 1, P, N)) return -1;
  const size_t st = bf16 ? state_bf16_smem(P, N) : state_f32_smem(P, N);
  const size_t sc = bf16 ? scan_bf16_smem(P, N) : scan_f32_smem(P, N);
  return (int)(st > sc ? st : sc);
}

// `work`: (B * nc * H * (P * N + 1)) floats, nc = ceil(T / chunk).  The
// state is cut into S = ceil(N / NS) slices of NS columns (N, NS multiples
// of 16, NS <= 128); `part`: (S * B * T * H * P) floats when S > 1 (else
// not read).  Three launches on `stream`, four when S > 1.
int mamba2_scan_f32(const void* xh, const void* a, const void* b,
                    const void* c, void* y, int B, int T, int H, int P, int N,
                    int NS, void* work, void* part, void* stream) {
  return launch<float>(xh, a, b, c, y, B, T, H, P, N, NS, work, part, stream);
}

int mamba2_scan_bf16(const void* xh, const void* a, const void* b,
                     const void* c, void* y, int B, int T, int H, int P,
                     int N, int NS, void* work, void* part, void* stream) {
  return launch<bf16>(xh, a, b, c, y, B, T, H, P, N, NS, work, part, stream);
}

}  // extern "C"
