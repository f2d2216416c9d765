// Chunkwise mLSTM / gated linear attention, written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mlstm.py mlstm_chunked_kernel (body _kernel;
// oracle repro.kernels.ref.gla_ref):
//   C_t = a_t C_{t-1} + i_t k_t v_t^T     n_t = a_t n_{t-1} + i_t k_t
//   y_t = (q_t C_t) / max(|q_t . n_t|, 1)          q scaled by K^-0.5
// per (batch, head), chunk by chunk, C (K x P) and n (K) carried in f32.
// Plain C interface, no PyTorch headers: the Python side
// (repro_torch/kernels/mlstm.py) loads the library with ctypes, hands in
// device pointers, a work buffer it allocated and PyTorch's current stream,
// and checks the returned cudaError_t.  The kernels allocate nothing and
// never synchronise.
//
//   q/k  (B, T, H, K)   f32 or bf16
//   v    (B, T, H, P)   q's type
//   a/i  (B, T, H)      f32: forget decay in (0, 1], input gate (up to e^10)
//   y    (B, T, H, P)   q's type
//   work (bf16 only)    a record per (batch, chunk, head), kRecBytes each
//
// Per chunk of kQ = 64 steps, as mlstm.py 31-79: cum = the running sum of
// log(max(a, 1e-20)) (log space: a running product underflows), total =
// its last value, and with q scaled by K^-0.5
//   W[q, s] = (q_q . k_s) exp(cum_q - cum_s) i_s          s <= q only
//   y[q]    = (W V + exp(cum_q) q_q C_{c-1}) / max(|sum_s W[q, s] +
//             exp(cum_q) q_q . n_{c-1}|, 1)
//   C_c     = C_{c-1} exp(total) + (K o dte)^T V,  dte = exp(total - cum) i
//   n_c     = n_{c-1} exp(total) + sum_s (K o dte)[s].
// A ragged last chunk reads a = 1, i = 0 and zeros past T and writes no row
// past T.
//
// K past kMaxK: the numerator q C and the normaliser q . n are sums over k,
// and row k of C and entry k of n evolve on their own under the same gates.
// So K is cut into S slices of KS columns (a multiple of kKs, the last one
// narrower) that the kernels take: the recurrence's blocks take one slice
// each (grid z = batch row x S) and write, unnormalised, their slice's part
// of the numerator (f32, chunk x P) and of the normaliser (f32, by the
// blocks of the first P slice); a last launch (mlstm_combine) adds the
// parts in slice order and only then divides by max(|q . n|, 1).  q's
// scale K^-0.5 is the whole K's.  In bf16 the scores are formed over the
// whole K as before and their part (W V, the row sums of W) is the first
// slice's; in f32 each slice forms its own scores over its columns (q k^T
// is a sum over k too).  No atomic, so repeats are bit-equal.  With K <=
// kMaxK the launches and their work are as they were (the kSplit = false
// instantiations).
//
// bf16 (the model's path): two launches, every product on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).
//   1. mlstm_scores_bf16, a block per (chunk, head, batch row), parallel:
//      Q K^T once a chunk (the first port formed it once per 32 columns of
//      P, 16 times at P = 512), then W in f32 with its row sums, the
//      chunk's exp(cum), dte and exp(total), into the chunk's record of the
//      work buffer.  W leaves as a pair hi + lo of bf16 (hi = bf16(w), lo =
//      bf16(w - hi)) in the mma A-fragment order of its causal 16 x 16
//      tiles, so that the next launch reads a lane's fragment as one 16-byte
//      piece, with no shuffle.
//   2. mlstm_recur_bf16, a block per (kPt columns of P, head, batch row),
//      walking its chunks in order with C[:, slice] (transposed: p rows, k
//      innermost) and n in f32 in shared memory.  The K contraction streams
//      through a two-buffer cp.async ring of 64-column slices of q and k
//      (the next slice, or the next chunk's first slice with its record and
//      V, loads while one computes); per slice: q C_{c-1}, q . n_{c-1}, then
//      the slice's part of C_c and n_c; per chunk the W V product and y.
// The inputs q, k and v are exact in bf16.  The operands the kernels make —
// W, C_{c-1} and K o dte — each enter two products as a hi + lo pair, so no
// product rounds an operand to 2^-9 (the input gate reaches e^10 and C
// grows with it).  Shared memory sets the P slice: kPt = 64 while C[:, slice]
// fits beside the ring (K <= 512 at 227 KB), else 32 (K <= 1024).
// f32: one launch of FFMA out of shared memory (mlstm_ffma: a block per (32
// columns of P, head, batch row) with Q K^T formed per block), since TF32
// would not hold the 2e-3 bar over K = 512.
//
// Bound.  The recurrence does 4 flops per (step, head, k, p) on ~6 bytes per
// (step, head, element) in bf16: ~K flops per byte, below the tensor cores'
// ~295 at K = 512, so bytes bound the ideal kernel.  This one is a chain of
// dependent K slices per block, one block per SM, whose products (doubled
// by the pairs) wait on shared-memory traffic and instruction issue: ~250
// KB of fragment loads, splits and state updates a slice.  16 warps a block
// instead of 8 loaded more fragments twice and ran 10 % slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kQ = 64;               // chunk length (both paths)
constexpr int kMaxK = 1024;          // widest K the kernels take
// ---- bf16 ----
constexpr int kKs = 64;              // K slice of the streamed contraction
constexpr int kLdS = kKs + 8;        // bf16 row stride of a slice: rows 16
                                     // bytes apart modulo 128 (ldmatrix)
constexpr int kRowTiles = kQ / 16;   // 16-row tiles of a chunk
constexpr int kTiles = kRowTiles * (kRowTiles + 1) / 2;   // causal tiles
constexpr int kRecW = kTiles * 32 * 32;                   // bytes of W
constexpr int kRecFloats = 3 * kQ + 4;   // exp(cum), dte, row sums, decay
constexpr int kRecBytes = kRecW + 4 * kRecFloats;
constexpr int kScoreThreads = 32 * kRowTiles;   // a warp per row tile
constexpr int kRecurThreads = 256;
constexpr int kRecurWarps = kRecurThreads / 32;
// ---- f32 ----
constexpr int kPt32 = 32;            // columns of P per block
constexpr int kKt = 32;              // K contraction tile
constexpr int kThreads32 = 256;
constexpr int kLdT = kKt + 1;
constexpr int kLdW = kQ + 1;

static_assert(kRecBytes % 16 == 0, "records are copied in 16-byte pieces");

__device__ __forceinline__ size_t row_off(int b, int t, int h, int T, int H) {
  return ((size_t)b * T + t) * H + h;
}

// rows [0, kQ) (steps t0..) x columns [c0, c0 + width) of a (B, T, H, D)
// bf16 tensor at batch b, head h into dst (row stride ld), zeros past T and
// past D: 16-byte cp.async pieces when D is a multiple of 8, else plain
// element copies (synchronous; dst is a buffer no thread reads meanwhile).
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src,
                                          bf16* dst, int ld, int b, int h,
                                          int t0, int c0, int width, int T,
                                          int H, int D) {
  if (D % 8 == 0) {
    const int pieces = width / 8;
    for (int i = threadIdx.x; i < kQ * pieces; i += blockDim.x) {
      const int r = i / pieces, c = c0 + 8 * (i - r * pieces), t = t0 + r;
      const bool ok = t < T && c < D;
      cp_async16(dst + r * ld + (c - c0),
                 src + row_off(b, ok ? t : 0, h, T, H) * D + (ok ? c : 0),
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kQ * width; i += blockDim.x) {
      const int r = i / width, c = c0 + (i - r * width), t = t0 + r;
      dst[r * ld + (c - c0)] = (t < T && c < D)
          ? src[row_off(b, t, h, T, H) * D + c] : __float2bfloat16(0.0f);
    }
  }
}

// ------------------------------------------------- bf16: the scores ----
//
// Shared memory: q and k slices in two buffers each (kQ x kLdS bf16), cum
// and the input gate (kQ f32).

constexpr size_t kScoreSmem = 2 * 2 * (size_t)kQ * kLdS * 2 + 2 * kQ * 4;

__global__ void __launch_bounds__(kScoreThreads, 4)
mlstm_scores_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const float* __restrict__ a, const float* __restrict__ ig,
                  unsigned char* __restrict__ work, int T, int H, int K,
                  int nc, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);          // 2 buffers
  bf16* sK = sQ + 2 * kQ * kLdS;                     // 2 buffers
  float* sCum = reinterpret_cast<float*>(sK + 2 * kQ * kLdS);
  float* sI = sCum + kQ;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = c * kQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = lane >> 3, r = lane & 7, g = lane >> 2, tq = lane & 3;
  const int nks = (K + kKs - 1) / kKs;

  load_rows(q, sQ, kLdS, b, h, t0, 0, kKs, T, H, K);
  load_rows(k, sK, kLdS, b, h, t0, 0, kKs, T, H, K);
  cp_async_commit();
  if (tid < kQ) {
    const int t = t0 + tid;
    sCum[tid] = t < T ? a[row_off(b, t, h, T, H)] : 1.0f;
    sI[tid] = t < T ? ig[row_off(b, t, h, T, H)] : 0.0f;
  }

  // Q K^T: warp w forms row tile w against the key tiles jp <= w
  float acc[2 * kRowTiles][4];
#pragma unroll
  for (int j = 0; j < 2 * kRowTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int j = 0; j < nks; ++j) {
    const int buf = j & 1;
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < nks) {
      load_rows(q, sQ + (buf ^ 1) * kQ * kLdS, kLdS, b, h, t0, (j + 1) * kKs,
                kKs, T, H, K);
      load_rows(k, sK + (buf ^ 1) * kQ * kLdS, kLdS, b, h, t0, (j + 1) * kKs,
                kKs, T, H, K);
    }
    cp_async_commit();
    const bf16* qs = sQ + buf * kQ * kLdS;
    const bf16* ks = sK + buf * kQ * kLdS;
#pragma unroll
    for (int kk = 0; kk < kKs / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, qs + (16 * warp + ((mi & 1) << 3) + r) * kLdS + 16 * kk +
                      ((mi >> 1) << 3));
#pragma unroll
      for (int jp = 0; jp < kRowTiles; ++jp) {
        if (jp <= warp) {
          uint32_t bb[4];
          ldsm_x4(bb, ks + (16 * jp + ((mi >> 1) << 3) + r) * kLdS + 16 * kk +
                          ((mi & 1) << 3));
          mma_bf16(acc[2 * jp], af, bb[0], bb[1]);
          mma_bf16(acc[2 * jp + 1], af, bb[2], bb[3]);
        }
      }
    }
  }
  if (warp == 0) chunk_cumlog(sCum, sCum);   // gates loaded before the loop
  __syncthreads();

  unsigned char* rec =
      work + (((size_t)b * nc + c) * H + h) * (size_t)kRecBytes;
  float* stats = reinterpret_cast<float*>(rec + kRecW);
  const float total = sCum[kQ - 1];
  if (tid < kQ) {
    stats[tid] = expf(sCum[tid]);
    stats[kQ + tid] = expf(total - sCum[tid]) * sI[tid];
  }
  if (tid == 0) stats[3 * kQ] = expf(total);

  // W in f32 (rows q0 = 16 w + g and q1 = q0 + 8 of this lane), its row
  // sums, then hi + lo A fragments of tile (w, ks): a0 = (q0; s, s + 1),
  // a1 = (q1; s, s + 1), a2 / a3 the same at s + 8, s = 16 ks + 2 tq
  const int q0 = 16 * warp + g, q1 = q0 + 8;
  const float cq0 = sCum[q0], cq1 = sCum[q1];
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 2 * kRowTiles; ++j) {
    if ((j >> 1) <= warp) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = 8 * j + 2 * tq + e;
        const float gs = scale * sI[s], cs = sCum[s];
        acc[j][e] = s <= q0 ? acc[j][e] * gs * expf(fminf(cq0 - cs, 0.0f))
                            : 0.0f;
        acc[j][2 + e] = s <= q1
            ? acc[j][2 + e] * gs * expf(fminf(cq1 - cs, 0.0f)) : 0.0f;
        sum0 += acc[j][e];
        sum1 += acc[j][2 + e];
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(kFull, sum0, o);
    sum1 += __shfl_xor_sync(kFull, sum1, o);
  }
  if (tq == 0) {
    stats[2 * kQ + q0] = sum0;
    stats[2 * kQ + q1] = sum1;
  }
  uint4* wrec = reinterpret_cast<uint4*>(rec);
#pragma unroll
  for (int ks = 0; ks < kRowTiles; ++ks) {
    if (ks <= warp) {
      uint4 hi, lo;
      split2(acc[2 * ks][0], acc[2 * ks][1], hi.x, lo.x);
      split2(acc[2 * ks][2], acc[2 * ks][3], hi.y, lo.y);
      split2(acc[2 * ks + 1][0], acc[2 * ks + 1][1], hi.z, lo.z);
      split2(acc[2 * ks + 1][2], acc[2 * ks + 1][3], hi.w, lo.w);
      uint4* slot = wrec + 2 * ((warp * (warp + 1) / 2 + ks) * 32 + lane);
      slot[0] = hi;
      slot[1] = lo;
    }
  }
}

// --------------------------------------------- bf16: the recurrence ----
//
// Shared memory (bytes): C[:, slice] transposed, kPt x ldc f32 (ldc = Kp +
// 8, Kp = K rounded up to kKs: a float2 read of 16 lanes hits 32 banks);
// n, Kp f32; the 8 warps' partial sums of n's update, 8 x kKs f32; the
// chunk's denominators, kQ f32; the q and k slices, two buffers each of kQ x
// kLdS bf16; lo of K o dte, kQ x kLdS bf16 (hi replaces k in place); V[:,
// slice] and the chunk's record in two buffers each (kQ x (kPt + 8) bf16,
// kRecBytes).

inline size_t recur_smem(int K, int pt) {
  const size_t Kp = (size_t)((K + kKs - 1) / kKs) * kKs;
  return 4 * (pt * (Kp + 8) + Kp + kRecurWarps * kKs + kQ) +
         2 * (5 * (size_t)kQ * kLdS + 2 * (size_t)kQ * (pt + 8)) +
         2 * (size_t)kRecBytes;
}

// kSplit: this block's columns are K slice (blockIdx.z % S) of width KS;
// it writes its parts of the numerator and normaliser to num / den.
template <int kPt, bool kSplit>
__global__ void __launch_bounds__(kRecurThreads, 1)
mlstm_recur_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const unsigned char* __restrict__ work, bf16* __restrict__ y,
                 int T, int H, int K, int P, int nc, float scale, int KS,
                 float* __restrict__ num, float* __restrict__ den) {
  constexpr int kNT = kPt / 32;            // y: n8 tiles a warp
  constexpr int kMT = kPt / 16;            // C update: m tiles (of p) ...
  constexpr int kWpm = kRecurWarps / kMT;  // ... warps on each ...
  constexpr int kCN = 8 / kWpm;            // ... n8 tiles (of k) a warp
  constexpr int kLdV = kPt + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = kSplit ? (K + KS - 1) / KS : 1;
  const int ksl = kSplit ? (int)blockIdx.z % S : 0;
  const int k0 = ksl * KS, Kw = kSplit ? min(KS, K - k0) : K;
  const int Kp = ((Kw + kKs - 1) / kKs) * kKs, ldc = Kp + 8;
  float* sC = reinterpret_cast<float*>(smem);
  float* sN = sC + kPt * ldc;
  float* sNp = sN + Kp;                              // kRecurWarps x kKs
  float* sDen = sNp + kRecurWarps * kKs;             // kQ
  bf16* sQ = reinterpret_cast<bf16*>(sDen + kQ);     // 2 buffers
  bf16* sK = sQ + 2 * kQ * kLdS;                     // 2 buffers
  bf16* sLo = sK + 2 * kQ * kLdS;
  bf16* sV = sLo + kQ * kLdS;                        // 2 buffers
  unsigned char* sRec =
      reinterpret_cast<unsigned char*>(sV + 2 * kQ * kLdV);   // 2 buffers

  const int p0 = blockIdx.x * kPt, h = blockIdx.y;
  const int b = kSplit ? (int)blockIdx.z / S : (int)blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = lane >> 3, r = lane & 7, g = lane >> 2, tq = lane & 3;
  const int nks = Kp / kKs, steps = nc * nks;
  // the slice's parts: rows (b, t, h) of a (S, B, T, H[, P]) array
  const size_t part_rows = kSplit ? (size_t)(gridDim.z / S) * T * H : 0;

  for (int i = tid; i < kPt * ldc; i += kRecurThreads) sC[i] = 0.0f;
  for (int i = tid; i < Kp; i += kRecurThreads) sN[i] = 0.0f;

  auto load_chunk = [&](int c) {      // the record and V[:, slice]
    const uint4* src = reinterpret_cast<const uint4*>(
        work + (((size_t)b * nc + c) * H + h) * (size_t)kRecBytes);
    uint4* dst = reinterpret_cast<uint4*>(sRec + (c & 1) * kRecBytes);
    for (int i = tid; i < kRecBytes / 16; i += kRecurThreads)
      cp_async16(dst + i, src + i, true);
    load_rows(v, sV + (c & 1) * kQ * kLdV, kLdV, b, h, c * kQ, p0, kPt, T, H,
              P);
  };
  auto load_slice = [&](int step) {   // q and k, columns of slice j
    const int c = step / nks, j = step - c * nks, buf = step & 1;
    load_rows(q, sQ + buf * kQ * kLdS, kLdS, b, h, c * kQ, k0 + j * kKs, kKs,
              T, H, K);
    load_rows(k, sK + buf * kQ * kLdS, kLdS, b, h, c * kQ, k0 + j * kKs, kKs,
              T, H, K);
  };
  load_chunk(0);
  load_slice(0);
  cp_async_commit();

  // y: warp w takes row tiles {w / 4, 3 - w / 4} (a causal pair: equal W V
  // work for every warp) and columns [col0, col0 + kPt / 4) of the slice
  const int rt[2] = {warp >> 2, kRowTiles - 1 - (warp >> 2)};
  const int col0 = (warp & 3) * (kPt / 4);
  // C update: warp w takes p rows [16 mt, 16 mt + 16) and k columns [8 kCN
  // nq, 8 kCN (nq + 1)) of each slice
  const int mt = warp / kWpm, nq = warp % kWpm;
  // q . n: thread t takes row t / 4, slice columns [16 (t % 4), + 16)
  const int qn_row = tid >> 2, qn_col = 16 * (tid & 3);
  float accy[2][kNT][4];
  float qn = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int c = step / nks, j = step - c * nks, buf = step & 1;
    const int kb = j * kKs;
    cp_async_wait_all();
    __syncthreads();                 // this step's loads are in; the last
                                     // step's reads of the other buffers done
    if (step + 1 < steps) {
      if (j + 1 == nks) load_chunk(c + 1);
      load_slice(step + 1);
    }
    cp_async_commit();
    const bf16* qs = sQ + buf * kQ * kLdS;
    bf16* ks = sK + buf * kQ * kLdS;
    const bf16* vs = sV + (c & 1) * kQ * kLdV;
    const unsigned char* rec = sRec + (c & 1) * kRecBytes;
    const float* ecum = reinterpret_cast<const float*>(rec + kRecW);
    const float* dte = ecum + kQ;
    const float* nrm = ecum + 2 * kQ;
    const float decay = ecum[3 * kQ];
    if (j == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          accy[u][n][0] = accy[u][n][1] = accy[u][n][2] = accy[u][n][3] = 0.0f;
      qn = 0.0f;
    }

    // q . n_{c-1} over this slice, in f32
    {
      const bf16* qr = qs + qn_row * kLdS + qn_col;
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const float2 qv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qr + e));
        qn = fmaf(qv.x, sN[kb + qn_col + e], qn);
        qn = fmaf(qv.y, sN[kb + qn_col + e + 1], qn);
      }
    }
    // q C_{c-1} over this slice: A = q's rows, B = C^T's columns of the
    // warp as hi + lo, read once for both row tiles
#pragma unroll
    for (int kk = 0; kk < kKs / 16; ++kk) {
      uint32_t chi[kNT][2], clo[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float* cr =
            sC + (col0 + 8 * n + g) * ldc + kb + 16 * kk + 2 * tq;
        const float2 v0 = *reinterpret_cast<const float2*>(cr);
        const float2 v1 = *reinterpret_cast<const float2*>(cr + 8);
        split2(v0.x, v0.y, chi[n][0], clo[n][0]);
        split2(v1.x, v1.y, chi[n][1], clo[n][1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t af[4];
        ldsm_x4(af, qs + (16 * rt[u] + ((mi & 1) << 3) + r) * kLdS + 16 * kk +
                        ((mi >> 1) << 3));
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma_bf16(accy[u][n], af, chi[n][0], chi[n][1]);
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma_bf16(accy[u][n], af, clo[n][0], clo[n][1]);
      }
    }
    // K o dte as hi (in place of k) + lo, and each warp's share of n's
    // update: lane l takes columns (2 l, 2 l + 1) of rows warp, warp + 8, ..
    {
      float n0 = 0.0f, n1 = 0.0f;
      for (int s = warp; s < kQ; s += kRecurWarps) {
        uint32_t* pk = reinterpret_cast<uint32_t*>(ks + s * kLdS) + lane;
        const float2 kv =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(pk));
        const float w = dte[s];
        uint32_t hi, lo;
        split2(kv.x * w, kv.y * w, hi, lo);
        n0 = fmaf(kv.x, w, n0);
        n1 = fmaf(kv.y, w, n1);
        *pk = hi;
        reinterpret_cast<uint32_t*>(sLo + s * kLdS)[lane] = lo;
      }
      sNp[warp * kKs + 2 * lane] = n0;
      sNp[warp * kKs + 2 * lane + 1] = n1;
    }
    {
      // the chunk's denominators, from the row's q . n_{c-1} (the four
      // threads of a row are lanes 4 i .. 4 i + 3)
      float s = qn + __shfl_xor_sync(kFull, qn, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      if (j + 1 == nks && (tid & 3) == 0) {
        if (kSplit) {      // this slice's part, unnormalised
          const int t = c * kQ + qn_row;
          const float d = (ksl == 0 ? nrm[qn_row] : 0.0f) +
                          ecum[qn_row] * scale * s;
          if (blockIdx.x == 0 && t < T)
            den[ksl * part_rows + row_off(b, t, h, T, H)] = d;
        } else {
          sDen[qn_row] =
              fmaxf(fabsf(nrm[qn_row] + ecum[qn_row] * scale * s), 1.0f);
        }
      }
    }
    __syncthreads();                 // C[:, slice] and n read; K o dte made

    // C_c[:, slice]^T = C^T exp(total) + V^T (K o dte): A = V^T (p, s),
    // B = K o dte (s, k) as hi + lo, both stored s outermost: ldmatrix.trans
    {
      float acc[kCN][4];
#pragma unroll
      for (int n = 0; n < kCN; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
          acc[n][3] = 0.0f;
#pragma unroll
      for (int ss = 0; ss < kQ / 16; ++ss) {
        uint32_t av[4];
        ldsm_x4_t(av, vs + (16 * ss + ((mi >> 1) << 3) + r) * kLdV + 16 * mt +
                          ((mi & 1) << 3));
#pragma unroll
        for (int jp = 0; jp < kCN / 2; ++jp) {
          const int kc = 8 * kCN * nq + 16 * jp + ((mi >> 1) << 3);
          const int sr = 16 * ss + ((mi & 1) << 3) + r;
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, ks + sr * kLdS + kc);
          ldsm_x4_t(bl, sLo + sr * kLdS + kc);
          mma_bf16(acc[2 * jp], av, bh[0], bh[1]);
          mma_bf16(acc[2 * jp + 1], av, bh[2], bh[3]);
          mma_bf16(acc[2 * jp], av, bl[0], bl[1]);
          mma_bf16(acc[2 * jp + 1], av, bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < kCN; ++n) {
        const int kc = kb + 8 * (kCN * nq + n) + 2 * tq;
        float2* c0 = reinterpret_cast<float2*>(sC + (16 * mt + g) * ldc + kc);
        float2* c1 = reinterpret_cast<float2*>(sC + (16 * mt + g + 8) * ldc +
                                               kc);
        float2 x0 = *c0, x1 = *c1;
        x0.x = fmaf(x0.x, decay, acc[n][0]);
        x0.y = fmaf(x0.y, decay, acc[n][1]);
        x1.x = fmaf(x1.x, decay, acc[n][2]);
        x1.y = fmaf(x1.y, decay, acc[n][3]);
        *c0 = x0;
        *c1 = x1;
      }
    }
    if (tid < kKs) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kRecurWarps; ++w) s += sNp[w * kKs + tid];
      sN[kb + tid] = fmaf(sN[kb + tid], decay, s);
    }
    if (j + 1 < nks) continue;

    // the chunk's end: y = (exp(cum) scale q C_{c-1} + W V) / den
    const uint4* wrec = reinterpret_cast<const uint4*>(rec);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float e0 = ecum[16 * rt[u] + g] * scale;
      const float e1 = ecum[16 * rt[u] + g + 8] * scale;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        accy[u][n][0] *= e0;
        accy[u][n][1] *= e0;
        accy[u][n][2] *= e1;
        accy[u][n][3] *= e1;
      }
    }
#pragma unroll
    for (int ss = 0; ss < kRowTiles; ++ss) {
      if (ss <= rt[1] && (!kSplit || ksl == 0)) {   // W V: the first slice's
        uint32_t bb[4];
        ldsm_x4_t(bb, vs + (16 * ss + ((mi & 1) << 3) + r) * kLdV + col0 +
                          ((mi >> 1) << 3));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (ss <= rt[u]) {
            const uint4* slot =
                wrec + 2 * ((rt[u] * (rt[u] + 1) / 2 + ss) * 32 + lane);
            const uint4 hv = slot[0], lv = slot[1];
            const uint32_t whi[4] = {hv.x, hv.y, hv.z, hv.w};
            const uint32_t wlo[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
            for (int n = 0; n < kNT; ++n)
              mma_bf16(accy[u][n], whi, bb[2 * n], bb[2 * n + 1]);
#pragma unroll
            for (int n = 0; n < kNT; ++n)
              mma_bf16(accy[u][n], wlo, bb[2 * n], bb[2 * n + 1]);
          }
        }
      }
    }
    const int t0 = c * kQ;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qq = 16 * rt[u] + g + 8 * half, t = t0 + qq;
        if (t >= T) continue;
        if (kSplit) {
          float* nr = num + (ksl * part_rows + row_off(b, t, h, T, H)) * P;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const int p = p0 + col0 + 8 * n + 2 * tq;
            if (p < P) nr[p] = accy[u][n][2 * half];
            if (p + 1 < P) nr[p + 1] = accy[u][n][2 * half + 1];
          }
          continue;
        }
        const float dn = sDen[qq];
        bf16* yr = y + row_off(b, t, h, T, H) * P;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int p = p0 + col0 + 8 * n + 2 * tq;
          const float y0 = accy[u][n][2 * half] / dn;
          const float y1 = accy[u][n][2 * half + 1] / dn;
          if (P % 2 == 0 && p + 1 < P) {
            *reinterpret_cast<__nv_bfloat162*>(yr + p) =
                __floats2bfloat162_rn(y0, y1);
          } else {
            if (p < P) yr[p] = __float2bfloat16(y0);
            if (p + 1 < P) yr[p + 1] = __float2bfloat16(y1);
          }
        }
      }
    }
  }
}

// ----------------------------------------------------------- f32: FFMA ----
//
// One block of 256 threads per (32-column slice of P, head, batch row) owns
// C[:, p0:p0+32] in shared memory across the loop over chunks and
// recomputes the normaliser n (K), which does not depend on P.  Per chunk
// the K contraction is tiled by 32: each (q, k) tile pair accumulates Q K^T
// (64 x 64, 16 per thread), q . C (64 x 32, 8 per thread) and q . n (64) in
// registers; then W, y, and with the k tiles read once more the update of C
// and n.  Every product is an f32 FMA out of shared memory.

// rows [0, 64) x columns [k0, k0 + 32) of a (B, T, H, K) tensor at batch b,
// head h, steps c0.. into dst (64 x kLdT), times mul[row] when given; zero
// past T and past column kend.
__device__ __forceinline__ void load_ktile(const float* __restrict__ src,
                                           int b, int h, int c0, int k0,
                                           int T_, int H, int K, int kend,
                                           float scale, const float* mul,
                                           float* dst) {
  for (int i = threadIdx.x; i < kQ * kKt; i += kThreads32) {
    const int r = i / kKt, kk = i - r * kKt, t = c0 + r, kc = k0 + kk;
    float x = 0.0f;
    if (t < T_ && kc < kend)
      x = src[row_off(b, t, h, T_, H) * K + kc] * scale;
    if (mul) x *= mul[r];
    dst[r * kLdT + kk] = x;
  }
}

inline size_t ffma_smem(int K) {
  return sizeof(float) * ((size_t)K * kPt32 + K + 2 * kQ * kLdT +
                          kQ * kPt32 + kQ * kLdW + 5 * kQ);
}

// kSplit: as mlstm_recur_bf16's; the slice forms its own scores over its
// columns, and its parts go to num / den.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads32, 1)
mlstm_ffma(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ a,
           const float* __restrict__ ig, float* __restrict__ y, int T_, int H,
           int K, int P, float scale, int KS, float* __restrict__ num,
           float* __restrict__ den) {
  extern __shared__ float smem32[];
  const int S = kSplit ? (K + KS - 1) / KS : 1;
  const int ksl = kSplit ? (int)blockIdx.z % S : 0;
  const int kb = ksl * KS, kend = kSplit ? min(K, kb + KS) : K;
  const int Kw = kend - kb;
  float* sC = smem32;                  // Kw x kPt32, the carried state slice
  float* sN = sC + Kw * kPt32;         // Kw, the carried normaliser
  float* sQt = sN + Kw;                // kQ x kLdT
  float* sKt = sQt + kQ * kLdT;        // kQ x kLdT
  float* sV = sKt + kQ * kLdT;         // kQ x kPt32
  float* sW = sV + kQ * kPt32;         // kQ x kLdW
  float* sCum = sW + kQ * kLdW;        // kQ: a, then cum
  float* sI = sCum + kQ;               // kQ: input gate
  float* sDst = sI + kQ;               // kQ: exp(cum)
  float* sDte = sDst + kQ;             // kQ: exp(cum_last - cum) * i
  float* sNrm = sDte + kQ;             // kQ: q . n, then max(|nrm|, 1)

  const int p0 = blockIdx.x * kPt32, h = blockIdx.y;
  const int b = kSplit ? (int)blockIdx.z / S : (int)blockIdx.z;
  const size_t part_rows = kSplit ? (size_t)(gridDim.z / S) * T_ * H : 0;
  const int tid = threadIdx.x;
  // thread layouts: Q K^T entries (tid / 64 + 4 j, tid % 64), j < 16;
  // (q, p) entries (tid / 32 + 8 j, tid % 32), j < 8
  const int s_own = tid & 63, q_base = tid >> 6;
  const int p_own = tid & 31, qp_base = tid >> 5;
  for (int i = tid; i < Kw * kPt32; i += kThreads32) sC[i] = 0.0f;
  for (int i = tid; i < Kw; i += kThreads32) sN[i] = 0.0f;

  for (int c0 = 0; c0 < T_; c0 += kQ) {
    __syncthreads();                   // the last chunk's reads are done
    for (int i = tid; i < kQ * kPt32; i += kThreads32) {
      const int r = i / kPt32, p = i - r * kPt32, t = c0 + r;
      sV[i] = (t < T_ && p0 + p < P) ? v[row_off(b, t, h, T_, H) * P + p0 + p]
                                     : 0.0f;
    }
    if (tid < kQ) {
      const int t = c0 + tid;
      sCum[tid] = t < T_ ? a[row_off(b, t, h, T_, H)] : 1.0f;
      sI[tid] = t < T_ ? ig[row_off(b, t, h, T_, H)] : 0.0f;
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
    for (int k0 = 0; k0 < Kw; k0 += kKt) {
      load_ktile(q, b, h, c0, kb + k0, T_, H, K, kend, scale, nullptr, sQt);
      load_ktile(k, b, h, c0, kb + k0, T_, H, K, kend, 1.0f, nullptr, sKt);
      __syncthreads();
      const int nk = min(kKt, Kw - k0);
      for (int kk = 0; kk < nk; ++kk) {
        const float kv = sKt[s_own * kLdT + kk];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          qk[j] = fmaf(sQt[(q_base + 4 * j) * kLdT + kk], kv, qk[j]);
        const float cv = sC[(k0 + kk) * kPt32 + p_own];
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
        if (kSplit) {      // this slice's part, unnormalised
          const int t = c0 + qq;
          if (lane == 0 && blockIdx.x == 0 && t < T_)
            den[ksl * part_rows + row_off(b, t, h, T_, H)] =
                s + sDst[qq] * sNrm[qq];
        } else if (lane == 0) {
          sNrm[qq] = fmaxf(fabsf(s + sDst[qq] * sNrm[qq]), 1.0f);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qq = qp_base + 8 * j, t = c0 + qq;
      const float* wq = sW + qq * kLdW;
      float acc = 0.0f;
      for (int s = 0; s <= qq; ++s)
        acc = fmaf(wq[s], sV[s * kPt32 + p_own], acc);
      acc = fmaf(sDst[qq], qc[j], acc);
      if (t < T_ && p0 + p_own < P) {
        if (kSplit)
          num[(ksl * part_rows + row_off(b, t, h, T_, H)) * P + p0 + p_own] =
              acc;
        else
          y[row_off(b, t, h, T_, H) * P + p0 + p_own] = acc / sNrm[qq];
      }
    }

    const float decay = expf(total);
    for (int k0 = 0; k0 < Kw; k0 += kKt) {
      // no barrier needed before this load: sKt was last read before the
      // barrier that ended the contraction loop
      load_ktile(k, b, h, c0, kb + k0, T_, H, K, kend, 1.0f, sDte, sKt);
      __syncthreads();
      const int nk = min(kKt, Kw - k0);
#pragma unroll
      for (int j = 0; j < kKt / 8; ++j) {
        const int kk = qp_base + 8 * j;
        if (kk < nk) {
          float acc = 0.0f;
          for (int s = 0; s < kQ; ++s)
            acc = fmaf(sKt[s * kLdT + kk], sV[s * kPt32 + p_own], acc);
          float* c = sC + (k0 + kk) * kPt32 + p_own;
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

// ------------------------------------------------------------ combine ----
//
// y = (sum_s num_s) / max(|sum_s den_s|, 1), the S slices' parts added in
// slice order in f32, an element of y a thread.

constexpr int kCombineThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
mlstm_combine(const float* __restrict__ num, const float* __restrict__ den,
              T* __restrict__ y, int S, size_t rows, int P) {
  const size_t i = (size_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= rows * P) return;
  const size_t r = i / P;
  float n = num[i], d = den[r];
  for (int s = 1; s < S; ++s) {
    n += num[(size_t)s * rows * P + i];
    d += den[(size_t)s * rows + r];
  }
  store(y + i, n / fmaxf(fabsf(d), 1.0f));
}

// K slices of KS columns: KS <= kMaxK, and a multiple of kKs when it cuts K
inline bool shape_ok(int B, int T, int H, int K, int P, int KS) {
  return B >= 1 && T >= 1 && H >= 1 && K >= 1 && P >= 1 && KS >= 1 &&
         KS <= kMaxK && (KS >= K || KS % kKs == 0);
}

template <typename T>
cudaError_t launch_combine(const float* num, const float* den, void* y, int S,
                           int B, int T_, int H, int P, cudaStream_t s) {
  const size_t rows = (size_t)B * T_ * H, n = rows * P;
  mlstm_combine<T><<<(unsigned)((n + kCombineThreads - 1) / kCombineThreads),
                     kCombineThreads, 0, s>>>(num, den, (T*)y, S, rows, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, after the library is loaded: let the kernels take all
// the dynamic shared memory a block may, and write the smallest limit to
// max_dyn.
int mlstm_init(int* max_dyn) {
  *max_dyn = 1 << 30;
  cudaError_t e = allow_smem(mlstm_ffma<false>, max_dyn);
  if (e == cudaSuccess) e = allow_smem(mlstm_ffma<true>, max_dyn);
  if (e == cudaSuccess) e = allow_smem(mlstm_scores_bf16, max_dyn);
  if (e == cudaSuccess) e = allow_smem(mlstm_recur_bf16<64, false>, max_dyn);
  if (e == cudaSuccess) e = allow_smem(mlstm_recur_bf16<32, false>, max_dyn);
  if (e == cudaSuccess) e = allow_smem(mlstm_recur_bf16<64, true>, max_dyn);
  if (e == cudaSuccess) e = allow_smem(mlstm_recur_bf16<32, true>, max_dyn);
  return (int)e;
}

// The chunk length, and the bytes of one (batch, chunk, head) record of
// the bf16 path's work buffer.
int mlstm_chunk() { return kQ; }
int mlstm_record_bytes() { return kRecBytes; }

// Largest dynamic shared memory a block of the path takes at a K slice of
// K columns (the bf16 recurrence with a P slice of pt = 64 or 32 columns),
// or -1 for a shape the kernels do not take (K > 1024, or another pt).
int mlstm_smem_bytes(int bf16, int K, int pt) {
  if (!shape_ok(1, 1, 1, K, 1, K)) return -1;
  if (!bf16) return (int)ffma_smem(K);
  if (pt != 64 && pt != 32) return -1;
  const size_t rec = recur_smem(K, pt);
  return (int)(rec > kScoreSmem ? rec : kScoreSmem);
}

// K is cut into S = ceil(K / KS) slices of KS columns (KS >= K: one, the
// path as it was); with S > 1 `num` and `den` take the slices' parts,
// (S * B * T * H * P) and (S * B * T * H) floats.
// f32: one launch, two when S > 1; `work` and `pt` are not read.
int mlstm_f32(const void* q, const void* k, const void* v, const void* a,
              const void* i, void* y, int B, int T, int H, int K, int P,
              float scale, void* work, int pt, int KS, void* num, void* den,
              void* stream) {
  (void)work;
  (void)pt;
  if (!shape_ok(B, T, H, K, P, KS)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (KS >= K) {
    const dim3 grid((P + kPt32 - 1) / kPt32, H, B);
    mlstm_ffma<false><<<grid, kThreads32, ffma_smem(K), s>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)a,
        (const float*)i, (float*)y, T, H, K, P, scale, K, nullptr, nullptr);
    return (int)cudaGetLastError();
  }
  if (!num || !den) return (int)cudaErrorInvalidValue;
  const int S = (K + KS - 1) / KS;
  const dim3 grid((P + kPt32 - 1) / kPt32, H, B * S);
  mlstm_ffma<true><<<grid, kThreads32, ffma_smem(KS), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)a,
      (const float*)i, (float*)y, T, H, K, P, scale, KS, (float*)num,
      (float*)den);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_combine<float>((const float*)num, (const float*)den, y,
                                    S, B, T, H, P, s);
}

// bf16: two launches on `stream` (three when S > 1), the scores over the
// whole K into `work` ((B * nc * H * mlstm_record_bytes()) bytes, nc =
// ceil(T / 64), 16-byte aligned), then the recurrence with a P slice of pt
// (64 or 32) columns (and a K slice a block when S > 1), then the combine.
int mlstm_bf16(const void* q, const void* k, const void* v, const void* a,
               const void* i, void* y, int B, int T, int H, int K, int P,
               float scale, void* work, int pt, int KS, void* num, void* den,
               void* stream) {
  if (!shape_ok(B, T, H, K, P, KS) || (pt != 64 && pt != 32))
    return (int)cudaErrorInvalidValue;
  const bool split = KS < K;
  if (split && (!num || !den)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = (T + kQ - 1) / kQ;
  mlstm_scores_bf16<<<dim3(nc, H, B), kScoreThreads, kScoreSmem, s>>>(
      (const bf16*)q, (const bf16*)k, (const float*)a, (const float*)i,
      (unsigned char*)work, T, H, K, nc, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int S = split ? (K + KS - 1) / KS : 1;
  const int width = split ? KS : K;
  const dim3 grid((P + pt - 1) / pt, H, B * S);
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
  const unsigned char* rec = (const unsigned char*)work;
  float *nm = (float*)num, *dn = (float*)den;
#define RECUR(PT, SPLIT)                                                    \
  mlstm_recur_bf16<PT, SPLIT><<<grid, kRecurThreads, recur_smem(width, PT), \
                                s>>>(qq, kk, vv, rec, (bf16*)y, T, H, K, P,  \
                                     nc, scale, width, nm, dn)
  if (pt == 64 && !split) RECUR(64, false);
  else if (!split) RECUR(32, false);
  else if (pt == 64) RECUR(64, true);
  else RECUR(32, true);
#undef RECUR
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return (int)e;
  return (int)launch_combine<bf16>(nm, dn, y, S, B, T, H, P, s);
}

}  // extern "C"
