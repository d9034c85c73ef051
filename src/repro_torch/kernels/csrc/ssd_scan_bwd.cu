// Backward of the Mamba-2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a): from x (bh, s, dh), dt (bh, s), B and C (bh / h, s, n), A (bh,),
// the forward's entering state of every chunk (bh, chunks, n, dh) and the
// output's gradient dy (bh, s, dh), it gives dx (x's type), ddt (f32), dB
// and dC (B's type, summed over the h rows that share them) and dA (f32).
//
// Replaces: no TPU kernel.  The JAX package trains the SSD through
// src/repro/models/layers.py::ssd_parallel, which XLA differentiates; the
// port's forward is a hand-written kernel, so its gradient is one too.
//
// Within a chunk of L rows (cum = inclusive running sum of A dt, total =
// cum_{L-1}, E_ij = exp(cum_i - cum_j) for j <= i and 0 above, w_j =
// exp(total - cum_j) dt_j) the forward is
//   y_i   = sum_j (C_i . B_j) E_ij dt_j x_j + exp(cum_i) C_i h_in,
//   h_out = exp(total) h_in + sum_j w_j B_j x_j^T,
// so the state gradient runs backwards through the chunks,
//   dh_in = exp(total) dh_out + sum_i exp(cum_i) C_i^T dy_i,
// with dh_out = 0 for the last chunk, and with M_ij = dy_i . x_j, G_ij =
// (C_i . B_j) E_ij, W_ij = M_ij E_ij dt_j, P_ij = G_ij M_ij dt_j:
//   dx_j  = dt_j sum_i G_ij dy_i + w_j dh_out^T B_j,
//   dB_j  = sum_i W_ij C_i + w_j dh_out x_j,
//   dC_i  = sum_j W_ij B_j + exp(cum_i) h_in dy_i,
//   dcum_i = sum_j P_ij - sum_j P_ji + exp(cum_i) dy_i . (C_i h_in) - w_i R_i,
//            R_j = x_j . (dh_out^T B_j),
//   dtotal = sum_j w_j R_j + exp(total) <h_in, dh_out>, added to the last
//            entry of dcum,
//   ddt_t = sum_i G_it M_it + exp(total - cum_t) R_t + A rev_t,
//   dA   += sum_t dt_t rev_t,   rev_t = sum_{i >= t} dcum_i.
// The exponent is masked before exp, as in the forward and the reference
// (src/repro/models/layers.py's ssd_parallel): for j > i it is positive and
// would overflow, and 0 x inf is a NaN gradient.
//
// Bound on an H100 SXM (3.35 TB/s HBM3; 989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s FP32 on the CUDA cores): at mamba2-130m's training
// shape (bh 192 = 8 x 24 heads sharing one group, s 256, dh 64, n 128,
// chunk 128) the function reads x, dy, B, C, dt and the entering states
// (12.6 MB of f32 states, 12.6 MB of bf16 x and dy) and writes dx, dB, dC,
// ddt, dA, 34 MB in all (10 us), against 7.3 GFLOP of products with the
// causal halves (7 us on the tensor cores): bound by bytes.
//
// What this design does about it.  Two bodies, as the forward's.
//   * One launch, every chunk in parallel, as the forward: each CTA takes one
//     (row, chunk) -- the SIMT body one (row, 16 head-dim columns, chunk) --
//     from an integer ticket, drawn in *reverse* chunk order, so a CTA only
//     ever waits on the next chunk's, which is already running or done.  It
//     first computes what needs no other chunk (the chunk's own state
//     gradient sum_i exp(cum_i) C_i^T dy_i; in the wgmma body also the row
//     side below), then waits for dh_out from the next chunk through a
//     two-slot f32 ring in the L2, publishes dh_in at once, and only then
//     forms the terms that need dh_out: the chain costs one hop a chunk.
//     The flags are per warp (a warp owns the same state elements in every
//     chunk), and the launch leaves them and the counter zeroed (the
//     wrapper keeps its own buffer, kernels/_workspace.py).
//   * bf16 at (dh, n) = (64, 128), chunks 64 and 128 -- ssd_bwd_sm90_kernel,
//     the tensor cores.  One warpgroup per 64 rows of the chunk, x, dy, B and
//     C in by TMA on one mbarrier (3-D maps with 128-byte swizzle; a ragged
//     last chunk is zero-filled past s), h_in and dh_out written by the
//     threads as swizzled bf16 tiles.  Every product is wgmma.m64nNk16 with
//     f32 accumulators, each operand read in the layout it has:
//       - row side (the warpgroup's rows as i): C h_in for Q_i; C B^T and
//         dy x^T, giving W = M o E o dt and sum_j P_ij = sum_j (C B^T)_ij
//         W_ij in registers; dC = exp(cum_i) dy h_in^T + W B, the first term
//         accumulated and row-scaled, then W B added onto it (W from
//         registers, B MN-major through the transpose bit);
//       - the chunk's own state gradient (C o exp(cum))^T dy, A from
//         registers read out of the swizzled C tile, as the forward's S;
//       - column side (the warpgroup's rows as j): the transposed scores
//         B C^T and x dy^T are computed directly, so G^T and W^T come out
//         as A fragments and sum_i G_ij M_ij is a row sum (no transpose,
//         no cross-warp column sums; flash attention's backward does the
//         same with S^T); dx = dt o (exp(total - cum) o (B dh_out) + G^T
//         dy), R_j read off B dh_out before its scaling; dB = w o (x
//         dh_out^T) + W^T C.  G^T and W^T come from two passes (x dy^T is
//         formed twice), so that only one of them is held in registers.
//     Each accumulator is released before the next is formed; 0 spills.
//     The f32 operands -- W, G^T, W^T, C o exp(cum), h_in and dh_out -- go
//     in as hi + lo bf16 pairs, each with the same other operand, as the
//     forward feeds its own: rounded once, each alone moves some gradient
//     by a bf16 rounding (1.3-1.6e-3 of its largest value); with all six
//     split the gradients agree with the f32 vjp to 5e-6
//     (tests/test_torch_ssd_scan.py emulates both).
//   * f32, and bf16 at other shapes -- ssd_bwd_kernel, the CUDA cores: the
//     quadratic terms walk tiles of 32 rows, as the forward's SIMT body: for
//     row tiles (dC, sum_j P_ij) and then for column tiles (dx, dB, sum_i
//     P_ij, the direct dt term), each tile of C B^T and M recomputed into
//     shared memory with 4 x 4 register blocks; FP32 FMAs throughout.
//   * No float atomics.  dB and dC are shared by the rows of a group (and,
//     in the SIMT body, by the column blocks of a row), ddt by the column
//     blocks, dA by the chunks: each CTA writes its own f32 partials, and a
//     second kernel sums them in a fixed order, so two calls give the same
//     bits.  The decay exponents' gradient is ssd_common.cuh's
//     decay_gradient in both bodies.
//   * Rows past s (a ragged last chunk) are staged as zeros, add nothing, and
//     are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "ssd_common.cuh"

namespace {

using namespace ssd;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kVectors = 8;   // per-row f32 vectors of a chunk in shared memory

template <typename T>
size_t smem_bytes(int n, int L) {
  return (size_t)(2 * n + 2 * kCols) * L * sizeof(T) +
         (size_t)4 * (2 * n * kCols + kCols * L + 3 * kRows * (L + kGPad) + kVectors * L);
}

// Sum of v over the 16 lanes of a half-warp (a fixed order).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 4 x 4 block of C_i . B_j (rows i = ib.., columns j = jb..) over the n
// states, and of dy_i . x_j over the CTA's columns; zeros where !live (a
// block wholly above the diagonal).
template <typename T>
__device__ __forceinline__ void score_blocks(const T* cs, const T* bs, const T* dys, const T* xs,
                                             int n, int L, int ib, int jb, bool live,
                                             float cb[4][4], float m[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) cb[r][q] = m[r][q] = 0.0f;
  if (!live) return;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    float cv[4], bv[4];
    load4(cs + k * L + ib, cv);
    load4(bs + k * L + jb, bv);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) cb[r][q] = fmaf(cv[r], bv[q], cb[r][q]);
  }
#pragma unroll
  for (int d = 0; d < kCols; d += 4) {
    float dv[4][4], xv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      load4(dys + (ib + r) * kCols + d, dv[r]);
      load4(xs + (jb + r) * kCols + d, xv[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) m[r][q] = fmaf(dv[r][u], xv[q][u], m[r][q]);
  }
}

// x, dy: (bh, s, dh); dt: (bh, s) f32; B, C: (bh / heads, s, n); A: (bh,)
// f32; entering: (bh, chunks, n, dh) f32; dx like x; part_b, part_c: (bh *
// dh / kCols, s, n) f32; part_dt: (bh * dh / kCols, s) f32; part_a: (bh *
// dh / kCols, chunks) f32; ring: (bh * dh / kCols, 2, n, kCols) f32; sync:
// the ticket counter, then kThreads / 32 flags per chain, all 0.
// gridDim = bh * dh / kCols * chunks, blockDim = kThreads, L % kRows == 0,
// n % 8 == 0, dh % kCols == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ B,
               const T* __restrict__ C, const float* __restrict__ A,
               const float* __restrict__ entering, const T* __restrict__ dy,
               T* __restrict__ dx, float* __restrict__ part_b, float* __restrict__ part_c,
               float* __restrict__ part_dt, float* __restrict__ part_a, float* ring, int* sync,
               int bh, int s, int dh, int n, int L, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  __shared__ float warp_sums[kThreads / 32];
  const int GS = L + kGPad;                      // tile row stride
  float* hs = reinterpret_cast<float*>(smem);    // [n][kCols] h_in
  float* dhs = hs + n * kCols;                   // [n][kCols] the local dh, then dh_out
  float* dxs = dhs + n * kCols;                  // [L][kCols] w_j dh_out^T B_j
  float* t0 = dxs + L * kCols;                   // three [kRows][GS] tiles
  float* t1 = t0 + kRows * GS;
  float* t2 = t1 + kRows * GS;
  float* dts = t2 + kRows * GS;                  // [L] dt
  float* cum = dts + L;                          // [L] running sum of A dt
  float* wts = cum + L;                          // [L] exp(total - cum) dt
  float* ecum = wts + L;                         // [L] exp(cum)
  float* qv = ecum + L;                          // [L] exp(cum_i) dy_i . C_i h_in
  float* rv = qv + L;                            // [L] R_j
  float* rowp = rv + L;                          // [L] sum_j P_ij
  float* colv = rowp + L;                        // [L] sum_i G_ij M_ij
  T* bs = reinterpret_cast<T*>(colv + L);        // [n][L] B^T
  T* cs = bs + n * L;                            // [n][L] C^T
  T* xs = cs + n * L;                            // [L][kCols] x columns
  T* dys = xs + L * kCols;                       // [L][kCols] dy columns

  const int tid = threadIdx.x;
  const int blocks = dh / kCols;
  const int chains = bh * blocks;
  const int chunks = (s + L - 1) / L;
  const int t = draw_ticket(sync, &ticket, chains * chunks);
  const int chunk = chunks - 1 - t / chains;     // reverse chunk-major tickets
  const int chain = t % chains;
  const int row = chain / blocks;
  const int d0 = (chain % blocks) * kCols;
  const int c0 = chunk * L;
  const int lv = min(L, s - c0);                 // valid rows of this chunk
  const float a = A[row];
  const size_t xoff = ((size_t)row * s + c0) * dh + d0;
  const float* dtg = dt + (size_t)row * s + c0;
  const T* bg = B + ((size_t)(row / heads) * s + c0) * n;
  const T* cg = C + ((size_t)(row / heads) * s + c0) * n;
  const float* hg = entering + ((size_t)row * chunks + chunk) * n * dh + d0;

  // -- stage the chunk ------------------------------------------------------
  for (int j = tid; j < L; j += kThreads) dts[j] = j < lv ? dtg[j] : 0.0f;
  stage_transposed<T>(bs, bg, L, n, lv);
  stage_transposed<T>(cs, cg, L, n, lv);
  {
    constexpr int V = kVecBytes / sizeof(T);
    constexpr int PER_ROW = kCols / V;
    for (int i = tid; i < L * PER_ROW; i += kThreads) {
      const int r = i / PER_ROW;
      const int c = (i % PER_ROW) * V;
      uint4 px = make_uint4(0u, 0u, 0u, 0u), pd = px;
      if (r < lv) {
        px = *reinterpret_cast<const uint4*>(x + xoff + (size_t)r * dh + c);
        pd = *reinterpret_cast<const uint4*>(dy + xoff + (size_t)r * dh + c);
      }
      *reinterpret_cast<uint4*>(xs + r * kCols + c) = px;
      *reinterpret_cast<uint4*>(dys + r * kCols + c) = pd;
    }
  }
  for (int i = tid; i < n * (kCols / 4); i += kThreads) {
    const int k = i / (kCols / 4);
    const int c = (i % (kCols / 4)) * 4;
    *reinterpret_cast<float4*>(hs + k * kCols + c) =
        *reinterpret_cast<const float4*>(hg + (size_t)k * dh + c);
  }
  __syncthreads();
  running_sum(dts, cum, a, L);
  __syncthreads();
  const float total = cum[L - 1];
  for (int j = tid; j < L; j += kThreads) {
    wts[j] = expf(total - cum[j]) * dts[j];
    ecum[j] = expf(cum[j]);
  }
  __syncthreads();

  // -- the chunk's own state gradient sum_i exp(cum_i) C_i^T dy_i -----------
  const int lv4 = (lv + 3) & ~3;                 // rows past lv are zero
  for (int e = tid; e < (n / 4) * (kCols / 2); e += kThreads) {
    const int kb = (e / (kCols / 2)) * 4;
    const int dp = (e % (kCols / 2)) * 2;
    float acc[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.0f;
    for (int i = 0; i < lv4; i += 4) {
      float ev[4];
      load4(ecum + i, ev);
      float2 dv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) dv[q] = load2(dys + (i + q) * kCols + dp);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float cv[4];
        load4(cs + (kb + r) * L + i, cv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float c = cv[q] * ev[q];
          acc[r][0] = fmaf(c, dv[q].x, acc[r][0]);
          acc[r][1] = fmaf(c, dv[q].y, acc[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) store2(dhs + (kb + r) * kCols + dp, acc[r][0], acc[r][1]);
  }

  // -- the chain, in reverse: dh_out from the next chunk, dh_in to the one before
  int* flag = sync + 1 + chain * (kThreads / 32) + tid / 32;
  const float* slot_in = ring + ((size_t)chain * 2 + ((chunk + 1) & 1)) * n * kCols;
  float* slot_out = ring + ((size_t)chain * 2 + (chunk & 1)) * n * kCols;
  const bool first = chunk == chunks - 1;        // the chain starts at the last chunk
  const bool last = chunk == 0;
  __syncthreads();                               // the local dh is in dhs
  if (!first) wait_flag(flag, chunks - 1 - chunk);
  const float decay = expf(total);
  // every load of a hop in flight before its stores (slot_in and slot_out
  // may alias as far as the compiler knows)
  constexpr int kHop = 8;
  for (int e0 = tid; e0 < n * kCols; e0 += kHop * kThreads) {
    float h[kHop];
#pragma unroll
    for (int u = 0; u < kHop; ++u) {
      const int e = e0 + u * kThreads;
      h[u] = !first && e < n * kCols ? __ldcg(slot_in + e) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kHop; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= n * kCols) break;
      if (!last) __stcg(slot_out + e, fmaf(decay, h[u], dhs[e]));
      dhs[e] = h[u];
    }
  }
  publish_flag(flag, last ? 0 : chunks - chunk);
  __syncthreads();                               // dh_out is in dhs

  // -- per-row terms of h_in and dh_out --------------------------------------
  // <h_in, dh_out> over the CTA's columns, summed in a fixed order
  {
    float v = 0.0f;
    for (int e = tid; e < n * kCols; e += kThreads) v = fmaf(hs[e], dhs[e], v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) warp_sums[tid / 32] = v;
  }
  // 16 threads per row r, one column each: (C_r h_in) and (B_r^T dh_out)
  for (int r0 = 0; r0 < L; r0 += kThreads / kCols) {
    const int r = r0 + tid / kCols;
    const int d = tid % kCols;
    float z = 0.0f, bd = 0.0f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      z = fmaf(to_f32(cs[k * L + r]), hs[k * kCols + d], z);
      bd = fmaf(to_f32(bs[k * L + r]), dhs[k * kCols + d], bd);
    }
    dxs[r * kCols + d] = wts[r] * bd;
    const float q = sum16(z * to_f32(dys[r * kCols + d]));
    const float rr = sum16(bd * to_f32(xs[r * kCols + d]));
    if (d == 0) {
      qv[r] = ecum[r] * q;
      rv[r] = rr;
    }
  }
  __syncthreads();

  // -- row tiles: dC_i and sum_j P_ij -----------------------------------------
  float* dcg = part_c + ((size_t)chain * s + c0) * n;
  for (int i0 = 0; i0 < lv; i0 += kRows) {
    const int jn = i0 + kRows;                   // columns j < jn
    for (int e = tid; e < (kRows / 4) * (jn / 4); e += kThreads) {
      const int ti = e % (kRows / 4);
      const int ib = i0 + ti * 4;
      const int jb = (e / (kRows / 4)) * 4;
      float cb[4][4], m[4][4];
      score_blocks<T>(cs, bs, dys, xs, n, L, ib, jb, jb <= ib + 3, cb, m);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ib + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = jb + q;
          // mask before exp: j > i would give exp of a positive number
          const float w = j <= i ? m[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.0f;
          t0[(ti * 4 + r) * GS + j] = w;                       // W_ij
          t1[(ti * 4 + r) * GS + j] = j <= i ? cb[r][q] * w : 0.0f;   // P_ij
        }
      }
    }
    __syncthreads();
    if (tid < kRows) {
      float v = 0.0f;
      for (int j = 0; j < jn; ++j) v += t1[tid * GS + j];
      rowp[i0 + tid] = v;
    }
    // dC: 4 rows x 4 states per thread
    for (int e = tid; e < (kRows / 4) * (n / 4); e += kThreads) {
      const int ti = e % (kRows / 4);
      const int kb = (e / (kRows / 4)) * 4;
      const int ib = i0 + ti * 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      for (int j = 0; j < ib + 4; j += 4) {       // W_ij = 0 for j > i
        float wv[4][4], bv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) load4(t0 + (ti * 4 + r) * GS + j, wv[r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) load4(bs + (kb + q) * L + j, bv[q]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[r][q] = fmaf(wv[r][u], bv[q][u], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ib + r;
        if (i >= lv) continue;
        float hv[4];                              // (h_in dy_i) at states kb..kb+3
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v = 0.0f;
#pragma unroll
          for (int d = 0; d < kCols; ++d)
            v = fmaf(hs[(kb + q) * kCols + d], to_f32(dys[i * kCols + d]), v);
          hv[q] = fmaf(ecum[i], v, acc[r][q]);
        }
        *reinterpret_cast<float4*>(dcg + (size_t)i * n + kb) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
    }
    __syncthreads();
  }

  // -- column tiles: dx_j, dB_j, sum_i P_ij, sum_i G_ij M_ij --------------------
  float* dbg = part_b + ((size_t)chain * s + c0) * n;
  T* dxg = dx + xoff;
  for (int j0 = 0; j0 < lv; j0 += kRows) {
    // tiles indexed [j - j0][i], i in [j0, L)
    const int ni = (L - j0) / 4;
    for (int e = tid; e < (kRows / 4) * ni; e += kThreads) {
      const int tj = e % (kRows / 4);
      const int jb = j0 + tj * 4;
      const int ib = j0 + (e / (kRows / 4)) * 4;
      float cb[4][4], m[4][4];
      score_blocks<T>(cs, bs, dys, xs, n, L, ib, jb, ib + 3 >= jb, cb, m);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = jb + q;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ib + r;
          const bool on = j <= i;
          const float ex = on ? expf(cum[i] - cum[j]) : 0.0f;
          const float g = on ? cb[r][q] * ex : 0.0f;
          t0[(tj * 4 + q) * GS + i] = g;                           // G_ij
          t1[(tj * 4 + q) * GS + i] = on ? m[r][q] * ex * dts[j] : 0.0f;   // W_ij
          t2[(tj * 4 + q) * GS + i] = on ? g * m[r][q] : 0.0f;    // G_ij M_ij
        }
      }
    }
    __syncthreads();
    if (tid < kRows) {
      float v = 0.0f;
      for (int i = j0; i < L; ++i) v += t2[tid * GS + i];
      colv[j0 + tid] = v;
    }
    // dx: one (row, column pair) per thread and pass
    for (int e = tid; e < kRows * (kCols / 2); e += kThreads) {
      const int jj = e / (kCols / 2);
      const int dp = (e % (kCols / 2)) * 2;
      const int j = j0 + jj;
      float y0 = 0.0f, y1 = 0.0f;
      for (int i = j & ~3; i < L; i += 4) {      // G_ij = 0 for i < j
        float g[4];
        load4(t0 + jj * GS + i, g);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 dv = load2(dys + (i + q) * kCols + dp);
          y0 = fmaf(g[q], dv.x, y0);
          y1 = fmaf(g[q], dv.y, y1);
        }
      }
      if (j < lv)
        store2(dxg + (size_t)j * dh + dp, fmaf(dts[j], y0, dxs[j * kCols + dp]),
               fmaf(dts[j], y1, dxs[j * kCols + dp + 1]));
    }
    // dB: 4 rows x 4 states per thread
    for (int e = tid; e < (kRows / 4) * (n / 4); e += kThreads) {
      const int tj = e % (kRows / 4);
      const int kb = (e / (kRows / 4)) * 4;
      const int jb = j0 + tj * 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      for (int i = jb; i < L; i += 4) {           // W_ij = 0 for i < j
        float wv[4][4], cv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) load4(t1 + (tj * 4 + r) * GS + i, wv[r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) load4(cs + (kb + q) * L + i, cv[q]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[r][q] = fmaf(wv[r][u], cv[q][u], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = jb + r;
        if (j >= lv) continue;
        float bv[4];                              // w_j (dh_out x_j) at states kb..kb+3
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v = 0.0f;
#pragma unroll
          for (int d = 0; d < kCols; ++d)
            v = fmaf(dhs[(kb + q) * kCols + d], to_f32(xs[j * kCols + d]), v);
          bv[q] = fmaf(wts[j], v, acc[r][q]);
        }
        *reinterpret_cast<float4*>(dbg + (size_t)j * n + kb) = make_float4(bv[0], bv[1], bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  // -- the decay exponents: dcum, its reverse running sum, ddt and dA (warp 0)
  if (tid < 32) {
    float hdot = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) hdot += warp_sums[w];
    decay_gradient(rowp, colv, qv, rv, dts, cum, wts, lv, total, a, hdot,
                   part_dt + (size_t)chain * s + c0, part_a + (size_t)chain * chunks + chunk);
  }
}

// dB, dC (groups, s, n) and ddt (bh, s), dA (bh,) from the partials, each
// summed over its rows, column blocks (and chunks) in a fixed order.
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_kernel(const float* __restrict__ part_b, const float* __restrict__ part_c,
                      const float* __restrict__ part_dt, const float* __restrict__ part_a,
                      T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ ddt,
                      float* __restrict__ dA, int bh, int s, int n, int blocks, int heads,
                      int chunks) {
  const size_t plane = (size_t)s * n;
  const size_t nbc = (size_t)(bh / heads) * plane;
  const size_t ndt = (size_t)bh * s;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < nbc + ndt + bh;
       idx += stride) {
    if (idx < nbc) {                     // the chains of group g are g * heads * blocks + p
      const size_t g = idx / plane, off = idx % plane;
      float vb = 0.0f, vc = 0.0f;
      for (int p = 0; p < heads * blocks; ++p) {
        const size_t at = (g * heads * blocks + p) * plane + off;
        vb += part_b[at];
        vc += part_c[at];
      }
      store1(dB + idx, vb);
      store1(dC + idx, vc);
    } else if (idx < nbc + ndt) {
      const size_t i = idx - nbc;
      const size_t row = i / s, t = i % s;
      float v = 0.0f;
      for (int b = 0; b < blocks; ++b) v += part_dt[(row * blocks + b) * s + t];
      ddt[i] = v;
    } else {
      const size_t row = idx - nbc - ndt;
      float v = 0.0f;
      for (int b = 0; b < blocks; ++b)
        for (int c = 0; c < chunks; ++c) v += part_a[(row * blocks + b) * chunks + c];
      dA[row] = v;
    }
  }
}

// The reduction of the partials, over `blocks` partials per row.
template <typename T>
cudaError_t reduce_launch(const void* part_b, const void* part_c, const void* part_dt,
                          const void* part_a, void* dB, void* dC, void* ddt, void* dA, int bh,
                          int s, int n, int blocks, int heads, int chunks, cudaStream_t stream) {
  const size_t total = (size_t)(bh / heads) * s * n + (size_t)bh * s + bh;
  const int grid = (int)((total + 255) / 256 < 132 * 16 ? (total + 255) / 256 : 132 * 16);
  ssd_bwd_reduce_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(part_b), static_cast<const float*>(part_c),
      static_cast<const float*>(part_dt), static_cast<const float*>(part_a),
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(ddt),
      static_cast<float*>(dA), bh, s, n, blocks, heads, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t simt_launch(const void* x, const void* dt, const void* B, const void* C,
                        const void* A, const void* entering, const void* dy, void* dx,
                        void* ddt, void* dB, void* dC, void* dA, void* part_b, void* part_c,
                        void* part_dt, void* part_a, void* ring, void* sync, int bh, int s,
                        int dh, int n, int L, int heads, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n, L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int chunks = (s + L - 1) / L;
  const int blocks = dh / kCols;
  ssd_bwd_kernel<T><<<bh * blocks * chunks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(A),
      static_cast<const float*>(entering), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part_b), static_cast<float*>(part_c), static_cast<float*>(part_dt),
      static_cast<float*>(part_a), static_cast<float*>(ring), static_cast<int*>(sync), bh, s,
      dh, n, L, heads);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_launch<T>(part_b, part_c, part_dt, part_a, dB, dC, ddt, dA, bh, s, n, blocks,
                          heads, chunks, stream);
}

template <typename T>
cudaError_t simt_attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, ssd_bwd_kernel<T>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 wgmma body
// ---------------------------------------------------------------------------

// Dynamic shared memory beyond the tiles and the kSm90Vectors (L,) f32
// vectors: the 1 KiB alignment slack, the per-warp sums, the mbarrier and
// the ticket.
constexpr int kSm90Vectors = 9;
constexpr int kSm90SmemExtra = sm90::kAlign + 128;

template <int DH, int N, int L>
constexpr int sm90_smem_bytes() {
  return (2 * L * DH + 2 * L * N + 4 * N * DH) * 2 + kSm90Vectors * L * 4 + kSm90SmemExtra;
}

// Sum of v over the four lanes that hold one row of a wgmma fragment.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Scales the two fragment rows of a 64 x NC accumulator by f[0], f[1].
template <int NC>
__device__ __forceinline__ void scale_rows(float* acc, const float* f) {
#pragma unroll
  for (int jb = 0; jb < NC / 8; ++jb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * jb + 2 * h] *= f[h];
      acc[4 * jb + 2 * h + 1] *= f[h];
    }
}

// sum over the fragment's columns of acc o (the (L x DH) bf16 tile at
// `tile`), one value per fragment row, summed over the quad.
template <int DH, int L>
__device__ __forceinline__ void row_dots(const float* acc, const unsigned char* tile, int ra,
                                         int q2, float* out) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = 0.0f;
#pragma unroll
    for (int jb = 0; jb < DH / 8; ++jb) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(tile + swz(L, ra + 8 * h, jb * 8 + q2)));
      v = fmaf(acc[4 * jb + 2 * h], t.x, v);
      v = fmaf(acc[4 * jb + 2 * h + 1], t.y, v);
    }
    out[h] = quad_sum(v);
  }
}

// A 64 x L f32 score fragment as wgmma A fragments (K = L), bf16 hi + lo.
template <int L>
__device__ __forceinline__ void split_fragment(const float* sc, uint32_t (*hi)[4],
                                               uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
}

// Writes the fragment rows ra, ra + 8 (those < lv) of a 64 x NC f32
// accumulator into the row-major (., NC) f32 array at g.
template <int NC>
__device__ __forceinline__ void store_rows(float* g, const float* acc, int ra, int q2, int lv) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = ra + 8 * h;
    if (i >= lv) continue;
#pragma unroll
    for (int jb = 0; jb < NC / 8; ++jb)
      *reinterpret_cast<float2*>(g + (size_t)i * NC + jb * 8 + q2) =
          make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
  }
}

// x, dy: (bh, s, DH) through xmap, dymap; B, C: (bh / heads, s, N) through
// bmap, cmap; dt: (bh, s) f32; A: (bh,) f32; entering: (bh, ceil(s / L), N,
// DH) f32; dx: (bh, s, DH) bf16.  part_b, part_c: (bh, s, N) f32; part_dt:
// (bh, s) f32; part_a: (bh, ceil(s / L)) f32; ring: (bh, 2, N, DH) f32;
// sync: the ticket counter, then L / 16 flags per row (one per warp), all
// 0.  gridDim = bh * ceil(s / L), blockDim = 2 L (one warpgroup per 64 rows).
template <int DH, int N, int L>
__global__ void __launch_bounds__(256, 1)
ssd_bwd_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap dymap,
                    const __grid_constant__ CUtensorMap bmap,
                    const __grid_constant__ CUtensorMap cmap, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ entering,
                    __nv_bfloat16* __restrict__ dx, float* __restrict__ part_b,
                    float* __restrict__ part_c, float* __restrict__ part_dt,
                    float* __restrict__ part_a, float* ring, int* sync, int bh, int s,
                    int heads) {
  using namespace sm90;
  static_assert(DH % kAtom == 0 && N % kAtom == 0 && DH <= 128 && N <= 128,
                "whole swizzle boxes, wgmma N <= 128");
  static_assert(L == 64 || L == 128, "one or two warpgroups");
  constexpr int W = L / 64;                      // warpgroups
  constexpr int kXBytes = L * DH * 2;            // one of x, dy
  constexpr int kBBytes = L * N * 2;             // one of B, C
  constexpr int kHBytes = N * DH * 2;            // one of the hi, lo tiles of h_in, dh_out
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* xs = smem;                                  // [DH/64][L][64]
  unsigned char* dys = xs + kXBytes;                         // [DH/64][L][64]
  unsigned char* bs = dys + kXBytes;                         // [N/64][L][64]
  unsigned char* cs = bs + kBBytes;                          // [N/64][L][64]
  unsigned char* hhi = cs + kBBytes;                         // [DH/64][N][64] h_in
  unsigned char* hlo = hhi + kHBytes;
  unsigned char* ohi = hlo + kHBytes;                        // [DH/64][N][64] dh_out
  unsigned char* olo = ohi + kHBytes;
  float* dts = reinterpret_cast<float*>(olo + kHBytes);      // [L] dt
  float* cum = dts + L;                                      // [L] running sum of A dt
  float* wts = cum + L;                                      // [L] exp(total - cum) dt
  float* ecum = wts + L;                                     // [L] exp(cum)
  float* etot = ecum + L;                                    // [L] exp(total - cum)
  float* rowp = etot + L;                                    // [L] sum_j P_ij
  float* colv = rowp + L;                                    // [L] sum_i G_ij M_ij
  float* qv = colv + L;                                      // [L] exp(cum_i) dy_i . C_i h_in
  float* rv = qv + L;                                        // [L] R_j
  float* wsum = rv + L;                                      // [L / 16] <h_in, dh_out> per warp
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsum + 16);
  int* ticket = reinterpret_cast<int*>(bar + 1);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = t % 32;
  const int warp = tid / 32;
  const int chunks = (s + L - 1) / L;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  const int tk = draw_ticket(sync, ticket, bh * chunks);
  const int chunk = chunks - 1 - tk / bh;        // reverse chunk-major tickets
  const int row = tk % bh;
  const int c0 = chunk * L;
  const int lv = min(L, s - c0);
  const bool has_in = chunk > 0;                 // h_in = 0 in the first chunk
  const bool first = chunk == chunks - 1;        // the chain starts at the last chunk
  const bool last = chunk == 0;
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * kXBytes + 2 * kBBytes);
#pragma unroll
    for (int b = 0; b < DH / kAtom; ++b) {
      tma_load(xs + b * L * 128, &xmap, bar, b * kAtom, c0, row);
      tma_load(dys + b * L * 128, &dymap, bar, b * kAtom, c0, row);
    }
#pragma unroll
    for (int b = 0; b < N / kAtom; ++b) {
      tma_load(bs + b * L * 128, &bmap, bar, b * kAtom, c0, row / heads);
      tma_load(cs + b * L * 128, &cmap, bar, b * kAtom, c0, row / heads);
    }
  }
  for (int j = tid; j < L; j += blockDim.x) dts[j] = j < lv ? dt[(size_t)row * s + c0 + j] : 0.0f;
  // h_in, the forward's entering state of this chunk, as hi + lo bf16 tiles
  const float* hg = entering + ((size_t)row * chunks + chunk) * N * DH;
  if (has_in) {
    for (int e = tid * 4; e < N * DH; e += blockDim.x * 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(hg + e));
      const int k = e / DH, d = e % DH;          // d % 4 == 0: one 8-byte store each
      uint32_t hi0, lo0, hi1, lo1;
      split_bf16(v.x, v.y, hi0, lo0);
      split_bf16(v.z, v.w, hi1, lo1);
      *reinterpret_cast<uint2*>(hhi + swz(N, k, d)) = make_uint2(hi0, hi1);
      *reinterpret_cast<uint2*>(hlo + swz(N, k, d)) = make_uint2(lo0, lo1);
    }
  }
  __syncthreads();
  running_sum(dts, cum, A[row], L);
  __syncthreads();
  const float total = cum[L - 1];
  for (int j = tid; j < L; j += blockDim.x) {
    const float et = expf(total - cum[j]);
    etot[j] = et;
    wts[j] = et * dts[j];
    ecum[j] = expf(cum[j]);
  }
  fence_proxy_async();                           // h_in's tiles, for wgmma
  __syncthreads();
  mbar_wait(bar, 0);

  const uint32_t xs_a = smem_addr(xs), dys_a = smem_addr(dys), bs_a = smem_addr(bs),
                 cs_a = smem_addr(cs), hhi_a = smem_addr(hhi), hlo_a = smem_addr(hlo),
                 ohi_a = smem_addr(ohi), olo_a = smem_addr(olo);
  const int r0 = (t / 32) * 16 + lane / 4;       // fragment rows r0 and r0 + 8
  const int q2 = 2 * (lane % 4);                 // fragment columns q2, q2 + 1
  const int ra = wg * 64 + r0;                   // chunk rows ra and ra + 8
  // K-major descriptor of this warpgroup's 64 rows of an [./64][L][64]
  // tile at k16 step kk, and of a whole tile of `rows` rows
  auto rows_desc = [&](uint32_t base, int kk) {
    return make_desc(base + (kk / 4) * L * 128 + wg * 64 * 128 + (kk % 4) * 32, 16, 1024);
  };
  auto kmajor = [](uint32_t base, int rows, int kk) {
    return make_desc(base + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
  };
  // MN-major descriptor of a (k = rows, n = cols) [cols/64][rows][64] tile
  auto mnmajor = [](uint32_t base, int rows, int kk) {
    return make_desc(base + kk * 16 * 128, rows * 128, 1024);
  };

  // == row side: rows i = ra, ra + 8 ===========================================
  // -- Q_i = exp(cum_i) dy_i . (C_i h_in) -------------------------------------
  {
    float q[2] = {0.0f, 0.0f};
    if (has_in) {
      float z[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) z[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t da = rows_desc(cs_a, kk);
        Wgmma<DH, kMNMajor>::mma(z, da, mnmajor(hhi_a, N, kk));
        Wgmma<DH, kMNMajor>::mma(z, da, mnmajor(hlo_a, N, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      row_dots<DH, L>(z, dys, ra, q2, q);
    }
    if (lane % 4 == 0) {
      qv[ra] = ecum[ra] * q[0];
      qv[ra + 8] = ecum[ra + 8] * q[1];
    }
  }
  // -- scores C B^T and M = dy x^T; W = M o E o dt, sum_j P_ij ------------------
  uint32_t whi[L / 16][4], wlo[L / 16][4];
  {
    float sc[L / 2], m[L / 2];
#pragma unroll
    for (int i = 0; i < L / 2; ++i) sc[i] = m[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      Wgmma<L, kKMajor>::mma(sc, rows_desc(cs_a, kk), kmajor(bs_a, L, kk));
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<L, kKMajor>::mma(m, rows_desc(dys_a, kk), kmajor(xs_a, L, kk));
    wgmma_commit();
    wgmma_wait<0>();
    // columns outermost: each column's cum and dt are read once and die
    const float ci[2] = {cum[ra], cum[ra + 8]};
    float rp[2] = {0.0f, 0.0f};
#pragma unroll
    for (int jb = 0; jb < L / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = jb * 8 + q2 + e;
        const float cj = cum[j], dj = dts[j];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = 4 * jb + 2 * h + e;
          // mask before exp: j > i would give exp of a positive number
          const float w = j <= ra + 8 * h ? m[u] * expf(ci[h] - cj) * dj : 0.0f;   // W_ij
          rp[h] = fmaf(sc[u], w, rp[h]);                                    // P_ij
          m[u] = w;
        }
      }
    rp[0] = quad_sum(rp[0]);
    rp[1] = quad_sum(rp[1]);
    if (lane % 4 == 0) {
      rowp[ra] = rp[0];
      rowp[ra + 8] = rp[1];
    }
    split_fragment<L>(m, whi, wlo);
  }
  // -- dC_i = exp(cum_i) dy_i h_in^T + sum_j W_ij B_j ---------------------------
  {
    float c[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) c[i] = 0.0f;
    if (has_in) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t da = rows_desc(dys_a, kk);
        Wgmma<N, kKMajor>::mma(c, da, kmajor(hhi_a, N, kk));
        Wgmma<N, kKMajor>::mma(c, da, kmajor(hlo_a, N, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      const float f[2] = {ecum[ra], ecum[ra + 8]};
      scale_rows<N>(c, f);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const uint64_t db = mnmajor(bs_a, L, kk);
      WgmmaRS<N>::mma(c, whi[kk], db);
      WgmmaRS<N>::mma(c, wlo[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    store_rows<N>(part_c + ((size_t)row * s + c0) * N, c, ra, q2, lv);
  }

  // == the chain ================================================================
  // -- the chunk's own state gradient sum_i exp(cum_i) C_i^T dy_i ---------------
  //    n rows in m-tiles of 64, the warpgroups share them
  constexpr int kMTiles = (N / 64 + W - 1) / W;  // m-tiles per warpgroup
  float sacc[kMTiles][DH / 2];
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
    const int mt = wg + mi * W;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) sacc[mi][i] = 0.0f;
    if (mt >= N / 64) continue;
    uint32_t ahi[L / 16][4], alo[L / 16][4];
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = mt * 64 + r0 + 8 * (i & 1);
        const int j = kk * 16 + q2 + 8 * (i >> 1);
        const float v0 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                             cs + swz(L, j, k))) * ecum[j];
        const float v1 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                             cs + swz(L, j + 1, k))) * ecum[j + 1];
        split_bf16(v0, v1, ahi[kk][i], alo[kk][i]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const uint64_t db = mnmajor(dys_a, L, kk);
      WgmmaRS<DH>::mma(sacc[mi], ahi[kk], db);
      WgmmaRS<DH>::mma(sacc[mi], alo[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  // -- dh_out from the next chunk, dh_in = exp(total) dh_out + the own one to
  //    the chunk before; every load in flight before any store (the slots
  //    may alias as far as the compiler knows)
  {
    int* flag = sync + 1 + row * (L / 16) + warp;
    const float* slot_in = ring + ((size_t)row * 2 + ((chunk + 1) & 1)) * N * DH;
    float* slot_out = ring + ((size_t)row * 2 + (chunk & 1)) * N * DH;
    if (!first) wait_flag(flag, chunks - 1 - chunk);
    const float decay = expf(total);
    float2 hout[kMTiles][DH / 8][2];
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
      for (int jb = 0; jb < DH / 8; ++jb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t e = (size_t)((wg + mi * W) * 64 + r0 + 8 * h) * DH + jb * 8 + q2;
          hout[mi][jb][h] = !first && wg + mi * W < N / 64
                                ? __ldcg(reinterpret_cast<const float2*>(slot_in + e))
                                : make_float2(0.0f, 0.0f);
        }
    if (!last) {
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
        if (wg + mi * W >= N / 64) continue;
#pragma unroll
        for (int jb = 0; jb < DH / 8; ++jb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t e = (size_t)((wg + mi * W) * 64 + r0 + 8 * h) * DH + jb * 8 + q2;
            __stcg(reinterpret_cast<float2*>(slot_out + e),
                   make_float2(fmaf(decay, hout[mi][jb][h].x, sacc[mi][4 * jb + 2 * h]),
                               fmaf(decay, hout[mi][jb][h].y, sacc[mi][4 * jb + 2 * h + 1])));
          }
      }
    }
    publish_flag(flag, last ? 0 : chunks - chunk);
    // dh_out into shared memory as hi + lo bf16 tiles, and <h_in, dh_out>
    float hd = 0.0f;
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
      if (wg + mi * W >= N / 64) continue;
#pragma unroll
      for (int jb = 0; jb < DH / 8; ++jb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = (wg + mi * W) * 64 + r0 + 8 * h;
          const int d = jb * 8 + q2;
          const float2 o = hout[mi][jb][h];
          if (has_in) {
            const float2 hv = __ldg(reinterpret_cast<const float2*>(hg + k * DH + d));
            hd = fmaf(hv.x, o.x, hd);
            hd = fmaf(hv.y, o.y, hd);
          }
          uint32_t hi, lo;
          split_bf16(o.x, o.y, hi, lo);
          *reinterpret_cast<uint32_t*>(ohi + swz(N, k, d)) = hi;
          *reinterpret_cast<uint32_t*>(olo + swz(N, k, d)) = lo;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) hd += __shfl_xor_sync(0xffffffffu, hd, off);
    if (lane == 0) wsum[warp] = hd;
  }
  fence_proxy_async();                           // dh_out's tiles, for wgmma
  __syncthreads();

  // == column side: rows j = ra, ra + 8, the transposed scores =================
  //    B C^T and x dy^T give G^T and M^T with the warpgroup's rows as j, so
  //    sum_i G_ij M_ij is a row sum and G^T, W^T are A fragments as they
  //    come.  Two passes, so that only one of them is held at a time: G^T
  //    for dx, then M^T once more (K = dh) for W^T and dB.
  uint32_t ghi[L / 16][4], glo[L / 16][4];
  {
    float sc[L / 2], m[L / 2];
#pragma unroll
    for (int i = 0; i < L / 2; ++i) sc[i] = m[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      Wgmma<L, kKMajor>::mma(sc, rows_desc(bs_a, kk), kmajor(cs_a, L, kk));
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<L, kKMajor>::mma(m, rows_desc(xs_a, kk), kmajor(dys_a, L, kk));
    wgmma_commit();
    wgmma_wait<0>();
    const float cj[2] = {cum[ra], cum[ra + 8]};
    float gm[2] = {0.0f, 0.0f};
#pragma unroll
    for (int ib = 0; ib < L / 8; ++ib)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = ib * 8 + q2 + e;
        const float ci = cum[i];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = 4 * ib + 2 * h + e;
          // mask before exp: i < j would give exp of a positive number
          const float ex = i >= ra + 8 * h ? expf(ci - cj[h]) : 0.0f;
          const float g = sc[u] * ex;                                    // G_ij
          gm[h] = fmaf(g, m[u], gm[h]);
          sc[u] = g;
        }
      }
    gm[0] = quad_sum(gm[0]);
    gm[1] = quad_sum(gm[1]);
    if (lane % 4 == 0) {
      colv[ra] = gm[0];
      colv[ra + 8] = gm[1];
    }
    split_fragment<L>(sc, ghi, glo);
  }
  // -- dx_j = dt_j (sum_i G_ij dy_i + exp(total - cum_j) B_j dh_out), and R_j --
  {
    float xa[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) xa[i] = 0.0f;
    float r[2] = {0.0f, 0.0f};
    if (!first) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t da = rows_desc(bs_a, kk);
        Wgmma<DH, kMNMajor>::mma(xa, da, mnmajor(ohi_a, N, kk));
        Wgmma<DH, kMNMajor>::mma(xa, da, mnmajor(olo_a, N, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      row_dots<DH, L>(xa, xs, ra, q2, r);
      const float f[2] = {etot[ra], etot[ra + 8]};
      scale_rows<DH>(xa, f);
    }
    if (lane % 4 == 0) {
      rv[ra] = r[0];
      rv[ra + 8] = r[1];
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const uint64_t db = mnmajor(dys_a, L, kk);
      WgmmaRS<DH>::mma(xa, ghi[kk], db);
      WgmmaRS<DH>::mma(xa, glo[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = ra + 8 * h;
      if (j >= lv) continue;
      const float dj = dts[j];
      __nv_bfloat16* xrow = dx + ((size_t)row * s + c0 + j) * DH;
#pragma unroll
      for (int jb = 0; jb < DH / 8; ++jb)
        *reinterpret_cast<uint32_t*>(xrow + jb * 8 + q2) =
            pack_bf16(dj * xa[4 * jb + 2 * h], dj * xa[4 * jb + 2 * h + 1]);
    }
  }
  // -- W^T from M^T recomputed -------------------------------------------------
  {
    float m[L / 2];
#pragma unroll
    for (int i = 0; i < L / 2; ++i) m[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<L, kKMajor>::mma(m, rows_desc(xs_a, kk), kmajor(dys_a, L, kk));
    wgmma_commit();
    wgmma_wait<0>();
    const float cj[2] = {cum[ra], cum[ra + 8]}, dj[2] = {dts[ra], dts[ra + 8]};
#pragma unroll
    for (int ib = 0; ib < L / 8; ++ib)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = ib * 8 + q2 + e;
        const float ci = cum[i];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = 4 * ib + 2 * h + e;
          m[u] = i >= ra + 8 * h ? m[u] * expf(ci - cj[h]) * dj[h] : 0.0f;   // W_ij
        }
      }
    split_fragment<L>(m, whi, wlo);
  }
  // -- dB_j = w_j dh_out x_j + sum_i W_ij C_i ----------------------------------
  {
    float ba[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) ba[i] = 0.0f;
    if (!first) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t da = rows_desc(xs_a, kk);
        Wgmma<N, kKMajor>::mma(ba, da, kmajor(ohi_a, N, kk));
        Wgmma<N, kKMajor>::mma(ba, da, kmajor(olo_a, N, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      const float f[2] = {wts[ra], wts[ra + 8]};
      scale_rows<N>(ba, f);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const uint64_t db = mnmajor(cs_a, L, kk);
      WgmmaRS<N>::mma(ba, whi[kk], db);
      WgmmaRS<N>::mma(ba, wlo[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    store_rows<N>(part_b + ((size_t)row * s + c0) * N, ba, ra, q2, lv);
  }

  // == the decay exponents (warp 0) =============================================
  __syncthreads();
  if (warp == 0) {
    float hdot = 0.0f;
#pragma unroll
    for (int w = 0; w < L / 16; ++w) hdot += wsum[w];
    decay_gradient(rowp, colv, qv, rv, dts, cum, wts, lv, total, A[row], hdot,
                   part_dt + (size_t)row * s + c0, part_a + (size_t)row * chunks + chunk);
  }
}

template <int DH, int N, int L>
cudaError_t sm90_launch(const void* x, const void* dt, const void* B, const void* C,
                        const void* A, const void* entering, const void* dy, void* dx,
                        void* ddt, void* dB, void* dC, void* dA, void* part_b, void* part_c,
                        void* part_dt, void* part_a, void* ring, void* sync, int bh, int s,
                        int heads, cudaStream_t stream) {
  CUtensorMap xmap, dymap, bmap, cmap;
  const int groups = bh / heads;
  if (!sm90::make_map(&xmap, x, DH, s, bh, L) || !sm90::make_map(&dymap, dy, DH, s, bh, L) ||
      !sm90::make_map(&bmap, B, N, s, groups, L) || !sm90::make_map(&cmap, C, N, s, groups, L))
    return cudaErrorInvalidValue;
  constexpr int smem = sm90_smem_bytes<DH, N, L>();
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_sm90_kernel<DH, N, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (s + L - 1) / L;
  ssd_bwd_sm90_kernel<DH, N, L><<<bh * chunks, 2 * L, smem, stream>>>(
      xmap, dymap, bmap, cmap, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(entering), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(part_b), static_cast<float*>(part_c), static_cast<float*>(part_dt),
      static_cast<float*>(part_a), static_cast<float*>(ring), static_cast<int*>(sync), bh, s,
      heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_launch<__nv_bfloat16>(part_b, part_c, part_dt, part_a, dB, dC, ddt, dA, bh, s,
                                      N, 1, heads, chunks, stream);
}

template <int DH, int N, int L>
cudaError_t sm90_attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, ssd_bwd_sm90_kernel<DH, N, L>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

cudaError_t sm90_dispatch(int dh, int n, int L, const void* x, const void* dt, const void* B,
                          const void* C, const void* A, const void* entering, const void* dy,
                          void* dx, void* ddt, void* dB, void* dC, void* dA, void* part_b,
                          void* part_c, void* part_dt, void* part_a, void* ring, void* sync,
                          int bh, int s, int heads, cudaStream_t stream) {
#define SSD_BWD_SM90_CASE(DH, N, CH)                                                   \
  if (dh == DH && n == N && L == CH)                                                   \
    return sm90_launch<DH, N, CH>(x, dt, B, C, A, entering, dy, dx, ddt, dB, dC, dA, part_b, \
                                  part_c, part_dt, part_a, ring, sync, bh, s, heads, stream);
  SSD_SM90_TILES(SSD_BWD_SM90_CASE)
#undef SSD_BWD_SM90_CASE
  return cudaErrorInvalidValue;
}

cudaError_t sm90_dispatch_attributes(int dh, int n, int L, int* num_regs, int* max_threads,
                                     int* local_bytes) {
#define SSD_BWD_SM90_ATTR(DH, N, CH)                                                   \
  if (dh == DH && n == N && L == CH)                                                   \
    return sm90_attributes<DH, N, CH>(num_regs, max_threads, local_bytes);
  SSD_SM90_TILES(SSD_BWD_SM90_ATTR)
#undef SSD_BWD_SM90_ATTR
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the backward and its reduction on `stream` and returns
// cudaGetLastError() (0 on success).  The caller has checked shapes,
// dtypes, alignment and the chunk's shared memory, and hands over the f32
// partials and the zeroed integers `sync`, which the launch leaves zeroed.
// body 1 runs the wgmma body, for bf16 at a compiled (dh, n, chunk) only
// (cudaErrorInvalidValue elsewhere): partials per row,
// part_b, part_c (bh, s, n), part_dt (bh, s), part_a (bh, chunks), the ring
// (bh, 2, n, dh), and the ticket counter and chunk / 16 flags per row.
// body 0 runs the SIMT body, any dtype and shape: partials per (row, 16 head-dim
// columns), part_b, part_c (bh * dh / 16, s, n), part_dt (bh * dh / 16, s),
// part_a (bh * dh / 16, chunks), the ring (bh * dh / 16, 2, n, 16), and the
// ticket counter and 8 flags per chain.  B and C are shared by `heads`
// consecutive rows.
int klaraptor_ssd_scan_bwd(const void* x, const void* dt, const void* B, const void* C,
                           const void* A, const void* entering, const void* dy, void* dx,
                           void* ddt, void* dB, void* dC, void* dA, void* part_b, void* part_c,
                           void* part_dt, void* part_a, void* ring, void* sync, int bh, int s,
                           int dh, int n, int chunk, int heads, int dtype, int body,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1)
    return dtype == kBF16 && sm90_compiled(dh, n, chunk)
               ? sm90_dispatch(dh, n, chunk, x, dt, B, C, A, entering, dy, dx, ddt, dB, dC,
                               dA, part_b, part_c, part_dt, part_a, ring, sync, bh, s, heads,
                               st)
               : cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return simt_launch<float>(x, dt, B, C, A, entering, dy, dx, ddt, dB, dC, dA, part_b,
                                part_c, part_dt, part_a, ring, sync, bh, s, dh, n, chunk,
                                heads, st);
    case kBF16:
      return simt_launch<__nv_bfloat16>(x, dt, B, C, A, entering, dy, dx, ddt, dB, dC, dA,
                                        part_b, part_c, part_dt, part_a, ring, sync, bh, s,
                                        dh, n, chunk, heads, st);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// the backward's SIMT kernel for `dtype`.
int klaraptor_ssd_scan_bwd_attributes(int dtype, int* num_regs, int* max_threads,
                                      int* local_bytes) {
  switch (dtype) {
    case kF32: return simt_attributes<float>(num_regs, max_threads, local_bytes);
    case kBF16: return simt_attributes<__nv_bfloat16>(num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

// The same for the wgmma instantiation (dh, n, chunk).
int klaraptor_ssd_scan_bwd_tile_attributes(int dh, int n, int chunk, int* num_regs,
                                           int* max_threads, int* local_bytes) {
  return sm90_dispatch_attributes(dh, n, chunk, num_regs, max_threads, local_bytes);
}

// Dynamic shared memory of the wgmma instantiation (dh, n, chunk), -1 if
// there is none.
int klaraptor_ssd_scan_bwd_tile_smem(int dh, int n, int chunk) {
#define SSD_BWD_SM90_SMEM(DH, N, CH) \
  if (dh == DH && n == N && chunk == CH) return sm90_smem_bytes<DH, N, CH>();
  SSD_SM90_TILES(SSD_BWD_SM90_SMEM)
#undef SSD_BWD_SM90_SMEM
  return -1;
}

const char* klaraptor_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
