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
// Bound on an H100 SXM (67 TFLOP/s FP32 on the CUDA cores, 3.35 TB/s HBM3):
// at mamba2-130m's training shape (bh 192 = 8 x 24 heads sharing one group,
// s 256, dh 64, n 128, chunk 128) the function reads x, dy, B, C, dt and the
// entering states (12.6 MB of f32 states, 12.6 MB of bf16 x and dy) and
// writes dx, dB, dC, ddt, dA, 34 MB in all (10 us), against 7.3 GFLOP of
// products with the causal halves (7 us on the tensor cores): bound by
// bytes on paper, by the FP32 rate of this body in practice.
//
// What this design does about it (a simple body: the tensor cores are later
// work).
//   * One launch, every chunk in parallel, as the forward: each CTA takes one
//     (row, 16 head-dim columns, chunk) from an integer ticket, drawn in
//     *reverse* chunk order, so a CTA only ever waits on the next chunk's,
//     which is already running or done.  It first computes what needs no
//     other chunk (sum_i exp(cum_i) C_i^T dy_i), then waits for dh_out from
//     the next chunk through a two-slot f32 ring in the L2, publishes dh_in,
//     and only then forms its gradients: the chain costs one hop a chunk.
//     The flags are per warp, and the launch leaves them and the counter
//     zeroed (the wrapper keeps its own buffer, kernels/_workspace.py).
//   * The quadratic terms walk tiles of 32 rows, as the forward's SIMT body:
//     for row tiles (dC, sum_j P_ij) and then for column tiles (dx, dB,
//     sum_i P_ij, the direct dt term), each tile of C B^T and M recomputed
//     into shared memory with 4 x 4 register blocks; FP32 FMAs throughout.
//   * No float atomics.  dB and dC are shared by the rows of a group and by
//     the column blocks of a row, ddt by the column blocks, dA by the chunks:
//     each CTA writes its own f32 partials, and a second kernel sums them in
//     a fixed order, so two calls give the same bits.
//   * Rows past s (a ragged last chunk) are staged as zeros, add nothing, and
//     are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    const int lane = tid;
    float hdot = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) hdot += warp_sums[w];
    float wr = 0.0f;                              // sum_j w_j R_j
    for (int i = lane; i < lv; i += 32) wr = fmaf(wts[i], rv[i], wr);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) wr += __shfl_xor_sync(0xffffffffu, wr, off);
    float carry = wr + decay * hdot;              // dtotal, on the last entry
    float da = 0.0f;
    float* dtp = part_dt + (size_t)chain * s + c0;
    for (int base = ((lv + 31) & ~31) - 32; base >= 0; base -= 32) {
      const int i = base + lane;
      float v = i < lv ? rowp[i] - dts[i] * colv[i] + qv[i] - wts[i] * rv[i] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {    // suffix sum within the warp
        const float dn = __shfl_down_sync(0xffffffffu, v, off);
        if (lane + off < 32) v += dn;
      }
      const float rev = v + carry;
      carry = __shfl_sync(0xffffffffu, rev, 0);
      if (i < lv) {
        dtp[i] = colv[i] + expf(total - cum[i]) * rv[i] + a * rev;
        da = fmaf(dts[i], rev, da);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(0xffffffffu, da, off);
    if (lane == 0) part_a[(size_t)chain * chunks + chunk] = da;
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

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* B, const void* C, const void* A,
                   const void* entering, const void* dy, void* dx, void* ddt, void* dB,
                   void* dC, void* dA, void* part_b, void* part_c, void* part_dt,
                   void* part_a, void* ring, void* sync, int bh, int s, int dh, int n, int L,
                   int heads, cudaStream_t stream) {
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
cudaError_t attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, ssd_bwd_kernel<T>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the backward and its reduction on `stream` and returns
// cudaGetLastError() (0 on success).  The caller has checked shapes,
// dtypes, alignment and the chunk's shared memory, and hands over the f32
// partials part_b, part_c (bh * dh / 16, s, n), part_dt (bh * dh / 16, s),
// part_a (bh * dh / 16, chunks), the state-gradient ring (bh * dh / 16, 2,
// n, 16) and the zeroed integers `sync` (the ticket counter and 8 flags per
// chain), which the launch leaves zeroed.  B and C are shared by `heads`
// consecutive rows.
int klaraptor_ssd_scan_bwd(const void* x, const void* dt, const void* B, const void* C,
                           const void* A, const void* entering, const void* dy, void* dx,
                           void* ddt, void* dB, void* dC, void* dA, void* part_b, void* part_c,
                           void* part_dt, void* part_a, void* ring, void* sync, int bh, int s,
                           int dh, int n, int chunk, int heads, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(x, dt, B, C, A, entering, dy, dx, ddt, dB, dC, dA, part_b, part_c,
                           part_dt, part_a, ring, sync, bh, s, dh, n, chunk, heads, st);
    case kBF16:
      return launch<__nv_bfloat16>(x, dt, B, C, A, entering, dy, dx, ddt, dB, dC, dA, part_b,
                                   part_c, part_dt, part_a, ring, sync, bh, s, dh, n, chunk,
                                   heads, st);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// the backward kernel for `dtype`.
int klaraptor_ssd_scan_bwd_attributes(int dtype, int* num_regs, int* max_threads,
                                      int* local_bytes) {
  switch (dtype) {
    case kF32: return attributes<float>(num_regs, max_threads, local_bytes);
    case kBF16: return attributes<__nv_bfloat16>(num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

const char* klaraptor_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
