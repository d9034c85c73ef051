// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a):
//   h_t = exp(dt_t * A) h_{t-1} + dt_t B_t x_t^T      h: (n, dh), f32
//   y_t = C_t h_t                                     y: (dh,)
// for each of bh independent (batch * head) rows, x (bh, s, dh), dt (bh, s),
// A (bh,), y (bh, s, dh) in x's type, and B and C (bh / h, s, n), each shared
// by h consecutive rows of x (h = 1 is the reference's per-head interface;
// a Mamba-2 layer's heads share one group's B and C).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (body _ssd_kernel),
// the TPU kernel with grid (bh, chunks), the chunk axis sequential and the
// (n, dh) state carried across chunks in f32 VMEM scratch.
//
// Bound on an H100 SXM (3.35 TB/s HBM3; 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s FP32 on the CUDA cores): at the mamba2-130m prefill shape (bh 24
// sharing one group, s 4096, dh 64, n 128, bf16) the function reads x, B, C
// and dt and writes y, 27.7 MB, while the chunked form needs about 1.6 GFLOP
// at chunk 64 (4.5 us on the tensor cores against 8.3 us of bytes): it is
// bound by bytes, and by the latency of the chain of chunk states.
//
// Within a chunk of L rows (cum = inclusive running sum of A dt, total =
// cum_{L-1}) the chunked form is
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i h_in,
//   S     = sum_j exp(total - cum_j) dt_j B_j x_j^T        (the chunk's own)
//   h_out = exp(total) h_in + S.
//
// What this design does about it.
//   * Chunks in parallel.  One launch; each CTA takes one (row, chunk) -- the
//     SIMT body one (row, 16 head-dim columns, chunk) -- in ticket order from
//     an integer atomic, chunk-major, so the h rows that share B and C run the
//     same chunk together and read it from the L2: B and C come from device
//     memory once per group.  A CTA computes everything that needs no other
//     chunk first (S, and in the wgmma body the intra-chunk output), then
//     waits for its predecessor (the same row's previous chunk), reads h_in
//     (an f32 tile through the L2), publishes h_out, and only then adds
//     exp(cum_i) C_i h_in to its rows.  The hop is per warp: warp w of a
//     chunk owns the same state elements in every chunk, so it waits on,
//     and releases, a flag of its own, with no block-wide barrier on the
//     chain's path; its loads all go out before its stores.  Tickets are drawn
//     in order, so a CTA only ever waits on one that is already running or
//     done: the look-back of single-pass scans, here one chunk deep.  The
//     chain of states costs s / L hops of a few microseconds each against
//     quadratic work in L, so the chunk is a real trade for KLARAPTOR.  The
//     states live in a ring of two slots per chain (a chunk reads slot
//     (c - 1) % 2 and writes c % 2; chunk c + 2 overwrites slot c % 2 only
//     after chunk c + 1, which read it, has published), 1.5 MB at the prefill
//     shape instead of one state per chunk (50 MB at chunk 64) that the
//     chunk-state / state-passing / chunk-scan split of Mamba-2's kernels
//     writes.  The flags and the ticket counter are integers the launch
//     leaves zeroed (the last ticket resets the counter, a chain's last chunk
//     its flag), so the wrapper keeps them between launches on one stream.
//   * bf16 at (dh, n) = (64, 128) -- ssd_sm90_kernel, the tensor cores.  One
//     warpgroup per 64 rows of the chunk (L = 64 or 128, template
//     parameters; SSD_SM90_CHUNKS).  x, B and C come in by TMA on one
//     mbarrier, 3-D maps over (dh or n, s, rows or groups) with 128-byte
//     swizzle; a ragged last chunk is zero-filled past s.  All four products
//     run wgmma.m64nNk16 with f32 accumulators:
//       - S = (B^T o w) X (n x dh x L), w_j = exp(total - cum_j) dt_j: A from
//         registers, read out of the swizzled B tile; X is (k, n) row-major,
//         MN-major for B, and goes in through the transpose bit as flash
//         attention's V does;
//       - C B^T (L x L x n): both K-major from shared memory, as Q K^T;
//       - (scores o gate) X (L x dh x L): A from the score accumulator in
//         registers, as flash attention's P;
//       - C h_in (L x dh x n), scaled by exp(cum_i) in the epilogue: h_in is
//         written to shared memory in the swizzled MN-major layout.
//     The f32 operands (w o B, the gated scores, h_in) are fed as hi + lo
//     bf16 pairs, each with the same B operand, so each product keeps them
//     to about 2^-17, as flash attention keeps P: rounding them once would
//     add a bf16 rounding per product to every layer, where the Pallas
//     kernel keeps them in f32.  wgmma rather than mma.sync: every tile has
//     64 rows or a multiple, and the helpers exist (csrc/sm90.cuh).
//   * f32, and bf16 at other (dh, n) -- ssd_simt_kernel: the same parallel
//     structure on the CUDA cores (wgmma takes f32 only as TF32).  A CTA of
//     256 threads owns 16 head-dim columns of one chunk; it stages dt, B and
//     C (transposed, n x L) and its x columns, forms the running sum with
//     warp scans, computes S into shared memory, waits for and publishes the
//     state, then walks tiles of 32 score rows: a 4 x 4 block of C B^T per
//     thread, gated and causally masked, into a shared f32 tile, then two y
//     columns of one row from it and from C_i h_in.  All FP32 FMAs.
//
// The exponent is masked before exp, as in the reference: only j <= i ever
// reaches exp(cum_i - cum_j), whose argument is then <= 0.  Rows past s have
// dt = 0 (nothing added to the running sum or the state) and are never
// written, so no length needs padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "ssd_common.cuh"

namespace {

using namespace ssd;

enum DType { kF32 = 0, kBF16 = 1 };

// ---------------------------------------------------------------------------
// SIMT body: f32, and bf16 at shapes without a wgmma instantiation
// ---------------------------------------------------------------------------

// x: (bh, s, dh); dt: (bh, s) f32; B, C: (bh / heads, s, n); A: (bh,) f32;
// out like x; all contiguous and 16-byte aligned.  states: (bh * dh / kCols,
// 2, n, kCols) f32; sync: the ticket counter, then kThreads / 32 flags per
// chain (one per warp), all 0.  entering: null, or (bh, ceil(s / L), n, dh)
// f32, each chunk's entering state (what the backward reads).
// gridDim = bh * dh / kCols * ceil(s / L), blockDim = kThreads,
// L % kRows == 0, n % 8 == 0, dh % kCols == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_simt_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const T* __restrict__ B, const T* __restrict__ C,
                const float* __restrict__ A, T* __restrict__ out, float* states, int* sync,
                float* __restrict__ entering, int bh, int s, int dh, int n, int L,
                int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  const int GS = L + kGPad;                               // score-tile row stride
  float* st = reinterpret_cast<float*>(smem);             // [n][kCols] S, then h_in
  float* gs = st + n * kCols;                             // [kRows][GS] scores
  float* dts = gs + kRows * GS;                           // [L] dt
  float* cum = dts + L;                                   // [L] running sum of A dt
  float* wts = cum + L;                                   // [L] exp(total - cum) dt
  T* bs = reinterpret_cast<T*>(wts + L);                  // [n][L] B^T
  T* cs = bs + n * L;                                     // [n][L] C^T
  T* xs = cs + n * L;                                     // [L][kCols] x columns

  const int tid = threadIdx.x;
  const int blocks = dh / kCols;
  const int chains = bh * blocks;
  const int chunks = (s + L - 1) / L;
  const int t = draw_ticket(sync, &ticket, chains * chunks);
  const int chunk = t / chains;                           // chunk-major tickets
  const int chain = t % chains;
  const int row = chain / blocks;
  const int d0 = (chain % blocks) * kCols;
  const int c0 = chunk * L;
  const int lv = min(L, s - c0);                          // valid rows of this chunk
  const float a = A[row];
  const T* xg = x + ((size_t)row * s + c0) * dh + d0;
  const float* dtg = dt + (size_t)row * s + c0;
  const T* bg = B + ((size_t)(row / heads) * s + c0) * n;
  const T* cg = C + ((size_t)(row / heads) * s + c0) * n;
  T* og = out + ((size_t)row * s + c0) * dh + d0;

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
      uint4 pack = make_uint4(0u, 0u, 0u, 0u);
      if (r < lv) pack = *reinterpret_cast<const uint4*>(xg + (size_t)r * dh + c);
      *reinterpret_cast<uint4*>(xs + r * kCols + c) = pack;
    }
  }
  __syncthreads();
  running_sum(dts, cum, a, L);
  __syncthreads();
  const float total = cum[L - 1];
  for (int j = tid; j < L; j += kThreads) wts[j] = expf(total - cum[j]) * dts[j];
  __syncthreads();

  // -- the chunk's own state S = sum_j w_j B_j x_j^T ------------------------
  const int lv4 = (lv + 3) & ~3;                          // rows past lv weigh 0
  for (int e = tid; e < (n / 4) * (kCols / 2); e += kThreads) {
    const int kb = (e / (kCols / 2)) * 4;
    const int dp = (e % (kCols / 2)) * 2;
    float acc[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.0f;
    for (int j = 0; j < lv4; j += 4) {
      float w[4];
      load4(wts + j, w);
      float2 xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = load2(xs + (j + q) * kCols + dp);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float bv[4];
        load4(bs + (kb + r) * L + j, bv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float b = bv[q] * w[q];
          acc[r][0] = fmaf(b, xv[q].x, acc[r][0]);
          acc[r][1] = fmaf(b, xv[q].y, acc[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) store2(st + (kb + r) * kCols + dp, acc[r][0], acc[r][1]);
  }

  // -- the chain: h_in from the previous chunk, h_out to the next -------------
  int* flag = sync + 1 + chain * (kThreads / 32) + tid / 32;
  const float* slot_in = states + ((size_t)chain * 2 + ((chunk + 1) & 1)) * n * kCols;
  float* slot_out = states + ((size_t)chain * 2 + (chunk & 1)) * n * kCols;
  const bool last = chunk == chunks - 1;
  __syncthreads();                                        // S is in st
  if (chunk > 0) wait_flag(flag, chunk);
  const float decay = expf(total);
  // kHop loads in flight before any store: slot_in and slot_out may alias
  // as far as the compiler knows, so a store between two loads would make
  // each load wait for the one before it (an L2 round trip per element)
  constexpr int kHop = 8;
  for (int e0 = tid; e0 < n * kCols; e0 += kHop * kThreads) {
    float h[kHop];
#pragma unroll
    for (int u = 0; u < kHop; ++u) {
      const int e = e0 + u * kThreads;
      h[u] = chunk > 0 && e < n * kCols ? __ldcg(slot_in + e) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kHop; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= n * kCols) break;
      if (!last) __stcg(slot_out + e, fmaf(decay, h[u], st[e]));
      st[e] = h[u];
      if (entering)
        entering[(((size_t)row * chunks + chunk) * n + e / kCols) * dh + d0 + e % kCols] = h[u];
    }
  }
  publish_flag(flag, last ? 0 : chunk + 1);
  __syncthreads();                                        // h_in is in st

  // -- output rows, one tile of kRows rows at a time ------------------------
  for (int i0 = 0; i0 < lv; i0 += kRows) {
    const int jn = i0 + kRows;                            // columns j < jn
    const int items = (kRows / 4) * (jn / 4);
    for (int e = tid; e < items; e += kThreads) {
      const int ti = e % (kRows / 4);
      const int tj = e / (kRows / 4);
      const int ib = i0 + ti * 4;
      const int jb = tj * 4;
      if (jb > ib + 3) continue;                          // wholly above the diagonal
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float cv[4], bv[4];
        load4(cs + k * L + ib, cv);
        load4(bs + k * L + jb, bv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ib + r;
        const float ci = cum[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = jb + q;
          // mask before exp: j > i would give exp of a positive number
          gs[(ti * 4 + r) * GS + j] =
              j <= i ? acc[r][q] * expf(ci - cum[j]) * dts[j] : 0.0f;
        }
      }
    }
    __syncthreads();

    for (int e = tid; e < kRows * (kCols / 2); e += kThreads) {
      const int r = e / (kCols / 2);
      const int dp = (e % (kCols / 2)) * 2;
      const int i = i0 + r;
      const float* grow = gs + r * GS;
      float y0 = 0.0f, y1 = 0.0f;
      int j = 0;
      for (; j + 3 <= i; j += 4) {                        // 4 columns, all j <= i
        float g[4];
        load4(grow + j, g);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xv = load2(xs + (j + q) * kCols + dp);
          y0 = fmaf(g[q], xv.x, y0);
          y1 = fmaf(g[q], xv.y, y1);
        }
      }
      for (; j <= i; ++j) {
        const float g = grow[j];
        const float2 xv = load2(xs + j * kCols + dp);
        y0 = fmaf(g, xv.x, y0);
        y1 = fmaf(g, xv.y, y1);
      }
      float z0 = 0.0f, z1 = 0.0f;                         // C_i h_in
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float cv = to_f32(cs[k * L + i]);
        const float2 h = *reinterpret_cast<const float2*>(st + k * kCols + dp);
        z0 = fmaf(cv, h.x, z0);
        z1 = fmaf(cv, h.y, z1);
      }
      const float ei = expf(cum[i]);
      if (i < lv) store2(og + (size_t)i * dh + dp, fmaf(ei, z0, y0), fmaf(ei, z1, y1));
    }
    __syncthreads();
  }
}

template <typename T>
size_t simt_smem_bytes(int n, int L) {
  return (size_t)(2 * n + kCols) * L * sizeof(T) + (size_t)12 * L +
         (size_t)4 * kRows * (L + kGPad) + (size_t)4 * n * kCols;
}

template <typename T>
cudaError_t simt_launch(const void* x, const void* dt, const void* B, const void* C,
                        const void* A, void* out, void* states, void* sync, void* entering,
                        int bh, int s, int dh, int n, int L, int heads, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes<T>(n, L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = bh * (dh / kCols) * ((s + L - 1) / L);
  ssd_simt_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(A), static_cast<T*>(out),
      static_cast<float*>(states), static_cast<int*>(sync), static_cast<float*>(entering), bh,
      s, dh, n, L, heads);
  return cudaGetLastError();
}

template <typename T>
cudaError_t simt_attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, ssd_simt_kernel<T>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 wgmma body
// ---------------------------------------------------------------------------

// Dynamic shared memory beyond the tiles and the three (L,) f32 vectors: the
// 1 KiB alignment slack, the mbarrier and the ticket.
constexpr int kSm90SmemExtra = sm90::kAlign + 64;

template <int DH, int N, int L>
constexpr int sm90_smem_bytes() {
  return (L * DH + 2 * L * N + 2 * N * DH) * 2 + 3 * L * 4 + kSm90SmemExtra;
}

// x: (bh, s, DH) through xmap; B, C: (bh / heads, s, N) through bmap, cmap;
// dt: (bh, s) f32; A: (bh,) f32; out: (bh, s, DH) bf16, 4-byte aligned.
// states: (bh, 2, N, DH) f32; sync: the ticket counter, then L / 16 flags
// per row (one per warp), all 0; entering: null, or (bh, ceil(s / L), N,
// DH) f32, each chunk's entering state.  gridDim = bh * ceil(s / L), blockDim = 2 L (one warpgroup per
// 64 rows).
template <int DH, int N, int L>
__global__ void __launch_bounds__(256, 1)
ssd_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap cmap,
                const float* __restrict__ dt, const float* __restrict__ A,
                __nv_bfloat16* __restrict__ out, float* states, int* sync,
                float* __restrict__ entering, int bh, int s, int heads) {
  using namespace sm90;
  static_assert(DH % kAtom == 0 && N % kAtom == 0 && DH <= 128 && N <= 128,
                "whole swizzle boxes, wgmma N <= 128");
  static_assert(L == 64 || L == 128, "one or two warpgroups");
  constexpr int W = L / 64;                      // warpgroups
  constexpr int kXBytes = L * DH * 2;
  constexpr int kBBytes = L * N * 2;             // one of B, C
  constexpr int kHBytes = N * DH * 2;            // one of h_in's hi, lo
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* xs = smem;                                  // [DH/64][L][64]
  unsigned char* bs = xs + kXBytes;                          // [N/64][L][64]
  unsigned char* cs = bs + kBBytes;                          // [N/64][L][64]
  unsigned char* hhi = cs + kBBytes;                         // [DH/64][N][64]
  unsigned char* hlo = hhi + kHBytes;                        // [DH/64][N][64]
  float* dts = reinterpret_cast<float*>(hlo + kHBytes);      // [L] dt
  float* cum = dts + L;                                      // [L] running sum
  float* wts = cum + L;                                      // [L] exp(total-cum) dt
  uint64_t* bar = reinterpret_cast<uint64_t*>(wts + L);
  int* ticket = reinterpret_cast<int*>(bar + 1);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = t % 32;
  const int chunks = (s + L - 1) / L;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  const int tk = draw_ticket(sync, ticket, bh * chunks);
  const int chunk = tk / bh;                     // chunk-major tickets
  const int row = tk % bh;
  const int c0 = chunk * L;
  const int lv = min(L, s - c0);
  if (tid == 0) {
    mbar_expect_tx(bar, kXBytes + 2 * kBBytes);
#pragma unroll
    for (int b = 0; b < DH / kAtom; ++b) tma_load(xs + b * L * 128, &xmap, bar, b * kAtom, c0, row);
#pragma unroll
    for (int b = 0; b < N / kAtom; ++b) {
      tma_load(bs + b * L * 128, &bmap, bar, b * kAtom, c0, row / heads);
      tma_load(cs + b * L * 128, &cmap, bar, b * kAtom, c0, row / heads);
    }
  }
  for (int j = tid; j < L; j += blockDim.x) dts[j] = j < lv ? dt[(size_t)row * s + c0 + j] : 0.0f;
  __syncthreads();
  running_sum(dts, cum, A[row], L);
  __syncthreads();
  const float total = cum[L - 1];
  for (int j = tid; j < L; j += blockDim.x) wts[j] = expf(total - cum[j]) * dts[j];
  __syncthreads();
  mbar_wait(bar, 0);

  const uint32_t xs_a = smem_addr(xs), bs_a = smem_addr(bs), cs_a = smem_addr(cs);
  const int r0 = (t / 32) * 16 + lane / 4;       // fragment rows r0 and r0 + 8
  const int q2 = 2 * (lane % 4);                 // fragment columns q2, q2 + 1

  // -- S = (B^T o w) X: n rows in m-tiles of 64, the warpgroups share them ---
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
        const int m = mt * 64 + r0 + 8 * (i & 1);
        const int j = kk * 16 + q2 + 8 * (i >> 1);
        const float v0 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                             bs + swz(L, j, m))) * wts[j];
        const float v1 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                             bs + swz(L, j + 1, m))) * wts[j + 1];
        split_bf16(v0, v1, ahi[kk][i], alo[kk][i]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const uint64_t db = make_desc(xs_a + kk * 16 * 128, L * 128, 1024);
      WgmmaRS<DH>::mma(sacc[mi], ahi[kk], db);
      WgmmaRS<DH>::mma(sacc[mi], alo[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }

  // -- scores C B^T of this warpgroup's 64 rows, gated, then times X ---------
  const int ra = wg * 64 + r0;                   // chunk rows ra and ra + 8
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  {
    float sc[L / 2];
#pragma unroll
    for (int i = 0; i < L / 2; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t da = make_desc(cs_a + (kk / 4) * L * 128 + wg * 64 * 128 + (kk % 4) * 32,
                                    16, 1024);
      const uint64_t db = make_desc(bs_a + (kk / 4) * L * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma<L, kKMajor>::mma(sc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ra + 8 * h;
      const float ci = cum[i];
#pragma unroll
      for (int jb = 0; jb < L / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jb * 8 + q2 + e;
          float& v = sc[4 * jb + 2 * h + e];
          // mask before exp: j > i would give exp of a positive number
          v = j <= i ? v * expf(ci - cum[j]) * dts[j] : 0.0f;
        }
    }
    uint32_t ghi[L / 16][4], glo[L / 16][4];
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], ghi[kk][i], glo[kk][i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const uint64_t db = make_desc(xs_a + kk * 16 * 128, L * 128, 1024);
      WgmmaRS<DH>::mma(o, ghi[kk], db);
      WgmmaRS<DH>::mma(o, glo[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }

  // -- the chain: h_in from the previous chunk, h_out to the next -------------
  int* flag = sync + 1 + row * (L / 16) + tid / 32;
  const float* slot_in = states + ((size_t)row * 2 + ((chunk + 1) & 1)) * N * DH;
  float* slot_out = states + ((size_t)row * 2 + (chunk & 1)) * N * DH;
  const bool last = chunk == chunks - 1;
  if (chunk > 0) wait_flag(flag, chunk);
  const float decay = expf(total);
  // every load in flight before any store: slot_in and slot_out may alias
  // as far as the compiler knows, so interleaving them would cost an L2
  // round trip per load
  float2 hin[kMTiles][DH / 8][2];
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int jb = 0; jb < DH / 8; ++jb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t e = (size_t)((wg + mi * W) * 64 + r0 + 8 * h) * DH + jb * 8 + q2;
        hin[mi][jb][h] = chunk > 0 && wg + mi * W < N / 64
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
                 make_float2(fmaf(decay, hin[mi][jb][h].x, sacc[mi][4 * jb + 2 * h]),
                             fmaf(decay, hin[mi][jb][h].y, sacc[mi][4 * jb + 2 * h + 1])));
        }
    }
  }
  publish_flag(flag, last ? 0 : chunk + 1);
  if (entering) {
    float* eg = entering + ((size_t)row * chunks + chunk) * N * DH;
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
      if (wg + mi * W >= N / 64) continue;
#pragma unroll
      for (int jb = 0; jb < DH / 8; ++jb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(eg + ((wg + mi * W) * 64 + r0 + 8 * h) * DH + jb * 8 + q2) =
              hin[mi][jb][h];
    }
  }
  // h_in into shared memory, as hi + lo bf16 tiles, for C h_in
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
    if (wg + mi * W >= N / 64) continue;
#pragma unroll
    for (int jb = 0; jb < DH / 8; ++jb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = (wg + mi * W) * 64 + r0 + 8 * h;
        const int d = jb * 8 + q2;
        uint32_t hi, lo;
        split_bf16(hin[mi][jb][h].x, hin[mi][jb][h].y, hi, lo);
        *reinterpret_cast<uint32_t*>(hhi + swz(N, k, d)) = hi;
        *reinterpret_cast<uint32_t*>(hlo + swz(N, k, d)) = lo;
      }
  }
  fence_proxy_async();
  __syncthreads();

  // -- y = G X + exp(cum_i) C_i h_in ------------------------------------------
  float z[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) z[i] = 0.0f;
  if (chunk > 0) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t da = make_desc(cs_a + (kk / 4) * L * 128 + wg * 64 * 128 + (kk % 4) * 32,
                                    16, 1024);
      Wgmma<DH, kMNMajor>::mma(z, da, make_desc(smem_addr(hhi) + kk * 16 * 128, N * 128, 1024));
      Wgmma<DH, kMNMajor>::mma(z, da, make_desc(smem_addr(hlo) + kk * 16 * 128, N * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = ra + 8 * h;
    if (i >= lv) continue;
    const float ei = expf(cum[i]);
    __nv_bfloat16* orow = out + ((size_t)row * s + c0 + i) * DH;
#pragma unroll
    for (int jb = 0; jb < DH / 8; ++jb) {
      const int v = 4 * jb + 2 * h;
      *reinterpret_cast<uint32_t*>(orow + jb * 8 + q2) =
          pack_bf16(fmaf(ei, z[v], o[v]), fmaf(ei, z[v + 1], o[v + 1]));
    }
  }
}

template <int DH, int N, int L>
cudaError_t sm90_launch(const void* x, const void* dt, const void* B, const void* C,
                        const void* A, void* out, void* states, void* sync, void* entering,
                        int bh, int s, int heads, cudaStream_t stream) {
  CUtensorMap xmap, bmap, cmap;
  const int groups = bh / heads;
  if (!sm90::make_map(&xmap, x, DH, s, bh, L) || !sm90::make_map(&bmap, B, N, s, groups, L) ||
      !sm90::make_map(&cmap, C, N, s, groups, L))
    return cudaErrorInvalidValue;
  constexpr int smem = sm90_smem_bytes<DH, N, L>();
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_sm90_kernel<DH, N, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = bh * ((s + L - 1) / L);
  ssd_sm90_kernel<DH, N, L><<<grid, 2 * L, smem, stream>>>(
      xmap, bmap, cmap, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(states), static_cast<int*>(sync),
      static_cast<float*>(entering), bh, s, heads);
  return cudaGetLastError();
}

template <int DH, int N, int L>
cudaError_t sm90_attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, ssd_sm90_kernel<DH, N, L>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

cudaError_t sm90_dispatch(int dh, int n, int L, const void* x, const void* dt, const void* B,
                          const void* C, const void* A, void* out, void* states, void* sync,
                          void* entering, int bh, int s, int heads, cudaStream_t stream) {
#define SSD_SM90_CASE(DH, N, CH)                                                 \
  if (dh == DH && n == N && L == CH)                                             \
    return sm90_launch<DH, N, CH>(x, dt, B, C, A, out, states, sync, entering, bh, s, heads, \
                                  stream);
  SSD_SM90_TILES(SSD_SM90_CASE)
#undef SSD_SM90_CASE
  return cudaErrorInvalidValue;
}

cudaError_t sm90_dispatch_attributes(int dh, int n, int L, int* num_regs, int* max_threads,
                                     int* local_bytes) {
#define SSD_SM90_ATTR(DH, N, CH)                                                 \
  if (dh == DH && n == N && L == CH)                                             \
    return sm90_attributes<DH, N, CH>(num_regs, max_threads, local_bytes);
  SSD_SM90_TILES(SSD_SM90_ATTR)
#undef SSD_SM90_ATTR
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller has checked shapes, dtypes, alignment, the chunk and limits, and
// hands over the f32 state ring `states` and the zeroed integers `sync` (the
// ticket counter and one flag per chain), which the launch leaves zeroed.
// `entering`, when not null, receives each chunk's entering state, f32 (bh,
// ceil(s / chunk), n, dh), zeros for the first chunk: the tile the kernel
// reads from the chain, which the backward needs; y is the same either way.
// bf16 at a compiled (dh, n, chunk) runs the wgmma body (states (bh, 2, n,
// dh), bh * chunk / 16 flags); everything else the SIMT body (states
// (bh * dh / 16, 2, n, 16), bh * dh / 16 * 8 flags).  B and C are shared by
// `heads` consecutive rows.
int klaraptor_ssd_scan(const void* x, const void* dt, const void* B, const void* C,
                       const void* A, void* out, void* states, void* sync, void* entering,
                       int bh, int s, int dh, int n, int chunk, int heads, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return simt_launch<float>(x, dt, B, C, A, out, states, sync, entering, bh, s, dh, n,
                                chunk, heads, st);
    case kBF16:
      if (sm90_compiled(dh, n, chunk))
        return sm90_dispatch(dh, n, chunk, x, dt, B, C, A, out, states, sync, entering, bh,
                             s, heads, st);
      return simt_launch<__nv_bfloat16>(x, dt, B, C, A, out, states, sync, entering, bh, s,
                                        dh, n, chunk, heads, st);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// the SIMT instantiation for `dtype`.
int klaraptor_ssd_scan_attributes(int dtype, int* num_regs, int* max_threads,
                                  int* local_bytes) {
  switch (dtype) {
    case kF32: return simt_attributes<float>(num_regs, max_threads, local_bytes);
    case kBF16: return simt_attributes<__nv_bfloat16>(num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

// The same for the wgmma instantiation (dh, n, chunk).
int klaraptor_ssd_scan_tile_attributes(int dh, int n, int chunk, int* num_regs,
                                       int* max_threads, int* local_bytes) {
  return sm90_dispatch_attributes(dh, n, chunk, num_regs, max_threads, local_bytes);
}

const char* klaraptor_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
