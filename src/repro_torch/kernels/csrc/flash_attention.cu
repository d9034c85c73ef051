// Flash attention forward for Hopper (sm_90a):
//   out[bh, i, :] = softmax_j(scale * q[bh, i, :] . k[kvh, j, :]) v[kvh, j, :]
// with causal masking, GQA, a sliding window and logit soft-capping.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel), the TPU kernel with grid (b*hq, q blocks, kv blocks), the kv
// axis sequential and (m, l, acc) carried in f32 VMEM scratch.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM3): at a
// prefill shape (32 q heads, 4096 tokens, head dim 64, causal) the function
// does 2 * d FLOPs per visible (query, key) pair for QK^T and as many for PV,
// about 69 GFLOP, on 4096 * 64 * (32 + 16) elements in and 4096 * 64 * 32
// out, tens of MB: thousands of FLOPs per byte, so it is bound by operations,
// and the roofline takes the bf16 tensor-core rate.
//
// Two bodies, one C interface.
//
// bf16 at head dims 64, 128 and 256 -- flash_sm90_kernel, the tensor-core
// design.
// One CTA per (b * hq, block of BQ query rows) with one consumer warpgroup
// (128 threads) per 64 rows, so BQ = 64 or 128 means 1 or 2 warpgroups.
//   * Thread 0 issues every TMA load (csrc/sm90.cuh): the (BQ, D) Q tile once,
//     and the (BKV, D) K and V tiles of each kv step into a ring of kStages
//     slots with full and empty mbarriers, the protocol of gemm_sm90.cuh.
//     The tensor maps are 3-D, over (d, s, b * heads): a ragged q or kv tail
//     is zero-filled at sq or skv, never read from the next head's rows.
//     128-byte swizzle; a tile of D = 128 or 256 is two or four 64-wide
//     boxes side by side.
//   * S = Q K^T: wgmma.m64n{BKV}k16, D / 16 steps, both operands in shared
//     memory.  Q is K-major for A; K stored (BKV, D) row-major is K-major for
//     B too, so its descriptor has the transpose bit clear.
//   * The online softmax runs in registers on S's accumulator fragment: thread
//     t of a warpgroup holds rows 16 (t / 32) + (t % 32) / 4 and eight below,
//     BKV / 4 columns of each; the row max reduces over the 4 threads of a
//     quad (__shfl_xor_sync 1 and 2), the row sum stays per thread until the
//     end.  Scores are kept in the log2 domain (ex2 on the SFU).
//   * O += P V: P is converted to bf16 in registers and fed as wgmma's A
//     operand from registers (wgmma.m64n{D}k16, BKV / 16 steps), as two
//     bf16 terms, P = hi + lo, each with V, so the product keeps P to about
//     2^-17, as the Pallas kernel keeps it in f32.  At D = 256 that is
//     wgmma.m64n256k16 (WgmmaRS<256>), V's four boxes in one descriptor
//     whose leading byte offset steps from box to box.  No shuffle
//     is needed: for 16-bit inputs the accumulator fragment of columns
//     [16 kk, 16 kk + 16) -- s[8kk .. 8kk+7] = (row r, cols c, c+1), (r + 8,
//     c, c+1), (r, c+8, c+9), (r + 8, c+8, c+9) with c = 16 kk + 2 (t % 4) --
//     is exactly the A fragment {a0, a1, a2, a3} of k step kk.  V stored
//     (BKV, D) row-major is (k, n) row-major, MN-major for B, and goes in
//     through the transpose bit as gemm_sm90.cuh's y does.  O is rescaled by
//     alpha before each PV group.
//   * The epilogue divides by l, converts to bf16, stages the warpgroup's rows
//     in its own rows of the Q tile (XOR-swizzled 16-byte chunks, so the
//     fragment stores do not conflict) and writes whole rows with 16-byte
//     stores, clipped at sq.
//   * Why two terms: with P rounded once to bf16 (the JAX oracle
//     flash_attention_ref's arithmetic, p cast to v's dtype) each layer's
//     output agrees within the bf16 tolerance, but llama3.2-1b's prefill
//     logits drifted to 5.1e-2 of max |logit| from the plain-attention step
//     after 16 layers, past the 5e-2 gate; the lo term costs BKV / 16 more
//     wgmmas per kv step.
// (D, BQ, BKV) are template parameters (wgmma's N is an immediate); the
// caller dispatches from FLASH_SM90_TILES.  Warp specialisation (a producer
// warp with setmaxnreg) and two consumer warpgroups ping-ponging softmax
// against wgmma are later work.
//   * Head dim 256 (gemma2) is the same body; registers and shared memory
//     bound it.  Per thread of a consumer warpgroup at BKV = 64: O is
//     64 x 256 f32 / 128 threads = 128 registers, S 64 x 64 / 128 = 32, and
//     P's hi + lo A fragments BKV / 16 x 4 x 2 = 32, which replace S as it is
//     split, so at most 160 hold data; with m, l, alpha, the row and key
//     positions and the descriptors ptxas gives both tiles 251 of the 255
//     that __launch_bounds__(256, 1) allows, with no spill (chip_smoke.py
//     [2] gates it).  BKV = 128 would need 256 for O, S and P alone, and its
//     two-slot ring, (BQ + 4 * 128) * 256 * 2 bytes, is over the 227 KiB a
//     block may have; so at D = 256 the tiles are BQ 64 or 128 with BKV 64,
//     164904 or 197672 bytes of shared memory and one CTA per SM.  Per kv
//     step a warpgroup issues 16 m64n64k16 for S and 2 x 4 m64n256k16 for
//     P V: the lo term makes PV twice the work the bound counts, so the
//     tensor cores do 3 / 2 of the bound's operations.
//   * The softmax's instructions sit between the two products of every kv
//     step, so they are kept few: 2^x and 1 / x are single SFU instructions
//     (ex2.approx.ftz, rcp.approx.ftz), the soft cap is tanh through them
//     with its constants folded into one multiply and one FFMA, and O is
//     rescaled only when a row's running max moved, which a long row's later
//     kv steps seldom do.
//
// f32 -- flash_fwd_kernel, the SIMT body: wgmma takes f32 only as TF32.
// One CTA per (b * hq, block of bq query rows) loops over kv blocks
// of BKV rows with 4 * bq threads: 16 lanes across each group of 4 query rows,
// so a thread owns 4 rows, BKV / 16 columns of the score tile and d / 16
// columns of the output.  Q (bq, d) is staged in shared memory once, K and V
// (BKV, d) per iteration, and the f32 probability tile (bq, BKV + 16) goes
// through shared memory between the two products; m, l and the output
// accumulator stay in registers, and both products are FP32 FMAs.  bq is a
// launch parameter taken at run time and sets the thread count; BKV (32, 64
// or 128) is a template parameter.
//
// Both bodies can also write lse, the natural-log log-sum-exp of each row's
// scaled, masked (and soft-capped) scores, f32 (bh, sq), -inf for a row that
// sees no key: what the backward kernel (flash_attention_bwd.cu) recomputes P
// from.  It is written in the epilogue, where the final m and l are known; a
// null lse pointer writes nothing, so serving launches are unchanged.
//
// Both bodies keep the reference's masking: rows with no visible key give 0;
// the running max starts at -1e30 and masked probabilities are exactly 0, so a
// row whose first kv blocks are all masked never takes exp of a NaN;
// soft-capping applies before masking.  Unlike the TPU kernel, kv blocks
// wholly above the causal diagonal or wholly outside the window are skipped,
// q blocks run longest causal rows first, the masks are evaluated only on
// blocks that straddle the diagonal, the window edge or skv, and ragged q and
// kv tails are masked, so no shape needs padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kRows = 4;        // query rows per thread
constexpr int kLanes = 16;      // threads across a row group (half a warp)
constexpr int kPad = 16;        // f32 words of padding per P row: the two
                                // half-warps' rows land 16 banks apart
constexpr int kVecBytes = 16;   // global loads are 16 bytes wide
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

template <int D> struct Bounds { static constexpr int kMaxThreads = 512; };
template <> struct Bounds<256> { static constexpr int kMaxThreads = 256; };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// Copy rows [0, rows) of a row-major (rows, D) tile at src into dst[D][rows]
// (transposed); rows at or past `valid` are zero.  Consecutive threads take
// consecutive rows, so the transposed shared-memory writes do not conflict.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(T* dst, const T* src, int rows,
                                                 int valid) {
  constexpr int V = kVecBytes / sizeof(T);
  const int vecs = rows * (D / V);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const int row = i % rows;
    const int dc = (i / rows) * V;
    uint4 pack = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid) pack = *reinterpret_cast<const uint4*>(src + (size_t)row * D + dc);
    const T* e = reinterpret_cast<const T*>(&pack);
#pragma unroll
    for (int t = 0; t < V; ++t) dst[(dc + t) * rows + row] = e[t];
  }
}

// Copy rows [0, rows) of a row-major (rows, D) tile at src into dst[rows][D];
// rows at or past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows, int valid) {
  constexpr int V = kVecBytes / sizeof(T);
  const int vecs = rows * (D / V);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const int row = i / (D / V);
    const int dc = (i % (D / V)) * V;
    uint4 pack = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid) pack = *reinterpret_cast<const uint4*>(src + (size_t)row * D + dc);
    *reinterpret_cast<uint4*>(dst + row * D + dc) = pack;
  }
}

// Max and sum over the 16 lanes that share a row group.
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q: (bh, sq, D); k, v: (bh / hq * hkv, skv, D); out: (bh, sq, D), all
// contiguous and 16-byte aligned.  blockDim.x == 4 * bq, bq % 16 == 0,
// gridDim = (ceil(sq / bq), bh).  softcap <= 0 means no soft-capping.
template <typename T, int D, int BKV>
__global__ void __launch_bounds__(Bounds<D>::kMaxThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int skv,
                 int hq, int hkv, int bq, float scale, int causal,
                 int has_window, int window, float softcap) {
  constexpr int NS = BKV / kLanes;   // score columns per thread
  constexpr int NC = D / kLanes;     // output columns per thread
  constexpr int PS = BKV + kPad;     // row stride of the P tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                    // [D][bq]
  T* ks = qs + D * bq;                                   // [D][BKV]
  T* vs = ks + D * BKV;                                  // [BKV][D]
  float* ps = reinterpret_cast<float*>(vs + BKV * D);    // [bq][PS]

  const int tr = threadIdx.x / kLanes;
  const int tc = threadIdx.x % kLanes;
  const int rstep = bq / kRows;                 // thread row groups
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;   // longest causal rows first
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const T* kg = k + (size_t)kvh * skv * D;
  const T* vg = v + (size_t)kvh * skv * D;

  stage_transposed<T, D>(qs, q + ((size_t)bh * sq + q0) * D, bq, sq - q0);

  // The kv blocks any row of this q block can see.
  int kv_begin = 0;
  int kv_end = skv;
  if (causal) kv_end = min(skv, q0 + bq);
  if (has_window) {
    const long long lo = (long long)q0 - window + 1;  // first key row q0 sees
    if (lo > 0) kv_begin = (int)min(lo / BKV * BKV, (long long)skv);
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    stage_transposed<T, D>(ks, kg + (size_t)k0 * D, BKV, skv - k0);
    stage_rows<T, D>(vs, vg + (size_t)k0 * D, BKV, skv - k0);
    __syncthreads();

    float s[kRows][NS];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float a[kRows], b[NS];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = to_f32(qs[dd * bq + tr + i * rstep]);
#pragma unroll
      for (int j = 0; j < NS; ++j) b[j] = to_f32(ks[dd * BKV + tc + j * kLanes]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = tr + i * rstep;
      const int qpos = q0 + row;
      unsigned visible = 0u;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int kpos = k0 + tc + j * kLanes;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool vis = kpos < skv;
        if (causal) vis = vis && qpos >= kpos;
        if (has_window) vis = vis && qpos - kpos < window;
        s[i][j] = x;
        if (vis) {
          visible |= 1u << j;
          row_max = fmaxf(row_max, x);
        }
      }
      const float m_new = fmaxf(m[i], group_max(row_max));
      const float alpha = expf(m[i] - m_new);   // both finite: never NaN
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p = (visible >> j) & 1u ? expf(s[i][j] - m_new) : 0.0f;
        ps[row * PS + tc + j * kLanes] = p;
        row_sum += p;
      }
      l[i] = alpha * l[i] + group_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float p[kRows], w[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(tr + i * rstep) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) w[c] = to_f32(vs[j * D + tc + c * kLanes]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + tr + i * rstep;
    if (qpos >= sq) continue;
    const float denom = l[i] > 0.0f ? l[i] : 1.0f;   // no visible key: acc is 0
    if (lse != nullptr && tc == 0)
      lse[(size_t)bh * sq + qpos] = l[i] > 0.0f ? m[i] + logf(l[i]) : -INFINITY;
    T* o = out + ((size_t)bh * sq + qpos) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tc + c * kLanes] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D, int BKV>
size_t smem_bytes(int bq) {
  return (size_t)(bq + 2 * BKV) * D * sizeof(T) + (size_t)bq * (BKV + kPad) * sizeof(float);
}

template <typename T, int D, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                   int sq, int skv, int hq, int hkv, int bq, float scale, int causal,
                   int has_window, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, BKV>(bq);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + bq - 1) / bq, bh);
  const dim3 block(bq * kLanes / kRows);
  flash_fwd_kernel<T, D, BKV><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, skv, hq, hkv, bq, scale, causal, has_window, window,
      softcap);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bkv(int bkv, const void* q, const void* k, const void* v, void* out,
                       float* lse, int bh, int sq, int skv, int hq, int hkv, int bq, float scale,
                       int causal, int has_window, int window, float softcap,
                       cudaStream_t stream) {
  switch (bkv) {
    case 32: return launch<T, D, 32>(q, k, v, out, lse, bh, sq, skv, hq, hkv, bq, scale,
                                     causal, has_window, window, softcap, stream);
    case 64: return launch<T, D, 64>(q, k, v, out, lse, bh, sq, skv, hq, hkv, bq, scale,
                                     causal, has_window, window, softcap, stream);
    case 128: return launch<T, D, 128>(q, k, v, out, lse, bh, sq, skv, hq, hkv, bq, scale,
                                       causal, has_window, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int d, int bkv, const void* q, const void* k, const void* v,
                     void* out, float* lse, int bh, int sq, int skv, int hq, int hkv, int bq,
                     float scale, int causal, int has_window, int window, float softcap,
                     cudaStream_t stream) {
  switch (d) {
    case 64: return launch_bkv<T, 64>(bkv, q, k, v, out, lse, bh, sq, skv, hq, hkv, bq, scale,
                                      causal, has_window, window, softcap, stream);
    case 128: return launch_bkv<T, 128>(bkv, q, k, v, out, lse, bh, sq, skv, hq, hkv, bq, scale,
                                        causal, has_window, window, softcap, stream);
    case 256: return launch_bkv<T, 256>(bkv, q, k, v, out, lse, bh, sq, skv, hq, hkv, bq, scale,
                                        causal, has_window, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D, int BKV>
cudaError_t attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd_kernel<T, D, BKV>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t attributes_bkv(int bkv, int* num_regs, int* max_threads, int* local_bytes) {
  switch (bkv) {
    case 32: return attributes<T, D, 32>(num_regs, max_threads, local_bytes);
    case 64: return attributes<T, D, 64>(num_regs, max_threads, local_bytes);
    case 128: return attributes<T, D, 128>(num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t attributes_d(int d, int bkv, int* num_regs, int* max_threads,
                         int* local_bytes) {
  switch (d) {
    case 64: return attributes_bkv<T, 64>(bkv, num_regs, max_threads, local_bytes);
    case 128: return attributes_bkv<T, 128>(bkv, num_regs, max_threads, local_bytes);
    case 256: return attributes_bkv<T, 256>(bkv, num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16, head dims 64, 128 and 256: the wgmma + TMA-ring body
// ---------------------------------------------------------------------------

constexpr int kStages = 2;             // K/V slots of the TMA ring
constexpr int kSm90Threads = 256;      // at most two consumer warpgroups
// Dynamic shared memory beyond Q and the ring: the 1 KiB alignment slack and
// the full, empty and Q barriers.
constexpr int kSm90SmemExtra = sm90::kAlign + (2 * kStages + 1) * 8;
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int BQ, int BKV>
constexpr int sm90_smem_bytes() {
  return (BQ + 2 * kStages * BKV) * D * 2 + kSm90SmemExtra;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as a bf16 pair hi and the bf16 pair lo of what hi leaves out:
// hi + lo holds a and b to about 2^-17 of their size.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// 2^x and 1 / x on the special function unit, one instruction each (relative
// error about 2^-22; denormals flush to 0, and 2^-inf is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of the 16-byte chunk (row, chunk) of a [D / 64][rows][64] bf16
// tile whose 128-byte rows hold their chunks XOR-permuted by row % 8.
__device__ __forceinline__ int staged_chunk(int rows, int row, int chunk) {
  return (chunk / 8) * rows * 128 + row * 128 + (((chunk % 8) ^ (row % 8)) * 16);
}

// q: (bh, sq, D) through qmap; k, v: (bh / hq * hkv, skv, D) through kmap and
// vmap; out: (bh, sq, D) row-major, 16-byte aligned.  blockDim.x == 2 * BQ,
// gridDim = (ceil(sq / BQ), bh).  softcap <= 0 means no soft-capping.
template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int sq,
                  int skv, int hq, int hkv, float scale, int causal, int has_window,
                  int window, float softcap) {
  using namespace sm90;
  static_assert(D % kAtom == 0 && D <= 256, "whole swizzle boxes, wgmma N <= 256");
  static_assert(BQ % 64 == 0 && BQ <= 128, "one warpgroup per 64 rows, at most two");
  static_assert(BKV % 64 == 0 && BKV <= 128, "wgmma N and the score registers");
  constexpr int kQBytes = BQ * D * 2;
  constexpr int kKVBytes = BKV * D * 2;         // one K or one V tile
  constexpr int kSlotBytes = 2 * kKVBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* qs = smem;                                   // [D/64][BQ][64]
  unsigned char* ring = smem + kQBytes;                       // [kStages][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlotBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = t % 32;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal rows first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);

  // The kv blocks any row of this q block can see.
  int kv_begin = 0;
  int kv_end = causal ? min(skv, q0 + BQ) : skv;
  if (has_window) {
    const long long lo = (long long)q0 - window + 1;  // first key row q0 sees
    if (lo > 0) kv_begin = (int)min(lo / BKV * BKV, (long long)skv);
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  auto load_kv = [&](int it, int s) {
    unsigned char* ks = ring + s * kSlotBytes;
    const int k0 = kv_begin + it * BKV;
    mbar_expect_tx(&full[s], kSlotBytes);
#pragma unroll
    for (int b = 0; b < D / kAtom; ++b) {
      tma_load(ks + b * BKV * 128, &kmap, &full[s], b * kAtom, k0, kvh);
      tma_load(ks + kKVBytes + b * BKV * 128, &vmap, &full[s], b * kAtom, k0, kvh);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], blockDim.x);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, kQBytes);
#pragma unroll
    for (int b = 0; b < D / kAtom; ++b)
      tma_load(qs + b * BQ * 128, &qmap, qbar, b * kAtom, q0, bh);
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, s);
  }

  // Scores in the log2 domain: x = scale * s, or soft-capped softcap *
  // tanh(scale * s / softcap), times log2(e).  The cap goes through
  // tanh(y) = 1 - 2 / (2^(2 y log2(e)) + 1): x = post - 2 post / (2^(pre s)
  // + 1), two SFU instructions and an FFMA, within a few 1e-7 of tanhf
  // (times post); an overflowed 2^ gives x = post, the cap itself.
  const bool capped = softcap > 0.0f;
  const float pre = capped ? 2.0f * kLog2e * scale / softcap : scale * kLog2e;
  const float post = softcap * kLog2e;
  const int qa = q0 + wg * 64;                          // this warpgroup's first row
  const int row0 = qa + (t / 32) * 16 + lane / 4;       // rows row0 and row0 + 8

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  mbar_wait(qbar, 0);
  const uint32_t q_base = smem_addr(qs) + wg * 64 * 128;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t k_base = smem_addr(ring + s * kSlotBytes);
    const uint32_t v_base = k_base + kKVBytes;

    float sc[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = make_desc(q_base + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = make_desc(k_base + (kk / 4) * BKV * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma<BKV, kKMajor>::mma(sc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();

    const int k0 = kv_begin + it * BKV;
    const bool masked = k0 + BKV > skv || (causal && k0 + BKV - 1 > qa) ||
                        (has_window && qa + 63 - k0 >= window);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row0 + 8 * h;
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * h + e] * pre;
          if (capped) x = fmaf(rcp(ex2(x) + 1.0f), -2.0f * post, post);
          if (masked) {
            const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
            bool vis = kpos < skv;
            if (causal) vis = vis && qpos >= kpos;
            if (has_window) vis = vis && qpos - kpos < window;
            if (!vis) x = __uint_as_float(0xff800000u);   // -inf: p = 0 exactly
          }
          sc[4 * j + 2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[h] = ex2(m[h] - mx);                       // both finite: never NaN
      m[h] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(sc[4 * j + 2 * h + e] - mx);
          sc[4 * j + 2 * h + e] = p;
          sum += p;
        }
      }
      l[h] = alpha[h] * l[h] + sum;
    }
    // O's rescale (D / 2 multiplies) only where a row's max moved: once the
    // running maxima settle, most kv steps of a long row skip it.
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }

    // P = hi + lo, two bf16 A fragments: the PV product at f32 precision
    uint32_t hi[BKV / 16][4], lo[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t db = make_desc(v_base + kk * 16 * 128, BKV * 128, 1024);
      WgmmaRS<D>::mma(o, hi[kk], db);
      WgmmaRS<D>::mma(o, lo[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // this slot's K and V are consumed: release it, and refill it
    mbar_arrive(&empty[s]);
    if (tid == 0 && it + kStages < n_tiles) {
      mbar_wait(&empty[s], (it / kStages) & 1);
      load_kv(it + kStages, s);
    }
  }

  // Epilogue: O / l in bf16, staged in this warpgroup's rows of the Q tile,
  // then whole rows out with 16-byte stores.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[h] = sum > 0.0f ? 1.0f / sum : 0.0f;   // no visible key: o is 0
    // m is in the log2 domain: lse = (m + log2 l) ln 2
    if (lse != nullptr && lane % 4 == 0 && row0 + 8 * h < sq)
      lse[(size_t)bh * sq + row0 + 8 * h] =
          sum > 0.0f ? (m[h] + log2f(sum)) / kLog2e : -INFINITY;
  }
  __syncthreads();   // every warpgroup's wgmmas are done with Q
  const int rl = (t / 32) * 16 + lane / 4;     // local row in the warpgroup
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + rl + 8 * h;
      *reinterpret_cast<uint32_t*>(qs + staged_chunk(BQ, r, j) + (lane % 4) * 4) =
          pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
    }
  __syncthreads();
  for (int i = t; i < 64 * (D / 8); i += 128) {
    const int r = wg * 64 + i / (D / 8);
    const int chunk = i % (D / 8);
    const int qpos = q0 + r;
    if (qpos < sq)
      *reinterpret_cast<uint4*>(out + ((size_t)bh * sq + qpos) * D + chunk * 8) =
          *reinterpret_cast<const uint4*>(qs + staged_chunk(BQ, r, chunk));
  }
}

template <int D, int BQ, int BKV>
cudaError_t sm90_launch(const void* q, const void* k, const void* v, void* out, float* lse,
                        int bh, int sq, int skv, int hq, int hkv, float scale, int causal,
                        int has_window, int window, float softcap,
                        cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const int bhkv = bh / hq * hkv;
  if (!sm90::make_map(&qmap, q, D, sq, bh, BQ) ||
      !sm90::make_map(&kmap, k, D, skv, bhkv, BKV) ||
      !sm90::make_map(&vmap, v, D, skv, bhkv, BKV))
    return cudaErrorInvalidValue;
  constexpr int smem = sm90_smem_bytes<D, BQ, BKV>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<D, BQ, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_sm90_kernel<D, BQ, BKV><<<grid, 2 * BQ, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, sq, skv, hq, hkv, scale,
      causal, has_window, window, softcap);
  return cudaGetLastError();
}

template <int D, int BQ, int BKV>
cudaError_t sm90_attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, flash_sm90_kernel<D, BQ, BKV>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

// The compiled wgmma tiles (D, BQ, BKV): BQ and BKV in {64, 128} at head
// dims 64 and 128; at 256 only BKV 64, whose ring fits the shared memory
// (kernel_spec.FLASH_SM90_TILES).
#define FLASH_SM90_TILES(X)                                                    \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128)                  \
  X(128, 64, 64) X(128, 64, 128) X(128, 128, 64) X(128, 128, 128)              \
  X(256, 64, 64) X(256, 128, 64)

// Launches the instantiation of (d, bq, bkv); cudaErrorInvalidValue for a
// tile that is not compiled.
cudaError_t sm90_dispatch(int d, int bq, int bkv, const void* q, const void* k,
                          const void* v, void* out, float* lse, int bh, int sq, int skv, int hq,
                          int hkv, float scale, int causal, int has_window, int window,
                          float softcap, cudaStream_t stream) {
#define FLASH_SM90_CASE(D, BQ, BKV)                                             \
  if (d == D && bq == BQ && bkv == BKV)                                         \
    return sm90_launch<D, BQ, BKV>(q, k, v, out, lse, bh, sq, skv, hq, hkv,      \
                                   scale, causal, has_window, window, softcap,  \
                                   stream);
  FLASH_SM90_TILES(FLASH_SM90_CASE)
#undef FLASH_SM90_CASE
  return cudaErrorInvalidValue;
}

cudaError_t sm90_dispatch_attributes(int d, int bq, int bkv, int* num_regs,
                                     int* max_threads, int* local_bytes) {
#define FLASH_SM90_ATTR(D, BQ, BKV)                                             \
  if (d == D && bq == BQ && bkv == BKV)                                         \
    return sm90_attributes<D, BQ, BKV>(num_regs, max_threads, local_bytes);
  FLASH_SM90_TILES(FLASH_SM90_ATTR)
#undef FLASH_SM90_ATTR
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller has checked shapes, dtypes, alignment, tiles and limits.  bf16
// runs the wgmma body ((bq, bkv) a compiled tile of head dim d); f32 the
// SIMT body.  lse is null or f32 (bh, sq).
int klaraptor_flash_attention(const void* q, const void* k, const void* v, void* out,
                              void* lse, int bh, int sq, int skv, int d, int hq, int hkv, int bq,
                              int bkv, float scale, int causal, int has_window,
                              int window, float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_d<float>(d, bkv, q, k, v, out, static_cast<float*>(lse), bh, sq,
                             skv, hq, hkv, bq, scale, causal, has_window, window,
                             softcap, s);
    case kBF16:
      return sm90_dispatch(d, bq, bkv, q, k, v, out, static_cast<float*>(lse), bh, sq,
                           skv, hq, hkv, scale, causal, has_window, window, softcap,
                           s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// the SIMT instantiation for (dtype, head dim d, bkv): f32 only.
int klaraptor_flash_attention_attributes(int dtype, int d, int bkv, int* num_regs,
                                         int* max_threads, int* local_bytes) {
  if (dtype != kF32) return cudaErrorInvalidValue;
  return attributes_d<float>(d, bkv, num_regs, max_threads, local_bytes);
}

// The same for the wgmma instantiation of bf16 tile (d, bq, bkv).
int klaraptor_flash_attention_tile_attributes(int d, int bq, int bkv, int* num_regs,
                                              int* max_threads, int* local_bytes) {
  return sm90_dispatch_attributes(d, bq, bkv, num_regs, max_threads, local_bytes);
}

const char* klaraptor_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
