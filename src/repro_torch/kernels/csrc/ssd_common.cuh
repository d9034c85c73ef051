// Pieces shared by the SSD scan's forward (csrc/ssd_scan.cu) and backward
// (csrc/ssd_scan_bwd.cu): the SIMT bodies' tile constants, f32 loads and
// stores of the input types, the chain of chunk states passed from CTA to
// CTA -- the ticket that orders the CTAs, and the per-warp flags a CTA
// waits on and publishes --, the wgmma bodies' compiled shapes and their
// bf16 helpers, and the backward's decay gradient, which both of its
// bodies end with.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

constexpr int kCols = 16;      // head-dim columns per SIMT CTA
constexpr int kRows = 32;      // rows of a SIMT score tile
constexpr int kGPad = 4;       // f32 words of padding per score-tile row
constexpr int kThreads = 256;  // SIMT CTA
constexpr int kVecBytes = 16;  // global loads are 16 bytes wide

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive values at p (8-byte aligned for bf16, 16 for f32) as f32.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Two consecutive values at p (4-byte aligned for bf16, 8 for f32) as f32,
// and their store.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// -- the chain of chunk states ------------------------------------------------

// Thread 0 draws the CTA's ticket; the last ticket of the launch resets the
// counter (every other ticket has been drawn by then).
__device__ __forceinline__ int draw_ticket(int* counter, int* slot, int total) {
  if (threadIdx.x == 0) {
    const int t = atomicAdd(counter, 1);
    if (t == total - 1) *counter = 0;
    *slot = t;
  }
  __syncthreads();
  return *slot;
}

// The chain's flags are per warp: warp w of a chunk reads and writes the
// same state elements as warp w of the chunks before and after it, so it
// waits on and releases only its own flag, with no block-wide barrier on
// the chain's path.
//
// Lane 0 spins until the warp's flag reaches `target`; then the warp.  The
// predecessor is always running or done, so the wait ends; a spin that
// outlasts seconds means a broken chain, and traps (the launch fails)
// instead of hanging the card.
__device__ __forceinline__ void wait_flag(const int* flag, int target) {
  if ((threadIdx.x & 31) == 0) {
    int v;
    long long spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                   : "=r"(v) : "l"(flag) : "memory");
      if (++spins > (1ll << 25)) __trap();
    } while (v < target);
  }
  __syncwarp();
}

// After the warp's state stores: the warp's barrier, then one gpu-scope
// fence and the flag's store by lane 0 (the chain's last chunk sets it back
// to 0).  The fence is cumulative: it orders the other lanes' stores, which
// the barrier ordered before it, so no lane needs a fence of its own on the
// chain's path (the pattern of CUTLASS's release on a barrier).
__device__ __forceinline__ void publish_flag(int* flag, int value) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    asm volatile("fence.acq_rel.gpu;\n"
                 "st.relaxed.gpu.global.s32 [%0], %1;\n"
                 :: "l"(flag), "r"(value) : "memory");
}

// Running sum of a * dts[0..L) into cum (warp 0; the caller syncs).
__device__ __forceinline__ void running_sum(const float* dts, float* cum, float a, int L) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.0f;
    for (int base = 0; base < L; base += 32) {
      float v = a * dts[base + lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += up;
      }
      v += carry;
      cum[base + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// Rows [0, rows) of a row-major (rows, n) tile at src into dst[n][rows]
// (transposed); rows at or past `valid` are zero.  Consecutive threads take
// consecutive rows, so the transposed shared-memory writes do not conflict.
template <typename T>
__device__ __forceinline__ void stage_transposed(T* dst, const T* src, int rows, int n,
                                                 int valid) {
  constexpr int V = kVecBytes / sizeof(T);
  const int vecs = rows * (n / V);
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    const int row = i % rows;
    const int c = (i / rows) * V;
    uint4 pack = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid) pack = *reinterpret_cast<const uint4*>(src + (size_t)row * n + c);
    const T* e = reinterpret_cast<const T*>(&pack);
#pragma unroll
    for (int t = 0; t < V; ++t) dst[(c + t) * rows + row] = e[t];
  }
}

// -- the wgmma bodies ----------------------------------------------------------

// The compiled wgmma instantiations (dh, n, chunk) of the forward and the
// backward: kernel_spec.py's SSD_SM90_SHAPES x SSD_SM90_CHUNKS.
#define SSD_SM90_TILES(X) X(64, 128, 64) X(64, 128, 128)

// 1 if (dh, n, chunk) has a wgmma instantiation.
inline bool sm90_compiled(int dh, int n, int L) {
#define SSD_SM90_HAS(DH, N, CH) if (dh == DH && n == N && L == CH) return true;
  SSD_SM90_TILES(SSD_SM90_HAS)
#undef SSD_SM90_HAS
  return false;
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

// Byte offset of element (row, col) of a [cols / 64][rows][64] bf16 tile
// whose 128-byte rows hold their 16-byte chunks XOR-permuted by row % 8 (the
// TMA's 128-byte swizzle).
__device__ __forceinline__ int swz(int rows, int row, int col) {
  return (col / 64) * rows * 128 + row * 128 + ((((col % 64) / 8) ^ (row % 8)) * 16) +
         (col % 8) * 2;
}

// -- the backward's decay gradient ----------------------------------------------

// The decay exponents' gradient of one chunk of lv valid rows, by warp 0
// (the caller syncs before): with the per-row terms in shared memory --
// rowp_i = sum_j P_ij, colv_j = sum_i G_ij M_ij, qv_i = exp(cum_i) dy_i .
// (C_i h_in), rv_j = R_j, dt, cum and w -- and hdot = <h_in, dh_out>,
//   dcum_i = rowp_i - dt_i colv_i + qv_i - w_i rv_i,
//   dtotal = sum_j w_j rv_j + exp(total) hdot, added to the last entry,
//   rev_t  = sum_{i >= t} dcum_i (a reverse running sum, 32 rows a step),
// it writes ddt_t = colv_t + exp(total - cum_t) rv_t + a rev_t into dtp[t]
// (t < lv) and this chunk's share of dA, sum_t dt_t rev_t, into *da_out.
__device__ __forceinline__ void decay_gradient(const float* rowp, const float* colv,
                                               const float* qv, const float* rv,
                                               const float* dts, const float* cum,
                                               const float* wts, int lv, float total,
                                               float a, float hdot, float* dtp,
                                               float* da_out) {
  const int lane = threadIdx.x & 31;
  float wr = 0.0f;                                // sum_j w_j R_j
  for (int i = lane; i < lv; i += 32) wr = fmaf(wts[i], rv[i], wr);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wr += __shfl_xor_sync(0xffffffffu, wr, off);
  float carry = wr + expf(total) * hdot;          // dtotal, on the last entry
  float da = 0.0f;
  for (int base = ((lv + 31) & ~31) - 32; base >= 0; base -= 32) {
    const int i = base + lane;
    float v = i < lv ? rowp[i] - dts[i] * colv[i] + qv[i] - wts[i] * rv[i] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {      // suffix sum within the warp
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
  if (lane == 0) *da_out = da;
}

}  // namespace ssd
