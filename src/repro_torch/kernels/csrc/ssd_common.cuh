// Pieces shared by the SSD scan's forward (csrc/ssd_scan.cu) and backward
// (csrc/ssd_scan_bwd.cu): the SIMT bodies' tile constants, f32 loads and
// stores of the input types, and the chain of chunk states passed from CTA
// to CTA -- the ticket that orders the CTAs, and the per-warp flags a CTA
// waits on and publishes.

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

}  // namespace ssd
