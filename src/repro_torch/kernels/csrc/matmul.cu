// Tiled matrix product for Hopper (sm_90a): C[m, n] = x[m, k] @ y[k, n].
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (body _matmul_kernel),
// the TPU kernel that tiles (bm, bn, bk) over a grid (i, j, l) with the k
// axis sequential and an f32 VMEM accumulator.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s FP32 on the
// CUDA cores, 3.35 TB/s HBM3): at the GEMM shapes the tuner serves (m = 4096
// tokens, n and k in the thousands) the product does 2*m*n*k FLOPs on
// (mk + kn + mn) elements, hundreds of FLOPs per byte, so it is bound by
// operations, not bytes.  The roofline takes the bf16 tensor-core rate.
//
// What this design does about it: two bodies, one per input type.
//   * bf16 inputs run the Hopper mainloop of csrc/gemm_sm90.cuh: wgmma on
//     the tensor cores, fed by a 4-slot TMA ring, one or two consumer
//     warpgroups (2 * bm threads), f32 accumulators in registers and the
//     result cast once to the output type (f32, bf16 or f16, chosen at run
//     time).  (bm, bn, bk) are template instantiations, the nine tiles of
//     GEMM_SM90_TILES; the C entry point dispatches to them.
//   * f32 inputs keep the SIMT body below: wgmma takes f32 only as TF32,
//     whose ten mantissa bits would break the 2e-4 f32 tolerance the port
//     holds to.  Each CTA computes one (bm, bn) tile of C and loops over k
//     inside the block (where the TPU had a sequential grid axis).  Per
//     iteration it stages a (bm, bk) tile of x (transposed) and a (bk, bn)
//     tile of y in dynamic shared memory with 16-byte vector loads, then
//     every thread accumulates an 8 x 8 micro-tile of C with FP32 FMAs from
//     registers.  bm, bn and bk are taken at run time: the CTA has
//     (bm / 8) * (bn / 8) threads.  It is capped at the FP32 rate of the
//     CUDA cores (67 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

constexpr int kMicro = 8;          // each thread owns a kMicro x kMicro block of C
constexpr int kMaxThreads = 512;   // launch bound: caps registers at 128/thread
constexpr int kVecBytes = 16;      // global and shared loads are 16 bytes wide

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Requires m % bm == n % bn == k % bk == 0, bm % 8 == bn % 8 == bk % 8 == 0,
// 16-byte aligned x and y, and blockDim.x == (bm / 8) * (bn / 8).
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kMaxThreads)
matmul_kernel(const Tin* __restrict__ x, const Tin* __restrict__ y,
              Tout* __restrict__ out, int m, int n, int k, int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tin* xs = reinterpret_cast<Tin*>(smem);  // [bk][bm]: x tile, transposed
  Tin* ys = xs + bk * bm;                  // [bk][bn]: y tile
  constexpr int V = kVecBytes / sizeof(Tin);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rows = bm / kMicro;            // thread rows in the CTA
  const int cols = bn / kMicro;            // thread columns in the CTA
  const int tr = tid / cols;
  const int tc = tid % cols;
  const int m0 = blockIdx.y * bm;
  const int n0 = blockIdx.x * bn;
  (void)m;

  // Thread (tr, tc) owns rows tr + i * rows and columns tc + j * cols of the
  // tile: neighbouring threads read neighbouring shared-memory words and
  // write neighbouring columns of C.
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  const int x_vecs = bm * (bk / V);
  const int y_vecs = bk * (bn / V);
  for (int k0 = 0; k0 < k; k0 += bk) {
    // x tile: consecutive threads take consecutive rows, 16 bytes along k
    // each, and store them transposed (conflict-free column writes).
    for (int v = tid; v < x_vecs; v += nthreads) {
      const int row = v % bm;
      const int kc = (v / bm) * V;
      const uint4 pack = *reinterpret_cast<const uint4*>(
          x + (size_t)(m0 + row) * k + k0 + kc);
      const Tin* e = reinterpret_cast<const Tin*>(&pack);
#pragma unroll
      for (int t = 0; t < V; ++t) xs[(kc + t) * bm + row] = e[t];
    }
    // y tile: row-major as in memory, 16-byte vectors along n.
    for (int v = tid; v < y_vecs; v += nthreads) {
      const int kr = v / (bn / V);
      const int nc = (v % (bn / V)) * V;
      *reinterpret_cast<uint4*>(ys + kr * bn + nc) =
          *reinterpret_cast<const uint4*>(y + (size_t)(k0 + kr) * n + n0 + nc);
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = to_f32(xs[kk * bm + tr + i * rows]);
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = to_f32(ys[kk * bn + tc + j * cols]);
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j)
      out[(size_t)(m0 + tr + i * rows) * n + n0 + tc + j * cols] =
          from_f32<Tout>(acc[i][j]);
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const void* y, void* out, int m, int n, int k,
                   int bm, int bn, int bk, cudaStream_t stream) {
  const size_t smem = (size_t)(bm + bn) * bk * sizeof(Tin);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_kernel<Tin, Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n / bn, m / bm);
  const dim3 block((bm / kMicro) * (bn / kMicro));
  matmul_kernel<Tin, Tout><<<grid, block, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(y),
      static_cast<Tout*>(out), m, n, k, bm, bn, bk);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_out(int out_dtype, const void* x, const void* y, void* out,
                       int m, int n, int k, int bm, int bn, int bk,
                       cudaStream_t stream) {
  switch (out_dtype) {
    case kF32: return launch<Tin, float>(x, y, out, m, n, k, bm, bn, bk, stream);
    case kBF16: return launch<Tin, __nv_bfloat16>(x, y, out, m, n, k, bm, bn, bk, stream);
    case kF16: return launch<Tin, __half>(x, y, out, m, n, k, bm, bn, bk, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Tin, typename Tout>
cudaError_t attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, matmul_kernel<Tin, Tout>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller has checked shapes, alignment, tile divisibility and limits.
int klaraptor_matmul(const void* x, const void* y, void* out, int m, int n, int k,
                     int bm, int bn, int bk, int in_dtype, int out_dtype,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32: return launch_out<float>(out_dtype, x, y, out, m, n, k, bm, bn, bk, s);
    case kBF16:
      return gemm_sm90::dispatch(x, y, out, out_dtype, 1, m, n, k, bm, bn, bk, s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes:
// of the f32 -> f32 SIMT kernel, or for bf16 the largest over the compiled
// wgmma tiles.
int klaraptor_matmul_attributes(int in_dtype, int* num_regs, int* max_threads,
                                int* local_bytes) {
  switch (in_dtype) {
    case kF32: return attributes<float, float>(num_regs, max_threads, local_bytes);
    case kBF16:
      *max_threads = gemm_sm90::kMaxThreads;
      return gemm_sm90::dispatch_attributes(0, 0, 0, num_regs, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread and local (spill) bytes of the bf16 wgmma tile
// (bm, bn, bk); cudaErrorInvalidValue if it is not compiled.
int klaraptor_matmul_tile_attributes(int bm, int bn, int bk, int* num_regs,
                                     int* local_bytes) {
  return gemm_sm90::dispatch_attributes(bm, bn, bk, num_regs, local_bytes);
}

const char* klaraptor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
