// Grouped (expert) matmul for Hopper (sm_90a): out[e] = x[e] @ w[e] for every
// expert e, x (e, g, k), w (e, k, n), out (e, g, n) in x's type.
//
// Replaces: src/repro/kernels/moe_gmm.py::moe_gmm_pallas (body _gmm_kernel),
// the TPU kernel that tiles (bg, bn, bk) over a grid (e, i, j, l) with the k
// axis sequential and an f32 VMEM accumulator.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM3): at the
// MoE expert shapes it serves (g in the thousands of tokens per expert, k and n
// the model and expert widths) each expert's product does 2*g*n*k FLOPs on
// (gk + kn + gn) elements, hundreds of FLOPs per byte, so it is bound by
// operations.  The roofline takes the bf16 tensor-core rate.
//
// What this design does about it: two bodies, one per input type.
//   * bf16 runs csrc/gemm_sm90.cuh, the Hopper mainloop csrc/matmul.cu's
//     bf16 path runs too, with the expert on blockIdx.z: wgmma on the tensor
//     cores fed by a 4-slot TMA ring, one or two consumer warpgroups
//     (2 * bg threads), f32 accumulators in registers (the Pallas kernel's
//     VMEM scratch) and the result cast once to bf16.  Its 3-D tensor maps
//     over x (e, g, k) and w (e, k, n) keep every box inside its expert.
//     (bg, bn, bk) are template instantiations, the nine tiles of
//     GEMM_SM90_TILES.
//   * f32 keeps the SIMT body below (wgmma would take f32 only as TF32):
//     each CTA computes one (bg, bn) tile of one expert's output, looping
//     over k inside the block (where the TPU had a sequential grid axis).
//     Per iteration it stages a (bg, bk) tile of x (transposed) and a (bk,
//     bn) tile of w in dynamic shared memory with 16-byte vector loads, then
//     every thread accumulates an 8 x 8 micro-tile in f32 registers with
//     FP32 FMAs, and the result is cast once.  bg, bn and bk are taken at
//     run time: the CTA has (bg / 8) * (bn / 8) threads.  It is capped at
//     the FP32 rate of the CUDA cores (67 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

constexpr int kMicro = 8;          // each thread owns a kMicro x kMicro block of out
constexpr int kMaxThreads = 512;   // launch bound: caps registers at 128/thread
constexpr int kVecBytes = 16;      // global and shared loads are 16 bytes wide

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// Requires g % bg == n % bn == k % bk == 0, bg % 8 == bn % 8 == bk % 8 == 0,
// 16-byte aligned x and w, and blockDim.x == (bg / 8) * (bn / 8).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int g, int n, int k, int bg, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);   // [bk][bg]: x tile, transposed
  T* ws = xs + bk * bg;                 // [bk][bn]: w tile
  constexpr int V = kVecBytes / sizeof(T);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rows = bg / kMicro;         // thread rows in the CTA
  const int cols = bn / kMicro;         // thread columns in the CTA
  const int tr = tid / cols;
  const int tc = tid % cols;
  const int g0 = blockIdx.y * bg;
  const int n0 = blockIdx.x * bn;
  const size_t ex = blockIdx.z;
  x += ex * g * k;
  w += ex * k * n;
  out += ex * g * n;

  // Thread (tr, tc) owns rows tr + i * rows and columns tc + j * cols of the
  // tile: neighbouring threads read neighbouring shared-memory words and
  // write neighbouring columns of out.
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  const int x_vecs = bg * (bk / V);
  const int w_vecs = bk * (bn / V);
  for (int k0 = 0; k0 < k; k0 += bk) {
    // x tile: consecutive threads take consecutive rows, 16 bytes along k
    // each, and store them transposed (conflict-free column writes).
    for (int v = tid; v < x_vecs; v += nthreads) {
      const int row = v % bg;
      const int kc = (v / bg) * V;
      const uint4 pack = *reinterpret_cast<const uint4*>(
          x + (size_t)(g0 + row) * k + k0 + kc);
      const T* e = reinterpret_cast<const T*>(&pack);
#pragma unroll
      for (int t = 0; t < V; ++t) xs[(kc + t) * bg + row] = e[t];
    }
    // w tile: row-major as in memory, 16-byte vectors along n.
    for (int v = tid; v < w_vecs; v += nthreads) {
      const int kr = v / (bn / V);
      const int nc = (v % (bn / V)) * V;
      *reinterpret_cast<uint4*>(ws + kr * bn + nc) =
          *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kr) * n + n0 + nc);
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = to_f32(xs[kk * bg + tr + i * rows]);
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = to_f32(ws[kk * bn + tc + j * cols]);
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
      out[(size_t)(g0 + tr + i * rows) * n + n0 + tc + j * cols] = from_f32<T>(acc[i][j]);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int e, int g, int n,
                   int k, int bg, int bn, int bk, cudaStream_t stream) {
  const size_t smem = (size_t)(bg + bn) * bk * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n / bn, g / bg, e);
  const dim3 block((bg / kMicro) * (bn / kMicro));
  moe_gmm_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      g, n, k, bg, bn, bk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, moe_gmm_kernel<T>);
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
int klaraptor_moe_gmm(const void* x, const void* w, void* out, int e, int g, int n,
                      int k, int bg, int bn, int bk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, w, out, e, g, n, k, bg, bn, bk, s);
    case kBF16:
      return gemm_sm90::dispatch(x, w, out, gemm_sm90::kBF16, e, g, n, k, bg, bn, bk, s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes:
// of the f32 SIMT kernel, or for bf16 the largest over the compiled wgmma
// tiles.
int klaraptor_moe_gmm_attributes(int dtype, int* num_regs, int* max_threads,
                                 int* local_bytes) {
  switch (dtype) {
    case kF32: return attributes<float>(num_regs, max_threads, local_bytes);
    case kBF16:
      *max_threads = gemm_sm90::kMaxThreads;
      return gemm_sm90::dispatch_attributes(0, 0, 0, num_regs, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread and local (spill) bytes of the bf16 wgmma tile
// (bg, bn, bk); cudaErrorInvalidValue if it is not compiled.
int klaraptor_moe_gmm_tile_attributes(int bg, int bn, int bk, int* num_regs,
                                      int* local_bytes) {
  return gemm_sm90::dispatch_attributes(bg, bn, bk, num_regs, local_bytes);
}

const char* klaraptor_moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
