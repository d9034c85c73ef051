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
//   * f32 inputs run the SIMT mainloop of csrc/gemm_simt.cuh, shared with
//     the f32 grouped matmul: FP32 FMAs on the CUDA cores (wgmma takes f32
//     only as TF32, whose ten mantissa bits would break the 2e-4 f32
//     tolerance the port holds to), an 8 x 8 micro-tile per thread read from
//     shared memory with 128-bit loads, and a 3-slot cp.async ring with one
//     barrier per k step.  Each CTA computes one (bm, bn) tile of C and loops
//     over k inside the block (where the TPU had a sequential grid axis);
//     bm, bn and bk are taken at run time: the CTA has (bm / 8) * (bn / 8)
//     threads.  It is capped at the FP32 rate of the CUDA cores (67
//     TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_simt.cuh"
#include "gemm_sm90.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

cudaError_t launch_f32(const void* x, const void* y, void* out, int out_dtype, int m, int n,
                       int k, int bm, int bn, int bk, cudaStream_t stream) {
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  switch (out_dtype) {
    case kF32:
      return gemm_simt::launch(xf, yf, static_cast<float*>(out), 1, m, n, k, bm, bn, bk, stream);
    case kBF16:
      return gemm_simt::launch(xf, yf, static_cast<__nv_bfloat16*>(out), 1, m, n, k, bm, bn, bk,
                               stream);
    case kF16:
      return gemm_simt::launch(xf, yf, static_cast<__half*>(out), 1, m, n, k, bm, bn, bk, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The largest registers and spills over the f32 body's three output types.
cudaError_t attributes_f32(int* num_regs, int* max_threads, int* local_bytes) {
  int regs[3], threads[3], local[3];
  cudaError_t err = gemm_simt::attributes<float>(&regs[0], &threads[0], &local[0]);
  if (err == cudaSuccess)
    err = gemm_simt::attributes<__nv_bfloat16>(&regs[1], &threads[1], &local[1]);
  if (err == cudaSuccess) err = gemm_simt::attributes<__half>(&regs[2], &threads[2], &local[2]);
  if (err != cudaSuccess) return err;
  *num_regs = *max_threads = *local_bytes = 0;
  for (int i = 0; i < 3; ++i) {
    *num_regs = regs[i] > *num_regs ? regs[i] : *num_regs;
    *max_threads = i == 0 || threads[i] < *max_threads ? threads[i] : *max_threads;
    *local_bytes = local[i] > *local_bytes ? local[i] : *local_bytes;
  }
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
    case kF32: return launch_f32(x, y, out, out_dtype, m, n, k, bm, bn, bk, s);
    case kBF16:
      return gemm_sm90::dispatch(x, y, out, out_dtype, 1, m, n, k, bm, bn, bk, s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes:
// for f32 the largest over the SIMT body's output types, for bf16 the
// largest over the compiled wgmma tiles.
int klaraptor_matmul_attributes(int in_dtype, int* num_regs, int* max_threads,
                                int* local_bytes) {
  switch (in_dtype) {
    case kF32: return attributes_f32(num_regs, max_threads, local_bytes);
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
