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
//   * f32 runs csrc/gemm_simt.cuh, the SIMT mainloop csrc/matmul.cu's f32
//     path runs too, with the expert on blockIdx.z (wgmma would take f32
//     only as TF32): FP32 FMAs on the CUDA cores, an 8 x 8 micro-tile per
//     thread read from shared memory with 128-bit loads, and a 3-slot
//     cp.async ring with one barrier per k step.  Each CTA computes one (bg,
//     bn) tile of one expert's output, looping over k inside the block
//     (where the TPU had a sequential grid axis).  bg, bn and bk are taken
//     at run time: the CTA has (bg / 8) * (bn / 8) threads.  It is capped at
//     the FP32 rate of the CUDA cores (67 TFLOP/s).
//
// The backward (klaraptor_moe_gmm_backward) replaces no TPU kernel either:
// the JAX package differentiates moe_gmm_ref with XLA.  It is two grouped
// products, dX[e] = dY[e] W[e]^T (e, g, k) and dW[e] = X[e]^T dY[e] (e, k,
// n), with the forward's 2 g n k FLOPs each.  bf16 runs both on
// csrc/gmm_bwd_sm90.cuh, a persistent wgmma body of their own with the
// transposed operand read in place and an asynchronous TMA-store epilogue
// (its header says why: at an MoE layer's short capacity dX is bound by
// reading W and dW by writing it), one launch per product at the tile (bm,
// bn), CTA count and walk order the caller chose.  f32 has no backward entry here: the
// wrapper feeds the f32 SIMT mainloop klaraptor_moe_gmm a transposed
// contiguous copy of W and of X (no model trains in f32 on the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_simt.cuh"
#include "gemm_sm90.cuh"
#include "gmm_bwd_sm90.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

}  // namespace

extern "C" {

// One bf16 backward product on `stream` (gmm_bwd_sm90::Product: 1 dX, 2
// dW): out (e, m, n) from a and b as gmm_bwd_sm90::launch reads them, at
// tile (bm, bn) on `ctas` persistent CTAs, walking each expert's tiles n
// fastest when n_fast is 1; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for a tile that is not compiled.  The caller has
// checked shapes, alignment and tile divisibility.
int klaraptor_moe_gmm_backward(int product, const void* a, const void* b, void* out, int e,
                               int m, int n, int k, int bm, int bn, int ctas, int n_fast,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (product) {
    case gmm_bwd_sm90::kDX:
      return gmm_bwd_sm90::dispatch<gmm_bwd_sm90::kDX>(a, b, out, e, m, n, k, bm, bn, ctas,
                                                       n_fast, s);
    case gmm_bwd_sm90::kDW:
      return gmm_bwd_sm90::dispatch<gmm_bwd_sm90::kDW>(a, b, out, e, m, n, k, bm, bn, ctas,
                                                       n_fast, s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, spilled local bytes and dynamic shared memory of
// backward product `product` at tile (bm, bn); cudaErrorInvalidValue if it
// is not compiled.
int klaraptor_moe_gmm_backward_attributes(int product, int bm, int bn, int* num_regs,
                                          int* local_bytes, int* smem_bytes) {
  switch (product) {
    case gmm_bwd_sm90::kDX:
      return gmm_bwd_sm90::dispatch_attributes<gmm_bwd_sm90::kDX>(bm, bn, num_regs,
                                                                 local_bytes, smem_bytes);
    case gmm_bwd_sm90::kDW:
      return gmm_bwd_sm90::dispatch_attributes<gmm_bwd_sm90::kDW>(bm, bn, num_regs,
                                                                 local_bytes, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller has checked shapes, alignment, tile divisibility and limits.
int klaraptor_moe_gmm(const void* x, const void* w, void* out, int e, int g, int n,
                      int k, int bg, int bn, int bk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return gemm_simt::launch(static_cast<const float*>(x), static_cast<const float*>(w),
                               static_cast<float*>(out), e, g, n, k, bg, bn, bk, s);
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
    case kF32: return gemm_simt::attributes<float>(num_regs, max_threads, local_bytes);
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
