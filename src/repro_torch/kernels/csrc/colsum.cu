// Blocked column sum for Hopper (sm_90a): out[j] = sum_i x[i, j] in f32,
// x (r, c) in bf16 or f32, out (c,) f32.
//
// Replaces: src/repro/kernels/reduce.py::colsum_pallas (body _colsum_kernel),
// the TPU kernel that walks (br, bc) tiles with the row axis as its
// sequential grid axis, accumulates in an (8, bc) f32 VMEM scratch and
// writes each column block's output once, at its last row step.
//
// Bound on an H100 SXM (3.35 TB/s HBM3): one add per element read, so it is
// bound by bytes: x read once, out written once.
//
// What this design does about it: it is the simple, correct first version.
// One CTA owns a block of bc columns (the grid is c / bc) and loops over the
// rows in tiles of br; a block keeps its own column sums, so there is no
// reduction across blocks and no atomic.  The CTA has bc threads: bc / 8
// column groups of 8 columns times 8 row lanes.  In each row tile, row lane l
// adds rows l, l + 8, ... of its 8 columns into f32 registers, with 16-byte
// loads of consecutive columns by consecutive threads.  After the last tile
// the 8 lanes' partial sums meet in an (8, bc) f32 shared-memory tile (the
// TPU kernel's scratch) and each thread writes one column's sum once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;           // columns per thread
constexpr int kLanes = 8;          // row lanes per CTA
constexpr int kMaxThreads = 1024;  // launch bound: caps registers at 64/thread

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Requires r % br == 0, c % bc == 0, bc % 8 == 0, blockDim.x == bc and a
// 16-byte aligned x.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
colsum_kernel(const T* __restrict__ x, float* __restrict__ out, int r, int c,
              int br, int bc) {
  extern __shared__ float part[];  // [kLanes][bc]: each row lane's sums
  constexpr int kVec = 16 / sizeof(T);
  const int groups = bc / kCols;
  const int lane = threadIdx.x / groups;
  const int group = threadIdx.x % groups;
  const int c0 = blockIdx.x * bc;
  const T* xc = x + c0 + group * kCols;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
  for (int r0 = 0; r0 < r; r0 += br) {
    for (int i = r0 + lane; i < r0 + br; i += kLanes) {
      const T* p = xc + (size_t)i * c;
#pragma unroll
      for (int v = 0; v < kCols / kVec; ++v) {
        const uint4 pack = *reinterpret_cast<const uint4*>(p + v * kVec);
        const T* e = reinterpret_cast<const T*>(&pack);
#pragma unroll
        for (int t = 0; t < kVec; ++t) acc[v * kVec + t] += to_f32(e[t]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) part[lane * bc + group * kCols + j] = acc[j];
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) s += part[l * bc + threadIdx.x];
  out[c0 + threadIdx.x] = s;
}

template <typename T>
cudaError_t launch(const void* x, void* out, int r, int c, int br, int bc,
                   cudaStream_t stream) {
  const size_t smem = (size_t)kLanes * bc * sizeof(float);
  colsum_kernel<T><<<c / bc, bc, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(out), r, c, br, bc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, colsum_kernel<T>);
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
int klaraptor_colsum(const void* x, void* out, int r, int c, int br, int bc,
                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, out, r, c, br, bc, s);
    case kBF16: return launch<__nv_bfloat16>(x, out, r, c, br, bc, s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// the bf16 and f32 instantiations.
int klaraptor_colsum_attributes(int dtype, int* num_regs, int* max_threads,
                                int* local_bytes) {
  switch (dtype) {
    case kF32: return attributes<float>(num_regs, max_threads, local_bytes);
    case kBF16: return attributes<__nv_bfloat16>(num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

const char* klaraptor_colsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
