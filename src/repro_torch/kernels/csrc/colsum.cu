// Blocked column sum for Hopper (sm_90a): out[j] = sum_i x[i, j] in f32,
// x (r, c) in bf16 or f32, out (c,) f32.
//
// Replaces: src/repro/kernels/reduce.py::colsum_pallas (body _colsum_kernel),
// the TPU kernel that walks (br, bc) tiles with the row axis as its
// sequential grid axis, accumulates in an (8, bc) f32 VMEM scratch and
// writes each column block's output once, at its last row step.
//
// Bound on an H100 SXM (3.35 TB/s HBM3): one add per element read, so it is
// bound by bytes: x read once, out written once.  A bytes-bound kernel needs
// enough bytes in flight on every SM, so the design is about spreading the
// rows over CTAs and keeping loads outstanding.
//
// What this design does about it.  The grid is (c / bc, r / br): the TPU
// kernel's row tile br is spread over CTAs instead of walked by one, so a
// (8192, 4096) input gives up to thousands of CTAs.  A CTA has bc
// threads: bc / 8 column groups of 8 columns times 8 row lanes.  Row lane l
// adds rows l, l + 8, ... of its br rows into 8 f32 registers, with 16-byte
// loads of consecutive columns by consecutive threads, kUnroll rows loaded
// before any is added, so each thread keeps several independent loads in
// flight.  The 8 lanes meet in an (8, bc) f32 shared-memory tile (the TPU
// kernel's scratch).
//
// The reduction across CTAs is one launch with no float atomics, and gives
// the same bits on every run: each CTA writes its bc partial sums to row
// blockIdx.y of an f32 workspace (r / br, c), then takes a ticket (an
// integer atomic) of its column block.  The CTA that draws the last ticket
// adds the column block's partials in row-split order, writes out, and
// resets the ticket to 0, so the tickets are zero again after every launch
// and the wrapper keeps them between launches on one stream.  A cluster
// reduction through distributed shared memory was not taken: it caps the row
// splits at a cluster's 8 (16 non-portable) CTAs, and KLARAPTOR is meant to
// trade the split count freely.  So KLARAPTOR tunes (br, bc) as the trade of
// CTA count against the partial sums that have to be written and read back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;           // columns per thread
constexpr int kLanes = 8;          // row lanes per CTA
constexpr int kUnroll = 4;         // rows a lane loads before adding them
constexpr int kMaxThreads = 1024;  // launch bound: caps registers at 64/thread

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Adds the 16 / sizeof(T) consecutive values of one 16-byte load into acc.
template <typename T>
__device__ __forceinline__ void add_pack(float* acc, const uint4* pack) {
  const T* e = reinterpret_cast<const T*>(pack);
#pragma unroll
  for (int t = 0; t < (int)(16 / sizeof(T)); ++t) acc[t] += to_f32(e[t]);
}

// Requires r % br == 0, c % bc == 0, br % 8 == 0, bc % 8 == 0,
// blockDim.x == bc, gridDim = (c / bc, r / br), a 16-byte aligned x, a
// workspace of (r / br, c) f32 and c / bc zeroed tickets.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
colsum_kernel(const T* __restrict__ x, float* __restrict__ out,
              float* __restrict__ part, unsigned int* __restrict__ tickets, int c,
              int br, int bc) {
  extern __shared__ float lanes[];  // [kLanes][bc]: each row lane's sums
  __shared__ bool last;
  constexpr int kPacks = kCols * sizeof(T) / 16;  // 16-byte loads per row
  const int groups = bc / kCols;
  const int lane = threadIdx.x / groups;
  const int group = threadIdx.x % groups;
  const int c0 = blockIdx.x * bc;
  const T* xc = x + (size_t)blockIdx.y * br * c + c0 + group * kCols;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
  int i = lane;
  for (; i + (kUnroll - 1) * kLanes < br; i += kUnroll * kLanes) {
    uint4 pack[kUnroll][kPacks];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int v = 0; v < kPacks; ++v)
        pack[u][v] = __ldg(reinterpret_cast<const uint4*>(
            xc + (size_t)(i + u * kLanes) * c) + v);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int v = 0; v < kPacks; ++v) add_pack<T>(acc + v * (16 / sizeof(T)), &pack[u][v]);
  }
  for (; i < br; i += kLanes) {
#pragma unroll
    for (int v = 0; v < kPacks; ++v) {
      const uint4 pack = __ldg(reinterpret_cast<const uint4*>(xc + (size_t)i * c) + v);
      add_pack<T>(acc + v * (16 / sizeof(T)), &pack);
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) lanes[lane * bc + group * kCols + j] = acc[j];
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) s += lanes[l * bc + threadIdx.x];
  part[(size_t)blockIdx.y * c + c0 + threadIdx.x] = s;

  // The last CTA of this column block to finish adds the partials.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int ticket = atomicAdd(&tickets[blockIdx.x], 1u);
    last = ticket == gridDim.y - 1;
    if (last) tickets[blockIdx.x] = 0u;  // every CTA of the block has drawn
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p = part + c0 + threadIdx.x;
  const int splits = gridDim.y;
  float total = 0.0f;
  int k = 0;
  for (; k + kUnroll <= splits; k += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(p + (size_t)(k + u) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) total += v[u];  // row-split order
  }
  for (; k < splits; ++k) total += __ldcg(p + (size_t)k * c);
  out[c0 + threadIdx.x] = total;
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* part, void* tickets, int r, int c,
                   int br, int bc, cudaStream_t stream) {
  const size_t smem = (size_t)kLanes * bc * sizeof(float);
  const dim3 grid(c / bc, r / br);
  colsum_kernel<T><<<grid, bc, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<unsigned int*>(tickets), c, br, bc);
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
// caller has checked shapes, alignment, tile divisibility and limits, and
// hands over the (r / br, c) f32 workspace `part` and c / bc zeroed
// `tickets`, which the launch leaves zeroed.
int klaraptor_colsum(const void* x, void* out, void* part, void* tickets, int r, int c,
                     int br, int bc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, out, part, tickets, r, c, br, bc, s);
    case kBF16: return launch<__nv_bfloat16>(x, out, part, tickets, r, c, br, bc, s);
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
