// Fused layernorm + residual for Hopper (sm_90a), over the feature axis:
// out[i] = (x[i] - mean) / sqrt(var + eps) * gamma + beta + res[i], f32 math,
// x and res (r, c) in bf16 or f32, gamma and beta (c,) in f32, out in x's type.
//
// Replaces: src/repro/kernels/layernorm.py::layernorm_pallas (body _ln_kernel),
// the TPU kernel that normalises a (br, c) row block per grid step with gamma
// and beta resident across every block.
//
// Bound on an H100 SXM (3.35 TB/s HBM3): about ten operations per element
// against 6 (bf16) or 12 (f32) bytes of x, res and out, so it is bound by
// bytes: x and res read once, out written once.
//
// What this design does about it: it is the simple, correct first version.
// A CTA of 8 warps owns br consecutive rows (the launch parameter; grid
// ceil(r / br), the last block masked) and stages gamma and beta once in
// shared memory as f32, where every row reads them (the TPU kernel's
// resident (1, c) blocks).  Each warp
// normalises the CTA's rows w, w + 8, ... in three passes over the row, as
// _ln_kernel computes it: the mean, then the variance of the centred row,
// then the output.  The second and third passes read the row again from the
// L1/L2 caches, not device memory, at one warp's row of a few KB.  Loads and
// stores are 16-byte vectors when c and the pointers allow, else one element
// per lane.  br trades the CTA count against the rows each warp walks through.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps per CTA
constexpr int kMinBlocks = 4;       // launch bound: caps registers at 64/thread
constexpr int kWarps = kThreads / 32;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements to f32: one 16-byte load when V * sizeof(T) == 16.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 pack = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&pack);
#pragma unroll
    for (int t = 0; t < V; ++t) v[t] = to_f32(e[t]);
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) v[t] = to_f32(p[t]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    alignas(16) T e[V];
#pragma unroll
    for (int t = 0; t < V; ++t) e[t] = from_f32<T>(v[t]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) p[t] = from_f32<T>(v[t]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Requires blockDim.x == kThreads, c % V == 0, and 16-byte aligned x, res
// and out rows when V * sizeof(T) == 16.  Rows past r (the last block's
// ragged tail) are skipped.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 T* __restrict__ out, int r, int c, int br, float eps) {
  extern __shared__ float gb[];      // [2][c]: gamma, then beta
  for (int i = threadIdx.x; i < c; i += kThreads) {
    gb[i] = gamma[i];
    gb[c + i] = beta[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float inv_c = 1.0f / (float)c;
  for (int rr = warp; rr < br; rr += kWarps) {
    const size_t row = (size_t)blockIdx.x * br + rr;
    if (row >= (size_t)r) break;
    const T* xr = x + row * c;
    float s = 0.0f;
    for (int i = lane * V; i < c; i += 32 * V) {
      float v[V];
      load_vec<T, V>(xr + i, v);
#pragma unroll
      for (int t = 0; t < V; ++t) s += v[t];
    }
    const float mean = warp_sum(s) * inv_c;
    float q = 0.0f;
    for (int i = lane * V; i < c; i += 32 * V) {
      float v[V];
      load_vec<T, V>(xr + i, v);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const float d = v[t] - mean;
        q = fmaf(d, d, q);
      }
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_c + eps);
    const T* rsr = res + row * c;
    T* outr = out + row * c;
    for (int i = lane * V; i < c; i += 32 * V) {
      float v[V], rv[V];
      load_vec<T, V>(xr + i, v);
      load_vec<T, V>(rsr + i, rv);
#pragma unroll
      for (int t = 0; t < V; ++t)
        v[t] = (v[t] - mean) * rstd * gb[i + t] + gb[c + i + t] + rv[t];
      store_vec<T, V>(outr + i, v);
    }
  }
}

template <typename T, int V>
cudaError_t launch_v(const void* x, const void* res, const void* gamma, const void* beta,
                     void* out, int r, int c, int br, float eps, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)c * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        layernorm_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  layernorm_kernel<T, V><<<(r + br - 1) / br, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(out), r, c, br, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const void* gamma, const void* beta,
                   void* out, int r, int c, int br, float eps, int vector,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vector) return launch_v<T, V>(x, res, gamma, beta, out, r, c, br, eps, stream);
  return launch_v<T, 1>(x, res, gamma, beta, out, r, c, br, eps, stream);
}

template <typename T>
cudaError_t attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, layernorm_kernel<T, 16 / sizeof(T)>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller has checked shapes, types and limits, and passes vector = 1 only
// when c is a multiple of 16 / sizeof(T) and x, res and out are 16-byte
// aligned.
int klaraptor_layernorm(const void* x, const void* res, const void* gamma,
                        const void* beta, void* out, int r, int c, int br, float eps,
                        int dtype, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, res, gamma, beta, out, r, c, br, eps, vector, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, res, gamma, beta, out, r, c, br, eps, vector, s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// the vectorised bf16 and f32 instantiations.
int klaraptor_layernorm_attributes(int dtype, int* num_regs, int* max_threads,
                                   int* local_bytes) {
  switch (dtype) {
    case kF32: return attributes<float>(num_regs, max_threads, local_bytes);
    case kBF16: return attributes<__nv_bfloat16>(num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

const char* klaraptor_layernorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
