// Flash attention forward for Hopper (sm_90a):
//   out[bh, i, :] = softmax_j(scale * q[bh, i, :] . k[kvh, j, :]) v[kvh, j, :]
// with causal masking, GQA, a sliding window and logit soft-capping.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel), the TPU kernel with grid (b*hq, q blocks, kv blocks), the kv
// axis sequential and (m, l, acc) carried in f32 VMEM scratch.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s FP32 on the
// CUDA cores, 3.35 TB/s HBM3): at a prefill shape (32 q heads, 4096 tokens,
// head dim 64, causal) the function does 2 * d FLOPs per visible (query, key)
// pair for QK^T and as many for PV, about 69 GFLOP, on 4096 * 64 * (32 + 16)
// elements in and 4096 * 64 * 32 out, tens of MB: thousands of FLOPs per
// byte, so it is bound by operations, and the roofline takes the bf16
// tensor-core rate.
//
// What this design does about it: it is the simple, correct first version.
// One CTA per (b * hq, block of bq query rows) loops over kv blocks of BKV rows
// inside the block (where the TPU had a sequential grid axis).  The CTA has
// 4 * bq threads: 16 lanes (half a warp) across each group of 4 query rows,
// so a thread owns 4 rows, BKV / 16 columns of the score tile and d / 16
// columns of the output.  Q (bq, d) is staged in shared memory once, K and V
// (BKV, d) per iteration, and the f32 probability tile (bq, BKV + 16) goes
// through shared memory between the two products; m, l and the output
// accumulator stay in registers for the whole loop, and the row max and row
// sum reduce across the 16 lanes with warp shuffles.  Both products are FP32
// FMAs on the CUDA cores, so the kernel is capped at the FP32 rate, a
// fifteenth of the bf16 tensor-core bound; wgmma, TMA and a pipelined ring of
// K/V stages are later work.  bq is a launch parameter taken at run time and
// sets the thread count; BKV is a template parameter (32, 64 or 128) that
// sets the per-thread score registers; both set the shared memory, so the
// tuner trades shared memory against occupancy.
//
// Masking follows the reference: rows with no visible key give 0; the
// running max starts at -1e30 and masked probabilities are set to 0
// explicitly, so a row whose first kv blocks are all masked never takes exp
// of a NaN.  Unlike the TPU kernel, kv blocks wholly above the causal diagonal
// or wholly outside the window are skipped, and ragged q and kv tails are
// masked (rows past sq are neither staged nor written; keys past skv are
// zero-filled and masked), so no shape needs padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
                 const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
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
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh,
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
      static_cast<T*>(out), sq, skv, hq, hkv, bq, scale, causal, has_window, window,
      softcap);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bkv(int bkv, const void* q, const void* k, const void* v, void* out,
                       int bh, int sq, int skv, int hq, int hkv, int bq, float scale,
                       int causal, int has_window, int window, float softcap,
                       cudaStream_t stream) {
  switch (bkv) {
    case 32: return launch<T, D, 32>(q, k, v, out, bh, sq, skv, hq, hkv, bq, scale,
                                     causal, has_window, window, softcap, stream);
    case 64: return launch<T, D, 64>(q, k, v, out, bh, sq, skv, hq, hkv, bq, scale,
                                     causal, has_window, window, softcap, stream);
    case 128: return launch<T, D, 128>(q, k, v, out, bh, sq, skv, hq, hkv, bq, scale,
                                       causal, has_window, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int d, int bkv, const void* q, const void* k, const void* v,
                     void* out, int bh, int sq, int skv, int hq, int hkv, int bq,
                     float scale, int causal, int has_window, int window, float softcap,
                     cudaStream_t stream) {
  switch (d) {
    case 64: return launch_bkv<T, 64>(bkv, q, k, v, out, bh, sq, skv, hq, hkv, bq, scale,
                                      causal, has_window, window, softcap, stream);
    case 128: return launch_bkv<T, 128>(bkv, q, k, v, out, bh, sq, skv, hq, hkv, bq, scale,
                                        causal, has_window, window, softcap, stream);
    case 256: return launch_bkv<T, 256>(bkv, q, k, v, out, bh, sq, skv, hq, hkv, bq, scale,
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

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller has checked shapes, dtypes, alignment, tiles and limits.
int klaraptor_flash_attention(const void* q, const void* k, const void* v, void* out,
                              int bh, int sq, int skv, int d, int hq, int hkv, int bq,
                              int bkv, float scale, int causal, int has_window,
                              int window, float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_d<float>(d, bkv, q, k, v, out, bh, sq, skv, hq, hkv, bq, scale,
                             causal, has_window, window, softcap, s);
    case kBF16:
      return launch_d<__nv_bfloat16>(d, bkv, q, k, v, out, bh, sq, skv, hq, hkv, bq,
                                     scale, causal, has_window, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// the instantiation for (dtype, head dim d, bkv).
int klaraptor_flash_attention_attributes(int dtype, int d, int bkv, int* num_regs,
                                         int* max_threads, int* local_bytes) {
  switch (dtype) {
    case kF32: return attributes_d<float>(d, bkv, num_regs, max_threads, local_bytes);
    case kBF16:
      return attributes_d<__nv_bfloat16>(d, bkv, num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

const char* klaraptor_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
