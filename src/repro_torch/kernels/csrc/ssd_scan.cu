// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a):
//   h_t = exp(dt_t * A) h_{t-1} + dt_t B_t x_t^T      h: (n, dh), f32
//   y_t = C_t h_t                                     y: (dh,)
// for each of bh independent (batch * head) rows, x (bh, s, dh), dt (bh, s),
// B and C (bh, s, n), A (bh,), y (bh, s, dh) in x's type.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (body _ssd_kernel),
// the TPU kernel with grid (bh, chunks), the chunk axis sequential and the
// (n, dh) state carried across chunks in f32 VMEM scratch.
//
// Bound on an H100 SXM (3.35 TB/s HBM3; 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s FP32 on the CUDA cores): at the mamba2-130m prefill shape (bh 24,
// s 4096, dh 64, n 128, bf16) the function reads x, B, C and dt and writes y,
// about 76 MB, while the chunked form needs about 8 GFLOP at chunk 256: a
// hundred FLOPs per byte, so it is bound by bytes.
//
// What this design does about it: it is the simple, correct first version.
// Within a chunk of L rows it computes the decay-gated quadratic form
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//       + exp(cum_i) C_i h_in,        cum = inclusive cumsum of A dt,
// and then carries h_out = exp(cum_L) h_in + sum_j exp(cum_L - cum_j) dt_j
// B_j x_j^T into the next chunk.  The chunk axis is sequential, so one CTA
// loops over all chunks of one (batch * head) row; the state's dh columns are
// independent, so the CTA carries only kCols of them, and dh / kCols CTAs per
// row fill more SMs (96 CTAs at batch 1 of mamba2-130m instead of 24), each
// recomputing the chunk's C B^T scores.  Per chunk the CTA stages B and C
// (transposed, n x L), its x columns and dt in shared memory, forms the
// running sum of A dt with warp scans, then walks tiles of kRows score rows:
// each thread computes a 4 x 4 block of C B^T, gated and causally masked,
// into a shared f32 tile, then two y columns of one row from it; last it
// updates the shared f32 state.  All products are FP32 FMAs on the CUDA
// cores; the state and every sum are f32.  Larger chunks do more quadratic
// work and need more shared memory (B and C alone take 2 n L elements), so
// the chunk is the launch parameter KLARAPTOR tunes.  wgmma for the score and
// state products, a TMA ring over chunks, a head -> group index for B and C
// (the model repeats them per head), and the chunk-state / state-passing /
// chunk-scan split that parallelises over chunks are later work.
//
// The exponent is masked before exp, as in the reference: only j <= i ever
// reaches exp(cum_i - cum_j), whose argument is then <= 0.  A ragged last
// chunk is masked: rows past s are staged as zeros (dt = 0 adds nothing to the
// running sum or the state) and never written, so no length needs padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;      // head-dim columns per CTA
constexpr int kRows = 32;      // rows of a score tile
constexpr int kGPad = 4;       // f32 words of padding per score-tile row
constexpr int kThreads = 256;
constexpr int kVecBytes = 16;  // global loads are 16 bytes wide

enum DType { kF32 = 0, kBF16 = 1 };

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

// x: (bh, s, dh); dt: (bh, s) f32; B, C: (bh, s, n); A: (bh,) f32; out like x;
// all contiguous and 16-byte aligned.  gridDim = (dh / kCols, bh),
// blockDim = kThreads, L % kRows == 0, n % 8 == 0, dh % kCols == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ B, const T* __restrict__ C,
                      const float* __restrict__ A, T* __restrict__ out, int s, int dh,
                      int n, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int GS = L + kGPad;                               // score-tile row stride
  float* st = reinterpret_cast<float*>(smem);             // [n][kCols] state
  float* gs = st + n * kCols;                             // [kRows][GS] scores
  float* dts = gs + kRows * GS;                           // [L] dt, then weights
  float* cum = dts + L;                                   // [L] running sum of A dt
  T* bs = reinterpret_cast<T*>(cum + L);                  // [n][L] B^T
  T* cs = bs + n * L;                                     // [n][L] C^T
  T* xs = cs + n * L;                                     // [L][kCols] x columns

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int d0 = blockIdx.x * kCols;
  const float a = A[bh];
  const T* xg = x + (size_t)bh * s * dh + d0;
  const float* dtg = dt + (size_t)bh * s;
  const T* bg = B + (size_t)bh * s * n;
  const T* cg = C + (size_t)bh * s * n;
  T* og = out + (size_t)bh * s * dh + d0;

  for (int e = tid; e < n * kCols; e += kThreads) st[e] = 0.0f;

  for (int c0 = 0; c0 < s; c0 += L) {
    const int lv = min(L, s - c0);                        // valid rows of this chunk

    // -- stage the chunk ----------------------------------------------------
    for (int j = tid; j < L; j += kThreads) dts[j] = j < lv ? dtg[c0 + j] : 0.0f;
    stage_transposed<T>(bs, bg + (size_t)c0 * n, L, n, lv);
    stage_transposed<T>(cs, cg + (size_t)c0 * n, L, n, lv);
    {
      constexpr int V = kVecBytes / sizeof(T);
      constexpr int PER_ROW = kCols / V;
      for (int i = tid; i < L * PER_ROW; i += kThreads) {
        const int row = i / PER_ROW;
        const int c = (i % PER_ROW) * V;
        uint4 pack = make_uint4(0u, 0u, 0u, 0u);
        if (row < lv)
          pack = *reinterpret_cast<const uint4*>(xg + (size_t)(c0 + row) * dh + c);
        *reinterpret_cast<uint4*>(xs + row * kCols + c) = pack;
      }
    }
    __syncthreads();

    // -- running sum of A dt (warp 0; rows past lv add 0) --------------------
    if (tid < 32) {
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
    __syncthreads();
    const float total = cum[L - 1];

    // -- output rows, one tile of kRows rows at a time -----------------------
    for (int i0 = 0; i0 < lv; i0 += kRows) {
      const int jn = i0 + kRows;                          // columns j < jn
      const int items = (kRows / 4) * (jn / 4);
      for (int e = tid; e < items; e += kThreads) {
        const int ti = e % (kRows / 4);
        const int tj = e / (kRows / 4);
        const int ib = i0 + ti * 4;
        const int jb = tj * 4;
        if (jb > ib + 3) continue;                        // wholly above the diagonal
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
          load4(cs + k * L + ib, cv);
          load4(bs + k * L + jb, bv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ib + r;
          const float ci = cum[i];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = jb + q;
            // mask before exp: j > i would give exp of a positive number
            gs[(ti * 4 + r) * GS + j] =
                j <= i ? acc[r][q] * expf(ci - cum[j]) * dts[j] : 0.0f;
          }
        }
      }
      __syncthreads();

      for (int e = tid; e < kRows * (kCols / 2); e += kThreads) {
        const int r = e / (kCols / 2);
        const int dp = (e % (kCols / 2)) * 2;
        const int i = i0 + r;
        const float* grow = gs + r * GS;
        float y0 = 0.0f, y1 = 0.0f;
        int j = 0;
        for (; j + 3 <= i; j += 4) {                      // 4 columns, all j <= i
          float g[4];
          load4(grow + j, g);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 xv = load2(xs + (j + q) * kCols + dp);
            y0 = fmaf(g[q], xv.x, y0);
            y1 = fmaf(g[q], xv.y, y1);
          }
        }
        for (; j <= i; ++j) {
          const float g = grow[j];
          const float2 xv = load2(xs + j * kCols + dp);
          y0 = fmaf(g, xv.x, y0);
          y1 = fmaf(g, xv.y, y1);
        }
        float z0 = 0.0f, z1 = 0.0f;                       // C_i h_in
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const float cv = to_f32(cs[k * L + i]);
          const float2 h = *reinterpret_cast<const float2*>(st + k * kCols + dp);
          z0 = fmaf(cv, h.x, z0);
          z1 = fmaf(cv, h.y, z1);
        }
        const float ei = expf(cum[i]);
        if (i < lv) store2(og + (size_t)(c0 + i) * dh + dp, fmaf(ei, z0, y0), fmaf(ei, z1, y1));
      }
      __syncthreads();
    }

    // -- carry the state into the next chunk ---------------------------------
    for (int j = tid; j < L; j += kThreads) dts[j] = expf(total - cum[j]) * dts[j];
    __syncthreads();
    const float decay = expf(total);
    const int lv4 = (lv + 3) & ~3;                        // rows past lv weigh 0
    for (int e = tid; e < (n / 4) * (kCols / 2); e += kThreads) {
      const int kb = (e / (kCols / 2)) * 4;
      const int dp = (e % (kCols / 2)) * 2;
      float acc[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.0f;
      for (int j = 0; j < lv4; j += 4) {
        float w[4];
        load4(dts + j, w);
        float2 xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = load2(xs + (j + q) * kCols + dp);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float bv[4];
          load4(bs + (kb + r) * L + j, bv);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float b = bv[q] * w[q];
            acc[r][0] = fmaf(b, xv[q].x, acc[r][0]);
            acc[r][1] = fmaf(b, xv[q].y, acc[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* h = st + (kb + r) * kCols + dp;
        h[0] = fmaf(decay, h[0], acc[r][0]);
        h[1] = fmaf(decay, h[1], acc[r][1]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int n, int L) {
  return (size_t)(2 * n + kCols) * L * sizeof(T) + (size_t)8 * L +
         (size_t)4 * kRows * (L + kGPad) + (size_t)4 * n * kCols;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* B, const void* C,
                   const void* A, void* out, int bh, int s, int dh, int n, int L,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n, L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(dh / kCols, bh);
  ssd_chunk_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(A), static_cast<T*>(out), s, dh,
      n, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, ssd_chunk_scan_kernel<T>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller has checked shapes, dtypes, alignment, the chunk and limits.
int klaraptor_ssd_scan(const void* x, const void* dt, const void* B, const void* C,
                       const void* A, void* out, int bh, int s, int dh, int n, int chunk,
                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, dt, B, C, A, out, bh, s, dh, n, chunk, st);
    case kBF16: return launch<__nv_bfloat16>(x, dt, B, C, A, out, bh, s, dh, n, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// the instantiation for `dtype`.
int klaraptor_ssd_scan_attributes(int dtype, int* num_regs, int* max_threads,
                                  int* local_bytes) {
  switch (dtype) {
    case kF32: return attributes<float>(num_regs, max_threads, local_bytes);
    case kBF16: return attributes<__nv_bfloat16>(num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

const char* klaraptor_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
