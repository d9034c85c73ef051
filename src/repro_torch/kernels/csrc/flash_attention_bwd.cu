// Flash attention backward for Hopper (sm_90a): given q, k, v, the forward's
// output o, its log-sum-exp lse and the output's gradient do, the gradients
//   dq[bh, i] = scale * sum_j ds[i, j] k[kvh, j]
//   dk[kvh, j] = scale * sum_{bh in kvh's group, i} ds[i, j] q[bh, i]
//   dv[kvh, j] = sum_{bh in kvh's group, i} p[i, j] do[bh, i]
// with p[i, j] = exp(scale * q[bh, i] . k[kvh, j] - lse[bh, i]) on the
// visible (query, key) pairs (causal or not; GQA), dp[i, j] = do[bh, i] .
// v[kvh, j] and ds = p * (dp - delta[bh, i]), delta = rowsum(do * o).
//
// Replaces no TPU kernel: the JAX package trains with its plain attention
// (use_pallas=False) and takes XLA's autodiff of it
// (src/repro/kernels/ref.py::flash_attention_ref); none of its Pallas kernels
// has a backward.  The port's training forward runs the hand-written
// forward kernel on the card, so its gradient needs this one.  The design is
// FlashAttention-2's backward (Dao, 2023), written by hand:
//
//   * flash_bwd_delta_kernel: delta = rowsum(do * o), one warp per row, f32.
//   * flash_bwd_dkdv_kernel: one CTA per (kv head, block of 64 kv rows).
//     K and V stay in shared memory; the CTA loops over the q heads of the
//     kv head's GQA group and, for each, over the q blocks that can see the
//     kv block (from the diagonal down when causal), recomputing S = Q K^T
//     and P from lse, dP = dO V^T and dS, and accumulating dV += P^T dO and
//     dK += dS^T Q in registers.  Nothing is written twice: no float atomics,
//     so the backward is deterministic.
//   * flash_bwd_dq_kernel: one CTA per (q head, block of 64 q rows), looping
//     over the kv blocks the rows can see: dQ += dS K, again without atomics.
//     S and dP are recomputed here too -- the price of no atomics.
//
// Bound on an H100 SXM: the backward does 2.5 times the forward's FLOPs
// (QK^T, dO V^T, P^T dO, dS^T Q and dS K, 2 d FLOPs each per visible pair,
// against the forward's two products), so at llama3.2-1b's shapes it is bound
// by operations, like the forward; the bound takes the bf16 tensor-core rate.
// This first kernel is SIMT: every product is FP32 FMAs on the CUDA cores
// (67 TFLOP/s), so it cannot reach that bound.  wgmma for the five products
// and TMA loads are later work (ROADMAP Queue B).
//
// The SIMT body.  256 threads; 64 x 64 tiles of S, dP, P and dS, each thread
// holding 4 x 4 of them (rows ty + 16 i, columns tx + 16 j with ty = tid / 16,
// tx = tid % 16) and 4 x (D / 16) of the (64, D) accumulators.  The Q, dO, K
// and V tiles come in by 16-byte cp.async copies, in the input type, into
// rows padded by 16 bytes: a row's stride is 4 words past a multiple of 32
// banks, so the 16-byte reads of 8 consecutive rows (the K operand of S)
// fall in 32 distinct banks, and rows past sq or skv are zero-filled by the
// copy.  P and dS go through f32 shared memory, rows padded by 16 words.
// Everything is accumulated in f32; dq, dk and dv are written in the input
// type.  Head dims 64 and 128, f32 and bf16, any sq and skv.  Softcap and
// window are not taken: the wrapper refuses them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // q rows and kv rows per block
constexpr int kLdp = kTile + 16;       // f32 row stride of the P and dS tiles

enum DType { kF32 = 0, kBF16 = 1 };

// Elements per 16-byte chunk, and the padded row stride of a staged tile.
template <typename T> constexpr int kVec = 16 / sizeof(T);
template <typename T, int D> constexpr int kLd = D + kVec<T>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void unpack(uint32_t w, float& a, float& b) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
  a = __low2float(h);
  b = __high2float(h);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// N consecutive elements at p (shared memory, N * sizeof(T) bytes aligned to
// that width, 8 or 16 bytes at a time) as f32.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* o) {
  static_assert(N % 4 == 0, "16-byte reads");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    o[4 * i] = v.x;
    o[4 * i + 1] = v.y;
    o[4 * i + 2] = v.z;
    o[4 * i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* o) {
  static_assert(N % 4 == 0, "8- or 16-byte reads");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      unpack(v.x, o[8 * i], o[8 * i + 1]);
      unpack(v.y, o[8 * i + 2], o[8 * i + 3]);
      unpack(v.z, o[8 * i + 4], o[8 * i + 5]);
      unpack(v.w, o[8 * i + 6], o[8 * i + 7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      unpack(v.x, o[4 * i], o[4 * i + 1]);
      unpack(v.y, o[4 * i + 2], o[4 * i + 3]);
    }
  }
}

// N f32 values stored as N consecutive elements at p (global memory).
template <int N>
__device__ __forceinline__ void store(float* p, const float* x) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                                  x[4 * i + 3]);
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(pack(x[8 * i], x[8 * i + 1]), pack(x[8 * i + 2], x[8 * i + 3]),
                     pack(x[8 * i + 4], x[8 * i + 5]), pack(x[8 * i + 6], x[8 * i + 7]));
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<uint2*>(p)[i] =
          make_uint2(pack(x[4 * i], x[4 * i + 1]), pack(x[4 * i + 2], x[4 * i + 3]));
  }
}

// One 16-byte cp.async copy; with valid false nothing is read and the 16
// bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of a (64, D) row-major tile at src (rows at or past
// `valid` zero-filled) into dst, whose rows are kLd<T, D> elements apart.
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* src, int valid) {
  constexpr int V = kVec<T>;
  constexpr int CH = D / V;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * V;
    const bool ok = r < valid;
    cp_async16(dst + r * kLd<T, D> + c, ok ? src + (size_t)r * D + c : src, ok);
  }
}

// acc[i][j] = sum_d x[ty + 16 i][d] * y[tx + 16 j][d]: a 64 x 64 tile of X Y^T
// over two staged (64, D) tiles.
template <typename T, int D>
__device__ __forceinline__ void tile_abt(const T* xs, const T* ys, int ty, int tx,
                                         float (&acc)[4][4]) {
  constexpr int V = kVec<T>;
  constexpr int LD = kLd<T, D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int dd = 0; dd < D; dd += V) {
    float a[4][V], b[4][V];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_f32<V>(xs + (ty + 16 * i) * LD + dd, a[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) load_f32<V>(ys + (tx + 16 * j) * LD + dd, b[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][j] = fmaf(a[i][e], b[j][e], acc[i][j]);
  }
}

// The output columns a thread owns of a (64, D) accumulator: NC = D / 16 of
// them, in NC / CE runs of CE consecutive columns, run h at h * 16 CE + tx CE
// (16 threads' runs side by side, so their reads of a staged row are
// contiguous).
template <typename T, int D> struct Cols {
  static constexpr int NC = D / 16;
  static constexpr int CE = NC < kVec<T> ? NC : kVec<T>;
  static constexpr int NCH = NC / CE;
  __device__ static int col(int tx, int h) { return h * 16 * CE + tx * CE; }
};

// acc[i][.] += sum_r w(r, i) * y[r][cols] over the 64 rows r of a staged
// (64, D) tile y, with w(r, i) = ws[r][ty + 16 i] (TRANS: a P^T or dS^T
// product) or ws[ty + 16 i][r] (a dS K product); ws is an f32 (64, kLdp) tile.
template <typename T, int D, bool TRANS>
__device__ __forceinline__ void tile_acc(const float* ws, const T* ys, int ty, int tx,
                                         float (&acc)[4][D / 16]) {
  using C = Cols<T, D>;
  constexpr int LD = kLd<T, D>;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float a[4], b[C::NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = TRANS ? ws[r * kLdp + ty + 16 * i] : ws[(ty + 16 * i) * kLdp + r];
#pragma unroll
    for (int h = 0; h < C::NCH; ++h)
      load_f32<C::CE>(ys + r * LD + C::col(tx, h), b + h * C::CE);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C::NC; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// Write rows row0 + ty + 16 i (those below `rows`) of a (64, D) accumulator
// times `mul` into dst, a row-major (rows, D) array.
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* dst, int row0, int rows, int ty, int tx,
                                           float (&acc)[4][D / 16], float mul) {
  using C = Cols<T, D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < C::NCH; ++h) {
      float x[C::CE];
#pragma unroll
      for (int e = 0; e < C::CE; ++e) x[e] = acc[i][h * C::CE + e] * mul;
      store<C::CE>(dst + (size_t)r * D + C::col(tx, h), x);
    }
  }
}

// P and dS of one 64 x 64 tile from its scores s and dp: ps[row][col] = p,
// dss[row][col] = p (dp - delta[row]); p = 0 off the visible pairs and on
// rows that see no key (lse -inf).
__device__ __forceinline__ void softmax_grad(const float (&s)[4][4], const float (&dp)[4][4],
                                             const float* lses, const float* dels,
                                             float* ps, float* dss, int q0, int k0, int sq,
                                             int skv, float scale, int causal, int ty,
                                             int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int qpos = q0 + row;
    const float lse = lses[row];
    const float delta = dels[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const int kpos = k0 + col;
      const bool vis = qpos < sq && kpos < skv && (!causal || kpos <= qpos) &&
                       lse != -INFINITY;
      const float p = vis ? expf(fmaf(s[i][j], scale, -lse)) : 0.0f;
      if (ps != nullptr) ps[row * kLdp + col] = p;
      dss[row * kLdp + col] = p * (dp[i][j] - delta);
    }
  }
}

// lse and delta of q rows [q0, q0 + 64) of head bh into shared memory (rows
// past sq: lse -inf, delta 0).
__device__ __forceinline__ void stage_rows(float* lses, float* dels, const float* lse,
                                           const float* delta, int bh, int q0, int sq) {
  if (threadIdx.x < kTile) {
    const int qpos = q0 + threadIdx.x;
    const bool ok = qpos < sq;
    lses[threadIdx.x] = ok ? lse[(size_t)bh * sq + qpos] : -INFINITY;
    dels[threadIdx.x] = ok ? delta[(size_t)bh * sq + qpos] : 0.0f;
  }
}

// delta[row] = sum_d do[row, d] * o[row, d], one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.0f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(o[row * D + d]), to_f32(dout[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
constexpr size_t dkdv_smem_bytes() {
  return 4 * kTile * kLd<T, D> * sizeof(T) + 2 * kTile * kLdp * 4 + 2 * kTile * 4;
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  return 4 * kTile * kLd<T, D> * sizeof(T) + kTile * kLdp * 4 + 2 * kTile * 4;
}

// q, dout: (bh, sq, D); k, v: (bh / hq * hkv, skv, D); lse, delta: (bh, sq)
// f32; dk, dv: like k.  gridDim = (ceil(skv / 64), bh / hq * hkv).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int hq,
                      int hkv, float scale, int causal) {
  constexpr int LD = kLd<T, D>;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);              // [64][LD]
  T* vs = ks + kTile * LD;
  T* qs = vs + kTile * LD;
  T* dos = qs + kTile * LD;
  float* ps = reinterpret_cast<float*>(dos + kTile * LD);   // [64][kLdp]
  float* dss = ps + kTile * kLdp;
  float* lses = dss + kTile * kLdp;                         // [64]
  float* dels = lses + kTile;

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int bkv = blockIdx.y;                 // b * hkv + kv head
  const int k0 = blockIdx.x * kTile;          // kv block 0 sees the most q rows
  const int group = hq / hkv;
  const int b = bkv / hkv;
  const int kvh = bkv % hkv;
  stage<T, D>(ks, k + ((size_t)bkv * skv + k0) * D, skv - k0);
  stage<T, D>(vs, v + ((size_t)bkv * skv + k0) * D, skv - k0);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  // q rows before k0 see no key of this block when causal
  const int q_begin = causal ? k0 : 0;
  for (int g = 0; g < group; ++g) {
    const int bh = b * hq + kvh * group + g;
    for (int q0 = q_begin; q0 < sq; q0 += kTile) {
      __syncthreads();   // the last iteration is done with qs, dos, ps, dss
      stage<T, D>(qs, q + ((size_t)bh * sq + q0) * D, sq - q0);
      stage<T, D>(dos, dout + ((size_t)bh * sq + q0) * D, sq - q0);
      stage_rows(lses, dels, lse, delta, bh, q0, sq);
      cp_async_wait_all();
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_abt<T, D>(qs, ks, ty, tx, s);
      tile_abt<T, D>(dos, vs, ty, tx, dp);
      softmax_grad(s, dp, lses, dels, ps, dss, q0, k0, sq, skv, scale, causal, ty, tx);
      __syncthreads();
      tile_acc<T, D, true>(ps, dos, ty, tx, dv_acc);    // dV += P^T dO
      tile_acc<T, D, true>(dss, qs, ty, tx, dk_acc);    // dK += dS^T Q
    }
  }
  if (q_begin >= sq) cp_async_wait_all();     // no q row: K and V still in flight
  T* dkg = dk + (size_t)bkv * skv * D;
  T* dvg = dv + (size_t)bkv * skv * D;
  write_rows<T, D>(dkg, k0, skv, ty, tx, dk_acc, scale);
  write_rows<T, D>(dvg, k0, skv, ty, tx, dv_acc, 1.0f);
}

// q, dout, dq: (bh, sq, D); k, v: (bh / hq * hkv, skv, D); lse, delta: (bh,
// sq) f32.  gridDim = (ceil(sq / 64), bh).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int skv, int hq, int hkv, float scale,
                    int causal) {
  constexpr int LD = kLd<T, D>;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);              // [64][LD]
  T* dos = qs + kTile * LD;
  T* ks = dos + kTile * LD;
  T* vs = ks + kTile * LD;
  float* dss = reinterpret_cast<float*>(vs + kTile * LD);   // [64][kLdp]
  float* lses = dss + kTile * kLdp;                         // [64]
  float* dels = lses + kTile;

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;   // longest causal rows first
  const int kvrow = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const T* kg = k + (size_t)kvrow * skv * D;
  const T* vg = v + (size_t)kvrow * skv * D;
  stage<T, D>(qs, q + ((size_t)bh * sq + q0) * D, sq - q0);
  stage<T, D>(dos, dout + ((size_t)bh * sq + q0) * D, sq - q0);
  stage_rows(lses, dels, lse, delta, bh, q0, sq);

  float dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.0f;

  const int kv_end = causal ? min(skv, q0 + kTile) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();   // the last iteration is done with ks, vs, dss
    stage<T, D>(ks, kg + (size_t)k0 * D, skv - k0);
    stage<T, D>(vs, vg + (size_t)k0 * D, skv - k0);
    cp_async_wait_all();
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt<T, D>(qs, ks, ty, tx, s);
    tile_abt<T, D>(dos, vs, ty, tx, dp);
    softmax_grad(s, dp, lses, dels, nullptr, dss, q0, k0, sq, skv, scale, causal, ty, tx);
    __syncthreads();
    tile_acc<T, D, false>(dss, ks, ty, tx, dq_acc);      // dQ += dS K
  }
  if (kv_end <= 0) cp_async_wait_all();       // no kv block: Q and dO still in flight
  write_rows<T, D>(dq + (size_t)bh * sq * D, q0, sq, ty, tx, dq_acc, scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int bh, int sq, int skv, int hq, int hkv, float scale,
                   int causal, cudaStream_t stream) {
  const int bhkv = bh / hq * hkv;
  const long long rows = (long long)bh * sq;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t kv_smem = dkdv_smem_bytes<T, D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3((skv + kTile - 1) / kTile, bhkv), kThreads, kv_smem,
                                stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      skv, hq, hkv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t q_smem = dq_smem_bytes<T, D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3((sq + kTile - 1) / kTile, bh), kThreads, q_smem,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sq, skv, hq, hkv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int bh, int sq, int skv, int hq, int hkv, float scale,
                     int causal, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, sq, skv, hq,
                                  hkv, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, sq, skv,
                                    hq, hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Kernel>
cudaError_t attributes(Kernel kernel, int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t attributes_of(int which, int* num_regs, int* max_threads, int* local_bytes) {
  switch (which) {
    case 0: return attributes(flash_bwd_delta_kernel<T, D>, num_regs, max_threads,
                              local_bytes);
    case 1: return attributes(flash_bwd_dkdv_kernel<T, D>, num_regs, max_threads,
                              local_bytes);
    case 2: return attributes(flash_bwd_dq_kernel<T, D>, num_regs, max_threads,
                              local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t attributes_d(int d, int which, int* num_regs, int* max_threads,
                         int* local_bytes) {
  switch (d) {
    case 64: return attributes_of<T, 64>(which, num_regs, max_threads, local_bytes);
    case 128: return attributes_of<T, 128>(which, num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns cudaGetLastError() (0
// on success); the caller has checked shapes, dtypes, alignment and head
// dim (64 or 128) and allocated delta, f32 (bh, sq).
int klaraptor_flash_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv, int bh, int sq,
                                  int skv, int d, int hq, int hkv, float scale, int causal,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (dtype) {
    case kF32:
      return launch_d<float>(d, q, k, v, o, dout, l, dl, dq, dk, dv, bh, sq, skv, hq, hkv,
                             scale, causal, s);
    case kBF16:
      return launch_d<__nv_bfloat16>(d, q, k, v, o, dout, l, dl, dq, dk, dv, bh, sq, skv, hq,
                                     hkv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// kernel `which` (0 delta, 1 dK / dV, 2 dQ) for (dtype, head dim d).
int klaraptor_flash_attention_bwd_attributes(int dtype, int d, int which, int* num_regs,
                                             int* max_threads, int* local_bytes) {
  switch (dtype) {
    case kF32: return attributes_d<float>(d, which, num_regs, max_threads, local_bytes);
    case kBF16:
      return attributes_d<__nv_bfloat16>(d, which, num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

const char* klaraptor_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
