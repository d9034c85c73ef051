// One f32 GEMM mainloop for Hopper (sm_90a): FP32 FMAs on the CUDA cores,
// fed by a cp.async ring.
//
// Shared by csrc/matmul.cu (C = x @ y, f32 inputs) and csrc/moe_gmm.cu
// (out[e] = x[e] @ w[e], f32).  Both see a batch of products on blockIdx.z,
// x (batch, m, k) and y (batch, k, n) row-major f32, out (batch, m, n); the
// plain matmul is the batch of one.
//
// Bound on an H100 SXM (67 TFLOP/s FP32 on the CUDA cores, 3.35 TB/s HBM3):
// at the sizes it is tuned for (m, n, k in the hundreds to thousands) a
// product does 2mnk FLOPs on (mk + kn + mn) f32 elements, over a hundred
// FLOPs per byte, so it is bound by the FP32 FMA rate.  wgmma would take f32
// only as TF32, whose ten mantissa bits break the port's 2e-4 f32 tolerance.
//
// What this design does about it:
//   * each thread owns kMicro x kMicro = 64 outputs: rows tr + i * (bm / 8)
//     (i < 8) and two 4-wide column runs, 4 * tc + {0..3} and bn / 2 + 4 * tc
//     + {0..3}.  Per k step it reads its y fragment as two 16-byte shared
//     loads, and per two k steps its x fragment as eight 8-byte loads (k,
//     k + 1 of each row): 12 loads per 128 FMAs where scalar fragments took
//     32.  x read four k steps at a time (16-byte loads) needs 32 fragment
//     registers and spills under the 128-register cap;
//   * where the CTA's thread grid allows (bn / 8 % 8 == 0, bm / 8 % 4 ==
//     0), a warp is a 4 x 8 block of (tr, tc), as in CUTLASS's SIMT GEMM:
//     an 8-lane quarter of the warp reads one x address (a broadcast) and 8
//     consecutive y runs, and the rows' padding keeps a warp's 4 x rows in
//     distinct banks.  Other thread grids take tr = tid / (bn / 8), equally
//     conflict-free;
//   * the k tiles stream through kStages shared-memory slots filled with
//     16-byte cp.async.cg copies (one commit group per tile): the copy of
//     tile t + kStages - 1 is issued right after the one barrier of step t,
//     into the slot step t - 1 read, and lands while steps t .. t +
//     kStages - 2 compute;
//   * y (bk, bn) goes in row-major as in memory; x (bm, bk) goes in
//     row-major too, each row padded by kPad words: cp.async cannot
//     transpose, and with (bk + 4) words per row the rows of a warp's x
//     loads fall in distinct bank groups for every bk % 8 == 0;
//   * the epilogue writes each 4-wide run as one 16-byte store (8 bytes for
//     bf16 and f16 outputs).
// What still holds it back on the card: the shared-memory pipe moves one
// 128-byte wavefront per clock while the SM issues four warp-FMAs, and a
// warp's 16-byte load costs four wavefronts unless each 8-lane quarter reads
// at most two addresses (8-byte loads: two, or 1.4): the 16 words a thread
// reads per 64 FMAs keep the pipe about 85 % busy at the FMA rate.  An 8 x
// 16 micro-tile (255 registers, 8 warps per SM) halves that share but ran
// slower for lack of warps to hide latency.
// bm, bn and bk are taken at run time (KLARAPTOR tunes them over its whole
// candidate grid): the CTA has (bm / 8) * (bn / 8) threads and
// smem_bytes(bm, bn, bk) of dynamic shared memory.  Requires m % bm == n %
// bn == k % bk == 0, bm % 8 == bn % 8 == bk % 8 == 0 and 16-byte aligned x
// and y; the wrappers check all of it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm_simt {

constexpr int kMicro = 8;          // each thread owns a kMicro x kMicro block
constexpr int kRun = 4;            // f32 words of one 16-byte vector
constexpr int kStages = 3;         // slots of the cp.async ring
constexpr int kPad = 4;            // f32 words of padding after each x row
constexpr int kMaxThreads = 512;   // launch bound: caps registers at 128/thread

// Dynamic shared memory of one CTA: kStages slots of a padded (bm, bk) x
// tile and a (bk, bn) y tile.
inline size_t smem_bytes(int bm, int bn, int bk) {
  return (size_t)kStages * ((size_t)bm * (bk + kPad) + (size_t)bk * bn) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four neighbouring outputs as one 16-byte (f32) or 8-byte store.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, float a, float b, float c, float d) {
  __half2 lo = __floats2half2_rn(a, b);
  __half2 hi = __floats2half2_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Copies of one (rows, cols) f32 tile into shared memory, 16 bytes each:
// vector v of the tile is row v / (cols / 4), column 4 * (v % (cols / 4)).
// A thread walks v = tid, tid + nthreads, ... by stepping (row, column)
// instead of dividing at every copy.
struct TileWalk {
  int row, col, drow, dcol;
  __device__ __forceinline__ TileWalk(int tid, int nthreads, int cols) {
    const int vecs = cols / kRun;
    row = tid / vecs;
    col = (tid % vecs) * kRun;
    drow = nthreads / vecs;
    dcol = (nthreads % vecs) * kRun;
  }
};

__device__ __forceinline__ void copy_tile(float* smem, int ld_smem, const float* gmem,
                                          size_t ld_gmem, int rows, int cols, TileWalk w) {
  while (w.row < rows) {
    cp_async16(smem + w.row * ld_smem + w.col, gmem + w.row * ld_gmem + w.col);
    w.row += w.drow;
    w.col += w.dcol;
    if (w.col >= cols) {
      w.col -= cols;
      ++w.row;
    }
  }
}

template <typename Tout>
__global__ void __launch_bounds__(kMaxThreads)
kernel(const float* __restrict__ x, const float* __restrict__ y, Tout* __restrict__ out,
       int m, int n, int k, int bm, int bn, int bk) {
  extern __shared__ __align__(16) float smem[];
  const int xld = bk + kPad;               // words per padded x row
  const int slot = bm * xld + bk * bn;     // words per ring slot

  const size_t b = blockIdx.z;
  x += b * (size_t)m * k;
  y += b * (size_t)k * n;
  out += b * (size_t)m * n;
  const int m0 = blockIdx.y * bm;
  const int n0 = blockIdx.x * bn;
  x += (size_t)m0 * k;
  y += n0;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rows = bm / kMicro;            // thread rows of the CTA
  const int cols = bn / kMicro;            // thread columns of the CTA
  int tr, tc;
  if (cols % 8 == 0 && rows % 4 == 0) {    // warps of 4 x 8 threads
    const int warp = tid / 32, lane = tid % 32, wcols = cols / 8;
    tr = (warp / wcols) * 4 + lane / 8;
    tc = (warp % wcols) * 8 + lane % 8;
  } else {
    tr = tid / cols;
    tc = tid % cols;
  }

  const TileWalk xw(tid, nthreads, bk);
  const TileWalk yw(tid, nthreads, bn);
  const int tiles = k / bk;
  auto load = [&](int t) {
    float* xs = smem + (t % kStages) * slot;
    copy_tile(xs, xld, x + (size_t)t * bk, (size_t)k, bm, bk, xw);
    copy_tile(xs + bm * xld, bn, y + (size_t)t * bk * n, (size_t)n, bk, bn, yw);
  };

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  // One commit group per tile, empty past the last, so that the count of
  // pending groups always names the tile that must have landed.
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }

  const int xstep = rows * xld;            // words between a thread's x rows
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();          // this thread's copies of tile t
    __syncthreads();                       // everyone's, and step t - 1 done
    if (t + kStages - 1 < tiles) load(t + kStages - 1);
    cp_async_commit();

    const float* xs = smem + (t % kStages) * slot + tr * xld;
    const float* ys = smem + (t % kStages) * slot + bm * xld + kRun * tc;
    // Eight k steps per iteration; per pair of steps, the x fragment is one
    // 8-byte load per row and the y fragment of each step two 16-byte runs.
#pragma unroll 1
    for (int kk = 0; kk < bk; kk += 8) {
#pragma unroll
      for (int k2 = kk; k2 < kk + 8; k2 += 2) {
        float2 a[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
          a[i] = *reinterpret_cast<const float2*>(xs + i * xstep + k2);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 b0 = *reinterpret_cast<const float4*>(ys + (k2 + q) * bn);
          const float4 b1 = *reinterpret_cast<const float4*>(ys + (k2 + q) * bn + bn / 2);
          const float bv[kMicro] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < kMicro; ++i) {
            const float av = q == 0 ? a[i].x : a[i].y;
#pragma unroll
            for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    Tout* o = out + (size_t)(m0 + tr + i * rows) * n + n0 + kRun * tc;
    store4(o, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    store4(o + bn / 2, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Launches the batch of products on `stream` and returns cudaGetLastError().
template <typename Tout>
cudaError_t launch(const float* x, const float* y, Tout* out, int batch, int m, int n, int k,
                   int bm, int bn, int bk, cudaStream_t stream) {
  const size_t smem = smem_bytes(bm, bn, bk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel<Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n / bn, m / bm, batch);
  const dim3 block((bm / kMicro) * (bn / kMicro));
  kernel<Tout><<<grid, block, smem, stream>>>(x, y, out, m, n, k, bm, bn, bk);
  return cudaGetLastError();
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// the f32 -> Tout instantiation.
template <typename Tout>
cudaError_t attributes(int* num_regs, int* max_threads, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel<Tout>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace gemm_simt
