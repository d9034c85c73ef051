// One bf16 GEMM mainloop for Hopper (sm_90a): wgmma fed by a TMA ring.
//
// Shared by csrc/matmul.cu (C = x @ y) and csrc/moe_gmm.cu (out[e] = x[e] @
// w[e]).  Both see a batch of e products, x (e, m, k) and y (e, k, n), both
// row-major bf16, and out (e, m, n); the plain matmul is the batch of one.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM3): at
// the shapes the port serves (m = 4096 tokens, n and k in the thousands) a
// product does 2mnk FLOPs on (mk + kn + mn) elements, hundreds of FLOPs per
// byte, so it is bound by operations on the tensor cores.
//
// What this design does about it:
//   * the CTA computes one (BM, BN) tile of out with BM / 64 consumer
//     warpgroups (128 or 256 threads); each issues
//     wgmma.mma_async.m64n{BN}k16.f32.bf16.bf16 over BK / 16 steps per k
//     tile and keeps its (64, BN) f32 accumulator in registers (BN / 2 per
//     thread);
//   * one elected thread (thread 0) loads the (BM, BK) x tile and the (BK,
//     BN) y tile of each k step with TMA (cp.async.bulk.tensor, 3-D tensor
//     maps over (k, m, e) and (n, k, e), 128-byte swizzle) into a ring of
//     kStages slots, each with a "full" mbarrier that counts the bytes in.
//     Under 128-byte swizzle a box row is at most 64 bf16, so a slot holds
//     BK / 64 boxes of x and BN / 64 boxes of y;
//   * x is K-major, wgmma's usual A layout; y (k, n) row-major is MN-major
//     for B and goes in through the descriptor's transpose bit, with no
//     transposing pass.  B's descriptor: 1024 bytes between 8-row k groups
//     (SBO), BK * 128 bytes between 64-wide n boxes (LBO);
//   * one wgmma group stays in flight (wgmma.wait_group 1): after tile kt's
//     group is issued, tile kt - 1's has retired, every thread arrives on
//     that slot's "empty" mbarrier, and thread 0 waits on it and refills the
//     slot with tile kt - 1 + kStages.  The loads of kStages - 1 tiles ahead
//     overlap the tensor cores;
//   * the epilogue converts the accumulator fragments to the output type
//     chosen at run time (f32, bf16 or f16: one instantiation per tile, not
//     per output type), stages them in the ring's shared memory and writes
//     whole rows of the tile with 16-byte stores.
// (BM, BN, BK) are template parameters (wgmma's N is an immediate and the
// swizzle fixes the k atom); the caller dispatches from its table of
// instantiations.  Tiles must divide m, n and k.  The PTX building blocks
// (barriers, TMA, descriptors, wgmma) are csrc/sm90.cuh's, shared with flash
// attention.  Warp specialisation,
// persistent CTAs (one tile's epilogue overlapping the next one's loads) and
// clusters with TMA multicast are later work.

#pragma once

#include <cuda_fp16.h>

#include "sm90.cuh"

namespace gemm_sm90 {

using namespace sm90;

constexpr int kStages = 4;         // slots of the TMA ring
constexpr int kMaxThreads = 256;   // two consumer warpgroups
// Dynamic shared memory beyond the ring: the full and empty barriers and the
// slack that aligns the ring to kAlign.
constexpr int kSmemExtra = kAlign + 2 * kStages * 8;

enum OutType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int BM, int BN, int BK>
constexpr int smem_bytes() {
  return kStages * (BM + BN) * BK * 2 + kSmemExtra;
}

// Two neighbouring outputs as one 4- or 8-byte store.
template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store2<__half>(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The epilogue.  Thread t of warpgroup w holds, for each 8-column block j of
// its 64 x BN fragment, d[4j], d[4j+1] at row 64 w + 16 (t / 32) + (t % 32) / 4,
// columns 8j + 2 (t % 4) and one more, and d[4j+2], d[4j+3] eight rows down.
// Stored straight to global memory, one warp instruction would write 16
// bytes into each of 8 rows; so the fragments go to shared memory first (rows
// padded by 16 bytes against bank conflicts), and the CTA then writes whole
// rows with 16-byte stores.  The ring is free by then and holds the tile: BM x (BN + 4)
// f32 at most, less than kStages slots.
template <typename T, int BM, int BN>
__device__ __forceinline__ void store_tile(const float* d, unsigned char* smem, void* out_v,
                                           size_t row0, int col0, int n) {
  constexpr int kLd = BN + 16 / sizeof(T);      // padded row, in elements
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte store
  static_assert(BM * kLd * sizeof(T) <= kStages * (BM + BN) * kAtom * 2,
                "the output tile fits the ring");
  T* tile = reinterpret_cast<T*>(smem);
  const int t = threadIdx.x % 128;
  const int r = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (t % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2<T>(tile + (r + h * 8) * kLd + c, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
  __syncthreads();
  T* out = static_cast<T*>(out_v);
  for (int i = threadIdx.x; i < BM * (BN / kVec); i += blockDim.x) {
    const int rr = i / (BN / kVec), cc = (i % (BN / kVec)) * kVec;
    *reinterpret_cast<uint4*>(out + (row0 + rr) * n + col0 + cc) =
        *reinterpret_cast<const uint4*>(tile + rr * kLd + cc);
  }
}

// out[e] = x[e] @ y[e] for e = blockIdx.z, the (BM, BN) tile at (blockIdx.x,
// blockIdx.y).  Requires m % BM == n % BN == k % BK == 0 and
// blockDim.x == 2 * BM.
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kMaxThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap ymap, void* out, int out_type,
            int m, int n, int k) {
  static_assert(BM % 64 == 0 && BM <= 128, "one warpgroup per 64 rows, at most two");
  static_assert(BN % 64 == 0 && BN <= 256, "wgmma N and whole swizzle boxes");
  static_assert(BK % kAtom == 0, "whole swizzle atoms along k");
  constexpr int kABytes = BM * BK * 2;          // one slot of x
  constexpr int kBBytes = BK * BN * 2;          // one slot of y
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* sa = smem;                                  // [kStages][BK/64][BM][64]
  unsigned char* sb = smem + kStages * kABytes;              // [kStages][BN/64][BK][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kBBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int ktiles = k / BK;

  auto load = [&](int kt, int s) {
    mbar_expect_tx(&full[s], kABytes + kBBytes);
#pragma unroll
    for (int b = 0; b < BK / kAtom; ++b)
      tma_load(sa + s * kABytes + b * BM * 128, &xmap, &full[s], kt * BK + b * kAtom, m0, e);
#pragma unroll
    for (int b = 0; b < BN / kAtom; ++b)
      tma_load(sb + s * kBBytes + b * BK * 128, &ymap, &full[s], n0 + b * kAtom, kt * BK, e);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], blockDim.x);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages && s < ktiles; ++s) load(s, s);
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  const uint32_t a_base = smem_addr(sa) + wg * 64 * 128;
  const uint32_t b_base = smem_addr(sb);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = make_desc(
          a_base + s * kABytes + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = make_desc(b_base + s * kBBytes + kk * 16 * 128, BK * 128, 1024);
      Wgmma<BN, kMNMajor>::mma(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0) {
      // tile kt - 1's wgmmas have retired: release its slot, and refill it
      const int ps = (kt - 1) % kStages;
      mbar_arrive(&empty[ps]);
      if (tid == 0 && kt - 1 + kStages < ktiles) {
        mbar_wait(&empty[ps], ((kt - 1) / kStages) & 1);
        load(kt - 1 + kStages, ps);
      }
    }
  }
  wgmma_wait<0>();
  __syncthreads();   // every warpgroup is done with the ring

  const size_t row0 = (size_t)e * m + m0;
  switch (out_type) {
    case kF32: store_tile<float, BM, BN>(acc, smem, out, row0, n0, n); break;
    case kBF16: store_tile<__nv_bfloat16, BM, BN>(acc, smem, out, row0, n0, n); break;
    case kF16: store_tile<__half, BM, BN>(acc, smem, out, row0, n0, n); break;
  }
}

template <int BM, int BN, int BK>
cudaError_t launch(const void* x, const void* y, void* out, int out_type, int e, int m,
                   int n, int k, cudaStream_t stream) {
  CUtensorMap xmap, ymap;
  if (!make_map(&xmap, x, k, m, e, BM) || !make_map(&ymap, y, n, k, e, BK))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<BM, BN, BK>();
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<BM, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(m / BM, n / BN, e);
  gemm_kernel<BM, BN, BK><<<grid, 2 * BM, smem, stream>>>(xmap, ymap, out, out_type, m, n, k);
  return cudaGetLastError();
}

template <int BM, int BN, int BK>
cudaError_t attributes(int* num_regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, gemm_kernel<BM, BN, BK>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaSuccess;
}

// The compiled tiles: every (BM, BN, BK) of {64, 128} x {64, 128, 256} x
// {64, 128} whose kStages-slot ring fits the 232448 bytes a block may have.
#define GEMM_SM90_TILES(X) \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128) X(64, 256, 64) \
  X(128, 64, 64) X(128, 64, 128) X(128, 128, 64) X(128, 256, 64)

// Launches the instantiation of tile (bm, bn, bk); cudaErrorInvalidValue for
// a tile that is not compiled.
inline cudaError_t dispatch(const void* x, const void* y, void* out, int out_type, int e,
                            int m, int n, int k, int bm, int bn, int bk,
                            cudaStream_t stream) {
#define GEMM_SM90_CASE(BM, BN, BK)                                              \
  if (bm == BM && bn == BN && bk == BK)                                          \
    return launch<BM, BN, BK>(x, y, out, out_type, e, m, n, k, stream);
  GEMM_SM90_TILES(GEMM_SM90_CASE)
#undef GEMM_SM90_CASE
  return cudaErrorInvalidValue;
}

// Registers per thread and spilled local bytes of tile (bm, bn, bk); with
// bm = 0 the largest register count and spill over all compiled tiles.
inline cudaError_t dispatch_attributes(int bm, int bn, int bk, int* num_regs,
                                       int* local_bytes) {
  int regs = 0, local = 0, found = 0;
#define GEMM_SM90_ATTR(BM, BN, BK)                                              \
  if (bm == 0 || (bm == BM && bn == BN && bk == BK)) {                           \
    int r, l;                                                                    \
    const cudaError_t err = attributes<BM, BN, BK>(&r, &l);                      \
    if (err != cudaSuccess) return err;                                          \
    regs = r > regs ? r : regs;                                                  \
    local = l > local ? l : local;                                               \
    found = 1;                                                                   \
  }
  GEMM_SM90_TILES(GEMM_SM90_ATTR)
#undef GEMM_SM90_ATTR
  if (!found) return cudaErrorInvalidValue;
  *num_regs = regs;
  *local_bytes = local;
  return cudaSuccess;
}

}  // namespace gemm_sm90
