// The bf16 grouped matmul's backward for Hopper (sm_90a): persistent wgmma
// bodies for its two products, each read in place.
//
//   * dX[e] = dY[e] W[e]^T (kDX): out (e, g, k) over M = g rows, N = k, K =
//     n.  A = dY (g, n) row-major is K-major; B = W^T is W (k, n) row-major
//     read along its rows, K-major too (the transpose bit clear).
//   * dW[e] = X[e]^T dY[e] (kDW): out (e, k, n) over M = k, N = n, K = g.
//     A = X^T is X (g, k) row-major, MN-major (wgmma's A transpose bit); B
//     = dY (g, n) row-major, MN-major.
//
// Replaces no TPU kernel: the JAX package differentiates moe_gmm_ref
// (src/repro/kernels/ref.py) with XLA.  Bound on an H100 SXM (989 TFLOP/s
// bf16, 3.35 TB/s HBM3): at an MoE layer in training the capacity rows g
// are short (qwen3-moe: 192) against k and n (4096, 1536), so each product
// does 2 g k n FLOPs on k n elements of W or dW and is bound by bytes --
// dX by reading W once, dW by writing it once.  At long capacity (grok-1:
// 640 rows, k and n 6144 / 32768) both are bound by operations.
//
// What this design does about it.  csrc/gemm_sm90.cuh, the forward's
// mainloop, runs one CTA per output tile with a blocking epilogue: a
// short-K product then runs ring fill, three k steps and a store one after
// another on each SM.  Here:
//   * persistent CTAs, one per SM, each walking many output tiles of one
//     expert-major order (gmm_bwd_kernel: m tiles fastest, or n tiles where
//     M exceeds N, so the smaller operand's expert stays in L2 while the
//     other streams; the row tiles that share one slab of W in dX run side
//     by side);
//   * one flat stream of k steps over all of a CTA's tiles feeds a ring of
//     kStages slots: thread 0 refills a slot as soon as every warpgroup has
//     retired its wgmmas, so the next tile's loads are in flight while this
//     tile's last steps and its epilogue run;
//   * an asynchronous epilogue (store_tile): each warpgroup converts its
//     64 x BN f32 fragment to bf16 into a 128-byte-swizzled staging tile of
//     its own and one of its threads hands it to the TMA
//     (cp.async.bulk.tensor, global <- shared), which drains while the next
//     tile computes; only the next epilogue of the same warpgroup waits for
//     it to have read the tile;
//   * BM = 64 x WGS rows, one consumer warpgroup per 64 rows: WGS = 3
//     covers qwen3-moe's whole padded capacity (192 rows), so each slab of
//     W crosses HBM once in dX.
// Every output element is one warpgroup's sum over K in a fixed order: no
// atomics, no split K, and two calls give the same bits whatever the grid
// or the walk.  Requires m % BM == n % BN == k % 64 == 0 (the wrapper
// pads).

#pragma once

#include "sm90.cuh"

namespace gmm_bwd_sm90 {

using namespace sm90;

constexpr int kBK = 64;                // one swizzle atom of k per ring slot
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may opt in to
constexpr int kMaxStages = 6;
enum Product { kDX = 1, kDW = 2 };

// The shared memory of tile (64 WGS, BN): the ring, the staging tiles and
// the barriers; kStages is as many slots (at most kMaxStages) as fit.
template <int WGS, int BN>
struct Tile {
  static constexpr int kBM = 64 * WGS;
  static constexpr int kThreads = 128 * WGS;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kSlotBytes = kABytes + kBBytes;
  static constexpr int kOutBytes = 64 * BN * 2;         // one warpgroup's staging tile
  static constexpr int kFixed = kAlign + WGS * kOutBytes + 2 * kMaxStages * 8;
  static constexpr int kFit = (kSmemLimit - kFixed) / kSlotBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kAlign + kStages * kSlotBytes + WGS * kOutBytes +
                               2 * kStages * 8;
  static_assert(kStages >= 2, "a ring of at least two slots fits");
};

// One warpgroup's epilogue: its 64 x BN f32 fragment as bf16 into its
// staging tile, 128-byte swizzled (16-byte chunk c of row r at chunk c ^ (r %
// 8), as the TMA reads it), then one TMA store per 64-column box to rows
// m0.. and columns n0.. of expert ee.  Thread 0 of the warpgroup issues the
// stores, after waiting for its last ones to have read the staging tile.
template <int BN>
__device__ __forceinline__ void store_tile(const float* acc, unsigned char* staging,
                                           const CUtensorMap* omap, int wg, int ee, int m0,
                                           int n0) {
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4;   // this thread's first fragment row
  if (t == 0) bulk_wait<0, true>();
  named_sync(1 + wg, 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(staging + (j / 8) * 64 * 128 + rr * 128 +
                                         (((j % 8) ^ (rr % 8)) << 4) + (t % 4) * 4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (t == 0) {
#pragma unroll
    for (int b = 0; b < BN / kAtom; ++b)
      tma_store(omap, staging + b * 64 * 128, n0 + b * kAtom, m0, ee);
    bulk_commit();
  }
}

// Tile `i` of an expert-major walk over e x (m / bm) x (n / bn) tiles: m
// tiles fastest (n_fast 0: the m tiles that share one slab of B run side by
// side) or n tiles fastest (n_fast 1: those that share one slab of A).
__device__ __forceinline__ void tile_coords(int i, int mtiles, int ntiles, int n_fast, int bm,
                                            int bn, int& ee, int& m0, int& n0) {
  const int per_e = mtiles * ntiles;
  ee = i / per_e;
  i %= per_e;
  const int mt = n_fast ? i / ntiles : i % mtiles;
  const int nt = n_fast ? i % ntiles : i / mtiles;
  m0 = mt * bm;
  n0 = nt * bn;
}

// out[e] = A[e] @ B[e] for PRODUCT, M x N per expert, over K, tiles of (64
// WGS, BN) walked persistently in the order n_fast names (see above).
template <int WGS, int BN, int PRODUCT>
__global__ void __launch_bounds__(128 * WGS, 1)
gmm_bwd_kernel(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap bmap,
               const __grid_constant__ CUtensorMap omap, int e, int m, int n, int k,
               int n_fast) {
  using T = Tile<WGS, BN>;
  constexpr int BM = T::kBM, S = T::kStages;
  static_assert(BN % 64 == 0 && BN <= 256, "wgmma N and whole swizzle boxes");
  static_assert(WGS >= 1 && WGS <= 3, "one to three consumer warpgroups");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  // ring slot s: A at s * kSlotBytes, B kABytes further.  kDX: A [BM][64],
  // B [BN][64]; kDW: A [BM/64][64 k][64], B [BN/64][64 k][64]
  unsigned char* ring = smem;
  unsigned char* staging = smem + S * T::kSlotBytes;     // [WGS][BN/64][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + WGS * T::kOutBytes);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int wg = tid / 128, t = tid % 128;
  const int mtiles = m / BM, ntiles = n / BN, ksteps = k / kBK;
  const int tiles = e * mtiles * ntiles;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
                       : 0;
  const int steps = mine * ksteps;

  // The coordinates of this CTA's tile number `local`.
  auto coords = [&](int local, int& ee, int& m0, int& n0) {
    tile_coords((int)blockIdx.x + local * (int)gridDim.x, mtiles, ntiles, n_fast, BM, BN, ee,
                m0, n0);
  };
  // Loads flat k step f into slot f % S.
  auto load = [&](int f) {
    const int s = f % S;
    int ee, m0, n0;
    coords(f / ksteps, ee, m0, n0);
    const int k0 = (f % ksteps) * kBK;
    unsigned char* sa = ring + s * T::kSlotBytes;
    unsigned char* sb = sa + T::kABytes;
    mbar_expect_tx(&full[s], T::kSlotBytes);
    if constexpr (PRODUCT == kDW) {
#pragma unroll
      for (int b = 0; b < BM / kAtom; ++b)
        tma_load(sa + b * kBK * 128, &amap, &full[s], m0 + b * kAtom, k0, ee);
#pragma unroll
      for (int b = 0; b < BN / kAtom; ++b)
        tma_load(sb + b * kBK * 128, &bmap, &full[s], n0 + b * kAtom, k0, ee);
    } else {
      tma_load(sa, &amap, &full[s], k0, m0, ee);
      tma_load(sb, &bmap, &full[s], k0, n0, ee);
    }
  };
  // Every warpgroup is done with flat step f: free its slot, and refill it
  // with step f + S.
  auto release = [&](int f) {
    mbar_arrive(&empty[f % S]);
    if (tid == 0 && f + S < steps) {
      mbar_wait(&empty[f % S], (f / S) & 1);
      load(f + S);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int f = 0; f < S && f < steps; ++f) load(f);
  }

  float acc[BN / 2];
  // warpgroup wg's 64 rows of A: 64 rows of 128 bytes (kDX) or the wg-th
  // 64-wide box of kBK rows (kDW); 8 KiB either way
  const uint32_t a_base = smem_addr(ring) + wg * 64 * 128;
  const uint32_t b_base = smem_addr(ring) + T::kABytes;

  int f = 0;
  for (int local = 0; local < mine; ++local) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < ksteps; ++kt, ++f) {
      const int s = f % S;
      mbar_wait(&full[s], (f / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a = a_base + s * T::kSlotBytes;
        const uint32_t b = b_base + s * T::kSlotBytes;
        if constexpr (PRODUCT == kDW) {
          Wgmma<BN, kMNMajor, kMNMajor>::mma(acc, make_desc(a + kk * 16 * 128, kBK * 128, 1024),
                                             make_desc(b + kk * 16 * 128, kBK * 128, 1024));
        } else {
          Wgmma<BN, kKMajor, kKMajor>::mma(acc, make_desc(a + kk * 32, 16, 1024),
                                           make_desc(b + kk * 32, 16, 1024));
        }
      }
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();   // step f - 1's wgmmas have retired
        release(f - 1);
      }
    }
    wgmma_wait<0>();
    release(f - 1);
    int ee, m0, n0;
    coords(local, ee, m0, n0);
    store_tile<BN>(acc, staging + wg * T::kOutBytes, &omap, wg, ee, m0 + wg * 64, n0);
  }
  if (t == 0) bulk_wait<0, false>();
}

// Launches PRODUCT at tile (64 wgs, bn) on `ctas` persistent CTAs: a (e, m,
// k) and b (e, n, k) for kDX (dY and W), a (e, k, m) and b (e, k, n) for
// kDW (X and dY), out (e, m, n); all bf16, row-major.
template <int WGS, int BN, int PRODUCT>
cudaError_t launch(const void* a, const void* b, void* out, int e, int m, int n, int k,
                   int ctas, int n_fast, cudaStream_t stream) {
  using T = Tile<WGS, BN>;
  CUtensorMap amap, bmap, omap;
  const bool ok = PRODUCT == kDW
                      ? make_map(&amap, a, m, k, e, kBK) && make_map(&bmap, b, n, k, e, kBK)
                      : make_map(&amap, a, k, m, e, T::kBM) && make_map(&bmap, b, k, n, e, BN);
  if (!ok || !make_map(&omap, out, n, m, e, 64)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(gmm_bwd_kernel<WGS, BN, PRODUCT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               T::kSmem);
  if (err != cudaSuccess) return err;
  gmm_bwd_kernel<WGS, BN, PRODUCT><<<ctas, T::kThreads, T::kSmem, stream>>>(
      amap, bmap, omap, e, m, n, k, n_fast);
  return cudaGetLastError();
}

template <int WGS, int BN, int PRODUCT>
cudaError_t attributes(int* num_regs, int* local_bytes, int* smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, gmm_bwd_kernel<WGS, BN, PRODUCT>);
  if (err != cudaSuccess) return err;
  *num_regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem = Tile<WGS, BN>::kSmem;
  return cudaSuccess;
}

// The compiled tiles (warpgroups, BN): every pair of {1, 2, 3} x {64, 128,
// 256} but (3, 256), whose 128 accumulators a thread do not fit 384
// threads' registers.
#define GMM_BWD_SM90_TILES(X) \
  X(1, 64) X(1, 128) X(1, 256) X(2, 64) X(2, 128) X(2, 256) X(3, 64) X(3, 128)

// Launches PRODUCT at tile (bm, bn); cudaErrorInvalidValue for a tile that
// is not compiled.
template <int PRODUCT>
inline cudaError_t dispatch(const void* a, const void* b, void* out, int e, int m, int n,
                            int k, int bm, int bn, int ctas, int n_fast, cudaStream_t stream) {
#define GMM_BWD_CASE(WGS, BN)                                                    \
  if (bm == 64 * WGS && bn == BN)                                                \
    return launch<WGS, BN, PRODUCT>(a, b, out, e, m, n, k, ctas, n_fast, stream);
  GMM_BWD_SM90_TILES(GMM_BWD_CASE)
#undef GMM_BWD_CASE
  return cudaErrorInvalidValue;
}

template <int PRODUCT>
inline cudaError_t dispatch_attributes(int bm, int bn, int* num_regs, int* local_bytes,
                                       int* smem) {
#define GMM_BWD_ATTR(WGS, BN)                                                    \
  if (bm == 64 * WGS && bn == BN) return attributes<WGS, BN, PRODUCT>(num_regs, local_bytes, smem);
  GMM_BWD_SM90_TILES(GMM_BWD_ATTR)
#undef GMM_BWD_ATTR
  return cudaErrorInvalidValue;
}

}  // namespace gmm_bwd_sm90
