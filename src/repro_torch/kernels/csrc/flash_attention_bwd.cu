// Flash attention backward for Hopper (sm_90a): given q, k, v, the forward's
// output o, its log-sum-exp lse and the output's gradient do, the gradients
//   dq[bh, i] = scale * sum_j ds[i, j] k[kvh, j]
//   dk[kvh, j] = scale * sum_{bh in kvh's group, i} ds[i, j] q[bh, i]
//   dv[kvh, j] = sum_{bh in kvh's group, i} p[i, j] do[bh, i]
// with c[i, j] = scale * q[bh, i] . k[kvh, j], soft-capped to softcap *
// tanh(c / softcap) when a cap is given, p[i, j] = exp(c[i, j] - lse[bh, i])
// on the visible (query, key) pairs (causal or not, a sliding window
// qpos - kpos < window or none; GQA), dp[i, j] = do[bh, i] . v[kvh, j] and
// ds = p * (dp - delta[bh, i]) * g, delta = rowsum(do * o), g = 1 - (c /
// softcap)^2 the cap's derivative (1 with no cap).
//
// Replaces no TPU kernel: the JAX package trains with its plain attention
// (use_pallas=False) and takes XLA's autodiff of it
// (src/repro/kernels/ref.py::flash_attention_ref); none of its Pallas kernels
// has a backward.  The port's training forward runs the hand-written
// forward kernel on the card, so its gradient needs this one.  The design is
// FlashAttention-2's backward (Dao, 2023): K and V of a kv block stay put
// while the q blocks that see them stream past (dK, dV), and Q of a q block
// stays put while the kv blocks stream past (dQ).  Each output is summed by
// one CTA in a fixed order -- no float atomics, so the backward is
// deterministic -- at the price of S and dP computed twice, once per
// kernel: 7 products of 2 d FLOPs per visible pair where the function needs
// 5 (QK^T, dO V^T, P^T dO, dS^T Q, dS K).
//
// Bound on an H100 SXM: those 5 products are 2.5 times the forward's FLOPs,
// so at llama3.2-1b's prefill shape (bh 32, S 4096, d 64, causal) the
// backward does about 172 GFLOP on about 84 MB (q, k, v, o, do and lse read
// once, dq, dk, dv written once): bound by operations at the bf16
// tensor-core rate (989 TFLOP/s), 0.174 ms.  At its training shape (bh 256,
// S 256) it is 5.4 GFLOP on 42 MB: bound by bytes (3.35 TB/s), 12.6 us.
//
// The window and the cap.  Every kernel takes them as the forward does
// (flash_attention.cu): the window trims each CTA's range of blocks -- a kv
// block at k0 sees q rows below k0 + 63 + window, a q block at q0 sees kv
// rows from q0 - window + 1 -- and only the blocks that straddle an edge
// (the diagonal, the window's far edge, skv) test each pair.  With a cap,
// P must come from exactly the capped score the forward normalised, or its
// rows no longer sum to 1 and dV drifts with no single element far off: the
// wgmma body recomputes it by the forward's own formula in the log2 domain,
// x = post - 2 post / (2^(pre s) + 1) (pre = 2 scale log2(e) / softcap, post
// = softcap log2(e)), and g = 1 - (x / post)^2 goes into dS in registers
// before dS is rounded to bf16; the SIMT body uses tanhf as its forward
// does.  What the first wgmma version of this taught on the card (PERF.md
// §6): with the cap tested per score at run time and every block
// testing each score against the mask, llama's uncapped shapes ran 37-46 %
// slower than before the cap and window came in.  So the cap is a template
// parameter of both wgmma kernels (kCapped: the uncapped ones hold no trace
// of it), P is formed by one of two copies of its loop -- the blocks that
// straddle an edge test each score against its row's visible range, one
// unsigned compare (Range), the others test nothing -- and the uncapped
// d 64 dQ kernel is held to 128 registers for four CTAs an SM
// (dq_min_ctas).  What is left is within a few per cent of the kernels
// before them at llama's and internlm2's shapes.
//
// Two bodies, one C interface.
//
// bf16 at head dims 64, 128 and 256 -- the wgmma + TMA-ring body, three
// kernels:
//   * flash_bwd_prep_kernel: one warp per row; delta = rowsum(do * o) and
//     lse2 = lse * log2(e), both f32 (bh, sq_pad) with sq_pad = sq rounded up
//     to 64.  A row that sees no key (lse -inf) and a padding row get
//     lse2 = +inf, so 2^(x - lse2) is exactly 0 there with no test in the
//     products' loops; padding rows get delta 0.  Padded rows keep every
//     64-row run of lse2 and delta 256-byte aligned for the bulk copy.
//   * flash_bwd_dkdv_sm90_kernel<D, kCapped>: one CTA per (b * hkv, block
//     of 64 kv rows), one consumer warpgroup (128 threads) at D 64 and
//     128, two at D 256.  Thread 0 loads the (64, D) K and V tiles once by TMA (3-D maps
//     over (d, s, b * heads), 128-byte swizzle, a ragged tail zero-filled),
//     then walks the (q head of the group, 64-row q block) pairs that can
//     see the block -- from the diagonal on when causal, up to the window's
//     edge with one -- loading each pair's Q and dO tiles by TMA and its 64
//     lse2 and delta values by bulk copy into a ring of kStages slots with
//     full and empty mbarriers, the forward's protocol.  Per pair a
//     warpgroup computes
//       S^T = K Q^T      Wgmma<64, kKMajor>, A = K, B = Q (both K-major),
//       P^T = 2^(x(S^T) - lse2[col]) in registers,
//       dP^T = V dO^T    Wgmma<64, kKMajor>, A = V, B = dO,
//       dV += P^T dO     WgmmaRS<DW>: P^T's accumulator fragment is the A
//                        fragment (flash_attention.cu's note), B = dO read
//                        MN-major from the same tile under a second
//                        descriptor (the transpose bit),
//       dS^T = P^T g (dP^T - delta[col]) in registers,
//       dK += dS^T Q     WgmmaRS<DW>, B = Q MN-major,
//     DW = D / warpgroups: the columns of dK and dV a warpgroup holds.
//     lse2 and delta are indexed by column, read from the slot.  dV's
//     product is in flight while dS^T is formed (at DW = 64; at DW = 128 its
//     A fragments would cost the registers dS^T needs).  The epilogue
//     scales dK, converts both to bf16 and writes rows clipped at skv.
//   * flash_bwd_dq_sm90_kernel<D, kCapped>: one CTA per (b * hq, block of
//     64 q rows), one warpgroup.  Q and dO come in once by TMA and
//     the rows' lse2 and delta once into registers; the (64, D) K and V tiles
//     of each visible kv block stream through the ring.  Per block
//       S = Q K^T, dP = dO V^T   Wgmma<64, kKMajor>, issued together,
//       P g and dS = P g (dP - delta[row]) in registers, masked on the
//       blocks that straddle the diagonal, the window's edge or skv,
//       dQ += dS K               WgmmaRS<D>, B = K MN-major.
//     The epilogue scales dQ, converts it to bf16 and writes rows clipped
//     at sq.
//   What bounds it, and what the design does about it.  The products take
//   every FLOP, so they all run on the tensor cores (the SIMT body below
//   caps at the CUDA cores' 67 TFLOP/s); TMA keeps the loads off the
//   threads and the ring overlaps a slot's loads with the products of the
//   slot before it; P and dS never leave registers (no shared-memory round
//   trip, no barrier between the products).  Registers bound D = 128: dK
//   and dV are 2 x 64 x 128 f32 / 128 threads = 128 registers a thread
//   before S^T and dP^T (32 each), so P^T's bf16 fragments are formed
//   before dP^T is issued and __launch_bounds__(128, 1) lets a thread have
//   255 with no spill (chip_smoke.py [28] gates zero spilled bytes).  At
//   D = 256 they would be 256 registers a thread, over the 255 a thread can
//   have, so dK / dV splits D over two consumer warpgroups: each holds dK
//   and dV for 128 columns (the D = 128 kernel's registers) and recomputes
//   S^T and dP^T over the full D itself.  That costs two of the seven
//   products twice (9 against 7 per visible pair), where an exchange of
//   P^T and dS^T through shared memory would need 32 KB more than the 195
//   KB of K, V and the two ring slots leave under the 227 KB opt-in, and
//   two passes over the q blocks (dV, then dK) would cost the same products
//   twice and the loads of Q and dO twice as well.  dQ at D = 256 keeps one
//   warpgroup: 128 accumulator registers plus S and dP (32 each).  What is
//   left is latency: within a warpgroup each product waits for the one it
//   feeds on (S^T, then P^T, then dV and dS^T, then dK), and the CTAs an SM
//   holds fill few of the gaps, so the tensor cores idle most of a step;
//   the dK / dV kernel takes most of the time.  Both kernels work on 64-row
//   blocks: 128-row blocks (two warpgroups a CTA) were no faster at the
//   shapes PERF.md §6 lists.  A deeper ring, a register cap for a third CTA
//   per SM, and the next pair's S^T issued beside this pair's dK were each
//   tried on the card: each sped one shape and slowed another, and none is
//   kept.
//   Precision: P and dS are rounded once to bf16 for the register-A
//   products, as FlashAttention-2 and -3 do and as the JAX oracle rounds P
//   (no hi + lo split as in the forward's PV).  dq, dk and dv must stay
//   within chip_smoke.py [28] (a)'s 2e-2 x max |plain| (PERF.md §6 has the
//   values measured on the card); tests/test_torch_flash_attention.py's
//   einsum that rounds them so stays within 5e-3 of the plain version and
//   jax.vjp on the CPU, where the split would be within 1e-5.
//
// f32 -- the SIMT body: wgmma takes f32 only as TF32.
//   * flash_bwd_delta_kernel: delta = rowsum(do * o), one warp per row.
//   * flash_bwd_dkdv_kernel: one CTA per (kv head, block of 64 kv rows),
//     looping over the q heads of the group and the q blocks that can see
//     the kv block, recomputing S = Q K^T and P from lse, dP = dO V^T and
//     dS, and accumulating dV += P^T dO and dK += dS^T Q in registers.
//   * flash_bwd_dq_kernel: one CTA per (q head, block of 64 q rows), looping
//     over the kv blocks the rows can see: dQ += dS K.
//   256 threads; 64 x 64 tiles of S, dP, P and dS, each thread holding 4 x 4
//   of them (rows ty + 16 i, columns tx + 16 j with ty = tid / 16, tx = tid
//   % 16) and 4 x (D / 16) of the (64, D) accumulators.  The Q, dO, K and V
//   tiles come in by 16-byte cp.async copies into rows padded by 16 bytes
//   (a row's stride is 4 words past a multiple of 32 banks, so the 16-byte
//   reads of 8 consecutive rows fall in 32 distinct banks), rows past sq or
//   skv zero-filled by the copy.  P and dS go through f32 shared memory, rows
//   padded by 16 words.  Every product is FP32 FMAs.  Head dims 64 and 128:
//   at 256 its four staged tiles and two P / dS tiles need 307 KB of shared
//   memory, so the wrapper refuses f32 at head dim 256.
//
// Any sq and skv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // q rows and kv rows per block
constexpr int kLdp = kTile + 16;       // f32 row stride of the P and dS tiles

enum DType { kF32 = 0, kBF16 = 1 };

// A compile-time flag for a generic lambda's argument (std::integral_constant
// converts to bool on the host only).
template <bool B> struct Flag {
  static constexpr bool value = B;
};

// A range of positions [lo, lo + span) tested with one unsigned compare.
struct Range {
  unsigned lo, span;
  __host__ __device__ bool has(int pos) const { return (unsigned)pos - lo < span; }
  __host__ __device__ static Range of(long long lo, long long hi) {
    return {(unsigned)lo, hi > lo ? (unsigned)(hi - lo) : 0u};
  }
};

// Which (query, key) pairs attention computes, and the score's scale and cap
// (softcap <= 0: none): the forward's arguments, one struct for all kernels.
struct Attn {
  float scale;
  float softcap;
  int causal;
  int has_window;
  int window;
  __host__ __device__ bool visible(int qpos, int kpos) const {
    return (!causal || kpos <= qpos) && (!has_window || qpos - kpos < window);
  }
  // First q row of a kv block at k0 that can see it, and the row past the
  // last (64-row blocks; q_end <= q_begin: none).
  __host__ __device__ int q_begin(int k0) const { return causal ? k0 : 0; }
  __host__ __device__ int q_end(int k0, int sq) const {
    if (!has_window) return sq;
    const long long e = (long long)k0 + 63 + window;   // qpos - kpos < window
    return (int)(e < sq ? (e > 0 ? e : 0) : sq);
  }
  // First kv row of the 64-row block where a q block at q0 starts seeing
  // keys (a multiple of 64, at most skv), and the kv row past the last.
  __host__ __device__ int kv_begin(int q0, int skv) const {
    if (!has_window) return 0;
    const long long lo = (long long)q0 - window + 1;  // first key row q0 sees
    return lo > 0 ? (int)(lo / 64 * 64 < skv ? lo / 64 * 64 : skv) : 0;
  }
  __host__ __device__ int kv_end(int q0, int skv) const {
    return causal ? (q0 + 64 < skv ? q0 + 64 : skv) : skv;
  }
  // The keys below skv query qpos sees, and the queries that see key kpos:
  // what the wgmma kernels test each score against, one compare a score.
  __host__ __device__ Range keys_of(int qpos, int skv) const {
    const long long lo = has_window ? (long long)qpos - window + 1 : 0;
    const long long hi = causal ? (qpos + 1LL < skv ? qpos + 1LL : skv) : skv;
    return Range::of(lo > 0 ? lo : 0, hi);
  }
  __host__ __device__ Range queries_of(int kpos) const {
    const long long hi = has_window ? (long long)kpos + window : 0x7fffffffLL;
    return Range::of(causal ? kpos : 0, hi < 0x7fffffffLL ? hi : 0x7fffffffLL);
  }
  // Whether the 64 x 64 block of q rows from q0 and kv rows from k0 holds a
  // pair that is not visible (tails past sq or skv aside).
  __host__ __device__ bool straddles(int q0, int k0) const {
    return (causal && q0 < k0 + 63) || (has_window && q0 + 63 - k0 >= window);
  }
};

// Elements per 16-byte chunk, and the padded row stride of a staged tile.
template <typename T> constexpr int kVec = 16 / sizeof(T);
template <typename T, int D> constexpr int kLd = D + kVec<T>;

__device__ __forceinline__ void unpack(uint32_t w, float& a, float& b) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
  a = __low2float(h);
  b = __high2float(h);
}

// N consecutive f32 at p (shared memory, 16-byte aligned).
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

// N f32 values stored as N consecutive elements at p (global memory).
template <int N>
__device__ __forceinline__ void store(float* p, const float* x) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                                  x[4 * i + 3]);
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
// dss[row][col] = p g (dp - delta[row]); p = 0 off the visible pairs and on
// rows that see no key (lse -inf).  The cap as the SIMT forward takes it:
// c = softcap tanhf(scale s / softcap), g = 1 - (c / softcap)^2.
__device__ __forceinline__ void softmax_grad(const float (&s)[4][4], const float (&dp)[4][4],
                                             const float* lses, const float* dels,
                                             float* ps, float* dss, int q0, int k0, int sq,
                                             int skv, const Attn& at, int ty, int tx) {
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
      const bool vis = qpos < sq && kpos < skv && at.visible(qpos, kpos) &&
                       lse != -INFINITY;
      float c = s[i][j] * at.scale;
      float g = 1.0f;
      if (at.softcap > 0.0f) {
        const float t = tanhf(c / at.softcap);
        c = at.softcap * t;
        g = fmaf(-t, t, 1.0f);
      }
      const float p = vis ? expf(c - lse) : 0.0f;
      if (ps != nullptr) ps[row * kLdp + col] = p;
      dss[row * kLdp + col] = p * g * (dp[i][j] - delta);
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
    acc = fmaf(o[row * D + d], dout[row * D + d], acc);
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
                      int hkv, Attn at) {
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

  // q rows before k0 see no key of this block when causal, and rows from
  // k0 + 63 + window none with a window
  const int q_begin = at.q_begin(k0);
  const int q_end = at.q_end(k0, sq);
  for (int g = 0; g < group; ++g) {
    const int bh = b * hq + kvh * group + g;
    for (int q0 = q_begin; q0 < q_end; q0 += kTile) {
      __syncthreads();   // the last iteration is done with qs, dos, ps, dss
      stage<T, D>(qs, q + ((size_t)bh * sq + q0) * D, sq - q0);
      stage<T, D>(dos, dout + ((size_t)bh * sq + q0) * D, sq - q0);
      stage_rows(lses, dels, lse, delta, bh, q0, sq);
      cp_async_wait_all();
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_abt<T, D>(qs, ks, ty, tx, s);
      tile_abt<T, D>(dos, vs, ty, tx, dp);
      softmax_grad(s, dp, lses, dels, ps, dss, q0, k0, sq, skv, at, ty, tx);
      __syncthreads();
      tile_acc<T, D, true>(ps, dos, ty, tx, dv_acc);    // dV += P^T dO
      tile_acc<T, D, true>(dss, qs, ty, tx, dk_acc);    // dK += dS^T Q
    }
  }
  cp_async_wait_all();     // no q row: K and V may still be in flight
  T* dkg = dk + (size_t)bkv * skv * D;
  T* dvg = dv + (size_t)bkv * skv * D;
  write_rows<T, D>(dkg, k0, skv, ty, tx, dk_acc, at.scale);
  write_rows<T, D>(dvg, k0, skv, ty, tx, dv_acc, 1.0f);
}

// q, dout, dq: (bh, sq, D); k, v: (bh / hq * hkv, skv, D); lse, delta: (bh,
// sq) f32.  gridDim = (ceil(sq / 64), bh).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int skv, int hq, int hkv, Attn at) {
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

  const int kv_end = at.kv_end(q0, skv);
  for (int k0 = at.kv_begin(q0, skv); k0 < kv_end; k0 += kTile) {
    __syncthreads();   // the last iteration is done with ks, vs, dss
    stage<T, D>(ks, kg + (size_t)k0 * D, skv - k0);
    stage<T, D>(vs, vg + (size_t)k0 * D, skv - k0);
    cp_async_wait_all();
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt<T, D>(qs, ks, ty, tx, s);
    tile_abt<T, D>(dos, vs, ty, tx, dp);
    softmax_grad(s, dp, lses, dels, nullptr, dss, q0, k0, sq, skv, at, ty, tx);
    __syncthreads();
    tile_acc<T, D, false>(dss, ks, ty, tx, dq_acc);      // dQ += dS K
  }
  cp_async_wait_all();     // no kv block: Q and dO may still be in flight
  write_rows<T, D>(dq + (size_t)bh * sq * D, q0, sq, ty, tx, dq_acc, at.scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int bh, int sq, int skv, int hq, int hkv, Attn at,
                   cudaStream_t stream) {
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
      skv, hq, hkv, at);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t q_smem = dq_smem_bytes<T, D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3((sq + kTile - 1) / kTile, bh), kThreads, q_smem,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sq, skv, hq, hkv, at);
  return cudaGetLastError();
}

cudaError_t simt_launch_d(int d, const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, void* dq,
                          void* dk, void* dv, int bh, int sq, int skv, int hq, int hkv,
                          Attn at, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, sq, skv,
                                      hq, hkv, at, stream);
    case 128: return launch<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, sq,
                                        skv, hq, hkv, at, stream);
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

cudaError_t simt_attributes_d(int d, int which, int* num_regs, int* max_threads,
                              int* local_bytes) {
  switch (d) {
    case 64: return attributes_of<float, 64>(which, num_regs, max_threads, local_bytes);
    case 128: return attributes_of<float, 128>(which, num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16, head dims 64, 128 and 256: the wgmma + TMA-ring body
// ---------------------------------------------------------------------------

constexpr int kStages = 2;             // slots of each kernel's TMA ring
constexpr int kSm90Threads = 128;      // one consumer warpgroup
constexpr int kBlock = 64;             // rows of every tile, the warpgroup's
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may opt in to
// Dynamic shared memory beyond the tiles: the 1 KiB alignment slack and the
// full, empty and once-loaded tiles' barriers.
constexpr int kSm90SmemExtra = sm90::kAlign + (2 * kStages + 1) * 8;
constexpr float kLog2e = 1.4426950408889634f;

// The dK / dV kernel's consumer warpgroups at head dim D: two at D = 256,
// each holding dK and dV for D / 2 columns (the header's note on registers).
template <int D>
__host__ __device__ constexpr int dkdv_groups() {
  return D > 128 ? 2 : 1;
}

// A dK / dV ring slot: the Q and dO tiles, then 64 lse2 and 64 delta values
// (512 bytes, rounded up to keep the next slot's tiles 1 KiB aligned).
template <int D>
__host__ __device__ constexpr int dkdv_slot_bytes() {
  return 2 * kBlock * D * 2 + sm90::kAlign;
}

template <int D>
__host__ __device__ constexpr int dkdv_sm90_smem_bytes() {
  return 2 * kBlock * D * 2 + kStages * dkdv_slot_bytes<D>() + kSm90SmemExtra;
}

template <int D>
__host__ __device__ constexpr int dq_sm90_smem_bytes() {
  return 2 * kBlock * D * 2 + kStages * 2 * kBlock * D * 2 + kSm90SmemExtra;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x and 1 / x on the special function unit, one instruction each, as the
// forward computes them (relative error about 2^-22; 2^-inf is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The score in the log2 domain, exactly as the forward's wgmma body forms
// it (flash_attention.cu): x = s pre, or with a cap (kCapped) post - 2 post
// / (2^(s pre) + 1); g = 1 - (x / post)^2 is the cap's derivative (a
// template parameter: the header says why).
template <bool kCapped>
struct Score {
  float pre, post, inv_post;
  __device__ Score(float scale, float softcap)
      : pre(kCapped ? 2.0f * kLog2e * scale / softcap : scale * kLog2e),
        post(softcap * kLog2e),
        inv_post(kCapped ? 1.0f / (softcap * kLog2e) : 0.0f) {}
  // p = 2^(x - l2), 0 where `hidden`; g into *g (the constant 1 with no
  // cap, which the callers' p g folds away).
  __device__ __forceinline__ float p(float s, float l2, bool hidden, float* g) const {
    float x;
    if constexpr (kCapped) {
      x = fmaf(rcp(ex2(s * pre) + 1.0f), -2.0f * post, post);
      const float c = x * inv_post;
      *g = fmaf(-c, c, 1.0f);
      x -= l2;
    } else {
      x = fmaf(s, pre, -l2);
      *g = 1.0f;
    }
    if (hidden) x = __uint_as_float(0xff800000u);   // -inf: p = 0 exactly
    return ex2(x);
  }
};

// N columns of a (64, N) accumulator fragment times `mul`, in bf16, into
// dst, a row-major array of rows LD elements apart: this thread's rows row0
// and row0 + 8, those below `rows`.
template <int N, int LD>
__device__ __forceinline__ void write_fragment(__nv_bfloat16* dst, int row0, int rows,
                                               const float* acc, float mul, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= rows) continue;
    __nv_bfloat16* p = dst + (size_t)r * LD + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// delta[row] = rowsum(do * o) and lse2[row] = lse * log2(e) over rows of
// (bh, sq_pad): +inf where lse is -inf (no visible key) and on padding rows,
// whose delta is 0.  One warp per row.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      float* __restrict__ lse2, int sq, int sq_pad, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / sq_pad;
  const int s = (int)(row % sq_pad);
  float acc = 0.0f;
  float l2 = INFINITY;
  if (s < sq) {
    const long long at = bh * sq + s;
    const uint32_t* o2 = reinterpret_cast<const uint32_t*>(o + at * D);
    const uint32_t* d2 = reinterpret_cast<const uint32_t*>(dout + at * D);
#pragma unroll
    for (int i = lane; i < D / 2; i += 32) {
      float a, b, c, e;
      unpack(o2[i], a, b);
      unpack(d2[i], c, e);
      acc = fmaf(a, c, fmaf(b, e, acc));
    }
    const float l = lse[at];
    if (l != -INFINITY) l2 = l * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = l2;
  }
}

// q, dout: (bh, sq, D) through qmap and domap, k, v: (bh / hq * hkv, skv, D)
// through kmap and vmap, all in boxes of 64 rows; lse2, delta: f32 (bh,
// sq_pad); dk, dv: like k, row-major.  blockDim.x == 128 * dkdv_groups<D>(),
// gridDim = (ceil(skv / 64), bh / hq * hkv).
template <int D, bool kCapped>
__global__ void __launch_bounds__(kSm90Threads * dkdv_groups<D>(), 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap domap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const float* __restrict__ lse2,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int sq, int sq_pad, int skv, int hq, int hkv, Attn at) {
  using namespace sm90;
  constexpr int DW = D / dkdv_groups<D>();       // dK and dV columns a warpgroup holds
  static_assert(D % kAtom == 0 && DW <= 128, "whole swizzle boxes; registers");
  static_assert(dkdv_sm90_smem_bytes<D>() <= kSmemLimit, "shared memory");
  constexpr int kKVBytes = kBlock * D * 2;        // the K or the V tile
  constexpr int kTileBytes = kBlock * D * 2;      // a Q or a dO tile
  constexpr int kRowBytes = kBlock * 4;           // a tile's lse2 or delta
  constexpr int kSlotBytes = dkdv_slot_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* ks = smem;                                   // [D/64][64][64]
  unsigned char* vs = smem + kKVBytes;
  unsigned char* ring = smem + 2 * kKVBytes;    // [kStages][Q, dO, lse2, delta]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlotBytes);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  constexpr bool kSplit = dkdv_groups<D>() > 1;
  const int tid = threadIdx.x;
  const int wg = kSplit ? tid / kSm90Threads : 0;   // its columns: [wg DW, wg DW + DW)
  const int t = kSplit ? tid % kSm90Threads : tid;
  const int lane = t % 32;
  const int bkv = blockIdx.y;                 // b * hkv + kv head
  const int k0 = blockIdx.x * kBlock;         // kv block 0 sees the most q rows
  const int group = hq / hkv;
  const int bh0 = (bkv / hkv) * hq + (bkv % hkv) * group;   // the group's first q head
  // q rows before k0 see no key of this block when causal (k0 % 64 == 0),
  // and rows from k0 + 63 + window none with a window
  const int q_begin = at.q_begin(k0);
  const int q_end = at.q_end(k0, sq);
  const int nq = q_begin < q_end ? (q_end - q_begin + kBlock - 1) / kBlock : 0;
  const int n_it = group * nq;                // (q head, q block) pairs

  auto load_q = [&](int it, int s) {
    unsigned char* slot = ring + s * kSlotBytes;
    const int bh = bh0 + it / nq;
    const int q0 = q_begin + (it % nq) * kBlock;
    const size_t row = (size_t)bh * sq_pad + q0;
    mbar_expect_tx(&full[s], 2 * kTileBytes + 2 * kRowBytes);
#pragma unroll
    for (int b = 0; b < D / kAtom; ++b) {
      tma_load(slot + b * kBlock * 128, &qmap, &full[s], b * kAtom, q0, bh);
      tma_load(slot + kTileBytes + b * kBlock * 128, &domap, &full[s], b * kAtom, q0, bh);
    }
    bulk_load(slot + 2 * kTileBytes, lse2 + row, kRowBytes, &full[s]);
    bulk_load(slot + 2 * kTileBytes + kRowBytes, delta + row, kRowBytes, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], blockDim.x);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_it > 0) {
    mbar_expect_tx(kvbar, 2 * kKVBytes);
#pragma unroll
    for (int b = 0; b < D / kAtom; ++b) {
      tma_load(ks + b * kBlock * 128, &kmap, kvbar, b * kAtom, k0, bkv);
      tma_load(vs + b * kBlock * 128, &vmap, kvbar, b * kAtom, k0, bkv);
    }
    for (int s = 0; s < kStages && s < n_it; ++s) load_q(s, s);
  }

  const Score<kCapped> score(at.scale, at.softcap);
  const int krow = k0 + (t / 32) * 16 + lane / 4;       // rows krow and krow + 8
  const int col0 = 2 * (lane % 4);                     // first fragment column
  const Range seen_by[2] = {at.queries_of(krow), at.queries_of(krow + 8)};
  // this warpgroup's columns of a Q or dO tile, read MN-major
  const uint32_t cols = wg * (DW / kAtom) * kBlock * 128;

  float dk_acc[DW / 2], dv_acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  if (n_it > 0) mbar_wait(kvbar, 0);
  const uint32_t k_base = smem_addr(ks);
  const uint32_t v_base = smem_addr(vs);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t q_base = smem_addr(ring + s * kSlotBytes);
    const uint32_t do_base = q_base + kTileBytes;
    const float* lrow = reinterpret_cast<const float*>(ring + s * kSlotBytes + 2 * kTileBytes);
    const float* drow = lrow + kBlock;
    const int q0 = q_begin + (it % nq) * kBlock;

    // S^T = K Q^T, over the full D in every warpgroup
    float st[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = make_desc(k_base + (kk / 4) * kBlock * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = make_desc(q_base + (kk / 4) * kBlock * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma<64, kKMajor>::mma(st, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // P^T = 2^(x(S^T) - lse2[col]), 0 off the visible pairs (tested only
    // in the blocks that straddle an edge: two copies of the loop); P^T in
    // bf16 as dV's A fragments, and P^T g kept in st for dS^T
    uint32_t pa[4][4];
    auto probabilities = [&](auto flag) {
      constexpr bool masked = decltype(flag)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * j + col0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const bool hidden = masked && !seen_by[h].has(q0 + 8 * j + col0 + e);
            float g;
            p[e] = score.p(st[i], e ? l2.y : l2.x, hidden, &g);
            st[i] = p[e] * g;
          }
          pa[j / 2][2 * (j % 2) + h] = pack_bf16(p[0], p[1]);
        }
      }
    };
    if (at.straddles(q0, k0)) probabilities(Flag<true>{});
    else probabilities(Flag<false>{});

    // dP^T = V dO^T, then dV += P^T dO (dO MN-major: the transpose bit)
    float dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dpt[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = make_desc(v_base + (kk / 4) * kBlock * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = make_desc(do_base + (kk / 4) * kBlock * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma<64, kKMajor>::mma(dpt, da, db);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<DW>::mma(dv_acc, pa[kk],
                       make_desc(do_base + cols + kk * 16 * 128, kBlock * 128, 1024));
    wgmma_commit();
    if constexpr (DW <= 64) wgmma_wait<1>();   // dP^T is done; dV may run on
    else wgmma_wait<0>();                       // pa's registers are dS^T's

    // dS^T = P^T g (dP^T - delta[col]), then dK += dS^T Q
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(drow + 8 * j + col0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        dsa[j / 2][2 * (j % 2) + h] =
            pack_bf16(st[i] * (dpt[i] - dl.x), st[i + 1] * (dpt[i + 1] - dl.y));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<DW>::mma(dk_acc, dsa[kk],
                       make_desc(q_base + cols + kk * 16 * 128, kBlock * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();

    // this slot's Q, dO, lse2 and delta are consumed: release it, and refill it
    mbar_arrive(&empty[s]);
    if (tid == 0 && it + kStages < n_it) {
      mbar_wait(&empty[s], (it / kStages) & 1);
      load_q(it + kStages, s);
    }
  }

  const size_t base = (size_t)bkv * skv * D + wg * DW;
  write_fragment<DW, D>(dk + base, krow, skv, dk_acc, at.scale, lane);
  write_fragment<DW, D>(dv + base, krow, skv, dv_acc, 1.0f, lane);
}

// CTAs an SM the dQ kernel asks its registers to leave room for: at D = 64
// without a cap four (at most 128 registers a thread, as the kernel used
// before it took the cap and window; left to itself ptxas takes 142 and an
// SM holds three), else one (the capped D = 64 kernel spills at 128).
template <int D, bool kCapped>
__host__ __device__ constexpr int dq_min_ctas() {
  return D == 64 && !kCapped ? 4 : 1;
}

// q, dout: (bh, sq, D) through qmap and domap, k, v: (bh / hq * hkv, skv, D)
// through kmap and vmap, all in boxes of 64 rows; lse2, delta: f32 (bh,
// sq_pad); dq: like q, row-major.  blockDim.x == 128, gridDim = (ceil(sq /
// 64), bh).
template <int D, bool kCapped>
__global__ void __launch_bounds__(kSm90Threads, dq_min_ctas<D, kCapped>())
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int sq, int sq_pad, int skv,
                         int hq, int hkv, Attn at) {
  using namespace sm90;
  static_assert(D % kAtom == 0 && D <= 256, "whole swizzle boxes, wgmma N <= 256");
  static_assert(dq_sm90_smem_bytes<D>() <= kSmemLimit, "shared memory");
  constexpr int kQBytes = kBlock * D * 2;       // the Q or the dO tile
  constexpr int kKVBytes = kBlock * D * 2;      // a K or a V tile
  constexpr int kSlotBytes = 2 * kKVBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* qs = smem;                                   // [D/64][64][64]
  unsigned char* dos = smem + kQBytes;
  unsigned char* ring = smem + 2 * kQBytes;                   // [kStages][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlotBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;   // longest causal rows first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // the kv blocks any row of this q block can see
  const int kv_begin = at.kv_begin(q0, skv);
  const int kv_end = at.kv_end(q0, skv);
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBlock - 1) / kBlock : 0;

  auto load_kv = [&](int it, int s) {
    unsigned char* slot = ring + s * kSlotBytes;
    const int k0 = kv_begin + it * kBlock;
    mbar_expect_tx(&full[s], kSlotBytes);
#pragma unroll
    for (int b = 0; b < D / kAtom; ++b) {
      tma_load(slot + b * kBlock * 128, &kmap, &full[s], b * kAtom, k0, kvh);
      tma_load(slot + kKVBytes + b * kBlock * 128, &vmap, &full[s], b * kAtom, k0, kvh);
    }
  };

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], blockDim.x);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(qbar, 2 * kQBytes);
#pragma unroll
    for (int b = 0; b < D / kAtom; ++b) {
      tma_load(qs + b * kBlock * 128, &qmap, qbar, b * kAtom, q0, bh);
      tma_load(dos + b * kBlock * 128, &domap, qbar, b * kAtom, q0, bh);
    }
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, s);
  }

  const Score<kCapped> score(at.scale, at.softcap);
  const int qrow = q0 + (t / 32) * 16 + lane / 4;       // rows qrow and qrow + 8
  const int col0 = 2 * (lane % 4);
  const Range sees[2] = {at.keys_of(qrow, skv), at.keys_of(qrow + 8, skv)};
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l2[h] = lse2[(size_t)bh * sq_pad + qrow + 8 * h];
    dl[h] = delta[(size_t)bh * sq_pad + qrow + 8 * h];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  mbar_wait(qbar, 0);
  const uint32_t q_base = smem_addr(qs);
  const uint32_t do_base = smem_addr(dos);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t k_base = smem_addr(ring + s * kSlotBytes);
    const uint32_t v_base = k_base + kKVBytes;

    // S = Q K^T and dP = dO V^T, issued together
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = make_desc(q_base + (kk / 4) * kBlock * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = make_desc(k_base + (kk / 4) * kBlock * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma<64, kKMajor>::mma(sc, da, db);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = make_desc(do_base + (kk / 4) * kBlock * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = make_desc(v_base + (kk / 4) * kBlock * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma<64, kKMajor>::mma(dp, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();

    // P g = 2^(x(S) - lse2[row]) g, 0 off the visible pairs (tested only in
    // the blocks that straddle an edge or skv: two copies of the loop)
    const int k0 = kv_begin + it * kBlock;
    auto probabilities = [&](auto flag) {
      constexpr bool masked = decltype(flag)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const bool hidden = masked && !sees[h].has(k0 + 8 * j + col0 + e);
            float g;
            const float p = score.p(sc[i], l2[h], hidden, &g);
            sc[i] = p * g;
          }
    };
    if (k0 + kBlock > skv || at.straddles(q0, k0)) probabilities(Flag<true>{});
    else probabilities(Flag<false>{});
    wgmma_wait<0>();

    // dS = P g (dP - delta[row]), then dQ += dS K (K MN-major)
    uint32_t dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * kk + 2 * i;
        const float d = dl[i % 2];            // a1, a3 are eight rows down
        dsa[kk][i] = pack_bf16(sc[c] * (dp[c] - d), sc[c + 1] * (dp[c + 1] - d));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<D>::mma(acc, dsa[kk], make_desc(k_base + kk * 16 * 128, kBlock * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();

    // this slot's K and V are consumed: release it, and refill it
    mbar_arrive(&empty[s]);
    if (t == 0 && it + kStages < n_tiles) {
      mbar_wait(&empty[s], (it / kStages) & 1);
      load_kv(it + kStages, s);
    }
  }

  write_fragment<D, D>(dq + (size_t)bh * sq * D, qrow, sq, acc, at.scale, lane);
}

template <int D, bool kCapped>
cudaError_t sm90_launch(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* work, void* dq, void* dk,
                        void* dv, int bh, int sq, int skv, int hq, int hkv, Attn at,
                        cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int bhkv = bh / hq * hkv;
  const int sq_pad = (sq + kBlock - 1) / kBlock * kBlock;
  float* delta = work;
  float* lse2 = work + (size_t)bh * sq_pad;
  const long long rows = (long long)bh * sq_pad;
  flash_bwd_prep_kernel<D><<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta, lse2, sq,
      sq_pad, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap qmap, domap, kmap, vmap;
  if (!sm90::make_map(&qmap, q, D, sq, bh, kBlock) ||
      !sm90::make_map(&domap, dout, D, sq, bh, kBlock) ||
      !sm90::make_map(&kmap, k, D, skv, bhkv, kBlock) ||
      !sm90::make_map(&vmap, v, D, skv, bhkv, kBlock))
    return cudaErrorInvalidValue;

  constexpr int kv_smem = dkdv_sm90_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_sm90_kernel<D, kCapped>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_sm90_kernel<D, kCapped><<<dim3((skv + kBlock - 1) / kBlock, bhkv),
                                  kSm90Threads * dkdv_groups<D>(), kv_smem, stream>>>(
      qmap, domap, kmap, vmap, lse2, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      sq, sq_pad, skv, hq, hkv, at);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int q_smem = dq_sm90_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<D, kCapped>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_sm90_kernel<D, kCapped><<<dim3((sq + kBlock - 1) / kBlock, bh), kSm90Threads,
                                         q_smem, stream>>>(
      qmap, domap, kmap, vmap, lse2, delta, static_cast<bf16*>(dq), sq, sq_pad, skv, hq, hkv,
      at);
  return cudaGetLastError();
}

cudaError_t sm90_launch_d(int d, const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* work, void* dq,
                          void* dk, void* dv, int bh, int sq, int skv, int hq, int hkv,
                          Attn at, cudaStream_t stream) {
  const bool capped = at.softcap > 0.0f;
#define KLARAPTOR_SM90_LAUNCH(D)                                                          \
  (capped ? sm90_launch<D, true>(q, k, v, o, dout, lse, work, dq, dk, dv, bh, sq, skv, hq, \
                                 hkv, at, stream)                                         \
          : sm90_launch<D, false>(q, k, v, o, dout, lse, work, dq, dk, dv, bh, sq, skv, hq, \
                                  hkv, at, stream))
  switch (d) {
    case 64: return KLARAPTOR_SM90_LAUNCH(64);
    case 128: return KLARAPTOR_SM90_LAUNCH(128);
    case 256: return KLARAPTOR_SM90_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef KLARAPTOR_SM90_LAUNCH
}

template <int D>
cudaError_t sm90_attributes(int which, int* num_regs, int* max_threads, int* local_bytes) {
  switch (which) {
    case 0: return attributes(flash_bwd_prep_kernel<D>, num_regs, max_threads, local_bytes);
    case 1: return attributes(flash_bwd_dkdv_sm90_kernel<D, false>, num_regs, max_threads,
                              local_bytes);
    case 2: return attributes(flash_bwd_dq_sm90_kernel<D, false>, num_regs, max_threads,
                              local_bytes);
    case 3: return attributes(flash_bwd_dkdv_sm90_kernel<D, true>, num_regs, max_threads,
                              local_bytes);
    case 4: return attributes(flash_bwd_dq_sm90_kernel<D, true>, num_regs, max_threads,
                              local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t sm90_attributes_d(int d, int which, int* num_regs, int* max_threads,
                              int* local_bytes) {
  switch (d) {
    case 64: return sm90_attributes<64>(which, num_regs, max_threads, local_bytes);
    case 128: return sm90_attributes<128>(which, num_regs, max_threads, local_bytes);
    case 256: return sm90_attributes<256>(which, num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the backward's three kernels on `stream` and returns
// cudaGetLastError() (0 on success); the caller has checked shapes, dtypes,
// alignment and head dim (bf16 64, 128 or 256; f32 64 or 128).  The window
// (has_window, window) and the cap (softcap <= 0: none) are the forward's.
// bf16 runs the wgmma body; work is f32 scratch of 2 * bh * sq_pad (delta,
// then lse2; sq_pad = sq rounded up to 64).  f32 runs the SIMT body with
// delta in the first bh * sq floats of work.
int klaraptor_flash_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const void* lse,
                                  void* work, void* dq, void* dk, void* dv, int bh, int sq,
                                  int skv, int d, int hq, int hkv, float scale, int causal,
                                  int has_window, int window, float softcap, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(work);
  const Attn at{scale, softcap, causal, has_window, window};
  switch (dtype) {
    case kF32:
      return simt_launch_d(d, q, k, v, o, dout, l, w, dq, dk, dv, bh, sq, skv, hq, hkv, at,
                           s);
    case kBF16:
      return sm90_launch_d(d, q, k, v, o, dout, l, w, dq, dk, dv, bh, sq, skv, hq, hkv, at,
                           s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread, launch-bound thread limit and local (spill) bytes of
// kernel `which` of the body that (dtype, d) runs: f32, the SIMT body's (0
// delta, 1 dK / dV, 2 dQ; they take the cap at run time); bf16, the wgmma
// body's (0 prep, 1 dK / dV, 2 dQ, 3 and 4 those two compiled for a
// softcap).
int klaraptor_flash_attention_bwd_attributes(int dtype, int d, int which, int* num_regs,
                                             int* max_threads, int* local_bytes) {
  switch (dtype) {
    case kF32: return simt_attributes_d(d, which, num_regs, max_threads, local_bytes);
    case kBF16: return sm90_attributes_d(d, which, num_regs, max_threads, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

const char* klaraptor_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
