// Flash-attention backward on the tensor cores, bf16: the kernels behind
// mlt_flash_bwd for bf16 (flash_bwd.cu sends bf16 here by dtype; float32
// stays on its FMA kernels).
//
// Replaces the backward of flash_attention_mlt, mlrun_tpu/ops/attention.py
// _blockwise_bwd (XLA on the TPU), and computes what flash_bwd.cu states:
//   s = (q . k) * scale (masked), p = exp(s - lse), delta = sum_d o * dO,
//   ds = p * (dO . v - delta) * scale, dq = ds . k, dk = ds^T . q,
//   dv = p^T . dO
// with dk/dv at the kv head count, summed over each group of query heads.
//
// What bounds it on the H100: arithmetic (10*D FLOPs a pair in the
// reference's count) against 989 TFLOP/s of bf16 tensor cores. The
// structure is flash_bwd.cu's, with the products on mma.sync.m16n8k16
// (bf16 in, float32 accumulate) and the tiles bf16 in shared memory,
// loaded with cp.async one tile ahead (double-buffered), rows padded by 16
// bytes for conflict-free ldmatrix:
//   1. dq:   grid (B*H, ceil(Sq/64)), 4 warps x 16 query rows. The prologue
//            computes delta in float32 FMAs and writes it for kernel 2;
//            then each key tile gives S = Q K^T and dP = dO V^T (A from the
//            Q / dO tiles, B from the K / V rows), dS in registers, and
//            dq += dS K (B = K through ldmatrix.trans). Causal launches walk
//            the query tiles from the last, the longest rows first.
//   2. dkdv: grid (B*Hk, ceil(Sk/64)), 4 warps x 16 keys (8 at D 128, two
//            warps a key block, each owning half of dk/dv). For each query
//            head of the group and each query tile it computes the
//            transposed forms S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
//            come out as accumulator fragments and feed dv += P^T dO and
//            dk += dS^T Q as register A operands, never through shared
//            memory.
// No atomics, and every sum runs in a fixed order: dq, dk and dv are
// bit-identical from run to run.
//
// Numerics. The gradients are held to half a bf16 ulp of the exact float32
// value plus 2e-5 of the largest gradient (chip_smoke.py): the output
// rounding takes the half ulp, so the float32 sums must be good to ~1e-5.
// S and dP take the bf16 inputs as they are (their products are exact in
// float32). P and dS are computed, not inputs: rounded once to bf16 they
// would add ~2**-9 relative per term, so every product with one of them as
// operand (dv += P^T dO, dk += dS^T Q, dq += dS K) runs as two mma on a
// hi/lo split, hi = bf16(x), lo = bf16(x - hi), which leaves ~2**-17. Each
// tile's product goes to a fresh accumulator that is then added to the
// running float32 sum, so the tensor cores' own accumulation covers one
// tile (8 mma), not the whole key or query range. The scale multiplies the
// float32 s; delta is float32 FMAs.
#include "tensor_core.cuh"

namespace {

using mlt::tc::bf16;
using mlt::tc::SmemTile;

template <int D>
struct BwdTc {
  static constexpr int kThreads = 128;  // dq: 4 warps x 16 query rows
  static constexpr int kB = 64;
  static constexpr int kND = D / 8;
  // dkdv: 4 warps x 16 keys, each warp accumulating dk and dv over all of
  // D; at D 128 that is 128 float32 accumulators a thread, too many beside
  // the score tiles, so 8 warps there: warps w and w + 4 own the same 16
  // keys (and both compute their scores) and split the head dim in halves
  static constexpr int kDkvSplit = D >= 128 ? 2 : 1;
  static constexpr int kDkvThreads = 128 * kDkvSplit;
  static constexpr int kDkvCols = D / kDkvSplit;  // dk/dv columns a warp
  using Tile = SmemTile<D>;
  // dq: Q + dO + 2 x (K + V), delta [64]
  static constexpr size_t kDqSmemBytes = 6 * Tile::kBytes + kB * 4;
  // dkdv: K + V + 2 x (Q + dO), 2 x (lse, delta) [64]
  static constexpr size_t kDkvSmemBytes = 6 * Tile::kBytes + 4 * kB * 4;
};

// A warp's two 16 x 64 score blocks against one tile: s = A1 . B1^T and
// dp = A2 . B2^T, the A rows row0..row0+15 of tiles a1 / a2 and all 64 rows
// of tiles b1 / b2 as the columns
template <int D>
__device__ __forceinline__ void scores_pair(float (&s)[8][4], float (&dp)[8][4],
                                            const bf16* a1, const bf16* b1,
                                            const bf16* a2, const bf16* b2,
                                            int row0, int lane) {
  constexpr int kStride = SmemTile<D>::kStride;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    mlt::tc::load_a(a, a1, kStride, row0, ks * 16, lane);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      uint32_t x0, x1, x2, x3;
      mlt::tc::load_b_rows(x0, x1, x2, x3, b1, kStride, n2 * 16, ks * 16,
                           lane);
      mlt::tc::mma_bf16(s[2 * n2], a, x0, x1);
      mlt::tc::mma_bf16(s[2 * n2 + 1], a, x2, x3);
    }
    mlt::tc::load_a(a, a2, kStride, row0, ks * 16, lane);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      uint32_t x0, x1, x2, x3;
      mlt::tc::load_b_rows(x0, x1, x2, x3, b2, kStride, n2 * 16, ks * 16,
                           lane);
      mlt::tc::mma_bf16(dp[2 * n2], a, x0, x1);
      mlt::tc::mma_bf16(dp[2 * n2 + 1], a, x2, x3);
    }
  }
}

// acc += X . tile[:, d0:d0 + kCols], X the 16 x 64 accumulator fragments
// ``x`` (split hi/lo into two mma each), the tile's 64 rows its k
// dimension (ldmatrix.trans); each 8-column block's product sums in a
// fresh accumulator first
template <int D, int kCols>
__device__ __forceinline__ void accumulate_split(float (&acc)[kCols / 8][4],
                                                 const float (&x)[8][4],
                                                 const bf16* tile, int d0,
                                                 int lane) {
  constexpr int kStride = SmemTile<D>::kStride;
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mlt::tc::split_bf16(x[n][0], x[n][1], hi[n >> 1][(n & 1) * 2],
                        lo[n >> 1][(n & 1) * 2]);
    mlt::tc::split_bf16(x[n][2], x[n][3], hi[n >> 1][(n & 1) * 2 + 1],
                        lo[n >> 1][(n & 1) * 2 + 1]);
  }
#pragma unroll
  for (int n2 = 0; n2 < kCols / 16; ++n2) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f};
    float t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b0, b1, b2, b3;
      mlt::tc::load_b_cols(b0, b1, b2, b3, tile, kStride, kk * 16,
                           d0 + n2 * 16, lane);
      mlt::tc::mma_bf16(t0, hi[kk], b0, b1);
      mlt::tc::mma_bf16(t0, lo[kk], b0, b1);
      mlt::tc::mma_bf16(t1, hi[kk], b2, b3);
      mlt::tc::mma_bf16(t1, lo[kk], b2, b3);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * n2][e] = __fadd_rn(acc[2 * n2][e], t0[e]);
      acc[2 * n2 + 1][e] = __fadd_rn(acc[2 * n2 + 1][e], t1[e]);
    }
  }
}

// p and ds of one score element (x = s * scale); live says the pair is
// unmasked
__device__ __forceinline__ void softmax_grad(float& s, float& dp, float lse,
                                             float delta, float scale,
                                             bool live) {
  const float x = __fmul_rn(s, scale);
  float p = mlt::tc::exp2_approx(__fmul_rn(__fsub_rn(x, lse),
                                           mlt::tc::kLog2e));
  p = live ? p : 0.f;
  dp = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
  s = p;
}

// a thread's share of one output row from 16-row fragments, as bf16 pairs:
// c0 = 0 stores its row g (accumulators 0, 1), c0 = 2 its row g + 8
template <int kCols>
__device__ __forceinline__ void store_row(bf16* out,
                                          const float (&acc)[kCols / 8][4],
                                          int c0, int t) {
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
    *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) =
        mlt::tc::pack_bf16(acc[n][c0], acc[n][c0 + 1]);
}

// ---------------------------------------------------------------------------
// kernel 1: dq (and delta)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(BwdTc<D>::kThreads, 1)
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ o,
                           const bf16* __restrict__ g,
                           const float* __restrict__ lse,
                           bf16* __restrict__ dq, float* __restrict__ delta_out,
                           int Sq, int Sk, int H, int Hk, int causal,
                           float scale) {
  using C = BwdTc<D>;
  using Tile = typename C::Tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + Tile::kElems;
  // buffer i: K at qs + (2 + 2i) tiles, V at qs + (3 + 2i) tiles
  auto k_buf = [&](int i) { return qs + (2 + 2 * i) * Tile::kElems; };
  auto v_buf = [&](int i) { return qs + (3 + 2 * i) * Tile::kElems; };
  float* delta_s = reinterpret_cast<float*>(qs + 6 * Tile::kElems);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hk);
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * C::kB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gi = lane >> 2;
  const int t = lane & 3;

  const size_t q_row_stride = static_cast<size_t>(H) * D;
  const size_t kv_row_stride = static_cast<size_t>(Hk) * D;
  const size_t q_off = (static_cast<size_t>(b) * Sq + q0) * q_row_stride +
                       static_cast<size_t>(h) * D;
  const bf16* k_head = k + static_cast<size_t>(b) * Sk * kv_row_stride +
                       static_cast<size_t>(kvh) * D;
  const bf16* v_head = v + static_cast<size_t>(b) * Sk * kv_row_stride +
                       static_cast<size_t>(kvh) * D;

  auto load_kv = [&](int kb, int buf) {
    const int k_start = kb * C::kB;
    const size_t off = static_cast<size_t>(k_start) * kv_row_stride;
    mlt::tc::load_tile_async<D, C::kThreads>(k_buf(buf), k_head + off,
                                             kv_row_stride, Sk - k_start,
                                             tid);
    mlt::tc::load_tile_async<D, C::kThreads>(v_buf(buf), v_head + off,
                                             kv_row_stride, Sk - k_start,
                                             tid);
  };

  const int q_last = min(q0 + C::kB, Sq) - 1;
  const int kb_hi = (causal ? min(q_last, Sk - 1) : Sk - 1) / C::kB;
  mlt::tc::load_tile_async<D, C::kThreads>(qs, q + q_off, q_row_stride,
                                           Sq - q0, tid);
  mlt::tc::load_tile_async<D, C::kThreads>(gs, g + q_off, q_row_stride,
                                           Sq - q0, tid);
  load_kv(0, 0);
  mlt::tc::cp_async_commit();

  // delta = sum_d o * dO in float32 FMAs, one warp a row, while the first
  // tiles load
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float part = 0.f;
    if (row < Sq) {
      const size_t off = (static_cast<size_t>(b) * Sq + row) * q_row_stride +
                         static_cast<size_t>(h) * D;
#pragma unroll
      for (int i = 0; i < D / 32; ++i)
        part = fmaf(mlt::to_f32(o[off + lane + 32 * i]),
                    mlt::to_f32(g[off + lane + 32 * i]), part);
    }
    const float d = mlt::warp_sum(part);
    if (lane == 0) {
      delta_s[warp * 16 + r] = d;
      if (row < Sq) delta_out[(static_cast<size_t>(b) * H + h) * Sq + row] = d;
    }
  }
  __syncwarp();
  const int row_a = q0 + warp * 16 + gi;
  const int row_b = row_a + 8;
  const size_t lse_base = (static_cast<size_t>(b) * H + h) * Sq;
  const float lse_a = row_a < Sq ? lse[lse_base + row_a] : 0.f;
  const float lse_b = row_b < Sq ? lse[lse_base + row_b] : 0.f;
  const float delta_a = delta_s[warp * 16 + gi];
  const float delta_b = delta_s[warp * 16 + gi + 8];

  float acc[C::kND][4];
#pragma unroll
  for (int n = 0; n < C::kND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kb = 0; kb <= kb_hi; ++kb) {
    const int buf = kb & 1;
    if (kb < kb_hi) {
      load_kv(kb + 1, buf ^ 1);
      mlt::tc::cp_async_commit();
      mlt::tc::cp_async_wait<1>();
    } else {
      mlt::tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k_start = kb * C::kB;

    float s[8][4], dp[8][4];
    scores_pair<D>(s, dp, qs, k_buf(buf), gs, v_buf(buf), warp * 16, lane);

    const bool need_mask = k_start + C::kB > Sk ||
                           (causal && k_start + C::kB - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = k_start + n * 8 + 2 * t + (e & 1);
        const int q_pos = e < 2 ? row_a : row_b;
        const bool live =
            !need_mask || (k_pos < Sk && (!causal || k_pos <= q_pos));
        softmax_grad(s[n][e], dp[n][e], e < 2 ? lse_a : lse_b,
                     e < 2 ? delta_a : delta_b, scale, live);
      }
    }
    accumulate_split<D, D>(acc, dp, k_buf(buf), 0, lane);  // dq += dS K
    __syncthreads();  // buffer buf consumed before it refills
  }

  if (row_a < Sq)
    store_row<D>(dq + (static_cast<size_t>(b) * Sq + row_a) * q_row_stride +
                     static_cast<size_t>(h) * D,
                 acc, 0, t);
  if (row_b < Sq)
    store_row<D>(dq + (static_cast<size_t>(b) * Sq + row_b) * q_row_stride +
                     static_cast<size_t>(h) * D,
                 acc, 2, t);
}

// ---------------------------------------------------------------------------
// kernel 2: dk, dv at the kv head count
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(BwdTc<D>::kDkvThreads, 1)
    flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int Sq, int Sk, int H, int Hk, int causal,
                             float scale) {
  using C = BwdTc<D>;
  using Tile = typename C::Tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kThreads = C::kDkvThreads;
  constexpr int kCols = C::kDkvCols;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + Tile::kElems;
  // buffer i: Q at ks + (2 + 2i) tiles, dO at ks + (3 + 2i) tiles
  auto q_buf = [&](int i) { return ks + (2 + 2 * i) * Tile::kElems; };
  auto g_buf = [&](int i) { return ks + (3 + 2 * i) * Tile::kElems; };
  float* lse_s = reinterpret_cast<float*>(ks + 6 * Tile::kElems);  // [2][64]
  float* delta_s = lse_s + 2 * C::kB;                              // [2][64]

  const int bkv = blockIdx.x;
  const int b = bkv / Hk;
  const int kvh = bkv % Hk;
  const int n_rep = H / Hk;
  const int k0 = blockIdx.y * C::kB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int key_warp = (tid >> 5) & 3;     // this warp's 16 keys
  const int d0 = (tid >> 7) * kCols;        // and dk/dv columns
  const int gi = lane >> 2;
  const int t = lane & 3;

  const size_t q_row_stride = static_cast<size_t>(H) * D;
  const size_t kv_row_stride = static_cast<size_t>(Hk) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Sk + k0) * kv_row_stride +
                        static_cast<size_t>(kvh) * D;
  mlt::tc::load_tile_async<D, kThreads>(ks, k + kv_off, kv_row_stride,
                                        Sk - k0, tid);
  mlt::tc::load_tile_async<D, kThreads>(vs, v + kv_off, kv_row_stride,
                                        Sk - k0, tid);
  mlt::tc::cp_async_commit();

  // causal: query tiles that end before this key tile starts see none of it
  const int qb_lo = causal ? k0 / C::kB : 0;
  const int qb_hi = (Sq - 1) / C::kB;
  const int n_qt = qb_hi - qb_lo + 1;
  const int total = n_qt > 0 ? n_rep * n_qt : 0;

  auto load_q = [&](int it, int buf) {
    const int h = kvh * n_rep + it / n_qt;
    const int q_start = (qb_lo + it % n_qt) * C::kB;
    const size_t off = (static_cast<size_t>(b) * Sq + q_start) * q_row_stride +
                       static_cast<size_t>(h) * D;
    mlt::tc::load_tile_async<D, kThreads>(q_buf(buf), q + off, q_row_stride,
                                          Sq - q_start, tid);
    mlt::tc::load_tile_async<D, kThreads>(g_buf(buf), g + off, q_row_stride,
                                          Sq - q_start, tid);
    // threads 0-63 copy the 64 lse values, threads 64-127 the deltas
    const int j = tid & (C::kB - 1);
    const bool ok = q_start + j < Sq;
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq + q_start + j;
    if (tid < C::kB)
      mlt::tc::cp_async4(lse_s + buf * C::kB + j, ok ? lse + row : lse, ok);
    else if (tid < 2 * C::kB)
      mlt::tc::cp_async4(delta_s + buf * C::kB + j, ok ? delta + row : delta,
                         ok);
  };

  if (total > 0) load_q(0, 0);
  mlt::tc::cp_async_commit();

  float acc_k[kCols / 8][4], acc_v[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  }
  const int key_a = k0 + key_warp * 16 + gi;  // this thread's keys
  const int key_b = key_a + 8;

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) {
      load_q(it + 1, buf ^ 1);
      mlt::tc::cp_async_commit();
      mlt::tc::cp_async_wait<1>();
    } else {
      mlt::tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int q_start = (qb_lo + it % n_qt) * C::kB;
    const float* lse_t = lse_s + buf * C::kB;
    const float* delta_t = delta_s + buf * C::kB;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries a warp
    float s[8][4], dp[8][4];
    scores_pair<D>(s, dp, ks, q_buf(buf), vs, g_buf(buf), key_warp * 16,
                   lane);

    const bool need_mask = q_start + C::kB > Sq || k0 + C::kB > Sk ||
                           (causal && k0 + C::kB - 1 > q_start);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int q_pos = q_start + col;
        const int k_pos = e < 2 ? key_a : key_b;
        const bool live = !need_mask || (q_pos < Sq && k_pos < Sk &&
                                         (!causal || k_pos <= q_pos));
        softmax_grad(s[n][e], dp[n][e], lse_t[col], delta_t[col], scale,
                     live);
      }
    }
    // dv += P^T dO, dk += dS^T Q (this warp's columns d0..d0 + kCols)
    accumulate_split<D, kCols>(acc_v, s, g_buf(buf), d0, lane);
    accumulate_split<D, kCols>(acc_k, dp, q_buf(buf), d0, lane);
    __syncthreads();  // buffer buf consumed before it refills
  }
  mlt::tc::cp_async_wait<0>();  // nothing left in flight (no query tile)

  if (key_a < Sk) {
    const size_t off = (static_cast<size_t>(b) * Sk + key_a) * kv_row_stride +
                       static_cast<size_t>(kvh) * D;
    store_row<kCols>(dk + off + d0, acc_k, 0, t);
    store_row<kCols>(dv + off + d0, acc_v, 0, t);
  }
  if (key_b < Sk) {
    const size_t off = (static_cast<size_t>(b) * Sk + key_b) * kv_row_stride +
                       static_cast<size_t>(kvh) * D;
    store_row<kCols>(dk + off + d0, acc_k, 2, t);
    store_row<kCols>(dv + off + d0, acc_v, 2, t);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int B, int Sq, int Sk, int H, int Hk, int causal,
           float scale, cudaStream_t stream) {
  using C = BwdTc<D>;
  auto dq_kernel = flash_bwd_dq_tc_kernel<D>;
  auto dkv_kernel = flash_bwd_dkdv_tc_kernel<D>;
  cudaError_t err = mlt::allow_smem(dq_kernel, C::kDqSmemBytes);
  if (err == cudaSuccess) err = mlt::allow_smem(dkv_kernel, C::kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  const float* lp = static_cast<const float*>(lse);
  float* deltap = static_cast<float*>(delta);
  dim3 grid_q(B * H, (Sq + C::kB - 1) / C::kB);
  dq_kernel<<<grid_q, C::kThreads, C::kDqSmemBytes, stream>>>(
      qp, kp, vp, static_cast<const bf16*>(o), gp, lp, static_cast<bf16*>(dq),
      deltap, Sq, Sk, H, Hk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_k(B * Hk, (Sk + C::kB - 1) / C::kB);
  dkv_kernel<<<grid_k, C::kDkvThreads, C::kDkvSmemBytes, stream>>>(
      qp, kp, vp, gp, lp, deltap, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, Hk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

namespace mlt {

int flash_bwd_tc(int head_dim, const void* q, const void* k, const void* v,
                 const void* o, const void* g, const void* lse, void* dq,
                 void* dk, void* dv, void* delta, int B, int Sq, int Sk,
                 int H, int Hk, int causal, float scale, cudaStream_t stream) {
  // cp.async moves 16-byte chunks of q/k/v/dO rows; gradients are stored
  // 4 bytes at a time
  if (!aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16) ||
      !aligned(g, 16) || !aligned(dq, 4) || !aligned(dk, 4) ||
      !aligned(dv, 4))
    return kBadArgument;
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, o, g, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hk, causal, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, g, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hk, causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, g, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hk, causal, scale, stream);
    default:
      return kBadArgument;
  }
}

}  // namespace mlt
