// Flash-attention forward on the tensor cores, bf16: the kernel behind
// mlt_flash_fwd_cached and mlt_flash_fwd (flash_fwd_cached.cu sends bf16
// here by dtype; float32 stays on its FMA tile loop).
//
// Replaces the same Pallas bodies as flash_fwd_cached.cu: the v2 bodies of
// mlrun_tpu/ops/attention.py _flash_v2_body (_flash_fwd_kernel_v2_cached,
// _flash_fwd_kernel_v2_bounded, _flash_fwd_kernel_v2) and the v1
// _flash_fwd_kernel, and computes the same function: q rows at q_offset + i
// over keys k_lo <= k_pos < M (and k_pos <= q_offset + i when causal), o in
// bf16, lse float32.
//
// What bounds it on the H100: arithmetic, 4*D FLOPs per unmasked
// (query, key) pair against 989 TFLOP/s of bf16 tensor cores. The design
// (FlashAttention-2's, on mma.sync):
//   - grid (B*H, ceil(S/64)); a block of 4 warps owns 64 query rows of one
//     head, a warp 16 of them. Causal launches walk the query tiles from
//     the last, so the longest rows start first.
//   - S = Q K^T and O += P V are mma.sync.m16n8k16 (bf16 in, float32
//     accumulate): Q stays in registers as A fragments for the whole key
//     loop; K and V tiles come from shared memory through ldmatrix (V with
//     .trans, so no transposed copy); P goes from the S accumulators to A
//     fragments in registers, never through shared memory.
//   - K/V tiles of 64 keys are double-buffered and loaded with cp.async one
//     tile ahead of the compute; operands stay bf16 in shared memory, rows
//     padded by 16 bytes so ldmatrix reads are free of bank conflicts.
//   - only the tiles that need a mask (the causal diagonal, a tile
//     straddling k_lo, the ragged tail past M) evaluate one.
//
// Numerics (each one held by an existing check):
//   - the scale multiplies the float32 logits after the dot product; q is
//     never rounded with the scale folded in;
//   - l sums the float32 p; p is rounded to bf16 only as the A operand of
//     P V (the rounding attention_reference makes with its weights);
//   - each tile's P V goes to a fresh accumulator, then o = o * alpha + pv
//     in float32 (one fmaf an element);
//   - chunk invariance: key tiles sit at fixed multiples of 64 from
//     position 0 and are visited in ascending order; a row's max and sum
//     are lane-local sums over its 16 keys followed by two quad butterflies,
//     the same whatever warp or lane the row lands in; logits are formed
//     with explicit round-to-nearest intrinsics, so masked and unmasked
//     tiles do the same arithmetic; a tile past a row's causal limit gives
//     p = 0 and alpha = 1 exactly, so it leaves o, l and m unchanged. A
//     chunked prefill therefore gives the unchunked one's bits.
#include "tensor_core.cuh"

namespace {

using mlt::tc::bf16;
using mlt::tc::SmemTile;

template <int D>
struct FwdTc {
  static constexpr int kThreads = 128;  // 4 warps x 16 query rows
  static constexpr int kBQ = 64;
  static constexpr int kBK = 64;
  static constexpr int kKS = D / 16;    // k-slices of the head dim
  static constexpr int kND = D / 8;     // 8-column blocks of the head dim
  using Tile = SmemTile<D>;
  // Q + 2 x (K + V)
  static constexpr size_t kSmemBytes = 5 * Tile::kBytes;
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(FwdTc<D>::kThreads, 1)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int S, int M, int H, int Hk,
                        int q_offset, int k_lo, float scale) {
  using C = FwdTc<D>;
  using Tile = typename C::Tile;
  constexpr int kStride = Tile::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  // buffer i: K at qs + (1 + 2i) tiles, V at qs + (2 + 2i) tiles
  auto k_buf = [&](int i) { return qs + (1 + 2 * i) * Tile::kElems; };
  auto v_buf = [&](int i) { return qs + (2 + 2 * i) * Tile::kElems; };

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hk);
  const int qb = kCausal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * C::kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t q_row_stride = static_cast<size_t>(H) * D;
  const size_t kv_row_stride = static_cast<size_t>(Hk) * D;
  const bf16* q_src = q + (static_cast<size_t>(b) * S + q0) * q_row_stride +
                      static_cast<size_t>(h) * D;
  const bf16* k_head = k + static_cast<size_t>(b) * M * kv_row_stride +
                       static_cast<size_t>(kvh) * D;
  const bf16* v_head = v + static_cast<size_t>(b) * M * kv_row_stride +
                       static_cast<size_t>(kvh) * D;

  const int q_last = min(q0 + C::kBQ, S) - 1;
  const int kb_lo = k_lo / C::kBK;
  const int kb_hi =
      (kCausal ? min(q_offset + q_last, M - 1) : M - 1) / C::kBK;
  const int q_abs0 = q_offset + q0;  // absolute position of tile row 0

  auto load_kv = [&](int kb, int buf) {
    const int k_start = kb * C::kBK;
    const size_t off = static_cast<size_t>(k_start) * kv_row_stride;
    mlt::tc::load_tile_async<D, C::kThreads>(k_buf(buf), k_head + off,
                                             kv_row_stride, M - k_start, tid);
    mlt::tc::load_tile_async<D, C::kThreads>(v_buf(buf), v_head + off,
                                             kv_row_stride, M - k_start, tid);
  };

  mlt::tc::load_tile_async<D, C::kThreads>(qs, q_src, q_row_stride, S - q0,
                                           tid);
  mlt::tc::cp_async_commit();
  if (kb_lo <= kb_hi) load_kv(kb_lo, 0);
  mlt::tc::cp_async_commit();

  // this thread's rows: ra = tile row warp*16 + g, rb = ra + 8
  const int pos_a = q_abs0 + warp * 16 + g;
  const int pos_b = pos_a + 8;
  float m_a = mlt::kNegInf, m_b = mlt::kNegInf;
  float l_a = 0.f, l_b = 0.f;
  float acc[C::kND][4];
#pragma unroll
  for (int n = 0; n < C::kND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // Q as A fragments, kept in registers for the whole key loop
  mlt::tc::cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[C::kKS][4];
#pragma unroll
  for (int ks_i = 0; ks_i < C::kKS; ++ks_i)
    mlt::tc::load_a(qf[ks_i], qs, kStride, warp * 16, ks_i * 16, lane);

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int buf = (kb - kb_lo) & 1;
    if (kb < kb_hi) {
      load_kv(kb + 1, buf ^ 1);
      mlt::tc::cp_async_commit();
      mlt::tc::cp_async_wait<1>();
    } else {
      mlt::tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile kb visible to every warp
    const bf16* kt = k_buf(buf);
    const bf16* vt = v_buf(buf);
    const int k_start = kb * C::kBK;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 blocks of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks_i = 0; ks_i < C::kKS; ++ks_i) {
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b0, b1, b2, b3;
        mlt::tc::load_b_rows(b0, b1, b2, b3, kt, kStride, n2 * 16, ks_i * 16,
                             lane);
        mlt::tc::mma_bf16(s[2 * n2], qf[ks_i], b0, b1);
        mlt::tc::mma_bf16(s[2 * n2 + 1], qf[ks_i], b2, b3);
      }
    }

    // scale after the dot; mask only where the tile needs it
    const bool need_mask = k_start < k_lo || k_start + C::kBK > M ||
                           (kCausal && k_start + C::kBK - 1 > q_abs0);
    float mx_a = mlt::kNegInf, mx_b = mlt::kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[n][e], scale);
        if (need_mask) {
          const int k_pos = k_start + n * 8 + 2 * t + (e & 1);
          const int q_pos = e < 2 ? pos_a : pos_b;
          const bool ok = (!kCausal || k_pos <= q_pos) && k_pos >= k_lo &&
                          k_pos < M;
          x = ok ? x : mlt::kNegInf;
        }
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    // exactly 1 when the max does not move (a fully masked tile)
    const float alpha_a =
        mn_a == m_a ? 1.f
                    : mlt::tc::exp2_approx(
                          __fmul_rn(__fsub_rn(m_a, mn_a), mlt::tc::kLog2e));
    const float alpha_b =
        mn_b == m_b ? 1.f
                    : mlt::tc::exp2_approx(
                          __fmul_rn(__fsub_rn(m_b, mn_b), mlt::tc::kLog2e));
    m_a = mn_a;
    m_b = mn_b;

    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pf[4][4];  // P as the A operand of P V, 4 slices of 16 keys
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m_row = e < 2 ? mn_a : mn_b;
        s[n][e] = mlt::tc::exp2_approx(
            __fmul_rn(__fsub_rn(s[n][e], m_row), mlt::tc::kLog2e));
      }
      sum_a = __fadd_rn(sum_a, __fadd_rn(s[n][0], s[n][1]));
      sum_b = __fadd_rn(sum_b, __fadd_rn(s[n][2], s[n][3]));
      pf[n >> 1][(n & 1) * 2] = mlt::tc::pack_bf16(s[n][0], s[n][1]);
      pf[n >> 1][(n & 1) * 2 + 1] = mlt::tc::pack_bf16(s[n][2], s[n][3]);
    }
    sum_a = __fadd_rn(sum_a, __shfl_xor_sync(0xffffffffu, sum_a, 1));
    sum_a = __fadd_rn(sum_a, __shfl_xor_sync(0xffffffffu, sum_a, 2));
    sum_b = __fadd_rn(sum_b, __shfl_xor_sync(0xffffffffu, sum_b, 1));
    sum_b = __fadd_rn(sum_b, __shfl_xor_sync(0xffffffffu, sum_b, 2));
    l_a = __fmaf_rn(l_a, alpha_a, sum_a);
    l_b = __fmaf_rn(l_b, alpha_b, sum_b);

    // O = O * alpha + P V, P V of this tile in a fresh accumulator
#pragma unroll
    for (int n2 = 0; n2 < C::kND / 2; ++n2) {
      float pv0[4] = {0.f, 0.f, 0.f, 0.f};
      float pv1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1, b2, b3;
        mlt::tc::load_b_cols(b0, b1, b2, b3, vt, kStride, kk * 16, n2 * 16,
                             lane);
        mlt::tc::mma_bf16(pv0, pf[kk], b0, b1);
        mlt::tc::mma_bf16(pv1, pf[kk], b2, b3);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float alpha = e < 2 ? alpha_a : alpha_b;
        acc[2 * n2][e] = __fmaf_rn(acc[2 * n2][e], alpha, pv0[e]);
        acc[2 * n2 + 1][e] = __fmaf_rn(acc[2 * n2 + 1][e], alpha, pv1[e]);
      }
    }
    __syncthreads();  // every warp done with buffer buf before it refills
  }
  mlt::tc::cp_async_wait<0>();  // nothing left in flight (an empty range)

  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const float den_a = fmaxf(l_a, mlt::kMinDenom);
  const float den_b = fmaxf(l_b, mlt::kMinDenom);
  const float inv_a = 1.f / den_a;
  const float inv_b = 1.f / den_b;
  if (row_a < S) {
    bf16* out = o + (static_cast<size_t>(b) * S + row_a) * q_row_stride +
                static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < C::kND; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) = mlt::tc::pack_bf16(
          acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (t == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + row_a] = m_a + logf(den_a);
  }
  if (row_b < S) {
    bf16* out = o + (static_cast<size_t>(b) * S + row_b) * q_row_stride +
                static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < C::kND; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) = mlt::tc::pack_bf16(
          acc[n][2] * inv_b, acc[n][3] * inv_b);
    if (t == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + row_b] = m_b + logf(den_b);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int M, int H, int Hk, int q_offset, int k_lo,
           int causal, float scale, cudaStream_t stream) {
  using C = FwdTc<D>;
  auto kernel = causal ? flash_fwd_tc_kernel<D, true>
                       : flash_fwd_tc_kernel<D, false>;
  cudaError_t err = mlt::allow_smem(kernel, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (S + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), S, M, H, Hk, q_offset, k_lo, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

namespace mlt {

int flash_fwd_tc(int head_dim, const void* q, const void* k, const void* v,
                 void* o, void* lse, int B, int S, int M, int H, int Hk,
                 int q_offset, int k_lo, int causal, float scale,
                 cudaStream_t stream) {
  // cp.async moves 16-byte chunks of every q/k/v row; o is stored 4 bytes
  // at a time
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) ||
      (reinterpret_cast<uintptr_t>(o) & 3) != 0)
    return kBadArgument;
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, o, lse, B, S, M, H, Hk, q_offset, k_lo, causal, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, lse, B, S, M, H, Hk, q_offset, k_lo, causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, B, S, M, H, Hk, q_offset, k_lo, causal, scale, stream);
    default:
      return kBadArgument;
  }
}

}  // namespace mlt
