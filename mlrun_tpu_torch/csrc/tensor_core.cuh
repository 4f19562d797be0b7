// Tensor-core building blocks of the bf16 flash kernels (flash_fwd_tc.cu,
// flash_bwd_tc.cu): 16-byte cp.async copies, ldmatrix, the bf16
// mma.sync.m16n8k16 with float32 accumulation, bf16 packing and the hi/lo
// split, and the padded shared-memory tile they read.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): in a warp, lane l
// has g = l / 4 and t = l % 4.
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9)
//   B (16 x 8, k x n), 2 registers: b0 (k 2t, 2t+1; col g),
//     b1 (k 2t+8, 2t+9; col g)
//   C (16 x 8) float32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// So the accumulators of two neighbouring 8-column blocks of a product are
// the A fragment of the next product over those 16 columns (FlashAttention-2's
// register reuse): a0 = c[0..1] of block 2j, a1 = c[2..3] of block 2j,
// a2 = c[0..1] of block 2j+1, a3 = c[2..3] of block 2j+1.
#pragma once

#include "common.cuh"

namespace mlt {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// A 64-row tile of bf16 rows of D values in shared memory, rows padded by 8
// values (16 bytes): the 8 rows one ldmatrix phase reads start 16 bytes
// apart modulo 128, so they hit distinct banks, and every row stays 16-byte
// aligned for cp.async.
template <int D>
struct SmemTile {
  static constexpr int kRows = 64;
  static constexpr int kStride = D + 8;          // bf16 values per row
  static constexpr int kElems = kRows * kStride;
  static constexpr int kBytes = kElems * 2;
  static constexpr int kChunks = D / 8;           // 16-byte chunks per row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; !pred writes 16 zero bytes
// (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; !pred writes a zero word
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a 64-row tile into shared memory: row r of the tile is
// src + r * row_stride (values); rows >= rows_valid are zero-filled.
template <int D, int kThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                size_t row_stride,
                                                int rows_valid, int tid) {
  using T = SmemTile<D>;
#pragma unroll
  for (int i = tid; i < T::kRows * T::kChunks; i += kThreads) {
    const int r = i / T::kChunks;
    const int c = i % T::kChunks;
    const bool ok = r < rows_valid;
    const bf16* from = ok ? src + static_cast<size_t>(r) * row_stride + c * 8
                          : src;
    cp_async16(dst + r * T::kStride + c * 8, from, ok);
  }
}

// four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p))
      : "memory");
}

// d += a * b, bf16 inputs, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand rows 0-15, k columns k0..k0+15 of a row-major tile
// (``tile`` points at row 0, column 0; stride in values)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int stride, int row0, int k0,
                                       int lane) {
  ldsm_x4(a[0], a[1], a[2], a[3],
          tile + (row0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8);
}

// B operands of two n-blocks (rows n0..n0+7 and n0+8..n0+15 of the tile
// are the product's columns) over k columns k0..k0+15: B[k][n] = tile[n][k]
// (the tile's rows are B's columns: K for S = Q K^T)
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            uint32_t& b2, uint32_t& b3,
                                            const bf16* tile, int stride,
                                            int n0, int k0, int lane) {
  ldsm_x4(b0, b1, b2, b3,
          tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + k0 +
              ((lane >> 3) & 1) * 8);
}

// B operands of two n-blocks (tile columns n0..n0+7, n0+8..n0+15) over k
// rows k0..k0+15: B[k][n] = tile[k][n] (V for O = P V)
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            uint32_t& b2, uint32_t& b3,
                                            const bf16* tile, int stride,
                                            int k0, int n0, int lane) {
  ldsm_x4_trans(b0, b1, b2, b3,
                tile + (k0 + (lane & 15)) * stride + n0 + (lane >> 4) * 8);
}

// two floats -> one register of two bf16 (x in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo + O(2**-17 |x|): hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x);
  const __nv_bfloat16 hy = __float2bfloat16_rn(y);
  __nv_bfloat162 h;
  h.x = hx;
  h.y = hy;
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x, __bfloat162float(hx)),
                 __fsub_rn(y, __bfloat162float(hy)));
}

// 2**x; exact 0 for the masked logits' large negative arguments
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace tc

// Launchers of the bf16 tensor-core kernels, called by the dtype dispatch
// of flash_fwd_cached.cu and flash_bwd.cu (float32 stays on the FMA
// kernels there).
int flash_fwd_tc(int head_dim, const void* q, const void* k, const void* v,
                 void* o, void* lse, int B, int S, int M, int H, int Hk,
                 int q_offset, int k_lo, int causal, float scale,
                 cudaStream_t stream);
int flash_bwd_tc(int head_dim, const void* q, const void* k, const void* v,
                 const void* o, const void* g, const void* lse, void* dq,
                 void* dk, void* dv, void* delta, int B, int Sq, int Sk,
                 int H, int Hk, int causal, float scale, cudaStream_t stream);

}  // namespace mlt
