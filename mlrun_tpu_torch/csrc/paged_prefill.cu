// Multi-row paged prefill and batched speculative verify: query rows
// attend cached prefix tokens where they live, in the KV page pool.
//
// Replaces the Pallas kernels of mlrun_tpu/ops/paged_attention.py:
//   - _paged_prefill_kernel, native (mlt_paged_prefill) and int8
//     (mlt_paged_prefill_int8, quantized=True), called through
//     _paged_prefill_call / paged_prefix_part on every prefix-cache hit;
//   - _paged_verify_kernel, native and int8 (mlt_paged_verify), called
//     through _paged_verify_call / paged_verify_attention once per layer
//     in every speculative verify round.
//
// Prefill: q [S, H, D] (one admission's chunk); k/v pages [P+1,
// page_size, Hkv, D] (the last page is the scratch page); page_ids
// [pages_per_slot] int32 with -1 past the prefix (routed to the scratch
// page). Every prefix position precedes every query row, so there is no
// causal mask: keys at k_pos >= base are masked. Outputs o [S, H, D]
// float32 and lse [S, H] float32, the partial softmax state the caller
// LSE-merges with the attention over the suffix.
//
// Verify: the same per slot. q [slots, S, H, D] (each slot's k+1 verify
// chunk), page_table [slots, pages_per_slot], base [slots] (the slot's
// committed length); outputs o [slots, S, H, D] and lse [slots, S, H]. The
// chunk's causal part over itself stays with the caller.
//
// int8 pages carry float32 per-vector scales [P+1, page_size, Hkv].
//
// The rows of one kv head are the chunk's tokens times the GQA group (row
// = token * n_rep + r, as in the Pallas kernels), so each staged key tile
// serves n_rep query heads at once. A block owns 64 such rows and walks
// key tiles of 64 positions from position 0, resolving each key row's page
// through the page ids itself (no scalar prefetch), so any page size
// works. Both entry points run the same block body, so a one-slot verify
// gives the prefill's bits. The body is chosen by q's dtype:
//
// float32 q: float32 FMAs from shared memory (attn_tile.cuh), pages staged
// as float32 (int8: the element times its scale, the reference's
// k * ks[:, None]). Prefill grid (Hkv, ceil(S*n_rep/64)); verify grid
// (slots * Hkv, ceil(S*n_rep/64)).
//
// bf16 q: the tensor cores (mma.sync.m16n8k16, bf16 in, float32
// accumulation; the helpers of tensor_core.cuh):
//   - What bounds it on the H100: a prefill of a few hundred rows a kv
//     head does 4*D FLOPs a (row, prefix key) pair, above the card's
//     bytes-to-operations line, so arithmetic; a verify block holds only
//     S * n_rep rows (20 at k 4 and Llama-3-8B), about 5 FLOPs a byte, so
//     bytes. The FMA body was far from both: a shared-memory load per FMA,
//     one element a thread step staged with a page lookup each, no
//     copy/compute overlap, and 32 verify blocks on 132 SMs.
//   - staging: 16-byte cp.async copies, the page resolved once a key row,
//     K/V tiles double-buffered one tile ahead of the compute. Native
//     pages land as bf16 tiles (rows padded by 16 bytes, read by
//     ldmatrix); int8 pages land as int8 and are widened to bf16 tiles in
//     shared memory (exact: |x| <= 127 fits bf16's 8-bit significand),
//     their scales beside them.
//   - S = Q K^T: Q stays in shared memory and its A fragments are read
//     again (ldmatrix) for every key tile, which keeps D 128 inside 255
//     registers beside the hi/lo P; the softmax scale (and, on int8 pages,
//     the key's k_scale) multiplies the float32 logits after the product.
//   - O += P V: P (on int8 pages times the value's v_scale, so V stays the
//     exact int8 values) is split into hi = bf16(P) and lo = bf16(P - hi),
//     two bf16 A operands of the same product.
//   - split-K for the verify: a slot's prefix is cut into chunks of 128
//     keys (kChunkTiles tiles from position 0: a function of the slot's
//     base alone, never of S or the slot count); grid (max chunks, q
//     blocks, slots * Hkv), so 4 slots at ~600 tokens and k 4 run ~130
//     blocks instead of 32. Each chunk's (m, l, acc) goes to a scratch
//     buffer the wrapper allocates, and the last block of a (slot, kv head,
//     q block) to arrive (an atomic counter the wrapper keeps zeroed, reset
//     by that block) merges the chunks in order 0, 1, 2, ... (lse_fold).
//     The prefill, with hundreds of rows to spread, walks the chunks in one
//     block and merges each as it ends, with the same operations in the
//     same order (the running o waits in the rows' o entries). A one-slot
//     split launch of the same rows took 3.1-3.8x the walk's time on an
//     H100 at S 512 over prefixes of 256 to 1536 keys
//     (scripts/time_paged_kernels.py; its merging blocks and its scratch
//     of S * H * (D + 2) floats a chunk, not timed apart), so the prefill
//     keeps the walk. So a row's (o, lse) bits depend only on the key
//     tiles it visits: not on S, its place in its q block, the other
//     slots, or the entry point.
//
// Error analysis of the bf16 body against the float32 plain version (held
// at 2e-5 on o and lse):
//   - a product of two bf16 values is exact in float32, so S differs from
//     the plain float32 dot only by the order of the float32 additions
//     (and the scale applied after the dot, not to q before it): a few
//     float32 ulps of |q||k|, ~1e-6 on the logits at these widths;
//   - p = 2**((s - m) log2 e) with ex2.approx: ~2 ulps, plus the rounding
//     of the argument, ~1e-6 relative for logits within ~10 of the max;
//   - P split: |P - hi - lo| <= 2**-18 |P|, so the value sum's extra error
//     is at most 2**-18 sum(p |v|) / l <= 3.9e-6 max|v| (a one-term bf16 P
//     would be 2**-9 max|v|, ~250x the tolerance); v_scale folded into P
//     is one more float32 rounding, 2**-24;
//   - l sums the unsplit float32 p; o = acc * (1 / l) and lse = m +
//     log(l) as in the float32 body.
// With |v| <= ~5 (randn values, or int8 * scale of randn) that keeps o
// within ~2e-5 in the worst case and ~1e-6 in practice; lse within ~1e-6.
#include <type_traits>

#include "attn_tile.cuh"
#include "tensor_core.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 q: the FMA body
// ---------------------------------------------------------------------------


using mlt::Tile;
using mlt::TileState;

struct PrefixMask {
  int base;
  __device__ __forceinline__ bool operator()(int, int k_pos) const {
    return k_pos < base;
  }
};

// Stage the key tile at k_start (positions < base) of kv head kvh into
// float32 shared memory; native pages, one element a thread step.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ k_pages,
                                           const T* __restrict__ v_pages,
                                           const float*, const float*,
                                           const int* __restrict__ page_ids,
                                           float* ks, float* vs, int k_start,
                                           int base, int Hkv, int kvh,
                                           int page_size, int pages_per_slot,
                                           int scratch_page) {
  using C = Tile<D>;
  for (int i = threadIdx.x; i < C::kBK * D; i += C::kThreads) {
    const int j = i / D, d = i % D;
    const int k_pos = k_start + j;
    float kv = 0.f, vv = 0.f;
    const int page = k_pos / page_size;
    if (k_pos < base && page < pages_per_slot) {
      int pid = page_ids[page];
      if (pid < 0) pid = scratch_page;
      const size_t off =
          (((size_t)pid * page_size + k_pos % page_size) * Hkv + kvh) * D + d;
      kv = mlt::to_f32(k_pages[off]);
      vv = mlt::to_f32(v_pages[off]);
    }
    ks[j * C::kKStride + d] = kv;
    vs[j * D + d] = vv;
  }
}

// int8 pages: 16 elements a 16-byte load, dequantized as they land.
template <int D>
__device__ __forceinline__ void stage_tile(const int8_t* __restrict__ k_pages,
                                           const int8_t* __restrict__ v_pages,
                                           const float* __restrict__ k_scale,
                                           const float* __restrict__ v_scale,
                                           const int* __restrict__ page_ids,
                                           float* ks, float* vs, int k_start,
                                           int base, int Hkv, int kvh,
                                           int page_size, int pages_per_slot,
                                           int scratch_page) {
  using C = Tile<D>;
  constexpr int kVec = 16;
  constexpr int kRowVecs = D / kVec;
  for (int i = threadIdx.x; i < C::kBK * kRowVecs; i += C::kThreads) {
    const int j = i / kRowVecs, c = i % kRowVecs;
    const int k_pos = k_start + j;
    float* kd = ks + j * C::kKStride + c * kVec;
    float* vd = vs + j * D + c * kVec;
    const int page = k_pos / page_size;
    if (k_pos < base && page < pages_per_slot) {
      int pid = page_ids[page];
      if (pid < 0) pid = scratch_page;
      const size_t row =
          ((size_t)pid * page_size + k_pos % page_size) * Hkv + kvh;
      mlt::dequant16(reinterpret_cast<const int4*>(k_pages + row * D)[c],
                     k_scale[row], kd);
      mlt::dequant16(reinterpret_cast<const int4*>(v_pages + row * D)[c],
                     v_scale[row], vd);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) kd[e] = vd[e] = 0.f;
    }
  }
}

// One block: query rows [q_block*64, +64) of kv head kvh over the prefix
// 0..base-1 of one slot. q, page_ids, o and lse point at that slot.
template <typename T, typename KV, int D>
__device__ __forceinline__ void prefix_block(
    const T* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_ids,
    float* __restrict__ o, float* __restrict__ lse, int S, int H, int Hkv,
    int page_size, int pages_per_slot, int scratch_page, int base,
    float scale, int kvh, int q_block) {
  using C = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + C::kBQ * D;
  float* vs = ks + C::kBK * C::kKStride;
  float* ps = vs + C::kBK * D;

  const int n_rep = H / Hkv;
  const int rows = S * n_rep;
  const int r0 = q_block * C::kBQ;
  const int tid = threadIdx.x;

  for (int i = tid; i < C::kBQ * D; i += C::kThreads) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    float val = 0.f;
    if (row < rows) {
      const int tok = row / n_rep, rep = row % n_rep;
      val = mlt::to_f32(q[((size_t)tok * H + kvh * n_rep + rep) * D + d]) * scale;
    }
    qs[i] = val;
  }

  TileState<D> st;
  st.init();
  const PrefixMask mask{base};
  const int n_tiles = (base + C::kBK - 1) / C::kBK;
  for (int kb = 0; kb < n_tiles; ++kb) {
    __syncthreads();
    const int k_start = kb * C::kBK;
    stage_tile<D>(k_pages, v_pages, k_scale, v_scale, page_ids, ks, vs,
                  k_start, base, Hkv, kvh, page_size, pages_per_slot,
                  scratch_page);
    __syncthreads();
    mlt::tile_update<D>(qs, ks, vs, ps, st, mask, k_start);
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < C::kRows; ++r) {
    const int row = r0 + warp * C::kRows + r;
    if (row >= rows) continue;
    const int tok = row / n_rep, rep = row % n_rep;
    const int head = kvh * n_rep + rep;
    const float l = fmaxf(st.l[r], mlt::kMinDenom);
    const float inv = 1.f / l;
    float* out = o + ((size_t)tok * H + head) * D;
#pragma unroll
    for (int i = 0; i < C::kDLane; ++i) out[lane + 32 * i] = st.acc[r][i] * inv;
    if (lane == 0) lse[(size_t)tok * H + head] = st.m[r] + logf(l);
  }
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(Tile<D>::kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                         const KV* __restrict__ v_pages,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ page_ids,
                         float* __restrict__ o, float* __restrict__ lse,
                         int S, int H, int Hkv, int page_size,
                         int pages_per_slot, int scratch_page, int base,
                         float scale) {
  prefix_block<T, KV, D>(q, k_pages, v_pages, k_scale, v_scale, page_ids, o,
                         lse, S, H, Hkv, page_size, pages_per_slot,
                         scratch_page, base, scale, blockIdx.x, blockIdx.y);
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(Tile<D>::kThreads)
    paged_verify_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                        const KV* __restrict__ v_pages,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ base, float* __restrict__ o,
                        float* __restrict__ lse, int S, int H, int Hkv,
                        int page_size, int pages_per_slot, int scratch_page,
                        float scale) {
  const int slot = blockIdx.x / Hkv;
  const size_t rows = (size_t)slot * S * H;  // the slot's first (token, head)
  prefix_block<T, KV, D>(q + rows * (D), k_pages, v_pages, k_scale, v_scale,
                         table + (size_t)slot * pages_per_slot, o + rows * D,
                         lse + rows, S, H, Hkv, page_size, pages_per_slot,
                         scratch_page, base[slot], scale, blockIdx.x % Hkv,
                         blockIdx.y);
}


// ---------------------------------------------------------------------------
// bf16 q: the tensor-core body
// ---------------------------------------------------------------------------

using mlt::tc::bf16;
using mlt::tc::SmemTile;

// split-K: a chunk is this many 64-key tiles (128 keys) from position 0;
// ops/paged_attention.py PREFIX_CHUNK_KEYS sizes the verify scratch by it
// (the launch refuses a scratch of fewer chunks than a slot may need)
constexpr int kChunkTiles = 2;

template <typename KV, int D>
struct PrefixTc {
  static constexpr int kThreads = 128;  // 4 warps x 16 query rows
  static constexpr int kBQ = 64;
  static constexpr int kBK = 64;
  static constexpr int kKS = D / 16;    // k-slices of the head dim
  static constexpr int kND = D / 8;     // 8-column blocks of the head dim
  static constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  using Tile = SmemTile<D>;
  static constexpr int kRawStride = D + 16;  // bytes a staged int8 row
  static constexpr int kRawBytes = kBK * kRawStride;
  static constexpr int kScaleBytes = kBK * 4;
  static constexpr int kRawStageBytes = 2 * kRawBytes + 2 * kScaleBytes;
  // native: Q + 2 x (K + V) bf16 tiles; int8: Q + K + V bf16 tiles, their
  // k/v scales, and 2 stages of raw int8 K, V and scales
  static constexpr size_t kSmemBytes =
      kInt8 ? 3 * Tile::kBytes + 2 * kScaleBytes + 2 * kRawStageBytes
            : 5 * Tile::kBytes;
};

// One step of the fixed-order LSE merge of chunk states: (M, L) absorbs
// (m_c, l_c); an element then goes O * a + x_c * b. Every operation is an
// explicit round-to-nearest intrinsic, so the merging block of a split
// launch and the block that walks every chunk itself give the same bits.
__device__ __forceinline__ void lse_fold(float& M, float& L, float m_c,
                                         float l_c, float& a, float& b) {
  const float mn = fmaxf(M, m_c);
  a = mn == M ? 1.f
              : mlt::tc::exp2_approx(
                    __fmul_rn(__fsub_rn(M, mn), mlt::tc::kLog2e));
  b = mn == m_c ? 1.f
                : mlt::tc::exp2_approx(
                      __fmul_rn(__fsub_rn(m_c, mn), mlt::tc::kLog2e));
  L = __fmaf_rn(L, a, __fmul_rn(l_c, b));
  M = mn;
}

__device__ __forceinline__ float fold_elem(float O, float x, float a,
                                           float b) {
  return __fmaf_rn(O, a, __fmul_rn(x, b));
}

// final (o, lse) of a row from its merged state
__device__ __forceinline__ float lse_of(float M, float L) {
  return __fadd_rn(M, logf(fmaxf(L, mlt::kMinDenom)));
}
__device__ __forceinline__ float inv_of(float L) {
  return 1.f / fmaxf(L, mlt::kMinDenom);
}

// One block: query rows [q_block*64, +64) of kv head kvh over the prefix
// 0..base-1 of one slot (q, page_ids, o and lse point at that slot).
// chunk < 0: the block walks every chunk and merges them as it goes
// (prefill); chunk >= 0: it computes that chunk only, and the last block
// of (slot, kv head, q block) to arrive merges the chunks' partial states
// from ``part`` [max_chunks][S * n_rep][D + 2] (verify).
template <typename KV, int D>
__device__ __forceinline__ void prefix_tc_block(
    const bf16* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_ids,
    float* __restrict__ o, float* __restrict__ lse, int S, int H, int Hkv,
    int page_size, int pages_per_slot, int scratch_page, int base,
    float scale, int kvh, int q_block, int chunk, float* __restrict__ part,
    int* __restrict__ counter) {
  using C = PrefixTc<KV, D>;
  using Tile = typename C::Tile;
  constexpr int kStride = Tile::kStride;
  constexpr bool kInt8 = C::kInt8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  // native: buffer i is K at tile 1 + 2i, V at 2 + 2i; int8: K at tile 1,
  // V at 2, then the scales and the raw stages
  auto k_buf = [&](int i) { return qs + (1 + 2 * i) * Tile::kElems; };
  auto v_buf = [&](int i) { return qs + (2 + 2 * i) * Tile::kElems; };
  float* ks_s = reinterpret_cast<float*>(qs + 3 * Tile::kElems);
  float* vs_s = ks_s + C::kBK;
  unsigned char* raw0 = reinterpret_cast<unsigned char*>(vs_s + C::kBK);
  auto raw = [&](int i) { return raw0 + i * C::kRawStageBytes; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_rep = H / Hkv;
  const int rows = S * n_rep;
  const int r0 = q_block * C::kBQ;
  const int rows_here = min(C::kBQ, rows - r0);
  const bool warp_live = warp * 16 < rows_here;
  base = min(base, pages_per_slot * page_size);  // the plain version's view
  const int n_tiles = (base + C::kBK - 1) / C::kBK;
  const int n_chunks = (n_tiles + kChunkTiles - 1) / kChunkTiles;
  const bool split = chunk >= 0;
  if (split && chunk >= max(n_chunks, 1)) return;
  const int kb_lo = split ? chunk * kChunkTiles : 0;
  const int kb_hi = split ? min(kb_lo + kChunkTiles, n_tiles) - 1
                          : n_tiles - 1;

  // copies: tile row tid / 2, half the row's 16-byte pieces each; the row's
  // page is resolved once
  const int cp_row = tid >> 1;
  const int cp_half = tid & 1;
  auto row_of = [&](int k_pos, bool& ok) -> size_t {
    ok = k_pos < base;
    if (!ok) return 0;
    int pid = page_ids[k_pos / page_size];
    if (pid < 0) pid = scratch_page;
    return ((size_t)pid * page_size + k_pos % page_size) * Hkv + kvh;
  };
  auto stage = [&](int kb, int buf) {
    bool ok;
    const size_t row = row_of(kb * C::kBK + cp_row, ok);
    if constexpr (kInt8) {
      unsigned char* st = raw(buf);
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(k_pages) + row * D;
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(v_pages) + row * D;
#pragma unroll
      for (int c = cp_half; c < D / 16; c += 2) {
        mlt::tc::cp_async16(st + cp_row * C::kRawStride + 16 * c,
                            ksrc + 16 * c, ok);
        mlt::tc::cp_async16(st + C::kRawBytes + cp_row * C::kRawStride +
                                16 * c,
                            vsrc + 16 * c, ok);
      }
      float* sc = reinterpret_cast<float*>(st + 2 * C::kRawBytes);
      if (cp_half == 0) {
        mlt::tc::cp_async4(sc + cp_row, k_scale + row, ok);
        mlt::tc::cp_async4(sc + C::kBK + cp_row, v_scale + row, ok);
      }
    } else {
      const bf16* ksrc = reinterpret_cast<const bf16*>(k_pages) + row * D;
      const bf16* vsrc = reinterpret_cast<const bf16*>(v_pages) + row * D;
#pragma unroll
      for (int c = cp_half; c < D / 8; c += 2) {
        mlt::tc::cp_async16(k_buf(buf) + cp_row * kStride + 8 * c,
                            ksrc + 8 * c, ok);
        mlt::tc::cp_async16(v_buf(buf) + cp_row * kStride + 8 * c,
                            vsrc + 8 * c, ok);
      }
    }
  };
  // int8 K and V rows to bf16 tiles (exact: |x| <= 127), scales beside
  auto convert = [&](int buf) {
    const unsigned char* st = raw(buf);
    constexpr int kPieces = D / 8;  // 8 values each
    for (int i = tid; i < 2 * C::kBK * kPieces; i += C::kThreads) {
      const int which = i / (C::kBK * kPieces);
      const int rem = i % (C::kBK * kPieces);
      const int r = rem / kPieces, c = rem % kPieces;
      const uint2 w = *reinterpret_cast<const uint2*>(
          st + which * C::kRawBytes + r * C::kRawStride + 8 * c);
      float x[8];
      mlt::int8x4_to_f32(w.x, x);
      mlt::int8x4_to_f32(w.y, x + 4);
      uint32_t packed[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        packed[h] = mlt::tc::pack_bf16(x[2 * h], x[2 * h + 1]);
      bf16* dst = (which ? v_buf(0) : k_buf(0)) + r * kStride + 8 * c;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    const float* sc = reinterpret_cast<const float*>(st + 2 * C::kRawBytes);
    if (tid < C::kBK) ks_s[tid] = sc[tid];
    else vs_s[tid - C::kBK] = sc[tid];
  };

  // Q rows (row = token * n_rep + rep) as bf16, unscaled
  for (int i = tid; i < C::kBQ * (D / 8); i += C::kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const int row = r0 + r;
    const bool ok = r < rows_here;
    const bf16* src = q;
    if (ok) {
      const int tok = row / n_rep, rep = row % n_rep;
      src = q + ((size_t)tok * H + kvh * n_rep + rep) * D + 8 * c;
    }
    mlt::tc::cp_async16(qs + r * kStride + 8 * c, src, ok);
  }
  mlt::tc::cp_async_commit();
  if (kb_lo <= kb_hi) stage(kb_lo, 0);
  mlt::tc::cp_async_commit();
  // (Q stays in shared memory; its A fragments are read again for every
  // tile, which keeps D 128 inside 255 registers with the hi/lo P)

  // this thread's rows: tile rows warp*16 + g (a) and + 8 (b)
  const int row_a = r0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const bool ok_a = row_a < rows;
  const bool ok_b = row_b < rows;
  auto out_row = [&](int row) -> size_t {
    const int tok = row / n_rep, rep = row % n_rep;
    return (size_t)tok * H + kvh * n_rep + rep;
  };
  // this thread's o rows ((token, head) rows of o and lse)
  float* o_a = o + out_row(row_a) * D + 2 * t;
  float* o_b = o + out_row(row_b) * D + 2 * t;
  float m_a = mlt::kNegInf, m_b = mlt::kNegInf, l_a = 0.f, l_b = 0.f;
  float M_a = mlt::kNegInf, M_b = mlt::kNegInf, L_a = 0.f, L_b = 0.f;
  float acc[C::kND][4];
#pragma unroll
  for (int n = 0; n < C::kND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int buf = (kb - kb_lo) & 1;
    if (kb < kb_hi) {
      stage(kb + 1, buf ^ 1);
      mlt::tc::cp_async_commit();
      mlt::tc::cp_async_wait<1>();
    } else {
      mlt::tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile kb landed; the previous tile's reads done
    if constexpr (kInt8) {
      convert(buf);
      __syncthreads();
    }
    const bf16* kt = kInt8 ? k_buf(0) : k_buf(buf);
    const bf16* vt = kInt8 ? v_buf(0) : v_buf(buf);
    const int k_start = kb * C::kBK;

    if (warp_live) {
      // S = Q K^T, 16 rows x 64 keys a warp, float32 accumulation
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks_i = 0; ks_i < C::kKS; ++ks_i) {
        uint32_t qf[4];
        mlt::tc::load_a(qf, qs, kStride, warp * 16, ks_i * 16, lane);
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          uint32_t b0, b1, b2, b3;
          mlt::tc::load_b_rows(b0, b1, b2, b3, kt, kStride, n2 * 16,
                               ks_i * 16, lane);
          mlt::tc::mma_bf16(s[2 * n2], qf, b0, b1);
          mlt::tc::mma_bf16(s[2 * n2 + 1], qf, b2, b3);
        }
      }
      // scales after the product (int8: the key's scale, then the softmax
      // scale); keys at or past base masked
      float mx_a = mlt::kNegInf, mx_b = mlt::kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * 8 + 2 * t + (e & 1);
          float x = s[n][e];
          if constexpr (kInt8) x = __fmul_rn(x, ks_s[key]);
          x = __fmul_rn(x, scale);
          s[n][e] = k_start + key < base ? x : mlt::kNegInf;
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

      // l sums the float32 p; o = o * alpha, then += P V with P (int8:
      // times the value's scale) split hi + lo into two bf16 A operands,
      // formed 16 keys at a time
      float sum_a = 0.f, sum_b = 0.f;
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
      }
      sum_a = __fadd_rn(sum_a, __shfl_xor_sync(0xffffffffu, sum_a, 1));
      sum_a = __fadd_rn(sum_a, __shfl_xor_sync(0xffffffffu, sum_a, 2));
      sum_b = __fadd_rn(sum_b, __shfl_xor_sync(0xffffffffu, sum_b, 1));
      sum_b = __fadd_rn(sum_b, __shfl_xor_sync(0xffffffffu, sum_b, 2));
      l_a = __fmaf_rn(l_a, alpha_a, sum_a);
      l_b = __fmaf_rn(l_b, alpha_b, sum_b);
#pragma unroll
      for (int n = 0; n < C::kND; ++n) {
        acc[n][0] = __fmul_rn(acc[n][0], alpha_a);
        acc[n][1] = __fmul_rn(acc[n][1], alpha_a);
        acc[n][2] = __fmul_rn(acc[n][2], alpha_b);
        acc[n][3] = __fmul_rn(acc[n][3], alpha_b);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t p_hi[4], p_lo[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * kk + h;
          float w[4] = {s[n][0], s[n][1], s[n][2], s[n][3]};
          if constexpr (kInt8) {
            const float v0 = vs_s[n * 8 + 2 * t];
            const float v1 = vs_s[n * 8 + 2 * t + 1];
            w[0] = __fmul_rn(w[0], v0);
            w[1] = __fmul_rn(w[1], v1);
            w[2] = __fmul_rn(w[2], v0);
            w[3] = __fmul_rn(w[3], v1);
          }
          mlt::tc::split_bf16(w[0], w[1], p_hi[2 * h], p_lo[2 * h]);
          mlt::tc::split_bf16(w[2], w[3], p_hi[2 * h + 1], p_lo[2 * h + 1]);
        }
#pragma unroll
        for (int n2 = 0; n2 < C::kND / 2; ++n2) {
          uint32_t b0, b1, b2, b3;
          mlt::tc::load_b_cols(b0, b1, b2, b3, vt, kStride, kk * 16,
                               n2 * 16, lane);
          mlt::tc::mma_bf16(acc[2 * n2], p_hi, b0, b1);
          mlt::tc::mma_bf16(acc[2 * n2], p_lo, b0, b1);
          mlt::tc::mma_bf16(acc[2 * n2 + 1], p_hi, b2, b3);
          mlt::tc::mma_bf16(acc[2 * n2 + 1], p_lo, b2, b3);
        }
      }
    }
    if constexpr (!kInt8) __syncthreads();  // buffer buf free to refill

    // a walking block merges each finished chunk into the rows' state;
    // the merged o waits, unnormalized, in the rows' own o entries
    const bool chunk_end = (kb + 1) % kChunkTiles == 0 || kb == kb_hi;
    if (!split && chunk_end && warp_live) {
      const int c = kb / kChunkTiles;
      if (c == 0) {
        M_a = m_a, L_a = l_a, M_b = m_b, L_b = l_b;
      } else {
        float a_a, b_a, a_b, b_b;
        lse_fold(M_a, L_a, m_a, l_a, a_a, b_a);
        lse_fold(M_b, L_b, m_b, l_b, a_b, b_b);
#pragma unroll
        for (int n = 0; n < C::kND; ++n) {
          if (ok_a) {
            const float2 prev = *reinterpret_cast<const float2*>(o_a + 8 * n);
            acc[n][0] = fold_elem(prev.x, acc[n][0], a_a, b_a);
            acc[n][1] = fold_elem(prev.y, acc[n][1], a_a, b_a);
          }
          if (ok_b) {
            const float2 prev = *reinterpret_cast<const float2*>(o_b + 8 * n);
            acc[n][2] = fold_elem(prev.x, acc[n][2], a_b, b_b);
            acc[n][3] = fold_elem(prev.y, acc[n][3], a_b, b_b);
          }
        }
      }
      if (c + 1 < n_chunks) {
#pragma unroll
        for (int n = 0; n < C::kND; ++n) {
          if (ok_a)
            *reinterpret_cast<float2*>(o_a + 8 * n) =
                make_float2(acc[n][0], acc[n][1]);
          if (ok_b)
            *reinterpret_cast<float2*>(o_b + 8 * n) =
                make_float2(acc[n][2], acc[n][3]);
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        }
        m_a = m_b = mlt::kNegInf;
        l_a = l_b = 0.f;
      }
    }
  }
  mlt::tc::cp_async_wait<0>();  // nothing left in flight (an empty range)

  // a split block with one chunk in its slot, or a walking block: its state
  // is the merged state (one chunk merges to itself bit for bit)
  if (!split || n_chunks <= 1) {
    if (split) M_a = m_a, L_a = l_a, M_b = m_b, L_b = l_b;
    if (!warp_live) return;
    const float inv_a = inv_of(L_a), inv_b = inv_of(L_b);
#pragma unroll
    for (int n = 0; n < C::kND; ++n) {
      if (ok_a)
        *reinterpret_cast<float2*>(o_a + 8 * n) = make_float2(
            __fmul_rn(acc[n][0], inv_a), __fmul_rn(acc[n][1], inv_a));
      if (ok_b)
        *reinterpret_cast<float2*>(o_b + 8 * n) = make_float2(
            __fmul_rn(acc[n][2], inv_b), __fmul_rn(acc[n][3], inv_b));
    }
    if (t == 0 && ok_a) lse[out_row(row_a)] = lse_of(M_a, L_a);
    if (t == 0 && ok_b) lse[out_row(row_b)] = lse_of(M_b, L_b);
    return;
  }

  // split: this chunk's partial state, then the last block to arrive
  // merges every chunk in order 0, 1, 2, ...
  float* mine = part + (size_t)chunk * rows * (D + 2);
  if (warp_live) {
#pragma unroll
    for (int n = 0; n < C::kND; ++n) {
      const int col = n * 8 + 2 * t;
      if (ok_a)
        *reinterpret_cast<float2*>(mine + (size_t)row_a * (D + 2) + col) =
            make_float2(acc[n][0], acc[n][1]);
      if (ok_b)
        *reinterpret_cast<float2*>(mine + (size_t)row_b * (D + 2) + col) =
            make_float2(acc[n][2], acc[n][3]);
    }
    if (t == 0 && ok_a) {
      mine[(size_t)row_a * (D + 2) + D] = m_a;
      mine[(size_t)row_a * (D + 2) + D + 1] = l_a;
    }
    if (t == 0 && ok_b) {
      mine[(size_t)row_b * (D + 2) + D] = m_b;
      mine[(size_t)row_b * (D + 2) + D + 1] = l_b;
    }
  }
  __threadfence();  // partials visible device-wide before the count
  __syncthreads();
  if (tid == 0) {
    const int arrived = atomicAdd(counter, 1);
    is_last = arrived == n_chunks - 1;
    if (is_last) *counter = 0;  // zeroed for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < rows_here * D; i += C::kThreads) {
    const int row = r0 + i / D, d = i % D;
    const float* p0 = part + (size_t)row * (D + 2);
    float M = __ldcg(p0 + D), L = __ldcg(p0 + D + 1), O = __ldcg(p0 + d);
    for (int c = 1; c < n_chunks; ++c) {
      const float* pc = p0 + (size_t)c * rows * (D + 2);
      float a, b;
      lse_fold(M, L, __ldcg(pc + D), __ldcg(pc + D + 1), a, b);
      O = fold_elem(O, __ldcg(pc + d), a, b);
    }
    o[out_row(row) * D + d] = __fmul_rn(O, inv_of(L));
    if (d == 0) lse[out_row(row)] = lse_of(M, L);
  }
}

template <typename KV, int D>
__global__ void __launch_bounds__(128, 1)
    paged_prefill_tc_kernel(const bf16* __restrict__ q,
                            const KV* __restrict__ k_pages,
                            const KV* __restrict__ v_pages,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ page_ids,
                            float* __restrict__ o, float* __restrict__ lse,
                            int S, int H, int Hkv, int page_size,
                            int pages_per_slot, int scratch_page, int base,
                            float scale) {
  prefix_tc_block<KV, D>(q, k_pages, v_pages, k_scale, v_scale, page_ids, o,
                         lse, S, H, Hkv, page_size, pages_per_slot,
                         scratch_page, base, scale, blockIdx.x, blockIdx.y,
                         -1, nullptr, nullptr);
}

// grid (max chunks, q blocks, slots * Hkv)
template <typename KV, int D>
__global__ void __launch_bounds__(128, 1)
    paged_verify_tc_kernel(const bf16* __restrict__ q,
                           const KV* __restrict__ k_pages,
                           const KV* __restrict__ v_pages,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ table,
                           const int* __restrict__ base,
                           float* __restrict__ o, float* __restrict__ lse,
                           float* __restrict__ part,
                           int* __restrict__ counters, int S, int H,
                           int Hkv, int page_size, int pages_per_slot,
                           int scratch_page, float scale) {
  const int head = blockIdx.z;  // slot * Hkv + kv head
  const int slot = head / Hkv;
  const size_t rows = (size_t)slot * S * H;  // the slot's first (token, head)
  const size_t n_rows = (size_t)S * (H / Hkv);
  prefix_tc_block<KV, D>(
      q + rows * D, k_pages, v_pages, k_scale, v_scale,
      table + (size_t)slot * pages_per_slot, o + rows * D, lse + rows, S, H,
      Hkv, page_size, pages_per_slot, scratch_page, base[slot], scale,
      head % Hkv, blockIdx.y, blockIdx.x,
      part + (size_t)head * gridDim.x * n_rows * (D + 2),
      counters + (size_t)head * gridDim.y + blockIdx.y);
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* ids;   // page ids [pps] (prefill) or page table [slots, pps]
  void* o;
  void* lse;
  float* part;      // verify, bf16: split-K partial states
  int* counters;    // verify, bf16: zeroed arrival counters
  int max_chunks;   // verify, bf16: chunks a slot's part holds
  int slots;        // 0: prefill; > 0: verify over that many slots
  int S, H, Hkv, page_size, pages_per_slot, scratch_page;
  int base;         // prefill's prefix length
  const int* bases; // verify's per-slot prefix lengths
  float scale;
  cudaStream_t stream;
};

// float32 q on the FMA body
template <typename KV, int D>
int launch_fma(const Args& a) {
  using C = Tile<D>;
  const int rows = a.S * (a.H / a.Hkv);
  const int q_blocks = (rows + C::kBQ - 1) / C::kBQ;
  const auto q = static_cast<const float*>(a.q);
  const auto k = static_cast<const KV*>(a.k_pages);
  const auto v = static_cast<const KV*>(a.v_pages);
  const auto o = static_cast<float*>(a.o);
  const auto lse = static_cast<float*>(a.lse);
  if (a.slots == 0) {
    auto kernel = paged_prefill_kernel<float, KV, D>;
    cudaError_t err = mlt::allow_smem(kernel, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(a.Hkv, q_blocks), C::kThreads, C::kSmemBytes, a.stream>>>(
        q, k, v, a.k_scale, a.v_scale, a.ids, o, lse, a.S, a.H, a.Hkv,
        a.page_size, a.pages_per_slot, a.scratch_page, a.base, a.scale);
  } else {
    auto kernel = paged_verify_kernel<float, KV, D>;
    cudaError_t err = mlt::allow_smem(kernel, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(a.slots * a.Hkv, q_blocks), C::kThreads, C::kSmemBytes,
             a.stream>>>(q, k, v, a.k_scale, a.v_scale, a.ids, a.bases, o,
                         lse, a.S, a.H, a.Hkv, a.page_size, a.pages_per_slot,
                         a.scratch_page, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 q on the tensor cores
template <typename KV, int D>
int launch_tc(const Args& a) {
  using C = PrefixTc<KV, D>;
  const int rows = a.S * (a.H / a.Hkv);
  const int q_blocks = (rows + C::kBQ - 1) / C::kBQ;
  const auto q = static_cast<const bf16*>(a.q);
  const auto k = static_cast<const KV*>(a.k_pages);
  const auto v = static_cast<const KV*>(a.v_pages);
  const auto o = static_cast<float*>(a.o);
  const auto lse = static_cast<float*>(a.lse);
  if (a.slots == 0) {
    auto kernel = paged_prefill_tc_kernel<KV, D>;
    cudaError_t err = mlt::allow_smem(kernel, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(a.Hkv, q_blocks), C::kThreads, C::kSmemBytes, a.stream>>>(
        q, k, v, a.k_scale, a.v_scale, a.ids, o, lse, a.S, a.H, a.Hkv,
        a.page_size, a.pages_per_slot, a.scratch_page, a.base, a.scale);
  } else {
    // the scratch holds a.max_chunks chunks; a slot may need this many
    const int tiles = (a.pages_per_slot * a.page_size + C::kBK - 1) / C::kBK;
    if (a.part == nullptr || a.counters == nullptr ||
        a.max_chunks < (tiles + kChunkTiles - 1) / kChunkTiles)
      return mlt::kBadArgument;
    auto kernel = paged_verify_tc_kernel<KV, D>;
    cudaError_t err = mlt::allow_smem(kernel, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(a.max_chunks, q_blocks, a.slots * a.Hkv), C::kThreads,
             C::kSmemBytes, a.stream>>>(
        q, k, v, a.k_scale, a.v_scale, a.ids, a.bases, o, lse, a.part,
        a.counters, a.S, a.H, a.Hkv, a.page_size, a.pages_per_slot,
        a.scratch_page, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// int8 pages when the scales are given, else pages in q's dtype; the body
// by q's dtype
int dispatch(int dtype, int head_dim, const Args& a) {
  if (a.S <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.page_size <= 0 ||
      a.pages_per_slot <= 0 || a.base < 0 || a.slots < 0 ||
      (a.k_scale == nullptr) != (a.v_scale == nullptr) ||
      !aligned16(a.q) || !aligned16(a.k_pages) || !aligned16(a.v_pages))
    return mlt::kBadArgument;
  return mlt::dispatch_dtype_dim(dtype, head_dim, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(d)::value;
    if constexpr (std::is_same_v<T, float>)
      return a.k_scale ? launch_fma<int8_t, kD>(a) : launch_fma<float, kD>(a);
    else
      return a.k_scale ? launch_tc<int8_t, kD>(a) : launch_tc<bf16, kD>(a);
  });
}

}  // namespace

extern "C" int mlt_paged_prefill(int dtype, int head_dim, const void* q,
                                 const void* k_pages, const void* v_pages,
                                 const void* page_ids, void* o, void* lse,
                                 int S, int H, int Hkv, int page_size,
                                 int pages_per_slot, int scratch_page,
                                 int base, float scale, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(page_ids), o, lse, nullptr, nullptr, 0,
               0, S, H, Hkv, page_size, pages_per_slot, scratch_page, base,
               nullptr, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a);
}

// int8 pages with float32 per-vector scales [P+1, page_size, Hkv]
extern "C" int mlt_paged_prefill_int8(int dtype, int head_dim, const void* q,
                                      const void* k_pages, const void* v_pages,
                                      const void* k_scale, const void* v_scale,
                                      const void* page_ids, void* o, void* lse,
                                      int S, int H, int Hkv, int page_size,
                                      int pages_per_slot, int scratch_page,
                                      int base, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return mlt::kBadArgument;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_ids), o, lse, nullptr, nullptr, 0,
               0, S, H, Hkv, page_size, pages_per_slot, scratch_page, base,
               nullptr, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a);
}

// k_scale/v_scale null: pages in q's dtype; both given: int8 pages.
// part: float32 scratch of slots * Hkv * max_chunks * S * (H / Hkv) *
// (head_dim + 2) values, max_chunks at least ceil(pages_per_slot *
// page_size / 128); counters: slots * Hkv * ceil(S * (H / Hkv) / 64)
// int32 zeros, left zeroed by every launch (launches that share them must
// be ordered on one stream). All three are read by the bf16 body only.
extern "C" int mlt_paged_verify(int dtype, int head_dim, const void* q,
                                const void* k_pages, const void* v_pages,
                                const void* k_scale, const void* v_scale,
                                const void* page_table, const void* base,
                                void* o, void* lse, void* part,
                                void* counters, int max_chunks, int slots,
                                int S, int H, int Hkv, int page_size,
                                int pages_per_slot, int scratch_page,
                                float scale, void* stream) {
  if (slots <= 0) return mlt::kBadArgument;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table), o, lse,
               static_cast<float*>(part), static_cast<int*>(counters),
               max_chunks, slots, S, H, Hkv, page_size, pages_per_slot,
               scratch_page, 0,
               static_cast<const int*>(base), scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a);
}
