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
// int8 pages carry float32 per-vector scales [P+1, page_size, Hkv]; a
// staged key or value is the int8 element times its scale in float32 (the
// reference's k * ks[:, None]), so the kernel sees the plain version's
// dequantized values bit for bit.
//
// What bounds it on the H100: the prefill reads base * Hkv * D prefix
// keys and values once and does 4*D FLOPs per (query row, prefix key)
// pair; with a few hundred query rows per kv head that is above the
// bytes-to-operations line, so the bound is arithmetic. A verify block
// holds only S * n_rep rows (20 at k 4 and Llama-3-8B), about 5 FLOPs a
// byte, so verify is bound by bytes. This first version uses float32 FMAs
// from shared memory (attn_tile.cuh) for both, well below either bound.
//
// Design: the rows of one kv head are the chunk's tokens times the GQA
// group (row = token * n_rep + r, as in the Pallas kernels), so each
// staged key tile serves n_rep query heads at once. Prefill grid (Hkv,
// ceil(S*n_rep/64)); verify grid (slots * Hkv, ceil(S*n_rep/64)), each
// block reading its own slot's page-table row and base. A block walks key
// tiles of 64 positions over 0..base-1, resolving each key's page through
// the page ids itself (no scalar prefetch), so any page size works. Both
// entry points run the same block body, so a one-slot verify gives the
// prefill's bits.
#include "attn_tile.cuh"

namespace {

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

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* ids;   // page ids [pps] (prefill) or page table [slots, pps]
  void* o;
  void* lse;
  int slots;        // 0: prefill; > 0: verify over that many slots
  int S, H, Hkv, page_size, pages_per_slot, scratch_page;
  int base;         // prefill's prefix length
  const int* bases; // verify's per-slot prefix lengths
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D>
int launch(const Args& a) {
  using C = Tile<D>;
  const int rows = a.S * (a.H / a.Hkv);
  const int q_blocks = (rows + C::kBQ - 1) / C::kBQ;
  const auto q = static_cast<const T*>(a.q);
  const auto k = static_cast<const KV*>(a.k_pages);
  const auto v = static_cast<const KV*>(a.v_pages);
  const auto o = static_cast<float*>(a.o);
  const auto lse = static_cast<float*>(a.lse);
  if (a.slots == 0) {
    auto kernel = paged_prefill_kernel<T, KV, D>;
    cudaError_t err = mlt::allow_smem(kernel, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(a.Hkv, q_blocks), C::kThreads, C::kSmemBytes, a.stream>>>(
        q, k, v, a.k_scale, a.v_scale, a.ids, o, lse, a.S, a.H, a.Hkv,
        a.page_size, a.pages_per_slot, a.scratch_page, a.base, a.scale);
  } else {
    auto kernel = paged_verify_kernel<T, KV, D>;
    cudaError_t err = mlt::allow_smem(kernel, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(a.slots * a.Hkv, q_blocks), C::kThreads, C::kSmemBytes,
             a.stream>>>(q, k, v, a.k_scale, a.v_scale, a.ids, a.bases, o,
                         lse, a.S, a.H, a.Hkv, a.page_size, a.pages_per_slot,
                         a.scratch_page, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// int8 pages when the scales are given, else pages in q's dtype
int dispatch(int dtype, int head_dim, const Args& a) {
  if (a.S <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.page_size <= 0 ||
      a.pages_per_slot <= 0 || a.base < 0 || a.slots < 0 ||
      (a.k_scale == nullptr) != (a.v_scale == nullptr))
    return mlt::kBadArgument;
  return mlt::dispatch_dtype_dim(dtype, head_dim, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(d)::value;
    return a.k_scale ? launch<T, int8_t, kD>(a) : launch<T, T, kD>(a);
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
               static_cast<const int*>(page_ids), o, lse, 0, S, H, Hkv,
               page_size, pages_per_slot, scratch_page, base, nullptr, scale,
               static_cast<cudaStream_t>(stream)};
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
               static_cast<const int*>(page_ids), o, lse, 0, S, H, Hkv,
               page_size, pages_per_slot, scratch_page, base, nullptr, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a);
}

// k_scale/v_scale null: pages in q's dtype; both given: int8 pages
extern "C" int mlt_paged_verify(int dtype, int head_dim, const void* q,
                                const void* k_pages, const void* v_pages,
                                const void* k_scale, const void* v_scale,
                                const void* page_table, const void* base,
                                void* o, void* lse, int slots, int S, int H,
                                int Hkv, int page_size, int pages_per_slot,
                                int scratch_page, float scale, void* stream) {
  if (slots <= 0) return mlt::kBadArgument;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table), o, lse, slots, S, H, Hkv,
               page_size, pages_per_slot, scratch_page, 0,
               static_cast<const int*>(base), scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a);
}
