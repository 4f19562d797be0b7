// Paged-decode attention: one query token per slot, read straight off the
// KV page pool through the page table.
//
// Replaces the Pallas kernel mlrun_tpu/ops/paged_attention.py
// _paged_decode_kernel, both variants, called through _paged_decode_call
// / paged_attention on every decode tick, once per layer:
//   - native pages (mlt_paged_decode): pages in q's dtype;
//   - int8 pages (mlt_paged_decode_int8, quantized=True): int8 pages with
//     float32 per-vector scales [P+1, page_size, Hkv], dequantized on the
//     way into shared memory (one float32 multiply per element, exactly
//     the reference's k * ks[:, None]).
//
// q [slots, H, D]; k/v pages [P+1, page_size, Hkv, D] (the last page is
// the scratch page); page_table [slots, pages_per_slot] int32, -1 =
// unmapped (routed to the scratch page); pos [slots] int32, the position
// of the current token, whose KV is already in the pool. Keys at
// k_pos > pos are masked and pages wholly past pos are skipped. Output
// [slots, H, D] in q's dtype.
//
// What bounds it on the H100: bytes. Each live key and value vector is
// read once and used for n_rep (4 at Llama-3-8B) query heads, about 1 FLOP
// per byte (2 for int8 pages), far below the card's ~295 FLOP per byte
// line, so the bound is the live KV bytes (int8: 1 byte an element plus 4
// bytes a (position, kv head) scale) over 3.35 TB/s.
//
// Design: grid (slot, kv_head), 128 threads. The block holds its GQA
// group's n_rep query rows in shared memory and walks the slot's pages
// 0..pos/page_size in order, carrying the online softmax (running max,
// denominator, accumulator) in shared memory; that loop takes the place of
// the Pallas kernel's sequential page grid axis. Each page's K and V tile
// (page_size x D) is staged into shared memory with 16-byte loads (int8
// pages: 16 elements a load, scaled to float32 as they land), then the
// logits are formed one key per warp (lanes over D) and the value sum one
// output column per thread. The block loads its own page-table entries.
// Known limit: at 4 slots x 8 kv heads the grid is 32 blocks on 132 SMs,
// so most of the card idles and the kernel cannot reach the bandwidth
// bound (PERF.md, open questions).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;

// shared-memory element type of a staged page: the pages' own type, or
// float32 for int8 pages (dequantized on the way in)
template <typename T, typename KV>
using Staged = std::conditional_t<std::is_same_v<KV, int8_t>, float, T>;

template <typename S>
size_t smem_bytes(int D, int n_rep, int page_size) {
  return 2 * (size_t)page_size * D * sizeof(S) +
         (2 * (size_t)n_rep * D + (size_t)n_rep * page_size + 3 * kMaxRep) *
             sizeof(float);
}

// Stage one page's K and V rows of kv head kvh into shared memory.
template <int D, typename T>
__device__ __forceinline__ void stage_page(const T* __restrict__ k_pages,
                                           const T* __restrict__ v_pages,
                                           const float*, const float*, T* ks,
                                           T* vs, int pid, int page_size,
                                           int Hkv, int kvh) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kRowVecs = D / kVec;
  for (int i = threadIdx.x; i < page_size * kRowVecs; i += kThreads) {
    const int j = i / kRowVecs, c = i % kRowVecs;
    const size_t off = (((size_t)pid * page_size + j) * Hkv + kvh) * D;
    reinterpret_cast<uint4*>(ks + (size_t)j * D)[c] =
        reinterpret_cast<const uint4*>(k_pages + off)[c];
    reinterpret_cast<uint4*>(vs + (size_t)j * D)[c] =
        reinterpret_cast<const uint4*>(v_pages + off)[c];
  }
}

template <int D>
__device__ __forceinline__ void stage_page(const int8_t* __restrict__ k_pages,
                                           const int8_t* __restrict__ v_pages,
                                           const float* __restrict__ k_scale,
                                           const float* __restrict__ v_scale,
                                           float* ks, float* vs, int pid,
                                           int page_size, int Hkv, int kvh) {
  constexpr int kVec = 16;  // int8 elements per 16-byte load
  constexpr int kRowVecs = D / kVec;
  for (int i = threadIdx.x; i < page_size * kRowVecs; i += kThreads) {
    const int j = i / kRowVecs, c = i % kRowVecs;
    const size_t row = ((size_t)pid * page_size + j) * Hkv + kvh;
    mlt::dequant16(reinterpret_cast<const int4*>(k_pages + row * D)[c],
                   k_scale[row], ks + (size_t)j * D + c * kVec);
    mlt::dequant16(reinterpret_cast<const int4*>(v_pages + row * D)[c],
                   v_scale[row], vs + (size_t)j * D + c * kVec);
  }
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                        const KV* __restrict__ v_pages,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int H, int Hkv, int page_size, int pages_per_slot,
                        int scratch_page, float scale) {
  using S = Staged<T, KV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_rep = H / Hkv;
  S* ks = reinterpret_cast<S*>(smem_raw);   // [page_size][D]
  S* vs = ks + (size_t)page_size * D;       // [page_size][D]
  float* qs = reinterpret_cast<float*>(vs + (size_t)page_size * D);  // [n_rep][D]
  float* acc = qs + n_rep * D;              // [n_rep][D]
  float* sc = acc + n_rep * D;              // [n_rep][page_size]
  float* m = sc + n_rep * page_size;        // [kMaxRep]
  float* l = m + kMaxRep;                   // [kMaxRep]
  float* alpha = l + kMaxRep;               // [kMaxRep]

  const int slot = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int head0 = kvh * n_rep;
  const int cur = pos[slot];

  for (int i = tid; i < n_rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = mlt::to_f32(q[((size_t)slot * H + head0 + r) * D + d]) * scale;
    acc[i] = 0.f;
  }
  if (tid < n_rep) {
    m[tid] = mlt::kNegInf;
    l[tid] = 0.f;
  }

  const int last_page = min(max(cur, 0) / page_size, pages_per_slot - 1);
  for (int p = 0; p <= last_page; ++p) {
    int pid = table[(size_t)slot * pages_per_slot + p];
    if (pid < 0) pid = scratch_page;
    __syncthreads();  // previous page consumed (and q/acc initialised)
    stage_page<D>(k_pages, v_pages, k_scale, v_scale, ks, vs, pid, page_size,
                  Hkv, kvh);
    __syncthreads();

    // logits, one key per warp: lanes split the head dim
    for (int j = warp; j < page_size; j += kWarps) {
      float part[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) part[r] = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32) {
        const float kv = mlt::to_f32(ks[(size_t)j * D + d]);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < n_rep) part[r] = fmaf(qs[r * D + d], kv, part[r]);
      }
      const bool live = p * page_size + j <= cur;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= n_rep) break;
        const float s = mlt::warp_sum(part[r]);
        if (lane == 0) sc[r * page_size + j] = live ? s : mlt::kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics, one query row per warp
    for (int r = warp; r < n_rep; r += kWarps) {
      float* row = sc + r * page_size;
      float mx = mlt::kNegInf;
      for (int j = lane; j < page_size; j += 32) mx = fmaxf(mx, row[j]);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mlt::warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < page_size; j += 32) {
        const float w = expf(row[j] - m_new);
        row[j] = w;
        sum += w;
      }
      sum = mlt::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // value sum, one output column per thread
    for (int i = tid; i < n_rep * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* w = sc + r * page_size;
      float s = 0.f;
      for (int j = 0; j < page_size; ++j)
        s = fmaf(w[j], mlt::to_f32(vs[(size_t)j * D + d]), s);
      acc[i] = acc[i] * alpha[r] + s;
    }
  }
  __syncthreads();

  for (int i = tid; i < n_rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    out[((size_t)slot * H + head0 + r) * D + d] =
        mlt::from_f32<T>(acc[i] / fmaxf(l[r], mlt::kMinDenom));
  }
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* pos;
  void* out;
  int slots, H, Hkv, page_size, pages_per_slot, scratch_page;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D>
int launch(const Args& a) {
  const size_t smem = smem_bytes<Staged<T, KV>>(D, a.H / a.Hkv, a.page_size);
  auto kernel = paged_decode_kernel<T, KV, D>;
  cudaError_t err = mlt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.slots, a.Hkv);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pages),
      static_cast<const KV*>(a.v_pages), a.k_scale, a.v_scale, a.table, a.pos,
      static_cast<T*>(a.out), a.H, a.Hkv, a.page_size, a.pages_per_slot,
      a.scratch_page, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// KV: the page element type, or void for "same as q"
template <typename KV>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (a.slots <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      a.H / a.Hkv > kMaxRep || a.page_size <= 0 || a.pages_per_slot <= 0)
    return mlt::kBadArgument;
  return mlt::dispatch_dtype_dim(dtype, head_dim, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    using P = std::conditional_t<std::is_void_v<KV>, T, KV>;
    return launch<T, P, decltype(d)::value>(a);
  });
}

}  // namespace

extern "C" int mlt_paged_decode(int dtype, int head_dim, const void* q,
                                const void* k_pages, const void* v_pages,
                                const void* page_table, const void* pos,
                                void* out, int slots, int H, int Hkv,
                                int page_size, int pages_per_slot,
                                int scratch_page, float scale, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(page_table), static_cast<const int*>(pos),
               out, slots, H, Hkv, page_size, pages_per_slot, scratch_page,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<void>(dtype, head_dim, a);
}

// int8 pages with float32 per-vector scales [P+1, page_size, Hkv]
extern "C" int mlt_paged_decode_int8(int dtype, int head_dim, const void* q,
                                     const void* k_pages, const void* v_pages,
                                     const void* k_scale, const void* v_scale,
                                     const void* page_table, const void* pos,
                                     void* out, int slots, int H, int Hkv,
                                     int page_size, int pages_per_slot,
                                     int scratch_page, float scale,
                                     void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table), static_cast<const int*>(pos),
               out, slots, H, Hkv, page_size, pages_per_slot, scratch_page,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<int8_t>(dtype, head_dim, a);
}
