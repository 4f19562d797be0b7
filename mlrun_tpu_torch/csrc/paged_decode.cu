// Paged-decode attention: one query token per slot, read straight off the
// KV page pool through the page table.
//
// Replaces the Pallas kernel mlrun_tpu/ops/paged_attention.py
// _paged_decode_kernel, both variants, called through _paged_decode_call
// / paged_attention on every decode tick, once per layer:
//   - native pages (mlt_paged_decode): pages in q's dtype;
//   - int8 pages (mlt_paged_decode_int8, quantized=True): int8 pages with
//     float32 per-vector scales [P+1, page_size, Hkv], dequantized in
//     registers (one float32 multiply per element, exactly the
//     reference's k * ks[:, None]).
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
// bytes a (position, kv head) scale) over 3.35 TB/s. Reaching it needs
// many blocks with copies in flight, not arithmetic.
//
// Design (split-K over pages, one launch):
//   - a slot's keys are cut into chunks of max(1, kChunkKeys / page_size)
//     pages (a function of the page size alone: 128 keys a chunk for pages
//     up to 128); grid (max chunks, Hkv, slots), 128 threads. A block owns
//     one (slot, kv head, chunk); blocks past the slot's last live page
//     exit at once. At 4 slots of up to 2048 tokens and 8 kv heads that is
//     up to 512 blocks in flight instead of 32.
//   - a block walks its chunk in tiles of 32 keys; each tile's K and V
//     rows (and int8 scales) are copied with 16-byte cp.async into a
//     3-stage ring, two tiles ahead of the compute. Pages stay in their own
//     type in shared memory (bf16, float32 or int8), rows padded by 16
//     bytes so the row-strided reads below are free of bank conflicts. A
//     thread resolves its tile row's page once per tile.
//   - logits: lanes take keys, warps take quarters of the head dim; each
//     thread converts (int8: dequantizes) its quarter key row once into
//     registers and dots it with every one of the n_rep query rows; the
//     four quarters are added in a fixed order through shared memory.
//     Warp w then owns query rows w and w + 4 for the online softmax (one
//     max and one sum butterfly a row a tile, not a shuffle reduction per
//     key).
//   - value sum: a thread owns one head-dim column of every query row and
//     128 / D key groups split the tile's keys; the groups are added in a
//     fixed order at the end.
//   - merge: a chunk writes its (m, l, acc) to a scratch buffer the wrapper
//     allocates; the last block of a (slot, kv head) to arrive (an atomic
//     counter the wrapper keeps zeroed, reset by that block) merges the
//     chunks by LSE in chunk order 0, 1, 2, ... A one-chunk slot writes its
//     output directly, with the bits the merge would give (weight
//     expf(0) = 1 exactly). So a slot's output bits depend on its own pos,
//     page size and data only: never on the other slots, the slot count or
//     which block finishes first. One launch a call: the tick is host-bound
//     and a second launch per layer would be host time.
#include <type_traits>

#include "tensor_core.cuh"

namespace {

using mlt::tc::cp_async16;
using mlt::tc::cp_async4;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;
constexpr int kTileKeys = 32;   // one key a lane
constexpr int kStages = 3;
constexpr int kPad = 16;        // bytes of padding a staged row
// split-K: a chunk is max(1, kChunkKeys / page_size) pages of a slot;
// ops/paged_attention.py DECODE_CHUNK_KEYS sizes the scratch by it (the
// launch refuses a scratch of fewer chunks than a slot may need)
constexpr int kChunkKeys = 128;

template <typename KV, int D>
struct Layout {
  static constexpr int kRowBytes = D * sizeof(KV) + kPad;
  static constexpr int kTileBytes = kTileKeys * kRowBytes;
  static constexpr int kChunks16 = D * sizeof(KV) / 16;  // per row
  static constexpr int kQuarter = D / kWarps;            // logits' d-range
  static constexpr int kGroups = kThreads / D;           // value-sum groups
  // stage s: K tile, V tile, then (int8) k and v scales of its rows
  static constexpr int kScaleBytes =
      std::is_same_v<KV, int8_t> ? 2 * kTileKeys * 4 : 0;
  static constexpr int kStageBytes = 2 * kTileBytes + kScaleBytes;
  // q [kMaxRep][D] f32, quarter sums [kWarps][kMaxRep][kTileKeys],
  // p [kTileKeys][kMaxRep], alpha / m / l [kMaxRep], group sums
  // [kGroups][kMaxRep][D] (aliasing the quarter sums when they fit)
  static constexpr int kRedFloats = kWarps * kMaxRep * kTileKeys;
  static constexpr int kGroupFloats = kGroups * kMaxRep * D;
  static constexpr int kScratchFloats =
      kMaxRep * D + (kRedFloats > kGroupFloats ? kRedFloats : kGroupFloats) +
      kTileKeys * kMaxRep + 3 * kMaxRep;
  static constexpr size_t kSmemBytes =
      (size_t)kStages * kStageBytes + kScratchFloats * sizeof(float);
};

// n contiguous elements of a staged row as float32 (int8: times its scale)
template <int N>
__device__ __forceinline__ void row_f32(const float* p, float, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x;
    out[i + 1] = v.y;
    out[i + 2] = v.z;
    out[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void row_f32(const __nv_bfloat16* p, float,
                                        float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // bf16 -> float32 is exact: the bf16 bits are the float's top half
      out[i + 2 * k] = __uint_as_float(w[k] << 16);
      out[i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

template <int N>
__device__ __forceinline__ void row_f32(const int8_t* p, float scale,
                                        float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p + i);
    mlt::int8x4_to_f32(raw.x, out + i);
    mlt::int8x4_to_f32(raw.y, out + i + 4);
#pragma unroll
    for (int b = 0; b < 8; ++b) out[i + b] = __fmul_rn(out[i + b], scale);
  }
}

__device__ __forceinline__ float elem_f32(const float* p, int i, float) {
  return p[i];
}
__device__ __forceinline__ float elem_f32(const __nv_bfloat16* p, int i,
                                          float) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float elem_f32(const int8_t* p, int i,
                                          float scale) {
  float x[4];
  mlt::int8x4_to_f32(reinterpret_cast<const uint8_t*>(p)[i], x);
  return __fmul_rn(x[0], scale);
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                        const KV* __restrict__ v_pages,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, T* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ counters,
                        int H, int Hkv, int page_size, int pages_per_slot,
                        int pages_per_chunk, int scratch_page, float scale) {
  using L = Layout<KV, D>;
  constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw + kStages * L::kStageBytes);
  float* red = qs + kMaxRep * D;  // quarter sums, later group sums
  float* ps = red + (L::kRedFloats > L::kGroupFloats ? L::kRedFloats
                                                     : L::kGroupFloats);
  float* alpha_s = ps + kTileKeys * kMaxRep;
  float* m_s = alpha_s + kMaxRep;
  float* l_s = m_s + kMaxRep;
  __shared__ int is_last;

  const int chunk = blockIdx.x;
  const int kvh = blockIdx.y;
  const int slot = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_rep = H / Hkv;
  const int cur = pos[slot];
  const int chunk_keys = pages_per_chunk * page_size;
  const int last_page = min(max(cur, 0) / page_size, pages_per_slot - 1);
  const int n_chunks = last_page / pages_per_chunk + 1;
  if (chunk >= n_chunks) return;
  const int k_begin = chunk * chunk_keys;
  const int k_end = min(min(k_begin + chunk_keys, max(cur, 0) + 1),
                        pages_per_slot * page_size);
  const int n_tiles = (k_end - k_begin + kTileKeys - 1) / kTileKeys;
  const int* row_table = table + (size_t)slot * pages_per_slot;

  // tile row tid / 4 is copied by 4 threads, 16 bytes at a time
  const int cp_row = tid >> 2;
  const int cp_col = tid & 3;
  auto stage = [&](int tile, int buf) {
    unsigned char* base = smem_raw + buf * L::kStageBytes;
    const int k_pos = k_begin + tile * kTileKeys + cp_row;
    const bool ok = k_pos < k_end;
    size_t row = 0;
    if (ok) {
      int pid = row_table[k_pos / page_size];
      if (pid < 0) pid = scratch_page;
      row = ((size_t)pid * page_size + k_pos % page_size) * Hkv + kvh;
    }
    const unsigned char* ksrc =
        reinterpret_cast<const unsigned char*>(k_pages + row * D);
    const unsigned char* vsrc =
        reinterpret_cast<const unsigned char*>(v_pages + row * D);
    unsigned char* kdst = base + cp_row * L::kRowBytes;
    unsigned char* vdst = kdst + L::kTileBytes;
#pragma unroll
    for (int c = cp_col; c < L::kChunks16; c += 4) {
      cp_async16(kdst + 16 * c, ksrc + 16 * c, ok);
      cp_async16(vdst + 16 * c, vsrc + 16 * c, ok);
    }
    if constexpr (kInt8) {
      float* sc = reinterpret_cast<float*>(base + 2 * L::kTileBytes);
      if (cp_col == 0) {
        cp_async4(sc + cp_row, k_scale + row, ok);
        cp_async4(sc + kTileKeys + cp_row, v_scale + row, ok);
      }
    }
  };

  // the first two tiles in flight before q is read
  stage(0, 0);
  mlt::tc::cp_async_commit();
  if (n_tiles > 1) stage(1, 1);
  mlt::tc::cp_async_commit();

  const size_t q_row0 = (size_t)slot * H + (size_t)kvh * n_rep;
  for (int i = tid; i < n_rep * D; i += kThreads)
    qs[i] = mlt::to_f32(q[q_row0 * D + i]);

  // online-softmax state of rows warp and warp + 4, in every lane
  float m_row[2] = {mlt::kNegInf, mlt::kNegInf};
  float l_row[2] = {0.f, 0.f};
  // value sums: column d of every row, keys of group g
  const int d_col = tid % D;
  const int group = tid / D;
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile % kStages;
    mlt::tc::cp_async_wait<1>();
    __syncthreads();  // tile visible; the previous tile fully consumed
    if (tile + 2 < n_tiles) stage(tile + 2, (tile + 2) % kStages);
    mlt::tc::cp_async_commit();

    const unsigned char* base = smem_raw + buf * L::kStageBytes;
    const KV* kt = reinterpret_cast<const KV*>(base);
    const KV* vt = reinterpret_cast<const KV*>(base + L::kTileBytes);
    const float* sc = reinterpret_cast<const float*>(base + 2 * L::kTileBytes);

    // logits: lane = key, warp = head-dim quarter, 8 key values at a time
    // against every query row
    {
      const KV* krow = reinterpret_cast<const KV*>(
                           reinterpret_cast<const unsigned char*>(kt) +
                           lane * L::kRowBytes) +
                       warp * L::kQuarter;
      const float k_sc = kInt8 ? sc[lane] : 1.f;
      float dot[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) dot[r] = 0.f;
#pragma unroll
      for (int c = 0; c < L::kQuarter; c += 8) {
        float kv[8];
        row_f32<8>(krow + c, k_sc, kv);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r >= n_rep) break;
          const float* qr = qs + r * D + warp * L::kQuarter + c;
          const float4 q0 = *reinterpret_cast<const float4*>(qr);
          const float4 q1 = *reinterpret_cast<const float4*>(qr + 4);
          float x = dot[r];
          x = fmaf(q0.x, kv[0], x);
          x = fmaf(q0.y, kv[1], x);
          x = fmaf(q0.z, kv[2], x);
          x = fmaf(q0.w, kv[3], x);
          x = fmaf(q1.x, kv[4], x);
          x = fmaf(q1.y, kv[5], x);
          x = fmaf(q1.z, kv[6], x);
          x = fmaf(q1.w, kv[7], x);
          dot[r] = x;
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < n_rep) red[(warp * kMaxRep + r) * kTileKeys + lane] = dot[r];
    }
    __syncthreads();

    // online softmax: warp w owns rows w and w + 4, lane = key
    {
      const int k_pos = k_begin + tile * kTileKeys + lane;
      const bool live = k_pos < k_end && k_pos <= cur;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp + kWarps * i;
        if (r >= n_rep) break;
        float s = red[r * kTileKeys + lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          s += red[(w * kMaxRep + r) * kTileKeys + lane];
        s = live ? s * scale : mlt::kNegInf;
        const float m_new = fmaxf(m_row[i], mlt::warp_max(s));
        const float p = expf(s - m_new);
        const float a = expf(m_row[i] - m_new);
        l_row[i] = l_row[i] * a + mlt::warp_sum(p);
        m_row[i] = m_new;
        ps[lane * kMaxRep + r] = p;
        if (lane == 0) alpha_s[r] = a;
      }
    }
    __syncthreads();

    // value sum: thread = (key group, column)
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < n_rep) acc[r] *= alpha_s[r];
    constexpr int kKeysPerGroup = kTileKeys / L::kGroups;
#pragma unroll 4
    for (int jj = 0; jj < kKeysPerGroup; ++jj) {
      const int j = group * kKeysPerGroup + jj;
      const float v = elem_f32(
          reinterpret_cast<const KV*>(reinterpret_cast<const unsigned char*>(
                                          vt) + j * L::kRowBytes),
          d_col, kInt8 ? sc[kTileKeys + j] : 1.f);
      const float4 p0 = *reinterpret_cast<const float4*>(ps + j * kMaxRep);
      const float4 p1 =
          *reinterpret_cast<const float4*>(ps + j * kMaxRep + 4);
      const float pr[kMaxRep] = {p0.x, p0.y, p0.z, p0.w,
                                 p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < n_rep) acc[r] = fmaf(pr[r], v, acc[r]);
    }
  }
  mlt::tc::cp_async_wait<0>();
  __syncthreads();  // every thread done with the last tile

  // key groups added in a fixed order; the row state to shared memory
  if (L::kGroups > 1) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < n_rep) red[(group * kMaxRep + r) * D + d_col] = acc[r];
    __syncthreads();
    if (group == 0) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= n_rep) break;
        float s = red[r * D + d_col];
#pragma unroll
        for (int g = 1; g < L::kGroups; ++g)
          s += red[(g * kMaxRep + r) * D + d_col];
        acc[r] = s;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp + kWarps * i;
      if (r < n_rep) {
        m_s[r] = m_row[i];
        l_s[r] = l_row[i];
      }
    }
  }
  __syncthreads();

  T* out_rows = out + q_row0 * D;
  if (n_chunks == 1) {
    // the merge of one chunk: weight expf(0) = 1, so the same bits
    if (group == 0) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= n_rep) break;
        out_rows[r * D + d_col] =
            mlt::from_f32<T>(acc[r] / fmaxf(l_s[r], mlt::kMinDenom));
      }
    }
    return;
  }

  // partial state [slot, kvh][chunk][row] = (acc [D], m, l)
  const int head = slot * Hkv + kvh;
  const int max_chunks = gridDim.x;
  float* mine = part + ((size_t)head * max_chunks + chunk) * n_rep * (D + 2);
  if (group == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < n_rep) mine[r * (D + 2) + d_col] = acc[r];
  }
  if (tid < n_rep) {
    mine[tid * (D + 2) + D] = m_s[tid];
    mine[tid * (D + 2) + D + 1] = l_s[tid];
  }
  __threadfence();  // partials visible device-wide before the count
  __syncthreads();
  if (tid == 0) {
    const int arrived = atomicAdd(counters + head, 1);
    is_last = arrived == n_chunks - 1;
    if (is_last) counters[head] = 0;  // zeroed for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // LSE merge in chunk order; L1 is bypassed (__ldcg) for the partials
  const float* all = part + (size_t)head * max_chunks * n_rep * (D + 2);
  for (int i = tid; i < n_rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float m_all = mlt::kNegInf;
    for (int c = 0; c < n_chunks; ++c)
      m_all = fmaxf(m_all,
                    __ldcg(all + ((size_t)c * n_rep + r) * (D + 2) + D));
    float o = 0.f, l = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float* pc = all + ((size_t)c * n_rep + r) * (D + 2);
      const float w = expf(__ldcg(pc + D) - m_all);
      o = fmaf(w, __ldcg(pc + d), o);
      l = fmaf(w, __ldcg(pc + D + 1), l);
    }
    out_rows[r * D + d] = mlt::from_f32<T>(o / fmaxf(l, mlt::kMinDenom));
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
  float* part;
  int* counters;
  int slots, H, Hkv, page_size, pages_per_slot;
  int max_chunks;  // chunks a (slot, query head) of part holds
  int scratch_page;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D>
int launch(const Args& a) {
  using L = Layout<KV, D>;
  auto kernel = paged_decode_kernel<T, KV, D>;
  cudaError_t err = mlt::allow_smem(kernel, L::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pages_per_chunk = max(1, kChunkKeys / a.page_size);
  const int chunks = (a.pages_per_slot + pages_per_chunk - 1) / pages_per_chunk;
  if (a.max_chunks < chunks) return mlt::kBadArgument;
  dim3 grid(chunks, a.Hkv, a.slots);
  kernel<<<grid, kThreads, L::kSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pages),
      static_cast<const KV*>(a.v_pages), a.k_scale, a.v_scale, a.table, a.pos,
      static_cast<T*>(a.out), a.part, a.counters, a.H, a.Hkv, a.page_size,
      a.pages_per_slot, pages_per_chunk, a.scratch_page, a.scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// KV: the page element type, or void for "same as q"
template <typename KV>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (a.slots <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      a.H / a.Hkv > kMaxRep || a.page_size <= 0 || a.pages_per_slot <= 0 ||
      !aligned16(a.k_pages) ||
      !aligned16(a.v_pages) || a.part == nullptr || a.counters == nullptr)
    return mlt::kBadArgument;
  return mlt::dispatch_dtype_dim(dtype, head_dim, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    using P = std::conditional_t<std::is_void_v<KV>, T, KV>;
    return launch<T, P, decltype(d)::value>(a);
  });
}

}  // namespace

// part: float32 scratch of slots * H * max_chunks * (head_dim + 2) values,
// max_chunks at least ceil(pages_per_slot / max(1, 128 / page_size));
// counters: slots * Hkv int32
// zeros, left zeroed by every launch (launches that share them
// must be ordered on one stream)
extern "C" int mlt_paged_decode(int dtype, int head_dim, const void* q,
                                const void* k_pages, const void* v_pages,
                                const void* page_table, const void* pos,
                                void* out, void* part, void* counters,
                                int slots, int H, int Hkv, int page_size,
                                int pages_per_slot, int max_chunks,
                                int scratch_page, float scale, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(page_table), static_cast<const int*>(pos),
               out, static_cast<float*>(part), static_cast<int*>(counters),
               slots, H, Hkv, page_size, pages_per_slot, max_chunks,
               scratch_page, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<void>(dtype, head_dim, a);
}

// int8 pages with float32 per-vector scales [P+1, page_size, Hkv]
extern "C" int mlt_paged_decode_int8(int dtype, int head_dim, const void* q,
                                     const void* k_pages, const void* v_pages,
                                     const void* k_scale, const void* v_scale,
                                     const void* page_table, const void* pos,
                                     void* out, void* part, void* counters,
                                     int slots, int H, int Hkv, int page_size,
                                     int pages_per_slot, int max_chunks,
                                     int scratch_page, float scale,
                                     void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return mlt::kBadArgument;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table), static_cast<const int*>(pos),
               out, static_cast<float*>(part), static_cast<int*>(counters),
               slots, H, Hkv, page_size, pages_per_slot, max_chunks,
               scratch_page, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<int8_t>(dtype, head_dim, a);
}
