// Flash-attention forward: the serving prefill form over a KV cache and
// the training self-attention form, one tile loop.
//
// Replaces the Pallas kernels mlrun_tpu/ops/attention.py, all bodies of
// _flash_v2_body:
// _flash_fwd_kernel_v2_cached (k_lo = 0, called through
// _flash_fwd_v2_cached / flash_attention_cached),
// _flash_fwd_kernel_v2_bounded (k_lo > 0, _flash_fwd_v2_cached_bounded),
// both through mlt_flash_fwd_cached; and _flash_fwd_kernel_v2 (the
// training forward of flash_attention_mlt, via _flash_fwd_v2: q_offset = 0,
// k_lo = 0, causal or not) through mlt_flash_fwd. The v1 body
// _flash_fwd_kernel (entry point _flash_fwd) computes that same function
// (q and kv from position 0, Sq and Sk free, keys past Sk masked), so
// mlt_flash_fwd replaces it too.
//
// q [B, S, H, D] holds query rows at absolute positions q_offset + i; k/v
// [B, M, Hk, D] is the cache indexed from position 0, with Hk either H
// (kv repeated to the query heads, the reference's signature) or the kv
// head count (head h reads kv head h / (H / Hk), which saves the engine
// and the trainer the repeat copy). Row i attends keys
// k_lo <= k_pos <= q_offset + i, k_pos < M; without the causal flag only
// k_pos < M masks (the Pallas body's kv_len mask).
// Outputs o [B, S, H, D] in q's dtype and lse [B, H, S] float32.
//
// What bounds it on the H100: the logits and the value products, 4*D
// FLOPs per unmasked (query, key) pair. At the serving shapes (S in the
// hundreds, M up to 2048, D 128) the work is far above the card's
// bytes-to-operations line, so it is bound by arithmetic.
//
// Routing by dtype: bf16 goes to the tensor-core kernel of
// flash_fwd_tc.cu (mma.sync tiles, cp.async double buffering); float32
// runs the tile loop below, float32 FMAs from shared memory (the tensor
// cores take no float32 operands at float32 precision). A bf16 launch
// never runs the float32 loop.
//
// Design: grid (B*H, ceil(S/64)); a block owns 64 query rows of one head
// and walks the key tiles of 64 from k_lo/64 up to the causal limit of
// its last row, in ascending order. Tiles are cut at fixed multiples of
// 64 from position 0, so a row visits the same tiles in the same order
// whatever q_offset its chunk arrived under (see attn_tile.cuh). The
// non-causal form walks every key tile. At the training shapes
// (Llama-3.2-1B: S 2048, D 64) the forward is bound by arithmetic too.
#include "attn_tile.cuh"
#include "tensor_core.cuh"

namespace {

using mlt::Tile;
using mlt::TileState;

template <bool kCausal>
struct CausalBoundedMask {
  int q_abs0;  // absolute position of tile row 0
  int k_lo;
  int kv_len;
  __device__ __forceinline__ bool operator()(int row, int k_pos) const {
    return (!kCausal || k_pos <= q_abs0 + row) && k_pos >= k_lo &&
           k_pos < kv_len;
  }
};

// kCausal is a template argument, so the serving (causal) instantiation
// compiles to the same code whatever the training form adds.
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(Tile<D>::kThreads)
    flash_fwd_cached_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse, int S, int M, int H,
                            int Hk, int q_offset, int k_lo, float scale) {
  using C = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + C::kBQ * D;
  float* vs = ks + C::kBK * C::kKStride;
  float* ps = vs + C::kBK * D;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hk);
  const int q0 = blockIdx.y * C::kBQ;
  const int tid = threadIdx.x;

  for (int i = tid; i < C::kBQ * D; i += C::kThreads) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    qs[i] = row < S ? mlt::to_f32(q[((size_t)(b * S + row) * H + h) * D + d]) * scale
                    : 0.f;
  }

  TileState<D> st;
  st.init();
  const int q_last = min(q0 + C::kBQ, S) - 1;
  const int kb_lo = k_lo / C::kBK;
  const int kb_hi =
      (kCausal ? min(q_offset + q_last, M - 1) : M - 1) / C::kBK;
  const CausalBoundedMask<kCausal> mask{q_offset + q0, k_lo, M};

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    __syncthreads();  // previous tile fully consumed (and qs staged)
    const int k_start = kb * C::kBK;
    for (int i = tid; i < C::kBK * D; i += C::kThreads) {
      const int j = i / D, d = i % D;
      const int k_pos = k_start + j;
      float kv = 0.f, vv = 0.f;
      if (k_pos < M) {
        const size_t off = ((size_t)(b * M + k_pos) * Hk + kvh) * D + d;
        kv = mlt::to_f32(k[off]);
        vv = mlt::to_f32(v[off]);
      }
      ks[j * C::kKStride + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();
    mlt::tile_update<D>(qs, ks, vs, ps, st, mask, k_start);
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < C::kRows; ++r) {
    const int row = q0 + warp * C::kRows + r;
    if (row >= S) continue;
    const float l = fmaxf(st.l[r], mlt::kMinDenom);
    const float inv = 1.f / l;
    T* out = o + ((size_t)(b * S + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < C::kDLane; ++i)
      out[lane + 32 * i] = mlt::from_f32<T>(st.acc[r][i] * inv);
    if (lane == 0) lse[(size_t)(b * H + h) * S + row] = st.m[r] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int M, int H, int Hk, int q_offset, int k_lo,
           int causal, float scale, cudaStream_t stream) {
  using C = Tile<D>;
  auto kernel = causal ? flash_fwd_cached_kernel<T, D, true>
                       : flash_fwd_cached_kernel<T, D, false>;
  cudaError_t err = mlt::allow_smem(kernel, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (S + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, M, H, Hk, q_offset, k_lo, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                 void* o, void* lse, int B, int S, int M, int H, int Hk,
                 int q_offset, int k_lo, int causal, float scale,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, S, M, H, Hk, q_offset, k_lo, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, S, M, H, Hk, q_offset, k_lo, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, S, M, H, Hk, q_offset, k_lo, causal, scale, stream);
    default:
      return mlt::kBadArgument;
  }
}

int dispatch(int dtype, int head_dim, const void* q, const void* k,
             const void* v, void* o, void* lse, int B, int S, int M, int H,
             int Hk, int q_offset, int k_lo, int causal, float scale,
             void* stream) {
  if (B <= 0 || S <= 0 || M <= 0 || Hk <= 0 || H % Hk != 0 || k_lo < 0 ||
      q_offset < 0)
    return mlt::kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == mlt::kFloat32)
    return dispatch_dim<float>(head_dim, q, k, v, o, lse, B, S, M, H, Hk,
                               q_offset, k_lo, causal, scale, s);
  if (dtype == mlt::kBFloat16)
    return mlt::flash_fwd_tc(head_dim, q, k, v, o, lse, B, S, M, H, Hk,
                             q_offset, k_lo, causal, scale, s);
  return mlt::kBadArgument;
}

}  // namespace

// serving: causal, q rows at q_offset + i, keys k_lo..
extern "C" int mlt_flash_fwd_cached(int dtype, int head_dim, const void* q,
                                    const void* k, const void* v, void* o,
                                    void* lse, int B, int S, int M, int H,
                                    int Hk, int q_offset, int k_lo,
                                    float scale, void* stream) {
  return dispatch(dtype, head_dim, q, k, v, o, lse, B, S, M, H, Hk, q_offset,
                  k_lo, 1, scale, stream);
}

// training: self-attention from position 0, causal or not (M = kv length)
extern "C" int mlt_flash_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, void* o, void* lse,
                             int B, int S, int M, int H, int Hk, int causal,
                             float scale, void* stream) {
  return dispatch(dtype, head_dim, q, k, v, o, lse, B, S, M, H, Hk, 0, 0,
                  causal ? 1 : 0, scale, stream);
}
