// Fused AdamW over a list of leaves: the optimizer of training/train.py
// (AdamW.update: clip_by_global_norm, then adamw) as two multi-tensor
// kernels, each one launch over up to kMaxLeaves leaves.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses optax's update chain
// (mlrun_tpu/training/train.py make_optimizer) by itself. The plain version
// is AdamW's per-leaf loop of PyTorch ops (training/train.py), about 25
// elementwise passes a leaf over device memory.
//
// What bounds it on the H100: bytes. An element costs about 20 float32
// operations against 16 bytes in bf16: the norm reads g (2), the update
// reads g, p, mu and nu (8) and writes p, mu and nu (6), each once. That is
// 16 bytes a weight over 3.35 TB/s, far below the card's ~295 FLOP per byte.
//
// Design:
//   - The leaves' pointers, sizes and dtype codes travel by value in the
//     kernel's arguments (__grid_constant__, under the 4 KB parameter
//     space), never through a device table: the host never copies or waits.
//   - A leaf is cut into tiles of kTile elements; one persistent grid walks
//     the tiles of every leaf of the launch in order (grid stride). A
//     thread takes 8 consecutive elements of a tile with 16-byte loads
//     (8 bf16 or 2 x 4 float32) where the leaf's pointers are 16-byte
//     aligned and the tile is whole, else element by element.
//   - mlt_grad_sqnorm: each block adds its tiles' squares (8 at a time in
//     float32, then in float64) and reduces them in a fixed order into one
//     float64 partial; a last one-block pass adds the partials in a fixed
//     order and writes, as float32, [sum of squares, g_norm, divisor,
//     factor] (the clip's scale: g_norm and max_norm where g_norm >=
//     max_norm, else 1 and 1). The result is the same run to run.
//   - mlt_adamw repeats the plain loop's float32 arithmetic in its order,
//     each step rounded on its own (__f*_rn: no FMA contraction): g / divisor
//     * factor where clipped, the moments, rounded to their stored dtype
//     before the bias correction, the bias correction as a product with the
//     float32 reciprocal (PyTorch divides a tensor by a Python scalar so),
//     sqrt, + eps, the division, the decay, p + update * -lr. The host casts
//     every constant to float32 as the plain loop's scalar operands are cast.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                  // elements a thread takes a tile
constexpr int kTile = kThreads * kVec;   // elements a tile
constexpr int kMaxLeaves = 64;           // leaves a launch
constexpr int kAligned = 4;              // kind bit: all pointers 16-byte aligned

struct NormList {
  const void* g[kMaxLeaves];
  long long numel[kMaxLeaves];
  long long tile_end[kMaxLeaves];  // tiles of leaves 0..i
  int kind[kMaxLeaves];            // grad dtype code | kAligned
  int n;
};

struct AdamWList {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* mu[kMaxLeaves];
  void* nu[kMaxLeaves];
  long long numel[kMaxLeaves];
  long long tile_end[kMaxLeaves];
  int kind[kMaxLeaves];  // param dtype code | grad dtype code << 1 | kAligned
  int n;
};

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2;
  float inv_bc1, inv_bc2, eps, weight_decay, neg_lr;
  int decay;
  const float* scale;  // [divisor, factor] on the device; null: no clip
};

static_assert(sizeof(AdamWList) + sizeof(Hyper) <= 4096,
              "kernel arguments above the 4 KB parameter space");
static_assert(sizeof(NormList) + sizeof(double*) <= 4096,
              "kernel arguments above the 4 KB parameter space");

template <typename T>
__device__ __forceinline__ void load_vec(const T* src, T (&out)[kVec]) {
#pragma unroll
  for (int w = 0; w < kVec * static_cast<int>(sizeof(T)) / 16; ++w)
    reinterpret_cast<uint4*>(out)[w] =
        __ldcs(reinterpret_cast<const uint4*>(src) + w);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const T (&in)[kVec]) {
#pragma unroll
  for (int w = 0; w < kVec * static_cast<int>(sizeof(T)) / 16; ++w)
    __stcs(reinterpret_cast<uint4*>(dst) + w,
           reinterpret_cast<const uint4*>(in)[w]);
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum, in a fixed order, on thread 0
__device__ __forceinline__ double block_sum_f64(double v) {
  __shared__ double warp[kWarps];
  v = warp_sum_f64(v);
  if ((threadIdx.x & 31) == 0) warp[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp[w];
  }
  return total;
}

// the sum of squares of this thread's 8 elements of a tile
template <typename G>
__device__ __forceinline__ float tile_squares(const G* g, long long left,
                                              bool aligned) {
  const int i0 = threadIdx.x * kVec;
  float sq[kVec];
  if (aligned && left >= kTile) {
    alignas(16) G gv[kVec];
    load_vec(g + i0, gv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float x = mlt::to_f32(gv[j]);
      sq[j] = x * x;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float x = i0 + j < left ? mlt::to_f32(g[i0 + j]) : 0.f;
      sq[j] = x * x;
    }
  }
#pragma unroll
  for (int w = kVec / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) sq[j] += sq[j + w];
  }
  return sq[0];
}

__global__ void __launch_bounds__(kThreads)
    grad_sqnorm_kernel(const __grid_constant__ NormList list,
                       double* __restrict__ partials) {
  double acc = 0.0;
  const long long total = list.tile_end[list.n - 1];
  int leaf = 0;
  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    while (tile >= list.tile_end[leaf]) ++leaf;
    const long long first = leaf == 0 ? 0 : list.tile_end[leaf - 1];
    const long long start = (tile - first) * kTile;
    const long long left = list.numel[leaf] - start;
    const int kind = list.kind[leaf];
    const bool aligned = kind & kAligned;
    if ((kind & 1) == mlt::kBFloat16)
      acc += tile_squares(
          static_cast<const __nv_bfloat16*>(list.g[leaf]) + start, left,
          aligned);
    else
      acc += tile_squares(static_cast<const float*>(list.g[leaf]) + start,
                          left, aligned);
  }
  const double sum = block_sum_f64(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

__global__ void __launch_bounds__(kThreads)
    grad_norm_finish_kernel(const double* __restrict__ partials, int n,
                            float* __restrict__ out, int finish,
                            float max_norm) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  const double sum = block_sum_f64(acc);
  if (threadIdx.x == 0) {
    const float sumsq = __double2float_rn(sum);
    out[0] = sumsq;
    if (finish) {
      const float norm = __fsqrt_rn(sumsq);
      const bool clip = norm >= max_norm;
      out[1] = norm;
      out[2] = clip ? norm : 1.f;
      out[3] = clip ? max_norm : 1.f;
    }
  }
}

// one element of the update, in the plain loop's order and roundings
template <typename T>
__device__ __forceinline__ void adamw_step(float g, T& p, T& m, T& v,
                                           const Hyper& h, bool clip,
                                           float divisor, float factor) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, divisor), factor);
  m = mlt::from_f32<T>(__fadd_rn(__fmul_rn(g, h.one_minus_b1),
                                 __fmul_rn(mlt::to_f32(m), h.b1)));
  v = mlt::from_f32<T>(__fadd_rn(__fmul_rn(__fmul_rn(g, g), h.one_minus_b2),
                                 __fmul_rn(mlt::to_f32(v), h.b2)));
  const float m_hat = __fmul_rn(mlt::to_f32(m), h.inv_bc1);
  const float v_hat = __fmul_rn(mlt::to_f32(v), h.inv_bc2);
  float update = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), h.eps));
  const float p32 = mlt::to_f32(p);
  if (h.decay) update = __fadd_rn(update, __fmul_rn(p32, h.weight_decay));
  p = mlt::from_f32<T>(__fadd_rn(p32, __fmul_rn(update, h.neg_lr)));
}

template <typename T, typename G>
__device__ __forceinline__ void adamw_tile(T* p, const G* g, T* mu, T* nu,
                                           long long left, bool aligned,
                                           const Hyper& h, bool clip,
                                           float divisor, float factor) {
  const int i0 = threadIdx.x * kVec;
  if (aligned && left >= kTile) {
    alignas(16) T pv[kVec], mv[kVec], vv[kVec];
    alignas(16) G gv[kVec];
    load_vec(g + i0, gv);
    load_vec(p + i0, pv);
    load_vec(mu + i0, mv);
    load_vec(nu + i0, vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      adamw_step(mlt::to_f32(gv[j]), pv[j], mv[j], vv[j], h, clip, divisor,
                 factor);
    store_vec(p + i0, pv);
    store_vec(mu + i0, mv);
    store_vec(nu + i0, vv);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = i0 + j;
      if (i < left) {
        T pj = p[i], mj = mu[i], vj = nu[i];
        adamw_step(mlt::to_f32(g[i]), pj, mj, vj, h, clip, divisor, factor);
        p[i] = pj;
        mu[i] = mj;
        nu[i] = vj;
      }
    }
  }
}

template <typename T, typename G>
__device__ __forceinline__ void adamw_leaf_tile(const AdamWList& list,
                                                int leaf, long long start,
                                                long long left, bool aligned,
                                                const Hyper& h, bool clip,
                                                float divisor, float factor) {
  adamw_tile(static_cast<T*>(list.p[leaf]) + start,
             static_cast<const G*>(list.g[leaf]) + start,
             static_cast<T*>(list.mu[leaf]) + start,
             static_cast<T*>(list.nu[leaf]) + start, left, aligned, h, clip,
             divisor, factor);
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ AdamWList list,
                 const __grid_constant__ Hyper h) {
  const bool clip = h.scale != nullptr;
  const float divisor = clip ? h.scale[0] : 1.f;
  const float factor = clip ? h.scale[1] : 1.f;
  const long long total = list.tile_end[list.n - 1];
  int leaf = 0;
  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    while (tile >= list.tile_end[leaf]) ++leaf;
    const long long first = leaf == 0 ? 0 : list.tile_end[leaf - 1];
    const long long start = (tile - first) * kTile;
    const long long left = list.numel[leaf] - start;
    const int kind = list.kind[leaf];
    const bool aligned = kind & kAligned;
    using bf16 = __nv_bfloat16;
    switch (kind & 3) {
      case 0:
        adamw_leaf_tile<float, float>(list, leaf, start, left, aligned, h,
                                      clip, divisor, factor);
        break;
      case 1:
        adamw_leaf_tile<bf16, float>(list, leaf, start, left, aligned, h,
                                     clip, divisor, factor);
        break;
      case 2:
        adamw_leaf_tile<float, bf16>(list, leaf, start, left, aligned, h,
                                     clip, divisor, factor);
        break;
      default:
        adamw_leaf_tile<bf16, bf16>(list, leaf, start, left, aligned, h,
                                    clip, divisor, factor);
        break;
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

bool known_dtype(int code) {
  return code == mlt::kFloat32 || code == mlt::kBFloat16;
}

long long tiles(long long numel) { return (numel + kTile - 1) / kTile; }

// the grid of a launch: every block the card holds at once
template <typename Kernel>
int grid_cap(Kernel kernel) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return sms * (per_sm > 0 ? per_sm : 1);
}

// a launch's grid could not be sized: the CUDA error, else a refusal
int no_grid() {
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : mlt::kBadArgument;
}

int launches(int n) { return (n + kMaxLeaves - 1) / kMaxLeaves; }

}  // namespace

// float64 partials that mlt_grad_sqnorm needs for n leaves (0 on an error)
extern "C" int mlt_grad_sqnorm_scratch(int n) {
  return n > 0 ? launches(n) * grid_cap(grad_sqnorm_kernel) : 0;
}

// out[0] = sum over the leaves of g**2 (float32); with finish also out[1] =
// its sqrt (g_norm) and out[2], out[3] = the clip's divisor and factor
extern "C" int mlt_grad_sqnorm(int n, const void* const* g,
                               const long long* numel, const int* dtype,
                               void* partials, int capacity, void* out,
                               int finish, float max_norm, void* stream) {
  if (n <= 0) return mlt::kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const int cap = grid_cap(grad_sqnorm_kernel);
  if (cap <= 0) return no_grid();
  auto* part = static_cast<double*>(partials);
  int used = 0;
  for (int lo = 0; lo < n;) {
    NormList list{};
    long long total = 0;
    for (; lo < n && list.n < kMaxLeaves; ++lo) {
      if (!known_dtype(dtype[lo]) || numel[lo] < 0) return mlt::kBadArgument;
      if (numel[lo] == 0) continue;
      const int i = list.n++;
      list.g[i] = g[lo];
      list.numel[i] = numel[lo];
      total += tiles(numel[lo]);
      list.tile_end[i] = total;
      list.kind[i] = dtype[lo] | (aligned16(g[lo]) ? kAligned : 0);
    }
    if (list.n == 0) continue;
    const int grid = static_cast<int>(total < cap ? total : cap);
    if (used + grid > capacity) return mlt::kBadArgument;
    grad_sqnorm_kernel<<<grid, kThreads, 0, s>>>(list, part + used);
    used += grid;
  }
  grad_norm_finish_kernel<<<1, kThreads, 0, s>>>(
      part, used, static_cast<float*>(out), finish, max_norm);
  return static_cast<int>(cudaGetLastError());
}

// one AdamW update of every leaf in place; scale: [divisor, factor] on the
// device, or null for no clip
extern "C" int mlt_adamw(int n, const void* const* p, const void* const* g,
                         const void* const* mu, const void* const* nu,
                         const long long* numel, const int* p_dtype,
                         const int* g_dtype, const void* scale, float b1,
                         float one_minus_b1, float b2, float one_minus_b2,
                         float inv_bc1, float inv_bc2, float eps,
                         float weight_decay, int decay, float neg_lr,
                         void* stream) {
  if (n <= 0) return mlt::kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const int cap = grid_cap(adamw_kernel);
  if (cap <= 0) return no_grid();
  Hyper h{b1,      one_minus_b1, b2,           one_minus_b2, inv_bc1,
          inv_bc2, eps,          weight_decay, neg_lr,       decay,
          static_cast<const float*>(scale)};
  for (int lo = 0; lo < n;) {
    AdamWList list{};
    long long total = 0;
    for (; lo < n && list.n < kMaxLeaves; ++lo) {
      if (!known_dtype(p_dtype[lo]) || !known_dtype(g_dtype[lo]) ||
          numel[lo] < 0)
        return mlt::kBadArgument;
      if (numel[lo] == 0) continue;
      const int i = list.n++;
      list.p[i] = const_cast<void*>(p[lo]);
      list.g[i] = g[lo];
      list.mu[i] = const_cast<void*>(mu[lo]);
      list.nu[i] = const_cast<void*>(nu[lo]);
      list.numel[i] = numel[lo];
      total += tiles(numel[lo]);
      list.tile_end[i] = total;
      const bool aligned = aligned16(p[lo]) && aligned16(g[lo]) &&
                           aligned16(mu[lo]) && aligned16(nu[lo]);
      list.kind[i] =
          p_dtype[lo] | (g_dtype[lo] << 1) | (aligned ? kAligned : 0);
    }
    if (list.n == 0) continue;
    const int grid = static_cast<int>(total < cap ? total : cap);
    adamw_kernel<<<grid, kThreads, 0, s>>>(list, h);
  }
  return static_cast<int>(cudaGetLastError());
}
