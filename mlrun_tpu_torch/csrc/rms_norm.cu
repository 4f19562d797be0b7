// RMSNorm over the last dimension: one row reduction per row.
//
// Replaces the Pallas kernel mlrun_tpu/ops/norms.py _rms_norm_kernel,
// called through rms_norm_pallas: x [rows, F] in float32, bfloat16 or
// float16, scale [F] in float32 or x's dtype; per row the float32 mean of
// squares (a sum divided by F, as the reference's jnp.mean), one
// rsqrt(var + eps), the product with the float32 scale, the cast back to
// x's dtype. out [rows, F] in x's dtype. The Pallas grid's blocks of
// block_rows rows become one CUDA block per row: the result does not
// depend on the block size, so any row count and any F run.
//
// What bounds it on the H100: bytes. Each element is read once (plus one
// re-read from cache for the output pass) and written once for about
// four float32 operations, far below the card's ~295 FLOP per byte line;
// the bound is 2 * rows * F * sizeof(x) + F * sizeof(scale) bytes over
// 3.35 TB/s.
//
// Design: 256 threads a row. A row is walked as a scalar head up to the
// first 16-byte boundary, a body of 16-byte vector loads (4 float32 or 8
// 16-bit values each) and a scalar tail, so every F and every row offset
// runs (a row of 4100 bfloat16 values starts 8 bytes off the boundary
// every other row). Each thread sums its squares in float32; the block
// reduces them with warp butterflies and one pass over the warps' partial
// sums in shared memory, in a fixed order. The second pass reads the row
// again (from L1/L2), scales it and stores it through the same
// head/body/tail split; a row whose output sits at another 16-byte phase
// than its input takes the scalar path for its stores.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Split {
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte load
  int head;    // scalar elements before the first 16-byte boundary
  int n_vec;   // 16-byte vectors after them
  int tail;    // first element of the scalar tail

  __device__ __forceinline__ Split(const T* row, int F) {
    const unsigned mis =
        static_cast<unsigned>(reinterpret_cast<uintptr_t>(row) & 15u);
    head = mis == 0 ? 0 : static_cast<int>((16u - mis) / sizeof(T));
    head = min(head, F);
    n_vec = (F - head) / kVec;
    tail = head + n_vec * kVec;
  }
};

template <typename T, typename TS>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                    T* __restrict__ out, int F, float eps) {
  constexpr int kVec = Split<T>::kVec;
  __shared__ float partial[kWarps];
  __shared__ float inv_rms;

  const size_t row = blockIdx.x;
  const T* xr = x + row * F;
  T* orow = out + row * F;
  const int tid = threadIdx.x;
  const Split<T> sp(xr, F);

  float sum = 0.f;
  for (int i = tid; i < sp.head; i += kThreads) {
    const float v = mlt::to_f32(xr[i]);
    sum = fmaf(v, v, sum);
  }
  const uint4* xv = reinterpret_cast<const uint4*>(xr + sp.head);
  for (int i = tid; i < sp.n_vec; i += kThreads) {
    const uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float v = mlt::to_f32(e[j]);
      sum = fmaf(v, v, sum);
    }
  }
  for (int i = sp.tail + tid; i < F; i += kThreads) {
    const float v = mlt::to_f32(xr[i]);
    sum = fmaf(v, v, sum);
  }

  sum = mlt::warp_sum(sum);
  if ((tid & 31) == 0) partial[tid >> 5] = sum;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partial[w];
    // the mean as a true division by F (not a multiply by a rounded 1/F)
    inv_rms = rsqrtf(total / static_cast<float>(F) + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  auto norm = [&](T v, int col) {
    return mlt::from_f32<T>((mlt::to_f32(v) * inv) * mlt::to_f32(scale[col]));
  };
  const bool same_phase =
      ((reinterpret_cast<uintptr_t>(xr) ^ reinterpret_cast<uintptr_t>(orow)) &
       15u) == 0;
  if (same_phase) {
    for (int i = tid; i < sp.head; i += kThreads) orow[i] = norm(xr[i], i);
    uint4* ov = reinterpret_cast<uint4*>(orow + sp.head);
    for (int i = tid; i < sp.n_vec; i += kThreads) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
      const int col0 = sp.head + i * kVec;
#pragma unroll
      for (int j = 0; j < kVec; ++j) r[j] = norm(e[j], col0 + j);
      ov[i] = res;
    }
    for (int i = sp.tail + tid; i < F; i += kThreads) orow[i] = norm(xr[i], i);
  } else {
    for (int i = tid; i < F; i += kThreads) orow[i] = norm(xr[i], i);
  }
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* out, int rows, int F,
           float eps, cudaStream_t stream) {
  rms_norm_kernel<T, TS><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(out), F, eps);
  return static_cast<int>(cudaGetLastError());
}

// scale in float32 or in x's own dtype
template <typename T>
int dispatch_scale(int scale_dtype, int dtype, const void* x,
                   const void* scale, void* out, int rows, int F, float eps,
                   cudaStream_t stream) {
  if (scale_dtype == mlt::kFloat32)
    return launch<T, float>(x, scale, out, rows, F, eps, stream);
  if (scale_dtype == dtype)
    return launch<T, T>(x, scale, out, rows, F, eps, stream);
  return mlt::kBadArgument;
}

}  // namespace

extern "C" int mlt_rms_norm(int dtype, int scale_dtype, const void* x,
                            const void* scale, void* out, int rows,
                            int features, float eps, void* stream) {
  if (rows <= 0 || features <= 0) return mlt::kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mlt::kFloat32:
      return dispatch_scale<float>(scale_dtype, dtype, x, scale, out, rows,
                                   features, eps, s);
    case mlt::kBFloat16:
      return dispatch_scale<__nv_bfloat16>(scale_dtype, dtype, x, scale, out,
                                           rows, features, eps, s);
    case mlt::kFloat16:
      return dispatch_scale<__half>(scale_dtype, dtype, x, scale, out, rows,
                                    features, eps, s);
    default:
      return mlt::kBadArgument;
  }
}
