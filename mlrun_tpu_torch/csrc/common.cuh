// Shared device helpers for the attention kernels of mlrun_tpu_torch.
//
// Every kernel here keeps the reference package's numeric conventions
// (mlrun_tpu/ops/attention.py, mlrun_tpu/ops/paged_attention.py):
//   - masked logits are NEG_INF = -2**30, not -inf, so a fully masked row
//     stays finite;
//   - the softmax denominator is clamped with max(l, 1e-30);
//   - page-table entries < 0 route to the scratch page (the last physical
//     page of the pool).
// Accumulation is float32 whatever the storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mlt {

constexpr float kNegInf = -1073741824.0f;  // -2**30
constexpr float kMinDenom = 1e-30f;

// dtype codes shared with ops/_build.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;  // rms_norm.cu only

// returned for an argument the kernels do not take (the Python wrapper
// checks first; this is the backstop)
constexpr int kBadArgument = -1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// butterfly reductions: every lane ends with the same value, and the order
// of the additions depends only on the lane a value sits in
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 int8 values (one 16-byte load) times their vector's float32 scale,
// stored as float32: one multiply per element, so the result equals the
// plain version's ``q.float() * scale`` bit for bit
__device__ __forceinline__ void dequant16(int4 raw, float scale,
                                          float* dst) {
  const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // sign-extend byte b of the word
      const int v = static_cast<int>(static_cast<unsigned>(words[w])
                                     << (24 - 8 * b)) >> 24;
      dst[4 * w + b] = static_cast<float>(v) * scale;
    }
  }
}

// The 4 int8 values of a 32-bit word as float32, exactly: each biased byte
// (x + 128) becomes the low byte of 2**23's significand, and 2**23 + 128
// comes off again (one PRMT and one FADD a value, no int-to-float
// conversion)
__device__ __forceinline__ void int8x4_to_f32(uint32_t word, float* out) {
  const uint32_t biased = word ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    out[b] = __fsub_rn(
        __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + b)),
        8388736.0f);
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
struct TypeTag {
  using type = T;
};

// fn(TypeTag<T>{}, std::integral_constant<int, D>{}) for the storage type
// (dtype code) and head dim the kernels are instantiated for; anything
// else is refused
template <typename Fn>
int dispatch_dtype_dim(int dtype, int head_dim, Fn&& fn) {
  auto by_dim = [&](auto tag) -> int {
    switch (head_dim) {
      case 32:
        return fn(tag, std::integral_constant<int, 32>{});
      case 64:
        return fn(tag, std::integral_constant<int, 64>{});
      case 128:
        return fn(tag, std::integral_constant<int, 128>{});
      default:
        return kBadArgument;
    }
  };
  if (dtype == kFloat32) return by_dim(TypeTag<float>{});
  if (dtype == kBFloat16) return by_dim(TypeTag<__nv_bfloat16>{});
  return kBadArgument;
}

}  // namespace mlt
