// Flash-attention backward for training: dq, dk, dv of self-attention from
// the forward's stored o and lse.
//
// Replaces the backward of flash_attention_mlt, mlrun_tpu/ops/attention.py
// _blockwise_bwd (an XLA recompute in einsums on the TPU, not Pallas). It
// computes what that function computes:
//   s     = (q . k) * scale, masked where k_pos >= Sk or (causal) k_pos > q_pos
//   p     = exp(s - lse)
//   delta = sum_d o * dO            (float32, from the STORED o)
//   ds    = p * (dO . v - delta) * scale
//   dq    = ds . k,  dk = ds^T . q,  dv = p^T . dO
// for q/o/dO [B, Sq, H, D] and k/v [B, Sk, Hk, D] in float32 or bf16, lse
// [B, H, Sq] float32, head_dim 32/64/128, Hk | H. Query head h reads kv
// head h / (H / Hk); dk and dv come out at the kv head count, summed over
// each group of H / Hk query heads (the VJP of the reference's
// _repeat_kv), so neither direction makes the repeated copy.
//
// Two kernels on the caller's stream, no atomics, every sum in a fixed
// order, so dq/dk/dv are bit-identical from run to run:
//   1. dq:   grid (B*H, ceil(Sq/64)). A block owns 64 query rows of one
//            head; its prologue computes delta for those rows (and writes
//            it for kernel 2); then it walks the key tiles up to the causal
//            limit and accumulates dq in registers.
//   2. dkdv: grid (B*Hk, ceil(Sk/64)). A block owns 64 keys of one kv
//            head; it walks the group's query heads and, for each, the query
//            tiles from the causal limit on, accumulating dk and dv in
//            registers.
//
// What bounds it on the H100: arithmetic. The reference does 10*D FLOPs per
// unmasked (query, key) pair (s, dO.v, dq, dk, dv); this kernel recomputes
// s and dO.v in both passes (14*D). At Llama-3.2-1B's training shapes
// (B 4, S 2048, H 32, Hk 8, D 64) that is ~0.25 TFLOP per layer, far above
// the card's bytes-to-operations line.
//
// Routing by dtype: bf16 goes to the tensor-core kernels of
// flash_bwd_tc.cu (the same two-kernel structure on mma.sync tiles);
// float32 runs the two kernels below, float32 FMAs from shared memory with
// tiles staged in float32. A bf16 launch never runs them.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

template <int D>
struct BwdTile {
  static constexpr int kB = 64;                  // rows of a query/key tile
  static constexpr int kWarps = D >= 128 ? 8 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = kB / kWarps;      // tile rows per warp
  static constexpr int kDLane = D / 32;          // head-dim columns per lane
  static constexpr int kPad = D + 1;             // padded: conflict-free reads
  // dq: Qs [kB][D] + Gs [kB][D] + Ks [kB][D+1] + Vs [kB][D+1] + dS [kB][kB]
  static constexpr size_t kDqSmemBytes =
      (2 * kB * D + 2 * kB * kPad + kB * kB) * sizeof(float);
  // dkdv: Ks [kB][D] + Vs [kB][D] + Qs [kB][D+1] + Gs [kB][D+1]
  //       + P [kB][kB] + dS [kB][kB] + lse [kB] + delta [kB]
  static constexpr size_t kDkvSmemBytes =
      (2 * kB * D + 2 * kB * kPad + 2 * kB * kB + 2 * kB) * sizeof(float);
};

__device__ __forceinline__ bool live(int q_pos, int k_pos, int Sq, int Sk,
                                     int causal) {
  return q_pos < Sq && k_pos < Sk && (!causal || k_pos <= q_pos);
}

// ---------------------------------------------------------------------------
// kernel 1: dq (and delta)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(BwdTile<D>::kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ g,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        float* __restrict__ delta_out, int Sq, int Sk, int H,
                        int Hk, int causal, float scale) {
  using C = BwdTile<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kB][D], read as row broadcasts
  float* gs = qs + C::kB * D;        // [kB][D]
  float* ks = gs + C::kB * D;        // [kB][D+1], read by lane rows
  float* vs = ks + C::kB * C::kPad;  // [kB][D+1]
  float* dss = vs + C::kB * C::kPad; // [kB][kB]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hk);
  const int q0 = blockIdx.y * C::kB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * C::kRows;

  for (int i = tid; i < C::kB * D; i += C::kThreads) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    float qv = 0.f, gv = 0.f;
    if (row < Sq) {
      const size_t off = ((size_t)(b * Sq + row) * H + h) * D + d;
      qv = mlt::to_f32(q[off]);
      gv = mlt::to_f32(g[off]);
    }
    qs[i] = qv;
    gs[i] = gv;
  }
  __syncthreads();

  float lse_r[C::kRows], delta_r[C::kRows];
#pragma unroll
  for (int r = 0; r < C::kRows; ++r) {
    const int row = q0 + row0 + r;
    float part = 0.f;
    if (row < Sq) {
      const T* o_row = o + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
      for (int i = 0; i < C::kDLane; ++i)
        part = fmaf(mlt::to_f32(o_row[lane + 32 * i]),
                    gs[(row0 + r) * D + lane + 32 * i], part);
    }
    delta_r[r] = mlt::warp_sum(part);
    lse_r[r] = row < Sq ? lse[(size_t)(b * H + h) * Sq + row] : 0.f;
    if (lane == 0 && row < Sq)
      delta_out[(size_t)(b * H + h) * Sq + row] = delta_r[r];
  }

  float acc[C::kRows][C::kDLane];
#pragma unroll
  for (int r = 0; r < C::kRows; ++r)
#pragma unroll
    for (int i = 0; i < C::kDLane; ++i) acc[r][i] = 0.f;

  const int q_last = min(q0 + C::kB, Sq) - 1;
  const int kb_hi = (causal ? min(q_last, Sk - 1) : Sk - 1) / C::kB;
  for (int kb = 0; kb <= kb_hi; ++kb) {
    __syncthreads();  // previous tile consumed
    const int k_start = kb * C::kB;
    for (int i = tid; i < C::kB * D; i += C::kThreads) {
      const int j = i / D, d = i % D;
      const int k_pos = k_start + j;
      float kv = 0.f, vv = 0.f;
      if (k_pos < Sk) {
        const size_t off = ((size_t)(b * Sk + k_pos) * Hk + kvh) * D + d;
        kv = mlt::to_f32(k[off]);
        vv = mlt::to_f32(v[off]);
      }
      ks[j * C::kPad + d] = kv;
      vs[j * C::kPad + d] = vv;
    }
    __syncthreads();

    // s and dO.v for this warp's rows x key columns lane, lane + 32
    float s[C::kRows][2], dp[C::kRows][2];
#pragma unroll
    for (int r = 0; r < C::kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    const float* k_a = ks + lane * C::kPad;
    const float* k_b = ks + (lane + 32) * C::kPad;
    const float* v_a = vs + lane * C::kPad;
    const float* v_b = vs + (lane + 32) * C::kPad;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float ka = k_a[d], kb2 = k_b[d], va = v_a[d], vb = v_b[d];
#pragma unroll
      for (int r = 0; r < C::kRows; ++r) {
        const float qv = qs[(row0 + r) * D + d];
        const float gv = gs[(row0 + r) * D + d];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kb2, s[r][1]);
        dp[r][0] = fmaf(gv, va, dp[r][0]);
        dp[r][1] = fmaf(gv, vb, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < C::kRows; ++r) {
      const int q_pos = q0 + row0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const float p = live(q_pos, k_start + col, Sq, Sk, causal)
                            ? expf(s[r][c] * scale - lse_r[r])
                            : 0.f;
        dss[(row0 + r) * C::kB + col] = p * (dp[r][c] - delta_r[r]) * scale;
      }
    }
    __syncwarp();

    for (int j = 0; j < C::kB; ++j) {
      float kv[C::kDLane];
#pragma unroll
      for (int i = 0; i < C::kDLane; ++i) kv[i] = ks[j * C::kPad + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < C::kRows; ++r) {
        const float ds = dss[(row0 + r) * C::kB + j];
#pragma unroll
        for (int i = 0; i < C::kDLane; ++i) acc[r][i] = fmaf(ds, kv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < C::kRows; ++r) {
    const int row = q0 + row0 + r;
    if (row >= Sq) continue;
    T* out = dq + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < C::kDLane; ++i)
      out[lane + 32 * i] = mlt::from_f32<T>(acc[r][i]);
  }
}

// ---------------------------------------------------------------------------
// kernel 2: dk, dv at the kv head count
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(BwdTile<D>::kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Sq,
                          int Sk, int H, int Hk, int causal, float scale) {
  using C = BwdTile<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [kB][D], read as row broadcasts
  float* vs = ks + C::kB * D;         // [kB][D]
  float* qs = vs + C::kB * D;         // [kB][D+1], read by lane rows
  float* gs = qs + C::kB * C::kPad;   // [kB][D+1]
  float* ps = gs + C::kB * C::kPad;   // [kB keys][kB queries]
  float* dss = ps + C::kB * C::kB;    // [kB keys][kB queries]
  float* lse_s = dss + C::kB * C::kB; // [kB]
  float* delta_s = lse_s + C::kB;     // [kB]

  const int bkv = blockIdx.x;
  const int b = bkv / Hk;
  const int kvh = bkv % Hk;
  const int n_rep = H / Hk;
  const int k0 = blockIdx.y * C::kB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * C::kRows;  // this warp's keys: k0 + row0 + r

  for (int i = tid; i < C::kB * D; i += C::kThreads) {
    const int r = i / D, d = i % D;
    const int k_pos = k0 + r;
    float kv = 0.f, vv = 0.f;
    if (k_pos < Sk) {
      const size_t off = ((size_t)(b * Sk + k_pos) * Hk + kvh) * D + d;
      kv = mlt::to_f32(k[off]);
      vv = mlt::to_f32(v[off]);
    }
    ks[i] = kv;
    vs[i] = vv;
  }

  float acc_k[C::kRows][C::kDLane], acc_v[C::kRows][C::kDLane];
#pragma unroll
  for (int r = 0; r < C::kRows; ++r)
#pragma unroll
    for (int i = 0; i < C::kDLane; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;

  // causal: query tiles that end before this key tile starts see none of it
  const int qb_lo = causal ? k0 / C::kB : 0;
  const int qb_hi = (Sq - 1) / C::kB;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = kvh * n_rep + rep;
    for (int qb = qb_lo; qb <= qb_hi; ++qb) {
      __syncthreads();  // previous tile consumed (and K/V staged)
      const int q_start = qb * C::kB;
      for (int i = tid; i < C::kB * D; i += C::kThreads) {
        const int j = i / D, d = i % D;
        const int q_pos = q_start + j;
        float qv = 0.f, gv = 0.f;
        if (q_pos < Sq) {
          const size_t off = ((size_t)(b * Sq + q_pos) * H + h) * D + d;
          qv = mlt::to_f32(q[off]);
          gv = mlt::to_f32(g[off]);
        }
        qs[j * C::kPad + d] = qv;
        gs[j * C::kPad + d] = gv;
      }
      for (int j = tid; j < C::kB; j += C::kThreads) {
        const int q_pos = q_start + j;
        const size_t off = (size_t)(b * H + h) * Sq + q_pos;
        lse_s[j] = q_pos < Sq ? lse[off] : 0.f;
        delta_s[j] = q_pos < Sq ? delta[off] : 0.f;
      }
      __syncthreads();

      // s^T and (dO.v)^T for this warp's keys x query columns lane, lane+32
      float s[C::kRows][2], dp[C::kRows][2];
#pragma unroll
      for (int r = 0; r < C::kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
      const float* q_a = qs + lane * C::kPad;
      const float* q_b = qs + (lane + 32) * C::kPad;
      const float* g_a = gs + lane * C::kPad;
      const float* g_b = gs + (lane + 32) * C::kPad;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qa = q_a[d], qb2 = q_b[d], ga = g_a[d], gb = g_b[d];
#pragma unroll
        for (int r = 0; r < C::kRows; ++r) {
          const float kv = ks[(row0 + r) * D + d];
          const float vv = vs[(row0 + r) * D + d];
          s[r][0] = fmaf(kv, qa, s[r][0]);
          s[r][1] = fmaf(kv, qb2, s[r][1]);
          dp[r][0] = fmaf(vv, ga, dp[r][0]);
          dp[r][1] = fmaf(vv, gb, dp[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < C::kRows; ++r) {
        const int k_pos = k0 + row0 + r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = lane + 32 * c;
          const float p = live(q_start + col, k_pos, Sq, Sk, causal)
                              ? expf(s[r][c] * scale - lse_s[col])
                              : 0.f;
          ps[(row0 + r) * C::kB + col] = p;
          dss[(row0 + r) * C::kB + col] = p * (dp[r][c] - delta_s[col]) * scale;
        }
      }
      __syncwarp();

      for (int j = 0; j < C::kB; ++j) {
        float qv[C::kDLane], gv[C::kDLane];
#pragma unroll
        for (int i = 0; i < C::kDLane; ++i) {
          qv[i] = qs[j * C::kPad + lane + 32 * i];
          gv[i] = gs[j * C::kPad + lane + 32 * i];
        }
#pragma unroll
        for (int r = 0; r < C::kRows; ++r) {
          const float p = ps[(row0 + r) * C::kB + j];
          const float ds = dss[(row0 + r) * C::kB + j];
#pragma unroll
          for (int i = 0; i < C::kDLane; ++i) {
            acc_v[r][i] = fmaf(p, gv[i], acc_v[r][i]);
            acc_k[r][i] = fmaf(ds, qv[i], acc_k[r][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < C::kRows; ++r) {
    const int k_pos = k0 + row0 + r;
    if (k_pos >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + k_pos) * Hk + kvh) * D;
#pragma unroll
    for (int i = 0; i < C::kDLane; ++i) {
      dk[off + lane + 32 * i] = mlt::from_f32<T>(acc_k[r][i]);
      dv[off + lane + 32 * i] = mlt::from_f32<T>(acc_v[r][i]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int B, int Sq, int Sk, int H, int Hk, int causal,
           float scale, cudaStream_t stream) {
  using C = BwdTile<D>;
  auto dq_kernel = flash_bwd_dq_kernel<T, D>;
  auto dkv_kernel = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = mlt::allow_smem(dq_kernel, C::kDqSmemBytes);
  if (err == cudaSuccess) err = mlt::allow_smem(dkv_kernel, C::kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  const float* lp = static_cast<const float*>(lse);
  float* deltap = static_cast<float*>(delta);
  dim3 grid_q(B * H, (Sq + C::kB - 1) / C::kB);
  dq_kernel<<<grid_q, C::kThreads, C::kDqSmemBytes, stream>>>(
      qp, kp, vp, static_cast<const T*>(o), gp, lp, static_cast<T*>(dq),
      deltap, Sq, Sk, H, Hk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_k(B * Hk, (Sk + C::kB - 1) / C::kB);
  dkv_kernel<<<grid_k, C::kThreads, C::kDkvSmemBytes, stream>>>(
      qp, kp, vp, gp, lp, deltap, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, Hk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                 const void* o, const void* g, const void* lse, void* dq,
                 void* dk, void* dv, void* delta, int B, int Sq, int Sk,
                 int H, int Hk, int causal, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, g, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hk, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, g, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hk, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, g, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hk, causal, scale, stream);
    default:
      return mlt::kBadArgument;
  }
}

}  // namespace

// delta: float32 scratch [B, H, Sq] written by the dq kernel and read by
// the dkdv kernel (the wrapper allocates it).
extern "C" int mlt_flash_bwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* o,
                             const void* g, const void* lse, void* dq,
                             void* dk, void* dv, void* delta, int B, int Sq,
                             int Sk, int H, int Hk, int causal, float scale,
                             void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hk <= 0 || H % Hk != 0)
    return mlt::kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const int c = causal ? 1 : 0;
  if (dtype == mlt::kFloat32)
    return dispatch_dim<float>(head_dim, q, k, v, o, g, lse, dq, dk, dv,
                               delta, B, Sq, Sk, H, Hk, c, scale, s);
  if (dtype == mlt::kBFloat16)
    return mlt::flash_bwd_tc(head_dim, q, k, v, o, g, lse, dq, dk, dv, delta,
                             B, Sq, Sk, H, Hk, c, scale, s);
  return mlt::kBadArgument;
}
