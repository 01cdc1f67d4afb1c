// Device code of the first, CUDA-core version of the fused QK-norm + RoPE +
// attention forward: the f32 path of fused_attention.cu (whose bf16 path is the
// tensor-core kernel of fused_attention_mma.cuh) and the attention of
// attention_sublayer.cu for f32 x (the same attention between the sublayer's
// two projections). One thread owns one query row, f32 throughout;
// the kernel design notes are in fused_attention.cu.
// launch_fused_attention<T, D>() enqueues the kernel for head dim D on a stream
// and returns the launch's cudaError_t; at D = 128 it enqueues the quad kernel
// of attention_f32_wide.cuh instead (a row per thread would take 256 registers),
// and so it does past S = 256 at every D (a block here holds its sequences'
// rows whole, a thread a query row).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_f32_wide.cuh"

namespace {

// smem row stride of a D-wide f32 row: 16-byte rows, conflict-free float4 by row
template <int D> constexpr int CORE_ROW = D + 4;
constexpr int MAX_ROWS = 256;  // query rows (= threads) per block; a longer sequence takes the quad kernel
constexpr int CHUNK = 16;      // keys per online-softmax step
constexpr float NEG_INF = -1e30f;  // the JAX kernels' masked score
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// LayerNorm (no bias) then rotate-half RoPE of one D-row held in registers; its
// statistics over the true head dim d <= D (inv_d = 1/d: a padded row's zeros
// add nothing to the sums).
template <int D>
__device__ __forceinline__ void norm_rope(float (&x)[D], const float* __restrict__ scale,
                                          const float* __restrict__ cos_row,
                                          const float* __restrict__ sin_row, float inv_d) {
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    s += x[d];
    sq += x[d] * x[d];
  }
  const float mean = s * inv_d;
  const float var = fmaxf(sq * inv_d - mean * mean, 0.f);
  const float r = rsqrtf(var + LN_EPS);
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = (x[d] - mean) * r * scale[d];
#pragma unroll
  for (int d = 0; d < D / 2; ++d) {
    const float a = x[d], b = x[d + D / 2];
    x[d] = a * cos_row[d] - b * sin_row[d];
    x[d + D / 2] = b * cos_row[d + D / 2] + a * sin_row[d + D / 2];
  }
}

template <int D>
__device__ __forceinline__ void load_row(float (&x)[D], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 v = s4[d4];
    x[4 * d4] = v.x;
    x[4 * d4 + 1] = v.y;
    x[4 * d4 + 2] = v.z;
    x[4 * d4 + 3] = v.w;
  }
}

// Stage one of q (part 0), k (1) or v (2) of every row of the block as f32.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ qkv, int part, int pair0,
                                      int rows, int S, int H, int n_pairs) {
  const int HD = H * D;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const int pair = pair0 + r / S;
    float v = 0.f;
    if (pair < n_pairs) {
      const int b = pair / H, h = pair % H, i = r % S;
      v = to_float(qkv[((size_t)b * S + i) * 3 * HD + part * HD + h * D + d]);
    }
    dst[r * CORE_ROW<D> + d] = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(MAX_ROWS)
fused_attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ q_scale,
                           const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                           const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                           T* __restrict__ out, int B, int S, int H, int pairs_per_block,
                           float scale, float inv_d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int ROW = CORE_ROW<D>;
  const int rows = pairs_per_block * S;  // row r: local pair r / S, position r % S
  float* buf_a = smem;                   // q, then v
  float* buf_b = smem + rows * ROW;      // k
  float* keep = buf_b + rows * ROW;      // 1: key kept, 0: key masked
  const int n_pairs = B * H;
  const int pair0 = blockIdx.x * pairs_per_block;
  const int r = threadIdx.x;
  const bool active = r < rows && pair0 + r / S < n_pairs;
  const int i = r % S;

  stage<D>(buf_a, qkv, 0, pair0, rows, S, H, n_pairs);
  stage<D>(buf_b, qkv, 1, pair0, rows, S, H, n_pairs);
  for (int rr = threadIdx.x; rr < rows; rr += blockDim.x) {
    const int pair = pair0 + rr / S;
    float kp = 1.f;
    if (mask != nullptr && pair < n_pairs) kp = mask[(size_t)(pair / H) * S + rr % S] ? 1.f : 0.f;
    keep[rr] = kp;
  }
  __syncthreads();

  float q[D];
  if (active) {
    float k[D];
    load_row(k, buf_b + r * ROW);
    norm_rope(k, k_scale, cos_t + (size_t)i * D, sin_t + (size_t)i * D, inv_d);
    float4* dst = reinterpret_cast<float4*>(buf_b + r * ROW);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4)
      dst[d4] = make_float4(k[4 * d4], k[4 * d4 + 1], k[4 * d4 + 2], k[4 * d4 + 3]);
    load_row(q, buf_a + r * ROW);
    norm_rope(q, q_scale, cos_t + (size_t)i * D, sin_t + (size_t)i * D, inv_d);
  }
  __syncthreads();  // q is in registers: buf_a takes v
  stage<D>(buf_a, qkv, 2, pair0, rows, S, H, n_pairs);
  __syncthreads();
  if (!active) return;

  const int g = r / S;
  const float* kb = buf_b + g * S * ROW;
  const float* vb = buf_a + g * S * ROW;
  const float* kp = keep + g * S;
  float m = -INFINITY, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int j0 = 0; j0 < S; j0 += CHUNK) {
    float s[CHUNK];
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int j = j0 + c;
      float v = -INFINITY;
      if (j < S) {
        const float4* kr = reinterpret_cast<const float4*>(kb + j * ROW);
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kk = kr[d4];
          p0 = fmaf(q[4 * d4], kk.x, p0);
          p1 = fmaf(q[4 * d4 + 1], kk.y, p1);
          p2 = fmaf(q[4 * d4 + 2], kk.z, p2);
          p3 = fmaf(q[4 * d4 + 3], kk.w, p3);
        }
        v = ((p0 + p1) + (p2 + p3)) * scale;
        if (kp[j] == 0.f) v = NEG_INF;
      }
      s[c] = v;
      cmax = fmaxf(cmax, v);
    }
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);  // 0 on the first chunk (m = -inf)
    m = m_new;
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int j = j0 + c;
      if (j < S) {
        const float p = expf(s[c] - m);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vb + j * ROW);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
    }
  }

  const int pair = pair0 + g;
  const int b = pair / H, h = pair % H;
  const float inv = 1.f / l;
  T* o = out + ((size_t)b * S + i) * H * D + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = from_float<T>(acc[d] * inv);
}

// At D = 128, and past S = MAX_ROWS at every D, the quad kernel of
// attention_f32_wide.cuh (f32 only). scale, inv_d: 1/sqrt(d) and 1/d of the true
// head dim d <= D.
template <typename T, int D>
cudaError_t launch_fused_attention(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                   const void* sin_t, const void* mask, void* out, int B, int S, int H, float scale,
                   float inv_d, cudaStream_t stream) {
  static_assert(sizeof(T) == 4, "the CUDA-core attention takes f32");
  if (D == 128 || S > MAX_ROWS) {
    const long long HD = (long long)H * D, token = 3 * HD;
    const float* x = static_cast<const float*>(qkv);
    const fa_wide::Rows q{x, S * token, D, token}, k{x + HD, S * token, D, token}, v{x + 2 * HD, S * token, D, token};
    return fa_wide::launch_fwd<D>(true, q, k, v, static_cast<const unsigned char*>(mask),
                                  fa_wide::OutRows{static_cast<float*>(out), S * HD, D, HD}, B, S, H,
                                  static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
                                  static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), scale, inv_d,
                                  stream);
  }
  if constexpr (D < 128) {
  const int pairs_per_block = MAX_ROWS / S;
  const int rows = pairs_per_block * S;
  const int threads = (rows + 31) / 32 * 32;
  const size_t smem = (2 * (size_t)rows * CORE_ROW<D> + rows) * sizeof(float);
  auto kernel = fused_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_pairs = (long long)B * H;
  const unsigned blocks = (unsigned)((n_pairs + pairs_per_block - 1) / pairs_per_block);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const unsigned char*>(mask),
      static_cast<T*>(out), B, S, H, pairs_per_block, scale, inv_d);
  return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // D = 128 took the quad kernel above
  }
}

}  // namespace
