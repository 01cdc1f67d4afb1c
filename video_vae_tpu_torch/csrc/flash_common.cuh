// Helpers shared by flash_attention.cu and flash_attention_bwd.cu: element
// conversions and the staging of (sequence, head) rows of a (B, S, H, D)
// tensor into shared memory as f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// smem row stride of a D-wide f32 row: 16-byte rows, conflict-free float4 by row
template <int D> constexpr int F32_ROW = D + 4;
constexpr float NEG_INF = -1e30f;  // the JAX kernels' masked score

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive elements, 16-byte aligned, as floats.
__device__ __forceinline__ void load8(float (&a)[8], const float* p) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  a[0] = lo.x, a[1] = lo.y, a[2] = lo.z, a[3] = lo.w;
  a[4] = hi.x, a[5] = hi.y, a[6] = hi.z, a[7] = hi.w;
}
__device__ __forceinline__ void load8(float (&a)[8], const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    a[2 * i] = __uint_as_float(w[i] << 16);
    a[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage `rows` (pair, position) rows of a (B, S, H, D) tensor, addressed as
// base + (b * S + i) * stride + h * D + d, as f32 rows of stride F32_ROW. Row r is
// local pair r / S, position r % S; rows of pairs past the end are zero. Each
// thread moves 8 elements at a time, so the base and the stride must keep
// 16-byte alignment (the wrappers check).
template <int D, typename T>
__device__ __forceinline__ void stage_heads(float* dst, const T* __restrict__ src,
                                            long long stride, long long pair0, int rows, int S,
                                            int H, long long n_pairs) {
  for (int e = threadIdx.x; e < rows * (D / 8); e += blockDim.x) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const int local = r / S, i = r - local * S;
    const long long pair = pair0 + local;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (pair < n_pairs) {
      const long long b = pair / H;
      const int h = (int)(pair - b * H);
      load8(a, src + (b * S + i) * stride + h * D + c);
    }
    float4* out = reinterpret_cast<float4*>(dst + r * F32_ROW<D> + c);
    out[0] = make_float4(a[0], a[1], a[2], a[3]);
    out[1] = make_float4(a[4], a[5], a[6], a[7]);
  }
}

}  // namespace
