// Direct 3-D convolution, channels-first, stride 1, SAME zero padding, bias fused,
// over one source or the channel concat of two sources (never materialised).
//
// Replaces: video_vae_tpu/ops/conv3d.py, _conv3d_pallas_cf -> _conv_kernel (the
// UNet's conv3d_cf and conv3d_cf_cat2). Activations are (b, t, c, h, w), the
// kernel is DHWIO (kt, kh, kw, cin, cout) as in the JAX params, the bias f32.
// f32 accumulation, bias added in f32, one rounding to the input dtype.
//
// What bounds it on the H100: the UNet's convs are compute bound (K = cin*kt*kh*kw
// is 324..3456 against cout 12..128): the flagship's 15 convs are ~0.49 TFLOP
// at b2 x 16 frames, ~0.5 ms at the 989 TFLOP/s bf16 tensor-core rate, while the
// largest moves ~0.13 GB (~40 us). This first version multiplies on the CUDA
// cores in f32 (67 TFLOP/s), which is its real limit.
//
// What the design does about it: an implicit GEMM with the halo in shared
// memory. A block owns one output frame, a 16 x 32 pixel tile and 16 output
// channels; each of its 256 threads owns 4 adjacent pixels x 8 channels (32
// f32 accumulators). Per temporal tap and per chunk of 4 input channels the
// block stages the halo'd input tile (4 x (16+kh-1) x (32+kw-1)) and the
// matching weights (kh*kw x 4 x 16) in shared memory; each input row segment
// a thread loads is reused across the kw taps, and the weights are read as
// broadcast float4s, so there are 8 FMAs per shared-memory load. The input
// row stride is padded to 1 mod 4 words, which makes a warp's loads (4 rows x
// 8 column groups) hit 32 distinct banks. A second source is read where the
// input channel is >= c1. Temporal taps that fall outside the clip are
// skipped (zero padding). Tensor cores (wgmma) and TMA come later.
//
// The optional second output (the TPU kernel's pool=True) is the 2x2 spatial
// max pool of the f32 sums + bias, rounded once: a thread's 4 pixels pair up
// along the row, and the row below belongs to the lane 8 further on in the same
// warp, so one shuffle per value finishes the pool in the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;     // output rows per block
constexpr int TW = 32;     // output columns per block
constexpr int PX = 4;      // output columns per thread
constexpr int COT = 16;    // output channels per block
constexpr int CO_T = 8;    // output channels per thread
constexpr int CI = 4;      // input channels staged per step
constexpr int PIX_GROUPS = TH * TW / PX;             // 128
constexpr int THREADS = PIX_GROUPS * (COT / CO_T);   // 256
constexpr int MAX_K = 7;   // largest kh / kw

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int in_width(int kw) { return TW + kw - 1; }
// smallest stride >= the tile width that is 1 mod 4 (bank-conflict-free rows)
__host__ __device__ constexpr int in_stride(int kw) {
  return in_width(kw) + ((1 - in_width(kw)) % 4 + 4) % 4;
}

template <typename T, int KW, bool POOL>
__global__ void __launch_bounds__(THREADS)
conv3d_cf_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int c1, int c2,
                 const T* __restrict__ w, const float* __restrict__ bias, T* __restrict__ y,
                 T* __restrict__ pooled, int Tn, int Hh, int Ww, int cout, int kt, int kh,
                 int tiles_w, int tiles_hw) {
  constexpr int IW = in_width(KW);
  constexpr int IWP = in_stride(KW);
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [kh*KW][CI][COT]
  float* in_s = w_s + kh * KW * CI * COT;         // [CI][IH][IWP]
  const int IH = TH + kh - 1;

  const int cin = c1 + c2;
  const int frame = blockIdx.y;  // b * Tn + t
  const int b = frame / Tn, t = frame % Tn;
  const int tile = blockIdx.x % tiles_hw;
  const int co0 = (blockIdx.x / tiles_hw) * COT;
  const int y0 = (tile / tiles_w) * TH, x0 = (tile % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int cog = tid / PIX_GROUPS;             // which 8 of the 16 channels
  const int pr = (tid % PIX_GROUPS) / (TW / PX);  // output row in the tile
  const int pc = (tid % PIX_GROUPS) % (TW / PX);  // column group in the tile
  const size_t plane = (size_t)Hh * Ww;

  float acc[PX][CO_T];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int o = 0; o < CO_T; ++o) acc[p][o] = 0.f;

  for (int dt = 0; dt < kt; ++dt) {
    const int tt = t + dt - kt / 2;
    if (tt < 0 || tt >= Tn) continue;  // uniform over the block
    for (int ci0 = 0; ci0 < cin; ci0 += CI) {
      __syncthreads();  // the previous step's reads are done
      for (int e = tid; e < CI * IH * IW; e += THREADS) {
        const int cl = e / (IH * IW), rem = e % (IH * IW);
        const int ry = rem / IW, rx = rem % IW;
        const int c = ci0 + cl;
        const int gy = y0 + ry - kh / 2, gx = x0 + rx - KW / 2;
        float v = 0.f;
        if (c < cin && gy >= 0 && gy < Hh && gx >= 0 && gx < Ww) {
          const T* src = c < c1 ? x1 + ((size_t)(b * Tn + tt) * c1 + c) * plane
                                : x2 + ((size_t)(b * Tn + tt) * c2 + (c - c1)) * plane;
          v = to_float(src[(size_t)gy * Ww + gx]);
        }
        in_s[(cl * IH + ry) * IWP + rx] = v;
      }
      for (int e = tid; e < kh * KW * CI * COT; e += THREADS) {
        const int col = e % COT, cl = (e / COT) % CI, tap = e / (COT * CI);
        const int c = ci0 + cl, co = co0 + col;
        float v = 0.f;
        if (c < cin && co < cout) v = to_float(w[(((size_t)dt * kh * KW + tap) * cin + c) * cout + co]);
        w_s[e] = v;
      }
      __syncthreads();
#pragma unroll
      for (int cl = 0; cl < CI; ++cl) {
        for (int dh = 0; dh < kh; ++dh) {
          const float* row = in_s + (cl * IH + pr + dh) * IWP + pc * PX;
          float xin[PX + KW - 1];
#pragma unroll
          for (int j = 0; j < PX + KW - 1; ++j) xin[j] = row[j];
#pragma unroll
          for (int dw = 0; dw < KW; ++dw) {
            const float4* wr =
                reinterpret_cast<const float4*>(w_s + ((dh * KW + dw) * CI + cl) * COT + cog * CO_T);
            const float4 wa = wr[0], wb = wr[1];
            const float wv[CO_T] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int p = 0; p < PX; ++p)
#pragma unroll
              for (int o = 0; o < CO_T; ++o) acc[p][o] = fmaf(xin[p + dw], wv[o], acc[p][o]);
          }
        }
      }
    }
  }

  const int gy = y0 + pr;
  if constexpr (POOL) {  // Hh and Ww are even here
    const int H2 = Hh / 2, W2 = Ww / 2;
    const int px = (x0 + pc * PX) / 2;
#pragma unroll
    for (int o = 0; o < CO_T; ++o) {
      const int co = co0 + cog * CO_T + o;
      const float bv = co < cout ? bias[co] : 0.f;
#pragma unroll
      for (int q = 0; q < PX / 2; ++q) {
        const float m = fmaxf(acc[2 * q][o], acc[2 * q + 1][o]);
        // rows pr and pr + 1 sit 8 lanes apart (TW / PX column groups a row)
        const float both = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, TW / PX));
        if (pr % 2 == 0 && co < cout && gy + 1 < Hh && px + q < W2)
          pooled[((size_t)(b * Tn + t) * cout + co) * H2 * W2 + (size_t)(gy / 2) * W2 + px + q] =
              from_float<T>(both + bv);
      }
    }
  }
  if (gy >= Hh) return;
#pragma unroll
  for (int o = 0; o < CO_T; ++o) {
    const int co = co0 + cog * CO_T + o;
    if (co >= cout) continue;
    const float bv = bias[co];
    T* dst = y + ((size_t)(b * Tn + t) * cout + co) * plane + (size_t)gy * Ww;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int gx = x0 + pc * PX + p;
      if (gx < Ww) dst[gx] = from_float<T>(acc[p][o] + bv);
    }
  }
}

template <typename T, int KW>
cudaError_t launch(const void* x1, const void* x2, int c1, int c2, const void* w,
                   const void* bias, void* y, void* pooled, int B, int Tn, int Hh, int Ww,
                   int cout, int kt, int kh, cudaStream_t stream) {
  const int tiles_w = (Ww + TW - 1) / TW, tiles_h = (Hh + TH - 1) / TH;
  const int tiles_hw = tiles_w * tiles_h;
  const int co_tiles = (cout + COT - 1) / COT;
  const size_t smem =
      ((size_t)kh * KW * CI * COT + (size_t)CI * (TH + kh - 1) * in_stride(KW)) * sizeof(float);
  // the pooled epilogue is its own instantiation, so the plain one pays nothing for it
  auto kernel = pooled != nullptr ? conv3d_cf_kernel<T, KW, true> : conv3d_cf_kernel<T, KW, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(tiles_hw * co_tiles), (unsigned)(B * Tn));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), c1, c2, static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), static_cast<T*>(pooled), Tn, Hh, Ww,
      cout, kt, kh, tiles_w, tiles_hw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_kw(const void* x1, const void* x2, int c1, int c2, const void* w,
                        const void* bias, void* y, void* pooled, int B, int Tn, int Hh, int Ww,
                        int cout, int kt, int kh, int kw, cudaStream_t stream) {
#define VVT_CONV_ARGS x1, x2, c1, c2, w, bias, y, pooled, B, Tn, Hh, Ww, cout, kt, kh, stream
  switch (kw) {
    case 1: return launch<T, 1>(VVT_CONV_ARGS);
    case 3: return launch<T, 3>(VVT_CONV_ARGS);
    case 5: return launch<T, 5>(VVT_CONV_ARGS);
    case 7: return launch<T, 7>(VVT_CONV_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef VVT_CONV_ARGS
}

}  // namespace

// x2 may be null with c2 = 0. dtype: 0 = float32, 1 = bfloat16 (x1, x2, w, y, pooled).
// pooled: (B, Tn, cout, Hh/2, Ww/2) or null; Hh and Ww must be even when it is given.
extern "C" int vvt_conv3d_cf(const void* x1, const void* x2, int c1, int c2, const void* w,
                             const void* bias, void* y, void* pooled, int B, int Tn, int Hh,
                             int Ww, int cout, int kt, int kh, int kw, int dtype, void* stream) {
  if (B < 1 || Tn < 1 || Hh < 1 || Ww < 1 || c1 < 1 || c2 < 0 || cout < 1) return (int)cudaErrorInvalidValue;
  if (kt < 1 || kt % 2 == 0 || kh < 1 || kh % 2 == 0 || kh > MAX_K) return (int)cudaErrorInvalidValue;
  if ((long long)B * Tn > 65535) return (int)cudaErrorInvalidValue;
  if (pooled != nullptr && (Hh % 2 || Ww % 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_kw<float>(x1, x2, c1, c2, w, bias, y, pooled, B, Tn, Hh, Ww, cout, kt, kh,
                                   kw, st);
  if (dtype == 1)
    return (int)dispatch_kw<__nv_bfloat16>(x1, x2, c1, c2, w, bias, y, pooled, B, Tn, Hh, Ww, cout,
                                           kt, kh, kw, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
