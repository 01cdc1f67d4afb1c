// Filter gradient of the stride-1 SAME 3-D convolution, channels-first, over one
// source or the channel concat of two sources (never materialised).
//
// Replaces: video_vae_tpu/ops/conv3d.py, _conv3d_wgrad_pallas_cf -> _wgrad_kernel (the
// filter gradient of conv3d_cf and conv3d_cf_cat2 in _cf_grads). It computes
//   dW[dt, dh, dw, ci, co] = sum_{b,t,y,x} x[b, t+dt-kt/2, ci, y+dh-kh/2, x+dw-kw/2] * g[b, t, co, y, x]
// with taps outside the clip or the frame counting zero, channel ci read from
// x2 where ci >= c1. Activations and g are (b, t, c, h, w) in f32 or bf16; the
// sum and the output (kt, kh, kw, c1 + c2, cout) are f32.
//
// What bounds it on the H100: it is the forward conv's work again, an implicit
// GEMM with K = kt*kh*kw*cin (324..3456) rows by cout (12..128) columns, summed
// over b*t*h*w pixels (2.1 M at the UNet's top level): ~0.53 TFLOP over the
// train step's 15 convs at b2 x 16 frames, ~0.5 ms at the bf16 tensor-core
// rate, against ~0.1 GB of inputs. This first version multiplies on the CUDA
// cores in f32 (67 TFLOP/s), which is its real limit.
//
// What the design does about it: the TPU kernel carries its sum in one output
// block across a sequential grid; a GPU grid has no order. So a block owns one
// tile of the output, 128 rows of K by 16 output channels, and a contiguous
// range of 32-pixel row segments: the grid's second axis splits the pixel
// reduction, each block writes an f32 partial of its tile to a workspace, and a
// second kernel sums the partials in a fixed order (no atomics: the same bits
// on every run). Per segment the block gathers the im2col slice (128 K rows x 32
// pixels, zero outside the clip and frame; global reads run along the pixels)
// and the matching g slice into shared memory; each of its 128 threads owns
// 4 K rows x 4 channels and reads one float4 of each per pixel (16 FMAs per two
// shared loads). Both slices are XOR-swizzled by pixel so that the float4
// stores of the gather and the float4 loads of the product are free of bank
// conflicts. Tensor cores (mma/wgmma) and reuse of the gathered rows across
// the kw taps come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TK = 128;    // K rows per output tile
constexpr int TC = 16;     // output channels per output tile
constexpr int NP = 32;     // pixels per row segment
constexpr int THREADS = 128;
constexpr int MAX_K = 7;   // largest kh / kw
constexpr int OUT_OF_RANGE = 1 << 28;  // tap offset of a K row past the end

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ g, float* __restrict__ partials, int c1, int c2,
                     int Tn, int Hh, int Ww, int cout, int kt, int kh, int kw, int co_tiles,
                     long long segments, int splits) {
  __shared__ float4 a_s[NP * TK / 4];  // [pixel][K row], float4 chunks swizzled by pixel
  __shared__ float4 b_s[NP * TC / 4];  // [pixel][channel], likewise
  __shared__ int k_dt[TK], k_dh[TK], k_dw[TK], k_ci[TK];

  const int cin = c1 + c2;
  const int K = kt * kh * kw * cin;
  const int k0 = (blockIdx.x / co_tiles) * TK;
  const int co0 = (blockIdx.x % co_tiles) * TC;
  const int tid = threadIdx.x;
  for (int kk = tid; kk < TK; kk += THREADS) {
    const int k = k0 + kk;
    if (k < K) {
      const int tap = k / cin;
      k_ci[kk] = k % cin;
      k_dw[kk] = tap % kw - kw / 2;
      k_dh[kk] = (tap / kw) % kh - kh / 2;
      k_dt[kk] = tap / (kw * kh) - kt / 2;
    } else {
      k_ci[kk] = 0;
      k_dw[kk] = k_dh[kk] = k_dt[kk] = OUT_OF_RANGE;
    }
  }

  const int xsegs = (Ww + NP - 1) / NP;
  const long long s_begin = segments * blockIdx.y / splits;
  const long long s_end = segments * (blockIdx.y + 1) / splits;
  const size_t plane = (size_t)Hh * Ww;

  // product role: 4 K rows (chunk kg) x 4 channels (chunk cg)
  const int kg = tid % 32, cg = tid / 32;
  // gather role: pixel p, K chunks kc + 4j, channel chunk kc
  const int p = tid % NP, kc = tid / NP;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long seg = s_begin; seg < s_end; ++seg) {
    const int x0 = (int)(seg % xsegs) * NP;
    long long r = seg / xsegs;
    const int y = (int)(r % Hh);
    r /= Hh;
    const int t = (int)(r % Tn);
    const long long b = r / Tn;
    const int xx = x0 + p;

    __syncthreads();  // the previous segment's product is done
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      const int chunk = kc + 4 * j;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 4 * chunk + e;
        const int tt = t + k_dt[kk], yy = y + k_dh[kk], xs = xx + k_dw[kk];
        float val = 0.f;
        if (tt >= 0 && tt < Tn && yy >= 0 && yy < Hh && xs >= 0 && xs < Ww) {
          const int ci = k_ci[kk];
          const T* src = ci < c1 ? x1 + ((size_t)(b * Tn + tt) * c1 + ci) * plane
                                 : x2 + ((size_t)(b * Tn + tt) * c2 + (ci - c1)) * plane;
          val = to_float(src[(size_t)yy * Ww + xs]);
        }
        v[e] = val;
      }
      a_s[p * (TK / 4) + (chunk ^ (p & 7))] = make_float4(v[0], v[1], v[2], v[3]);
    }
    {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + 4 * kc + e;
        float val = 0.f;
        if (co < cout && xx < Ww)
          val = to_float(g[((size_t)(b * Tn + t) * cout + co) * plane + (size_t)y * Ww + xx]);
        v[e] = val;
      }
      b_s[p * (TC / 4) + (kc ^ (p & 3))] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

#pragma unroll 8
    for (int q = 0; q < NP; ++q) {
      const float4 a = a_s[q * (TK / 4) + (kg ^ (q & 7))];
      const float4 bq = b_s[q * (TC / 4) + (cg ^ (q & 3))];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* out = partials + (size_t)blockIdx.y * K * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * kg + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + 4 * cg + j;
      if (co < cout) out[(size_t)k * cout + co] = acc[i][j];
    }
  }
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ partials, float* __restrict__ dw,
                                    long long n, int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += partials[(size_t)z * n + e];
  dw[e] = sum;
}

template <typename T>
cudaError_t launch(const void* x1, const void* x2, const void* g, void* partials, void* dw, int c1,
                   int c2, int B, int Tn, int Hh, int Ww, int cout, int kt, int kh, int kw,
                   int splits, cudaStream_t stream) {
  const int K = kt * kh * kw * (c1 + c2);
  const int k_tiles = (K + TK - 1) / TK, co_tiles = (cout + TC - 1) / TC;
  const long long segments = (long long)B * Tn * Hh * ((Ww + NP - 1) / NP);
  if (splits < 1 || splits > 65535 || splits > segments) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(k_tiles * co_tiles), (unsigned)splits);
  wgrad_partial_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), static_cast<const T*>(g),
      static_cast<float*>(partials), c1, c2, Tn, Hh, Ww, cout, kt, kh, kw, co_tiles, segments,
      splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)K * cout;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(dw), n, splits);
  return cudaGetLastError();
}

}  // namespace

// x2 may be null with c2 = 0. dtype: 0 = float32, 1 = bfloat16 (x1, x2, g).
// partials: f32 scratch of splits * K * cout; dw: f32 (kt, kh, kw, c1 + c2, cout).
extern "C" int vvt_conv3d_wgrad(const void* x1, const void* x2, const void* g, void* partials,
                                void* dw, int c1, int c2, int B, int Tn, int Hh, int Ww, int cout,
                                int kt, int kh, int kw, int splits, int dtype, void* stream) {
  if (B < 1 || Tn < 1 || Hh < 1 || Ww < 1 || c1 < 1 || c2 < 0 || cout < 1) return (int)cudaErrorInvalidValue;
  if (kt < 1 || kt % 2 == 0 || kh < 1 || kh % 2 == 0 || kh > MAX_K || kw < 1 || kw % 2 == 0 ||
      kw > MAX_K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x1, x2, g, partials, dw, c1, c2, B, Tn, Hh, Ww, cout, kt, kh, kw,
                              splits, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x1, x2, g, partials, dw, c1, c2, B, Tn, Hh, Ww, cout, kt,
                                      kh, kw, splits, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
