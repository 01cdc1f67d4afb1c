// Direct 3-D convolution, channels-first, stride 1, SAME zero padding, bias fused,
// over one source or the channel concat of two sources (never materialised), with
// an optional 2x2 max-pooled second output.
//
// Replaces: video_vae_tpu/ops/conv3d.py, _conv3d_pallas_cf -> _conv_kernel (the
// UNet's conv3d_cf, conv3d_cf_cat2 and conv3d_cf_pooled, and the input gradient
// of each, which is the same call with the spatially flipped, IO-swapped kernel).
// Activations are (b, t, c, h, w), the kernel is DHWIO (kt, kh, kw, cin, cout) as
// in the JAX params, the bias f32. Taps outside the clip or the frame count as
// zero. Sums in f32 over every tap and input channel (the MXU's
// preferred_element_type=f32), the f32 bias added, one rounding to the input
// dtype; the pooled output is the 2x2 max of the f32 sums + bias, rounded once.
//
// What bounds it on the H100: operations. K = cin*kt*kh*kw is 324..4608 against
// cout 12..512; the flagship's 15 convs at b2 x 16 frames are 0.50 TFLOP (0.55 ms
// at the 989 TFLOP/s bf16 tensor-core peak) over 1.1 GB (0.34 ms at 3.35 TB/s).
// The 256^2 level carries 43 % of the work at cout <= 16, so the design has to
// be good at narrow N.
//
// Which kernel takes a call (ops/conv3d.py:conv_variant, by dtype and shape;
// the entry point's `variant`):
//   - bf16, w % 8 == 0, a kernel of at most 3 x 3 taps a frame and 64 or more
//     output channels (128, or a frame of 64 x 64 or more), kt = 1 or more:
//     where it was measured faster than the mma.sync kernel (PERF.md),
//     the wgmma implicit GEMM fed by TMA of conv3d_wg.cuh
//     (its header has the design): each source copied channels-last so that a
//     pixel shift is an outer TMA coordinate, one input box a temporal tap and
//     channel chunk for every spatial tap, A loaded from the box with ldmatrix
//     at each tap's shift into registers (one fragment feeds the kh output rows
//     it serves), M = output pixels, N = output channels, a producer and two
//     consumer warpgroups, the output staged and stored by TMA.
//   - every other bf16 conv (a narrower one, where a wgmma step's round trip
//     and the copy cost more than the mma.sync kernel's products, or a width a tensor map
//     cannot describe): the mma.sync kernel of conv3d_mma.cuh, as follows.
//   - f32: the CUDA-core kernel below (conv3d_cf_kernel).
//
// The mma.sync kernel: an implicit GEMM on the tensor cores, mma.sync
// m16n8k16 with f32 accumulators: M = output pixels, N = output channels,
// K = 16-channel input chunks, once per (temporal, spatial) tap. A work item is
// one output frame, a th x 32 pixel tile and nb = 8, 16, 32 or 64 output
// channels: the plan (ops/conv3d.py: conv_plan) picks the narrowest block that
// holds cout, 64 at most, with the tallest tile (16, 8 or 4 rows) whose buffers
// fit shared memory. Each of 8 consumer warps owns 2 output rows x 32 columns
// (4 M tiles) by 8, 16 or 32 channels, so its accumulators stay in registers
// for the item's whole K loop; the epilogue writes the bias-added sums, rounded
// once, straight from them, and the 2x2 pool pairs rows inside a warp and
// columns one shuffle apart. A stage is one temporal tap inside the clip x one
// input chunk. Its window is held TRANSPOSED, [row][column][16 channels], so
// every spatial tap's A operand is the same buffer read from a pixel offset
// with ldmatrix (no shifted copy, no im2col); its weights, zero-padded to 16
// input and nb output channels (cin 12 -> 16, cout 12 -> 16), are read with
// ldmatrix.trans; a consumer loads tap i + 1's fragments while it multiplies
// tap i's. The block is warp specialised, as the bf16 filter gradient: 4
// producer warps prepare stage k while the consumers multiply stage k - 1, the
// two handing buffers over on named barriers. The producers copy stage k + 1's
// window as the sources hold it (channel planes, 16-byte pieces) and stage k's
// weights with cp.async, a thread walking one (row, piece) down the channels
// with a pointer step, then transpose stage k's window, copied a stage
// earlier, shared memory to shared memory (byte permutes, 16-byte stores).
// Blocks are persistent (one an SM) and walk their items in turn, so the copies
// run ahead across item boundaries and under the epilogue. Each output is
// summed by one warp of one block in a fixed order: every launch gives the same
// bits; no split-K, no atomics, no rounding before the end.
// What set its pace on the H100 (PERF.md): the staging. With it cut out the
// block ran 1.3-1.55x faster, at about 160 TFLOP/s where N = 16 (one A
// fragment feeds 2 products) and 400 where N = 64, near what mma.sync gives;
// hence the wgmma kernel, whose TMA boxes need no transposing producer and
// whose A fragments feed kh products.
//
// f32 keeps the first version on the CUDA cores (conv3d_cf_kernel below): a
// block owns one output frame, a 16 x 32 pixel tile and 16 output channels;
// each of its 256 threads owns 4 adjacent pixels x 8 channels (32 f32
// accumulators). Per temporal tap and per chunk of 4 input channels the block
// stages the halo'd input tile and the matching weights in shared memory, and
// multiplies in f32 FMAs (8 a shared-memory load). The optional pool comes
// from the f32 sums in the epilogue, one shuffle a value. TF32 would not hold
// the float32 card-vs-CPU gates (1e-4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3d_mma.cuh"
#include "conv3d_wg.cuh"

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

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

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
// variant (ops/conv3d.py:CONV_VARIANTS): 0 = the CUDA-core kernel (float32),
// 1 = the mma.sync kernel, 2 = the wgmma kernel (bfloat16). wn, wgn, blocks:
// variant 1's plan (conv_plan); kc, nb, mtw, stages, blocks, smem: variant 2's
// (conv_wg_plan), with its scratch xt1, xt2 (the channels-last copies) and wt
// (the weights' K-major re-layout). The arguments a variant does not read are
// 0 or null.
extern "C" int vvt_conv3d_cf(const void* x1, const void* x2, int c1, int c2, const void* w,
                             const void* bias, void* y, void* pooled, void* xt1, void* xt2, void* wt,
                             int B, int Tn, int Hh, int Ww, int cout, int kt, int kh, int kw, int dtype,
                             int variant, int wn, int wgn, int blocks, int kc, int nb, int mtw, int stages,
                             int smem, void* stream) {
  if (B < 1 || Tn < 1 || Hh < 1 || Ww < 1 || c1 < 1 || c2 < 0 || cout < 1) return (int)cudaErrorInvalidValue;
  if (kt < 1 || kt % 2 == 0 || kh < 1 || kh % 2 == 0 || kh > MAX_K) return (int)cudaErrorInvalidValue;
  if ((long long)B * Tn > 65535) return (int)cudaErrorInvalidValue;
  if (pooled != nullptr && (Hh % 2 || Ww % 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && variant == 0)
    return (int)dispatch_kw<float>(x1, x2, c1, c2, w, bias, y, pooled, B, Tn, Hh, Ww, cout, kt, kh,
                                   kw, st);
  if (dtype == 1 && variant == 1)
    return (int)conv_mma::launch_conv_mma(x1, x2, c1, c2, w, bias, y, pooled, B, Tn, Hh, Ww, cout,
                                          kt, kh, kw, wn, wgn, blocks, st);
  if (dtype == 1 && variant == 2)
    return (int)conv_wg::launch(static_cast<const __nv_bfloat16*>(x1), static_cast<const __nv_bfloat16*>(x2),
                                static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
                                static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(pooled),
                                static_cast<__nv_bfloat16*>(xt1), static_cast<__nv_bfloat16*>(xt2),
                                static_cast<__nv_bfloat16*>(wt), c1, c2, B, Tn, Hh, Ww, cout, kt, kh, kw, kc,
                                nb, mtw, stages, blocks, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
