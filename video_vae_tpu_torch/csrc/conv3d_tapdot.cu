// kt = 1 convolution as one tensor-core product per spatial tap: channels-first,
// stride 1, SAME zero padding, bias fused, over one source or the channel concat
// of two sources (never materialised), with an optional 2x2 max-pooled second
// output. bf16 in and out.
//
// Replaces: video_vae_tpu/ops/conv3d.py, _conv3d_tapdot_cf -> _tapdot_kernel.
// For each tap (dh, dw): W[dh, dw] (cin x cout) against the window shifted by
// the tap (pixels x cin), f32 accumulation over taps and channels, + the f32
// bias, one rounding to bf16; the pooled output is the 2x2 max of the f32 sums,
// rounded.
//
// What bounds it on the H100: with cin >= 128 the products are deep enough for
// the tensor cores (2 * cin * cout * kh * kw FLOPs a pixel against (cin + cout)
// * 2 bytes): the 128 -> 128 conv at 128^2 over 32 frames is 0.155 TFLOP
// (0.16 ms at the 989 TFLOP/s bf16 peak) over 0.27 GB (0.08 ms):
// operations-bound.
//
// What the design does about it: an implicit GEMM, M = pixels, N = output
// channels, K = input channels, once per tap. A block owns one frame, an 8 x 32
// pixel tile and 64 output channels; each of its 8 warps owns 2 rows x 16
// columns (two 16-pixel M tiles, so the 2x2 pool stays inside a warp) by the 64
// channels: 8 wmma 16x16x16 accumulators. Per chunk of 16 input channels the
// block stages the halo'd window TRANSPOSED, [row][column][channel] with the 16
// channels of a pixel in one 32-byte line, and the chunk's weights of every
// tap. A tap's A operand is then the same staged window read from a pixel
// offset (row-major, 32-byte aligned whatever the shift; the staging lives in
// conv_window.cuh, shared with the bf16 filter gradient), so no shifted copy is
// ever made: the TPU kernel's halo DMA, lane rolls and VMEM tile search have no
// counterpart here. The epilogue goes through a per-warp f32 tile: bias, one
// rounding, 16-byte stores along the row; the pooled output from the same tile.
// A multi-stage TMA pipeline and wgmma are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "conv_window.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using conv_window::CK;  // input channels per staged chunk: one wmma K step
using conv_window::TH;  // output rows per block
using conv_window::TW;  // output columns per block

constexpr int COT = 64;      // output channels per block
constexpr int W_LD = COT + 8;  // 144-byte weight rows: 16-byte aligned vectors, 32-byte aligned tiles
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE = 2 * 16 * 16;  // a warp's f32 epilogue tile: two 16 x 16 M tiles
constexpr int MAX_K = 7;     // largest kh / kw

__global__ void __launch_bounds__(THREADS)
conv3d_tapdot_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2, int c1, int c2,
                     const bf16* __restrict__ w, const float* __restrict__ bias,
                     bf16* __restrict__ y, bf16* __restrict__ pooled, int Hh, int Ww, int cout,
                     int kh, int kw, int tiles_w, int tiles_hw, int vec_ok) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int IH = TH + kh - 1, IW = TW + kw - 1;
  const int taps = kh * kw;
  bf16* win = reinterpret_cast<bf16*>(smem_raw);           // [IH][IW][CK]
  bf16* w_s = win + IH * IW * CK;                          // [taps][CK][W_LD]
  float* stage = reinterpret_cast<float*>(w_s + taps * CK * W_LD);  // [WARPS][STAGE]

  const int cin = c1 + c2;
  const int frame = blockIdx.y;
  const int tile = blockIdx.x % tiles_hw;
  const int co0 = (blockIdx.x / tiles_hw) * COT;
  const int y0 = (tile / tiles_w) * TH, x0 = (tile % tiles_w) * TW;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rp = warp / 2, ch = warp % 2;  // row pair and column half of the tile
  const size_t plane = (size_t)Hh * Ww;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][COT / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < COT / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int ci0 = 0; ci0 < cin; ci0 += CK) {
    __syncthreads();  // the previous chunk's reads are done
    const conv_window::Window src{x1, x2, c1, c2, frame, ci0, y0, x0, Hh, Ww, kh, kw, vec_ok};
    conv_window::stage_window<THREADS>(win, src, tid);
    // the chunk's weights of every tap: 8 output channels per step
    for (int e = tid; e < taps * CK * (COT / 8); e += THREADS) {
      const int cv = e % (COT / 8), cl = (e / (COT / 8)) % CK, tap = e / ((COT / 8) * CK);
      const int c = ci0 + cl, co = co0 + cv * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < cin && co < cout)
        val = *reinterpret_cast<const uint4*>(w + ((size_t)tap * cin + c) * cout + co);
      *reinterpret_cast<uint4*>(w_s + (tap * CK + cl) * W_LD + cv * 8) = val;
    }
    __syncthreads();

    for (int dh = 0; dh < kh; ++dh) {
      for (int dw = 0; dw < kw; ++dw) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], win + ((2 * rp + i + dh) * IW + 16 * ch + dw) * CK, CK);
        const bf16* wt = w_s + (dh * kw + dw) * CK * W_LD;
#pragma unroll
        for (int j = 0; j < COT / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, wt + j * 16, W_LD);
          wmma::mma_sync(acc[0][j], af[0], bfr, acc[0][j]);
          wmma::mma_sync(acc[1][j], af[1], bfr, acc[1][j]);
        }
      }
    }
  }

  // epilogue: 16 channels at a time through the warp's f32 tile, stored
  // channel-major ([channel][pixel]) so a lane finishes 8 pixels of one channel
  float* st = stage + warp * STAGE;
  const int col = lane / 2, half = lane % 2;
  const int gy0 = y0 + 2 * rp, gx = x0 + 16 * ch + half * 8;
#pragma unroll
  for (int j = 0; j < COT / 16; ++j) {
    wmma::store_matrix_sync(st, acc[0][j], 16, wmma::mem_col_major);
    wmma::store_matrix_sync(st + 256, acc[1][j], 16, wmma::mem_col_major);
    __syncwarp();
    const int co = co0 + j * 16 + col;
    if (co < cout) {
      const float bv = bias[co];
      float s[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 lo = *reinterpret_cast<const float4*>(st + i * 256 + col * 16 + half * 8);
        const float4 hi = *reinterpret_cast<const float4*>(st + i * 256 + col * 16 + half * 8 + 4);
        s[i][0] = lo.x + bv; s[i][1] = lo.y + bv; s[i][2] = lo.z + bv; s[i][3] = lo.w + bv;
        s[i][4] = hi.x + bv; s[i][5] = hi.y + bv; s[i][6] = hi.z + bv; s[i][7] = hi.w + bv;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int gy = gy0 + i;
        if (gy >= Hh || gx >= Ww) continue;
        __align__(16) bf16 out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(s[i][e]);
        bf16* dst = y + ((size_t)frame * cout + co) * plane + (size_t)gy * Ww + gx;
        if (vec_ok && gx + 8 <= Ww) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (gx + e < Ww) dst[e] = out[e];
        }
      }
      if (pooled != nullptr && gy0 + 1 < Hh) {  // Hh and Ww are even here
        const int H2 = Hh / 2, W2 = Ww / 2;
        bf16* dst = pooled + ((size_t)frame * cout + co) * H2 * W2 + (size_t)(gy0 / 2) * W2 + gx / 2;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float m = fmaxf(fmaxf(s[0][2 * q], s[0][2 * q + 1]), fmaxf(s[1][2 * q], s[1][2 * q + 1]));
          if (gx / 2 + q < W2) dst[q] = __float2bfloat16(m);
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// x1: (B*T, c1, H, W) bf16; x2: (B*T, c2, H, W) bf16 or null with c2 = 0; w: (kh, kw,
// c1 + c2, cout) bf16; bias: (cout,) f32; y: (B*T, cout, H, W) bf16; pooled: (B*T, cout,
// H/2, W/2) bf16 or null. c1 + c2 and cout multiples of 8; kh, kw odd, at most 7;
// H and W even when pooled is given. Every pointer 16-byte aligned.
extern "C" int vvt_conv3d_tapdot(const void* x1, const void* x2, int c1, int c2, const void* w,
                                 const void* bias, void* y, void* pooled, int frames, int Hh,
                                 int Ww, int cout, int kh, int kw, void* stream) {
  const int cin = c1 + c2;
  if (frames < 1 || frames > 65535 || Hh < 1 || Ww < 1 || c1 < 1 || c2 < 0 || cout < 8)
    return (int)cudaErrorInvalidValue;
  if (cin % 8 || cout % 8 || (c2 > 0 && x2 == nullptr)) return (int)cudaErrorInvalidValue;
  if (kh < 1 || kh % 2 == 0 || kh > MAX_K || kw < 1 || kw % 2 == 0 || kw > MAX_K)
    return (int)cudaErrorInvalidValue;
  if (pooled != nullptr && (Hh % 2 || Ww % 2)) return (int)cudaErrorInvalidValue;
  const int tiles_w = (Ww + TW - 1) / TW, tiles_h = (Hh + TH - 1) / TH;
  const int tiles_hw = tiles_w * tiles_h;
  const int co_tiles = (cout + COT - 1) / COT;
  const size_t smem = (size_t)(TH + kh - 1) * (TW + kw - 1) * CK * sizeof(bf16) +
                      (size_t)kh * kw * CK * W_LD * sizeof(bf16) +
                      (size_t)WARPS * STAGE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conv3d_tapdot_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(tiles_hw * co_tiles), (unsigned)frames);
  conv3d_tapdot_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x1), static_cast<const bf16*>(x2), c1, c2,
      static_cast<const bf16*>(w), static_cast<const float*>(bias), static_cast<bf16*>(y),
      static_cast<bf16*>(pooled), Hh, Ww, cout, kh, kw, tiles_w, tiles_hw, Ww % 8 == 0 ? 1 : 0);
  return (int)cudaGetLastError();
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
