// The halo'd input window of one conv tile, staged TRANSPOSED in shared memory:
// [row][column][channel], the CK = 16 channels of a pixel in one 32-byte line.
// Used by PR 6's bf16 wmma filter gradient (conv3d_wgrad.cu), which serves
// only the frames a tensor map cannot describe (w % 8 != 0); every other bf16
// filter gradient runs the wgmma kernel of conv3d_wgrad_wg.cuh, fed by TMA.
//
// A tile is TH x TW output pixels of one frame; its window is (TH + kh - 1) x
// (TW + kw - 1) pixels of one 16-channel chunk, zero outside the frame and past
// the last channel, with channel c read from x2 where c >= c1 (the concat of
// the two sources is never built). A tap (dh, dw) of the tile is then the same
// window read from the pixel offset (dh, dw): 16 consecutive pixels x 16
// channels is one 512-byte run at a 32-byte aligned address, whatever the shift,
// which is what a wmma 16x16x16 bf16 fragment needs (row-major pixels x
// channels, or col-major channels x pixels, ldm CK).
//
// The staging is split into items so that a kernel can hold them in registers
// between a load and a store: the interior items, 8 pixels of one channel and
// row (one 16-byte load where the row allows it), and the kw - 1 halo columns,
// one element each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace conv_window {

using bf16 = __nv_bfloat16;

constexpr int TH = 8;   // output rows per tile
constexpr int TW = 32;  // output columns per tile
constexpr int CK = 16;  // channels per staged chunk: one wmma K (or M) step

// Where a tile's window comes from.
struct Window {
  const bf16* x1;  // (frames, c1, Hh, Ww)
  const bf16* x2;  // (frames, c2, Hh, Ww) or null with c2 = 0
  int c1, c2;
  long long frame;  // the frame's index into both sources
  int ci0, y0, x0;  // first channel of the chunk, the tile's top-left output pixel
  int Hh, Ww, kh, kw;
  int vec_ok;  // Ww % 8 == 0 and 16-byte aligned sources: 16-byte loads
};

__host__ __device__ __forceinline__ int window_rows(int kh) { return TH + kh - 1; }
__host__ __device__ __forceinline__ int window_cols(int kw) { return TW + kw - 1; }
__host__ __device__ __forceinline__ int interior_items(int kh) { return CK * window_rows(kh) * (TW / 8); }
__host__ __device__ __forceinline__ int halo_items(int kh, int kw) { return CK * window_rows(kh) * (kw - 1); }

__device__ __forceinline__ const bf16* channel_plane(const Window& s, int c) {
  const size_t plane = (size_t)s.Hh * s.Ww;
  return c < s.c1 ? s.x1 + ((size_t)s.frame * s.c1 + c) * plane
                  : s.x2 + ((size_t)s.frame * s.c2 + (c - s.c1)) * plane;
}

// Interior item e: 8 pixels of one channel and window row, consecutive items on
// consecutive channels (one 32-byte line of the window per 16 items).
__device__ __forceinline__ uint4 load_interior(const Window& s, int e) {
  const int cl = e % CK, v = (e / CK) % (TW / 8), wr = e / (CK * (TW / 8));
  const int c = s.ci0 + cl, gy = s.y0 + wr - s.kh / 2, gx = s.x0 + v * 8;
  __align__(16) bf16 vals[8];
  const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int j = 0; j < 8; ++j) vals[j] = zero;
  if (c < s.c1 + s.c2 && gy >= 0 && gy < s.Hh && gx < s.Ww) {
    const bf16* src = channel_plane(s, c) + (size_t)gy * s.Ww + gx;
    if (s.vec_ok && gx + 8 <= s.Ww) {
      *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (gx + j < s.Ww) vals[j] = src[j];
    }
  }
  return *reinterpret_cast<const uint4*>(vals);
}

__device__ __forceinline__ void store_interior(bf16* win, const Window& s, int e, uint4 v) {
  const int cl = e % CK, vv = (e / CK) % (TW / 8), wr = e / (CK * (TW / 8));
  bf16* dst = win + ((size_t)(wr * window_cols(s.kw) + s.kw / 2 + vv * 8)) * CK + cl;
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j * CK] = __ushort_as_bfloat16((unsigned short)(words[j / 2] >> (16 * (j % 2))));
}

// Halo item e: one element of the kw - 1 columns left and right of the interior.
__device__ __forceinline__ bf16 load_halo(const Window& s, int e) {
  const int hw = s.kw - 1, pw = s.kw / 2;
  const int cl = e % CK, hc = (e / CK) % hw, wr = e / (CK * hw);
  const int wc = hc < pw ? hc : TW + hc;  // left of the interior, or right of it
  const int c = s.ci0 + cl, gy = s.y0 + wr - s.kh / 2, gx = s.x0 + wc - pw;
  bf16 val = __float2bfloat16(0.f);
  if (c < s.c1 + s.c2 && gy >= 0 && gy < s.Hh && gx >= 0 && gx < s.Ww)
    val = channel_plane(s, c)[(size_t)gy * s.Ww + gx];
  return val;
}

__device__ __forceinline__ void store_halo(bf16* win, const Window& s, int e, bf16 val) {
  const int hw = s.kw - 1, pw = s.kw / 2;
  const int cl = e % CK, hc = (e / CK) % hw, wr = e / (CK * hw);
  const int wc = hc < pw ? hc : TW + hc;
  win[((size_t)(wr * window_cols(s.kw) + wc)) * CK + cl] = val;
}

// The whole window, each thread of the block loading and storing its items in turn.
template <int THREADS>
__device__ __forceinline__ void stage_window(bf16* win, const Window& s, int tid) {
  for (int e = tid; e < interior_items(s.kh); e += THREADS) store_interior(win, s, e, load_interior(s, e));
  for (int e = tid; e < halo_items(s.kh, s.kw); e += THREADS) store_halo(win, s, e, load_halo(s, e));
}

}  // namespace conv_window
