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
// What bounds it on the H100: operations. It is the forward conv's work again,
// an implicit GEMM with M = kt*kh*kw*cin rows (324..4608) by N = cout (12..512)
// columns, summed over b*t*h*w pixels (2.1 M at the UNet's top level): 0.53
// TFLOP over the 15 convs of the default b1 x 16-frame train step (its UNet
// runs 2 rollouts), 0.55 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// ~0.1 GB of inputs; 2.3 TFLOP and 2.37 ms on the kt = 1, base-64 tap-dot model.
//
// Which kernel takes a call (ops/conv3d.py:wgrad_variant, by dtype and width
// alone; the entry point's `variant`):
//   - bf16, w % 8 == 0 (every conv of every train path): the wgmma implicit
//     GEMM fed by TMA of conv3d_wgrad_wg.cuh (its header has the design): g
//     copied channels-last so that a tap's shift is an outer TMA coordinate,
//     M = output channels (up to four taps' 16-channel bands stacked in a
//     64-row M-tile), N = input channels, K = pixels, one producer and two
//     consumer warpgroups, split-K partials summed in a fixed order.
//   - bf16 at a width a tensor map cannot describe (w % 8 != 0: the row
//     stride is not a multiple of 16 bytes): PR 6's wmma kernel below (the
//     `tc` namespace), as follows.
//   - f32: the CUDA-core kernel below (wgrad_partial_kernel).
//
// PR 6's wmma kernel: a tensor-core implicit GEMM, wmma 16x16x16 bf16 with
// f32 accumulators, M = the 16 input channels of a chunk, N = output
// channels, K = pixels. A block owns one 16-channel chunk, one temporal tap
// dt and up to 64 output channels (nj 16-wide fragments), and walks a range
// of 8 x 32-pixel tiles of the frames whose tap dt lands inside the clip. Per
// tile it stages the halo'd window of frame t + dt - kt/2 TRANSPOSED,
// [row][column][16 channels] (conv_window.cuh), so every spatial tap's A
// operand (channels x 16 pixels, col-major, ldm 16) is the same buffer read
// from a pixel offset: each input element is read from memory once per tile,
// not once per tap. g is staged as [channel][pixel], B col-major along the
// pixels. The block is warp specialised: 4 producer warps stage tile k (g
// with cp.async, the window with every load in flight before its transposed
// stores) into one of two buffers while 8 consumer warps multiply tile k - 1
// from the other, handing the buffers over on named barriers. The kh*kw*nj
// accumulator fragments are dealt out to the consumer warps (at most 7 a
// warp, in registers, the count a template parameter so that a warp issues
// all its A loads before its products); a warp's fragments share one
// output-channel block, so one B load serves them all. Where there are fewer
// fragments than 8 warps can hold, the warps also split the tile's rows into
// row_groups, each with its own partial. No atomics: each (split, row group)
// writes an f32 partial of its fragments into a padded workspace, and a
// second kernel sums the partials in a fixed order, so every run gives the
// same bits. wmma is issued as mma.sync and ran at 85-96 TFLOP/s at most on
// the H100 (PERF.md), which is why the widths TMA can describe moved to the
// wgmma kernel.
//
// f32 inputs keep the first version on the CUDA cores (wgrad_partial_kernel):
// a tile of 128 K rows x 16 output channels, the im2col slice of a 32-pixel row
// segment gathered into shared memory, 4 x 4 f32 FMAs a thread per pixel, the
// partials of the pixel splits summed by the same fixed-order pass. TF32 would
// not hold the f32 train step to its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "conv3d_wgrad_wg.cuh"
#include "conv_window.cuh"

namespace {

constexpr int TK = 128;    // K rows per output tile
constexpr int TC = 16;     // output channels per output tile
constexpr int NP = 32;     // pixels per row segment
constexpr int THREADS = 128;
constexpr int MAX_K = 7;   // largest kh / kw
constexpr int OUT_OF_RANGE = 1 << 28;  // tap offset of a K row past the end

__device__ __forceinline__ float to_float(float x) { return x; }

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

// ---- bf16: tensor-core implicit GEMM -------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using conv_window::CK;
using conv_window::TH;
using conv_window::TW;

constexpr int CONSUMER_WARPS = 8;   // the products
constexpr int PRODUCER_WARPS = 4;   // the staging
constexpr int CONSUMERS = 32 * CONSUMER_WARPS, PRODUCERS = 32 * PRODUCER_WARPS;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int MAXF = 7;             // accumulator fragments a warp holds: 7 x 8 registers
constexpr int MAX_NJ = 4;           // 16-wide output-channel fragments a block owns: 64 channels
constexpr int G_LD = TH * TW + 8;   // a staged g row: the tile's 256 pixels, 528 bytes
// a producer thread's share of one window: interior items (16-byte vectors) and halo elements
constexpr int NV = (CK * (TH + MAX_K - 1) * (TW / 8) + PRODUCERS - 1) / PRODUCERS;
constexpr int NH = (CK * (TH + MAX_K - 1) * (MAX_K - 1) + PRODUCERS - 1) / PRODUCERS;
// named barriers (0 is __syncthreads): buffer b is full, buffer b is free again
constexpr int FULL = 1, EMPTY = 3;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// g of one tile as [channel][pixel]: 8 pixels of one channel and row per item,
// zero past the frame and past cout. With vec_ok a cp.async each (a masked one
// copies zeros); otherwise element loads.
__device__ __forceinline__ void stage_g(bf16* gs, const bf16* __restrict__ g, long long frame, int co0,
                                        int cob, int cout, int y0, int x0, int Hh, int Ww, int vec_ok,
                                        int ptid) {
  const size_t plane = (size_t)Hh * Ww;
  for (int e = ptid; e < cob * TH * (TW / 8); e += PRODUCERS) {
    const int v = e % (TW / 8), r = (e / (TW / 8)) % TH, col = e / (TH * (TW / 8));
    const int co = co0 + col, gy = y0 + r, gx = x0 + v * 8;
    const bool inside = co < cout && gy < Hh && gx < Ww;
    const bf16* src = g + ((size_t)frame * cout + co) * plane + (size_t)gy * Ww + gx;
    bf16* dst = gs + col * G_LD + r * TW + v * 8;
    if (vec_ok) {  // Ww % 8 == 0: a vector is all inside the row or all outside
      cp_async16(dst, inside ? src : g, inside ? 16 : 0);
    } else {
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = (inside && gx + j < Ww) ? src[j] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
    }
  }
}

// grid: (chunks * co_tiles * kt, splits). Block: one 16-channel input chunk, nj
// output-channel fragments, one dt, the split's share of the pixel tiles of the
// frames whose tap dt lands inside the clip. Producer warps stage tile k into
// buffer k % 2 while the consumer warps multiply tile k - 1 from the other.
// Consumer warp w: row group w / L of the tile's rows (every row_groups-th
// row), fragments f = wl, wl + L, ... (NF of them, tap-major, f = tap * nj +
// j) of the block's kh*kw*nj, with L = 8 / row_groups, wl = w % L and
// L % nj == 0, so a warp's fragments share one output-channel block j = wl %
// nj and one B operand. A warp with fewer than NF fragments multiplies tap 0
// into the rest and stores only its own.
template <int NF>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_mma_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2, const bf16* __restrict__ g,
                 float* __restrict__ partials, int c1, int c2, int B, int Tn, int Hh, int Ww,
                 int cout, int kt, int kh, int kw, int nj, int row_groups, int chunks, int co_tiles,
                 int tiles_w, int tiles_hw, int cin_pad, int cout_pad, int vec_ok) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int IW = conv_window::window_cols(kw);
  const int win_bytes = (conv_window::window_rows(kh) * IW * CK * 2 + 127) / 128 * 128;
  const int cob = 16 * nj;
  bf16* wins = reinterpret_cast<bf16*>(smem_raw);                      // [2][IH][IW][CK]
  bf16* g_bufs = reinterpret_cast<bf16*>(smem_raw + 2 * win_bytes);    // [2][cob][G_LD]

  const int chunk = blockIdx.x % chunks;
  const int co_tile = (blockIdx.x / chunks) % co_tiles;
  const int dt = blockIdx.x / (chunks * co_tiles);
  const int ci0 = chunk * CK, co0 = co_tile * cob;
  const int shift = dt - kt / 2;
  const int t_lo = max(0, -shift), tv = max(0, min(Tn, Tn - shift) - t_lo);
  const long long tiles = (long long)B * tv * tiles_hw;
  const long long q_begin = tiles * blockIdx.y / gridDim.y;
  const int n = (int)(tiles * (blockIdx.y + 1) / gridDim.y - q_begin);
  const int tid = threadIdx.x, warp = tid / 32;

  if (warp >= CONSUMER_WARPS) {  // producers
    const int ptid = tid - CONSUMERS;
    const int n_int = conv_window::interior_items(kh), n_halo = conv_window::halo_items(kh, kw);
    for (int k = 0; k < n; ++k) {
      const int b = k & 1;
      if (k >= 2) bar_sync(EMPTY + b);  // the consumers are done with tile k - 2
      const long long q = q_begin + k;
      const int hw = (int)(q % tiles_hw);
      const long long bt = q / tiles_hw;
      const long long g_frame = (bt / tv) * Tn + t_lo + (int)(bt % tv);
      const int y0 = (hw / tiles_w) * TH, x0 = (hw % tiles_w) * TW;
      stage_g(g_bufs + b * cob * G_LD, g, g_frame, co0, cob, cout, y0, x0, Hh, Ww, vec_ok, ptid);
      const conv_window::Window s{x1, x2, c1, c2, g_frame + shift, ci0, y0, x0, Hh, Ww, kh, kw, vec_ok};
      bf16* win = wins + b * (win_bytes / 2);
      uint4 wv[NV];  // every load of the window in flight before the first store
      bf16 wh[NH];
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (ptid + i * PRODUCERS < n_int) wv[i] = conv_window::load_interior(s, ptid + i * PRODUCERS);
#pragma unroll
      for (int i = 0; i < NH; ++i)
        if (ptid + i * PRODUCERS < n_halo) wh[i] = conv_window::load_halo(s, ptid + i * PRODUCERS);
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (ptid + i * PRODUCERS < n_int) conv_window::store_interior(win, s, ptid + i * PRODUCERS, wv[i]);
#pragma unroll
      for (int i = 0; i < NH; ++i)
        if (ptid + i * PRODUCERS < n_halo) conv_window::store_halo(win, s, ptid + i * PRODUCERS, wh[i]);
      cp_async_wait_all();
      bar_arrive(FULL + b);
    }
    return;
  }

  // consumers
  const int L = CONSUMER_WARPS / row_groups, pg = warp / L, wl = warp % L;
  const int taps = kh * kw, nfrag = taps * nj;
  const int nf = wl < nfrag ? min(NF, (nfrag - wl + L - 1) / L) : 0;
  const int b_off = (wl % nj) * 16 * G_LD;
  int a_off[NF];  // a fragment's offset into the window
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int tap = i < nf ? (wl + L * i) / nj : 0;
    a_off[i] = ((tap / kw) * IW + tap % kw) * CK;
    wmma::fill_fragment(acc[i], 0.f);
  }
  for (int k = 0; k < n; ++k) {
    const int b = k & 1;
    bar_sync(FULL + b);
    const bf16* win = wins + b * (win_bytes / 2);
    const bf16* gs = g_bufs + b * cob * G_LD + b_off;
    for (int r = pg; r < TH; r += row_groups) {
#pragma unroll
      for (int c = 0; c < TW; c += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> afr[NF];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
#pragma unroll
        for (int i = 0; i < NF; ++i) wmma::load_matrix_sync(afr[i], win + (r * IW + c) * CK + a_off[i], CK);
        wmma::load_matrix_sync(bfr, gs + r * TW + c, G_LD);
#pragma unroll
        for (int i = 0; i < NF; ++i) wmma::mma_sync(acc[i], afr[i], bfr, acc[i]);
      }
    }
    if (k + 2 < n) bar_arrive(EMPTY + b);  // the producers may refill buffer b
  }

  // partial [split * row_groups + pg][dt][tap][cin_pad][cout_pad]
  const size_t slab = (size_t)cin_pad * cout_pad;
  const size_t slot = (size_t)blockIdx.y * row_groups + pg;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    if (i < nf) {
      const int f = wl + L * i;
      float* dst = partials + ((slot * kt + dt) * taps + f / nj) * slab + (size_t)ci0 * cout_pad + co0 +
                   (f % nj) * 16;
      wmma::store_matrix_sync(dst, acc[i], cout_pad, wmma::mem_row_major);
    }
  }
}

// dw[tap][ci][co] = the sum of the slots' partials in slot order
__global__ void wgrad_mma_reduce_kernel(const float* __restrict__ partials, float* __restrict__ dw,
                                        int taps, int cin, int cout, int cin_pad, int cout_pad,
                                        int slots) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)taps * cin * cout) return;
  const int co = (int)(e % cout), ci = (int)((e / cout) % cin), tap = (int)(e / ((long long)cout * cin));
  const size_t stride = (size_t)taps * cin_pad * cout_pad;
  const float* src = partials + ((size_t)tap * cin_pad + ci) * cout_pad + co;
  float sum = 0.f;
  for (int z = 0; z < slots; ++z) sum += src[z * stride];
  dw[e] = sum;
}

template <int NF>
cudaError_t launch_nf(dim3 grid, size_t smem, cudaStream_t stream, const void* x1, const void* x2,
                      const void* g, void* partials, int c1, int c2, int B, int Tn, int Hh, int Ww,
                      int cout, int kt, int kh, int kw, int nj, int row_groups, int chunks,
                      int co_tiles, int tiles_w, int tiles_hw, int vec_ok) {
  cudaError_t err = cudaFuncSetAttribute(wgrad_mma_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  wgrad_mma_kernel<NF><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x1), static_cast<const bf16*>(x2), static_cast<const bf16*>(g),
      static_cast<float*>(partials), c1, c2, B, Tn, Hh, Ww, cout, kt, kh, kw, nj, row_groups, chunks,
      co_tiles, tiles_w, tiles_hw, chunks * CK, co_tiles * 16 * nj, vec_ok);
  return cudaGetLastError();
}

cudaError_t launch(const void* x1, const void* x2, const void* g, void* partials, void* dw, int c1,
                   int c2, int B, int Tn, int Hh, int Ww, int cout, int kt, int kh, int kw, int splits,
                   int nj, int row_groups, cudaStream_t stream) {
  if (nj < 1 || nj > MAX_NJ || splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  if (row_groups != 1 && row_groups != 2 && row_groups != 4 && row_groups != 8) return cudaErrorInvalidValue;
  const int lanes = CONSUMER_WARPS / row_groups, nf = (kh * kw * nj + lanes - 1) / lanes;
  if (lanes % nj != 0 || nf > MAXF) return cudaErrorInvalidValue;
  const int cin = c1 + c2, cob = 16 * nj;
  const int chunks = (cin + CK - 1) / CK, co_tiles = (cout + cob - 1) / cob;
  const int tiles_w = (Ww + TW - 1) / TW, tiles_hw = tiles_w * ((Hh + TH - 1) / TH);
  const int vec_ok = Ww % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2) |
                       reinterpret_cast<uintptr_t>(g)) % 16) == 0;
  const size_t win_bytes =
      ((size_t)conv_window::window_rows(kh) * conv_window::window_cols(kw) * CK * 2 + 127) / 128 * 128;
  const size_t smem = 2 * win_bytes + 2 * (size_t)cob * G_LD * sizeof(bf16);
  const dim3 grid((unsigned)(chunks * co_tiles * kt), (unsigned)splits);
#define WGRAD_LAUNCH(N)                                                                        \
  case N:                                                                                      \
    err = launch_nf<N>(grid, smem, stream, x1, x2, g, partials, c1, c2, B, Tn, Hh, Ww, cout, kt, \
                       kh, kw, nj, row_groups, chunks, co_tiles, tiles_w, tiles_hw, vec_ok);   \
    break;
  cudaError_t err = cudaErrorInvalidValue;
  switch (nf) {
    WGRAD_LAUNCH(1) WGRAD_LAUNCH(2) WGRAD_LAUNCH(3) WGRAD_LAUNCH(4)
    WGRAD_LAUNCH(5) WGRAD_LAUNCH(6) WGRAD_LAUNCH(7)
  }
#undef WGRAD_LAUNCH
  if (err != cudaSuccess) return err;
  const long long n = (long long)kt * kh * kw * cin * cout;
  wgrad_mma_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(dw), kt * kh * kw, cin, cout, chunks * CK,
      co_tiles * cob, splits * row_groups);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x2 may be null with c2 = 0. dtype: 0 = float32, 1 = bfloat16 (x1, x2, g).
// variant (ops/conv3d.py:WGRAD_VARIANTS): 0 = the CUDA-core kernel (float32),
// 1 = PR 6's wmma kernel, 2 = the wgmma kernel (bfloat16). dw: f32 (kt, kh,
// kw, c1 + c2, cout). partials: f32 scratch, for variant 0 of splits * K *
// cout (K = kt * kh * kw * (c1 + c2)), for variant 1 of splits * row_groups *
// kt * kh * kw * cin_pad * cout_pad with cin_pad = c1 + c2 and cout_pad = cout
// rounded up to 16 and 16 * nj (wgrad_plan), for variant 2 as wgrad_wg_plan's
// workspace. gt: variant 2's channels-last copy of g (null otherwise). The
// arguments a variant does not read are 0.
extern "C" int vvt_conv3d_wgrad(const void* x1, const void* x2, const void* g, void* gt, void* partials,
                                void* dw, int c1, int c2, int B, int Tn, int Hh, int Ww, int cout,
                                int kt, int kh, int kw, int variant, int splits, int nj, int row_groups,
                                int band, int nb, int rows, int stages, int smem, int dtype,
                                void* stream) {
  if (B < 1 || Tn < 1 || Hh < 1 || Ww < 1 || c1 < 1 || c2 < 0 || cout < 1) return (int)cudaErrorInvalidValue;
  if (kt < 1 || kt % 2 == 0 || kh < 1 || kh % 2 == 0 || kh > MAX_K || kw < 1 || kw % 2 == 0 ||
      kw > MAX_K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && variant == 0)
    return (int)launch<float>(x1, x2, g, partials, dw, c1, c2, B, Tn, Hh, Ww, cout, kt, kh, kw,
                              splits, st);
  if (dtype == 1 && variant == 1)
    return (int)tc::launch(x1, x2, g, partials, dw, c1, c2, B, Tn, Hh, Ww, cout, kt, kh, kw, splits,
                           nj, row_groups, st);
  if (dtype == 1 && variant == 2)
    return (int)wgrad_wg::launch(static_cast<const __nv_bfloat16*>(x1), static_cast<const __nv_bfloat16*>(x2),
                                 static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gt),
                                 static_cast<float*>(partials), static_cast<float*>(dw), c1, c2, B, Tn, Hh,
                                 Ww, cout, kt, kh, kw, splits, band, nb, rows, stages, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
