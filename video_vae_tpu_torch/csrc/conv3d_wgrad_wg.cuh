// The bf16 filter gradient of the stride-1 SAME 3-D conv on Hopper: a
// warp-specialised wgmma implicit GEMM fed by TMA (conv3d_wgrad.cu's entry
// point launches it for every frame width TMA can describe, w % 8 == 0).
//
//   dW[dt, dh, dw, ci, co] = sum_{b,t,y,x} x[b, t+dt-kt/2, ci, y+dh-kh/2, x+dw-kw/2] * g[b, t, co, y, x]
//
// is computed with the shift on g rather than on x:
//
//   dW^T[tap][co][ci] = sum_p g[p - off(tap)][co] * x[p][ci]
//
// an M = output channels by N = input channels product per tap, K = the
// pixels. TMA cannot shift a box by one pixel along a contiguous axis (on the
// H100 a box whose innermost coordinate is not 16-byte aligned stops the
// kernel), so a first launch copies g channels-last (channels_last.cuh) into
// the wrapper's scratch, (b, t, h, w, cp) with cout padded to cp, and every
// shift moves an outer coordinate of that copy; x is read in place.
//   - A, the g copy, is MN-major (wgmma's transpose bit): a 5-D tensor map over
//     (cp, w, h, t, b) gives a box of `band` output channels x bw pixels x
//     (rows + kh - 1) image rows of one frame, swizzled by the band's width
//     (16 channels: 32-byte swizzle, 32: 64-byte, 64: 128-byte). The box's
//     column and frame coordinates carry the tap's dw and dt; TMA's zero fill
//     past the frame's edges and past the clip's first and last frames is
//     SAME's padding, so no tap needs code for it. One box serves the kh row
//     taps of its (dt, dw): tap dh's operand starts kh - 1 - dh image rows in,
//     a whole number of swizzle atoms.
//   - An M-tile is 64 rows: 64 / band boxes of consecutive (dt, dw) at the
//     same row offset, `band` channels each, placed side by side so that the
//     descriptor's leading offset (the distance between MN blocks) steps from
//     one to the next. A 12- or 16-channel conv stacks four taps in an M-tile
//     and a 32-channel conv two, where PR 6's wmma kernel padded each tap to
//     16 x 16 fragments one at a time.
//   - B, x, is K-major as it lies (pixels contiguous): a box of 64 pixels x nb
//     input channels x `rows` image rows at the tile's corner (a 4-D map over
//     (w, c, h, frames), 128-byte swizzle), or, for a frame narrower than 64
//     that divides 64, one box of 64 consecutive pixels (64 / w whole rows) x
//     nb channels a K block from a 3-D map over (h * w, c, frames). Channels
//     past a source's last read as zeros, so a 12-channel source's rows
//     12..15 add nothing, and two sources (the concat is never built) take N
//     tiles of their own, x1's then x2's, or, where both fit one N tile with
//     their channels rounded up to 8 (the UNet's 16+16, 32+32, 64+64 decoder
//     convs), share it: two boxes a K block, x1's rows then x2's, so that the
//     M-tiles' A boxes are read once, not once a source.
// The block (384 threads): a producer warpgroup (setmaxnreg 40) of which one
// thread walks the block's share of the pixel tiles (frame, `rows` image
// rows, bw columns; column tile fastest) and fills a ring of `stages` slots
// with the tile's A boxes and B box(es) on `full` mbarriers; two consumer
// warpgroups (setmaxnreg 232) take the tiles in turns (warpgroup w the w-th,
// w + 2-th, ... of the block's; with an odd ring a slot's tiles alternate
// between them, so a warpgroup first waits for the other's release of the
// slot, or it could pass the `full` barrier on the parity of the phase before
// and read a slot not yet loaded), each holding all kh M-tiles x nb of the
// block's gradient in registers (kh * nb / 2 a thread), and per tile issue
// kh wgmma.mma_async m64nNBk16 for every 16 pixels, wait for them and free
// the slot on its `empty` mbarrier. A block owns one M-tile group (the boxes
// of 64 / band consecutive taps) by one N tile, and the `splits`-th share of
// the tiles; the grid is (groups x N tiles, splits).
// No atomics: each (split, consumer warpgroup) writes an f32 partial of its
// M-tiles by its N tile, [slot][m-tile][n][64 rows], and wgrad_wg_reduce
// sums the slots in a fixed order into dW's (kt, kh, kw, c1 + c2, cout)
// layout, mapping each (tap, co) back to its band and each ci to its source's
// N tile: the same bits on every run (not PR 6's bits: the sums run in
// another order).
// What bounds it: the 12- to 32-channel convs at the top of the UNet by the
// A boxes, g read from L2 kt * kw * (rows + kh - 1) / rows times a pixel for
// every N tile (a copy whose ring loads are cut takes about half their time:
// utils/kernel_phases.py --kernel 4, PERF.md), so the plan takes the tallest
// row tile whose ring still holds two slots, measured faster than a shorter
// tile with a deeper ring at every band; the 64- to 512-channel convs by the
// products. The tile, band, nb, ring and grid come from
// ops/conv3d.py:wgrad_wg_plan, which tests/test_torch_wgrad_wg_plan.py walks
// and replays on the CPU; the entry point checks the shared memory against
// wgrad_wg_smem_bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "channels_last.cuh"
#include "gemm_sm90.cuh"

namespace wgrad_wg {

using bf16 = __nv_bfloat16;
using vvt_sm90::SMEM_ALIGN;

constexpr int THREADS = 384;  // two consumer warpgroups and a producer
constexpr int KB = 64;        // pixels of a K block: one 128-byte row of B
constexpr int MAX_STAGES = 8;
constexpr int MAX_ROWS = 64;  // image rows of a pixel tile

// Bytes of one ring slot's A boxes (64 / band boxes of band x bw x (rows + kh
// - 1) bf16: 128 bytes a pixel whatever the band) and of its B box(es) (nb
// channels x rows * bw pixels).
__host__ __device__ constexpr int a_bytes(int bw, int rows, int kh) { return 128 * bw * (rows + kh - 1); }
__host__ __device__ constexpr int b_bytes(int nb, int bw, int rows) { return 2 * nb * bw * rows; }

// Dynamic shared memory of a block: alignment slack, the ring, a full and an
// empty mbarrier a slot. ops/conv3d.py's wgrad_wg_smem mirrors it.
__host__ __device__ constexpr int wgrad_wg_smem_bytes(int nb, int kh, int bw, int rows, int stages) {
  return SMEM_ALIGN + stages * (a_bytes(bw, rows, kh) + b_bytes(nb, bw, rows)) + stages * 2 * 8;
}

struct Geometry {
  int Tn, H, W, kt, kh, kw;
  int band, bpm, co_bands, boxes, groups;  // boxes: (dt, dw, band) triples, bpm of them an M-tile group
  int nt1, cin_pad, c1;                     // x1's N tiles; N tiles x nb in all
  int joint, c1p, c2p;  // one N tile for both sources: x1's c1p rows, then x2's c2p
  int n2;               // x2's first column of the padded N axis
  int bw, rows, kblocks, flat;              // a pixel tile: rows x bw, kblocks K blocks of 64
  int tiles_w, tiles_h, tiles, splits, stages;
};

// d (64 x N a warpgroup, f32) += A (64 x 16, MN-major: the transpose bit) .
// B (16 x N, K-major)
#define WG_ACC8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <int N>
struct WgmmaT;

template <>
struct WgmmaT<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : WG_ACC8(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaT<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : WG_ACC8(0), WG_ACC8(8)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaT<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 0;\n}\n"
        : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaT<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 1, 0;\n}\n"
        : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24), WG_ACC8(32), WG_ACC8(40), WG_ACC8(48),
          WG_ACC8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef WG_ACC8

template <int NB, int KH>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_wg_kernel(const __grid_constant__ CUtensorMap g_map, const __grid_constant__ CUtensorMap x1_map,
                const __grid_constant__ CUtensorMap x2_map, float* __restrict__ partials, const Geometry geo) {
  using namespace vvt_sm90;
  constexpr int ACC = NB / 2;  // f32 accumulators a thread an M-tile: 64 x NB over 128
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) & ~uintptr_t(SMEM_ALIGN - 1));
  const int a_slot = a_bytes(geo.bw, geo.rows, KH);
  const int slot_bytes = a_slot + b_bytes(NB, geo.bw, geo.rows);
  const int box_bytes = a_slot / geo.bpm;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + geo.stages * slot_bytes);
  uint64_t* empty = full + geo.stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the four warps of the warpgroup that took the tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int group = blockIdx.x % geo.groups, nt = blockIdx.x / geo.groups;
  const long long t_begin = (long long)geo.tiles * blockIdx.y / geo.splits;
  const int n = (int)((long long)geo.tiles * (blockIdx.y + 1) / geo.splits - t_begin);
  const bool second = nt >= geo.nt1;  // an N tile of x2
  const int ci0 = (second ? nt - geo.nt1 : nt) * NB;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      const int box0 = group * geo.bpm, nbox = min(geo.bpm, geo.boxes - box0);
      const uint32_t bytes = nbox * box_bytes + (geo.joint ? geo.kblocks * (geo.c1p + geo.c2p) * 128
                                                             : b_bytes(NB, geo.bw, geo.rows));
      const CUtensorMap* x_map = second ? &x2_map : &x1_map;
      const int rk = KB / geo.bw;  // image rows of a K block
      for (int i = 0; i < n; ++i) {
        const int slot = i % geo.stages;
        mbar_wait(&empty[slot], ((i / geo.stages) & 1) ^ 1);
        long long t = t_begin + i;
        const int x0 = (int)(t % geo.tiles_w) * geo.bw;
        t /= geo.tiles_w;
        const int y0 = (int)(t % geo.tiles_h) * geo.rows;
        const int frame = (int)(t / geo.tiles_h);
        const int b = frame / geo.Tn, tt = frame % geo.Tn;
        uint8_t* a_dst = smem + slot * slot_bytes;
        uint8_t* b_dst = a_dst + a_slot;
        mbar_expect_tx(&full[slot], bytes);
        for (int j = 0; j < nbox; ++j) {  // box (dt, dw, band): g at the pixel minus the tap's offset
          const int box = box0 + j, cb = box % geo.co_bands, tap = box / geo.co_bands;
          const int dw = tap % geo.kw, dt = tap / geo.kw;
          tma_load_5d(a_dst + j * box_bytes, &g_map, &full[slot], cb * geo.band, x0 - dw + geo.kw / 2,
                      y0 - KH / 2, tt - dt + geo.kt / 2, b);
        }
        if (geo.joint) {  // a K block's rows: x1's c1p channels, then x2's
          for (int j = 0; j < geo.kblocks; ++j) {
            uint8_t* dst = b_dst + j * NB * 128;
            if (geo.flat) {
              tma_load_3d(dst, &x1_map, &full[slot], (y0 + j * rk) * geo.W, 0, frame);
              tma_load_3d(dst + geo.c1p * 128, &x2_map, &full[slot], (y0 + j * rk) * geo.W, 0, frame);
            } else {
              tma_load_4d(dst, &x1_map, &full[slot], x0, 0, y0 + j, frame);
              tma_load_4d(dst + geo.c1p * 128, &x2_map, &full[slot], x0, 0, y0 + j, frame);
            }
          }
        } else if (geo.flat) {
          for (int j = 0; j < geo.kblocks; ++j)
            tma_load_3d(b_dst + j * NB * 128, x_map, &full[slot], (y0 + j * rk) * geo.W, ci0, frame);
        } else {
          tma_load_4d(b_dst, x_map, &full[slot], x0, ci0, y0, frame);
        }
      }
    }
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const uint32_t layout = geo.band == 16 ? 3 : geo.band == 32 ? 2 : 1;  // the band's swizzle
    const uint32_t k_row = 2 * geo.band;             // bytes of one pixel of a box
    const uint32_t row_bytes = k_row * geo.bw;       // one image row of a box
    const int rk = KB / geo.bw;
    float d[KH][ACC];
#pragma unroll
    for (int m = 0; m < KH; ++m)
#pragma unroll
      for (int i = 0; i < ACC; ++i) d[m][i] = 0.f;
#pragma unroll
    for (int m = 0; m < KH; ++m) fence_acc(d[m]);
    for (int i = wg; i < n; i += 2) {
      const int slot = i % geo.stages;
      // With an odd ring the slot's last tile was the other warpgroup's: wait
      // until it freed the slot, so that the `full` phase of the parity asked
      // for next is this tile's and not that one's.
      if ((geo.stages & 1) && i >= geo.stages) mbar_wait(&empty[slot], (i / geo.stages - 1) & 1);
      mbar_wait(&full[slot], (i / geo.stages) & 1);
      const uint8_t* a_tile = smem + slot * slot_bytes;
      const uint8_t* b_tile = a_tile + a_slot;
      wgmma_fence();
      for (int j = 0; j < geo.kblocks; ++j) {
#pragma unroll
        for (int kk = 0; kk < KB / 16; ++kk) {
          // B: nb rows of 128 bytes, 8-row groups 1024 apart, a k16 step 32 bytes along the row
          const uint64_t b_desc = smem_desc(b_tile + j * NB * 128 + kk * 32, 16, 1024);
#pragma unroll
          for (int m = 0; m < KH; ++m) {  // tap dh = m starts kh - 1 - dh rows into the box
            const uint8_t* a = a_tile + (j * rk + KH - 1 - m) * row_bytes + kk * 16 * k_row;
            WgmmaT<NB>::mma(d[m], smem_desc(a, box_bytes, 8 * k_row, layout), b_desc);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_group<0>();
#pragma unroll
      for (int m = 0; m < KH; ++m) fence_acc(d[m]);
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

    // partial [split * 2 + wg][m-tile][n][64]; d[m][4j + 2e + c] is row 16 * warp
    // + lane / 4 + 8e, column 8j + 2 (lane % 4) + c of M-tile group * kh + m
    const size_t mtiles = (size_t)geo.groups * KH;
    const size_t slot = (size_t)blockIdx.y * 2 + wg;
#pragma unroll
    for (int m = 0; m < KH; ++m) {
      float* out = partials + ((slot * mtiles + (size_t)group * KH + m) * geo.cin_pad + (size_t)nt * NB) * 64;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            out[(8 * j + 2 * (lane % 4) + c) * 64 + 16 * warp + lane / 4 + 8 * e] = d[m][4 * j + 2 * e + c];
    }
  }
}

// dw[dt][dh][dw][ci][co] = the sum of the slots' partials in slot order
__global__ void wgrad_wg_reduce_kernel(const float* __restrict__ partials, float* __restrict__ dw,
                                       const Geometry geo, int cin, int cout, int nb, int slots) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int taps = geo.kt * geo.kh * geo.kw;
  if (e >= (long long)taps * cin * cout) return;
  const int co = (int)(e % cout), ci = (int)((e / cout) % cin), tap = (int)(e / ((long long)cout * cin));
  const int dwi = tap % geo.kw, dh = (tap / geo.kw) % geo.kh, dt = tap / (geo.kw * geo.kh);
  const int box = (dt * geo.kw + dwi) * geo.co_bands + co / geo.band;
  const int mt = box / geo.bpm * geo.kh + dh, row = box % geo.bpm * geo.band + co % geo.band;
  const int n = ci < geo.c1 ? ci : geo.n2 + ci - geo.c1;
  const size_t stride = (size_t)geo.groups * geo.kh * geo.cin_pad * 64;
  const float* src = partials + ((size_t)mt * geo.cin_pad + n) * 64 + row;
  float sum = 0.f;
  for (int z = 0; z < slots; ++z) sum += src[z * stride];
  dw[e] = sum;
}

template <int NB, int KH>
cudaError_t launch_kernel(const CUtensorMap& g_map, const CUtensorMap& x1_map, const CUtensorMap& x2_map,
                          float* partials, const Geometry& geo, int smem, cudaStream_t s) {
  auto kernel = wgrad_wg_kernel<NB, KH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(geo.groups * (geo.cin_pad / NB)), (unsigned)geo.splits);
  kernel<<<grid, THREADS, smem, s>>>(g_map, x1_map, x2_map, partials, geo);
  return cudaGetLastError();
}

// The instantiations: nb x kh within 112 accumulators a thread, or 192 for a
// 3 x 3 kernel's 128-wide N tiles.
template <int KH>
cudaError_t launch_nb(int nb, const CUtensorMap& g_map, const CUtensorMap& x1_map, const CUtensorMap& x2_map,
                      float* partials, const Geometry& geo, int smem, cudaStream_t s) {
  switch (nb) {
    case 16: return launch_kernel<16, KH>(g_map, x1_map, x2_map, partials, geo, smem, s);
    case 32: return launch_kernel<32, KH>(g_map, x1_map, x2_map, partials, geo, smem, s);
    case 64:
      if constexpr (KH <= 3) return launch_kernel<64, KH>(g_map, x1_map, x2_map, partials, geo, smem, s);
      break;
    case 128:
      if constexpr (KH <= 3) return launch_kernel<128, KH>(g_map, x1_map, x2_map, partials, geo, smem, s);
      break;
  }
  return cudaErrorInvalidValue;
}

// The whole filter gradient: the copy of g, the products, the reduce.
// gt: (b, t, h, w, cp) bf16 scratch with cp = band * co_bands; partials: f32
// scratch of splits * 2 * groups * kh * cin_pad * 64. Every pointer 16-byte
// aligned, w % 8 == 0 (ops/conv3d.py:wgrad_wg_plan).
inline cudaError_t launch(const bf16* x1, const bf16* x2, const bf16* g, bf16* gt, float* partials, float* dw,
                          int c1, int c2, int B, int Tn, int H, int W, int cout, int kt, int kh, int kw,
                          int splits, int band, int nb, int rows, int stages, int smem, cudaStream_t s) {
  if (W % 8 != 0 || (band != 16 && band != 32 && band != 64)) return cudaErrorInvalidValue;
  if (nb != 16 && nb != 32 && nb != 64 && nb != 128) return cudaErrorInvalidValue;
  if ((nb > 32 && kh > 3) || (c2 > 0 && x2 == nullptr)) return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(gt);
  if (align % 16 != 0) return cudaErrorInvalidValue;
  Geometry geo;
  geo.Tn = Tn;
  geo.H = H;
  geo.W = W;
  geo.kt = kt;
  geo.kh = kh;
  geo.kw = kw;
  geo.band = band;
  geo.bpm = 64 / band;
  geo.co_bands = (cout + band - 1) / band;
  geo.boxes = kt * kw * geo.co_bands;
  geo.groups = (geo.boxes + geo.bpm - 1) / geo.bpm;
  // two sources whose channels, each rounded up to 8, fit one N tile share it
  geo.c1p = (c1 + 7) / 8 * 8;
  geo.c2p = (c2 + 7) / 8 * 8;
  geo.joint = c2 > 0 && geo.c1p + geo.c2p <= nb;
  geo.nt1 = geo.joint ? 1 : (c1 + nb - 1) / nb;
  geo.cin_pad = nb * (geo.joint ? 1 : geo.nt1 + (c2 + nb - 1) / nb);
  geo.n2 = geo.joint ? geo.c1p : geo.nt1 * nb;
  geo.c1 = c1;
  geo.flat = W < KB && KB % W == 0;
  geo.bw = geo.flat ? W : KB;
  geo.rows = rows;
  geo.kblocks = rows * geo.bw / KB;
  geo.tiles_w = (W + geo.bw - 1) / geo.bw;
  geo.tiles_h = (H + rows - 1) / rows;
  geo.splits = splits;
  geo.stages = stages;
  const long long tiles = (long long)B * Tn * geo.tiles_h * geo.tiles_w;
  if (rows < 1 || rows > MAX_ROWS || (rows * geo.bw) % KB != 0 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  geo.tiles = (int)tiles;
  if (stages < 2 || stages > MAX_STAGES || splits < 1 || splits > 65535 || splits > geo.tiles)
    return cudaErrorInvalidValue;
  if (smem != wgrad_wg_smem_bytes(nb, kh, geo.bw, rows, stages)) return cudaErrorInvalidValue;

  // the g copy, cout padded to the bands
  const int cp = band * geo.co_bands;
  const long long P = (long long)H * W;
  cudaError_t err = channels_last::copy(g, gt, B * Tn, cout, cp, P, s);
  if (err != cudaSuccess) return err;

  // A: (cp, w, h, t, b), a box of band x bw x (rows + kh - 1) x 1 x 1
  CUtensorMap g_map, x1_map, x2_map;
  {
    const long long dims[5] = {cp, W, H, Tn, B};
    const long long strides[4] = {2LL * cp, 2LL * cp * W, 2LL * cp * P, 2LL * cp * P * Tn};
    const int box[5] = {band, geo.bw, rows + kh - 1, 1, 1};
    const CUtensorMapSwizzle sw = band == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                  : band == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_128B;
    err = vvt_sm90::encode_map(&g_map, gt, 5, dims, strides, box, sw);
    if (err != cudaSuccess) return err;
  }
  // B: x in place, (w, c, h, frames) boxes of 64 x nb x rows, or (h * w, c, frames) boxes of 64 x nb;
  // with a joint N tile, boxes of one K block and the source's rounded channels
  for (int src = 0; src < (c2 > 0 ? 2 : 1); ++src) {
    const long long C = src == 0 ? c1 : c2;
    CUtensorMap* map = src == 0 ? &x1_map : &x2_map;
    const void* base = src == 0 ? static_cast<const void*>(x1) : static_cast<const void*>(x2);
    const int n_box = geo.joint ? (src == 0 ? geo.c1p : geo.c2p) : nb;
    if (geo.flat) {
      const long long dims[3] = {P, C, (long long)B * Tn};
      const long long strides[2] = {2 * P, 2 * P * C};
      const int box[3] = {KB, n_box, 1};
      err = vvt_sm90::encode_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    } else {
      const long long dims[4] = {W, C, H, (long long)B * Tn};
      const long long strides[3] = {2 * P, 2LL * W, 2 * P * C};
      const int box[4] = {KB, n_box, geo.joint ? 1 : rows, 1};
      err = vvt_sm90::encode_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (err != cudaSuccess) return err;
  }
  if (c2 == 0) x2_map = x1_map;

  switch (kh) {
    case 1: err = launch_nb<1>(nb, g_map, x1_map, x2_map, partials, geo, smem, s); break;
    case 3: err = launch_nb<3>(nb, g_map, x1_map, x2_map, partials, geo, smem, s); break;
    case 5: err = launch_nb<5>(nb, g_map, x1_map, x2_map, partials, geo, smem, s); break;
    case 7: err = launch_nb<7>(nb, g_map, x1_map, x2_map, partials, geo, smem, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long long total = (long long)kt * kh * kw * (c1 + c2) * cout;
  wgrad_wg_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(partials, dw, geo, c1 + c2, cout, nb,
                                                                         2 * splits);
  return cudaGetLastError();
}

}  // namespace wgrad_wg
