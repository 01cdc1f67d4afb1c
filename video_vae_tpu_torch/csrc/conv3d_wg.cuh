// The bf16 direct 3-D conv on Hopper: a warp-specialised wgmma implicit GEMM
// fed by TMA from a channels-last copy of each source (conv3d.cu's entry point
// launches it for the bf16 convs ops/conv3d.py:conv_variant sends it: w % 8 ==
// 0, a 3 x 3 or smaller spatial kernel, 64 or more output channels, where it was
// measured faster than the mma.sync kernel; it takes any w % 8 == 0 conv whose plan
// fits). The function is conv3d.cu's: stride 1, SAME zero padding, DHWIO weights,
// f32 sums over every tap and input channel, the f32 bias, one rounding; one
// source or two whose concat is never built; an optional 2x2 max pool.
//
//   y[f, co, p] = bias[co] + sum_{dt,dh,dw,ci} x[f + dt - kt/2, ci, p + (dh - kh/2, dw - kw/2)] w[dt,dh,dw,ci,co]
//
// M = output pixels, N = output channels (a block's `nb` of them: 64 or 128),
// K = input channels, once per tap.
//   - The sources. A first launch per source (channels_last.cuh, shared with
//     #4 and #9) copies it to (frames, h * w, cp), its channels zero-padded to
//     cp, a multiple of the chunk `kc` (16, 32 or 64 channels: one 32-, 64- or
//     128-byte pixel). On the H100 a TMA box whose innermost coordinate is not
//     16-byte aligned stops the kernel, so the copy makes every pixel shift an
//     outer coordinate.
//   - A stage is one temporal tap dt inside the clip by one chunk (x1's chunks,
//     then x2's). Its input box comes from a 5-D tensor map over the copy, (cp,
//     w, h, t, b): kc channels x bx = bw + kw - 1 columns x rx = rows + kh - 1
//     image rows of frame t + dt - kt/2, the tile's pixels and their halo,
//     swizzled by the chunk's width. TMA's zero fill past the frame's edges and
//     past the clip's first and last frames is SAME's padding; t and b are
//     separate dimensions, so a tap never reads the next clip. Every spatial tap
//     reads this one box: a pixel shift is an offset into it.
//   - A from registers. wgmma takes its A operand from registers, so a consumer
//     loads each 64-pixel x 16-channel fragment with ldmatrix from any row and
//     column of the box (each lane names its own row: the shift needs no
//     aligned start). An M-tile is `rpm` image rows of bw columns (bw = 64, or
//     the frame's width rounded down to a power of two); the fragment at box
//     row a serves M-tile r at row tap dh = a - r * rpm, so one load feeds up
//     to kh products of a warpgroup (the input row reused across the output
//     rows it feeds, where the mma.sync kernel loaded a fragment a tap).
//   - B, the weights of the stage's kh * kw taps for the block's nb output
//     channels: one TMA box of a 3-D map over the entry point's K-major
//     re-layout [tap][cout][k] (k: x1's cp1 channels, then x2's), swizzled like
//     the input, its rows past cout filled with zeros.
//   - The block (384 threads): a producer warpgroup (setmaxnreg 40) of which one
//     thread fills a ring of `stages` slots (an input box and a weight box) on
//     `full`/`empty` mbarriers; two consumer warpgroups (setmaxnreg 232) of
//     `mtw` M-tiles each (the tile's top and bottom halves), which run every
//     stage of the tile. A consumer walks (box row, k16 step, column shift):
//     a step loads the fragment of its shift into one of two buffers, issues
//     its products (m64nNBk16, f32 accumulators), commits once and waits for
//     the step before, whose buffer the next step overwrites. It frees a slot
//     once its products are done.
//     Blocks are persistent (one an SM) and walk their tiles in turn (output
//     channel tile fastest, then column tile, row tile, frame), so the ring
//     runs ahead across tiles and under the epilogue.
//   - The epilogue: the bias added to the f32 sums, one rounding, the M-tiles
//     written two at a time to a staging tile of the warpgroup's (the output's
//     [row][channel][column] box, swizzled by its 16-, 32-, 64- or 128-byte
//     rows) and stored by TMA from a 4-D map over y, (w, cout, h, frames), which
//     clips rows, columns and channels past the edges. The 2x2 pool is the max
//     of four staged values: rounding to bf16 is monotonic, so the max of the
//     rounded sums is the rounded max of the sums.
// No split-K and no atomics: each output is summed by one warpgroup in a fixed
// order, so two launches give the same bits (not the mma.sync kernel's: the sums run in
// another order). The chunk, tile, ring and grid come from
// ops/conv3d.py:conv_wg_plan, which tests/test_torch_conv_wg_plan.py walks and
// replays on the CPU; the entry point checks the shared memory against
// conv_wg_smem_bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "channels_last.cuh"
#include "gemm_sm90.cuh"

namespace conv_wg {

using bf16 = __nv_bfloat16;
using vvt_sm90::SMEM_ALIGN;

constexpr int THREADS = 384;  // two consumer warpgroups and a producer
constexpr int MTILE = 64;     // output pixels of an M-tile
constexpr int MAX_STAGES = 6;
constexpr int MAX_K = 7;

// M-tiles a consumer warpgroup holds at most (mtw * nb / 2 f32 accumulators a
// thread, beside two fragments of 4 registers): within the 168 registers a
// thread of 384 has.
__host__ __device__ constexpr int max_mtw(int nb) { return 256 / nb; }

__host__ __device__ constexpr int round1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }
// One ring slot: the input box (kc channels x bx x rx pixels) and the weight
// box (taps x nb x kc), each on a 1024-byte boundary.
__host__ __device__ constexpr int a_slot_bytes(int kc, int bx, int rx) { return round1k(2 * kc * bx * rx); }
__host__ __device__ constexpr int b_slot_bytes(int kc, int nb, int taps) { return round1k(2 * kc * nb * taps); }
// A consumer warpgroup's staging: two M-tiles of 64 pixels x nb channels.
__host__ __device__ constexpr int staging_bytes(int nb) { return 2 * MTILE * nb * 2; }

// Dynamic shared memory of a block: alignment slack, the ring, the two
// warpgroups' staging, a full and an empty mbarrier a slot.
// ops/conv3d.py's conv_wg_smem mirrors it.
__host__ __device__ constexpr int conv_wg_smem_bytes(int kc, int nb, int bx, int rx, int taps, int stages) {
  return SMEM_ALIGN + stages * (a_slot_bytes(kc, bx, rx) + b_slot_bytes(kc, nb, taps)) + 2 * staging_bytes(nb) +
         stages * 16;
}

struct Geometry {
  int Tn, H, W, cout, kt, kh, kw;
  int kc, chunks1, chunks, cp1;          // chunks of kc channels: x1's, then x2's; x2's first weight column
  int bw, bw_log2, rpm, bx, rows, rx, mtw;  // a tile: rows x bw pixels, an M-tile rpm rows; the box bx x rx
  int tiles_w, tiles_h, n_tiles, tiles;
  int stages, a_slot, b_slot;
};

// tile t: output channel tile fastest, then column tile, row tile, frame
struct Tile {
  int b, t, y0, x0, n0, dt_lo, dt_hi;  // the temporal taps [dt_lo, dt_hi) land inside the clip
};

__device__ __forceinline__ Tile tile_at(const Geometry& g, int i, int nb) {
  Tile r;
  r.n0 = (i % g.n_tiles) * nb;
  i /= g.n_tiles;
  r.x0 = (i % g.tiles_w) * g.bw;
  i /= g.tiles_w;
  r.y0 = (i % g.tiles_h) * g.rows;
  const int frame = i / g.tiles_h;
  r.b = frame / g.Tn;
  r.t = frame % g.Tn;
  r.dt_lo = max(0, g.kt / 2 - r.t);
  r.dt_hi = min(g.kt, g.Tn - r.t + g.kt / 2);
  return r;
}

// The byte offset `off` of a box whose rows are swizzled by TMA (1 << s
// 16-byte units a row: s = 1, 2, 3 for 32-, 64-, 128-byte rows; 0: none),
// from a 1024-byte boundary.
__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t s) {
  return off ^ (((off >> 7) & ((1u << s) - 1)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Keeps a fragment that an in-flight wgmma reads alive until the wait after it.
__device__ __forceinline__ void fence_frag(uint32_t (&r)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[e])::"memory");
}

// One box of a 4-D tensor map from shared memory (this thread's bulk async
// group); elements past the tensor's edges are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(vvt_sm90::smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// d (64 x N a warpgroup, f32) += A (64 x 16, bf16 in registers: each warp's 16
// rows as mma.sync's m16n8k16 A fragment) . B (16 x N, K-major in shared memory)
#define CW_ACC8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define CW_A "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)

template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : CW_ACC8(0), CW_ACC8(8), CW_ACC8(16), CW_ACC8(24)
        : CW_A);
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : CW_ACC8(0), CW_ACC8(8), CW_ACC8(16), CW_ACC8(24), CW_ACC8(32), CW_ACC8(40), CW_ACC8(48),
          CW_ACC8(56)
        : CW_A);
  }
};

#undef CW_ACC8
#undef CW_A

// One step of a stage: the fragment at box row `a`, k16 step ks and column
// shift dw into `f`; its products for every M-tile r whose row tap dh = a - r *
// rpm is a tap; one commit; a wait for the step before (whose fragment `prev`
// the next step overwrites).
template <int NB, int MTW>
__device__ __forceinline__ void conv_step(float (&d)[MTW][NB / 2], uint32_t (&f)[4], uint32_t (&prev)[4],
                                          uint32_t a_base, uint32_t off, uint32_t a_swz, uint64_t b_desc,
                                          const Geometry& g, int a, int dw) {
  using namespace vvt_sm90;
  ldsm_x4(f, a_base + swizzle(off, a_swz));
  wgmma_fence();
  const int tap_units = NB * g.kc / 8;  // one tap's weight slab, in 16-byte units
#pragma unroll
  for (int r = 0; r < MTW; ++r) {
    const int dh = a - r * g.rpm;
    if (r < g.mtw && dh >= 0 && dh < g.kh) WgmmaRS<NB>::mma(d[r], f, b_desc + (dh * g.kw + dw) * tap_units);
  }
  wgmma_commit();
  wgmma_wait_group<1>();
  fence_frag(prev);
}

template <int NB, int MTW>
__global__ void __launch_bounds__(THREADS, 1)
conv_wg_kernel(const __grid_constant__ CUtensorMap x1_map, const __grid_constant__ CUtensorMap x2_map,
               const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap y_map,
               const float* __restrict__ bias, bf16* __restrict__ pooled, const Geometry g) {
  using namespace vvt_sm90;
  constexpr int ACC = NB / 2;  // f32 accumulators a thread an M-tile: 64 x NB over 128
  constexpr int STG = staging_bytes(NB);
  constexpr int STG_TILE = STG / 2;  // one M-tile's staging box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) & ~uintptr_t(SMEM_ALIGN - 1));
  const int slot_bytes = g.a_slot + g.b_slot;
  uint8_t* staging = smem + g.stages * slot_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * STG);
  uint64_t* empty = full + g.stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int taps = g.kh * g.kw;

  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      const uint32_t bytes = 2 * g.kc * (g.bx * g.rx + NB * taps);
      int slot = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < g.tiles; i += gridDim.x) {
        const Tile tl = tile_at(g, i, NB);
        for (int dt = tl.dt_lo; dt < tl.dt_hi; ++dt) {
          for (int c = 0; c < g.chunks; ++c) {
            mbar_wait(&empty[slot], phase ^ 1);
            uint8_t* dst = smem + slot * slot_bytes;
            mbar_expect_tx(&full[slot], bytes);
            const bool first = c < g.chunks1;
            const int c0 = (first ? c : c - g.chunks1) * g.kc;
            tma_load_5d(dst, first ? &x1_map : &x2_map, &full[slot], c0, tl.x0 - g.kw / 2, tl.y0 - g.kh / 2,
                        tl.t + dt - g.kt / 2, tl.b);
            tma_load_3d(dst + g.a_slot, &w_map, &full[slot], first ? c0 : g.cp1 + c0, tl.n0, dt * taps);
            if (++slot == g.stages) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const uint32_t a_swz = g.kc == 16 ? 1 : g.kc == 32 ? 2 : 3;
    const uint32_t b_layout = g.kc == 16 ? 3 : g.kc == 32 ? 2 : 1;  // the same swizzle, as wgmma names it
    const uint32_t y_swz = g.bw == 64 ? 3 : g.bw == 32 ? 2 : g.bw == 16 ? 1 : 0;
    const int first_row = wg * g.mtw * g.rpm;  // this warpgroup's first output row of the tile
    // this lane's ldmatrix row: pixel p of an M-tile and its 8-channel half
    const int p = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
    const uint32_t half = (lane >> 4) * 16;
    const int pix0 = (first_row + (p >> g.bw_log2)) * g.bx + (p & (g.bw - 1));
    const uint32_t pix_bytes = 2 * g.kc;
    const int ksteps = g.kc / 16;
    const int steps = ((g.mtw - 1) * g.rpm + g.kh) * ksteps * g.kw;  // (box row, k16 step, column shift)
    uint8_t* stg = staging + wg * STG;
    float d[MTW][ACC];
    uint32_t fa[4] = {}, fb[4] = {};
    int slot = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < g.tiles; i += gridDim.x) {
      const Tile tl = tile_at(g, i, NB);
#pragma unroll
      for (int r = 0; r < MTW; ++r)
#pragma unroll
        for (int e = 0; e < ACC; ++e) d[r][e] = 0.f;
      const int stages = (tl.dt_hi - tl.dt_lo) * g.chunks;
      for (int st = 0; st < stages; ++st) {
        mbar_wait(&full[slot], phase);
        const uint8_t* box = smem + slot * slot_bytes;
        const uint32_t a_base = smem_addr(box);
        const uint64_t b_desc = smem_desc(box + g.a_slot, 16, 16 * g.kc, b_layout);
        int a = 0, ks = 0, dw = 0;
        for (int s = 0; s < steps; s += 2) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u == 1 && s + 1 == steps) break;
            const uint32_t off = (uint32_t)(pix0 + a * g.bx + dw) * pix_bytes + ks * 32 + half;
            if (u == 0)
              conv_step<NB, MTW>(d, fa, fb, a_base, off, a_swz, b_desc + ks * 2, g, a, dw);
            else
              conv_step<NB, MTW>(d, fb, fa, a_base, off, a_swz, b_desc + ks * 2, g, a, dw);
            if (++dw == g.kw) {
              dw = 0;
              if (++ks == ksteps) {
                ks = 0;
                ++a;
              }
            }
          }
        }
        wgmma_wait_group<0>();
        fence_frag(fa);
        fence_frag(fb);
#pragma unroll
        for (int r = 0; r < MTW; ++r) fence_acc(d[r]);
        if (lane == 0) mbar_arrive(&empty[slot]);
        if (++slot == g.stages) {
          slot = 0;
          phase ^= 1;
        }
      }

      // The epilogue, two M-tiles at a time. d[r][4j + 2e + c] is pixel 16 warp
      // + lane / 4 + 8e of M-tile r, output channel n0 + 8j + 2 (lane % 4) + c.
      const int frame = tl.b * g.Tn + tl.t;
#pragma unroll
      for (int r = 0; r < MTW; ++r) {
        if (r >= g.mtw) break;
        if (r % 2 == 0) {  // the last pair's stores have read the staging
          if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        }
        uint8_t* box = stg + (r % 2) * STG_TILE;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int ch = 8 * j + 2 * (lane % 4) + c;
            const float bv = tl.n0 + ch < g.cout ? bias[tl.n0 + ch] : 0.f;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int px = 16 * warp + lane / 4 + 8 * e;
              const uint32_t off = (uint32_t)((((px >> g.bw_log2) * NB + ch) << g.bw_log2) + (px & (g.bw - 1))) * 2;
              *reinterpret_cast<bf16*>(box + swizzle(off, y_swz)) = __float2bfloat16(d[r][4 * j + 2 * e + c] + bv);
            }
          }
        }
        if (r % 2 == 1 || r + 1 == g.mtw) {
          const int r0 = r - r % 2, n = r - r0 + 1;  // the pair's M-tiles
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
          const int row0 = tl.y0 + first_row + r0 * g.rpm;  // the pair's first output row
          if (threadIdx.x % 128 == 0) {
            for (int q = 0; q < n; ++q)
              if (row0 + q * g.rpm < g.H) tma_store_4d(&y_map, stg + q * STG_TILE, tl.x0, tl.n0, row0 + q * g.rpm, frame);
          }
          if (pooled != nullptr) {  // the pair's rows in twos, columns in twos (rows pair up inside it)
            const int H2 = g.H / 2, W2 = g.W / 2, half_cols = g.bw / 2, pair_rows = n * g.rpm / 2;
            for (int e = threadIdx.x % 128; e < NB * pair_rows * half_cols; e += 128) {
              const int pc = e % half_cols, pr = (e / half_cols) % pair_rows, ch = e / (half_cols * pair_rows);
              const int py = row0 / 2 + pr, pxo = tl.x0 / 2 + pc;
              if (tl.n0 + ch >= g.cout || py >= H2 || pxo >= W2) continue;
              float m = 0.f;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int row = 2 * pr + k / 2, col = 2 * pc + k % 2;  // the pair's row, a column of the tile
                const int q = row / g.rpm, rr = row % g.rpm;
                const uint32_t off = (uint32_t)(((rr * NB + ch) << g.bw_log2) + col) * 2;
                const float v = __bfloat162float(*reinterpret_cast<const bf16*>(stg + q * STG_TILE + swizzle(off, y_swz)));
                m = k == 0 ? v : fmaxf(m, v);
              }
              pooled[((size_t)frame * g.cout + tl.n0 + ch) * H2 * W2 + (size_t)py * W2 + pxo] = __float2bfloat16(m);
            }
          }
        }
      }
      __syncwarp();  // converged again before the next tile's wgmma (.aligned)
    }
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// wt[tap][co][k] = the weights of tap, output channel co and K column k: x1's
// channel k for k < c1, x2's channel k - cp1 for cp1 <= k < cp1 + c2, else 0.
__global__ void weights_kmajor_kernel(const bf16* __restrict__ w, bf16* __restrict__ wt, int taps, int c1,
                                      int c2, int cp1, int kp, int cout) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)taps * cout * kp) return;
  const int k = (int)(e % kp), co = (int)((e / kp) % cout), tap = (int)(e / ((long long)kp * cout));
  const int ci = k < cp1 ? (k < c1 ? k : -1) : (k - cp1 < c2 ? c1 + k - cp1 : -1);
  wt[e] = ci < 0 ? __float2bfloat16(0.f) : w[((size_t)tap * (c1 + c2) + ci) * cout + co];
}

template <int NB>
cudaError_t launch_kernel(const CUtensorMap& x1_map, const CUtensorMap& x2_map, const CUtensorMap& w_map,
                          const CUtensorMap& y_map, const float* bias, bf16* pooled, const Geometry& g, int blocks,
                          int smem, cudaStream_t s) {
  auto kernel = conv_wg_kernel<NB, max_mtw(NB)>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, s>>>(x1_map, x2_map, w_map, y_map, bias, pooled, g);
  return cudaGetLastError();
}

// The whole conv: the weights' re-layout, the channels-last copies, the
// products. x1: (frames, c1, H, W), x2: (frames, c2, H, W) or null with c2 =
// 0; w: (kt, kh, kw, c1 + c2, cout); y: (frames, cout, H, W); pooled: (frames,
// cout, H/2, W/2) or null. Scratch: xt1 (frames, H * W, cp1), xt2 (frames, H *
// W, cp2) or null, wt (kt * kh * kw, cout, cp1 + cp2), with cp = the source's
// channels rounded up to kc. Every pointer 16-byte aligned, W % 8 == 0
// (ops/conv3d.py:conv_wg_plan gives kc, nb, mtw, stages, blocks and smem).
inline cudaError_t launch(const bf16* x1, const bf16* x2, const bf16* w, const float* bias, bf16* y, bf16* pooled,
                          bf16* xt1, bf16* xt2, bf16* wt, int c1, int c2, int B, int Tn, int H, int W, int cout,
                          int kt, int kh, int kw, int kc, int nb, int mtw, int stages, int blocks, int smem,
                          cudaStream_t s) {
  if (W % 8 != 0 || (kc != 16 && kc != 32 && kc != 64)) return cudaErrorInvalidValue;
  if (nb != 64 && nb != 128) return cudaErrorInvalidValue;
  if (kw < 1 || kw % 2 == 0 || kw > MAX_K || mtw < 1 || mtw > max_mtw(nb)) return cudaErrorInvalidValue;
  if (stages < 2 || stages > MAX_STAGES || blocks < 1) return cudaErrorInvalidValue;
  if (c2 > 0 && (x2 == nullptr || xt2 == nullptr)) return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2) |
                          reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(xt1) |
                          reinterpret_cast<uintptr_t>(xt2) | reinterpret_cast<uintptr_t>(wt);
  if (align % 16 != 0) return cudaErrorInvalidValue;
  Geometry g;
  g.Tn = Tn;
  g.H = H;
  g.W = W;
  g.cout = cout;
  g.kt = kt;
  g.kh = kh;
  g.kw = kw;
  g.kc = kc;
  const int cp1 = (c1 + kc - 1) / kc * kc, cp2 = (c2 + kc - 1) / kc * kc;
  g.chunks1 = cp1 / kc;
  g.chunks = g.chunks1 + cp2 / kc;
  g.cp1 = cp1;
  g.bw = 64;
  while (g.bw > W) g.bw /= 2;
  g.bw_log2 = 31 - __builtin_clz(g.bw);
  g.rpm = MTILE / g.bw;
  g.bx = g.bw + kw - 1;
  g.mtw = mtw;
  g.rows = 2 * mtw * g.rpm;
  g.rx = g.rows + kh - 1;
  g.tiles_w = (W + g.bw - 1) / g.bw;
  g.tiles_h = (H + g.rows - 1) / g.rows;
  g.n_tiles = (cout + nb - 1) / nb;
  const long long tiles = (long long)B * Tn * g.tiles_h * g.tiles_w * g.n_tiles;
  if (tiles > 0x7fffffffLL || g.rx > 256) return cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  if (blocks > g.tiles) return cudaErrorInvalidValue;
  if (pooled != nullptr && (H % 2 || W % 2 || (g.rpm == 1 && mtw % 2))) return cudaErrorInvalidValue;
  g.stages = stages;
  g.a_slot = a_slot_bytes(kc, g.bx, g.rx);
  g.b_slot = b_slot_bytes(kc, nb, kh * kw);
  if (smem != conv_wg_smem_bytes(kc, nb, g.bx, g.rx, kh * kw, stages)) return cudaErrorInvalidValue;

  const int taps = kt * kh * kw, kp = cp1 + cp2;
  const long long n_w = (long long)taps * cout * kp;
  weights_kmajor_kernel<<<(unsigned)((n_w + 255) / 256), 256, 0, s>>>(w, wt, taps, c1, c2, cp1, kp, cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long P = (long long)H * W;
  err = channels_last::copy(x1, xt1, B * Tn, c1, cp1, P, s);
  if (err != cudaSuccess) return err;
  if (c2 > 0) {
    err = channels_last::copy(x2, xt2, B * Tn, c2, cp2, P, s);
    if (err != cudaSuccess) return err;
  }

  const CUtensorMapSwizzle k_swizzle = kc == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                       : kc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap x1_map, x2_map, w_map, y_map;
  // the copies: (cp, w, h, t, b), boxes of kc x bx x rx x 1 x 1
  for (int src = 0; src < (c2 > 0 ? 2 : 1); ++src) {
    const long long cp = src == 0 ? cp1 : cp2;
    const long long dims[5] = {cp, W, H, Tn, B};
    const long long strides[4] = {2 * cp, 2 * cp * W, 2 * cp * P, 2 * cp * P * Tn};
    const int box[5] = {kc, g.bx, g.rx, 1, 1};
    err = vvt_sm90::encode_map(src == 0 ? &x1_map : &x2_map, src == 0 ? xt1 : xt2, 5, dims, strides, box,
                               k_swizzle);
    if (err != cudaSuccess) return err;
  }
  if (c2 == 0) x2_map = x1_map;
  {  // the weights: (kp, cout, taps), boxes of kc x nb x (kh * kw)
    const long long dims[3] = {kp, cout, taps};
    const long long strides[2] = {2LL * kp, 2LL * kp * cout};
    const int box[3] = {kc, nb, kh * kw};
    err = vvt_sm90::encode_map(&w_map, wt, 3, dims, strides, box, k_swizzle);
    if (err != cudaSuccess) return err;
  }
  {  // the output: (w, cout, h, frames), boxes of bw x nb x rpm x 1, one M-tile
    const long long dims[4] = {W, cout, H, (long long)B * Tn};
    const long long strides[3] = {2 * P, 2LL * W, 2 * P * cout};
    const int box[4] = {g.bw, nb, g.rpm, 1};
    const CUtensorMapSwizzle y_swizzle = g.bw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : g.bw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                         : g.bw == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                      : CU_TENSOR_MAP_SWIZZLE_NONE;
    err = vvt_sm90::encode_map(&y_map, y, 4, dims, strides, box, y_swizzle);
    if (err != cudaSuccess) return err;
  }
  return nb == 64 ? launch_kernel<64>(x1_map, x2_map, w_map, y_map, bias, pooled, g, blocks, smem, s)
                  : launch_kernel<128>(x1_map, x2_map, w_map, y_map, bias, pooled, g, blocks, smem, s);
}

}  // namespace conv_wg
