// kt = 1 convolution as one tensor-core product per spatial tap: channels-first,
// stride 1, SAME zero padding, bias fused, over one source or the channel concat
// of two sources (never materialised), with an optional 2x2 max-pooled second
// output. bf16 in and out.
//
// Replaces: video_vae_tpu/ops/conv3d.py, _conv3d_tapdot_cf -> _tapdot_kernel.
// For each tap (dh, dw): W[dh, dw] (cout x cin) against the window shifted by
// the tap (cin x pixels), f32 accumulation over taps and channels, + the f32
// bias, one rounding to bf16; the pooled output is the 2x2 max of the f32 sums,
// rounded.
//
// What bounds it on the H100: with cin >= 128 the products are deep enough for
// the tensor cores (2 * cin * cout * kh * kw FLOPs a pixel against (cin + cout)
// * 2 bytes): the 128 -> 128 conv at 128^2 over 32 frames is 0.155 TFLOP
// (0.16 ms at the 989 TFLOP/s bf16 peak) over 0.27 GB (0.08 ms):
// operations-bound.
//
// What the design does about it: a warp-specialised, persistent implicit GEMM
// on wgmma fed by TMA, the structure of gemm_sm90.cuh (whose PTX helpers it
// uses as they are). For one frame, BM output channels and a tile of BN / 64
// image rows of 64 pixels:
//   D (BM x BN) = sum over taps (dh, dw) and 64-channel slabs of
//                 Wtap[co, ci] . X[ci, y + dh - kh/2, x + dw - kw/2]
// M = output channels, N = pixels, K = 64 input channels a slab, per tap.
//   - A, the weights, is K-major: the wrapper lays the (1, kh, kw, cin, cout)
//     kernel out as (kh * kw * cout, cin), the JAX wrapper's wmat; a 2-D
//     tensor map over it gives tap t's rows co0 .. co0 + BM - 1 at row
//     t * cout + co0. Rows past cout (the next tap's, or zeros) make rows of
//     D that are not stored.
//   - B, the input, is K-major too. TMA takes a box at any coordinate of an
//     outer dimension, but on the H100 a box whose innermost coordinate is
//     not 16-byte aligned stops the kernel (an illegal instruction): the
//     channels-first input cannot be shifted by one pixel along its rows.
//     So a first launch, channels_last_kernel (channels_last.cuh, shared
//     with the filter gradient's wgmma kernel), copies each source to
//     (frames, H, W, C) in a scratch buffer (the wrapper's), and the tap's
//     shift moves an outer coordinate: a 4-D tensor map over (C, W, H,
//     frames) with a box of 64 channels x 64 pixels x 1 row x 1 frame gives
//     one 8 KB panel of 64 pixel rows of 128 bytes, the A layout of
//     gemm_sm90.cuh. A tap's B is BN / 64 panels (image rows y0 + p + dh -
//     kh/2, columns from x0 + dw - kw/2); TMA fills zeros left of, right of,
//     above and below the frame (SAME padding), past a source's last channel
//     and past a ragged tile, so none of that needs code. Two sources take
//     x1's slabs, then x2's with the weights' K coordinate offset by c1: x1's
//     zero-filled channels past c1 meet x2's weight columns and add 0, and
//     the concat is never built. The copy costs a read and a write of the
//     input; it is the price of TMA here, and PERF.md has its time.
//   - The loads are what pace it: with one (A, B) slab a tap, a block
//     moved 48 KB from L2 for each 4.2 MFLOP product, and a copy of the
//     kernel without its products took 95 % of its time (PERF.md,
//     utils/kernel_phases.py --kernel 9). So the kh taps of a column shift dw
//     share one B group: the R + kh - 1 image rows y0 - kh/2 .. y0 + R - 1 +
//     kh/2 of a slab, loaded once, tap dh's B starting dh panels in. Two
//     rings: one of B groups (`b_stages` slots of R + kh - 1 panels) and one
//     of the weights' slabs (`a_stages` slots, one a tap), each on `full` /
//     `empty` mbarriers. One producer thread (warpgroup 2, setmaxnreg 40)
//     walks the block's tiles: for each dw and slab a B group, then its kh
//     weight slabs. Two consumer warpgroups (setmaxnreg 232) issue four
//     wgmma.mma_async m64nNk16 a tap. With BM = 128 each takes 64 channels
//     by all BN pixels; with BM = 64 (cout <= 64) both take the 64 channels,
//     each half the rows. A consumer keeps one tap's products in flight
//     (wgmma.wait_group 1) and frees the slot before it.
//   - The epilogue: the bias and one rounding in registers; each consumer
//     warpgroup writes its 64 channels x WG_N pixels to a staging tile of its
//     own in shared memory (128-byte swizzle, no bank conflicts) and one of
//     its threads hands it to TMA (cp.async.bulk.tensor store, which clips a
//     ragged tile) and goes on to the next tile: the stores overlap the next
//     tile's products, where stores from registers had taken 27-30 % of the
//     GEMM launch. A width TMA cannot describe (w % 8 != 0: its strides must
//     be multiples of 16 bytes) takes the second route the plan names, the
//     stores from registers: wgmma's f32 layout gives a lane two adjacent
//     pixels of a row, one 4-byte store. The pooled output always comes from
//     registers: the pixel below a lane's pair is 64 columns on, in the next
//     panel of the same lane's fragment, so the 2x2 pool is a max over four
//     registers.
// No split-K and no atomics: two launches on the same inputs give the same
// bits. The tile, the rings' depths and the grid come from
// ops/conv3d.py:tapdot_plan, which tests/test_torch_tapdot_plan.py walks on
// the CPU; the entry point checks the shared memory against
// tapdot_smem_bytes. Not tried: sharing the kw shifts of a row as well (a B
// operand starting mid-swizzle, at a pixel row not a multiple of 8), and a
// transposition in shared memory in place of the copy.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "channels_last.cuh"
#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vvt_sm90::SMEM_ALIGN;

constexpr int TD_BK = 64;      // input channels a slab: one 128-byte swizzle row
constexpr int TD_PANEL = 64;   // pixels of a B panel: one image row segment
constexpr int TD_PANEL_BYTES = TD_PANEL * TD_BK * 2;
constexpr int TD_THREADS = 384;  // two consumer warpgroups and a producer
constexpr int TD_MAX_STAGES = 6;
constexpr int MAX_K = 7;  // largest kh / kw

// The output staging tile of a consumer warpgroup: 64 channels x wg_n pixels.
__host__ __device__ constexpr int staging_bytes(int bm, int bn) {
  return 64 * (bm == 128 ? bn : bn / 2) * 2;
}

// Dynamic shared memory of one block: alignment slack, the ring of weight
// slabs, the ring of B groups (bn / 64 + kh - 1 panels each), the two
// warpgroups' staging tiles, a full and an empty mbarrier a slot.
// ops/conv3d.py's tapdot_smem mirrors it.
__host__ __device__ constexpr int tapdot_smem_bytes(int bm, int bn, int kh, int a_stages,
                                                    int b_stages) {
  return SMEM_ALIGN + a_stages * bm * TD_BK * 2 + b_stages * (bn / TD_PANEL + kh - 1) * TD_PANEL_BYTES +
         2 * staging_bytes(bm, bn) + (a_stages + b_stages) * 2 * 8;
}

// One box of a 4-D tensor map from shared memory (the bulk async group of
// this thread); elements past the tensor's edges are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(vvt_sm90::smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// A ring's slot and the parity of its current phase.
struct Ring {
  int slot = 0, n;
  uint32_t phase = 0;
  __device__ explicit Ring(int slots) : n(slots) {}
  __device__ void next() {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// ---- the implicit GEMM ---------------------------------------------------------

// d (64 x N per warpgroup, f32) += A (64 x 16, K-major) . B (16 x N, K-major):
// gemm_sm90.cuh's Wgmma with B's transpose bit clear.
#define TD_ACC8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <int N>
struct WgmmaKK;

template <>
struct WgmmaKK<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : TD_ACC8(0), TD_ACC8(8), TD_ACC8(16), TD_ACC8(24), TD_ACC8(32), TD_ACC8(40),
          TD_ACC8(48), TD_ACC8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaKK<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n"
        "}\n"
        : TD_ACC8(0), TD_ACC8(8), TD_ACC8(16), TD_ACC8(24), TD_ACC8(32), TD_ACC8(40),
          TD_ACC8(48), TD_ACC8(56), TD_ACC8(64), TD_ACC8(72), TD_ACC8(80), TD_ACC8(88),
          TD_ACC8(96), TD_ACC8(104), TD_ACC8(112), TD_ACC8(120)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef TD_ACC8

struct Geometry {
  int c1, slabs1, slabs;  // x1's channels and slabs; then x2's slabs: slabs in all
  int H, W, cout, kh, kw;
  int tiles_w, tiles_h, co_tiles, tiles;
};

// tile -> (frame, first row, first column, first output channel); the
// output-channel tile fastest, then the column tile, then the row tile
struct Tile {
  int frame, y0, x0, co0;
};
template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(const Geometry& g, int t) {
  Tile r;
  r.co0 = (t % g.co_tiles) * BM;
  t /= g.co_tiles;
  r.x0 = (t % g.tiles_w) * TD_PANEL;
  t /= g.tiles_w;
  r.y0 = (t % g.tiles_h) * (BN / TD_PANEL);
  r.frame = t / g.tiles_h;
  return r;
}

template <int BM, int BN>
__global__ void __launch_bounds__(TD_THREADS, 1)
tapdot_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap x1_map,
              const __grid_constant__ CUtensorMap x2_map, const __grid_constant__ CUtensorMap y_map,
              const float* __restrict__ bias, bf16* __restrict__ y, bf16* __restrict__ pooled,
              const Geometry g, int a_stages, int b_stages, int tma_y) {
  using namespace vvt_sm90;
  constexpr int A_BYTES = BM * TD_BK * 2;
  constexpr int ROWS = BN / TD_PANEL;            // image rows of a tile
  constexpr int WG_N = BM == 128 ? BN : BN / 2;  // pixels a consumer warpgroup owns
  constexpr int ACC = WG_N / 2;                  // f32 accumulators a thread: 64 x WG_N over 128
  static_assert(WG_N % (2 * TD_PANEL) == 0, "a warpgroup owns whole pairs of rows (the pool)");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) & ~uintptr_t(SMEM_ALIGN - 1));
  const int panels = ROWS + g.kh - 1;  // a B group: the tile's rows and the taps' halo
  const int b_bytes = panels * TD_PANEL_BYTES;
  constexpr int STG_BYTES = staging_bytes(BM, BN);
  uint8_t* a_ring = smem;
  uint8_t* b_ring = smem + a_stages * A_BYTES;
  uint8_t* staging = b_ring + b_stages * b_bytes;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(staging + 2 * STG_BYTES);
  uint64_t* a_empty = a_full + a_stages;
  uint64_t* b_full = a_empty + a_stages;
  uint64_t* b_empty = b_full + b_stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a_stages; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], CONSUMER_WARPGROUPS * 4);
    }
    for (int s = 0; s < b_stages; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], CONSUMER_WARPGROUPS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int groups = g.kw * g.slabs;  // a tile's B groups, dw-major
  const int wg = threadIdx.x / 128;

  if (wg == CONSUMER_WARPGROUPS) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 128 * CONSUMER_WARPGROUPS) {
      Ring a(a_stages), b(b_stages);
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const Tile tl = tile_at<BM, BN>(g, t);
        for (int grp = 0; grp < groups; ++grp) {
          const int dw = grp / g.slabs, s = grp % g.slabs;
          const bool first = s < g.slabs1;
          const int ci0 = (first ? s : s - g.slabs1) * TD_BK;
          const int x = tl.x0 + dw - g.kw / 2, y = tl.y0 - g.kh / 2;
          uint8_t* b_dst = b_ring + b.slot * b_bytes;
          mbar_wait(&b_empty[b.slot], b.phase ^ 1);
          mbar_expect_tx(&b_full[b.slot], b_bytes);
          for (int q = 0; q < panels; ++q) {
            if (first)
              tma_load_4d(b_dst + q * TD_PANEL_BYTES, &x1_map, &b_full[b.slot], ci0, x, y + q, tl.frame);
            else
              tma_load_4d(b_dst + q * TD_PANEL_BYTES, &x2_map, &b_full[b.slot], ci0, x, y + q, tl.frame);
          }
          b.next();
          for (int dh = 0; dh < g.kh; ++dh) {
            mbar_wait(&a_empty[a.slot], a.phase ^ 1);
            mbar_expect_tx(&a_full[a.slot], A_BYTES);
            // the weights' K column: x2's channels follow x1's
            tma_load_2d(a_ring + a.slot * A_BYTES, &a_map, &a_full[a.slot], first ? ci0 : g.c1 + ci0,
                        (dh * g.kw + dw) * g.cout + tl.co0);
            a.next();
          }
        }
      }
    }
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    // this warpgroup's A rows and first B panel
    const int a_off = BM == 128 ? wg * 64 * TD_BK * 2 : 0;
    const int b_off = BM == 128 ? 0 : wg * (WG_N / TD_PANEL) * TD_PANEL_BYTES;
    Ring a(a_stages), b(b_stages);
    float d[ACC];
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const Tile tl = tile_at<BM, BN>(g, t);
#pragma unroll
      for (int i = 0; i < ACC; ++i) d[i] = 0.f;
      // the slots whose products may still be in flight (the last commit's);
      // a B group's slot is held from its last tap's commit to the next one's
      int held_a = -1, held_b = -1;
      for (int grp = 0; grp < groups; ++grp) {
        mbar_wait(&b_full[b.slot], b.phase);
        const uint8_t* b_grp = b_ring + b.slot * b_bytes + b_off;
        for (int dh = 0; dh < g.kh; ++dh) {
          mbar_wait(&a_full[a.slot], a.phase);
          __syncwarp();
          // A and B both K-major: 8-row groups 1024 bytes apart, a k16 step
          // 32 bytes along the swizzled 128-byte rows; tap dh's B starts dh
          // panels into the group.
          const uint64_t a_desc = smem_desc(a_ring + a.slot * A_BYTES + a_off, 16, 1024);
          const uint64_t b_desc = smem_desc(b_grp + dh * TD_PANEL_BYTES, 16, 1024);
          fence_acc(d);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TD_BK / 16; ++kk)
            WgmmaKK<WG_N>::mma(d, a_desc + (kk * 32 >> 4), b_desc + (kk * 32 >> 4));
          wgmma_commit();
          wgmma_wait_group<1>();  // the tap before this one is done with
          fence_acc(d);
          if (lane == 0) {
            if (held_a >= 0) mbar_arrive(&a_empty[held_a]);
            if (held_b >= 0) mbar_arrive(&b_empty[held_b]);
          }
          held_a = a.slot;
          held_b = -1;
          a.next();
        }
        held_b = b.slot;
        b.next();
      }
      wgmma_wait_group<0>();
      fence_acc(d);
      if (lane == 0) {
        if (held_a >= 0) mbar_arrive(&a_empty[held_a]);
        if (held_b >= 0) mbar_arrive(&b_empty[held_b]);
      }

      // The epilogue. d[4j + 2e + c] is row 16 * warp + lane / 4 + 8e (an
      // output channel), column 8j + 2 (lane % 4) + c of this warpgroup's
      // 64 x WG_N; column n is pixel n % 64 of the tile's image row n / 64.
      const int m = (BM == 128 ? wg * 64 : 0) + warp * 16 + lane / 4;
      const int n0 = (BM == 128 ? 0 : wg * WG_N) + 2 * (lane % 4);
      int co[2];
      float bv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        co[e] = tl.co0 + m + 8 * e;
        bv[e] = co[e] < g.cout ? bias[co[e]] : 0.f;
      }
      const bool vec = g.W % 2 == 0;  // a lane's pixel pair is one aligned 4-byte word
      const size_t plane = (size_t)g.H * g.W;
      // the staging tile: line (row r, channel c) at (64 r + c) * 128 bytes, its
      // 16-byte units swizzled by c % 8 = lane / 4
      uint8_t* stg = staging + wg * STG_BYTES;
      if (tma_y) {
        if (threadIdx.x % 128 == 0)  // this warpgroup's last store has read its staging
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      }
#pragma unroll
      for (int j = 0; j < WG_N / 8; ++j) {
        const int n = n0 + 8 * j;
        const int yy = tl.y0 + n / TD_PANEL, xx = tl.x0 + n % TD_PANEL;
        const bool inside = yy < g.H && xx < g.W;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v0 = d[4 * j + 2 * e] + bv[e], v1 = d[4 * j + 2 * e + 1] + bv[e];
          if (tma_y) {
            const int line = (j / 8) * 64 + warp * 16 + lane / 4 + 8 * e;
            *reinterpret_cast<unsigned*>(stg + line * 128 + (((j % 8) ^ (lane / 4)) << 4) + (lane % 4) * 4) =
                pack2(v0, v1);
          } else if (inside && co[e] < g.cout) {
            bf16* dst = y + ((size_t)tl.frame * g.cout + co[e]) * plane + (size_t)yy * g.W + xx;
            if (vec) {
              *reinterpret_cast<unsigned*>(dst) = pack2(v0, v1);
            } else {
              dst[0] = __float2bfloat16(v0);
              if (xx + 1 < g.W) dst[1] = __float2bfloat16(v1);
            }
          }
        }
        // the pooled output: rows n / 64 and n / 64 + 1 (even first row; H and
        // W are even here, so the whole 2 x 2 window is inside the frame)
        if (pooled != nullptr && inside && (j / (TD_PANEL / 8)) % 2 == 0) {
          const int jb = j + TD_PANEL / 8;
          const int H2 = g.H / 2, W2 = g.W / 2;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (co[e] >= g.cout) continue;
            const float mx = fmaxf(fmaxf(d[4 * j + 2 * e], d[4 * j + 2 * e + 1]),
                                   fmaxf(d[4 * jb + 2 * e], d[4 * jb + 2 * e + 1]));
            pooled[((size_t)tl.frame * g.cout + co[e]) * H2 * W2 + (size_t)(yy / 2) * W2 + xx / 2] =
                __float2bfloat16(mx + bv[e]);
          }
        }
      }
      if (tma_y) {  // the staging tile to TMA: channels and rows past the edges are clipped
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        if (threadIdx.x % 128 == 0)
          tma_store_4d(&y_map, stg, tl.x0, tl.co0 + (BM == 128 ? 64 * wg : 0),
                       tl.y0 + (BM == 128 ? 0 : wg * (WG_N / TD_PANEL)), tl.frame);
      }
      __syncwarp();  // converged again before the next tile's wgmma (.aligned)
    }
    if (tma_y && threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// The output (frames, cout, H, W) as a 4-D tensor map over (W, cout, H, frames),
// so that a box of 64 pixels x 64 channels x `rows` rows lands as the staging
// tile's lines: 128-byte swizzle, W % 8 == 0.
cudaError_t encode_output(CUtensorMap* map, bf16* y, int frames, int cout, int Hh, int Ww, int rows) {
  const vvt_sm90::EncodeTiledFn encode = vvt_sm90::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)Ww, (cuuint64_t)cout, (cuuint64_t)Hh, (cuuint64_t)frames};
  const cuuint64_t strides[3] = {(cuuint64_t)Hh * Ww * 2, (cuuint64_t)Ww * 2, (cuuint64_t)cout * Hh * Ww * 2};
  const cuuint32_t box[4] = {TD_PANEL, 64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, y, dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BM, int BN>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& x1_map, const CUtensorMap& x2_map,
                   const float* bias, bf16* y, bf16* pooled, const Geometry& g, int frames,
                   int a_stages, int b_stages, int blocks, int tma_y, int smem, cudaStream_t stream) {
  constexpr int WG_N = BM == 128 ? BN : BN / 2;
  CUtensorMap y_map = a_map;  // unused by the stores from registers
  if (tma_y) {
    const cudaError_t err = encode_output(&y_map, y, frames, g.cout, g.H, g.W, WG_N / TD_PANEL);
    if (err != cudaSuccess) return err;
  }
  auto kernel = tapdot_kernel<BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, TD_THREADS, smem, stream>>>(a_map, x1_map, x2_map, y_map, bias, y, pooled, g,
                                              a_stages, b_stages, tma_y);
  return cudaGetLastError();
}

}  // namespace

// x1: (frames, c1, H, W) bf16; x2: (frames, c2, H, W) bf16 or null with c2 = 0;
// wmat: (kh * kw * cout, c1 + c2) bf16, tap-major (row t * cout + co is tap t's
// weights of output channel co); bias: (cout,) f32; y: (frames, cout, H, W)
// bf16; pooled: (frames, cout, H/2, W/2) bf16 or null; xt1, xt2: scratch of
// x1's and x2's size (x2's null with it), the channels-last copies. c1, c2
// and cout multiples of 8; kh, kw odd, at most 7; H and W even when pooled is
// given. Every pointer 16-byte aligned. The plan (ops/conv3d.py:tapdot_plan):
// bm x bn tiles (128 x 128, 128 x 256 or 64 x 256), `a_stages` weight slots,
// `b_stages` B group slots, `blocks` persistent blocks, tma_y = 1 to store y
// through TMA (W % 8 == 0) or 0 from registers, smem =
// tapdot_smem_bytes(bm, bn, kh, a_stages, b_stages).
extern "C" int vvt_conv3d_tapdot(const void* x1, const void* x2, int c1, int c2, const void* wmat,
                                 const void* bias, void* y, void* pooled, void* xt1, void* xt2,
                                 int frames, int Hh, int Ww, int cout, int kh, int kw, int bm,
                                 int bn, int a_stages, int b_stages, int blocks, int tma_y, int smem,
                                 void* stream) {
  const int cin = c1 + c2;
  if (frames < 1 || frames > 65535 || Hh < 1 || Ww < 1 || c1 < 1 || c2 < 0 || cout < 8)
    return (int)cudaErrorInvalidValue;
  if (c1 % 8 || c2 % 8 || cout % 8 || (c2 > 0 && (x2 == nullptr || xt2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (kh < 1 || kh % 2 == 0 || kh > MAX_K || kw < 1 || kw % 2 == 0 || kw > MAX_K)
    return (int)cudaErrorInvalidValue;
  if (pooled != nullptr && (Hh % 2 || Ww % 2)) return (int)cudaErrorInvalidValue;
  if (!((bm == 128 && (bn == 128 || bn == 256)) || (bm == 64 && bn == 256)))
    return (int)cudaErrorInvalidValue;
  if (a_stages < 2 || a_stages > TD_MAX_STAGES || b_stages < 2 || b_stages > TD_MAX_STAGES ||
      blocks < 1 || smem != tapdot_smem_bytes(bm, bn, kh, a_stages, b_stages))
    return (int)cudaErrorInvalidValue;
  if (tma_y && Ww % 8) return (int)cudaErrorInvalidValue;
  const long long P = (long long)Hh * Ww;
  if (P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  Geometry g;
  g.c1 = c1;
  g.slabs1 = (c1 + TD_BK - 1) / TD_BK;
  g.slabs = g.slabs1 + (c2 + TD_BK - 1) / TD_BK;
  g.H = Hh;
  g.W = Ww;
  g.cout = cout;
  g.kh = kh;
  g.kw = kw;
  g.tiles_w = (Ww + TD_PANEL - 1) / TD_PANEL;
  g.tiles_h = (Hh + bn / TD_PANEL - 1) / (bn / TD_PANEL);
  g.co_tiles = (cout + bm - 1) / bm;
  const long long tiles = (long long)frames * g.tiles_h * g.tiles_w * g.co_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap a_map, x1_map, x2_map;
  cudaError_t err = vvt_sm90::encode_2d(&a_map, static_cast<const bf16*>(wmat),
                                        (long long)kh * kw * cout, cin, bm, TD_BK);
  if (err != cudaSuccess) return (int)err;
  const int box[4] = {TD_BK, TD_PANEL, 1, 1};
  const long long dims1[4] = {c1, Ww, Hh, frames};
  err = vvt_sm90::encode_4d(&x1_map, static_cast<const bf16*>(xt1), dims1, box);
  if (err != cudaSuccess) return (int)err;
  err = channels_last::copy(static_cast<const bf16*>(x1), static_cast<bf16*>(xt1), frames, c1, c1, P, s);
  if (err != cudaSuccess) return (int)err;
  x2_map = x1_map;
  if (c2 > 0) {
    const long long dims2[4] = {c2, Ww, Hh, frames};
    err = vvt_sm90::encode_4d(&x2_map, static_cast<const bf16*>(xt2), dims2, box);
    if (err != cudaSuccess) return (int)err;
    err = channels_last::copy(static_cast<const bf16*>(x2), static_cast<bf16*>(xt2), frames, c2, c2, P, s);
    if (err != cudaSuccess) return (int)err;
  }
  const float* b = static_cast<const float*>(bias);
  bf16* out = static_cast<bf16*>(y);
  bf16* pool = static_cast<bf16*>(pooled);
  if (bm == 64)
    err = launch<64, 256>(a_map, x1_map, x2_map, b, out, pool, g, frames, a_stages, b_stages, blocks,
                          tma_y, smem, s);
  else if (bn == 128)
    err = launch<128, 128>(a_map, x1_map, x2_map, b, out, pool, g, frames, a_stages, b_stages, blocks,
                           tma_y, smem, s);
  else
    err = launch<128, 256>(a_map, x1_map, x2_map, b, out, pool, g, frames, a_stages, b_stages, blocks,
                           tma_y, smem, s);
  return (int)err;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
