// The tile variant of the fused attention backward (#3, fused_attention_bwd.cu)
// on Hopper's warpgroup tensor cores, for 64 < S <= TILE_MAX_SEQ = 256 at head
// dims 64 and 128: wgmma fed by TMA, one launch, no atomics, no workspace. It
// replaces the mma.sync tile block (attention_bwd_kernel<D, KT, true> in
// fused_attention_bwd_mma.cuh and, at D = 128, a kernel over bwd::wide_tile_bwd,
// which #6 keeps), which issued about one mma.sync per 7 cycles an SM. Head
// dims 16 and 32 keep it: their 32- and 64-byte rows are below the 128-byte
// swizzle span that every tile, descriptor and transpose read here is laid
// out on. The plan picks by (S, D) alone (ops/flash_attention.py:
// fused_attention_bwd_plan, variant "tile_wg").
//
// What bounds it on the H100: the products on paper. At the flagship's spatial
// call (S = 256, 8 heads of 64, b2 x 16f: 256 pairs) the backward is 5 products
// of S^2 D a pair (21 GFLOP, 21 us at the 989 TFLOP/s bf16 peak); this design
// runs 9, as the split variant does (attention_split_bwd.cuh), so that every
// gradient has one owner and one order: 38 GFLOP. Measured (utils/kernel_phases.py
// --kernel 3, PERF.md), the elementwise work paces it: the softmax and its exps,
// and above all the epilogues (the LN + RoPE backward of every row).
//
// One block a (sequence, head) pair, since a pair's rows fit on chip: two
// consumer warpgroups (setmaxnreg 232) and a producer warpgroup (setmaxnreg 40)
// whose one thread loads with TMA from two 3-D tensor maps, the fused qkv as
// (3 H D columns, S, B) and dO as (H D, S, B), boxes of 64 rows by 64 columns
// (128 bytes, the 128-byte swizzle; D = 128 takes two a tile); a row past S
// reads as zeros. Resident in shared memory, in 64-row tiles: the raw q and k
// rows, which the consumers turn into q~ and k~ in place (LN, scale, RoPE,
// rounded to bf16: norm_rope_own_q of attention_split_fwd.cuh, whose lanes
// hold each 16-byte chunk with its rotate-half partner under the swizzle, so
// q and k take the same code); at D = 64 also v and dO (4 x 32 KB at S =
// 256). At D = 128 (4 x 64 KB would not fit) v and dO stream: each
// warpgroup's own 64-row tile of the side's A operand (dO on the query side,
// v on the key side) in a buffer of its own, and the walked operand (v, then
// dO) through a ring of STAGES tiles that both warpgroups read in step.
//
// The 64-row tiles are dealt to the warpgroups in rounds (tile 2 r + w to
// warpgroup w), on each side:
//   query side: S = q~ k~^T and dP = dO v^T by wgmma over key tiles of
//     KEY_TILE<D> keys (128 at D = 64, 64 at 128), walked twice: the first
//     walk gives each row's max m, sum l and rs = sum_j exp(s - m) dP online,
//     the second P, dS = P (dP - row) / sqrt(D) and dq~ += dS k~, dS rounded
//     to bf16 from the accumulators as the register A operand and k~ read
//     MN-major (the transpose bit). The rows' (m, 1/l, row) go to shared
//     memory.
//   key side, after a barrier of the consumers: S^T = k~ q~^T and dP^T = v
//     dO^T over each 64-query tile, P^T and dS^T in f32 from the statistics,
//     dv += P^T dO and dk~ += dS^T q~ (P^T, dS^T rounded to bf16, dO and q~
//     MN-major); dv rounded into dqkv.
// After each walk, the epilogue: dq~ or dk~ back through RoPE, the scale and
// the LN into dqkv, straight from the accumulators (wgmma's layout is
// mma.sync's for each warp's 16 rows). At D = 64 it reads the tile's raw x
// rows and their cos and sin rows from shared memory, where the producer put
// them by TMA while the walk ran (a staging a warpgroup, filled for its next
// epilogue once it freed it); at 128, with no room for that, from device
// memory (bwd::ln_rope_bwd_acc). At D = 64 a warpgroup's own rows are register
// A fragments of the score products (ldmatrix through the swizzle), at 128
// they stay in shared memory, as in the split variant. Each warp sums its
// rows' dln xn of each scale in a fixed order into its own (2, D) partial; the
// block adds the 8 warps' in order and writes one (D,) row of each, summed by
// the wrapper.
//
// Roundings as the mma.sync tile block's (fused_attention_bwd.cu): q~, k~, P and dS
// in bf16, everything else f32, dqkv rounded once; its sums run in another
// order, so its bits differ from that block's within the same tolerance. Its exps
// are the MUFU's alone (exp2_ftz: a P below 2^-126, which no bf16 sum can
// feel, flushes to 0). Masks: a masked key scores -1e30 (NEG_INF), a key past
// S -inf, so a row whose keys are all masked spreads P over all S keys and a
// key past S adds exactly 0; a query past S reads zero q~, dO and statistics,
// so its P and dS are 0; no row at or past S is written. At D = 64 and 128 <
// S <= 192 the last 128-key tile reaches one 64-row tile past the loaded
// ones: the consumers zero it in k~ and v first.
//
// Shared memory (1 KB alignment slack, then; R = the resident rows, S rounded
// up to KEY_TILE<D>):
//   D = 64:  q~ | k~ | v | dO [R x 64] | staging [2][x 64 x 64 bf16 | cos, sin 64 x 64 f32]
//            | m | 1/l | row [R] f32 | partials [8 warps][2][D] f32 | 6 mbarriers
//   D = 128: q~ | k~ [R x 128] | own [2][64 x 128] | ring [STAGES][64 x 128] | m | 1/l | row | partials
//            | 11 mbarriers
// 216 KB at D = 64 and 220 KB at 128 (S = 256): one block an SM (384 threads).
// tests/helpers/tile_wg_geometry.py mirrors these sizes and the dealing.

#pragma once

#include "attention_split_fwd.cuh"
#include "fused_attention_bwd_mma.cuh"

namespace fa_mma {
namespace tile_wg {

using split_wg::ALIGN;
using split_wg::CONSUMER_REGS;
using split_wg::CONSUMERS;
using split_wg::exp2_ftz;  // the exps of P: the MUFU alone (a P below 2^-126 flushes to 0)
using split_wg::fence_regs;
using split_wg::Keep;
using split_wg::KeyBits;
using split_wg::PRODUCER_REGS;
using vvt_sm90::fence_acc;
using vvt_sm90::mbar_arrive;
using vvt_sm90::mbar_expect_tx;
using vvt_sm90::mbar_init;
using vvt_sm90::mbar_wait;
using vvt_sm90::wgmma_commit;
using vvt_sm90::wgmma_fence;
using vvt_sm90::wgmma_wait_group;

template <int D> using OwnFrags = split_wg::OwnFrags<D>;

constexpr int ROWS = split_wg::WG_ROWS;    // a tile: one warpgroup's 64 rows
constexpr int THREADS = split_wg::THREADS;  // the consumers, then the producer
constexpr int WARPS = split_wg::WARPS;      // the plan's warps (ops/flash_attention.py)
constexpr int STAGES = 3;                   // ring stages at D = 128
constexpr int CONSUMER_BAR = 1;             // named barrier of the two consumer warpgroups
template <int D> constexpr bool STREAM = D == 128;  // v and dO stream through the own buffers and the ring
template <int D> constexpr int KT = split_wg::KEY_TILE<D>;           // keys a query-side step takes
template <int D> constexpr int TB = split_wg::TILE_BYTES<D, ROWS>;   // bytes of a 64-row tile

__host__ __device__ __forceinline__ int tiles_of(int S) { return (S + ROWS - 1) / ROWS; }
template <int D>
__host__ __device__ __forceinline__ int key_tiles(int S) { return (S + KT<D> - 1) / KT<D>; }
// 64-row tiles of each resident array: the query side's key tiles cover them whole
template <int D>
__host__ __device__ __forceinline__ int resident_tiles(int S) { return key_tiles<D>(S) * (KT<D> / ROWS); }

// D = 64: a warpgroup's epilogue staging, the raw x rows of its tile (bf16, one 64-row
// tile) and their cos and sin rows (f32, two 64-row tiles each)
template <int D> constexpr int EPI_BYTES = STREAM<D> ? 0 : 5 * TB<D>;
constexpr int TABLE_COLS = 32;  // f32 columns of a table box: 128 bytes, the swizzle span

// Byte offsets from the 1 KB aligned base, and the bytes a block asks for.
struct Layout {
  size_t q, k, v, g, epi, own, ring, stats, red, bars, bytes;
};

template <int D>
__host__ __device__ __forceinline__ Layout layout(int S) {
  const size_t arr = (size_t)resident_tiles<D>(S) * TB<D>, rows = (size_t)resident_tiles<D>(S) * ROWS;
  Layout L{};
  L.q = 0;
  L.k = arr;
  if (STREAM<D>) {
    L.own = 2 * arr;
    L.ring = L.own + (size_t)CONSUMERS * TB<D>;
    L.stats = L.ring + (size_t)STAGES * TB<D>;
  } else {
    L.v = 2 * arr;
    L.g = 3 * arr;
    L.epi = 4 * arr;
    L.stats = L.epi + (size_t)CONSUMERS * EPI_BYTES<D>;
  }
  L.red = L.stats + 3 * rows * sizeof(float);
  L.bars = L.red + (size_t)4 * CONSUMERS * 2 * D * sizeof(float);
  L.bytes = ALIGN + L.bars + (1 + 2 * CONSUMERS + (STREAM<D> ? 2 * STAGES : 1)) * sizeof(uint64_t);
  return L;
}
static_assert(split_wg::OWN_IN_REGS<64> && !split_wg::OWN_IN_REGS<128>, "own rows as the split variant keeps them");

struct Maps {
  CUtensorMap qkv, g;  // (3 H D, S, B) and (H D, S, B), boxes of 64 rows x 64 columns
  CUtensorMap cos, sin;  // D = 64: (D, S) f32, boxes of 64 rows x 32 columns
};

// One key-side step over a 64-query tile (q~ and dO rows, their statistics sm, si,
// sr): S^T = k~ q~^T and dP^T = v dO^T, P^T normalised and dS^T in f32, then dv +=
// P^T . dO and dk~ += dS^T . q~ with P^T and dS^T rounded to bf16 as the register A
// operand and dO and q~ read MN-major (the transpose bit).
template <int D>
__device__ __forceinline__ void key_step(float (&dv)[D / 2], float (&dk)[D / 2], const uint8_t* k_tile,
                                         const uint8_t* v_tile, const OwnFrags<D>& kf, const OwnFrags<D>& vf,
                                         const uint8_t* q_tile, const uint8_t* do_tile, const float* sm,
                                         const float* si, const float* sr, const bool (&masked)[2],
                                         const HeadScale& hs) {
  constexpr int N = ROWS;
  const int t = threadIdx.x & 3;
  float s[N / 2], dp[N / 2];
  wgmma_fence();
  split_wg::scores<D, N>(s, k_tile, kf, q_tile);  // S^T: keys by queries
  wgmma_commit();
  split_wg::scores<D, N>(dp, v_tile, vf, do_tile);  // dP^T
  wgmma_commit();
  wgmma_wait_group<1>();
  fence_acc(s);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {  // P^T, normalised, f32: columns 8 j + 2 t, + 1 are queries
    const float2 mi = *reinterpret_cast<const float2*>(sm + 8 * j + 2 * t);
    const float2 inv = *reinterpret_cast<const float2*>(si + 8 * j + 2 * t);
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      float& p0 = s[4 * j + 2 * r2];
      float& p1 = s[4 * j + 2 * r2 + 1];
      p0 = exp2_ftz(((masked[r2] ? NEG_INF : p0) - mi.x) * hs.c) * inv.x;
      p1 = exp2_ftz(((masked[r2] ? NEG_INF : p1) - mi.y) * hs.c) * inv.y;
    }
  }
  wgmma_wait_group<0>();
  fence_acc(dp);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {  // dS^T, f32
    const float2 rw = *reinterpret_cast<const float2*>(sr + 8 * j + 2 * t);
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      dp[4 * j + 2 * r2] = s[4 * j + 2 * r2] * (dp[4 * j + 2 * r2] - rw.x) * hs.scale;
      dp[4 * j + 2 * r2 + 1] = s[4 * j + 2 * r2 + 1] * (dp[4 * j + 2 * r2 + 1] - rw.y) * hs.scale;
    }
  }
  uint32_t pa[N / 16][4], da[N / 16][4];
  split_wg::pack_frags<N>(pa, s);
  split_wg::pack_frags<N>(da, dp);
  wgmma_fence();
  split_wg::mma_rows<D, N>(dv, pa, do_tile);  // dv += P^T (bf16) . dO
  split_wg::mma_rows<D, N>(dk, da, q_tile);   // dk~ += dS^T (bf16) . q~
  wgmma_commit();
  wgmma_wait_group<0>();
  fence_acc(dv);
  fence_acc(dk);
  fence_regs(pa);
  fence_regs(da);
}

// bwd::ln_rope_bwd_acc's arithmetic, in its order, for a warp's 16 rows of a tile
// (rows row0 + 16 warp + g (+ 8)) from their f32 accumulators (wgmma's layout) and
// the tile's staging in shared memory, which TMA filled while the walk ran: the raw x
// rows (one swizzled 64-row tile, as the products' tiles) and their cos and sin rows
// (64 rows x 32 f32 a box, 128-byte swizzle: 16-byte chunk c of row r at c ^ (r % 8)).
template <int D>
__device__ __forceinline__ void epilogue_staged(const float (&du)[D / 2], const uint8_t* stage, bf16* __restrict__ dst,
                                                size_t stride, int row0, int S, const float* __restrict__ scale,
                                                float* red, float inv_d) {
  constexpr int NT = D / 8, HT = D / 16;  // column groups of a row, of its first half
  constexpr int BOX = ROWS * 128;          // a table box's bytes
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3, g = lane >> 2;
  const uint8_t* x_tile = stage;
  const uint8_t* c_tile = stage + TB<D>;
  const uint8_t* s_tile = stage + 3 * TB<D>;
  // a table entry at column 8 nt + 2 t (and + 1) of tile row rl
  auto table = [&](const uint8_t* tab, int rl, int nt) {
    const int chunk = 2 * (nt % 4) + (t >> 1);
    return *reinterpret_cast<const float2*>(tab + (nt / 4) * BOX + rl * 128 + ((chunk ^ (rl & 7)) << 4) + (t & 1) * 8);
  };
  float2 sc[NT];  // the scale at the lane's columns
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) sc[nt] = __ldg(reinterpret_cast<const float2*>(scale + 8 * nt + 2 * t));
  float part[NT][2];  // the sum over the lane's rows of dln xn at its columns
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) part[nt][0] = part[nt][1] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = 16 * warp + g + 8 * r, i = row0 + rl;
    const bool live = i < S;
    float xn[NT][2], dxn[NT][2], s = 0.f, sq = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          x_tile + (nt / 8) * split_wg::PANEL_BYTES<ROWS> + rl * 128 + (((nt % 8) ^ (rl & 7)) << 4) + 4 * t));
      xn[nt][0] = x.x, xn[nt][1] = x.y;
      s += x.x + x.y;
      sq += x.x * x.x + x.y * x.y;
    }
    const float mean = quad_sum(s) * inv_d;
    const float rstd = rsqrtf(fmaxf(quad_sum(sq) * inv_d - mean * mean, 0.f) + LN_EPS);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int nt = 0; nt < HT; ++nt) {
      const float2 c_lo = table(c_tile, rl, nt), c_hi = table(c_tile, rl, nt + HT);
      const float2 s_lo = table(s_tile, rl, nt), s_hi = table(s_tile, rl, nt + HT);
      const float u_lo[2] = {du[4 * nt + 2 * r], du[4 * nt + 2 * r + 1]};
      const float u_hi[2] = {du[4 * (nt + HT) + 2 * r], du[4 * (nt + HT) + 2 * r + 1]};
      // RoPE transpose: rot^T(v)[d < D/2] = v[d + D/2], else -v[d - D/2]
      const float dln[2][2] = {{u_lo[0] * c_lo.x + u_hi[0] * s_hi.x, u_lo[1] * c_lo.y + u_hi[1] * s_hi.y},
                               {u_hi[0] * c_hi.x - u_lo[0] * s_lo.x, u_hi[1] * c_hi.y - u_lo[1] * s_lo.y}};
      const float sc2[2][2] = {{sc[nt].x, sc[nt].y}, {sc[nt + HT].x, sc[nt + HT].y}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // column c, then its partner c + D/2
        const int tile = nt + h * HT;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          xn[tile][e] = (xn[tile][e] - mean) * rstd;
          if (live) part[tile][e] += dln[h][e] * xn[tile][e];
          dxn[tile][e] = dln[h][e] * sc2[h][e];
          m1 += dxn[tile][e];
          m2 += dxn[tile][e] * xn[tile][e];
        }
      }
    }
    m1 = quad_sum(m1) * inv_d;
    m2 = quad_sum(m2) * inv_d;
    if (live) {
      bf16* out = dst + (size_t)i * stride;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(out + 8 * nt + 2 * t) = pack_bf16(
            rstd * (dxn[nt][0] - m1 - xn[nt][0] * m2), rstd * (dxn[nt][1] - m1 - xn[nt][1] * m2));
    }
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) part[nt][e] += __shfl_xor_sync(0xffffffffu, part[nt][e], off);
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) red[8 * nt + 2 * t] += part[nt][0], red[8 * nt + 2 * t + 1] += part[nt][1];
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) tile_wg_bwd_kernel(const __grid_constant__ Maps maps, const bwd::Args a) {
  constexpr int K = KT<D>, B64 = TB<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  const int S = a.S, H = a.H, T = tiles_of(S), KTILES = key_tiles<D>(S), R = resident_tiles<D>(S) * ROWS;
  const Layout L = layout<D>(S);
  uint8_t* q_s = smem + L.q;  // raw q, then q~
  uint8_t* k_s = smem + L.k;  // raw k, then k~
  uint8_t* v_s = smem + L.v;  // D = 64
  uint8_t* g_s = smem + L.g;  // D = 64: dO
  uint8_t* epi = smem + L.epi;  // D = 64: [CONSUMERS][EPI_BYTES]
  uint8_t* own = smem + L.own;    // D = 128: [CONSUMERS][B64]
  uint8_t* ring = smem + L.ring;  // D = 128: [STAGES][B64]
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* il_s = m_s + R;
  float* row_s = il_s + R;
  float* red = reinterpret_cast<float*>(smem + L.red);  // [consumer warp][q, k][D]
  uint64_t* qk_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* vg_full = qk_full + 1;              // D = 64
  uint64_t* epi_full = vg_full + 1;             // D = 64: [CONSUMERS]
  uint64_t* epi_empty = epi_full + CONSUMERS;   // D = 64: [CONSUMERS]
  uint64_t* own_full = qk_full + 1;             // D = 128: [CONSUMERS]
  uint64_t* own_empty = own_full + CONSUMERS;   // [CONSUMERS]
  uint64_t* full = own_empty + CONSUMERS;       // [STAGES]
  uint64_t* empty = full + STAGES;              // [STAGES]
  const long long pair = blockIdx.x, b = pair / H;
  const int h = (int)(pair % H), wg = threadIdx.x / 128;
  const int rounds = (T + CONSUMERS - 1) / CONSUMERS;
  if (threadIdx.x == 0) {
    mbar_init(qk_full, 1);
    if constexpr (STREAM<D>) {
      for (int w = 0; w < CONSUMERS; ++w) {
        mbar_init(&own_full[w], 1);
        mbar_init(&own_empty[w], 4);
      }
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 4 * CONSUMERS);
      }
    } else {
      mbar_init(vg_full, 1);
      for (int w = 0; w < CONSUMERS; ++w) {
        mbar_init(&epi_full[w], 1);
        mbar_init(&epi_empty[w], 4);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) {
      const int bi = (int)b;  // column blocks of the fused qkv: q at h, k at H + h, v at 2 H + h (in heads)
      mbar_expect_tx(qk_full, 2 * T * B64);
      for (int t = 0; t < T; ++t) {
        split_wg::load_tile<D, ROWS>(q_s + t * B64, &maps.qkv, qk_full, bi, h, t * ROWS);
        split_wg::load_tile<D, ROWS>(k_s + t * B64, &maps.qkv, qk_full, bi, H + h, t * ROWS);
      }
      if constexpr (!STREAM<D>) {
        mbar_expect_tx(vg_full, 2 * T * B64);
        for (int t = 0; t < T; ++t) {
          split_wg::load_tile<D, ROWS>(v_s + t * B64, &maps.qkv, vg_full, bi, 2 * H + h, t * ROWS);
          split_wg::load_tile<D, ROWS>(g_s + t * B64, &maps.g, vg_full, bi, h, t * ROWS);
        }
        // each epilogue's staging, in the consumers' order (query side, then key side; a
        // round's tiles): the raw q (then k) rows of the warpgroup's tile, their cos and
        // sin rows; warpgroup w's epilogues before one: r, after its (T - w + 1) / 2 on
        // the query side
        for (int side = 0; side < 2; ++side)
          for (int r = 0; r < rounds; ++r)
            for (int w = 0; w < CONSUMERS && CONSUMERS * r + w < T; ++w) {
              const int before = r + side * ((T - w + 1) / 2), row0 = (CONSUMERS * r + w) * ROWS;
              uint8_t* st = epi + w * EPI_BYTES<D>;
              mbar_wait(&epi_empty[w], (before & 1) ^ 1);
              mbar_expect_tx(&epi_full[w], EPI_BYTES<D>);
              split_wg::load_tile<D, ROWS>(st, &maps.qkv, &epi_full[w], bi, side * H + h, row0);
              for (int p = 0; p < D / TABLE_COLS; ++p) {
                vvt_sm90::tma_load_2d(st + B64 + p * ROWS * 128, &maps.cos, &epi_full[w], TABLE_COLS * p, row0);
                vvt_sm90::tma_load_2d(st + 3 * B64 + p * ROWS * 128, &maps.sin, &epi_full[w], TABLE_COLS * p, row0);
              }
            }
      } else {
        // in the consumers' order: per round each warpgroup's own tile, then the walked
        // tiles (query side: v over both walks; key side: dO)
        int n = 0;  // ring steps
        // round r's own tiles of a side (0 query, 1 key); warpgroup w's loads before one:
        // r, after its (T - w + 1) / 2 query tiles on the key side
        auto own_tile = [&](const CUtensorMap* map, int head, int r, int side) {
          for (int w = 0; w < CONSUMERS && CONSUMERS * r + w < T; ++w) {
            const int before = r + side * ((T - w + 1) / 2);
            mbar_wait(&own_empty[w], (before & 1) ^ 1);
            mbar_expect_tx(&own_full[w], B64);
            split_wg::load_tile<D, ROWS>(own + w * B64, map, &own_full[w], bi, head, (CONSUMERS * r + w) * ROWS);
          }
        };
        auto walk_tile = [&](const CUtensorMap* map, int head, int tile) {
          const int stage = n % STAGES;
          mbar_wait(&empty[stage], ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[stage], B64);
          split_wg::load_tile<D, ROWS>(ring + stage * B64, map, &full[stage], bi, head, tile * ROWS);
          ++n;
        };
        for (int r = 0; r < rounds; ++r) {
          own_tile(&maps.g, h, r, 0);
          for (int s = 0; s < 2 * KTILES; ++s) walk_tile(&maps.qkv, 2 * H + h, s % KTILES);
        }
        for (int r = 0; r < rounds; ++r) {
          own_tile(&maps.qkv, 2 * H + h, r, 1);
          for (int s = 0; s < T; ++s) walk_tile(&maps.g, h, s);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3, g = lane >> 2;
  float* my_red = red + (4 * wg + warp) * 2 * D;
  for (int e = lane; e < 2 * D; e += 32) my_red[e] = 0.f;
  auto consumers_sync = [] { asm volatile("bar.sync %0, %1;" ::"n"(CONSUMER_BAR), "n"(128 * CONSUMERS) : "memory"); };
  if constexpr (!STREAM<D>) {  // the k and v tiles past the loaded ones, read by the last key tile
    const int words = (R / ROWS - T) * B64 / 16;
    for (int e = threadIdx.x; e < words; e += 128 * CONSUMERS) {
      reinterpret_cast<uint4*>(k_s + T * B64)[e] = make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint4*>(v_s + T * B64)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  {  // q~ and k~ in place, each warpgroup its tiles of both
    const split_wg::QNorm qn{a.q_scale, a.cos_t, a.sin_t};
    for (int mt = wg; mt < T; mt += CONSUMERS) {
      split_wg::QTables<D> tables;
      split_wg::load_q_tables<D>(tables, mt * ROWS, S, qn);
      mbar_wait(qk_full, 0);
      split_wg::norm_rope_own_q<D>(q_s + mt * B64, mt * ROWS, S, tables, a.hs.inv_d);
      load_lane_scale<D>(tables.sc, a.k_scale);
      split_wg::norm_rope_own_q<D>(k_s + mt * B64, mt * ROWS, S, tables, a.hs.inv_d);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for the products' reads of q~ and k~
  consumers_sync();

  const unsigned char* mask_row = a.mask == nullptr ? nullptr : a.mask + b * S;
  // part p (0 q, 1 k, 2 v) of the pair's fused rows: row i at + i token (made where it is
  // used, from the block's index: one value fewer held across the walks)
  const int token = 3 * H * D;
  auto pair_rows = [&](int part) {
    const int pr = blockIdx.x;
    return ((size_t)(pr / H) * S * 3 + part) * H * D + (size_t)(pr % H) * D;
  };
  // D = 128: ring step n's tile once it has landed, and its release; this warpgroup's
  // own tile (its uses-th) and its release
  auto ring_tile = [&](int n) -> const uint8_t* {
    mbar_wait(&full[n % STAGES], (n / STAGES) & 1);
    return ring + (n % STAGES) * B64;
  };
  auto release_stage = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[n % STAGES]);
  };
  auto own_tile = [&](int uses) -> const uint8_t* {
    mbar_wait(&own_full[wg], uses & 1);
    return own + wg * B64;
  };
  auto release_own = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&own_empty[wg]);
  };
  if constexpr (!STREAM<D>) mbar_wait(vg_full, 0);

  // Query side, then key side, each in rounds of the two warpgroups' tiles; one
  // epilogue (dq~ or dk~ back through RoPE, the scale and the LN) after each walk.
  for (int phase = 0; phase < 2 * rounds; ++phase) {
    const bool key_side = phase >= rounds;
    const int r = key_side ? phase - rounds : phase, tile = CONSUMERS * r + wg;
    // this warpgroup's own tiles (and epilogues) before this one; the ring's first step
    const int uses = key_side ? (T - wg + 1) / 2 + r : r;
    const int ring0 = key_side ? rounds * 2 * KTILES + r * T : r * 2 * KTILES;
    if (key_side && r == 0) consumers_sync();  // every row's statistics are in
    if (tile >= T) {  // no tile of this warpgroup in the last round: it keeps the ring's count
      if constexpr (STREAM<D>)
        for (int n = ring0; n < ring0 + (key_side ? T : 2 * KTILES); ++n) {
          ring_tile(n);
          release_stage(n);
        }
      continue;
    }
    const int own0 = tile * ROWS;
    float du[D / 2];  // dq~ (query side) or dk~ (key side) of the tile's rows
#pragma unroll
    for (int i = 0; i < D / 2; ++i) du[i] = 0.f;
    if (!key_side) {  // statistics and dq~
      const uint8_t* q_tile = q_s + tile * B64;
      const uint8_t* do_tile = STREAM<D> ? own_tile(uses) : g_s + tile * B64;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
      float il[2] = {0.f, 0.f}, row[2] = {0.f, 0.f};
      const int steps = 2 * KTILES;
      Keep<K> keep = split_wg::load_keep<K>(mask_row, S, 0);
      OwnFrags<D> qf, df;
      if constexpr (split_wg::OWN_IN_REGS<D>) {
        split_wg::load_frags<D>(qf, q_tile);
        split_wg::load_frags<D>(df, do_tile);
      }
      for (int n = 0; n < steps; ++n) {  // query side
        const int j0 = (n % KTILES) * K;
        const bool first_walk = n < KTILES;
        const Keep<K> kept = keep;
        if (n + 1 < steps) keep = split_wg::load_keep<K>(mask_row, S, ((n + 1) % KTILES) * K);
        if (n == KTILES) {  // each row's 1/l and row = sum_j P dP (bwd::finish_stats)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            il[r2] = 1.f / quad_sum(l[r2]);
            row[r2] = quad_sum(rs[r2]) * il[r2];
          }
        }
        const uint8_t* k_tile = k_s + (j0 / ROWS) * B64;
        const uint8_t* v_tile = STREAM<D> ? ring_tile(ring0 + n) : v_s + (j0 / ROWS) * B64;
        __syncwarp();
        float s[K / 2], dp[K / 2];
        wgmma_fence();
        split_wg::scores<D, K>(s, q_tile, qf, k_tile);
        wgmma_commit();
        split_wg::scores<D, K>(dp, do_tile, df, v_tile);
        wgmma_commit();
        const KeyBits<K> bits = split_wg::key_bits<K>(kept, j0, S);  // while the products run
        wgmma_wait_group<1>();
        fence_acc(s);
        split_wg::mask_tile<K>(s, bits, j0, S);
        if (first_walk) {  // m, l and sum_j exp(s - m) dP, online
          float corr[2];
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < K / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r2], s[4 * j + 2 * r2 + 1]));
            const float m_new = fmaxf(m[r2], quad_max(mx));
            corr[r2] = exp2_ftz((m[r2] - m_new) * a.hs.c);  // 0 on the first tile
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < K / 8; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float p = exp2_ftz((s[4 * j + 2 * r2 + c] - m_new) * a.hs.c);
                s[4 * j + 2 * r2 + c] = p;
                sum += p;
              }
            l[r2] = l[r2] * corr[r2] + sum;
            m[r2] = m_new;
          }
          wgmma_wait_group<0>();
          fence_acc(dp);
          if constexpr (STREAM<D>) release_stage(ring0 + n);
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < K / 8; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) acc += s[4 * j + 2 * r2 + c] * dp[4 * j + 2 * r2 + c];
            rs[r2] = rs[r2] * corr[r2] + acc;
          }
        } else {  // P (normalised, f32), dS, dq~ += dS (bf16) . k~
#pragma unroll
          for (int e = 0; e < K / 2; ++e) s[e] = exp2_ftz((s[e] - m[(e >> 1) & 1]) * a.hs.c) * il[(e >> 1) & 1];
          wgmma_wait_group<0>();
          fence_acc(dp);
          if constexpr (STREAM<D>) release_stage(ring0 + n);  // dq~'s product reads k~ alone
#pragma unroll
          for (int e = 0; e < K / 2; ++e) dp[e] = s[e] * (dp[e] - row[(e >> 1) & 1]) * a.hs.scale;
          uint32_t ds[K / 16][4];
          split_wg::pack_frags<K>(ds, dp);
          wgmma_fence();
          split_wg::mma_rows<D, K>(du, ds, k_tile);
          wgmma_commit();
          wgmma_wait_group<0>();
          fence_acc(du);
          fence_regs(ds);
        }
        __syncwarp();
      }
      if constexpr (STREAM<D>) release_own();  // the walk is done with the own dO tile
      if (t == 0) {  // the rows' statistics for the key side; a row past S: zeros, so its P is 0
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int i = own0 + 16 * warp + g + 8 * r2;
          const bool in = i < S;
          m_s[i] = in ? m[r2] : 0.f, il_s[i] = in ? il[r2] : 0.f, row_s[i] = in ? row[r2] : 0.f;
        }
      }
    } else {  // dv and dk~
      const uint8_t* k_tile = k_s + tile * B64;
      const uint8_t* v_tile = STREAM<D> ? own_tile(uses) : v_s + tile * B64;
      bool masked[2];  // keys own0 + 16 warp + g (+ 8): masked, or past S (whose rows are not written)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int j = own0 + 16 * warp + g + 8 * r2;
        masked[r2] = j >= S || (mask_row != nullptr && !mask_row[j]);
      }
      float dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv[i] = 0.f;
      OwnFrags<D> kf, vf;
      if constexpr (split_wg::OWN_IN_REGS<D>) {
        split_wg::load_frags<D>(kf, k_tile);
        split_wg::load_frags<D>(vf, v_tile);
      }
      for (int n = 0; n < T; ++n) {  // key side
        const uint8_t* q_tile = q_s + n * B64;
        const uint8_t* do_tile = STREAM<D> ? ring_tile(ring0 + n) : g_s + n * B64;
        __syncwarp();
        key_step<D>(dv, du, k_tile, v_tile, kf, vf, q_tile, do_tile, m_s + n * ROWS, il_s + n * ROWS,
                    row_s + n * ROWS, masked, a.hs);
        if constexpr (STREAM<D>) release_stage(ring0 + n);
        __syncwarp();
      }
      if constexpr (STREAM<D>) release_own();
      split_wg::store_rows<D, bf16>(dv, a.dqkv + pair_rows(2), token, own0, S);
    }
    const size_t rows = pair_rows(key_side ? 1 : 0);  // the q or the k columns
    const float* scale = key_side ? a.k_scale : a.q_scale;
    float* red_side = my_red + (key_side ? D : 0);
    if constexpr (STREAM<D>) {  // wgmma's accumulator layout is mma.sync's for the warp's 16 rows
      float acc[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = du[4 * j + e];
      bwd::ln_rope_bwd_acc<D>(acc, a.qkv + rows, a.dqkv + rows, token, own0 + 16 * warp, S, scale,
                              a.cos_t, a.sin_t, red_side, a.hs.inv_d);
    } else {  // from the staging TMA filled while the walk ran
      const uint8_t* stage = epi + wg * EPI_BYTES<D>;
      mbar_wait(&epi_full[wg], uses & 1);
      epilogue_staged<D>(du, stage, a.dqkv + rows, token, own0, S, scale, red_side, a.hs.inv_d);
      __syncwarp();
      if (lane == 0) mbar_arrive(&epi_empty[wg]);
    }
  }
  consumers_sync();
  // the block's scale partials: the consumer warps' sums in warp order
  for (int e = threadIdx.x; e < 2 * D; e += 128 * CONSUMERS) {
    const int part = e / D, d = e % D;
    float sum = 0.f;
    for (int w = 0; w < 4 * CONSUMERS; ++w) sum += red[(w * 2 + part) * D + d];
    (part ? a.dks_part : a.dqs_part)[(size_t)blockIdx.x * D + d] = sum;
  }
}

// A (S, D) f32 RoPE table as a 2-D tensor map cut in boxes of 64 rows x 32
// columns (128 bytes), 128-byte swizzle, zeros past S.
inline cudaError_t encode_table(CUtensorMap* map, const float* table, int S, int D) {
  const vvt_sm90::EncodeTiledFn encode = vvt_sm90::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)S};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(float)};
  const cuuint32_t box[2] = {TABLE_COLS, ROWS};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(table), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Checks the plan (variant "tile_wg": one pair a block, WARPS warps, 64 < S <=
// 256) and the partials' row count against the shape, encodes the two maps
// (TMA's rule, a 16-byte aligned base and row stride, holds for qkv and dO at
// head dims 64 and 128; the wrapper copies a base off 16 bytes), and launches.
template <int D>
cudaError_t launch_bwd(const bwd::Args& a, int warps, int n_blocks, cudaStream_t stream) {
  static_assert(D == 64 || D == 128, "the wgmma tile backward takes head dims 64 and 128");
  const long long blocks = (long long)a.B * a.H;
  if (a.S <= bwd::SLAB_MAX_SEQ || a.S > TILE_MAX_SEQ || a.unit != 1 || warps != WARPS || blocks != n_blocks ||
      blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Maps maps;
  cudaError_t err =
      split_wg::encode_rows(&maps.qkv, split::In{a.qkv, 3LL * a.H * D}, a.B, a.S, 3 * a.H, D, ROWS);
  if (err != cudaSuccess) return err;
  err = split_wg::encode_rows(&maps.g, split::In{a.g, (long long)a.H * D}, a.B, a.S, a.H, D, ROWS);
  if (err != cudaSuccess) return err;
  if constexpr (!STREAM<D>) {
    err = encode_table(&maps.cos, a.cos_t, a.S, D);
    if (err != cudaSuccess) return err;
    err = encode_table(&maps.sin, a.sin_t, a.S, D);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = layout<D>(a.S).bytes;
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(tile_wg_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tile_wg_bwd_kernel<D><<<(unsigned)blocks, THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace tile_wg
}  // namespace fa_mma
