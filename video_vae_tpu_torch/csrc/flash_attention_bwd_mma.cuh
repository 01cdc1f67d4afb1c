// Device code of the bf16 plain attention backward on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators). The design note is in
// flash_attention_bwd.cu. launch_flash_bwd_mma() enqueues the kernel on a
// stream and returns the launch's cudaError_t. The slab variant runs the
// softmax backward of the fused attention backward (fa_mma::bwd in
// fused_attention_mma_common.cuh) on q, k, v and dO as they are, with no LN or
// RoPE around it; the tile variant exchanges dS through shared memory instead
// of recomputing the scores a third time.
//
// Shared-memory layout. Rows of D bf16 sit in D + 8-element rows (144 bytes at
// D = 64), staged in 16-row units, a row past the sequence zero-filled.
//   slab (S <= 64): per (sequence, head) pair of the block: q | dO | k | v
//                   [row], then P and dS as bf16 [query][key] (rows of
//                   rows16(S) + 8 elements); then the key bits of every pair;
//   tile (S > 64):  q | dO | k | v [row] of one pair; dS^T of one round, bf16
//                   [key][query] (rows of ROUND + 8 elements); its rows'
//                   softmax max m, 1/l and row term (f32); its key bits.
// Last, both: each warp's 8 staging rows of the epilogue, [warp][8][STAGE_ROW] f32.

#pragma once

#include "fused_attention_mma_common.cuh"

namespace fa_mma {
namespace flash_bwd {

// the fused backward's plan (ops/flash_attention.py:flash_attention_bwd_plan)
using bwd::SLAB_BLOCKS;
using bwd::SLAB_MAX_SEQ;
using bwd::SLAB_WARPS;
using bwd::STAGE_ROW;
using bwd::TILE_KT;
using bwd::TILE_WARPS;

constexpr int ROUND = 64;           // queries whose dS a tile block exchanges at a time
constexpr int DS_ROW = ROUND + 8;   // bf16 row of the round's dS^T (144 bytes: ldmatrix without bank conflicts)

// Shared memory of one block (unit: pairs of a slab block).
template <int D>
__host__ __forceinline__ size_t smem_bytes(int variant, int S, int unit, int warps) {
  const size_t words = 8 * (size_t)key_words(S);
  const size_t stage = (size_t)warps * 8 * STAGE_ROW<D> * sizeof(float);  // each warp's staging rows
  if (variant == SLAB) return (size_t)unit * (2 * bwd::slab_pair_elems<D>(S) + words) + stage;
  return 4 * (size_t)rows16(S) * ROW_BYTES<D> + (size_t)rows16(S) * DS_ROW * sizeof(bf16) +
         3 * (size_t)rows16(S) * sizeof(float) + words + stage;
}

struct Args {
  const bf16* q;  // each input (B, S, H, D), row (b, i) at base + (b S + i) stride
  const bf16* k;
  const bf16* v;
  const bf16* g;  // dO
  const unsigned char* mask;  // (B, S) or null
  bf16* dq;                   // each output (B, S, H, D), contiguous
  bf16* dk;
  bf16* dv;
  long long q_stride, k_stride, v_stride, g_stride;
  int B, S, H, unit;
  HeadScale hs;  // the true head dim's softmax scale (its 1/d is not read here)
};

// cp.async rows i0 .. i1 - 1 of parts part0 .. part1 - 1 (0 q, 1 dO, 2 k, 3 v)
// of the `unit` pairs p0 .. into shared memory, part `part` of local pair pl
// at rows_of(pl, part); a row past S or of a pair past the end is
// zero-filled. Consecutive threads copy consecutive 16-byte pieces of one
// position's rows: the pairs of a block are consecutive heads of a sequence,
// adjacent in memory. The caller commits the group.
template <int D, typename RowsOf>
__device__ __forceinline__ void copy_rows(const Args& a, RowsOf rows_of, long long p0, int unit, int part0, int part1,
                                          int i0, int i1) {
  constexpr int P = PIECES<D>;
  const int S = a.S, H = a.H, n = i1 - i0;
  const long long pairs = (long long)a.B * H;
  for (int e = threadIdx.x; e < (part1 - part0) * n * unit * P; e += blockDim.x) {
    const int piece = e % P, pl = (e / P) % unit, ri = (e / P) / unit;
    const int i = i0 + ri % n, part = part0 + ri / n;
    const long long p = p0 + pl;
    const bool inside = p < pairs && i < S;
    const bf16* src = a.q;
    if (inside) {
      const bf16* base = part == 0 ? a.q : part == 1 ? a.g : part == 2 ? a.k : a.v;
      const long long stride = part == 0 ? a.q_stride : part == 1 ? a.g_stride : part == 2 ? a.k_stride : a.v_stride;
      const long long b = p / H;
      const int h = (int)(p % H);
      src = base + (b * S + i) * stride + h * D + 8 * piece;
    }
    cp_async16(rows_of(pl, part) + (size_t)i * ROW<D> + 8 * piece, src, inside ? 16 : 0);
  }
}

// wait until at most n (0 .. 3) of this thread's committed groups are still in flight
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

// Slab: one block per `unit` consecutive (sequence, head) pairs. The query side
// of every 16-row query tile, dealt to the warps in turn (P and dS to shared
// memory, dq); a barrier; the key side of every 16-row key tile, dealt the same
// way (dv, dk). tests/test_torch_flash_bwd_plan.py walks the same items on the CPU.
template <int D, int KT>
__global__ void __launch_bounds__(SLAB_WARPS * 32, SLAB_BLOCKS<D>) flash_bwd_slab_kernel(Args a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  constexpr int ROW = fa_mma::ROW<D>, STAGE_ROW = bwd::STAGE_ROW<D>;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int S = a.S, H = a.H, s16 = rows16(S), words = key_words(S), tiles = s16 / 16, unit = a.unit;
  const size_t HD = (size_t)H * D;
  const long long pairs = (long long)a.B * H;
  const long long p0 = (long long)blockIdx.x * unit;
  const size_t pair_elems = bwd::slab_pair_elems<D>(S);
  const int pstride = bwd::ps_row(S);
  // part 0 q, 1 dO, 2 k, 3 v of the block's pair pl; its P, then dS, begin at part 4
  auto rows_of = [&](int pl, int part) { return smem + pl * pair_elems + (size_t)part * s16 * ROW; };
  unsigned long long* keep = reinterpret_cast<unsigned long long*>(smem + unit * pair_elems);
  float* stage = reinterpret_cast<float*>(keep + unit * words) + warp * 8 * STAGE_ROW;  // this warp's
  copy_rows<D>(a, rows_of, p0, unit, 0, 4, 0, s16);
  cp_async_commit();
  for (int pl = 0; pl < unit; ++pl)
    stage_key_bits(keep + pl * words, a.mask, p0 + pl < pairs ? (p0 + pl) / H : 0, S, warp, warps);
  cp_async_wait<0>();
  __syncthreads();

  const int items = unit * tiles;
  for (int it = warp; it < items; it += warps) {  // query side
    const int pl = it / tiles, mt = it % tiles;
    const long long p = p0 + pl;
    if (p >= pairs) continue;  // uniform per warp
    bf16* p_rows = rows_of(pl, 4) + (size_t)16 * mt * pstride;
    float dq[D / 8][4], st[2][3];
    bwd::query_side<D, KT, false>(rows_of(pl, 0) + (size_t)16 * mt * ROW, rows_of(pl, 1) + (size_t)16 * mt * ROW,
                                  rows_of(pl, 2), rows_of(pl, 3), keep + pl * words, S, dq, st, p_rows,
                                  p_rows + (size_t)s16 * pstride, pstride, a.hs);
    const size_t base = (size_t)(p / H) * S * HD + (size_t)(p % H) * D;
    bwd::store_rows<D>(dq, stage, a.dq + base, HD, 16 * mt, S);
  }
  __syncthreads();
  for (int it = warp; it < items; it += warps) {  // key side
    const int pl = it / tiles, kt = it % tiles;
    const long long p = p0 + pl;
    if (p >= pairs) continue;
    float dv[D / 8][4], dk[D / 8][4];
    bwd::key_side_slab<D>(rows_of(pl, 4), rows_of(pl, 4) + (size_t)s16 * pstride, pstride, rows_of(pl, 0),
                       rows_of(pl, 1), 16 * kt, S, dv, dk);
    const size_t base = (size_t)(p / H) * S * HD + (size_t)(p % H) * D;
    bwd::store_rows<D>(dv, stage, a.dv + base, HD, 16 * kt, S);
    bwd::store_rows<D>(dk, stage, a.dk + base, HD, 16 * kt, S);
  }
}

// The key side of one round in a tile block: key rows k0 .. k0 + 15 against the
// queries q0 .. q1 - 1, 16 at a time. For each 16: s^T = k q^T and dP^T = v dO^T,
// P^T from the query rows' (m, 1/l, row) in shared memory, dS^T = P^T (dP^T -
// row) / sqrt(D); dv += P^T . dO and dk += dS^T . q with P^T and dS^T rounded to
// bf16, and the rounded dS^T to ds_t (row k0 + r, column i - q0). The k and v
// fragments are loaded again for each 16 queries, so that the registers of dv
// and dk are not spilled. masked: keys k0 + g and k0 + g + 8 masked or past S.
template <int D>
__device__ __forceinline__ void key_round(const bf16* q_s, const bf16* do_s, const bf16* k_s, const bf16* v_s,
                                          const float* m_s, const float* il_s, const float* row_s, const bool (&masked)[2],
                                          int k0, int q0, int q1, int S, bf16* ds_t, float (&dv)[D / 8][4],
                                          float (&dk)[D / 8][4], const HeadScale& hs) {
  constexpr int ROW = fa_mma::ROW<D>;
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  for (int i0 = q0; i0 < q1; i0 += 16) {
    float st[2][4], dt[2][4];
    {
      uint32_t f[D / 16][4];
      bwd::load_rows<D>(f, k_s + (size_t)k0 * ROW);
      bwd::row_dots<D, 1>(st, f, q_s, i0, 1);
      bwd::load_rows<D>(f, v_s + (size_t)k0 * ROW);
      bwd::row_dots<D, 1>(dt, f, do_s, i0, 1);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int i = i0 + 8 * nt + 2 * t + e1;
        const bool live = i < S;  // a query past S adds 0
        const float mi = live ? m_s[i] : 0.f, il = live ? il_s[i] : 0.f, row = live ? row_s[i] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + e1;
          const float p = live ? exp2f(((masked[r] ? NEG_INF : st[nt][e]) - mi) * hs.c) * il : 0.f;
          st[nt][e] = p;
          dt[nt][e] = p * (dt[nt][e] - row) * hs.scale;
        }
      }
    uint32_t ap[4], ad[4];
    bwd::pack_a(ap, st, 0);
    bwd::pack_a(ad, dt, 0);
    bwd::mma_rows<D>(dv, ap, do_s + (size_t)i0 * ROW);
    bwd::mma_rows<D>(dk, ad, q_s + (size_t)i0 * ROW);
    // ad[2 h + r]: key row k0 + g + 8 r, queries i0 + 8 h + 2 t, + 1
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(ds_t + (size_t)(k0 + g + 8 * r) * DS_ROW + i0 - q0 + 8 * h + 2 * t) = ad[2 * h + r];
  }
}

// dq of 16 queries (columns c0 .. c0 + 15 of the round's dS^T) and 16 dims
// d0 .. d0 + 15: the sum over the keys j < s16 of dS_ij k_jd, dS read from
// ds_t through ldmatrix.trans, k through ldmatrix.trans. acc[nt]: dims
// d0 + 8 nt .. in the m16n8 accumulator layout. A key past S has a zero k row.
template <int D>
__device__ __forceinline__ void dq_tile(float (&acc)[2][4], const bf16* ds_t, const bf16* k_s, int c0, int d0, int s16) {
  constexpr int ROW = fa_mma::ROW<D>;
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // matrix mi of the A load: keys j0 + 8 (mi >> 1) .., queries c0 + 8 (mi & 1) ..
  const bf16* a_at = ds_t + (size_t)((lane & 7) + 8 * (mi >> 1)) * DS_ROW + c0 + 8 * (mi & 1);
  const bf16* b_at = k_s + (size_t)(lane & 15) * ROW + d0 + 8 * (lane >> 4);
  for (int j0 = 0; j0 < s16; j0 += 16) {
    uint32_t af[4], b[4];
    ldsm_x4_trans(af, a_at + (size_t)j0 * DS_ROW);
    ldsm_x4_trans(b, b_at + (size_t)j0 * ROW);
    mma(acc[0], af, b[0], b[1]);
    mma(acc[1], af, b[2], b[3]);
  }
}

// Tile: one block per pair, a warp per 16 rows (warps = rows16(S) / 16).
// 1. Each warp walks the keys once for its 16 query rows' m, 1/l and row
//    (scores and dP, online); a barrier.
// 2. In rounds of ROUND queries: each warp, for its 16 key rows, takes the
//    round's P^T and dS^T (key_round: dv, dk, dS^T to shared memory); a
//    barrier; the warps take the round's 16 x 16 tiles of dq = dS k in turn
//    and store them; a barrier.
// 3. Each warp stores its dv and dk rows. 7 products of S^2 D and 2 exp a
// score. tests/test_torch_flash_bwd_plan.py walks the same items on the CPU.
template <int D>
__global__ void __launch_bounds__(TILE_WARPS * 32, 1) flash_bwd_tile_kernel(Args a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  constexpr int ROW = fa_mma::ROW<D>, STAGE_ROW = bwd::STAGE_ROW<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int t = lane & 3, g = lane >> 2;
  const int S = a.S, s16 = rows16(S), words = key_words(S);
  const size_t HD = (size_t)a.H * D;
  const long long p = blockIdx.x;  // the block's (sequence, head) pair
  auto rows_of = [&](int, int part) { return smem + (size_t)part * s16 * ROW; };
  const bf16 *q_s = rows_of(0, 0), *do_s = rows_of(0, 1), *k_s = rows_of(0, 2), *v_s = rows_of(0, 3);
  bf16* ds_t = smem + 4 * (size_t)s16 * ROW;
  float* m_s = reinterpret_cast<float*>(ds_t + (size_t)s16 * DS_ROW);  // m | 1/l | row
  float* il_s = m_s + s16;
  float* row_s = il_s + s16;
  unsigned long long* keep = reinterpret_cast<unsigned long long*>(row_s + s16);
  float* stage = reinterpret_cast<float*>(keep + words) + warp * 8 * STAGE_ROW;  // this warp's
  // group 0, the q and dO rows; group 1 + c, the k and v rows of keys 64 c ..
  // 64 c + 63: the statistics start on the first keys while the rest arrive
  const int key_groups = (s16 + 63) / 64;
  copy_rows<D>(a, rows_of, p, 1, 0, 2, 0, s16);
  cp_async_commit();
  for (int c = 0; c < key_groups; ++c) {
    copy_rows<D>(a, rows_of, p, 1, 2, 4, 64 * c, min(64 * c + 64, s16));
    cp_async_commit();
  }
  stage_key_bits(keep, a.mask, p / a.H, S, warp, warps);
  const size_t base = (size_t)(p / a.H) * S * HD + (size_t)(p % a.H) * D;
  const int r0 = 16 * warp;  // this warp's query rows in step 1, key rows in steps 2 and 3

  {  // 1: the query rows' statistics
    cp_async_wait_at_most(key_groups - 1);  // the q and dO rows and the first 64 keys
    __syncthreads();
    uint32_t qf[D / 16][4], df[D / 16][4];
    bwd::load_rows<D>(qf, q_s + (size_t)r0 * ROW);
    bwd::load_rows<D>(df, do_s + (size_t)r0 * ROW);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
    float s[2 * TILE_KT][4], dp[2 * TILE_KT][4];
    for (int c0 = 0; c0 < S; c0 += 16 * TILE_KT) {
      if (c0 > 0 && c0 % 64 == 0) {  // the rows of keys c0 .. c0 + 63 have arrived
        cp_async_wait_at_most(key_groups - 1 - c0 / 64);
        __syncthreads();
      }
      bwd::online_chunk<D, TILE_KT>(s, dp, qf, df, k_s, v_s, keep, S, c0, m, l, rs, a.hs.c);
    }
    float il[2], row[2], st[2][3];
    bwd::finish_stats(m, l, rs, il, row, st);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r0 + g + 8 * r;
        m_s[i] = st[r][0], il_s[i] = st[r][1], row_s[i] = st[r][2];
      }
    }
  }
  __syncthreads();

  bool masked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = r0 + g + 8 * r;
    masked[r] = !((keep[j >> 6] >> (j & 63)) & 1ull);  // also a padding key: its rows are not written
  }
  float dv[D / 8][4], dk[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[dn][e] = dk[dn][e] = 0.f;
  for (int q0 = 0; q0 < s16; q0 += ROUND) {  // 2: rounds of queries
    const int q1 = min(q0 + ROUND, s16);
    key_round<D>(q_s, do_s, k_s, v_s, m_s, il_s, row_s, masked, r0, q0, q1, S, ds_t, dv, dk, a.hs);
    __syncthreads();
    for (int it = warp; it < (q1 - q0) / 16 * (D / 16); it += warps) {  // the round's dq tiles
      const int c0 = 16 * (it / (D / 16)), d0 = 16 * (it % (D / 16));
      float acc[2][4];
      dq_tile<D>(acc, ds_t, k_s, c0, d0, s16);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = q0 + c0 + g + 8 * r;
        if (i < S) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            *reinterpret_cast<uint32_t*>(a.dq + base + (size_t)i * HD + d0 + 8 * nt + 2 * t) =
                pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
        }
      }
    }
    __syncthreads();
  }
  bwd::store_rows<D>(dv, stage, a.dv + base, HD, r0, S);  // 3
  bwd::store_rows<D>(dk, stage, a.dk + base, HD, r0, S);
}

// The tile variant at D = 128: the fused backward's wide tile
// (bwd::wide_tile_bwd in fused_attention_mma_common.cuh) without LN or RoPE,
// one block per (sequence, head) pair. It recomputes the scores on the key
// side (9 products of S^2 D) where the D <= 64 tile exchanges dS (7): the
// exchange's dS^T rows would not fit beside the three D-wide arrays.
template <int D>
__global__ void __launch_bounds__(bwd::WIDE_TILE_WARPS * 32, 1) flash_bwd_wide_kernel(Args a) {
  const long long p = blockIdx.x, b = p / a.H;
  const int h = (int)(p % a.H);
  const size_t out = (size_t)b * a.S * a.H * D + (size_t)h * D;
  const bwd::PairRows io{{a.q + b * a.S * a.q_stride + h * D, a.k + b * a.S * a.k_stride + h * D,
                          a.v + b * a.S * a.v_stride + h * D, a.g + b * a.S * a.g_stride + h * D},
                         {(size_t)a.q_stride, (size_t)a.k_stride, (size_t)a.v_stride, (size_t)a.g_stride},
                         {a.dq + out, a.dk + out, a.dv + out},
                         (size_t)a.H * D};
  bwd::wide_tile_bwd<D, false>(io, bwd::NormRope{}, a.hs, a.mask, b, a.S, nullptr, nullptr);
}

template <int D, int KT>
cudaError_t launch_slab(const Args& a, int warps, int smem, unsigned blocks, cudaStream_t stream) {
  auto kernel = flash_bwd_slab_kernel<D, KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

// Checks the plan (ops/flash_attention.py:flash_attention_bwd_plan: the
// variant, the pairs a slab block, the warps a block and the grid) against the
// shape, and launches.
template <int D>
cudaError_t launch_flash_bwd_mma(const Args& a, int variant, int warps, long long n_blocks,
                                        cudaStream_t stream) {
  const long long pairs = (long long)a.B * a.H;
  long long blocks;
  if (variant == SLAB) {
    if (a.S > SLAB_MAX_SEQ || a.unit < 1 || warps < 1 || warps > SLAB_WARPS) return cudaErrorInvalidValue;
    blocks = (pairs + a.unit - 1) / a.unit;
  } else if (variant == TILE) {
    const int tile_warps = D == 128 ? std::min(rows16(a.S) / 16, bwd::WIDE_TILE_WARPS) : rows16(a.S) / 16;
    if (a.unit != 1 || a.S > TILE_MAX_SEQ || warps != tile_warps || warps > TILE_WARPS) return cudaErrorInvalidValue;
    blocks = pairs;
  } else {
    return cudaErrorInvalidValue;
  }
  const size_t smem = D == 128 && variant == TILE ? bwd::wide_tile_smem_bytes<D>(a.S, warps, false)
                                                  : smem_bytes<D>(variant, a.S, a.unit, warps);
  if (blocks != n_blocks || blocks > 0x7fffffffLL || smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  if (variant == TILE) {
    auto kernel = [] {
      if constexpr (D == 128) return flash_bwd_wide_kernel<D>;
      else return flash_bwd_tile_kernel<D>;
    }();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, 32 * warps, smem, stream>>>(a);
    return cudaGetLastError();
  }
  switch (chunk_steps(a.S)) {  // one chunk holds every key
    case 1:
      return launch_slab<D, 1>(a, warps, (int)smem, grid, stream);
    case 2:
      return launch_slab<D, 2>(a, warps, (int)smem, grid, stream);
    default:
      return launch_slab<D, 4>(a, warps, (int)smem, grid, stream);
  }
}

}  // namespace flash_bwd
}  // namespace fa_mma
