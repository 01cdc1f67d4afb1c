// Device code of the bf16 fused QK-norm + RoPE + attention backward on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 accumulators). The design note is
// in fused_attention_bwd.cu. launch_attention_bwd_mma() enqueues the kernel on a
// stream and returns the launch's cudaError_t. The helpers it shares with the
// forward (cp.async, ldmatrix, mma, the LN + RoPE of a row pair, the key bits)
// and with the plain attention backward (the products of a row tile, the
// query side, the slab's key side, the epilogue of dv; namespace bwd) are in
// fused_attention_mma_common.cuh.
//
// Shared-memory layout. Rows of D bf16 sit in D + 8-element rows (144 bytes at
// D = 64) as in the forward, staged in 16-row units, a row past the sequence
// zero-filled.
//   slab (S <= 64): per (sequence, head) pair of the block: q~ | k~ | v | dO
//                   [row], then P and dS as bf16 [query][key] (rows of
//                   rows16(S) + 8 elements, an odd count of 16-byte units, so
//                   ldmatrix.trans reads them without bank conflicts); then the
//                   key bits of every pair;
//   tile (S > 64):  q~ | k~ | v | dO [row] of one pair, then its rows' softmax
//                   max m, 1/l and row term (f32), then its key bits.
// Last, both: the per-warp dscale partials, [warp][q, k][D] f32, then each
// warp's 8 staging rows of the epilogue, [warp][8][STAGE_ROW] f32.

#pragma once

#include "fused_attention_mma_common.cuh"

namespace fa_mma {
namespace bwd {

// Shared memory of one block (unit: pairs of a slab block).
template <int D>
__host__ __forceinline__ size_t bwd_smem_bytes(int variant, int S, int unit, int warps) {
  const size_t words = 8 * (size_t)key_words(S);
  // each warp's (2, D) dscale partials and 8 staging rows
  const size_t red = (size_t)warps * (2 * D + 8 * STAGE_ROW<D>) * sizeof(float);
  if (variant == SLAB) return (size_t)unit * (2 * slab_pair_elems<D>(S) + words) + red;
  return 4 * (size_t)rows16(S) * ROW_BYTES<D> + 3 * (size_t)rows16(S) * sizeof(float) + words + red;
}

struct Args {
  const bf16* qkv;  // (B, S, 3 H D)
  const float* q_scale;
  const float* k_scale;
  const float* cos_t;  // (S, D)
  const float* sin_t;
  const unsigned char* mask;  // (B, S) or null
  const bf16* g;              // dO, (B, S, H D)
  bf16* dqkv;                 // (B, S, 3 H D)
  float* dqs_part;            // (blocks, D)
  float* dks_part;
  int B, S, H, unit;
  HeadScale hs;  // the true head dim's 1/d and softmax scale
};

// The key side of one warp in a tile block: key rows k0 .. k0 + 15 of the pair.
// For each 16 queries: s^T = k~ q~^T and dP^T = v dO^T, P^T from the query rows'
// (m, 1/l, row) that the query side left in shared memory, dS^T; then
// dv += P^T . dO and dk~ += dS^T . q~, P^T and dS^T rounded to bf16.
template <int D>
__device__ __forceinline__ void key_side_tile(const bf16* q_s, const bf16* k_s, const bf16* v_s, const bf16* do_s,
                                              const float* m_s, const float* il_s, const float* row_s,
                                              const unsigned long long* keep, int k0, int S, float (&dv)[D / 8][4],
                                              float (&dk)[D / 8][4], const HeadScale& hs) {
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_rows<D>(kf, k_s + (size_t)k0 * ROW<D>);
  load_rows<D>(vf, v_s + (size_t)k0 * ROW<D>);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[dn][e] = dk[dn][e] = 0.f;
  bool masked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + g + 8 * r;
    masked[r] = !((keep[j >> 6] >> (j & 63)) & 1ull);  // also a padding key: its rows are not written
  }
  for (int q0 = 0; q0 < S; q0 += 16) {
    float st[2][4], dt[2][4];
    row_dots<D, 1>(st, kf, q_s, q0, 1);
    row_dots<D, 1>(dt, vf, do_s, q0, 1);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int i = q0 + 8 * nt + 2 * t + e1;
        const float mi = m_s[i], il = il_s[i], row = row_s[i];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + e1;
          const float p = i < S ? exp2f(((masked[r] ? NEG_INF : st[nt][e]) - mi) * hs.c) * il : 0.f;
          st[nt][e] = p;
          dt[nt][e] = p * (dt[nt][e] - row) * hs.scale;
        }
      }
    uint32_t ap[4], ad[4];
    pack_a(ap, st, 0);
    pack_a(ad, dt, 0);
    mma_rows<D>(dv, ap, do_s + (size_t)q0 * ROW<D>);
    mma_rows<D>(dk, ad, q_s + (size_t)q0 * ROW<D>);
  }
}

template <int D>
__device__ __forceinline__ float row_sum(float x) {  // over the ROW_LANES lanes of a row
#pragma unroll
  for (int off = 1; off < ROW_LANES<D>; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Back through RoPE, the scale and the LN for the 16 rows row0 + .. of one
// pair, from du = dq~ or dk~ (16 x D f32 accumulators): dln = RoPE^T(du),
// dx = r (dln s - mean(dln s) - xn mean(dln s xn)), rounded to bf16 at dst (row i
// at dst + i * stride). xn and r come from the raw row re-read at src. The rows'
// sum of dln xn (the scale's gradient) is added to red (D floats, this warp's).
// The accumulators pass through the warp's staging rows, 8 rows at a time, and
// ROW_LANES lanes take a row (stage_half): a lane holds dims d and d + D/2, so
// RoPE's transpose needs no shuffle, and every global access of a row is one
// contiguous piece; the row's sums take __shfl_xor over its lanes. inv_d: 1/d of
// the true head dim (HeadScale), over which the LN's means are taken.
template <int D>
__device__ __forceinline__ void ln_rope_bwd(const float (&du)[D / 8][4], float* stage, const bf16* __restrict__ src,
                                            bf16* __restrict__ dst, size_t stride, int row0, int S,
                                            const float* __restrict__ scale, const float* __restrict__ cos_t,
                                            const float* __restrict__ sin_t, float* red, float inv_d) {
  constexpr int LR = ROW_LANES<D>, RPI = 32 / LR;  // lanes a row, rows at a time
  constexpr int STAGE_ROW = bwd::STAGE_ROW<D>;
  const int lane = threadIdx.x & 31, d0 = 2 * (lane % LR);
  const float2 sc_lo = __ldg(reinterpret_cast<const float2*>(scale + d0));
  const float2 sc_hi = __ldg(reinterpret_cast<const float2*>(scale + d0 + D / 2));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // sum over the lane's rows of dln xn at d0, d0 + 1, d0 + D/2, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    stage_half<D>(du, stage, r);
#pragma unroll
    for (int it = 0; it < 8 / RPI; ++it) {
      const int rl = RPI * it + lane / LR, i = row0 + 8 * r + rl;
      const bool live = i < S;
      const int at = live ? i : 0;
      const float2 u_lo = *reinterpret_cast<const float2*>(stage + rl * STAGE_ROW + d0);
      const float2 u_hi = *reinterpret_cast<const float2*>(stage + rl * STAGE_ROW + d0 + D / 2);
      const bf16* row = src + (size_t)at * stride;
      const float2 x_lo = live ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(row + d0)))
                               : make_float2(0.f, 0.f);
      const float2 x_hi = live ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(row + d0 + D / 2)))
                               : make_float2(0.f, 0.f);
      const float mean = row_sum<D>(x_lo.x + x_lo.y + x_hi.x + x_hi.y) * inv_d;
      const float sq = row_sum<D>(x_lo.x * x_lo.x + x_lo.y * x_lo.y + x_hi.x * x_hi.x + x_hi.y * x_hi.y);
      const float rstd = rsqrtf(fmaxf(sq * inv_d - mean * mean, 0.f) + LN_EPS);
      const float* c = cos_t + (size_t)at * D;
      const float* sn = sin_t + (size_t)at * D;
      const float2 c_lo = __ldg(reinterpret_cast<const float2*>(c + d0));
      const float2 c_hi = __ldg(reinterpret_cast<const float2*>(c + d0 + D / 2));
      const float2 s_lo = __ldg(reinterpret_cast<const float2*>(sn + d0));
      const float2 s_hi = __ldg(reinterpret_cast<const float2*>(sn + d0 + D / 2));
      // RoPE transpose: rot^T(v)[d < D/2] = v[d + D/2], else -v[d - D/2]
      const float dln[4] = {u_lo.x * c_lo.x + u_hi.x * s_hi.x, u_lo.y * c_lo.y + u_hi.y * s_hi.y,
                            u_hi.x * c_hi.x - u_lo.x * s_lo.x, u_hi.y * c_hi.y - u_lo.y * s_lo.y};
      const float xn[4] = {(x_lo.x - mean) * rstd, (x_lo.y - mean) * rstd, (x_hi.x - mean) * rstd,
                           (x_hi.y - mean) * rstd};
      const float sc[4] = {sc_lo.x, sc_lo.y, sc_hi.x, sc_hi.y};
      float dxn[4], m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (live) acc[k] += dln[k] * xn[k];
        dxn[k] = dln[k] * sc[k];
        m1 += dxn[k];
        m2 += dxn[k] * xn[k];
      }
      m1 = row_sum<D>(m1) * inv_d;
      m2 = row_sum<D>(m2) * inv_d;
      if (live) {
        bf16* out = dst + (size_t)i * stride;
        *reinterpret_cast<uint32_t*>(out + d0) =
            pack_bf16(rstd * (dxn[0] - m1 - xn[0] * m2), rstd * (dxn[1] - m1 - xn[1] * m2));
        *reinterpret_cast<uint32_t*>(out + d0 + D / 2) =
            pack_bf16(rstd * (dxn[2] - m1 - xn[2] * m2), rstd * (dxn[3] - m1 - xn[3] * m2));
      }
    }
  }
  // the warp's sum over its rows, in a fixed order: the lanes of the rows taken
  // at a time (the two half-warps at D = 64), then into red
#pragma unroll
  for (int off = LR; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  if (lane < LR) {
    red[d0] += acc[0], red[d0 + 1] += acc[1];
    red[d0 + D / 2] += acc[2], red[d0 + D / 2 + 1] += acc[3];
  }
  __syncwarp();
}

// grid: slab, one block per `unit` consecutive (sequence, head) pairs; tile,
// one block per pair. Both: the query side of every 16-row query tile, dealt to
// the warps in turn; a barrier; the key side of every 16-row key tile, dealt
// the same way. tests/test_torch_attention_bwd_plan.py walks the same items on
// the CPU.
template <int D, int KT, bool TILE, int MAX_WARPS_, int MIN_BLOCKS_>
__global__ void __launch_bounds__(MAX_WARPS_ * 32, MIN_BLOCKS_) attention_bwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  constexpr int ROW = fa_mma::ROW<D>, P = PIECES<D>, LANES = LN_LANES<D>, STAGE_ROW = bwd::STAGE_ROW<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int S = a.S, H = a.H, s16 = rows16(S), words = key_words(S), tiles = s16 / 16;
  const size_t token = 3 * (size_t)H * D, HD = (size_t)H * D;
  const long long pairs = (long long)a.B * H;
  const int unit = TILE ? 1 : a.unit;
  const long long p0 = (long long)blockIdx.x * unit;
  const size_t pair_elems = TILE ? 4 * (size_t)s16 * ROW : slab_pair_elems<D>(S);
  const int pstride = ps_row(S);
  // part 0 q~, 1 k~, 2 v, 3 dO of the block's pair pl; a slab pair's P, then dS, begin at part 4
  auto rows_of = [&](int pl, int part) {
    return smem + pl * pair_elems + (size_t)part * s16 * ROW;
  };
  float* stats = reinterpret_cast<float*>(smem + unit * pair_elems);  // tile: m | 1/l | row
  unsigned long long* keep = reinterpret_cast<unsigned long long*>(TILE ? stats + 3 * s16 : stats);
  float* red = reinterpret_cast<float*>(keep + unit * words);  // [warp][q, k][D]
  float* stage = red + warps * 2 * D + warp * 8 * STAGE_ROW;      // this warp's staging rows

  // Group 0, the q and k rows; group 1, the v and dO rows. Consecutive threads
  // copy consecutive 16-byte pieces of one position's rows: the pairs of a
  // block are consecutive heads of a sequence, adjacent in memory.
  for (int group = 0; group < 2; ++group) {
    for (int e = threadIdx.x; e < 2 * s16 * unit * P; e += blockDim.x) {
      const int piece = e % P, pl = (e / P) % unit, ri = (e / P) / unit;
      const int i = ri % s16, part = 2 * group + ri / s16;
      const long long p = p0 + pl;
      const bool inside = p < pairs && i < S;
      const bf16* src = a.qkv;
      if (inside) {
        const long long b = p / H;
        const int h = (int)(p % H);
        src = part < 3 ? a.qkv + ((size_t)b * S + i) * token + part * HD + h * D + 8 * piece
                       : a.g + ((size_t)b * S + i) * HD + h * D + 8 * piece;
      }
      cp_async16(rows_of(pl, part) + (size_t)i * ROW + 8 * piece, src, inside ? 16 : 0);
    }
    cp_async_commit();
  }
  for (int pl = 0; pl < unit; ++pl)
    stage_key_bits(keep + pl * words, a.mask, p0 + pl < pairs ? (p0 + pl) / H : 0, S, warp, warps);
  for (int e = lane; e < 2 * D; e += 32) red[warp * 2 * D + e] = 0.f;
  cp_async_wait<1>();
  __syncthreads();
  {  // LN + RoPE of the q and k rows of each (pair, position), four lanes each, pairs fastest
    float qsc[16], ksc[16];
    load_lane_scale<D>(qsc, a.q_scale);
    load_lane_scale<D>(ksc, a.k_scale);
    const int tasks = unit * S, per_warp = 32 / LANES;
    for (int base = per_warp * warp; base < tasks; base += per_warp * warps) {
      const int tk = min(base + lane / LANES, tasks - 1);
      const int pl = tk % unit, i = tk / unit;
      const bool live = base + lane / LANES < tasks && p0 + pl < pairs;
      norm_rope_pair<D>(rows_of(pl, 0) + (size_t)i * ROW, live, qsc, rows_of(pl, 1) + (size_t)i * ROW, live, ksc,
                        a.cos_t + (size_t)i * D, a.sin_t + (size_t)i * D, a.hs.inv_d);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int items = unit * tiles;
  for (int it = warp; it < items; it += warps) {  // query side
    const int pl = it / tiles, mt = it % tiles;
    const long long p = p0 + pl;
    if (p >= pairs) continue;  // uniform per warp
    bf16* p_rows = TILE ? nullptr : rows_of(pl, 4) + (size_t)16 * mt * pstride;
    float dq[D / 8][4], st[2][3];
    query_side<D, KT, TILE>(rows_of(pl, 0) + (size_t)16 * mt * ROW, rows_of(pl, 3) + (size_t)16 * mt * ROW,
                            rows_of(pl, 1), rows_of(pl, 2), keep + pl * words, S, dq, st, p_rows,
                            TILE ? nullptr : p_rows + (size_t)s16 * pstride, pstride, a.hs);
    if (TILE && (lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 16 * mt + (lane >> 2) + 8 * r;
        stats[i] = st[r][0], stats[s16 + i] = st[r][1], stats[2 * s16 + i] = st[r][2];
      }
    }
    const size_t base = (size_t)(p / H) * S * token + (size_t)(p % H) * D;
    ln_rope_bwd<D>(dq, stage, a.qkv + base, a.dqkv + base, token, 16 * mt, S, a.q_scale, a.cos_t, a.sin_t,
                   red + warp * 2 * D, a.hs.inv_d);
  }
  __syncthreads();
  for (int it = warp; it < items; it += warps) {  // key side
    const int pl = it / tiles, kt = it % tiles;
    const long long p = p0 + pl;
    if (p >= pairs) continue;
    float dv[D / 8][4], dk[D / 8][4];
    if (TILE)
      key_side_tile<D>(rows_of(0, 0), rows_of(0, 1), rows_of(0, 2), rows_of(0, 3), stats, stats + s16, stats + 2 * s16,
                       keep, 16 * kt, S, dv, dk, a.hs);
    else
      key_side_slab<D>(rows_of(pl, 4), rows_of(pl, 4) + (size_t)s16 * pstride, pstride, rows_of(pl, 0), rows_of(pl, 3),
                    16 * kt, S, dv, dk);
    const size_t base = (size_t)(p / H) * S * token + (size_t)(p % H) * D;
    store_rows<D>(dv, stage, a.dqkv + base + 2 * HD, token, 16 * kt, S);
    ln_rope_bwd<D>(dk, stage, a.qkv + base + HD, a.dqkv + base + HD, token, 16 * kt, S, a.k_scale, a.cos_t, a.sin_t,
                   red + warp * 2 * D + D, a.hs.inv_d);
  }
  __syncthreads();
  // the block's dscale partials: the warps' sums in warp order
  for (int e = threadIdx.x; e < 2 * D; e += blockDim.x) {
    const int part = e / D, d = e % D;
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) sum += red[(w * 2 + part) * D + d];
    (part ? a.dks_part : a.dqs_part)[(size_t)blockIdx.x * D + d] = sum;
  }
}

template <int D, int KT, bool TILE>
cudaError_t launch_bwd(const Args& a, int warps, int smem, unsigned blocks, cudaStream_t stream) {
  auto kernel = attention_bwd_kernel<D, KT, TILE, TILE ? TILE_WARPS : SLAB_WARPS, TILE ? 1 : SLAB_BLOCKS<D>>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

// Checks the plan (ops/flash_attention.py:fused_attention_bwd_plan: the variant,
// the pairs a slab block and the warps a block) and the partials' row count
// against the shape, and launches. The tile variant is this kernel's at head
// dims 16 and 32 alone: at 64 and 128 the plan takes the wgmma tile
// (fused_attention_bwd_wg.cuh).
template <int D>
cudaError_t launch_attention_bwd_mma(const Args& a, int variant, int warps, int n_blocks,
                                            cudaStream_t stream) {
  const long long pairs = (long long)a.B * a.H;
  long long blocks;
  if (variant == SLAB) {
    if (a.S > SLAB_MAX_SEQ || a.unit < 1 || warps < 1 || warps > SLAB_WARPS) return cudaErrorInvalidValue;
    blocks = (pairs + a.unit - 1) / a.unit;
  } else if (variant == TILE) {
    if (D >= 64 || a.unit != 1 || a.S > TILE_MAX_SEQ || warps < 1 || warps > TILE_WARPS) return cudaErrorInvalidValue;
    blocks = pairs;
  } else {
    return cudaErrorInvalidValue;
  }
  const size_t smem = bwd_smem_bytes<D>(variant, a.S, a.unit, warps);
  if (blocks != n_blocks || blocks > 0x7fffffffLL || smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  if (variant == TILE) {
    if constexpr (D < 64)
      return launch_bwd<D, TILE_KT, true>(a, warps, (int)smem, grid, stream);
    else
      return cudaErrorInvalidValue;
  }
  switch (chunk_steps(a.S)) {  // one chunk holds every key
    case 1:
      return launch_bwd<D, 1, false>(a, warps, (int)smem, grid, stream);
    case 2:
      return launch_bwd<D, 2, false>(a, warps, (int)smem, grid, stream);
    default:
      return launch_bwd<D, 4, false>(a, warps, (int)smem, grid, stream);
  }
}

}  // namespace bwd
}  // namespace fa_mma
