// The "wide" variant of the five attention kernels: every head dim past 128.
// The forward of #1 (fused_attention.cu, and the attention of #7,
// attention_sublayer.cu) and of #5 (flash_attention.cu), the backward of #3
// (fused_attention_bwd.cu) and of #6 (flash_attention_bwd.cu), in bf16 and in
// f32, at a head dim Dp that is a multiple of CHUNK = 128 (the wrapper pads
// another even D > 128 by halves to Dp = 128 ceil(D / 128):
// ops/flash_attention.py:padded_head_dim; the true D's 1/D and 1/sqrt(D) come
// in as HeadScale), at any S.
//
// Why the other variants cannot take D > 128 by a larger instantiation: a
// 256-wide bf16 row is 528 bytes of shared memory, so the tile and slab
// variants, which stage a pair's q, k and v whole, need 405 KB at S = 256; a
// warp's 16-row f32 output at D = 256 is 128 registers a thread before its q
// fragments (on wgmma a 64-row tile is the same). So the wide variant streams
// the head dim: a block owns its rows and ONE 128-column chunk of the output,
// and every product over the head dim (scores, dP) is summed over the Dp / 128
// chunks as they stream through shared memory. A warp's state is then that of
// a D = 128 split kernel (attention_split.cuh): a 16 x 64 f32 score tile and a
// 16 x 128 f32 output chunk.
//
// What bounds it on the H100: the products. The forward is 4 S^2 Dp a pair on
// paper; here each of the Dp / 128 chunk blocks recomputes the scores, so the
// forward does (2 Dp / 128 + 2) S^2 Dp (6 S^2 Dp at Dp = 256), #5 twice the
// score part (it walks the keys twice); the backward recomputes the scores and
// dP in its statistics pass and on each side in every chunk block. This PR
// only needs the kernels to be right; sharing P across a block's chunks, or
// wgmma with 64 x 256 accumulators, is later work (PERF.md).
//
// bf16 (mma.sync m16n8k16, bf16 operands, f32 accumulators, ldmatrix from
// 136-element shared-memory rows, fused_attention_mma_common.cuh):
// - A pass of its own (wide_norm_rope_kernel, one warp a head row, any Dp)
//   writes #1's and #3's q~ and k~ (LN over the row with the true 1/D, the
//   scale, RoPE; rounded to bf16) to a (B, S, H, Dp) workspace. #5 and #6 read
//   q and k as they are.
// - Forward (wide_fwd_kernel): a block takes ROWS = 64 query rows of one pair
//   (a warp each 16) and output chunk ch; the grid is pairs x query tiles x Dp
//   / 128, a tile's chunk blocks adjacent, so that they read the same rows
//   from L2. It walks the key tiles of KEY_TILE = 64: for each, Dp / 128
//   stages each bring 128 columns of the block's q~ rows and the tile's k~ rows
//   (double-buffered by cp.async), whose products the warps sum into the
//   scores; then a stage brings the tile's v rows of chunk ch for P.V. #1 at S
//   >= 128 (JAX's unpacked path): one walk, a running max, P = exp(s - m)
//   rounded unnormalised, 1/l on the f32 output. #1 on JAX's packed path (S <
//   128 and S H % 128 == 0) and #5: a first walk of the score stages alone
//   gives the exact row max and sum, so that P is normalised before its
//   rounding. o is rounded once.
// - Backward, three launches, no atomics (so two runs give the same bits):
//   1. wide_stats_kernel: a block takes 64 query rows of a pair and walks the
//      key tiles once, summing the scores (q~ k~^T) and dP (dO v^T) over the
//      chunks, for each row's max m, 1/l and row = sum_j P dP (m | 1/l | row
//      to an f32 workspace), over the full Dp before any chunk block needs
//      them.
//   2. wide_query_kernel: 64 query rows and chunk ch of dq: per key tile the
//      scores and dP again, P (normalised, f32), dS = P (dP - row) / sqrt(D),
//      then dq += dS (bf16) k~ over the tile's k~ rows of chunk ch.
//   3. wide_key_kernel: 64 key rows and chunk ch of dk and dv: per tile of
//      QUERY_TILE = 32 queries, P^T (k~ q~^T) and dP^T (v dO^T) summed over the
//      chunks, then dv += P^T (bf16) dO and dk += dS^T (bf16) q~ over the
//      tile's rows of chunk ch. 32 queries a tile keep dv and dk (128 f32
//      registers) beside the 16 x 32 score and dP tiles.
//   #3 writes dq~ and dk~ in f32 to its workspace, and wide_ln_rope_bwd_kernel
//   (one warp 8 head rows, any Dp) runs the RoPE transpose, the scale and the
//   LN backward, writing dqkv's q and k parts and a (Dp,) partial of each
//   scale gradient a warp, which the wrapper sums in a fixed order.
// Roundings as the other variants': q~, k~, P and dS to bf16 before their
// products, everything else f32, each output rounded once.
//
// f32 (the CUDA cores; these back the f32 card-vs-CPU checks): the same grid
// and walks, a quad of four lanes a row as in attention_f32_wide.cuh (a lane
// holds 32 floats of a 128-column chunk, and a dot product takes two
// __shfl_xor), the other side staged F32_TILE = 16 rows and one chunk at a
// time, the own rows' chunks read straight from device memory. A Dp-wide row
// does not fit a quad's registers, hence the chunks. f32 throughout.
//
// Masks: a masked key scores -1e30, a key past S -inf, so a row whose keys
// are all masked averages all S keys, as the other variants.
//
// Shared memory: bf16, two buffers of two 64-row arrays of 136 bf16 (69,632
// bytes a block at every Dp and S); f32, two 16-row arrays of 132 floats and
// the statistics (17 KB). tests/helpers/wide_geometry.py mirrors the grid,
// the stages and these sizes.

#pragma once

#include "attention_f32_wide.cuh"
#include "attention_split.cuh"

#include <initializer_list>

namespace fa_mma {
namespace wide {

constexpr int CHUNK = 128;                  // head-dim columns a chunk block owns, and of every stage
constexpr int CROW = ROW<CHUNK>;            // a chunk row in shared memory: 136 bf16
constexpr int ROWS = 64;                    // a block's own rows, a warp each 16
constexpr int WARPS = ROWS / 16;
constexpr int KEY_TILE = 64;                // keys a forward or query-side stage holds
constexpr int KT = KEY_TILE / 16;           // 16-key steps of a key tile
constexpr int QUERY_TILE = 32;              // queries a key-side stage holds
constexpr int QT = QUERY_TILE / 16;
constexpr int MIN_BLOCKS = 2;
constexpr int PREP_WARPS = 8;               // the row passes: warps a block, a warp a head row
constexpr int LN_ROWS = 8;                  // head rows a warp of the LN + RoPE backward takes
constexpr int F32_THREADS = 256;            // f32: a quad a row, 64 rows a block
constexpr int F32_TILE = 16;                // f32: other-side rows a stage
constexpr int F32_ROW = fa_wide::SROW<CHUNK>;  // 132 floats
constexpr size_t SMEM = (size_t)2 * 2 * ROWS * CROW * sizeof(bf16);
constexpr size_t F32_SMEM = ((size_t)2 * F32_TILE * F32_ROW + 3 * F32_TILE) * sizeof(float);
static_assert(KEY_TILE == ROWS && QUERY_TILE <= ROWS, "a stage's arrays are ROWS rows");

// The rows of one (B, S, H, Dp) array: row i of pair (b, h) at base + b
// b_stride + h h_stride + i i_stride, its columns contiguous.
template <typename T>
struct Arr {
  T* base;
  long long b_stride, h_stride, i_stride;
  __host__ __device__ __forceinline__ T* pair(long long p, int H) const {
    return base + (p / H) * b_stride + (p % H) * h_stride;
  }
};

template <typename T>
struct FwdArgs {
  Arr<const T> q, k, v;
  const unsigned char* mask;  // (B, S) or null
  Arr<T> out;
  int B, S, H, Dp;
  HeadScale hs;
};

// TD: the type of dq and dk (bf16, or f32 for #3's dq~ and dk~); dv is T.
template <typename T, typename TD>
struct BwdArgs {
  Arr<const T> q, k, v, g;    // q (#3: q~), k (k~), v, dO
  const unsigned char* mask;  // (B, S) or null
  Arr<TD> dq, dk;
  Arr<T> dv;
  float* stats;  // three runs of B H S, row (pair, i) at pair S + i: bf16 m | 1/l | row, f32 m | l | row
  int B, S, H, Dp;
  HeadScale hs;
};

__host__ __device__ __forceinline__ int tiles_of(int S, int rows) { return (S + rows - 1) / rows; }

// cp.async rows i0 .. i0 + N - 1 of one pair's chunk (row i at src + i stride) to
// dst (row r at dst + r CROW), 16 bytes a thread; a row at or past S zero-filled.
template <int N>
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, long long stride, int i0, int S) {
  constexpr int P = CHUNK / 8;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) {
    const int r = e / P, piece = e % P, i = i0 + r;
    const bool inside = i < S;
    cp_async16(dst + r * CROW + 8 * piece, inside ? src + i * stride + 8 * piece : src, inside ? 16 : 0);
  }
}

// acc[nt] += A . B^T for nt / 2 < steps: A the 16 x 128 fragments af, B the
// rows 8 nt .. 8 nt + 7 of b_rows.
template <int N>
__device__ __forceinline__ void add_dots(float (&acc)[N][4], const uint32_t (&af)[CHUNK / 16][4],
                                         const bf16* b_rows, int steps) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
    if (nt / 2 < steps) dot_rows8<CHUNK>(acc[nt], af, b_rows + 8 * nt * CROW);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// ---- the row passes: LN + RoPE forward and backward, any Dp -----------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Head row r of B S H (position r / H, head r % H) of qkv (B, S, 3 H Dp): LN (no
// bias; f32 statistics over the true head dim, E[x^2] - mean^2 clamped at 0)
// times the scale, then rotate-half RoPE, into qn and kn (B, S, H, Dp), row r at
// r Dp. A warp a row; lane l takes columns 2 l + 64 n, + 1 of each half and
// their partners Dp / 2 on, so every access of a warp is one contiguous piece.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(PREP_WARPS * 32)
wide_norm_rope_kernel(const Tin* __restrict__ qkv, const float* __restrict__ q_scale,
                      const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t, Tout* __restrict__ qn, Tout* __restrict__ kn, long long rows,
                      int S, int H, int Dp, float inv_d) {
  const int lane = threadIdx.x & 31, half = Dp / 2;
  const long long r = (long long)blockIdx.x * PREP_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;  // uniform per warp
  const long long HD = (long long)H * Dp;
  const int i = (int)((r / H) % S);
  const Tin* src = qkv + (r / H) * 3 * HD + (r % H) * Dp;
  const float* cs = cos_t + (size_t)i * Dp;
  const float* sn = sin_t + (size_t)i * Dp;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const Tin* x = src + part * HD;
    const float* scale = part ? k_scale : q_scale;
    Tout* dst = (part ? kn : qn) + r * Dp;
    float s = 0.f, sq = 0.f;
    for (int d = 2 * lane; d < Dp; d += 64) {
      const float2 v = load2(x + d);
      s += v.x + v.y;
      sq += v.x * v.x + v.y * v.y;
    }
    const float mean = warp_sum(s) * inv_d;
    const float rs = rsqrtf(fmaxf(warp_sum(sq) * inv_d - mean * mean, 0.f) + LN_EPS);
    for (int d = 2 * lane; d < half; d += 64) {
      const float2 x1 = load2(x + d), x2 = load2(x + d + half);
      const float a0 = (x1.x - mean) * rs * scale[d], a1 = (x1.y - mean) * rs * scale[d + 1];
      const float b0 = (x2.x - mean) * rs * scale[d + half], b1 = (x2.y - mean) * rs * scale[d + half + 1];
      store2(dst + d, a0 * cs[d] - b0 * sn[d], a1 * cs[d + 1] - b1 * sn[d + 1]);  // rotate_half: (-x2, x1)
      store2(dst + d + half, b0 * cs[d + half] + a0 * sn[d + half], b1 * cs[d + half + 1] + a1 * sn[d + half + 1]);
    }
  }
}

// #3's last pass: from dq~ and dk~ (f32, (B, S, H, Dp) rows as qn's), back
// through RoPE (its transpose), the scale and the LN: dx = r (dxn - mean(dxn) -
// xn mean(dxn xn)), dxn = dln scale, into dqkv's q and k parts; and a (Dp,)
// partial sum over the warp's rows of dln xn for each scale, at row `warp` of
// dqs_part and dks_part. A warp takes LN_ROWS consecutive head rows: their
// statistics first, then the columns, lane l taking 2 l + 64 n, + 1 of each
// half and their partners, so that the partials need no shared memory at any Dp.
template <typename T>
__global__ void __launch_bounds__(PREP_WARPS * 32)
wide_ln_rope_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ q_scale,
                        const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, const float* __restrict__ dqn,
                        const float* __restrict__ dkn, T* __restrict__ dqkv, float* __restrict__ dqs_part,
                        float* __restrict__ dks_part, long long rows, int S, int H, int Dp, float inv_d) {
  const int lane = threadIdx.x & 31, half = Dp / 2;
  const long long warp = (long long)blockIdx.x * PREP_WARPS + (threadIdx.x >> 5), r0 = warp * LN_ROWS;
  if (r0 >= rows) return;  // uniform per warp
  const long long HD = (long long)H * Dp;
  for (int part = 0; part < 2; ++part) {
    const float* scale = part ? k_scale : q_scale;
    const float* du_all = part ? dkn : dqn;
    float mean[LN_ROWS], rs[LN_ROWS], m1[LN_ROWS], m2[LN_ROWS];
    // the rows' statistics: the LN's mean and 1/std, then mean(dxn) and mean(dxn xn)
#pragma unroll
    for (int n = 0; n < LN_ROWS; ++n) {
      const long long r = r0 + n;
      mean[n] = rs[n] = m1[n] = m2[n] = 0.f;
      if (r >= rows) continue;  // uniform per warp
      const T* x = qkv + (r / H) * 3 * HD + part * HD + (r % H) * Dp;
      const float* du = du_all + r * Dp;
      const int i = (int)((r / H) % S);
      const float* cs = cos_t + (size_t)i * Dp;
      const float* sn = sin_t + (size_t)i * Dp;
      float s = 0.f, sq = 0.f;
      for (int d = 2 * lane; d < Dp; d += 64) {
        const float2 v = load2(x + d);
        s += v.x + v.y;
        sq += v.x * v.x + v.y * v.y;
      }
      mean[n] = warp_sum(s) * inv_d;
      rs[n] = rsqrtf(fmaxf(warp_sum(sq) * inv_d - mean[n] * mean[n], 0.f) + LN_EPS);
      float s1 = 0.f, s2 = 0.f;
      for (int d = 2 * lane; d < half; d += 64) {
        const float2 xa = load2(x + d), xb = load2(x + d + half);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = d + e;
          const float xn0 = ((e ? xa.y : xa.x) - mean[n]) * rs[n], xn1 = ((e ? xb.y : xb.x) - mean[n]) * rs[n];
          const float u0 = du[c], u1 = du[c + half];
          // RoPE transpose: rot^T(u)[c < Dp/2] = u[c + Dp/2], else -u[c - Dp/2]
          const float dln0 = u0 * cs[c] + u1 * sn[c + half];
          const float dln1 = u1 * cs[c + half] - u0 * sn[c];
          const float dxn0 = dln0 * scale[c], dxn1 = dln1 * scale[c + half];
          s1 += dxn0 + dxn1;
          s2 += dxn0 * xn0 + dxn1 * xn1;
        }
      }
      m1[n] = warp_sum(s1) * inv_d;
      m2[n] = warp_sum(s2) * inv_d;
    }
    // the columns: dx of every row, and the scale partials
    float* part_row = (part ? dks_part : dqs_part) + warp * Dp;
    for (int d = 2 * lane; d < half; d += 64) {
      float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [column d + e][first half, second half]
#pragma unroll
      for (int n = 0; n < LN_ROWS; ++n) {
        const long long r = r0 + n;
        if (r >= rows) break;
        const size_t at = (size_t)(r / H) * 3 * HD + part * HD + (r % H) * Dp;
        const float* du = du_all + r * Dp;
        const int i = (int)((r / H) % S);
        const float* cs = cos_t + (size_t)i * Dp;
        const float* sn = sin_t + (size_t)i * Dp;
        const float2 xa = load2(qkv + at + d), xb = load2(qkv + at + d + half);
        float out0[2], out1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = d + e;
          const float xn0 = ((e ? xa.y : xa.x) - mean[n]) * rs[n], xn1 = ((e ? xb.y : xb.x) - mean[n]) * rs[n];
          const float u0 = du[c], u1 = du[c + half];
          const float dln0 = u0 * cs[c] + u1 * sn[c + half];
          const float dln1 = u1 * cs[c + half] - u0 * sn[c];
          acc[e][0] += dln0 * xn0;
          acc[e][1] += dln1 * xn1;
          out0[e] = rs[n] * (dln0 * scale[c] - m1[n] - xn0 * m2[n]);
          out1[e] = rs[n] * (dln1 * scale[c + half] - m1[n] - xn1 * m2[n]);
        }
        store2(dqkv + at + d, out0[0], out0[1]);
        store2(dqkv + at + d + half, out1[0], out1[1]);
      }
      store2(part_row + d, acc[0][0], acc[1][0]);
      store2(part_row + d + half, acc[0][1], acc[1][1]);
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_norm_rope(const Tin* qkv, const float* q_scale, const float* k_scale, const float* cos_t,
                             const float* sin_t, Tout* qn, Tout* kn, int B, int S, int H, int Dp, float inv_d,
                             cudaStream_t stream) {
  const long long rows = (long long)B * S * H, blocks = (rows + PREP_WARPS - 1) / PREP_WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wide_norm_rope_kernel<Tin, Tout><<<(unsigned)blocks, PREP_WARPS * 32, 0, stream>>>(
      qkv, q_scale, k_scale, cos_t, sin_t, qn, kn, rows, S, H, Dp, inv_d);
  return cudaGetLastError();
}

// ---- bf16: the forward (#1, #5, #7's attention) -----------------------------

// grid: pairs x query tiles x chunks, blockIdx.x = (pair qtiles + query tile) chunks + ch.
// Stage n of the walks: in the statistics walk (NORMALIZE) key tile n / NC, chunk
// n % NC of q and k; in the last walk NC + 1 stages a key tile, the chunks of q
// and k, then chunk ch of v. Stage n fills buffer n & 1 while the warps take n - 1.
template <bool NORMALIZE>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) wide_fwd_kernel(const FwdArgs<bf16> a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);  // [2 buffers][2 arrays][ROWS][CROW]
  const float C = a.hs.c;
  const int warp = threadIdx.x >> 5;
  const int S = a.S, H = a.H, NC = a.Dp / CHUNK, qtiles = tiles_of(S, ROWS), tiles = tiles_of(S, KEY_TILE);
  const int ch = (int)(blockIdx.x % NC);
  const long long item = blockIdx.x / NC, pair = item / qtiles, b = pair / H;
  const int q0 = (int)(item % qtiles) * ROWS, row0 = q0 + 16 * warp;
  const bf16* qp = a.q.pair(pair, H);
  const bf16* kp = a.k.pair(pair, H);
  const bf16* vp = a.v.pair(pair, H) + ch * CHUNK;
  const int first = NORMALIZE ? tiles * NC : 0;  // stages of the statistics walk
  const int total = first + tiles * (NC + 1);
  auto issue = [&](int n) {
    bf16* buf = smem + (n & 1) * 2 * ROWS * CROW;
    const bool stats = n < first;
    const int rel = stats ? n : n - first, per = stats ? NC : NC + 1;
    const int j0 = rel / per * KEY_TILE, kind = rel % per;
    if (kind < NC) {
      copy_chunk<ROWS>(buf, qp + kind * CHUNK, a.q.i_stride, q0, S);
      copy_chunk<KEY_TILE>(buf + ROWS * CROW, kp + kind * CHUNK, a.k.i_stride, j0, S);
    } else {
      copy_chunk<KEY_TILE>(buf, vp, a.v.i_stride, j0, S);
    }
    cp_async_commit();
  };
  issue(0);
  const bool live = row0 < S;  // the warp has query rows (uniform per warp)
  float o[CHUNK / 8][4], s[2 * KT][4];
  zero(o);
  zero(s);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, il[2] = {1.f, 1.f};
  for (int n = 0; n < total; ++n) {
    if (n + 1 < total) {
      issue(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool stats_walk = n < first;
    const int rel = stats_walk ? n : n - first, per = stats_walk ? NC : NC + 1;
    const int j0 = rel / per * KEY_TILE, kind = rel % per;
    const int steps = min(KT, (S - j0 + 15) / 16);
    const bf16* buf = smem + (n & 1) * 2 * ROWS * CROW;
    if (live && kind < NC) {  // scores += q~ k~^T over this chunk
      if (kind == 0) zero(s);
      uint32_t qf[CHUNK / 16][4];
      bwd::load_rows<CHUNK>(qf, buf + 16 * warp * CROW);
      add_dots<2 * KT>(s, qf, buf + ROWS * CROW, steps);
    }
    if (live && kind == NC - 1) {  // the tile's scores are whole: the softmax
      split::mask_chunk<KT>(s, j0, S, split::key_word(a.mask, b, S, j0));
      if (NORMALIZE && !stats_walk && j0 == 0) {  // the exact row sums of the first walk
        il[0] = 1.f / quad_sum(l[0]);
        il[1] = 1.f / quad_sum(l[1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (NORMALIZE && !stats_walk) break;  // the max and sum are exact already
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float corr = exp2f((m[r] - m_new) * C);  // 0 on the first tile
        m[r] = m_new;
        if (stats_walk) {
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2 * KT; ++nt)
            sum += exp2f((s[nt][2 * r] - m_new) * C) + exp2f((s[nt][2 * r + 1] - m_new) * C);
          l[r] = l[r] * corr + sum;
        } else {  // online: rescale what the earlier tiles summed
          l[r] *= corr;
#pragma unroll
          for (int dn = 0; dn < CHUNK / 8; ++dn) {
            o[dn][2 * r] *= corr;
            o[dn][2 * r + 1] *= corr;
          }
        }
      }
      if (!stats_walk) {
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = exp2f((s[nt][e] - m[e >> 1]) * C);
            if (NORMALIZE)
              s[nt][e] *= il[e >> 1];  // P normalised before it is rounded
            else
              l[e >> 1] += s[nt][e];
          }
      }
    }
    if (live && kind == NC) {  // o += P (rounded to bf16) . v over chunk ch
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (kk < steps) {
          uint32_t pa[4];
          bwd::pack_a(pa, s, kk);
          bwd::mma_rows<CHUNK>(o, pa, buf + 16 * kk * CROW);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer n & 1 before stage n + 2 refills it
  }
  if (!live) return;
  if (!NORMALIZE) {  // P was rounded unnormalised: 1/l on the f32 output
    il[0] = 1.f / quad_sum(l[0]);
    il[1] = 1.f / quad_sum(l[1]);
  }
#pragma unroll
  for (int dn = 0; dn < CHUNK / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] *= NORMALIZE ? 1.f : il[e >> 1];
  split::store_acc<CHUNK, bf16>(o, a.out.pair(pair, H) + ch * CHUNK, a.out.i_stride, row0, S);
}

// ---- bf16: the backward (#3, #6) ------------------------------------------------

// The statistics: grid pairs x query tiles; per key tile NC stages of (q, k) chunks
// then NC of (dO, v) chunks. Writes m | 1/l | row.
template <typename TD>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) wide_stats_kernel(const BwdArgs<bf16, TD> a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const float C = a.hs.c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int S = a.S, H = a.H, NC = a.Dp / CHUNK, qtiles = tiles_of(S, ROWS), tiles = tiles_of(S, KEY_TILE);
  const long long pair = blockIdx.x / qtiles, b = pair / H;
  const int q0 = (int)(blockIdx.x % qtiles) * ROWS, row0 = q0 + 16 * warp;
  const bf16* qp = a.q.pair(pair, H);
  const bf16* kp = a.k.pair(pair, H);
  const bf16* vp = a.v.pair(pair, H);
  const bf16* gp = a.g.pair(pair, H);
  const int per = 2 * NC, total = tiles * per;
  auto issue = [&](int n) {
    bf16* buf = smem + (n & 1) * 2 * ROWS * CROW;
    const int j0 = n / per * KEY_TILE, kind = n % per, c = kind % NC;
    const bool dp_stage = kind >= NC;
    copy_chunk<ROWS>(buf, (dp_stage ? gp : qp) + c * CHUNK, dp_stage ? a.g.i_stride : a.q.i_stride, q0, S);
    copy_chunk<KEY_TILE>(buf + ROWS * CROW, (dp_stage ? vp : kp) + c * CHUNK,
                         dp_stage ? a.v.i_stride : a.k.i_stride, j0, S);
    cp_async_commit();
  };
  issue(0);
  const bool live = row0 < S;
  float s[2 * KT][4], dp[2 * KT][4];
  zero(s);
  zero(dp);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  for (int n = 0; n < total; ++n) {
    if (n + 1 < total) {
      issue(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = n / per * KEY_TILE, kind = n % per;
    const int steps = min(KT, (S - j0 + 15) / 16);
    const bf16* buf = smem + (n & 1) * 2 * ROWS * CROW;
    if (live) {
      if (kind == 0) {
        zero(s);
        zero(dp);
      }
      uint32_t f[CHUNK / 16][4];
      bwd::load_rows<CHUNK>(f, buf + 16 * warp * CROW);
      if (kind < NC)
        add_dots<2 * KT>(s, f, buf + ROWS * CROW, steps);
      else
        add_dots<2 * KT>(dp, f, buf + ROWS * CROW, steps);
      if (kind == per - 1) {  // m, l and sum_j exp(s - m) dP, online
        split::mask_chunk<KT>(s, j0, S, split::key_word(a.mask, b, S, j0));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 2 * KT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
          const float m_new = fmaxf(m[r], quad_max(mx));
          const float corr = exp2f((m[r] - m_new) * C);  // 0 on the first tile
          float sum = 0.f, acc = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              const float p = exp2f((s[nt][e] - m_new) * C);
              sum += p;
              acc += p * dp[nt][e];
            }
          l[r] = l[r] * corr + sum;
          rs[r] = rs[r] * corr + acc;
          m[r] = m_new;
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  float il[2], row[2], st[2][3];
  bwd::finish_stats(m, l, rs, il, row, st);
  if (t == 0) {
    const long long rows = (long long)a.B * H * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + g + 8 * r;
      if (i < S) {
        const long long me = pair * S + i;
        a.stats[me] = st[r][0], a.stats[rows + me] = st[r][1], a.stats[2 * rows + me] = st[r][2];
      }
    }
  }
}

// Query-major: grid pairs x query tiles x chunks; per key tile NC (q, k) stages, NC
// (dO, v) stages, then chunk ch of k for dq.
template <typename TD>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) wide_query_kernel(const BwdArgs<bf16, TD> a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const float C = a.hs.c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int S = a.S, H = a.H, NC = a.Dp / CHUNK, qtiles = tiles_of(S, ROWS), tiles = tiles_of(S, KEY_TILE);
  const int ch = (int)(blockIdx.x % NC);
  const long long item = blockIdx.x / NC, pair = item / qtiles, b = pair / H;
  const int q0 = (int)(item % qtiles) * ROWS, row0 = q0 + 16 * warp;
  const bf16* qp = a.q.pair(pair, H);
  const bf16* kp = a.k.pair(pair, H);
  const bf16* vp = a.v.pair(pair, H);
  const bf16* gp = a.g.pair(pair, H);
  const int per = 2 * NC + 1, total = tiles * per;
  auto issue = [&](int n) {
    bf16* buf = smem + (n & 1) * 2 * ROWS * CROW;
    const int j0 = n / per * KEY_TILE, kind = n % per;
    if (kind < 2 * NC) {
      const int c = kind % NC;
      const bool dp_stage = kind >= NC;
      copy_chunk<ROWS>(buf, (dp_stage ? gp : qp) + c * CHUNK, dp_stage ? a.g.i_stride : a.q.i_stride, q0, S);
      copy_chunk<KEY_TILE>(buf + ROWS * CROW, (dp_stage ? vp : kp) + c * CHUNK,
                           dp_stage ? a.v.i_stride : a.k.i_stride, j0, S);
    } else {
      copy_chunk<KEY_TILE>(buf, kp + ch * CHUNK, a.k.i_stride, j0, S);
    }
    cp_async_commit();
  };
  issue(0);
  const bool live = row0 < S;
  float stat[2][3] = {{0.f, 1.f, 0.f}, {0.f, 1.f, 0.f}};  // m, 1/l, row of rows g and g + 8
  if (live) {
    const long long rows = (long long)a.B * H * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = min(row0 + g + 8 * r, S - 1);
      const long long me = pair * S + i;
      stat[r][0] = a.stats[me], stat[r][1] = a.stats[rows + me], stat[r][2] = a.stats[2 * rows + me];
    }
  }
  float dq[CHUNK / 8][4], s[2 * KT][4], dp[2 * KT][4];
  zero(dq);
  zero(s);
  zero(dp);
  for (int n = 0; n < total; ++n) {
    if (n + 1 < total) {
      issue(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = n / per * KEY_TILE, kind = n % per;
    const int steps = min(KT, (S - j0 + 15) / 16);
    const bf16* buf = smem + (n & 1) * 2 * ROWS * CROW;
    if (live && kind < 2 * NC) {
      if (kind == 0) {
        zero(s);
        zero(dp);
      }
      uint32_t f[CHUNK / 16][4];
      bwd::load_rows<CHUNK>(f, buf + 16 * warp * CROW);
      if (kind < NC)
        add_dots<2 * KT>(s, f, buf + ROWS * CROW, steps);
      else
        add_dots<2 * KT>(dp, f, buf + ROWS * CROW, steps);
      if (kind == 2 * NC - 1) {  // P (normalised, f32) and dS
        split::mask_chunk<KT>(s, j0, S, split::key_word(a.mask, b, S, j0));
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f((s[nt][e] - stat[e >> 1][0]) * C) * stat[e >> 1][1];
            dp[nt][e] = p * (dp[nt][e] - stat[e >> 1][2]) * a.hs.scale;
          }
      }
    }
    if (live && kind == 2 * NC) {  // dq += dS (bf16) . k over chunk ch
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (kk < steps) {
          uint32_t da[4];
          bwd::pack_a(da, dp, kk);
          bwd::mma_rows<CHUNK>(dq, da, buf + 16 * kk * CROW);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  split::store_acc<CHUNK, TD>(dq, a.dq.pair(pair, H) + ch * CHUNK, a.dq.i_stride, row0, S);
}

// Key-major: grid pairs x key tiles x chunks; per tile of QUERY_TILE queries NC
// (k, q) stages, NC (v, dO) stages, then chunk ch of q and dO for dk and dv.
template <typename TD>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) wide_key_kernel(const BwdArgs<bf16, TD> a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const float C = a.hs.c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int S = a.S, H = a.H, NC = a.Dp / CHUNK, ktiles = tiles_of(S, ROWS), tiles = tiles_of(S, QUERY_TILE);
  const int ch = (int)(blockIdx.x % NC);
  const long long item = blockIdx.x / NC, pair = item / ktiles, b = pair / H;
  const long long rows = (long long)a.B * H * S;
  const int j0 = (int)(item % ktiles) * ROWS, k0 = j0 + 16 * warp;
  const bf16* qp = a.q.pair(pair, H);
  const bf16* kp = a.k.pair(pair, H);
  const bf16* vp = a.v.pair(pair, H);
  const bf16* gp = a.g.pair(pair, H);
  const int per = 2 * NC + 1, total = tiles * per;
  auto issue = [&](int n) {
    bf16* buf = smem + (n & 1) * 2 * ROWS * CROW;
    const int i0 = n / per * QUERY_TILE, kind = n % per;
    if (kind < 2 * NC) {
      const int c = kind % NC;
      const bool dp_stage = kind >= NC;
      copy_chunk<ROWS>(buf, (dp_stage ? vp : kp) + c * CHUNK, dp_stage ? a.v.i_stride : a.k.i_stride, j0, S);
      copy_chunk<QUERY_TILE>(buf + ROWS * CROW, (dp_stage ? gp : qp) + c * CHUNK,
                             dp_stage ? a.g.i_stride : a.q.i_stride, i0, S);
    } else {
      copy_chunk<QUERY_TILE>(buf, qp + ch * CHUNK, a.q.i_stride, i0, S);
      copy_chunk<QUERY_TILE>(buf + ROWS * CROW, gp + ch * CHUNK, a.g.i_stride, i0, S);
    }
    cp_async_commit();
  };
  issue(0);
  const bool live = k0 < S;  // uniform per warp
  bool masked[2];  // keys k0 + g and k0 + g + 8: masked, or past S (whose rows are not written)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + g + 8 * r;
    masked[r] = j >= S || (a.mask != nullptr && !a.mask[b * S + j]);
  }
  float dv[CHUNK / 8][4], dk[CHUNK / 8][4], st[2 * QT][4], dt[2 * QT][4];
  zero(dv);
  zero(dk);
  zero(st);
  zero(dt);
  for (int n = 0; n < total; ++n) {
    if (n + 1 < total) {
      issue(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = n / per * QUERY_TILE, kind = n % per;
    const int steps = min(QT, (S - i0 + 15) / 16);
    const bf16* buf = smem + (n & 1) * 2 * ROWS * CROW;
    if (live && kind < 2 * NC) {  // P^T and dP^T over this chunk: k q^T, v dO^T
      if (kind == 0) {
        zero(st);
        zero(dt);
      }
      uint32_t f[CHUNK / 16][4];
      bwd::load_rows<CHUNK>(f, buf + 16 * warp * CROW);
      if (kind < NC)
        add_dots<2 * QT>(st, f, buf + ROWS * CROW, steps);
      else
        add_dots<2 * QT>(dt, f, buf + ROWS * CROW, steps);
      if (kind == 2 * NC - 1) {  // P^T and dS^T from the queries' statistics
#pragma unroll
        for (int nt = 0; nt < 2 * QT; ++nt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int i = i0 + 8 * nt + 2 * t + e1;
            const bool in = i < S;
            const long long me = pair * S + (in ? i : 0);
            const float mi = in ? a.stats[me] : 0.f, inv = in ? a.stats[rows + me] : 0.f;
            const float row = in ? a.stats[2 * rows + me] : 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + e1;
              const float p = in ? exp2f(((masked[r] ? NEG_INF : st[nt][e]) - mi) * C) * inv : 0.f;
              st[nt][e] = p;
              dt[nt][e] = p * (dt[nt][e] - row) * a.hs.scale;
            }
          }
      }
    }
    if (live && kind == 2 * NC) {  // dv += P^T dO, dk += dS^T q over chunk ch
#pragma unroll
      for (int kk = 0; kk < QT; ++kk) {
        if (kk < steps) {
          uint32_t ap[4], ad[4];
          bwd::pack_a(ap, st, kk);
          bwd::pack_a(ad, dt, kk);
          bwd::mma_rows<CHUNK>(dv, ap, buf + ROWS * CROW + 16 * kk * CROW);
          bwd::mma_rows<CHUNK>(dk, ad, buf + 16 * kk * CROW);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  split::store_acc<CHUNK, bf16>(dv, a.dv.pair(pair, H) + ch * CHUNK, a.dv.i_stride, k0, S);
  split::store_acc<CHUNK, TD>(dk, a.dk.pair(pair, H) + ch * CHUNK, a.dk.i_stride, k0, S);
}

// ---- f32: the same walks on the CUDA cores ----------------------------------

// Rows i0 .. i0 + F32_TILE - 1 of chunk c of a pair's array into dst (row r at dst +
// r F32_ROW), a row at or past S zero.
__device__ __forceinline__ void stage_f32(float* dst, const float* pair_base, long long stride, int c, int i0,
                                          int S) {
  constexpr int C4 = CHUNK / 4;
  for (int e = threadIdx.x; e < F32_TILE * C4; e += blockDim.x) {
    const int r = e / C4, q = e % C4, i = i0 + r;
    const float4 v = i < S ? reinterpret_cast<const float4*>(pair_base + i * stride + c * CHUNK)[q]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(dst + r * F32_ROW)[q] = v;
  }
}

// s[j] (+)= the whole-row dot of the own row (its chunks read by load) with staged rows j.
__device__ __forceinline__ void quad_dots(float (&s)[F32_TILE], const float (&part)[fa_wide::PART<CHUNK>],
                                          const float* rows_s, int q) {
#pragma unroll
  for (int j = 0; j < F32_TILE; ++j) s[j] += fa_wide::quad_dot<CHUNK>(part, rows_s + j * F32_ROW, q);
}

struct QuadRow {  // the own row of a thread's quad
  long long pair, b;
  int i, ch;     // its position (clamped into S) and the block's chunk
  bool active;
  int i0;        // the block's first own row
};

// grid: pairs x tiles of 64 own rows [x chunks]; a quad a row
__device__ __forceinline__ QuadRow quad_row(int S, int H, int NC) {
  QuadRow r;
  const int tiles = tiles_of(S, ROWS);
  r.ch = (int)(blockIdx.x % NC);
  const long long item = blockIdx.x / NC;
  r.pair = item / tiles;
  r.b = r.pair / H;
  r.i0 = (int)(item % tiles) * ROWS;
  const int i = r.i0 + (int)threadIdx.x / fa_wide::QUAD;
  r.active = i < S;
  r.i = min(i, S - 1);
  return r;
}

__device__ __forceinline__ bool key_kept(const unsigned char* mask, long long b, int S, int j) {
  return j < S && (mask == nullptr || mask[b * S + j]);
}

// The forward: out = softmax(q k^T scale + key mask) v, one walk with a running max.
__global__ void __launch_bounds__(F32_THREADS) wide_f32_fwd_kernel(const FwdArgs<float> a) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + F32_TILE * F32_ROW;
  const int S = a.S, H = a.H, NC = a.Dp / CHUNK, q = threadIdx.x % fa_wide::QUAD;
  const QuadRow me = quad_row(S, H, NC);
  const float* qrow = a.q.pair(me.pair, H) + me.i * a.q.i_stride;
  const float* kp = a.k.pair(me.pair, H);
  const float* vp = a.v.pair(me.pair, H);
  constexpr int P = fa_wide::PART<CHUNK>;
  float acc[P];
#pragma unroll
  for (int d = 0; d < P; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < S; j0 += F32_TILE) {
    float s[F32_TILE];
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) s[j] = 0.f;
    for (int c = 0; c < NC; ++c) {
      __syncthreads();
      stage_f32(k_s, kp, a.k.i_stride, c, j0, S);
      __syncthreads();
      float qv[P];
      fa_wide::load_part<CHUNK>(qv, qrow + c * CHUNK, q);
      quad_dots(s, qv, k_s, q);
    }
    __syncthreads();
    stage_f32(v_s, vp, a.v.i_stride, me.ch, j0, S);
    __syncthreads();
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) {
      s[j] = j0 + j >= S ? -INFINITY : key_kept(a.mask, me.b, S, j0 + j) ? s[j] * a.hs.scale : NEG_INF;
      cmax = fmaxf(cmax, s[j]);
    }
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    m = m_new;
    l *= corr;
#pragma unroll
    for (int d = 0; d < P; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) {
      if (j0 + j < S) {
        const float p = expf(s[j] - m);
        l += p;
        fa_wide::axpy_part<CHUNK>(acc, p, v_s + j * F32_ROW, q);
      }
    }
  }
  if (!me.active) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < P; ++d) acc[d] *= inv;
  fa_wide::store_part<CHUNK>(a.out.pair(me.pair, H) + me.i * a.out.i_stride + me.ch * CHUNK, acc, q);
}

// The backward's scores and dP of a quad's own query row against F32_TILE staged
// keys from j0, summed over the chunks.
__device__ __forceinline__ void f32_scores(float (&s)[F32_TILE], float (&dp)[F32_TILE], float* k_s, float* v_s,
                                           const BwdArgs<float, float>& a, const QuadRow& me, int j0, int q) {
  constexpr int P = fa_wide::PART<CHUNK>;
  const int NC = a.Dp / CHUNK;
  const float* qrow = a.q.pair(me.pair, a.H) + me.i * a.q.i_stride;
  const float* grow = a.g.pair(me.pair, a.H) + me.i * a.g.i_stride;
#pragma unroll
  for (int j = 0; j < F32_TILE; ++j) s[j] = dp[j] = 0.f;
  for (int c = 0; c < NC; ++c) {
    __syncthreads();
    stage_f32(k_s, a.k.pair(me.pair, a.H), a.k.i_stride, c, j0, a.S);
    stage_f32(v_s, a.v.pair(me.pair, a.H), a.v.i_stride, c, j0, a.S);
    __syncthreads();
    float x[P];
    fa_wide::load_part<CHUNK>(x, qrow + c * CHUNK, q);
    quad_dots(s, x, k_s, q);
    fa_wide::load_part<CHUNK>(x, grow + c * CHUNK, q);
    quad_dots(dp, x, v_s, q);
  }
#pragma unroll
  for (int j = 0; j < F32_TILE; ++j)
    s[j] = j0 + j >= a.S ? -INFINITY : key_kept(a.mask, me.b, a.S, j0 + j) ? s[j] * a.hs.scale : NEG_INF;
}

// Statistics: grid pairs x query tiles; m | l | row, as the f32 kernels' workspace.
__global__ void __launch_bounds__(F32_THREADS) wide_f32_stats_kernel(const BwdArgs<float, float> a) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + F32_TILE * F32_ROW;
  const int q = threadIdx.x % fa_wide::QUAD;
  const QuadRow me = quad_row(a.S, a.H, 1);
  float m = -INFINITY, l = 0.f, racc = 0.f;
  for (int j0 = 0; j0 < a.S; j0 += F32_TILE) {
    float s[F32_TILE], dp[F32_TILE];
    f32_scores(s, dp, k_s, v_s, a, me, j0, q);
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) {
      if (j0 + j < a.S) {
        const float m_new = fmaxf(m, s[j]);
        const float corr = expf(m - m_new);  // 0 on the first key (m = -inf)
        const float p = expf(s[j] - m_new);
        l = l * corr + p;
        racc = racc * corr + p * dp[j];
        m = m_new;
      }
    }
  }
  if (!me.active || q != 0) return;
  const long long rows = (long long)a.B * a.H * a.S, at = me.pair * a.S + me.i;
  a.stats[at] = m;
  a.stats[rows + at] = l;
  a.stats[2 * rows + at] = racc / l;
}

// Query side: grid pairs x query tiles x chunks; dq = sum_j P (dP - row) scale k_j over chunk ch.
__global__ void __launch_bounds__(F32_THREADS) wide_f32_query_kernel(const BwdArgs<float, float> a) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + F32_TILE * F32_ROW;
  constexpr int P = fa_wide::PART<CHUNK>;
  const int q = threadIdx.x % fa_wide::QUAD;
  const QuadRow me = quad_row(a.S, a.H, a.Dp / CHUNK);
  const long long rows = (long long)a.B * a.H * a.S, at = me.pair * a.S + me.i;
  const float m = a.stats[at], inv_l = 1.f / a.stats[rows + at], row = a.stats[2 * rows + at];
  float acc[P];
#pragma unroll
  for (int d = 0; d < P; ++d) acc[d] = 0.f;
  for (int j0 = 0; j0 < a.S; j0 += F32_TILE) {
    float s[F32_TILE], dp[F32_TILE];
    f32_scores(s, dp, k_s, v_s, a, me, j0, q);
    __syncthreads();
    stage_f32(k_s, a.k.pair(me.pair, a.H), a.k.i_stride, me.ch, j0, a.S);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) {
      if (j0 + j < a.S) {
        const float p = expf(s[j] - m) * inv_l;
        fa_wide::axpy_part<CHUNK>(acc, p * (dp[j] - row) * a.hs.scale, k_s + j * F32_ROW, q);
      }
    }
  }
  if (!me.active) return;
  fa_wide::store_part<CHUNK>(a.dq.pair(me.pair, a.H) + me.i * a.dq.i_stride + me.ch * CHUNK, acc, q);
}

// Key side: grid pairs x key tiles x chunks; a quad a key row j: over the queries i,
// P_ij from their m and l, dv += P_ij dO_i, dk += P_ij (dP_ij - row_i) scale q_i, chunk ch.
__global__ void __launch_bounds__(F32_THREADS) wide_f32_key_kernel(const BwdArgs<float, float> a) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + F32_TILE * F32_ROW;
  float* m_s = do_s + F32_TILE * F32_ROW;  // [m, l, row][F32_TILE]
  constexpr int P = fa_wide::PART<CHUNK>;
  const int q = threadIdx.x % fa_wide::QUAD, NC = a.Dp / CHUNK, S = a.S, H = a.H;
  const QuadRow me = quad_row(S, H, NC);
  const long long rows = (long long)a.B * H * S;
  const bool masked = !key_kept(a.mask, me.b, S, me.i);
  const float* krow = a.k.pair(me.pair, H) + me.i * a.k.i_stride;
  const float* vrow = a.v.pair(me.pair, H) + me.i * a.v.i_stride;
  const float* qp = a.q.pair(me.pair, H);
  const float* gp = a.g.pair(me.pair, H);
  float dk[P], dv[P];
#pragma unroll
  for (int d = 0; d < P; ++d) dk[d] = dv[d] = 0.f;
  for (int i0 = 0; i0 < S; i0 += F32_TILE) {
    float st[F32_TILE], dt[F32_TILE];
#pragma unroll
    for (int i = 0; i < F32_TILE; ++i) st[i] = dt[i] = 0.f;
    for (int c = 0; c < NC; ++c) {
      __syncthreads();
      stage_f32(q_s, qp, a.q.i_stride, c, i0, S);
      stage_f32(do_s, gp, a.g.i_stride, c, i0, S);
      __syncthreads();
      float x[P];
      fa_wide::load_part<CHUNK>(x, krow + c * CHUNK, q);
      quad_dots(st, x, q_s, q);
      fa_wide::load_part<CHUNK>(x, vrow + c * CHUNK, q);
      quad_dots(dt, x, do_s, q);
    }
    __syncthreads();
    stage_f32(q_s, qp, a.q.i_stride, me.ch, i0, S);
    stage_f32(do_s, gp, a.g.i_stride, me.ch, i0, S);
    for (int e = threadIdx.x; e < 3 * F32_TILE; e += blockDim.x) {  // a query past S: m 0, l 1, row 0
      const int part = e / F32_TILE, i = i0 + e % F32_TILE;
      m_s[e] = i < S ? a.stats[part * rows + me.pair * S + i] : part == 1 ? 1.f : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < F32_TILE; ++i) {
      if (i0 + i < S) {
        const float s = masked ? NEG_INF : st[i] * a.hs.scale;
        const float p = expf(s - m_s[i]) * (1.f / m_s[F32_TILE + i]);
        fa_wide::axpy_part<CHUNK>(dv, p, do_s + i * F32_ROW, q);
        fa_wide::axpy_part<CHUNK>(dk, p * (dt[i] - m_s[2 * F32_TILE + i]) * a.hs.scale, q_s + i * F32_ROW, q);
      }
    }
  }
  if (!me.active) return;
  fa_wide::store_part<CHUNK>(a.dk.pair(me.pair, H) + me.i * a.dk.i_stride + me.ch * CHUNK, dk, q);
  fa_wide::store_part<CHUNK>(a.dv.pair(me.pair, H) + me.i * a.dv.i_stride + me.ch * CHUNK, dv, q);
}

// ---- launches ------------------------------------------------------------------

// The wide variant takes a head dim past 128 that is a multiple of CHUNK.
__host__ inline bool takes(int Dp) { return Dp > CHUNK && Dp % CHUNK == 0; }

// blocks of a launch over the pairs' tiles of `rows` own rows and `chunks` chunks
__host__ inline long long grid(int B, int S, int H, int chunks) { return (long long)B * H * tiles_of(S, ROWS) * chunks; }

// normalize: P normalised before its rounding (bf16 #5, and #1 on JAX's packed path).
template <typename T>
cudaError_t launch_fwd(const FwdArgs<T>& a, bool normalize, cudaStream_t stream) {
  const long long blocks = grid(a.B, a.S, a.H, a.Dp / CHUNK);
  if (!takes(a.Dp) || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    auto kernel = normalize ? &wide_fwd_kernel<true> : &wide_fwd_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, WARPS * 32, SMEM, stream>>>(a);
  } else {
    wide_f32_fwd_kernel<<<(unsigned)blocks, F32_THREADS, F32_SMEM, stream>>>(a);
  }
  return cudaGetLastError();
}

// The three launches of the backward: statistics, query side, key side.
template <typename T, typename TD>
cudaError_t launch_bwd(const BwdArgs<T, TD>& a, cudaStream_t stream) {
  const int NC = a.Dp / CHUNK;
  const long long stats_blocks = grid(a.B, a.S, a.H, 1), blocks = grid(a.B, a.S, a.H, NC);
  if (!takes(a.Dp) || a.stats == nullptr || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    for (auto kernel : {&wide_stats_kernel<TD>, &wide_query_kernel<TD>, &wide_key_kernel<TD>}) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
      if (err != cudaSuccess) return err;
    }
    wide_stats_kernel<TD><<<(unsigned)stats_blocks, WARPS * 32, SMEM, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    wide_query_kernel<TD><<<(unsigned)blocks, WARPS * 32, SMEM, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    wide_key_kernel<TD><<<(unsigned)blocks, WARPS * 32, SMEM, stream>>>(a);
  } else {
    static_assert(std::is_same<TD, float>::value, "f32 gradients are f32");
    wide_f32_stats_kernel<<<(unsigned)stats_blocks, F32_THREADS, F32_SMEM, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    wide_f32_query_kernel<<<(unsigned)blocks, F32_THREADS, F32_SMEM, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    wide_f32_key_kernel<<<(unsigned)blocks, F32_THREADS, F32_SMEM, stream>>>(a);
  }
  return cudaGetLastError();
}

// #1 (and #7's attention): the LN + RoPE pass into work (q~ | k~, (B, S, H, Dp)
// each, in T), then the forward on them and v straight from qkv.
template <typename T>
cudaError_t launch_fused_fwd(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                             const void* sin_t, const void* mask, void* out, void* work, int B, int S, int H, int Dp,
                             const HeadScale& hs, cudaStream_t stream) {
  if (work == nullptr || !takes(Dp)) return cudaErrorInvalidValue;
  const long long HD = (long long)H * Dp, rows = (long long)B * S * H;
  const T* x = static_cast<const T*>(qkv);
  T* qn = static_cast<T*>(work);
  T* kn = qn + rows * Dp;
  cudaError_t err = launch_norm_rope<T, T>(x, static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
                                           static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), qn, kn,
                                           B, S, H, Dp, hs.inv_d, stream);
  if (err != cudaSuccess) return err;
  const Arr<const T> qa{qn, S * HD, Dp, HD}, ka{kn, S * HD, Dp, HD}, va{x + 2 * HD, S * 3 * HD, Dp, 3 * HD};
  const FwdArgs<T> a{qa, ka, va, static_cast<const unsigned char*>(mask), Arr<T>{static_cast<T*>(out), S * HD, Dp, HD},
                     B, S, H, Dp, hs};
  // P normalised before its rounding where the JAX package takes its packed path
  return launch_fwd<T>(a, S < 128 && (long long)S * H % 128 == 0, stream);
}

// #3: work (f32 words) = dq~ | dk~ (f32, (B, S, H, Dp) each) | q~ | k~ (in T) | m | 1/l | row
// (bf16; m | l | row for f32), B H S each. dqs_part, dks_part: (ceil(B S H / LN_ROWS), Dp).
template <typename T>
cudaError_t launch_fused_bwd(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                             const void* sin_t, const void* mask, const void* g, void* dqkv, void* dqs_part,
                             void* dks_part, void* work, int B, int S, int H, int Dp, int n_blocks,
                             const HeadScale& hs, cudaStream_t stream) {
  const long long HD = (long long)H * Dp, rows = (long long)B * S * H, token = 3 * HD;
  const long long warps = (rows + LN_ROWS - 1) / LN_ROWS;
  if (work == nullptr || !takes(Dp) || n_blocks != warps || (warps + PREP_WARPS - 1) / PREP_WARPS > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  float* dqn = static_cast<float*>(work);
  float* dkn = dqn + rows * Dp;
  T* qn = reinterpret_cast<T*>(dkn + rows * Dp);
  T* kn = qn + rows * Dp;
  float* stats = reinterpret_cast<float*>(kn + rows * Dp);
  const T* x = static_cast<const T*>(qkv);
  const float* qs = static_cast<const float*>(q_scale);
  const float* ks = static_cast<const float*>(k_scale);
  const float* ct = static_cast<const float*>(cos_t);
  const float* st = static_cast<const float*>(sin_t);
  cudaError_t err = launch_norm_rope<T, T>(x, qs, ks, ct, st, qn, kn, B, S, H, Dp, hs.inv_d, stream);
  if (err != cudaSuccess) return err;
  auto tilde = [&](T* p) { return Arr<const T>{p, S * HD, Dp, HD}; };
  auto grad = [&](float* p) { return Arr<float>{p, S * HD, Dp, HD}; };
  const BwdArgs<T, float> a{tilde(qn), tilde(kn), Arr<const T>{x + 2 * HD, S * token, Dp, token},
                            Arr<const T>{static_cast<const T*>(g), S * HD, Dp, HD},
                            static_cast<const unsigned char*>(mask), grad(dqn), grad(dkn),
                            Arr<T>{static_cast<T*>(dqkv) + 2 * HD, S * token, Dp, token}, stats, B, S, H, Dp, hs};
  err = launch_bwd<T, float>(a, stream);
  if (err != cudaSuccess) return err;
  wide_ln_rope_bwd_kernel<T><<<(unsigned)((warps + PREP_WARPS - 1) / PREP_WARPS), PREP_WARPS * 32, 0, stream>>>(
      x, qs, ks, ct, st, dqn, dkn, static_cast<T*>(dqkv), static_cast<float*>(dqs_part),
      static_cast<float*>(dks_part), rows, S, H, Dp, hs.inv_d);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace fa_mma
