// Device helpers shared by the bf16 fused attention forward
// (fused_attention_mma.cuh) and backward (fused_attention_bwd_mma.cuh) and the
// bf16 plain attention backward (flash_attention_bwd_mma.cuh) on the tensor
// cores: cp.async staging, ldmatrix and mma.sync m16n8k16 (bf16 operands, f32
// accumulators), the LN + RoPE of a q row and a k row in shared memory, the
// key bits of a key mask, and (namespace bwd) the softmax backward of a 16-row
// tile that both backward kernels run.
//
// The head dim D is a template parameter of every kernel and of every helper
// that depends on it; with_head_dim lists the values the entry points
// instantiate. A call at another even head dim d < D runs the instantiation D
// with its heads padded by halves (HeadScale). Rows of D bf16 sit in shared memory in D + 8-element rows
// (144 bytes at D = 64; 48, 80 and 272 at D = 16, 32 and 128): the 8 row
// addresses of an ldmatrix then fall on 8 distinct 16-byte bank groups (row
// strides of 12, 20, 36 and 68 words), so every ldmatrix is free of bank
// conflicts. Key bits: bit j % 64 of word j / 64 is 1 where key j is kept.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace fa_mma {

using bf16 = __nv_bfloat16;

template <int D> constexpr int ROW = D + 8;  // shared-memory row in bf16
template <int D> constexpr int ROW_BYTES = 2 * ROW<D>;
template <int D> constexpr int PIECES = D / 8;  // 16-byte pieces of a head row
constexpr int MAX_SMEM = 232448;  // what one block may ask for on the H100 (227 KB)
// the plan's variant codes (ops/flash_attention.py:MMA_VARIANTS); TILE_WG, #3's wgmma tile, the backward's alone;
// WIDE, every head dim past 128 in both dtypes (attention_wide.cuh)
constexpr int SLAB = 0, TILE = 1, SPLIT = 2, TILE_WG = 3, WIDE = 4;
constexpr int TILE_MAX_SEQ = 256;  // the longest sequence of the slab and tile variants; split takes longer ones
constexpr float NEG_INF = -1e30f;  // the JAX kernels' masked score
constexpr float LN_EPS = 1e-6f;
constexpr float LOG2E = 1.4426950408889634f;

// The true head dim d's constants, at run time. The wrapper pads a head of d
// to the instantiation D >= d by halves (ops/flash_attention.py:pad_heads:
// columns [0, d/2) stay, [d/2, d) move to [D/2, D/2 + d/2), the rest zero,
// and so do the RoPE tables and the LN scales, a padded column's scale 0).
// Zero columns add nothing to a row's sums or products, so the kernels run
// at D with the LN statistics' 1/d and the scores' 1/sqrt(d); a padded
// column of q~ and k~ is 0 (its scale is), and the LN backward's means take
// nothing from it (dln times a zero scale). At d = D these are the constants
// of the instantiation: 1/D, and 1/sqrt(D) rounded to f32.
struct HeadScale {
  float inv_d;  // 1/d
  float scale;  // 1/sqrt(d) rounded to f32: the JAX kernels' Python float 1 / d**0.5
  float c;      // scale * LOG2E: the scale in the exp2 domain
};

// The entry points' check of the true head dim against the instantiation.
__host__ inline bool takes_head(int d, int D, float scale) { return d >= 2 && d <= D && d % 2 == 0 && scale > 0.f; }
__host__ inline HeadScale head_scale(int d, float scale) { return {1.f / (float)d, scale, scale * LOG2E}; }

// Calls f(std::integral_constant<int, D>{}) for the head dims the kernels are
// instantiated for (ops/flash_attention.py:KERNEL_HEAD_DIMS); any other is refused.
template <typename F>
cudaError_t with_head_dim(int head_dim, F&& f) {
  switch (head_dim) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

__host__ __device__ __forceinline__ int rows16(int S) { return (S + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int key_words(int S) { return (S + 63) / 64; }
// 16-key steps per online-softmax chunk: the whole row up to 64 keys, then 64 at a time
__host__ __device__ __forceinline__ int chunk_steps(int S) { return rows16(S) <= 16 ? 1 : rows16(S) <= 32 ? 2 : 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// two 8 x 8 matrices: lanes 0-7 give the rows of the first, lanes 8-15 of the second
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16 x 16, row major) * b (16 x 8, column major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// acc (16 x 8) += A . B^T over D: A the 16 x D fragments af (af[ks]: dims
// 16 ks .. 16 ks + 15), B the 8 D-wide rows from b_row0 in shared memory, read
// by ldmatrix (an x4 for each 32 dims; an x2 at D = 16).
template <int D>
__device__ __forceinline__ void dot_rows8(float (&acc)[4], const uint32_t (&af)[D / 16][4], const bf16* b_row0) {
  const int lane = threadIdx.x & 31;
  if constexpr (D == 16) {
    uint32_t b[2];
    ldsm_x2(b, b_row0 + (lane & 7) * ROW<D> + 8 * ((lane >> 3) & 1));
    mma(acc, af[0], b[0], b[1]);
  } else {
#pragma unroll
    for (int hf = 0; hf < D / 32; ++hf) {  // d in [32 hf, 32 hf + 32): two 16-deep k-steps
      uint32_t b[4];
      ldsm_x4(b, b_row0 + (lane & 7) * ROW<D> + 32 * hf + 8 * (lane >> 3));
      mma(acc, af[2 * hf], b[0], b[1]);
      mma(acc, af[2 * hf + 1], b[2], b[3]);
    }
  }
}

// LN + RoPE lanes: D / 16 own a row (4 at D = 64, 1 at D = 16). Lane c of them
// holds elements 8c .. 8c + 7 and their rotate-half partners D/2 + 8c .. D/2 +
// 8c + 7, so the rotation needs no shuffle; the row's sums come from __shfl_xor
// over the row's lanes.
template <int D> constexpr int LN_LANES = D / 16;

// The scales of the 16 elements a lane owns, in the order it holds them.
template <int D>
__device__ __forceinline__ void load_lane_scale(float (&dst)[16], const float* __restrict__ scale) {
  const int c = threadIdx.x & (LN_LANES<D> - 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(scale + 8 * c) + h);
    const float4 b = __ldg(reinterpret_cast<const float4*>(scale + D / 2 + 8 * c) + h);
    dst[4 * h] = a.x, dst[4 * h + 1] = a.y, dst[4 * h + 2] = a.z, dst[4 * h + 3] = a.w;
    dst[8 + 4 * h] = b.x, dst[8 + 4 * h + 1] = b.y, dst[8 + 4 * h + 2] = b.z, dst[8 + 4 * h + 3] = b.w;
  }
}

// LayerNorm (no bias; f32 statistics, E[x^2] - mean^2 clamped at 0, over the
// true head dim: inv_d = 1/d) times the (D,) scale, then rotate-half RoPE, of two
// D-element bf16 rows in shared memory that share a position (a q row and a k
// row), in place, rounded to bf16: one load of the cos/sin rows serves both, and
// their two chains run side by side. Every lane of the warp calls it (the
// shuffles take all 32); a row whose `live` is false is neither read nor written.
template <int D>
__device__ __forceinline__ void norm_rope_pair(bf16* row0, bool live0, const float (&scale0)[16],
                                               bf16* row1, bool live1, const float (&scale1)[16],
                                               const float* __restrict__ cos_row,
                                               const float* __restrict__ sin_row, float inv_d) {
  const int c = threadIdx.x & (LN_LANES<D> - 1);
  bf16* rows[2] = {row0, row1};
  const bool live[2] = {live0, live1};
  uint4 raw[2][2];
  float cs[16], sn[16];
#pragma unroll
  for (int u = 0; u < 2; ++u)  // every load issued before the reductions wait on them
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      raw[u][hf] = live[u] ? *reinterpret_cast<const uint4*>(rows[u] + hf * D / 2 + 8 * c) : make_uint4(0u, 0u, 0u, 0u);
  const bool any = live0 || live1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // float4 q of the lane's 16 table entries
    const int d = (q >> 1) * D / 2 + 8 * c + 4 * (q & 1);
    const float4 cv = any ? __ldg(reinterpret_cast<const float4*>(cos_row + d)) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 sv = any ? __ldg(reinterpret_cast<const float4*>(sin_row + d)) : make_float4(0.f, 0.f, 0.f, 0.f);
    cs[4 * q] = cv.x, cs[4 * q + 1] = cv.y, cs[4 * q + 2] = cv.z, cs[4 * q + 3] = cv.w;
    sn[4 * q] = sv.x, sn[4 * q + 1] = sv.y, sn[4 * q + 2] = sv.z, sn[4 * q + 3] = sv.w;
  }
  float x[2][16], s[2], sq[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    s[u] = sq[u] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const bf16* xb = reinterpret_cast<const bf16*>(&raw[u][hf]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[u][8 * hf + e] = __bfloat162float(xb[e]);
        s[u] += x[u][8 * hf + e];
        sq[u] += x[u][8 * hf + e] * x[u][8 * hf + e];
      }
    }
  }
#pragma unroll
  for (int off = 1; off < LN_LANES<D>; off <<= 1)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      sq[u] += __shfl_xor_sync(0xffffffffu, sq[u], off);
    }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float mean = s[u] * inv_d;
    const float r = rsqrtf(fmaxf(sq[u] * inv_d - mean * mean, 0.f) + LN_EPS);
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float ya[2], yb[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float sa = u ? scale1[e + v] : scale0[e + v], sb = u ? scale1[8 + e + v] : scale0[8 + e + v];
        const float a = (x[u][e + v] - mean) * r * sa;      // x1 (element 8c + e)
        const float b = (x[u][8 + e + v] - mean) * r * sb;  // x2 (D/2 + 8c + e)
        ya[v] = a * cs[e + v] - b * sn[e + v];  // rotate_half: (-x2, x1)
        yb[v] = b * cs[8 + e + v] + a * sn[8 + e + v];
      }
      lo[e / 2] = pack_bf16(ya[0], ya[1]);
      hi[e / 2] = pack_bf16(yb[0], yb[1]);
    }
    if (live[u]) {
      *reinterpret_cast<uint4*>(rows[u] + 8 * c) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(rows[u] + D / 2 + 8 * c) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
}

// The key bits of sequence b into keep[0 .. key_words(S)), one warp a word.
__device__ __forceinline__ void stage_key_bits(unsigned long long* keep, const unsigned char* __restrict__ mask,
                                               long long b, int S, int first_word, int word_step) {
  const int lane = threadIdx.x & 31;
  for (int w = first_word; w < key_words(S); w += word_step) {
    const int j0 = 64 * w + lane, j1 = j0 + 32;
    const bool k0 = j0 < S && (mask == nullptr || mask[b * S + j0]);
    const bool k1 = j1 < S && (mask == nullptr || mask[b * S + j1]);
    const unsigned lo = __ballot_sync(0xffffffffu, k0), hi = __ballot_sync(0xffffffffu, k1);
    if (lane == 0) keep[w] = (unsigned long long)lo | ((unsigned long long)hi << 32);
  }
}

// The softmax backward on the tensor cores, shared by the fused attention
// backward (fused_attention_bwd_mma.cuh) and the plain attention backward
// (flash_attention_bwd_mma.cuh): the products of a 16-row tile, the online
// statistics, the query side, the slab's key side and the epilogue of a row
// tile without LN or RoPE. The design note is in fused_attention_bwd.cu.
namespace bwd {

constexpr int SLAB_MAX_SEQ = 64;     // the longest sequence whose P and dS a block keeps
constexpr int SLAB_WARPS = 4;        // warps of a slab block at most
constexpr int TILE_WARPS = 16;       // warps of a tile block at most (S = 256)
constexpr int SLAB_MIN_BLOCKS = 4;   // slab blocks an SM at least: 128 registers a thread
// ... but one at D = 128, where a warp's 16 x 128 accumulators alone take 64 registers
template <int D> constexpr int SLAB_BLOCKS = D == 128 ? 1 : SLAB_MIN_BLOCKS;
constexpr int TILE_KT = 2;           // 16-key steps of a query-side chunk in a tile block
template <int D> constexpr int STAGE_ROW = D + 8;  // f32 staging row of the epilogue (no bank conflicts)

__host__ __device__ __forceinline__ int ps_row(int S) { return rows16(S) + 8; }

// bf16 elements of one pair's rows in a slab block: q~, k~, v, dO, then P and dS
template <int D>
__host__ __device__ __forceinline__ size_t slab_pair_elems(int S) {
  return 4 * (size_t)rows16(S) * ROW<D> + 2 * (size_t)rows16(S) * ps_row(S);
}

// acc[nt] = A . B^T, A the 16 x D fragments af, B the rows c0 + 8 nt .. + 7 of
// b_s (D wide): the 16-row-by-8 tiles of a product over D, for nt / 2 < steps.
template <int D, int KT>
__device__ __forceinline__ void row_dots(float (&acc)[2 * KT][4], const uint32_t (&af)[D / 16][4], const bf16* b_s,
                                         int c0, int steps) {
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    if (nt / 2 < steps) dot_rows8<D>(acc[nt], af, b_s + (size_t)(c0 + 8 * nt) * ROW<D>);
  }
}

// The 16 x D A fragments of 16 rows of a D-wide bf16 array in shared memory.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t (&f)[D / 16][4], const bf16* rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(f[ks], rows + (lane & 15) * ROW<D> + 16 * ks + 8 * (lane >> 4));
}

// acc (16 x D) += a (16 x 16) . the 16 rows of b_rows (D wide), read through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4], const uint32_t (&a)[4], const bf16* b_rows) {
  const int lane = threadIdx.x & 31;
  const bf16* row = b_rows + (lane & 15) * ROW<D> + 8 * (lane >> 4);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, row + 16 * dp);
    mma(acc[2 * dp], a, b[0], b[1]);
    mma(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// Score tiles 2kk and 2kk + 1 rounded to bf16: the A fragment of 16-key step kk.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s)[N][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// Mask one chunk of scores (keys c0 .. c0 + 16 KT, within one word of key bits):
// a masked key NEG_INF, a padding key (j >= S) -inf, so that it adds exactly 0.
template <int KT>
__device__ __forceinline__ void mask_scores(float (&s)[2 * KT][4], int c0, int S, const unsigned long long* keep) {
  const int lane = threadIdx.x & 31;
  const unsigned long long bits = keep[c0 >> 6] >> (c0 & 63);
  constexpr unsigned long long CHUNK_BITS = KT == 4 ? ~0ull : (1ull << 16 * KT) - 1;
  if (c0 + 16 * KT <= S && (bits & CHUNK_BITS) == CHUNK_BITS) return;  // nothing to mask
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jl = 8 * nt + 2 * (lane & 3) + (e & 1);
      s[nt][e] = c0 + jl >= S ? -INFINITY : ((bits >> jl) & 1ull) ? s[nt][e] : NEG_INF;
    }
}

// One chunk of the online softmax statistics of a warp's 16 query rows (qf, df:
// their q and dO fragments): the scores s (masked) and dP of keys c0 .. c0 +
// 16 KT, folded into this lane's running max m, sum l = sum_j exp(s - m) and
// rs = sum_j exp(s - m) dP of rows g and g + 8. s and dP stay for the caller.
// c: the softmax scale in the exp2 domain (HeadScale::c).
template <int D, int KT>
__device__ __forceinline__ void online_chunk(float (&s)[2 * KT][4], float (&dp)[2 * KT][4], const uint32_t (&qf)[D / 16][4],
                                             const uint32_t (&df)[D / 16][4], const bf16* k_s, const bf16* v_s,
                                             const unsigned long long* keep, int S, int c0, float (&m)[2],
                                             float (&l)[2], float (&rs)[2], float c) {
  const int steps = min(KT, (S - c0 + 15) / 16);
  row_dots<D, KT>(s, qf, k_s, c0, steps);
  mask_scores<KT>(s, c0, S, keep);
  row_dots<D, KT>(dp, df, v_s, c0, steps);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));
    const float corr = exp2f((m[r] - m_new) * c);  // 0 on the first chunk
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float p = exp2f((s[nt][e] - m_new) * c);
        sum += p;
        acc += p * dp[nt][e];
      }
    l[r] = l[r] * corr + sum;
    rs[r] = rs[r] * corr + acc;
    m[r] = m_new;
  }
}

// The rows' statistics from the lanes' running ones: 1/l and row = sum_j P dP,
// and stat = (m, 1/l, row) of rows g and g + 8.
__device__ __forceinline__ void finish_stats(const float (&m)[2], const float (&l)[2], const float (&rs)[2],
                                             float (&il)[2], float (&row)[2], float (&stat)[2][3]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    il[r] = 1.f / quad_sum(l[r]);
    row[r] = quad_sum(rs[r]) * il[r];
    stat[r][0] = m[r], stat[r][1] = il[r], stat[r][2] = row[r];
  }
}

// The query side of one warp: 16 query rows (q_rows, do_rows: their q~ and dO
// rows) against the S keys of k_s and v_s. P = softmax(q~k~^T / sqrt(D) + key
// mask) with the exact row max m and sum l, dP = dO v^T, row = sum_j P dP,
// dS = P (dP - row) / sqrt(D), all f32; dq~ = dS . k~ with dS rounded to bf16.
// One chunk of up to 64 keys (!TWO_PASS): the scores and dP stay in registers.
// More (TWO_PASS): a first pass over the chunks gives m, l and row online, the
// second recomputes the scores and dP. stat: (m, 1/l, row) of rows g and g + 8.
// With p_rows (slab), P and dS rounded to bf16 go to shared memory for the key
// side: query row r of this tile at p_rows + r * pstride, dS at ds_rows.
// query_frags takes the rows' q~ and dO fragments (qf, df) as they stand;
// query_side loads them from q_rows and do_rows in shared memory first.
template <int D, int KT, bool TWO_PASS>
__device__ __forceinline__ void query_frags(const uint32_t (&qf)[D / 16][4], const uint32_t (&df)[D / 16][4],
                                            const bf16* k_s, const bf16* v_s, const unsigned long long* keep, int S,
                                            float (&dq)[D / 8][4], float (&stat)[2][3], bf16* p_rows, bf16* ds_rows,
                                            int pstride, const HeadScale& hs) {
  constexpr int CH = 16 * KT;
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  float s[2 * KT][4], dp[2 * KT][4];
  const int chunks = TWO_PASS ? (S + CH - 1) / CH : 1;
  for (int c = 0; c < (TWO_PASS ? chunks : 1); ++c) {  // m, l and sum_j exp(s - m) dP
    online_chunk<D, KT>(s, dp, qf, df, k_s, v_s, keep, S, c * CH, m, l, rs, hs.c);
  }
  float il[2], row[2];
  finish_stats(m, l, rs, il, row, stat);

  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * CH, steps = min(KT, (S - c0 + 15) / 16);
    if (TWO_PASS) {
      row_dots<D, KT>(s, qf, k_s, c0, steps);
      mask_scores<KT>(s, c0, S, keep);
      row_dots<D, KT>(dp, df, v_s, c0, steps);
    }
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[nt][e] - m[e >> 1]) * hs.c) * il[e >> 1];  // P, normalised, f32
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - row[e >> 1]) * hs.scale;  // dS, f32
      }
    if (p_rows != nullptr) {  // P and dS as bf16 [query][key] for the key side
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        if (nt / 2 < steps) {
          const int col = c0 + 8 * nt + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            *reinterpret_cast<uint32_t*>(p_rows + (g + 8 * r) * pstride + col) = pack_bf16(s[nt][2 * r], s[nt][2 * r + 1]);
            *reinterpret_cast<uint32_t*>(ds_rows + (g + 8 * r) * pstride + col) =
                pack_bf16(dp[nt][2 * r], dp[nt][2 * r + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {  // dq~ += dS (bf16) . k~
      if (kk < steps) {
        uint32_t a[4];
        pack_a(a, dp, kk);
        mma_rows<D>(dq, a, k_s + (size_t)(c0 + 16 * kk) * ROW<D>);
      }
    }
  }
}

template <int D, int KT, bool TWO_PASS>
__device__ __forceinline__ void query_side(const bf16* q_rows, const bf16* do_rows, const bf16* k_s, const bf16* v_s,
                                           const unsigned long long* keep, int S, float (&dq)[D / 8][4],
                                           float (&stat)[2][3], bf16* p_rows, bf16* ds_rows, int pstride,
                                           const HeadScale& hs) {
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_rows<D>(qf, q_rows);
  load_rows<D>(df, do_rows);
  query_frags<D, KT, TWO_PASS>(qf, df, k_s, v_s, keep, S, dq, stat, p_rows, ds_rows, pstride, hs);
}

// The key side of one warp in a slab block: key rows k0 .. k0 + 15 of one pair,
// dv = P^T . dO and dk~ = dS^T . q~ over the pair's query rows, with P and dS
// (bf16, [query][key]) from shared memory read through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void key_side_slab(const bf16* p_s, const bf16* ds_s, int pstride, const bf16* q_s,
                                              const bf16* do_s, int k0, int S, float (&dv)[D / 8][4],
                                              float (&dk)[D / 8][4]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[dn][e] = dk[dn][e] = 0.f;
  // matrix mi of the x4 load: queries q0 + 8 (mi >> 1) .., keys k0 + 8 (mi & 1) ..
  const int at = ((lane & 7) + 8 * (mi >> 1)) * pstride + k0 + 8 * (mi & 1);
  for (int q0 = 0; q0 < S; q0 += 16) {
    uint32_t ap[4], ad[4];
    ldsm_x4_trans(ap, p_s + q0 * pstride + at);
    ldsm_x4_trans(ad, ds_s + q0 * pstride + at);
    mma_rows<D>(dv, ap, do_s + (size_t)q0 * ROW<D>);
    mma_rows<D>(dk, ad, q_s + (size_t)q0 * ROW<D>);
  }
}

// The epilogue's lanes: D / 4 take one row (16 at D = 64, 4 at D = 16), lane l
// of them dims 2 l, 2 l + 1 and their RoPE partners 2 l + D/2, 2 l + D/2 + 1,
// so that each global load and store of a row is one contiguous piece; a warp
// takes 32 / (D / 4) rows at a time.
template <int D> constexpr int ROW_LANES = D / 4;

// The 8 rows 8 r .. 8 r + 7 of a 16 x D f32 accumulator tile into the warp's
// staging rows, so that the row's ROW_LANES lanes can then take it whole.
template <int D>
__device__ __forceinline__ void stage_half(const float (&acc)[D / 8][4], float* stage, int r) {
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    *reinterpret_cast<float2*>(stage + g * STAGE_ROW<D> + 8 * nt + 2 * t) =
        make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
  __syncwarp();
}

// 16 rows of f32 accumulators (dv; dq and dk of the plain attention), rounded
// to bf16 at dst (row i at dst + i * stride) for the rows row0 + .. below S,
// through the staging rows.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float* stage, bf16* __restrict__ dst,
                                           size_t stride, int row0, int S) {
  constexpr int LR = ROW_LANES<D>, RPI = 32 / LR;  // lanes a row, rows at a time
  const int lane = threadIdx.x & 31, d0 = 2 * (lane % LR);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    stage_half<D>(acc, stage, r);
#pragma unroll
    for (int it = 0; it < 8 / RPI; ++it) {
      const int rl = RPI * it + lane / LR, i = row0 + 8 * r + rl;
      const float2 lo = *reinterpret_cast<const float2*>(stage + rl * STAGE_ROW<D> + d0);
      const float2 hi = *reinterpret_cast<const float2*>(stage + rl * STAGE_ROW<D> + d0 + D / 2);
      if (i < S) {
        *reinterpret_cast<uint32_t*>(dst + (size_t)i * stride + d0) = pack_bf16(lo.x, lo.y);
        *reinterpret_cast<uint32_t*>(dst + (size_t)i * stride + d0 + D / 2) = pack_bf16(hi.x, hi.y);
      }
    }
  }
}

// ---- The tile variant at D = 128 (S > 64), shared by both backward kernels ----
// At D = 128 a pair's four D-wide arrays (q~, k~, v, dO) would take 4 x 69.6 KB
// at S = 256, over a block's 227 KB, and 16 warps capped at 128 registers
// would spill their 16 x 128 accumulators. So a block keeps three arrays, q~ |
// k~ | v, and v gives way to dO between the sides: the query side reads its
// dO rows, and the key side its v rows, as mma.sync A fragments straight from
// device memory (load_rows_global: an A operand needs no other layout), while
// every B operand (k~ and v, then q~ and dO) comes from shared memory through
// ldmatrix. Up to WIDE_TILE_WARPS warps of up to 255 registers take the 16-row
// tiles in turn, the query tiles and then, after a barrier and dO's copy, the
// key tiles. The epilogues work on the accumulators as they stand
// (store_rows_acc, ln_rope_bwd_acc), so no staging rows are needed either.
// The products and roundings are the D <= 64 tile's: 9 products of S^2 D a
// pair, q~, k~, P and dS rounded to bf16.
constexpr int WIDE_TILE_WARPS = 8;

// Shared memory of one wide tile block: q~ | k~ | v (then dO) rows, m | 1/l |
// row (f32), the key bits, and with LN (fused) each warp's (2, D) dscale partials.
template <int D>
__host__ __forceinline__ size_t wide_tile_smem_bytes(int S, int warps, bool fused) {
  return 3 * (size_t)rows16(S) * ROW_BYTES<D> + 3 * (size_t)rows16(S) * sizeof(float) + 8 * (size_t)key_words(S) +
         (fused ? (size_t)warps * 2 * D * sizeof(float) : 0);
}

// The 16 x D A fragments of rows r0 .. r0 + 15 of a bf16 array in device
// memory (row i at rows + i * stride), as load_rows gives them from shared
// memory: lane (g, t) holds columns 16 ks + 2 t (+ 8) of rows g and g + 8. A
// row at or past S reads as zeros.
template <int D>
__device__ __forceinline__ void load_rows_global(uint32_t (&f)[D / 16][4], const bf16* __restrict__ rows,
                                                 size_t stride, int r0, int S) {
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const bool lo_in = r0 + g < S, hi_in = r0 + g + 8 < S;
  const unsigned* lo = reinterpret_cast<const unsigned*>(rows + (size_t)(lo_in ? r0 + g : 0) * stride + 2 * t);
  const unsigned* hi = reinterpret_cast<const unsigned*>(rows + (size_t)(hi_in ? r0 + g + 8 : 0) * stride + 2 * t);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {  // 2-element words: column 16 ks + 2 t is word 8 ks + t
    f[ks][0] = lo_in ? __ldg(lo + 8 * ks) : 0u;
    f[ks][1] = hi_in ? __ldg(hi + 8 * ks) : 0u;
    f[ks][2] = lo_in ? __ldg(lo + 8 * ks + 4) : 0u;
    f[ks][3] = hi_in ? __ldg(hi + 8 * ks + 4) : 0u;
  }
}

// 16 rows of f32 accumulators rounded to bf16 at dst (row i at dst + i *
// stride) for the rows row0 + .. below S, straight from the m16n8 layout:
// lane (g, t) stores columns 8 nt + 2 t, + 1 of rows g and g + 8.
template <int D>
__device__ __forceinline__ void store_rows_acc(const float (&acc)[D / 8][4], bf16* __restrict__ dst, size_t stride,
                                               int row0, int S) {
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    if (i < S) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<uint32_t*>(dst + (size_t)i * stride + 8 * nt + 2 * t) =
            pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// Back through RoPE, the scale and the LN, as ln_rope_bwd in
// fused_attention_bwd_mma.cuh, for the 16 rows row0 + .. of du straight from
// the accumulators: lane (g, t) holds columns c = 8 nt + 2 t, c + 1 of rows g
// and g + 8 and their RoPE partners c + D/2 (tile nt + D/16); a row's sums take
// quad_sum over its four lanes. xn and r come from the raw row re-read at src
// (row i at src + i * stride, as dst). The rows' sum of dln xn is added to red
// (this warp's D floats), summed over the warp's 8 row groups in a fixed order.
// inv_d: 1/d of the true head dim (HeadScale).
template <int D>
__device__ __forceinline__ void ln_rope_bwd_acc(const float (&du)[D / 8][4], const bf16* __restrict__ src,
                                                bf16* __restrict__ dst, size_t stride, int row0, int S,
                                                const float* __restrict__ scale, const float* __restrict__ cos_t,
                                                const float* __restrict__ sin_t, float* red, float inv_d) {
  constexpr int NT = D / 8, HT = D / 16;  // tiles of a row, of its first half
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  float part[NT][2];  // the sum over the lane's rows of dln xn at its columns
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) part[nt][0] = part[nt][1] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    const bool live = i < S;
    const int at = live ? i : 0;
    const bf16* row = src + (size_t)at * stride;
    float xn[NT][2], dxn[NT][2], s = 0.f, sq = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 x = live ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(row + 8 * nt + 2 * t)))
                            : make_float2(0.f, 0.f);
      xn[nt][0] = x.x, xn[nt][1] = x.y;
      s += x.x + x.y;
      sq += x.x * x.x + x.y * x.y;
    }
    const float mean = quad_sum(s) * inv_d;
    const float rstd = rsqrtf(fmaxf(quad_sum(sq) * inv_d - mean * mean, 0.f) + LN_EPS);
    const float* c = cos_t + (size_t)at * D;
    const float* sn = sin_t + (size_t)at * D;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int nt = 0; nt < HT; ++nt) {
      const int col = 8 * nt + 2 * t;
      const float2 c_lo = __ldg(reinterpret_cast<const float2*>(c + col));
      const float2 c_hi = __ldg(reinterpret_cast<const float2*>(c + col + D / 2));
      const float2 s_lo = __ldg(reinterpret_cast<const float2*>(sn + col));
      const float2 s_hi = __ldg(reinterpret_cast<const float2*>(sn + col + D / 2));
      const float2 sc_lo = __ldg(reinterpret_cast<const float2*>(scale + col));
      const float2 sc_hi = __ldg(reinterpret_cast<const float2*>(scale + col + D / 2));
      const float u_lo[2] = {du[nt][2 * r], du[nt][2 * r + 1]};
      const float u_hi[2] = {du[nt + HT][2 * r], du[nt + HT][2 * r + 1]};
      // RoPE transpose: rot^T(v)[d < D/2] = v[d + D/2], else -v[d - D/2]
      const float dln[2][2] = {{u_lo[0] * c_lo.x + u_hi[0] * s_hi.x, u_lo[1] * c_lo.y + u_hi[1] * s_hi.y},
                               {u_hi[0] * c_hi.x - u_lo[0] * s_lo.x, u_hi[1] * c_hi.y - u_lo[1] * s_lo.y}};
      const float sc[2][2] = {{sc_lo.x, sc_lo.y}, {sc_hi.x, sc_hi.y}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // column c, then its partner c + D/2
        const int tile = nt + h * HT;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          xn[tile][e] = (xn[tile][e] - mean) * rstd;
          if (live) part[tile][e] += dln[h][e] * xn[tile][e];
          dxn[tile][e] = dln[h][e] * sc[h][e];
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

// The key side of one warp in a wide tile block: key rows k0 .. k0 + 15 of the
// pair, as key_side_tile in fused_attention_bwd_mma.cuh, with the k~ fragments
// from shared memory and the v fragments from device memory, both loaded again
// for each 16 queries so that dv and dk keep their registers.
template <int D>
__device__ __forceinline__ void key_side_wide(const bf16* q_s, const bf16* do_s, const bf16* k_s,
                                              const bf16* __restrict__ v_rows, size_t v_stride, const float* m_s,
                                              const float* il_s, const float* row_s, const unsigned long long* keep,
                                              int k0, int S, float (&dv)[D / 8][4], float (&dk)[D / 8][4],
                                              const HeadScale& hs) {
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
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
    {
      uint32_t f[D / 16][4];
      load_rows<D>(f, k_s + (size_t)k0 * ROW<D>);
      row_dots<D, 1>(st, f, q_s, q0, 1);
      load_rows_global<D>(f, v_rows, v_stride, k0, S);
      row_dots<D, 1>(dt, f, do_s, q0, 1);
    }
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

// The rows of the (sequence, head) pair a wide tile block reads and writes:
// input part p (0 q, 1 k, 2 v, 3 dO) row i at src[p] + i * src_stride[p],
// gradient part p (0 dq, 1 dk, 2 dv) row i at dst[p] + i * dst_stride.
struct PairRows {
  const bf16* src[4];
  size_t src_stride[4];
  bf16* dst[3];
  size_t dst_stride;
};

// The LN + RoPE operands of the fused backward (unread by the plain one).
struct NormRope {
  const float *q_scale, *k_scale, *cos_t, *sin_t;
};

// One wide tile block (one pair of sequence b): the fused backward's with
// FUSED (LN + RoPE of q and k after staging, its epilogues through the LN and
// the block's dscale partials at row blockIdx.x), the plain backward's
// without. tests/test_torch_attention_bwd_plan.py walks the same items on the CPU.
template <int D, bool FUSED>
__device__ __forceinline__ void wide_tile_bwd(const PairRows& io, const NormRope& nr, const HeadScale& hs,
                                              const unsigned char* __restrict__ mask, long long b, int S,
                                              float* dqs_part, float* dks_part) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  constexpr int ROW = fa_mma::ROW<D>, P = PIECES<D>, LANES = LN_LANES<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int s16 = rows16(S), words = key_words(S), tiles = s16 / 16;
  bf16* q_s = smem;
  bf16* k_s = q_s + (size_t)s16 * ROW;
  bf16* x_s = k_s + (size_t)s16 * ROW;  // v, then dO
  float* m_s = reinterpret_cast<float*>(x_s + (size_t)s16 * ROW);
  float* il_s = m_s + s16;
  float* row_s = il_s + s16;
  unsigned long long* keep = reinterpret_cast<unsigned long long*>(row_s + s16);
  float* red = reinterpret_cast<float*>(keep + words);  // FUSED: [warp][q, k][D]
  auto copy = [&](bf16* dst, int p) {  // the rows of input part p, a row's pieces on consecutive threads
    for (int e = threadIdx.x; e < s16 * P; e += blockDim.x) {
      const int i = e / P, piece = e % P;
      const bool inside = i < S;
      cp_async16(dst + (size_t)i * ROW + 8 * piece,
                 inside ? io.src[p] + (size_t)i * io.src_stride[p] + 8 * piece : io.src[p], inside ? 16 : 0);
    }
  };
  copy(q_s, 0);  // group 0, the q and k rows; group 1, the v rows
  copy(k_s, 1);
  cp_async_commit();
  copy(x_s, 2);
  cp_async_commit();
  stage_key_bits(keep, mask, b, S, warp, warps);
  if constexpr (FUSED)
    for (int e = lane; e < 2 * D; e += 32) red[warp * 2 * D + e] = 0.f;
  cp_async_wait<1>();
  __syncthreads();
  if constexpr (FUSED) {  // LN + RoPE of q row i and k row i, D / 16 lanes each
    float qsc[16], ksc[16];
    load_lane_scale<D>(qsc, nr.q_scale);
    load_lane_scale<D>(ksc, nr.k_scale);
    const int per_warp = 32 / LANES;
    for (int first = per_warp * warp; first < S; first += per_warp * warps) {
      const int i = first + lane / LANES;
      const bool live = i < S;
      const int at = live ? i : 0;
      norm_rope_pair<D>(q_s + (size_t)at * ROW, live, qsc, k_s + (size_t)at * ROW, live, ksc,
                        nr.cos_t + (size_t)at * D, nr.sin_t + (size_t)at * D, hs.inv_d);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int mt = warp; mt < tiles; mt += warps) {  // query side
    uint32_t qf[D / 16][4], df[D / 16][4];
    load_rows<D>(qf, q_s + (size_t)16 * mt * ROW);
    load_rows_global<D>(df, io.src[3], io.src_stride[3], 16 * mt, S);
    float dq[D / 8][4], st[2][3];
    query_frags<D, TILE_KT, true>(qf, df, k_s, x_s, keep, S, dq, st, nullptr, nullptr, 0, hs);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 16 * mt + (lane >> 2) + 8 * r;
        m_s[i] = st[r][0], il_s[i] = st[r][1], row_s[i] = st[r][2];
      }
    }
    if constexpr (FUSED)
      ln_rope_bwd_acc<D>(dq, io.src[0], io.dst[0], io.dst_stride, 16 * mt, S, nr.q_scale, nr.cos_t, nr.sin_t,
                         red + warp * 2 * D, hs.inv_d);
    else
      store_rows_acc<D>(dq, io.dst[0], io.dst_stride, 16 * mt, S);
  }
  __syncthreads();  // the query side is done with v: its rows take dO's
  copy(x_s, 3);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int kt = warp; kt < tiles; kt += warps) {  // key side
    float dv[D / 8][4], dk[D / 8][4];
    key_side_wide<D>(q_s, x_s, k_s, io.src[2], io.src_stride[2], m_s, il_s, row_s, keep, 16 * kt, S, dv, dk, hs);
    store_rows_acc<D>(dv, io.dst[2], io.dst_stride, 16 * kt, S);
    if constexpr (FUSED)
      ln_rope_bwd_acc<D>(dk, io.src[1], io.dst[1], io.dst_stride, 16 * kt, S, nr.k_scale, nr.cos_t, nr.sin_t,
                         red + warp * 2 * D + D, hs.inv_d);
    else
      store_rows_acc<D>(dk, io.dst[1], io.dst_stride, 16 * kt, S);
  }
  if constexpr (FUSED) {  // the block's dscale partials: the warps' sums in warp order
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * D; e += blockDim.x) {
      const int part = e / D, d = e % D;
      float sum = 0.f;
      for (int w = 0; w < warps; ++w) sum += red[(w * 2 + part) * D + d];
      (part ? dks_part : dqs_part)[(size_t)blockIdx.x * D + d] = sum;
    }
  }
}

}  // namespace bwd

}  // namespace fa_mma
