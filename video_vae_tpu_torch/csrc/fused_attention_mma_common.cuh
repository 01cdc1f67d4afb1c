// Device helpers shared by the bf16 fused attention forward
// (fused_attention_mma.cuh) and backward (fused_attention_bwd_mma.cuh) on the
// tensor cores: cp.async staging, ldmatrix and mma.sync m16n8k16 (bf16
// operands, f32 accumulators), the LN + RoPE of a q row and a k row in shared
// memory, and the key bits of a key mask.
//
// Rows of 64 bf16 sit in shared memory in 72-element rows (144 bytes): the 8
// row addresses of an ldmatrix then fall on 8 distinct 16-byte bank groups, so
// every ldmatrix is free of bank conflicts. Key bits: bit j % 64 of word j / 64
// is 1 where key j is kept.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>

namespace fa_mma {

using bf16 = __nv_bfloat16;

constexpr int D = 64;            // head dim the kernel is written for
constexpr int ROW = D + 8;       // shared-memory row in bf16 (144 bytes)
constexpr int ROW_BYTES = 2 * ROW;
constexpr int MAX_SMEM = 232448;  // what one block may ask for on the H100 (227 KB)
constexpr int SLAB = 0, TILE = 1;  // the plan's variant codes
constexpr float NEG_INF = -1e30f;  // the JAX kernels' masked score
constexpr float LN_EPS = 1e-6f;
constexpr float LOG2E = 1.4426950408889634f;

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

// LN + RoPE lanes: four own a row. Lane c = lane & 3 holds elements 8c .. 8c + 7
// and their rotate-half partners 32 + 8c .. 32 + 8c + 7, so the rotation needs
// no shuffle; the row's sums come from __shfl_xor over the four.
constexpr int LN_LANES = 4;

// The scales of the 16 elements a lane owns, in the order it holds them.
__device__ __forceinline__ void load_lane_scale(float (&dst)[16], const float* __restrict__ scale) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(scale + 8 * c) + h);
    const float4 b = __ldg(reinterpret_cast<const float4*>(scale + D / 2 + 8 * c) + h);
    dst[4 * h] = a.x, dst[4 * h + 1] = a.y, dst[4 * h + 2] = a.z, dst[4 * h + 3] = a.w;
    dst[8 + 4 * h] = b.x, dst[8 + 4 * h + 1] = b.y, dst[8 + 4 * h + 2] = b.z, dst[8 + 4 * h + 3] = b.w;
  }
}

// LayerNorm (no bias; f32 statistics, E[x^2] - mean^2 clamped at 0) times the (D,)
// scale, then rotate-half RoPE, of two 64-element bf16 rows in shared memory that
// share a position (a q row and a k row), in place, rounded to bf16: one load of
// the cos/sin rows serves both, and their two chains run side by side. Every
// lane of the warp calls it (the shuffles take all 32); a row whose `live` is
// false is neither read nor written.
__device__ __forceinline__ void norm_rope_pair(bf16* row0, bool live0, const float (&scale0)[16],
                                               bf16* row1, bool live1, const float (&scale1)[16],
                                               const float* __restrict__ cos_row,
                                               const float* __restrict__ sin_row) {
  const int c = threadIdx.x & 3;
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
  for (int off = 1; off < LN_LANES; off <<= 1)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      sq[u] += __shfl_xor_sync(0xffffffffu, sq[u], off);
    }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float mean = s[u] * (1.f / D);
    const float r = rsqrtf(fmaxf(sq[u] * (1.f / D) - mean * mean, 0.f) + LN_EPS);
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float ya[2], yb[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float sa = u ? scale1[e + v] : scale0[e + v], sb = u ? scale1[8 + e + v] : scale0[8 + e + v];
        const float a = (x[u][e + v] - mean) * r * sa;      // x1 (element 8c + e)
        const float b = (x[u][8 + e + v] - mean) * r * sb;  // x2 (32 + 8c + e)
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

}  // namespace fa_mma
