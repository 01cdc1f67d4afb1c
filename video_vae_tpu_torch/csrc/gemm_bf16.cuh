// Token LayerNorm and a bf16 tensor-core GEMM with a fused epilogue, for
// attention_sublayer.cu (the two projections around the attention). The MLP
// sublayer (fused_mlp.cu) runs the wgmma GEMM of gemm_sm90.cuh instead; the
// attention sublayer's redesign is to move its projections onto that GEMM
// and retire this one.
//
//   launch_token_ln<T>:  xa = bf16(LN(x) * gamma + beta), f32 statistics
//                        (E[x^2] - mean^2 clamped at 0, eps 1e-6), one warp a token.
//   launch_gemm<TA, TO, EPI>:  acc = A . W on the tensor cores (wmma 16x16x16
//                        bf16, f32 accumulators), then by epilogue
//     EPI_BIAS      out = TO(acc + bias)
//     EPI_RESIDUAL  out = TO(f32(resid) + (acc + bias)), one rounding
//
// A block owns a 128 x 128 output tile, 8 warps of 64 x 32; A and W are staged
// through padded shared memory 32 columns of K at a time, the next slab's
// global loads in flight in registers meanwhile. wgmma, TMA and a multi-stage
// pipeline are left for a later version.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace vvt_gemm {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr float TOKEN_LN_EPS = 1e-6f;
constexpr int GEMM_THREADS = 256;
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_LD = BK + 8;   // 80-byte rows: 16-byte aligned vectors, 32-byte aligned tiles
constexpr int B_LD = BN + 8;   // 272-byte rows
constexpr int WARP_M = 64, WARP_N = 32;  // 2 x 4 warps over the block's tile
constexpr int LN_WARPS = 8;

enum Epilogue { EPI_BIAS = 0, EPI_RESIDUAL = 1 };

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 round_to<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- token LayerNorm + affine, rounded to bf16 ------------------------------

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
token_ln_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, bf16* __restrict__ xa, long long n, int C) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * LN_WARPS + threadIdx.x / 32;
  if (row >= n) return;  // uniform per warp
  const T* src = x + row * C;
  float s = 0.f, sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = as_f32(src[c]);
    s += v;
    sq += v * v;
  }
  const float mean = warp_sum(s) / C;
  const float var = fmaxf(warp_sum(sq) / C - mean * mean, 0.f);
  const float r = rsqrtf(var + TOKEN_LN_EPS);
  bf16* dst = xa + row * C;
  for (int c = lane; c < C; c += 32) {
    const float xn = (as_f32(src[c]) - mean) * r;
    dst[c] = __float2bfloat16(xn * gamma[c] + beta[c]);
  }
}

template <typename T>
cudaError_t launch_token_ln(const T* x, const float* gamma, const float* beta, bf16* xa,
                            long long n, int C, cudaStream_t stream) {
  token_ln_kernel<T><<<(unsigned)((n + LN_WARPS - 1) / LN_WARPS), LN_WARPS * 32, 0, stream>>>(
      x, gamma, beta, xa, n, C);
  return cudaGetLastError();
}

// ---- out = epilogue(A . W) on the tensor cores ------------------------------

// two floats rounded to bf16, the first in the low half of the word
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const unsigned l = __bfloat16_as_ushort(__float2bfloat16(lo));
  const unsigned h = __bfloat16_as_ushort(__float2bfloat16(hi));
  return l | (h << 16);
}

// Eight consecutive elements of a row as bf16, from bf16 or (rounded) from f32.
__device__ __forceinline__ uint4 load8(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
}

constexpr int A_VECS = BM * (BK / 8) / GEMM_THREADS;  // 8-element vectors per thread and tile
constexpr int B_VECS = BK * (BN / 8) / GEMM_THREADS;
static_assert(A_VECS * GEMM_THREADS == BM * (BK / 8) && B_VECS * GEMM_THREADS == BK * (BN / 8),
              "the tiles must split evenly over the block's threads");

// This thread's vectors of the A and W tiles at K offset k0; zero past the edges.
template <typename TA>
__device__ __forceinline__ void fetch_tiles(uint4 (&a_reg)[A_VECS], uint4 (&b_reg)[B_VECS],
                                            const TA* __restrict__ A, const bf16* __restrict__ W,
                                            long long m0, int n0, int k0, long long N, int K,
                                            int M) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int v = threadIdx.x + i * GEMM_THREADS;
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    a_reg[i] = (m0 + r < N && k0 + c < K) ? load8(A + (m0 + r) * K + k0 + c) : zero;
  }
#pragma unroll
  for (int i = 0; i < B_VECS; ++i) {
    const int v = threadIdx.x + i * GEMM_THREADS;
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    b_reg[i] = (k0 + r < K && n0 + c < M) ? load8(W + (long long)(k0 + r) * M + n0 + c) : zero;
  }
}

// A: (N, K) row-major, TA = bf16 or f32 (rounded to bf16 as it is staged).
// W: (K, M) row-major bf16. bias: (M,) f32. resid (EPI_RESIDUAL), out: (N, M)
// row-major TO. K and M are multiples of 8; N is arbitrary: the ragged last
// row tile is masked here.
template <typename TA, typename TO, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const TA* __restrict__ A, const bf16* __restrict__ W, const float* __restrict__ bias,
            const TO* __restrict__ resid, TO* __restrict__ out, long long N, int K, int M) {
  __shared__ __align__(32) bf16 a_s[BM * A_LD];
  __shared__ __align__(32) bf16 b_s[BK * B_LD];
  __shared__ __align__(32) float c_s[GEMM_THREADS / 32][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WARP_M / 16][WARP_N / 16];
#pragma unroll
  for (int i = 0; i < WARP_M / 16; ++i)
#pragma unroll
    for (int j = 0; j < WARP_N / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // The next K-slab's global loads go into registers before the tensor-core
  // work on the current one starts, so their latency hides behind it.
  uint4 a_reg[A_VECS], b_reg[B_VECS];
  fetch_tiles(a_reg, b_reg, A, W, m0, n0, 0, N, K, M);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {  // A tile: BM rows of BK columns, four vectors per row
      const int v = threadIdx.x + i * GEMM_THREADS;
      *reinterpret_cast<uint4*>(&a_s[(v / (BK / 8)) * A_LD + (v % (BK / 8)) * 8]) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {  // B tile: BK rows of BN columns, sixteen vectors per row
      const int v = threadIdx.x + i * GEMM_THREADS;
      *reinterpret_cast<uint4*>(&b_s[(v / (BN / 8)) * B_LD + (v % (BN / 8)) * 8]) = b_reg[i];
    }
    __syncthreads();
    if (k0 + BK < K) fetch_tiles(a_reg, b_reg, A, W, m0, n0, k0 + BK, N, K, M);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[WARP_M / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[WARP_N / 16];
#pragma unroll
      for (int i = 0; i < WARP_M / 16; ++i)
        wmma::load_matrix_sync(af[i], &a_s[(wm * WARP_M + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < WARP_N / 16; ++j)
        wmma::load_matrix_sync(bfr[j], &b_s[kk * B_LD + wn * WARP_N + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < WARP_M / 16; ++i)
#pragma unroll
        for (int j = 0; j < WARP_N / 16; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: one 16 x 16 tile at a time through the warp's f32 staging tile;
  // each lane finishes 8 consecutive columns of one row
  float* stage_tile = c_s[warp];
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < WARP_M / 16; ++i) {
#pragma unroll
    for (int j = 0; j < WARP_N / 16; ++j) {
      wmma::store_matrix_sync(stage_tile, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long row = m0 + wm * WARP_M + i * 16 + er;
      const int col = n0 + wn * WARP_N + j * 16 + ec;
      if (row < N && col < M) {
        const long long o = row * M + col;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float val = stage_tile[er * 16 + ec + e] + bias[col + e];
          if constexpr (EPI == EPI_RESIDUAL) val = as_f32(resid[o + e]) + val;
          out[o + e] = round_to<TO>(val);
        }
      }
      __syncwarp();
    }
  }
}

template <typename TA, typename TO, int EPI>
cudaError_t launch_gemm(const TA* A, const bf16* W, const float* bias, const TO* resid, TO* out,
                        long long N, int K, int M, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BN - 1) / BN), (unsigned)((N + BM - 1) / BM));
  gemm_kernel<TA, TO, EPI><<<grid, GEMM_THREADS, 0, stream>>>(A, W, bias, resid, out, N, K, M);
  return cudaGetLastError();
}

}  // namespace vvt_gemm
