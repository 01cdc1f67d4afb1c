// The whole attention sublayer behind one entry point:
//   y = x + Wout . attention(qk-LN + RoPE(LN(x) . Wqkv + bqkv)) + bout
//
// Replaces: video_vae_tpu/ops/flash_attention.py, _sublayer_pallas -> _sublayer_kernel.
// Roundings, as there: token LN with f32 statistics (E[x^2] - mean^2 clamped at
// 0, eps 1e-6), xa = LN(x) * g + b rounded to bf16; Wqkv and Wout arrive as
// bf16; qkv = xa . Wqkv (f32 accumulation) + bqkv rounded to x's dtype; the
// attention of fused_attention.cu on that qkv, o in x's dtype (read as bf16 by
// the second product); y = f32(x) + (o . Wout in f32 + bout), one rounding.
// The training variant keeps qkv and o (the backward's residuals); the
// inference variant writes them to scratch the caller drops.
//
// What bounds it on the H100: the two products are 2 * N * C * 3HD +
// 2 * N * HD * C FLOPs (25.8 GFLOP at N = 8192 tokens, C = 768, HD = 512:
// 26 us at the 989 TFLOP/s bf16 peak) over x in, y out and the weights
// (~29 MB, 9 us): operations-bound.
//
// What the design does about it: the TPU kernel keeps a tile of tokens in VMEM
// through both products. Here one sequence's xa and qkv at S = 256 (1.2 MB) are
// over a block's 227 KB, so the entry point enqueues four kernels on the
// stream, with xa, qkv and o in device memory between them (they stay in the
// 50 MB L2 at the model's sizes):
//   1. token LN -> xa (bf16), one warp per token;
//   2. qkv = xa . Wqkv + bqkv on the tensor cores (wmma 16x16x16 bf16, f32
//      accumulators): a block owns a 128 x 128 output tile, 8 warps of 64 x 32,
//      A and B staged through padded shared memory 32 columns of K at a time,
//      the next slab's global loads in flight in registers meanwhile;
//   3. the fused QK-norm + RoPE + attention kernel of fused_attention_core.cuh;
//   4. y = x + o . Wout + bout, the same GEMM with the residual in its epilogue.
// wgmma, TMA and a multi-stage pipeline are left for a later version.

#include <mma.h>

#include "fused_attention_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int GEMM_THREADS = 256;
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_LD = BK + 8;   // 80-byte rows: 16-byte aligned vectors, 32-byte aligned tiles
constexpr int B_LD = BN + 8;   // 272-byte rows
constexpr int WARP_M = 64, WARP_N = 32;  // 2 x 4 warps over the block's tile
constexpr int LN_WARPS = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- 1. token LayerNorm + affine, rounded to bf16 --------------------------

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
    const float v = to_float(src[c]);
    s += v;
    sq += v * v;
  }
  const float mean = warp_sum(s) / C;
  const float var = fmaxf(warp_sum(sq) / C - mean * mean, 0.f);
  const float r = rsqrtf(var + LN_EPS);
  bf16* dst = xa + row * C;
  for (int c = lane; c < C; c += 32) {
    const float xn = (to_float(src[c]) - mean) * r;
    dst[c] = __float2bfloat16(xn * gamma[c] + beta[c]);
  }
}

// ---- 2, 4. out = A . W + bias (+ residual) on the tensor cores -------------

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
// W: (K, M) row-major bf16. bias: (M,) f32. resid, out: (N, M) row-major TO.
// K and M are multiples of 8; N is arbitrary.
template <typename TA, typename TO, bool RESIDUAL>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bias_kernel(const TA* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const TO* __restrict__ resid,
                 TO* __restrict__ out, long long N, int K, int M) {
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
          if constexpr (RESIDUAL) val = to_float(resid[o + e]) + val;
          out[o + e] = from_float<TO>(val);
        }
      }
      __syncwarp();
    }
  }
}

template <typename TA, typename TO, bool RESIDUAL>
cudaError_t launch_gemm(const TA* A, const bf16* W, const float* bias, const TO* resid, TO* out,
                        long long N, int K, int M, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BN - 1) / BN), (unsigned)((N + BM - 1) / BM));
  gemm_bias_kernel<TA, TO, RESIDUAL><<<grid, GEMM_THREADS, 0, stream>>>(A, W, bias, resid, out, N,
                                                                         K, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sublayer(const void* x, const void* mask, const void* ln_g, const void* ln_b,
                            const void* wqkv, const void* bqkv, const void* q_scale,
                            const void* k_scale, const void* cos_t, const void* sin_t,
                            const void* wout, const void* bout, void* y, void* qkv, void* o,
                            void* xa, int B, int S, int C, int H, cudaStream_t stream) {
  const long long n = (long long)B * S;
  const int HD = H * D;
  const T* xt = static_cast<const T*>(x);
  bf16* xa_t = static_cast<bf16*>(xa);
  T* qkv_t = static_cast<T*>(qkv);
  T* o_t = static_cast<T*>(o);

  token_ln_kernel<T><<<(unsigned)((n + LN_WARPS - 1) / LN_WARPS), LN_WARPS * 32, 0, stream>>>(
      xt, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), xa_t, n, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = launch_gemm<bf16, T, false>(xa_t, static_cast<const bf16*>(wqkv),
                                    static_cast<const float*>(bqkv), nullptr, qkv_t, n, C, 3 * HD,
                                    stream);
  if (err != cudaSuccess) return err;

  err = launch_fused_attention<T>(qkv, q_scale, k_scale, cos_t, sin_t, mask, o, B, S, H, stream);
  if (err != cudaSuccess) return err;

  return launch_gemm<T, T, true>(o_t, static_cast<const bf16*>(wout),
                                 static_cast<const float*>(bout), xt, static_cast<T*>(y), n, HD, C,
                                 stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, qkv, o). x, y: (B, S, C); qkv: (B, S, 3*H*D);
// o: (B, S, H*D); xa: bf16 scratch (B, S, C). ln_g, ln_b, bqkv, bout, q_scale, k_scale,
// cos_t, sin_t: f32. wqkv (C, 3*H*D) and wout (H*D, C): bf16, row-major.
// mask: (B, S) uint8 key mask, or null. C a multiple of 8. Every pointer 16-byte aligned.
extern "C" int vvt_attention_sublayer(const void* x, const void* mask, const void* ln_g,
                                      const void* ln_b, const void* wqkv, const void* bqkv,
                                      const void* q_scale, const void* k_scale, const void* cos_t,
                                      const void* sin_t, const void* wout, const void* bout,
                                      void* y, void* qkv, void* o, void* xa, int B, int S, int C,
                                      int H, int head_dim, int dtype, void* stream) {
  if (head_dim != D || S < 1 || S > MAX_ROWS || B < 1 || H < 1 || C < 8 || C % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_sublayer<float>(x, mask, ln_g, ln_b, wqkv, bqkv, q_scale, k_scale, cos_t,
                                       sin_t, wout, bout, y, qkv, o, xa, B, S, C, H, st);
  if (dtype == 1)
    return (int)launch_sublayer<bf16>(x, mask, ln_g, ln_b, wqkv, bqkv, q_scale, k_scale, cos_t,
                                      sin_t, wout, bout, y, qkv, o, xa, B, S, C, H, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
