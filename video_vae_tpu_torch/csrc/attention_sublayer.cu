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
//   1. token LN -> xa (bf16), one warp per token (gemm_bf16.cuh);
//   2. qkv = xa . Wqkv + bqkv on the tensor cores (the wmma GEMM of
//      gemm_bf16.cuh: a block owns a 128 x 128 output tile, 8 warps of
//      64 x 32);
//   3. the fused QK-norm + RoPE + attention kernel of fused_attention_core.cuh;
//   4. y = x + o . Wout + bout, the same GEMM with the residual in its epilogue.
// wgmma, TMA and a multi-stage pipeline are left for a later version.

#include "fused_attention_core.cuh"
#include "gemm_bf16.cuh"

namespace {

using vvt_gemm::bf16;
using vvt_gemm::EPI_BIAS;
using vvt_gemm::EPI_RESIDUAL;
using vvt_gemm::launch_gemm;
using vvt_gemm::launch_token_ln;

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

  cudaError_t err = launch_token_ln<T>(xt, static_cast<const float*>(ln_g),
                                       static_cast<const float*>(ln_b), xa_t, n, C, stream);
  if (err != cudaSuccess) return err;

  err = launch_gemm<bf16, T, EPI_BIAS>(xa_t, static_cast<const bf16*>(wqkv),
                                       static_cast<const float*>(bqkv), nullptr, qkv_t, n, C, 3 * HD,
                                       stream);
  if (err != cudaSuccess) return err;

  err = launch_fused_attention<T>(qkv, q_scale, k_scale, cos_t, sin_t, mask, o, B, S, H, stream);
  if (err != cudaSuccess) return err;

  return launch_gemm<T, T, EPI_RESIDUAL>(o_t, static_cast<const bf16*>(wout),
                                         static_cast<const float*>(bout), xt, static_cast<T*>(y), n,
                                         HD, C, stream);
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
