// The whole MLP sublayer behind one entry point:
//   y = x + W2 . silu(W1 . LN(x) + b1) + b2
//
// Replaces: video_vae_tpu/ops/fused_block.py, _mlp_pallas -> _mlp_kernel (the
// inference variant: y only) and _mlp_kernel_res (the training variant: y and
// the backward's residuals xa and h, both bf16).
// Roundings, as there, whatever x's dtype: token LN with f32 statistics
// (E[x^2] - mean^2 clamped at 0, eps 1e-6), xa = LN(x) * g + b rounded to bf16;
// W1 and W2 arrive as bf16; h = xa . W1 (f32 accumulation) + b1 rounded to
// bf16; a = silu(f32(h)) rounded to bf16; y = f32(x) + (a . W2 in f32 + b2),
// one rounding to x's dtype. Any row count N: the TPU wrapper pads the rows to
// its tile, here the GEMM masks its ragged last row tile.
//
// What bounds it on the H100: the two products are 4 * N * C * F FLOPs
// (38.7 GFLOP at N = 8192 tokens, C = 768, F = 1536: 39 us at the 989 TFLOP/s
// bf16 peak) over x in, y out and the weights (~30 MB in bf16, 9 us):
// operations-bound.
//
// What the design does about it: the TPU kernel keeps a tile of rows in VMEM
// through both products. Here the hidden tile of 128 rows (128 x 1536 x 2 B =
// 393 KB) is over a block's 227 KB of shared memory, so the entry point
// enqueues three kernels on the stream, with xa and a in device memory between
// them (25 MB of a at N = 8192: inside the 50 MB L2):
//   1. token LN -> xa (bf16), one warp per token;
//   2. a = silu(xa . W1 + b1) with the wmma GEMM of gemm_bf16.cuh, whose
//      epilogue adds b1, rounds h to bf16, writes h when the caller keeps the
//      residuals, and writes a;
//   3. y = x + a . W2 + b2, the same GEMM with the residual in its epilogue.
// A later version would keep a 64-row hidden tile (196 KB) in shared memory
// between the two products, or split F over a cluster's blocks and reduce
// through distributed shared memory, with wgmma and TMA for the products.

#include "gemm_bf16.cuh"

namespace {

using vvt_gemm::bf16;
using vvt_gemm::EPI_RESIDUAL;
using vvt_gemm::EPI_SILU;
using vvt_gemm::launch_gemm;
using vvt_gemm::launch_token_ln;

template <typename T>
cudaError_t launch_mlp(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* y, void* xa, void* h,
                       void* a, long long n, int C, int F, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  bf16* xa_t = static_cast<bf16*>(xa);
  bf16* a_t = static_cast<bf16*>(a);

  cudaError_t err = launch_token_ln<T>(xt, static_cast<const float*>(ln_g),
                                       static_cast<const float*>(ln_b), xa_t, n, C, stream);
  if (err != cudaSuccess) return err;

  err = launch_gemm<bf16, bf16, EPI_SILU>(xa_t, static_cast<const bf16*>(w1),
                                          static_cast<const float*>(b1), nullptr, a_t,
                                          static_cast<bf16*>(h), n, C, F, stream);
  if (err != cudaSuccess) return err;

  return launch_gemm<bf16, T, EPI_RESIDUAL>(a_t, static_cast<const bf16*>(w2),
                                            static_cast<const float*>(b2), xt, static_cast<T*>(y),
                                            nullptr, n, F, C, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y). x, y: (N, C). ln_g, ln_b, b2: (C,) f32;
// b1: (F,) f32. w1 (C, F) and w2 (F, C): bf16, row-major. xa: (N, C) bf16 and a:
// (N, F) bf16, written always (scratch for the inference variant). h: (N, F) bf16,
// written when not null (the training variant). C and F multiples of 8. Every
// pointer 16-byte aligned.
extern "C" int vvt_fused_mlp(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* y, void* xa,
                             void* h, void* a, long long n, int C, int F, int dtype, void* stream) {
  if (n < 1 || C < 8 || C % 8 || F < 8 || F % 8) return (int)cudaErrorInvalidValue;
  if ((n + vvt_gemm::BM - 1) / vvt_gemm::BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_mlp<float>(x, ln_g, ln_b, w1, b1, w2, b2, y, xa, h, a, n, C, F, st);
  if (dtype == 1)
    return (int)launch_mlp<bf16>(x, ln_g, ln_b, w1, b1, w2, b2, y, xa, h, a, n, C, F, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
