// The whole MLP sublayer behind one entry point:
//   y = x + W2 . silu(W1 . LN(x) + b1) + b2
//
// Replaces: video_vae_tpu/ops/fused_block.py, _mlp_pallas -> _mlp_kernel (the
// inference variant: y only) and _mlp_kernel_res (the training variant: y and
// the backward's residuals xa and h, both bf16).
// Roundings, as there, whatever x's dtype: token LN with f32 statistics
// (E[x^2] - mean^2 clamped at 0, eps 1e-6), xa = LN(x) * g + b rounded to bf16;
// W1 and W2 arrive as bf16; h = xa . W1 (f32 accumulation) + b1 rounded to
// bf16; a = silu(f32(h)) rounded to bf16, silu(v) = v * (1 / (1 + expf(-v)));
// y = f32(x) + (a . W2 in f32 + b2), one rounding to x's dtype. Any row count
// N: the TPU wrapper pads the rows to its tile, here TMA reads zeros past the
// last row and the epilogue masks its stores. Both products take bf16
// operands whatever x's dtype is, so f32 x runs the same GEMM.
//
// What bounds it on the H100: the two products are 4 * N * C * F FLOPs
// (38.7 GFLOP at N = 8192 tokens, C = 768, F = 1536: 39 us at the 989 TFLOP/s
// bf16 peak) over x in, y out and the weights (~30 MB in bf16, 9 us):
// operations-bound, so the design is there to reach the tensor cores' rate.
//
// What the design does about it (gemm_sm90.cuh): three launches on the
// stream, with xa and a in device memory between them:
//   1. token LN -> xa (bf16), one warp a token, x read once;
//   2. a = silu(xa . W1 + b1): the warp-specialised wgmma GEMM (TMA ring,
//      two consumer warpgroups of m64nBNk16), whose epilogue adds b1, rounds
//      h to bf16, writes h when the caller keeps the residuals, and writes a;
//   3. y = x + a . W2 + b2, the same GEMM with the residual in its epilogue.
// The TPU kernel keeps a tile of rows in VMEM through both products. Here
// that does not pay: a 64-row tile of y at C = 768 is 196 KB of f32
// accumulators a block, and fusing the products would save L2 traffic, not
// device-memory traffic: a (25 MB at N = 8192) stays in the 50 MB L2 between
// launches 2 and 3. The tile width, the ring's stages and the persistent
// grid of each product come from ops/fused_block.py:mlp_plan, held on the
// CPU by tests/test_torch_mlp_plan.py.

#include "gemm_sm90.cuh"

namespace {

using vvt_sm90::bf16;
using vvt_sm90::EPI_RESIDUAL;
using vvt_sm90::EPI_SILU;
using vvt_sm90::GemmPlan;
using vvt_sm90::launch_gemm;
using vvt_sm90::launch_token_ln;

template <typename T>
cudaError_t launch_mlp(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* y, void* xa, void* h,
                       void* a, int n, int C, int F, GemmPlan up, GemmPlan down,
                       cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  bf16* xa_t = static_cast<bf16*>(xa);
  bf16* a_t = static_cast<bf16*>(a);

  cudaError_t err = launch_token_ln<T>(xt, static_cast<const float*>(ln_g),
                                       static_cast<const float*>(ln_b), xa_t, n, C, stream);
  if (err != cudaSuccess) return err;

  err = launch_gemm<EPI_SILU, bf16>(xa_t, static_cast<const bf16*>(w1),
                                    static_cast<const float*>(b1), nullptr, a_t,
                                    static_cast<bf16*>(h), n, C, F, up, stream);
  if (err != cudaSuccess) return err;

  return launch_gemm<EPI_RESIDUAL, T>(a_t, static_cast<const bf16*>(w2),
                                      static_cast<const float*>(b2), xt, static_cast<T*>(y),
                                      nullptr, n, F, C, down, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y). x, y: (N, C). ln_g, ln_b, b2: (C,) f32;
// b1: (F,) f32. w1 (C, F) and w2 (F, C): bf16, row-major. xa: (N, C) bf16 and a:
// (N, F) bf16, written always (scratch for the inference variant). h: (N, F) bf16,
// written when not null (the training variant). C and F multiples of 8; N below
// 2^31. Every pointer 16-byte aligned. up_* and down_*: the plan of the first
// (xa . W1) and the second (a . W2) product: tile width, stages, blocks and
// shared-memory bytes (ops/fused_block.py:mlp_plan).
extern "C" int vvt_fused_mlp(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* y, void* xa,
                             void* h, void* a, long long n, int C, int F, int dtype, int up_bn,
                             int up_stages, int up_blocks, int up_smem, int down_bn,
                             int down_stages, int down_blocks, int down_smem, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || C < 8 || C % 8 || F < 8 || F % 8)
    return (int)cudaErrorInvalidValue;
  const GemmPlan up{up_bn, up_stages, up_blocks, up_smem};
  const GemmPlan down{down_bn, down_stages, down_blocks, down_smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = (int)n;
  if (dtype == 0)
    return (int)launch_mlp<float>(x, ln_g, ln_b, w1, b1, w2, b2, y, xa, h, a, rows, C, F, up, down, st);
  if (dtype == 1)
    return (int)launch_mlp<bf16>(x, ln_g, ln_b, w1, b1, w2, b2, y, xa, h, a, rows, C, F, up, down, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
