// The whole attention sublayer behind one entry point:
//   y = x + Wout . attention(qk-LN + RoPE(LN(x) . Wqkv + bqkv)) + bout
//
// Replaces: video_vae_tpu/ops/flash_attention.py, _sublayer_pallas -> _sublayer_kernel.
// Roundings: token LN with f32 statistics (E[x^2] - mean^2 clamped at 0,
// eps 1e-6), xa = LN(x) * g + b rounded to bf16; Wqkv and Wout arrive as
// bf16; qkv = xa . Wqkv (f32 accumulation) + bqkv rounded once to x's dtype;
// the attention of fused_attention.cu on that qkv, o in x's dtype (bf16 qkv
// takes #1's tensor-core rule: q~, k~ and P rounded to bf16); the second
// product reads o as bf16; y = f32(x) + (o . Wout in f32 + bout), one
// rounding. The training variant keeps qkv and o (the backward's residuals);
// the inference variant writes them to scratch the caller drops.
//
// What bounds it on the H100: the two products are 2 * N * C * 3HD +
// 2 * N * HD * C FLOPs (25.8 GFLOP at N = 8192 tokens, C = 768, HD = 512:
// 26 us at the 989 TFLOP/s bf16 peak) over x in, y out and the weights
// (~29 MB, 9 us): operations-bound.
//
// What the design does about it: the TPU kernel keeps a tile of tokens in VMEM
// through both products. Here one sequence's xa and qkv at S = 256 (1.2 MB) are
// over a block's 227 KB, so the entry point enqueues four launches of device
// code the port already runs elsewhere, with xa, qkv and o in device memory
// between them (they stay in the 50 MB L2 at the model's sizes):
//   1. token LN -> xa (bf16), one warp a token, x read once (gemm_sm90.cuh);
//   2. qkv = xa . Wqkv + bqkv on the warp-specialised wgmma GEMM of
//      gemm_sm90.cuh (TMA ring, two consumer warpgroups of m64nBNk16,
//      persistent blocks), its EPI_BIAS epilogue rounding once;
//   3. the attention: bf16 qkv takes #1's mma.sync kernel
//      (fused_attention_mma.cuh, as fused_attention.cu launches it; past S =
//      256 #1's split variant, attention_split_fwd.cuh: its LN + RoPE pass
//      into the caller's workspace, then its core, two launches); f32 qkv
//      the CUDA-core kernel of fused_attention_core.cuh, whose f32 o one more
//      launch casts to a bf16 scratch, since TMA loads the A operand in bf16;
//   4. y = x + o . Wout + bout, the same GEMM with the residual in its epilogue.
// The tile width, stages and grid of each product come from
// ops/flash_attention.py:sublayer_plan (ops/fused_block.py:gemm_plan), the
// attention's variant and sequences a block from fused_attention_plan; the
// plan is held on the CPU by tests/test_torch_sublayer_plan.py.
// Measured on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's
// "kernel-check" lines, PERF.md): bf16, device ms summed over the 42 calls of
// a train step 3.76 / 3.71 (two runs; LN 0.34, xa . Wqkv 1.18, the attention
// 0.97, o . Wout 0.95, the wrapper's weight casts the rest), 4.0x its bound of
// 0.94 and 1.7x ahead of layer_norm -> matmul -> SDPA -> matmul (6.42); over
// a b2 serving pass 4.63 / 4.57 against 8.00. xa . Wqkv runs at 500-570
// TFLOP/s, o . Wout at 205-240: its K = 512 is 8 slabs a tile, so filling the
// ring and the epilogue weigh more.
// D = 128 (e.g. 4 heads at H D = 512): the products are the flagship's (o .
// Wout's K = 512 in 8 slabs); the attention launch is #1's at D = 128 (8
// warps a bf16 block, the quad kernel for f32 x).

#include "attention_split_fwd.cuh"
#include "attention_wide.cuh"
#include "fused_attention_core.cuh"
#include "fused_attention_mma.cuh"
#include "gemm_sm90.cuh"

#include <algorithm>

namespace {

using vvt_sm90::bf16;
using vvt_sm90::GemmPlan;

constexpr int CAST_THREADS = 256;
constexpr long long CAST_MAX_BLOCKS = 4096;

// o16 = bf16(o), round to nearest even as torch's cast: 8 values a step.
__global__ void __launch_bounds__(CAST_THREADS)
o_to_bf16_kernel(const float* __restrict__ o, bf16* __restrict__ o16, long long vecs) {
  for (long long i = (long long)blockIdx.x * CAST_THREADS + threadIdx.x; i < vecs;
       i += (long long)gridDim.x * CAST_THREADS) {
    float v[8];
    vvt_sm90::load8(o + 8 * i, v);
    vvt_sm90::store8(o16 + 8 * i, v);
  }
}

// The token LN, the qkv product, the attention (attend: its launch, writing o
// from qkv), then for f32 x o's cast to bf16, and the out projection with the residual.
template <typename T, typename Attend>
cudaError_t launch_sublayer(const void* x, const void* ln_g, const void* ln_b, const void* wqkv, const void* bqkv,
                            const void* wout, const void* bout, void* y, void* qkv, void* o, void* xa, void* o16,
                            int B, int S, int C, int HD, GemmPlan qkv_plan, GemmPlan out_plan, Attend attend,
                            cudaStream_t stream) {
  const int n = B * S;
  const T* xt = static_cast<const T*>(x);
  bf16* xa_t = static_cast<bf16*>(xa);

  cudaError_t err = vvt_sm90::launch_token_ln<T>(xt, static_cast<const float*>(ln_g),
                                                 static_cast<const float*>(ln_b), xa_t, n, C, stream);
  if (err != cudaSuccess) return err;

  err = vvt_sm90::launch_gemm<vvt_sm90::EPI_BIAS, T>(
      xa_t, static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv), nullptr,
      static_cast<T*>(qkv), nullptr, n, C, 3 * HD, qkv_plan, stream);
  if (err != cudaSuccess) return err;

  err = attend();
  if (err != cudaSuccess) return err;
  const bf16* o_bf16;
  if constexpr (sizeof(T) == 2) {
    o_bf16 = static_cast<const bf16*>(o);
  } else {
    const long long vecs = (long long)n * HD / 8;
    const long long blocks = std::min<long long>((vecs + CAST_THREADS - 1) / CAST_THREADS, CAST_MAX_BLOCKS);
    o_to_bf16_kernel<<<(unsigned)blocks, CAST_THREADS, 0, stream>>>(static_cast<const float*>(o),
                                                                  static_cast<bf16*>(o16), vecs);
    err = cudaGetLastError();
    o_bf16 = static_cast<const bf16*>(o16);
  }
  if (err != cudaSuccess) return err;

  return vvt_sm90::launch_gemm<vvt_sm90::EPI_RESIDUAL, T>(
      o_bf16, static_cast<const bf16*>(wout), static_cast<const float*>(bout), xt,
      static_cast<T*>(y), nullptr, n, HD, C, out_plan, stream);
}

}  // namespace

// head_dim D: 16, 32, 64 or 128; any other is refused. true_dim d and scale: the
// call's head dim, even, 2 <= d <= D, and its softmax scale 1/sqrt(d) in f32; the
// wrapper pads each head of d to D by halves (ops/flash_attention.py:pad_heads:
// Wqkv's and bqkv's columns, Wout's rows, the scales and the tables), so that
// qkv's and o's padded columns are zero.
// dtype: 0 = float32, 1 = bfloat16 (x, y, qkv, o). x, y: (B, S, C); qkv: (B, S, 3*H*D);
// o: (B, S, H*D); xa: bf16 scratch (B, S, C); o16: bf16 scratch (B, S, H*D) for
// float32 x, null for bfloat16. ln_g, ln_b, bqkv, bout, q_scale, k_scale, cos_t,
// sin_t: f32. wqkv (C, 3*H*D) and wout (H*D, C): bf16, row-major. mask: (B, S)
// uint8 key mask, or null. C a multiple of 8; B * S below 2^31. Every pointer
// 16-byte aligned. qkv_* and out_*: the plan of the first (xa . Wqkv) and the
// second (o . Wout) product: tile width, stages, blocks and shared-memory bytes;
// variant, unit: the bf16 attention's (ops/flash_attention.py:sublayer_plan).
// work: for bf16 x with the split variant, #1's workspace (fused_attention.cu:
// B * S * H * head_dim bf16 for k~ at head_dim 64 and 128, twice that for q~
// and k~ at 16 and 32); with variant 4 ("wide", a head_dim past 128, a multiple of
// 128), for either dtype, 2 * B * S * H * head_dim elements of x's dtype (q~ and k~);
// null otherwise.
extern "C" int vvt_attention_sublayer(const void* x, const void* mask, const void* ln_g,
                                      const void* ln_b, const void* wqkv, const void* bqkv,
                                      const void* q_scale, const void* k_scale, const void* cos_t,
                                      const void* sin_t, const void* wout, const void* bout,
                                      void* y, void* qkv, void* o, void* xa, void* o16, void* work,
                                      int B, int S, int C, int H, int head_dim, int true_dim, float scale,
                                      int dtype, int qkv_bn, int qkv_stages, int qkv_blocks, int qkv_smem,
                                      int out_bn, int out_stages, int out_blocks, int out_smem, int variant,
                                      int unit, void* stream) {
  if (S < 1 || B < 1 || H < 1 || C < 8 || C % 8 || (long long)B * S > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1) || (dtype == 0 && o16 == nullptr) || !fa_mma::takes_head(true_dim, head_dim, scale))
    return (int)cudaErrorInvalidValue;
  const fa_mma::HeadScale hs = fa_mma::head_scale(true_dim, scale);
  const GemmPlan qkv_plan{qkv_bn, qkv_stages, qkv_blocks, qkv_smem};
  const GemmPlan out_plan{out_bn, out_stages, out_blocks, out_smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero, int HD, auto attend) {
    using T = decltype(zero);
    return launch_sublayer<T>(x, ln_g, ln_b, wqkv, bqkv, wout, bout, y, qkv, o, xa, o16, B, S, C, HD, qkv_plan,
                              out_plan, attend, st);
  };
  if (variant == fa_mma::WIDE) {  // a head dim past 128, both dtypes (attention_wide.cuh)
    if (unit != 1) return (int)cudaErrorInvalidValue;
    const int HD = H * head_dim;
    if (dtype == 0)
      return (int)run(0.f, HD, [&] {
        return fa_mma::wide::launch_fused_fwd<float>(qkv, q_scale, k_scale, cos_t, sin_t, mask, o, work, B, S, H,
                                                     head_dim, hs, st);
      });
    return (int)run(bf16(), HD, [&] {
      return fa_mma::wide::launch_fused_fwd<bf16>(qkv, q_scale, k_scale, cos_t, sin_t, mask, o, work, B, S, H,
                                                  head_dim, hs, st);
    });
  }
  return (int)fa_mma::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return run(0.f, H * D, [&] {
        return launch_fused_attention<float, D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, o, B, S, H, hs.scale,
                                                hs.inv_d, st);
      });
    return run(bf16(), H * D, [&] {
      if (variant == fa_mma::SPLIT)
        return unit != 1 ? cudaErrorInvalidValue
                         : fa_mma::launch_split_fused_fwd<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, o, work, B, S,
                                                             H, hs, st);
      return fa_mma::launch_attention_mma<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, o, B, S, H, variant, unit,
                                             hs, st);
    });
  });
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
