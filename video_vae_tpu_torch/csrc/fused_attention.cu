// Fused QK-norm + RoPE + attention forward, straight off the fused QKV projection.
//
// Replaces: video_vae_tpu/ops/flash_attention.py, _fused_pallas -> _fused_kernel
// (math in _attention_core). Per (sequence, head): split q/k/v out of the
// (B, S, 3*H*D) row, LayerNorm q and k over D (no bias, f32 statistics,
// E[x^2]-mean^2 clamped at 0, eps 1e-6, times the (D,) scale), rotate-half
// RoPE with (S, D) f32 tables, softmax(q k^T / sqrt(D) + key mask) v, one
// rounding to the output dtype. D in {16, 32, 64, 128} (a template parameter of
// every kernel, one instantiation each; another even D up to 128 runs the next,
// its heads padded by the wrapper, with the true D's 1/D and 1/sqrt(D) taken at
// run time: fa_mma::HeadScale), any S >= 1. A masked key (j < S,
// mask 0) scores -1e30, so a row whose keys are all masked averages all S
// keys; a key past S (a tile's padding) adds exactly 0.
//
// What bounds it on the H100: bytes. Every call reads the (B, S, 3*H*D)
// projection once and writes (B, S, H*D): 33.6 MB at the model's b2 calls
// (temporal S = 16 over 512 sequences, spatial S = 256 over 32), ~10 us at
// 3.35 TB/s. The products are 4*S*S*D FLOPs per (sequence, head): 0.27 GFLOP
// (temporal) and 4.3 GFLOP (spatial) a call, 4.3 us at the 989 TFLOP/s bf16
// peak, so the spatial call is within 2.3x of the ridge (171 FLOPs a byte,
// against ~295).
//
// bf16 qkv: a tensor-core kernel (fused_attention_mma.cuh), one launch:
// - Products: mma.sync m16n8k16, bf16 operands and f32 accumulators, with
//   ldmatrix from shared memory (ldmatrix.trans for V). Not wgmma: at S = 16
//   one (sequence, head) is exactly one 16-row tile, and wgmma's 64-row tile
//   would waste 3/4 of its products on block-diagonal packing; at S = 256 the
//   products take about as long as the bytes even at a fraction of peak.
//   mma.sync's documented accumulator layout keeps the softmax in registers:
//   two adjacent 16x8 score accumulators are, as they stand, the A fragment of
//   a 16-key step of P.V, with no trip through shared memory.
// - Staging: cp.async copies every q, k and v head row of the block into
//   shared memory (16 bytes a thread, each token's row in order, so all of a
//   block's loads are in flight at once), q and k as one group and v as a
//   second that P.V alone waits for. Then four lanes a row apply LayerNorm +
//   RoPE to q and k in place and round them to bf16: a lane holds a 16-byte
//   piece and its rotate-half partner 32 elements on, so the rotation takes no
//   shuffle, and the row's sums take two __shfl_xor; the same four lanes take
//   the q row and the k row of one position, so one load of the cos/sin rows
//   serves both.
// - Geometry (the variant and the sequences a slab block from
//   ops/flash_attention.py:fused_attention_plan; warps and shared memory
//   derived here): S <= 64, "slab": a block stages whole sequences with all H
//   heads (48 KB of qkv a sequence at S = 16, coalesced loads and (S, H*D)
//   stores), and a warp takes one 16-query-row tile of one head at a time.
//   S > 64, "tile": a block owns one (sequence, head) pair and all its query
//   rows, a warp for each 16 (16 warps at S = 256, 110 KB of shared memory),
//   so the pair's k and v are read and normalised once. S > 256, "split"
//   (attention_split.cuh): a pass writes k~ (and at head dims 16 and 32 q~;
//   LN + RoPE, rounded to bf16, by the same code) to the caller's workspace,
//   then a block takes some query rows of one pair and streams its keys, so
//   no S caps it: at head dims 64 and 128 a warp-specialised wgmma launch fed
//   by a TMA ring that normalises its own q rows (attention_split_fwd.cuh: 128
//   rows a block, two consumer warpgroups and a producer), at 16 and 32 an
//   mma.sync one (64 rows, double buffers).
// - Softmax: a warp holds its 16 query rows' q fragments in registers and
//   walks the keys in chunks of up to 64 with a running (online) max: one
//   chunk, so an exact max, up to S = 64; four at S = 256, where an exact max
//   would cost a second QK^T. O accumulates as 16 x D f32 in registers and
//   leaves through the warp's own q rows in shared memory, 16 bytes a lane.
// Measured on the H100 (PERF.md): the temporal call takes about twice its
// bytes bound, with staging, LN and the products in turn; the spatial call is
// set by its products (111 TFLOP/s over the whole call).
// Roundings, as the JAX package's: q~ and k~ (after LN and RoPE) to bf16
// before q~k~^T (its non-TPU chain, _reference_fused_chain, does the same);
// P to bf16 before P.V (_attention_core). Where JAX takes its packed path
// (S < 128 and S*H a multiple of 128; the model's temporal S = 16 with 8
// heads) P is normalised first and then rounded (on one chunk the row's sum
// is at hand; past 64 keys a first pass of scores gives the exact max and
// sum); otherwise P = exp(s - running max) is rounded unnormalised and 1/l
// scales the f32 output. The output is rounded to bf16 once.
//
// f32 qkv keeps the first version on the CUDA cores (fused_attention_core.cuh,
// shared with the attention sublayer): one thread a query row, f32 throughout.
// A later version would issue wgmma from warpgroups and stage with TMA under
// warp specialisation, so that one tile's loads and LN overlap another's
// products.
//
// D = 128: the bf16 kernel is the same code with at most 8 warps a block
// (FWD_WARPS<128>): a warp's 16 x 128 f32 output and its q fragments take 96
// registers a lane, so 16 warps capped at 128 registers would spill; a tile
// block (205 KB of q, k, v rows at S = 256) then gives each warp two 16-row
// query tiles in turn. f32 takes the quad kernel of attention_f32_wide.cuh
// (four lanes a row, k~ and v staged in 64-key chunks): one thread a row would
// need 256 registers and the whole sequence's f32 k and v 270 KB. Past S =
// 256 f32 takes that quad kernel at every D: the row-a-thread kernel stages a
// block's sequences whole.

#include "attention_split_fwd.cuh"
#include "attention_wide.cuh"
#include "fused_attention_core.cuh"
#include "fused_attention_mma.cuh"

// dtype: 0 = float32, 1 = bfloat16. mask: (B, S) uint8 key mask, or null.
// variant, unit: the bf16 kernel's plan (slab 0, tile 1 or split 2; sequences
// a slab block, 1 otherwise); the f32 kernel takes its geometry from the shape.
// work: for the bf16 split variant, a bf16 scratch of B * S * H * head_dim (k~)
// at head_dim 64 and 128, twice that (q~ and k~) at 16 and 32; null otherwise.
// head_dim: 16, 32, 64 or 128; any other is refused. true_dim d and scale: the
// head dim of the call, even, 2 <= d <= head_dim (the wrapper pads each head of d
// to head_dim by halves, ops/flash_attention.py:pad_heads, with the scales' and
// the tables' columns), and its softmax scale 1/sqrt(d) rounded to f32; the
// kernels take 1/d and that scale at run time (fa_mma::HeadScale).
// variant 4 ("wide", both dtypes): head_dim a multiple of 128 past 128, unit 1, work
// a scratch of 2 * B * S * H * head_dim elements of qkv's dtype (q~ and k~).
extern "C" int vvt_fused_attention_fwd(const void* qkv, const void* q_scale, const void* k_scale,
                                       const void* cos_t, const void* sin_t, const void* mask,
                                       void* out, void* work, int B, int S, int H, int head_dim, int true_dim,
                                       float scale, int dtype, int variant, int unit, void* stream) {
  if (S < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1) || !fa_mma::takes_head(true_dim, head_dim, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const fa_mma::HeadScale hs = fa_mma::head_scale(true_dim, scale);
  if (variant == fa_mma::WIDE) {  // a head dim past 128 (attention_wide.cuh)
    if (unit != 1) return (int)cudaErrorInvalidValue;
    return (int)(dtype == 0 ? fa_mma::wide::launch_fused_fwd<float>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out,
                                                                   work, B, S, H, head_dim, hs, st)
                            : fa_mma::wide::launch_fused_fwd<fa_mma::bf16>(qkv, q_scale, k_scale, cos_t, sin_t, mask,
                                                                          out, work, B, S, H, head_dim, hs, st));
  }
  return (int)fa_mma::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch_fused_attention<float, D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, S, H, hs.scale,
                                              hs.inv_d, st);
    if (variant == fa_mma::SPLIT) {
      if (unit != 1) return cudaErrorInvalidValue;
      return fa_mma::launch_split_fused_fwd<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, work, B, S, H, hs, st);
    }
    return fa_mma::launch_attention_mma<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, S, H, variant, unit, hs,
                                           st);
  });
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
