// Fused QK-norm + RoPE + attention forward, straight off the fused QKV projection.
//
// Replaces: video_vae_tpu/ops/flash_attention.py, _fused_pallas -> _fused_kernel
// (math in _attention_core). Per (sequence, head): split q/k/v out of the
// (B, S, 3*H*D) row, LayerNorm q and k over D (no bias, f32 statistics,
// E[x^2]-mean^2 clamped at 0, eps 1e-6, times the (D,) scale), rotate-half
// RoPE with (S, D) f32 tables, softmax(q k^T / sqrt(D) + key mask) v, one
// rounding to the output dtype. D = 64, S <= 256.
//
// What bounds it on the H100: at the model's shapes every call is memory
// bound on paper (temporal: S = 16, 0.27 GFLOP over 33.6 MB; spatial: S = 256,
// 4.3 GFLOP over 33.6 MB), i.e. ~10 us at 3.35 TB/s. This first version does
// its arithmetic in f32 on the CUDA cores, so at S = 256 the 4*S*S*D FLOPs per
// (sequence, head) on the 67 TFLOP/s f32 pipe are the real limit.
//
// What the design does about it: every byte of q, k, v is read from device
// memory once and the S x S scores never leave the SM. One thread owns one
// query row: it keeps its normalised, rotated q and its f32 output
// accumulator in registers and walks the keys in chunks of 16 with an online
// softmax, so k and v are read from shared memory as broadcasts (all threads
// of a (sequence, head) read the same key row). A block holds 256 rows: one
// (sequence, head) at S = 256, sixteen at the temporal S = 16. Normalised
// k and v sit in shared memory as f32 (2 x 256 x 68 floats, 139 KB, above the
// 48 KB default, so the launcher raises the block's dynamic limit).
// Tensor cores (wgmma) and a bf16 P.V are left for a later version.


#include "fused_attention_core.cuh"

// dtype: 0 = float32, 1 = bfloat16. mask: (B, S) uint8 key mask, or null.
extern "C" int vvt_fused_attention_fwd(const void* qkv, const void* q_scale, const void* k_scale,
                                       const void* cos_t, const void* sin_t, const void* mask,
                                       void* out, int B, int S, int H, int head_dim, int dtype,
                                       void* stream) {
  if (head_dim != D || S < 1 || S > MAX_ROWS || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fused_attention<float>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, S, H, st);
  if (dtype == 1)
    return (int)launch_fused_attention<__nv_bfloat16>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
