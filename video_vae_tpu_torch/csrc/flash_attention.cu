// Plain masked attention forward over separate q, k, v of layout (B, S, H, D).
//
// Replaces: video_vae_tpu/ops/flash_attention.py, _flash_fwd -> _fwd_kernel.
// Per (sequence, head): s = q k^T / sqrt(D) with an f32 accumulator, masked
// keys set to -1e30 (so a fully masked row gets uniform weights), p =
// exp(s - max) / sum in f32 with the exact row max and sum, p rounded to v's
// dtype, o = p v accumulated in f32, one rounding to the output dtype. D in
// {16, 32, 64, 128} (a template parameter of every kernel; another even D up to
// 128 runs the next, zero-padded by the wrapper, with the true D's scale), any
// S >= 1; f32 or bf16. Each tensor is addressed as base + (b * S + i) *
// row_stride + h * D + d, so v may be a view into the fused QKV projection
// (row stride 3 * H * D, as the model's "pallas" path hands it over).
//
// What bounds it on the H100: bytes, on paper. A call reads q, k and v and
// writes o once: 33.6 MB at the model's b2 calls (temporal S = 16 over 512
// sequences, spatial S = 256 over 32), 10 us at 3.35 TB/s. The products take
// 4 * S * S * D FLOPs a (sequence, head): 0.27 GFLOP a temporal b2 call, 4.3
// GFLOP a spatial one, 4.3 us at the 989 TFLOP/s bf16 peak. Rounding P after
// it is normalised needs the row's exact max and sum before the first P.V, so
// wherever a row spans more than one 64-key chunk the scores are computed
// twice: the spatial call really takes 6 * S * S * D, 6.4 GFLOP. At the rate
// mma.sync reaches, the spatial call's products (and its two exp a score) set
// the pace; the temporal call is its staging and its stores.
//
// bf16: a tensor-core kernel (flash_attention_mma.cuh), one launch, no
// workspace, no atomics: the fused forward's design (fused_attention.cu)
// without its LN and RoPE, on the same warp code (fa_mma::attend in
// fused_attention_mma.cuh), with P normalised before its rounding at every S.
// - Products: mma.sync m16n8k16, bf16 operands and f32 accumulators, ldmatrix
//   (and .trans for V) from 144-byte shared-memory rows. Not wgmma: at S = 16
//   a (sequence, head) is one 16-row tile, and a 64-row wgmma tile would waste
//   3/4 of its products. Two adjacent 16 x 8 score accumulators are, as they
//   stand, the A fragment of a 16-key step of P.V: P never leaves registers.
// - Staging: cp.async straight into bf16 rows, 16 bytes a thread, from three
//   base pointers with their own row strides, all of a block's rows in one
//   group. Copies in groups (q with the first 64 keys, each further 64 keys,
//   then v), each waited for inside the first walk where it is first read,
//   measured no faster at S = 256 on the H100 (PERF.md), so there is one. A
//   thread's pieces step down the rows by a fixed stride: no index is divided
//   per copy (dividing by H and S per copy cost a fifth of the S = 16 calls).
// - Geometry (the variant and the sequences a slab block from
//   ops/flash_attention.py:flash_attention_plan, which is the fused forward's
//   plan; warps and shared memory derived here as the fused forward does):
//   * "slab" (S <= 64 and a sequence's rows within 100 KB): a block stages
//     whole sequences, all heads (48 KB a sequence at S = 16), and a warp
//     takes one head's 16-row query tile at a time: one chunk of keys, so the
//     row's max and sum are at hand when P is rounded;
//   * "tile" (otherwise): a block owns one (sequence, head) pair, a warp for
//     each 16 query rows (16 warps, 110 KB at S = 256). Past 64 keys each warp
//     walks the keys twice: a first walk for the exact max and sum, then the
//     scores again, P normalised, rounded and multiplied by V;
//   * "split" (S > 256, #1's core without its LN and RoPE pass): a block
//     takes some query rows of one pair and walks the key tiles twice, k
//     (then k and v) streamed through shared memory: the first walk for the
//     exact max and sum, the second for P.V. At head dims 64 and 128 two
//     launches of a warp-specialised wgmma kernel fed by a TMA ring
//     (attention_split_fwd.cuh: 128 rows a block, 128 or 64 keys a stage; the
//     first parks each row's max and 1/l in its own output row, the second
//     reads them back), at 16 and 32 one mma.sync launch (attention_split.cuh:
//     64 rows, double buffers of 64 keys). Nothing in shared memory grows
//     with S.
// - Epilogue: o leaves through the warp's own q rows in shared memory, 16
//   bytes a lane, whole 128-byte rows of the (B, S, H, D) output.
// Measured on the H100 (PERF.md, utils/kernel_phases.py --kernel 5): the
// temporal call is paced by its staging, the spatial call by its products and
// exps on 16 warps an SM, P.V the largest phase.
// Roundings, as JAX's _fwd_kernel: scores and softmax in f32 (the scale
// applied in the exp2 domain), the exact row max and sum, P normalised and
// then rounded to bf16, P.V accumulated in f32, o rounded to bf16 once. Two
// launches on the same inputs give the same bits.
//
// f32 keeps the first version on the CUDA cores: one thread owns one query row
// (q and the f32 accumulator in registers); k and v of the block's (sequence,
// head) pairs sit in shared memory as f32 and are read as broadcasts; a block
// holds 256 rows (one pair at S = 256, sixteen at S = 16). The keys are walked
// twice, once for the row max and sum, once for the rounded normalised weights
// times v, recomputing the scores (6 * S * S * D FLOPs in all on the f32 pipe).
// It backs the f32 card-vs-CPU phases of the "pallas" path.
//
// D = 128: bf16 as above with at most 8 warps a block (FWD_WARPS<128>, each
// warp of a tile block taking two 16-row query tiles at S = 256); f32 the
// quad kernel of attention_f32_wide.cuh (the thread-a-row kernel would need
// 256 registers and 270 KB of staged k and v); past S = 256 f32 takes the quad
// kernel at every D (the row-a-thread kernel stages a block's sequences whole).

#include "attention_f32_wide.cuh"
#include "attention_split_fwd.cuh"
#include "attention_wide.cuh"
#include "flash_attention_mma.cuh"
#include "flash_common.cuh"

namespace {

constexpr int MAX_ROWS = 256;  // query rows (= threads) per block; a longer sequence takes the quad kernel

template <int D>
__device__ __forceinline__ float dot_row(const float (&q)[D], const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 kk = r4[d4];
    p0 = fmaf(q[4 * d4], kk.x, p0);
    p1 = fmaf(q[4 * d4 + 1], kk.y, p1);
    p2 = fmaf(q[4 * d4 + 2], kk.z, p2);
    p3 = fmaf(q[4 * d4 + 3], kk.w, p3);
  }
  return (p0 + p1) + (p2 + p3);
}

template <typename T, int D>
__global__ void __launch_bounds__(MAX_ROWS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const unsigned char* __restrict__ mask,
                           T* __restrict__ out, long long q_stride, long long k_stride,
                           long long v_stride, int B, int S, int H, int pairs_per_block,
                           float scale) {
  constexpr int ROW = F32_ROW<D>;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  const int rows = pairs_per_block * S;  // row r: local pair r / S, position r % S
  float* v_s = k_s + rows * ROW;
  float* keep = v_s + rows * ROW;  // 1: key kept, 0: key masked
  const long long n_pairs = (long long)B * H;
  const long long pair0 = (long long)blockIdx.x * pairs_per_block;
  const int r = threadIdx.x;

  stage_heads<D>(k_s, k, k_stride, pair0, rows, S, H, n_pairs);
  stage_heads<D>(v_s, v, v_stride, pair0, rows, S, H, n_pairs);
  for (int rr = threadIdx.x; rr < rows; rr += blockDim.x) {
    const long long pair = pair0 + rr / S;
    float kp = 1.f;
    if (mask != nullptr && pair < n_pairs) kp = mask[(pair / H) * S + rr % S] ? 1.f : 0.f;
    keep[rr] = kp;
  }
  __syncthreads();
  if (r >= rows || pair0 + r / S >= n_pairs) return;

  const int g = r / S, i = r % S;
  const long long pair = pair0 + g;
  const long long b = pair / H;
  const int h = (int)(pair % H);
  float qr[D];
  {
    const T* src = q + (b * S + i) * q_stride + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_float(src[d]);
  }
  const float* kb = k_s + g * S * ROW;
  const float* vb = v_s + g * S * ROW;
  const float* kp = keep + g * S;

  // first walk: the row max m and l = sum_j exp(s_j - m)
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < S; ++j) {
    float s = dot_row(qr, kb + j * ROW) * scale;
    if (kp[j] == 0.f) s = NEG_INF;
    const float m_new = fmaxf(m, s);
    l = l * expf(m - m_new) + expf(s - m_new);  // expf(-inf) = 0 on the first key
    m = m_new;
  }
  const float inv_l = 1.f / l;

  // second walk: normalised weights, rounded to v's dtype, times v
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j = 0; j < S; ++j) {
    float s = dot_row(qr, kb + j * ROW) * scale;
    if (kp[j] == 0.f) s = NEG_INF;
    const float p = to_float(from_float<T>(expf(s - m) * inv_l));
    const float4* vr = reinterpret_cast<const float4*>(vb + j * ROW);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 vv = vr[d4];
      acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
      acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
      acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
      acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
    }
  }
  T* o = out + ((b * S + i) * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = from_float<T>(acc[d]);
}

// At D = 128, and past S = MAX_ROWS at every D, the quad kernel of
// attention_f32_wide.cuh (f32 only).
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   long long q_stride, long long k_stride, long long v_stride, int B, int S, int H, float scale,
                   cudaStream_t stream) {
  static_assert(sizeof(T) == 4, "the CUDA-core attention takes f32");
  if (D == 128 || S > MAX_ROWS) {
    const long long HD = (long long)H * D;
    auto rows = [&](const void* p, long long stride) {
      return fa_wide::Rows{static_cast<const float*>(p), S * stride, D, stride};
    };
    return fa_wide::launch_fwd<D>(false, rows(q, q_stride), rows(k, k_stride), rows(v, v_stride),
                                  static_cast<const unsigned char*>(mask),
                                  fa_wide::OutRows{static_cast<float*>(out), S * HD, D, HD}, B, S, H, nullptr,
                                  nullptr, nullptr, nullptr, scale, 0.f, stream);
  }
  if constexpr (D < 128) {
  const int pairs_per_block = MAX_ROWS / S;
  const int rows = pairs_per_block * S;
  const int threads = (rows + 31) / 32 * 32;
  const size_t smem = (2 * (size_t)rows * F32_ROW<D> + rows) * sizeof(float);
  auto kernel = flash_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_pairs = (long long)B * H;
  const unsigned blocks = (unsigned)((n_pairs + pairs_per_block - 1) / pairs_per_block);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), q_stride, k_stride, v_stride,
      B, S, H, pairs_per_block, scale);
  return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // D = 128 took the quad kernel above
  }
}

// A head dim past 128 (attention_wide.cuh): q, k and v row (b, i) at base + (b S + i) stride,
// head h at + h Dp; out contiguous (B, S, H, Dp); P normalised before its rounding.
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* mask, void* out, long long q_stride,
                        long long k_stride, long long v_stride, int B, int S, int H, int Dp,
                        const fa_mma::HeadScale& hs, cudaStream_t stream) {
  using fa_mma::wide::Arr;
  auto in = [&](const void* p, long long stride) { return Arr<const T>{static_cast<const T*>(p), S * stride, Dp, stride}; };
  const long long HD = (long long)H * Dp;
  const fa_mma::wide::FwdArgs<T> a{in(q, q_stride), in(k, k_stride), in(v, v_stride),
                                   static_cast<const unsigned char*>(mask), Arr<T>{static_cast<T*>(out), S * HD, Dp, HD},
                                   B, S, H, Dp, hs};
  return fa_mma::wide::launch_fwd<T>(a, true, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out). mask: (B, S) uint8 key mask, or null.
// *_stride: elements between rows (b, i) and (b, i + 1) of that tensor; out is contiguous.
// variant, unit: the bf16 kernel's plan (slab 0, tile 1 or split 2; sequences
// a slab block, 1 otherwise); the f32 kernel takes its geometry from the shape.
// head_dim: 16, 32, 64 or 128; true_dim d and scale: the call's head dim (q, k and
// v zero-padded past it to head_dim) and its softmax scale 1/sqrt(d) in f32.
// variant 4 ("wide", both dtypes): head_dim a multiple of 128 past 128, unit 1.
extern "C" int vvt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, long long q_stride,
                                       long long k_stride, long long v_stride, int B, int S, int H,
                                       int head_dim, int true_dim, float scale, int dtype, int variant, int unit,
                                       void* stream) {
  if (S < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1) || !fa_mma::takes_head(true_dim, head_dim, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using fa_mma::bf16;
  const fa_mma::HeadScale hs = fa_mma::head_scale(true_dim, scale);
  const fa_mma::flash_fwd::Args a{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(mask), static_cast<bf16*>(out), q_stride, k_stride, v_stride,
      B, S, H, unit, hs};
  if (variant == fa_mma::WIDE) {
    if (unit != 1) return (int)cudaErrorInvalidValue;
    return (int)(dtype == 0 ? launch_wide<float>(q, k, v, mask, out, q_stride, k_stride, v_stride, B, S, H, head_dim,
                                                 hs, st)
                            : launch_wide<bf16>(q, k, v, mask, out, q_stride, k_stride, v_stride, B, S, H, head_dim,
                                                hs, st));
  }
  return (int)fa_mma::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0) return launch<float, D>(q, k, v, mask, out, q_stride, k_stride, v_stride, B, S, H, hs.scale, st);
    if (variant == fa_mma::SPLIT) {  // P normalised before its rounding, as at every S
      if (unit != 1) return cudaErrorInvalidValue;
      const fa_mma::split::FwdArgs sa{{a.q, q_stride}, {a.k, k_stride}, {a.v, v_stride}, a.mask, a.out, B, S, H,
                                      hs};
      return fa_mma::launch_split_fwd<D>(sa, true, st);
    }
    return fa_mma::flash_fwd::launch_flash_mma<D>(a, variant, st);
  });
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
