// Device code of the bf16 fused QK-norm + RoPE + attention forward on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 accumulators). The design note is
// in fused_attention.cu. launch_attention_mma() enqueues the kernel on a stream
// and returns the launch's cudaError_t. The helpers it shares with the backward
// are in fused_attention_mma_common.cuh.
//
// Shared-memory layout. Every q, k and v head row (D bf16) sits in a D + 8-element
// row (144 bytes at D = 64, fused_attention_mma_common.cuh). Rows are staged in
// 16-row units; a row past the sequence is zero-filled, so a padding key's v row
// adds exactly 0 to P.V.
//   slab (S <= 64): per sequence of the block, q | k | v, each [head][row], then
//                   the key bits of every sequence;
//   tile (S > 64):  k [row] | v [row] | q [row] of one (sequence, head) pair, then
//                   the pair's key bits.
// Key bits: bit j % 64 of word j / 64 is 1 where key j is kept.

#pragma once

#include "fused_attention_mma_common.cuh"

namespace fa_mma {

constexpr int MAX_WARPS = 16;
constexpr int SLAB_WARPS = 8;  // warps of a slab block at most
constexpr int SLAB_MAX_SEQ = 64;
// Warps of a block at most: 16 (128 registers a thread), but 8 at D = 128, where
// a warp's 16 x 128 f32 output and its q fragments alone take 96 registers a
// lane; a tile block's warps then take two 16-row query tiles each at S = 256.
template <int D> constexpr int FWD_WARPS = D == 128 ? 8 : MAX_WARPS;

// Shared memory of one block (unit: sequences of a slab block).
template <int D>
__host__ __forceinline__ size_t smem_bytes(int variant, int S, int H, int unit) {
  const size_t words = 8 * (size_t)key_words(S);
  if (variant == SLAB) return (size_t)unit * (3 * (size_t)H * rows16(S) * ROW_BYTES<D> + words);
  return 3 * (size_t)rows16(S) * ROW_BYTES<D> + words;
}

// The masked scores q.k of one 16-row query tile against one chunk of keys: a
// masked key NEG_INF, a padding key (j >= S) -inf, so that it adds exactly 0
// whatever the row holds. The softmax scale is applied in the exponent.
template <int D, int KT>
__device__ __forceinline__ void chunk_scores(float (&s)[2 * KT][4], const uint32_t (&qf)[D / 16][4],
                                             const bf16* k_s, int c0, int steps, int S,
                                             unsigned long long keep) {
  const int lane = threadIdx.x & 31;
  // A chunk starts on a word of key bits (64 keys, or the only chunk). Every key
  // of it inside the sequence and kept: nothing to mask.
  constexpr unsigned long long CHUNK_BITS = KT == 4 ? ~0ull : (1ull << 16 * KT) - 1;
  const bool whole = c0 + 16 * KT <= S && (keep & CHUNK_BITS) == CHUNK_BITS;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (nt / 2 < steps) dot_rows8<D>(s[nt], qf, k_s + (c0 + 8 * nt) * ROW<D>);
    if (!whole) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = c0 + 8 * nt + 2 * (lane & 3) + (e & 1);
        const bool kept = (keep >> (j & 63)) & 1ull;
        s[nt][e] = j >= S ? -INFINITY : kept ? s[nt][e] : NEG_INF;
      }
    }
  }
}

// One warp: softmax(q k^T / sqrt(D) + key mask) v for 16 query rows (q_rows, in
// shared memory, row0 their first position) against the S keys of k_s and v_s,
// rounded to bf16 into out (row i at out + i * H * D). The output passes through
// q_rows, which the warp owns and no longer needs once its fragments are loaded.
// C: the softmax scale in the exp2 domain (HeadScale::c).
template <int D, int KT>
__device__ __forceinline__ void attend(bf16* q_rows, const bf16* k_s, const bf16* v_s,
                                       const unsigned long long* keep, int S, bool normalize,
                                       bf16* __restrict__ out, int row0, int H, float C) {
  constexpr int CH = 16 * KT;  // keys per chunk
  constexpr int ROW = fa_mma::ROW<D>;
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(qf[ks], q_rows + (lane & 15) * ROW + 16 * ks + 8 * (lane >> 4));

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int chunks = (S + CH - 1) / CH;
  // Normalise-then-round needs the row's max and sum before its first P.V: with
  // one chunk they come from that chunk; with more, from a first pass of scores.
  const bool two_pass = normalize && chunks > 1;
  float s[2 * KT][4];
  if (two_pass) {
    for (int c = 0; c < chunks; ++c) {
      const int c0 = c * CH;
      chunk_scores<D, KT>(s, qf, k_s, c0, min(KT, (S - c0 + 15) / 16), S, keep[c0 >> 6]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt)
          sum += exp2f((s[nt][2 * r] - m_new) * C) + exp2f((s[nt][2 * r + 1] - m_new) * C);
        l[r] = l[r] * exp2f((m[r] - m_new) * C) + sum;
        m[r] = m_new;
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }

  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * CH;
    const int steps = min(KT, (S - c0 + 15) / 16);
    chunk_scores<D, KT>(s, qf, k_s, c0, steps, S, keep[c0 >> 6]);
    if (!two_pass) {  // online max: rescale what the earlier chunks summed
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float corr = exp2f((m[r] - m_new) * C);  // 0 on the first chunk
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          o[dn][2 * r] *= corr;
          o[dn][2 * r + 1] *= corr;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f((s[nt][e] - m[e >> 1]) * C);
        if (!two_pass) l[e >> 1] += s[nt][e];
      }
    if (normalize) {  // the packed rule: P normalised before it is rounded
      const float inv0 = 1.f / (two_pass ? l[0] : quad_sum(l[0]));
      const float inv1 = 1.f / (two_pass ? l[1] : quad_sum(l[1]));
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        s[nt][0] *= inv0, s[nt][1] *= inv0;
        s[nt][2] *= inv1, s[nt][3] *= inv1;
      }
    }
    // P (rounded to bf16) . V: score tiles 2kk and 2kk + 1 are the A fragment of
    // 16-key step kk as they stand; V^T's fragments come through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk < steps) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const bf16* vrow = v_s + (c0 + 16 * kk + (lane & 15)) * ROW + 8 * (lane >> 4);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vrow + 16 * dp);
          mma(o[2 * dp], a, vb[0], vb[1]);
          mma(o[2 * dp + 1], a, vb[2], vb[3]);
        }
      }
    }
  }

  float inv[2] = {1.f, 1.f};
  if (!normalize) {  // P was rounded unnormalised: 1/l on the f32 output
    inv[0] = 1.f / quad_sum(l[0]);
    inv[1] = 1.f / quad_sum(l[1]);
  }
  __syncwarp();
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    *reinterpret_cast<uint32_t*>(q_rows + g * ROW + 8 * dn + 2 * t) = pack_bf16(o[dn][0] * inv[0], o[dn][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(q_rows + (g + 8) * ROW + 8 * dn + 2 * t) =
        pack_bf16(o[dn][2] * inv[1], o[dn][3] * inv[1]);
  }
  __syncwarp();
  const size_t stride = (size_t)H * D;
  constexpr int P = PIECES<D>, RPI = 32 / P;  // 16-byte pieces of a row; rows at a time
#pragma unroll
  for (int it = 0; it < 16 / RPI; ++it) {  // 16 rows x 2D bytes, 16 bytes a lane
    const int r = RPI * it + lane / P, piece = lane % P;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(out + (row0 + r) * stride + 8 * piece) =
          *reinterpret_cast<const uint4*>(q_rows + r * ROW + 8 * piece);
  }
}

// grid: slab, one block per `unit` sequences; tile, one block per (sequence,
// head) pair, a warp for each 16 of its query rows (up to FWD_WARPS<D>, each
// then taking the tiles in turn). tests/test_torch_attention_plan.py
// walks the same items on the CPU.
template <int D, int KT>
__global__ void __launch_bounds__(FWD_WARPS<D> * 32)
attention_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ q_scale,
                     const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                     const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                     bf16* __restrict__ out, int B, int S, int H, int variant, int unit, bool normalize,
                     const HeadScale hs) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int s16 = rows16(S), words = key_words(S);
  constexpr int ROW = fa_mma::ROW<D>, P = PIECES<D>, LANES = LN_LANES<D>;
  const size_t token = 3 * (size_t)H * D;  // elements of one qkv row
  const size_t part_stride = (size_t)H * D;

  if (variant == SLAB) {
    const long long seq0 = (long long)blockIdx.x * unit;
    const size_t head_rows = (size_t)s16 * ROW, seq_elems = 3 * (size_t)H * head_rows;
    auto row_of = [&](int sl, int part, int h, int i) {  // [sequence][part][head][row]
      return smem + sl * seq_elems + (part * H + h) * head_rows + (size_t)i * ROW;
    };
    unsigned long long* keep = reinterpret_cast<unsigned long long*>(smem + unit * seq_elems);
    // Group 0, q and k; group 1, v (P.V alone reads it). Thread p copies the
    // same 16-byte piece of every token, so the warps read each token's row in order.
    for (int group = 0; group < 2; ++group) {
      const int first = group ? 2 * H : 0, rows = group ? H : 2 * H;  // head rows of a token
      for (int p = threadIdx.x; p < P * rows; p += blockDim.x) {
        const int piece = p % P, part = (first + p / P) / H, h = (first + p / P) % H;
        for (int sl = 0; sl < unit; ++sl)
          for (int i = 0; i < s16; ++i) {
            const long long b = seq0 + sl;
            const bool inside = b < B && i < S;
            const bf16* src = inside ? qkv + ((size_t)b * S + i) * token + part * part_stride + h * D + 8 * piece : qkv;
            cp_async16(row_of(sl, part, h, i) + 8 * piece, src, inside ? 16 : 0);
          }
      }
      cp_async_commit();
    }
    for (int sl = 0; sl < unit; ++sl)
      stage_key_bits(keep + sl * words, mask, seq0 + sl < B ? seq0 + sl : 0, S, warp, warps);
    cp_async_wait<1>();
    __syncthreads();
    // LN + RoPE of the q and k rows of each (sequence, position, head), four
    // lanes each, heads fastest: a warp's eight tasks read the same cos/sin rows
    float qsc[16], ksc[16];
    load_lane_scale<D>(qsc, q_scale);
    load_lane_scale<D>(ksc, k_scale);
    const int tasks = unit * S * H, per_warp = 32 / LANES;
    for (int base = per_warp * warp; base < tasks; base += per_warp * warps) {
      const int t = min(base + lane / LANES, tasks - 1);
      const int h = t % H, i = (t / H) % S, sl = t / (H * S);
      const bool live = base + lane / LANES < tasks && seq0 + sl < B;
      norm_rope_pair<D>(row_of(sl, 0, h, i), live, qsc, row_of(sl, 1, h, i), live, ksc, cos_t + (size_t)i * D,
                        sin_t + (size_t)i * D, hs.inv_d);
    }
    cp_async_wait<0>();
    __syncthreads();
    const int tiles = s16 / 16, items = unit * H * tiles;
    for (int it = warp; it < items; it += warps) {
      const int mt = it % tiles, h = (it / tiles) % H, sl = it / (tiles * H);
      const long long b = seq0 + sl;
      if (b >= B) continue;
      attend<D, KT>(row_of(sl, 0, h, 16 * mt), row_of(sl, 1, h, 0), row_of(sl, 2, h, 0), keep + sl * words, S,
                    normalize, out + (size_t)b * S * part_stride + h * D, 16 * mt, H, hs.c);
    }
    return;
  }

  // tile: one (sequence, head) pair
  const long long b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  bf16* k_s = smem;
  bf16* v_s = k_s + (size_t)s16 * ROW;
  bf16* q_s = v_s + (size_t)s16 * ROW;
  unsigned long long* keep = reinterpret_cast<unsigned long long*>(q_s + (size_t)s16 * ROW);
  const bf16* base = qkv + (size_t)b * S * token + h * D;
  const int piece = threadIdx.x % P, row_step = blockDim.x / P;
  // group 0: the k rows, then the q rows; group 1: the v rows (P.V alone reads them)
  for (int r = threadIdx.x / P; r < 2 * s16; r += row_step) {
    const bool is_k = r < s16;
    const int i = is_k ? r : r - s16;
    const bool inside = i < S;
    cp_async16((is_k ? k_s : q_s) + (size_t)i * ROW + 8 * piece,
               inside ? base + (size_t)i * token + (is_k ? part_stride : 0) + 8 * piece : qkv, inside ? 16 : 0);
  }
  cp_async_commit();
  for (int r = threadIdx.x / P; r < s16; r += row_step) {
    const bool inside = r < S;
    cp_async16(v_s + (size_t)r * ROW + 8 * piece, inside ? base + (size_t)r * token + 2 * part_stride + 8 * piece : qkv,
               inside ? 16 : 0);
  }
  cp_async_commit();
  stage_key_bits(keep, mask, b, S, warp, warps);
  cp_async_wait<1>();
  __syncthreads();
  // LN + RoPE of k row i and q row i, D / 16 lanes each
  float qsc[16], ksc[16];
  load_lane_scale<D>(qsc, q_scale);
  load_lane_scale<D>(ksc, k_scale);
  const int per_warp = 32 / LANES;
  for (int first = per_warp * warp; first < S; first += per_warp * warps) {
    const int i = first + lane / LANES;
    const bool live = i < S;
    const int at = live ? i : 0;
    norm_rope_pair<D>(k_s + (size_t)at * ROW, live, ksc, q_s + (size_t)at * ROW, live, qsc, cos_t + (size_t)at * D,
                      sin_t + (size_t)at * D, hs.inv_d);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int mt = warp; 16 * mt < S; mt += warps)
    attend<D, KT>(q_s + (size_t)16 * mt * ROW, k_s, v_s, keep, S, normalize, out + (size_t)b * S * part_stride + h * D,
                  16 * mt, H, hs.c);
}

template <int D, int KT>
cudaError_t launch_kt(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                      const void* sin_t, const void* mask, void* out, int B, int S, int H, int variant,
                      int unit, int warps, bool normalize, int smem, unsigned blocks, const HeadScale& hs,
                      cudaStream_t stream) {
  auto kernel = attention_mma_kernel<D, KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const unsigned char*>(mask), static_cast<bf16*>(out), B, S, H, variant, unit, normalize, hs);
  return cudaGetLastError();
}

// Checks the plan (ops/flash_attention.py:fused_attention_plan: the variant, and
// the sequences a slab block) against the shape, derives the rest and launches.
template <int D>
cudaError_t launch_attention_mma(const void* qkv, const void* q_scale, const void* k_scale,
                                        const void* cos_t, const void* sin_t, const void* mask, void* out,
                                        int B, int S, int H, int variant, int unit, const HeadScale& hs,
                                        cudaStream_t stream) {
  const long long tiles = rows16(S) / 16;  // 16-row query tiles of one head
  long long blocks, warps;
  if (variant == SLAB) {
    if (S > SLAB_MAX_SEQ || unit < 1) return cudaErrorInvalidValue;
    blocks = ((long long)B + unit - 1) / unit;
    warps = std::min<long long>(SLAB_WARPS, (long long)unit * H * tiles);
  } else if (variant == TILE) {
    if (unit != 1 || S > TILE_MAX_SEQ) return cudaErrorInvalidValue;
    blocks = (long long)B * H;
    warps = std::min<long long>(tiles, FWD_WARPS<D>);  // tiles <= 16, as S <= 256
  } else {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<D>(variant, S, H, unit);
  if (blocks > 0x7fffffffLL || smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  // P normalised before its rounding where the JAX package takes its packed
  // path (flash_attention.py:_packed_and_bb), else rounded unnormalised
  const bool normalize = S < 128 && (long long)S * H % 128 == 0;
  switch (chunk_steps(S)) {
    case 1:
      return launch_kt<D, 1>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, S, H, variant, unit, (int)warps,
                          normalize, (int)smem, (unsigned)blocks, hs, stream);
    case 2:
      return launch_kt<D, 2>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, S, H, variant, unit, (int)warps,
                          normalize, (int)smem, (unsigned)blocks, hs, stream);
    default:
      return launch_kt<D, 4>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, S, H, variant, unit, (int)warps,
                          normalize, (int)smem, (unsigned)blocks, hs, stream);
  }
}

}  // namespace fa_mma
