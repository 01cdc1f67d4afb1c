// The "split" variant of the bf16 attention kernels, for sequences longer than
// the tile variant's 256 tokens: the forward of #1 (fused_attention.cu, and the
// attention of #7, attention_sublayer.cu) and of #5 (flash_attention.cu), and
// the backward of #3 (fused_attention_bwd.cu) and of #6
// (flash_attention_bwd.cu). The slab and tile variants stage whole sequences
// in shared memory, as the TPU kernels hold them in VMEM; past 256 keys a
// pair's rows outgrow a block (and its warps its 16-row tiles). In the split
// variant nothing that grows with S stays in shared memory: a block owns some
// rows of one (sequence, head) pair and streams the other side's rows.
//
// This header holds what every head dim shares, #1's and #3's LN + RoPE pass
// (qk_norm_rope_kernel), and the mma.sync launches (m16n8k16, bf16 operands,
// f32 accumulators, ldmatrix from D + 8-element shared-memory rows,
// fused_attention_mma_common.cuh) that serve head dims 16 and 32: their 32-
// and 64-byte rows are below the 128-byte swizzle span of the wgmma launches
// that serve 64 and 128, the forward in attention_split_fwd.cuh (which also
// routes by head dim: launch_split_fwd, launch_split_fused_fwd) and the
// backward in attention_split_bwd.cuh (launch_split_bwd). A block here owns
// ROWS = 64 rows and streams the other side through two buffers of TILE_ROWS
// rows, cp.async filling one while the warps work on the other.
//
// What bounds them on the H100: the products. A forward is 4 S^2 D a pair (#5
// walks the keys twice: 6), a backward 10 S^2 D on paper; the backward here
// recomputes the scores on each side (9 products of S^2 D a pair, as the fused
// backward's tile variant) so that no gradient is summed by atomics.
//
// Forward (split_fwd_kernel): a block takes ROWS = 64 query rows of one pair,
// a warp each 16, whose q fragments stay in registers; it walks the keys in
// tiles of 64, k and v double-buffered. The grid is (pairs x query tiles), the
// query tiles of a pair adjacent, so that they read its k and v from L2.
// Roundings as the tile variant's (fa_mma::attend): scores and softmax in f32,
// P rounded to bf16 before P.V, o rounded once. #1 at S > 256 is on JAX's
// unpacked path (S >= 128): one walk with a running max, P = exp(s - m)
// rounded unnormalised, 1/l on the f32 output. #5 rounds P after normalising
// it: a first walk over the key tiles (k only) gives the exact row max and
// sum, a second (k and v) takes P.V.
//
// #1's q~ and k~: a short pass first (qk_norm_rope_kernel) writes LN + scale +
// RoPE of every k (and, at head dims 16 and 32, q) head row, rounded to bf16
// as the tile variant rounds them (norm_rope_pair, the same code), to a (B, S,
// H, D) workspace; the forward then reads them as #5 reads q and k, and v
// straight from the fused qkv. Normalising each key tile as it is staged would
// redo the LN of every key once for each of a pair's query tiles (16 times at
// S = 1024); the pass does it once and lets #1 and #5 share one core. The
// wgmma forward (head dims 64 and 128) normalises its own q rows, which it
// stages once. #3 runs the pass for q~ and k~.
//
// Backward at head dims 16 and 32 (FlashAttention-2's, in its simple form,
// two launches and no atomics, so two runs give the same bits):
// 1. split_bwd_query_kernel, query-major: a block takes 64 query rows (q and
//    dO fragments in registers, read straight from device memory) and walks
//    the key tiles twice, k and v double-buffered: the first walk gives each
//    row's max m, sum l and row = sum_j P dP online (scores and dP in chunks
//    of 32 keys, bwd::TILE_KT), the second recomputes them for P, dS and
//    dq = dS k. It writes dq and (m, 1/l, row) to an f32 workspace.
// 2. split_bwd_key_kernel, key-major: a block takes 64 key rows (k and v
//    staged once) and walks the query tiles, q, dO and their statistics
//    double-buffered: k q^T and v dO^T give P^T and dS^T, then dv += P^T dO
//    and dk += dS^T q. dq is summed by its own query-major pass rather than
//    by atomics from the key side, so its summation order is fixed.
// Roundings as the tile variant's: P normalised (exact max and sum, f32) and
// then rounded to bf16 for dv; dS in f32, rounded to bf16 for dq and dk;
// everything else f32; each gradient rounded once. #3 writes dq~ and dk~ in
// f32 for its LN + RoPE backward pass (fused_attention_bwd.cu), which also
// writes the scale gradients' per-block partials, as its f32 path does.
//
// Masks: a masked key scores -1e30 (NEG_INF), a key past S -inf, as in the
// tile variant, so a row whose keys are all masked averages all S keys, and a
// key tile whose keys are all masked leaves the running max finite (m moves
// from -inf to -1e30, where exp2 gives 1, never NaN).
//
// Shared memory of a block (ROW_BYTES<D> = 2 (D + 8) a row; 48 bytes at D = 16;
// T = TILE_ROWS):
//   forward:    q [ROWS] | k [2][T] | v [2][T]                       15 KB at D = 16, 25 KB at 32
//   query side: k [2][T] | v [2][T]                                  12 KB, 20 KB
//   key side:   k [ROWS] | v [ROWS] | q [2][T] | dO [2][T],
//               then (m, 1/l, row) [2][3][T] f32                     20 KB, 32 KB
// so at least two blocks share an SM (__launch_bounds__(128, 2)); the sizes
// hold at every head dim the launches are instantiated for.
// tests/helpers/split_geometry.py mirrors these sizes.

#pragma once

#include "fused_attention_mma_common.cuh"

namespace fa_mma {
namespace split {

constexpr int ROWS = 64;                // a block's own rows: queries (keys on the backward's key side)
constexpr int WARPS = ROWS / 16;        // a warp each 16 of them
constexpr int TILE_ROWS = 64;           // rows of the other side staged a step
constexpr int FWD_KT = TILE_ROWS / 16;  // the forward takes a key tile as one chunk of 16-key steps
constexpr int BWD_KT = bwd::TILE_KT;    // the backward's query side: chunks of 32 keys
constexpr int MIN_BLOCKS = 2;           // blocks an SM at least
constexpr int PREP_ROWS = 64;           // head rows a block of the LN + RoPE pass takes
static_assert(ROWS == TILE_ROWS, "a block's own rows are staged as one tile");

// One (B, S, H, D) bf16 input: row i of pair (b, h) at base + (b S + i) stride + h D.
struct In {
  const bf16* base;
  long long stride;
};

// One output: row i of pair (b, h) at base + b b_stride + h h_stride + i i_stride.
template <typename T>
struct Out {
  T* base;
  long long b_stride, h_stride, i_stride;
};

template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() { return (size_t)(ROWS + 4 * TILE_ROWS) * ROW_BYTES<D>; }
template <int D>
__host__ __device__ constexpr size_t query_smem_bytes() { return (size_t)4 * TILE_ROWS * ROW_BYTES<D>; }
template <int D>
__host__ __device__ constexpr size_t key_smem_bytes() {
  return (size_t)(2 * ROWS + 4 * TILE_ROWS) * ROW_BYTES<D> + 2 * 3 * TILE_ROWS * sizeof(float);
}

__host__ __device__ __forceinline__ int tiles_of(int S) { return (S + TILE_ROWS - 1) / TILE_ROWS; }

// cp.async rows i0 .. i0 + TILE_ROWS - 1 of one pair's array (row i at src + i *
// stride) to dst (row r at dst + r * ROW), 16 bytes a thread, a row's pieces
// on consecutive threads; a row at or past S is zero-filled. The caller commits.
template <int D>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, long long stride, int i0, int S) {
  constexpr int P = PIECES<D>;
  for (int e = threadIdx.x; e < TILE_ROWS * P; e += blockDim.x) {
    const int r = e / P, piece = e % P, i = i0 + r;
    const bool inside = i < S;
    cp_async16(dst + r * ROW<D> + 8 * piece, inside ? src + i * stride + 8 * piece : src, inside ? 16 : 0);
  }
}

// The key bits of keys j0 .. j0 + 63 of sequence b (bit j - j0 set where key j
// is kept and j < S), on every lane: every lane of the warp calls it.
__device__ __forceinline__ unsigned long long key_word(const unsigned char* __restrict__ mask, long long b, int S,
                                                       int j0) {
  const int lane = threadIdx.x & 31, ja = j0 + lane, jb = ja + 32;
  const bool ka = ja < S && (mask == nullptr || mask[b * S + ja]);
  const bool kb = jb < S && (mask == nullptr || mask[b * S + jb]);
  return (unsigned long long)__ballot_sync(0xffffffffu, ka) |
         ((unsigned long long)__ballot_sync(0xffffffffu, kb) << 32);
}

// Mask one chunk of scores, keys jc .. jc + 16 KT (bits: their key bits from
// bit 0): a masked key NEG_INF, a key past S -inf, so that it adds exactly 0.
template <int KT>
__device__ __forceinline__ void mask_chunk(float (&s)[2 * KT][4], int jc, int S, unsigned long long bits) {
  const int lane = threadIdx.x & 31;
  constexpr unsigned long long CHUNK_BITS = KT == 4 ? ~0ull : (1ull << 16 * KT) - 1;
  if (jc + 16 * KT <= S && (bits & CHUNK_BITS) == CHUNK_BITS) return;  // nothing to mask
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jl = 8 * nt + 2 * (lane & 3) + (e & 1);
      s[nt][e] = jc + jl >= S ? -INFINITY : ((bits >> jl) & 1ull) ? s[nt][e] : NEG_INF;
    }
}

// 16 rows of f32 accumulators at dst (row i at dst + i * stride), rounded to T,
// for the rows row0 + .. below S: lane (g, t) stores columns 8 nt + 2 t, + 1
// of rows g and g + 8.
template <int D, typename T>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4], T* __restrict__ dst, long long stride,
                                          int row0, int S) {
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    if (i < S) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        T* at = dst + i * stride + 8 * nt + 2 * t;
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
        else
          *reinterpret_cast<float2*>(at) = make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
      }
    }
  }
}

// ---- #1's and #3's first pass: q~ and k~ ----------------------------------

// LN (no bias; f32 statistics, E[x^2] - mean^2 clamped at 0) times the (D,)
// scale, then rotate-half RoPE, of the q and k head rows of qkv (B, S, 3 H D),
// rounded to bf16 into qn and kn, each (B, S, H, D): norm_rope_pair, as the
// tile variant runs it in shared memory; qn null: k alone (the wgmma forward
// normalises its own q rows). A block takes PREP_ROWS consecutive head rows r
// (position r / H, head r % H) of `rows` = B S H. inv_d: 1/d of the true head dim.
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
qk_norm_rope_kernel(const bf16* __restrict__ qkv, const float* __restrict__ q_scale,
                    const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, bf16* __restrict__ qn, bf16* __restrict__ kn, long long rows,
                    int S, int H, float inv_d) {
  extern __shared__ float4 smem4[];
  bf16* rows_s = reinterpret_cast<bf16*>(smem4);  // [q, k][PREP_ROWS][ROW]
  constexpr int ROW = fa_mma::ROW<D>, P = PIECES<D>, LANES = LN_LANES<D>;
  const long long r0 = (long long)blockIdx.x * PREP_ROWS;
  const long long HD = (long long)H * D;
  for (int e = threadIdx.x; e < 2 * PREP_ROWS * P; e += blockDim.x) {
    const int piece = e % P, rr = (e / P) % PREP_ROWS, part = e / (P * PREP_ROWS);
    const long long r = r0 + rr;
    const bool inside = r < rows && (part == 1 || qn != nullptr);
    const bf16* src = inside ? qkv + (r / H) * 3 * HD + part * HD + (r % H) * D + 8 * piece : qkv;
    cp_async16(rows_s + (part * PREP_ROWS + rr) * ROW + 8 * piece, src, inside ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float qsc[16], ksc[16];
  load_lane_scale<D>(qsc, q_scale);
  load_lane_scale<D>(ksc, k_scale);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5, per_warp = 32 / LANES;
  for (int first = per_warp * warp; first < PREP_ROWS; first += per_warp * warps) {
    const int rr = first + lane / LANES;
    const long long r = r0 + rr;
    const bool live = r < rows;
    const int i = live ? (int)((r / H) % S) : 0;
    norm_rope_pair<D>(rows_s + rr * ROW, live && qn != nullptr, qsc, rows_s + (PREP_ROWS + rr) * ROW, live, ksc,
                      cos_t + (size_t)i * D, sin_t + (size_t)i * D, inv_d);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * PREP_ROWS * P; e += blockDim.x) {
    const int piece = e % P, rr = (e / P) % PREP_ROWS, part = e / (P * PREP_ROWS);
    const long long r = r0 + rr;
    if (r < rows && (part == 1 || qn != nullptr))
      *reinterpret_cast<uint4*>((part ? kn : qn) + r * D + 8 * piece) =
          *reinterpret_cast<const uint4*>(rows_s + (part * PREP_ROWS + rr) * ROW + 8 * piece);
  }
}

template <int D>
cudaError_t launch_norm_rope(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                             const void* sin_t, bf16* qn, bf16* kn, int B, int S, int H, float inv_d,
                             cudaStream_t stream) {
  const long long rows = (long long)B * S * H, blocks = (rows + PREP_ROWS - 1) / PREP_ROWS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)PREP_ROWS * ROW_BYTES<D>;  // 34 KB at D = 128: no opt-in needed
  qk_norm_rope_kernel<D><<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), qn, kn, rows, S, H, inv_d);
  return cudaGetLastError();
}

// ---- the forward core: #1 and #5 -------------------------------------------

struct FwdArgs {
  In q, k, v;
  const unsigned char* mask;  // (B, S) or null
  bf16* out;                  // (B, S, H, D), contiguous
  int B, S, H;
  HeadScale hs;  // the true head dim's 1/d and softmax scale
};

// The scores of 16 query rows (fragments qf) against the 16 KT keys of a
// staged chunk (k_rows, its first key jc; steps of them inside S), masked.
template <int D, int KT>
__device__ __forceinline__ void tile_scores(float (&s)[2 * KT][4], const uint32_t (&qf)[D / 16][4],
                                            const bf16* k_rows, int jc, int steps, int S, unsigned long long bits) {
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (nt / 2 < steps) dot_rows8<D>(s[nt], qf, k_rows + 8 * nt * ROW<D>);
  }
  mask_chunk<KT>(s, jc, S, bits);
}

// grid: one block per (pair, tile of ROWS query rows), a pair's tiles adjacent.
// Step n of the walks stages key tile n % tiles (v too on the last walk) into
// buffer n & 1 while the warps take step n - 1's. tests/test_torch_attention_plan.py
// and tests/test_torch_flash_plan.py walk the same items on the CPU.
template <int D, bool NORMALIZE>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) split_fwd_kernel(const FwdArgs a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  constexpr int ROW = fa_mma::ROW<D>, KT = FWD_KT;
  const float C = a.hs.c;  // the softmax scale in the exp2 domain
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int S = a.S, H = a.H, qtiles = (S + ROWS - 1) / ROWS, tiles = tiles_of(S);
  const long long pair = blockIdx.x / qtiles, b = pair / H;
  const int h = (int)(pair % H), row0 = (int)(blockIdx.x % qtiles) * ROWS + 16 * warp;
  bf16* q_s = smem;                       // the block's query rows; each warp's output leaves through its own
  bf16* k_s = q_s + ROWS * ROW;           // [2][TILE_ROWS][ROW]
  bf16* v_s = k_s + 2 * TILE_ROWS * ROW;  // [2][TILE_ROWS][ROW]
  const bf16* qp = a.q.base + b * S * a.q.stride + h * D;
  const bf16* kp = a.k.base + b * S * a.k.stride + h * D;
  const bf16* vp = a.v.base + b * S * a.v.stride + h * D;
  constexpr int WALKS = NORMALIZE ? 2 : 1;
  const int steps_all = WALKS * tiles;
  auto issue = [&](int n) {
    const int buf = n & 1, j0 = (n % tiles) * TILE_ROWS;
    copy_tile<D>(k_s + buf * TILE_ROWS * ROW, kp, a.k.stride, j0, S);
    if (n / tiles == WALKS - 1) copy_tile<D>(v_s + buf * TILE_ROWS * ROW, vp, a.v.stride, j0, S);
    cp_async_commit();
  };
  copy_tile<D>(q_s, qp, a.q.stride, row0 - 16 * warp, S);  // in step 0's group
  issue(0);
  const bool live = row0 < S;  // the warp has query rows (uniform per warp)
  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, il[2] = {1.f, 1.f};
  for (int n = 0; n < steps_all; ++n) {
    if (n + 1 < steps_all) {
      issue(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (n == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        ldsm_x4(qf[ks], q_s + (16 * warp + (lane & 15)) * ROW + 16 * ks + 8 * (lane >> 4));
    }
    if (live) {
      const bool stats_walk = NORMALIZE && n < tiles;
      if (NORMALIZE && n == tiles) {  // the exact row sums of the first walk
        il[0] = 1.f / quad_sum(l[0]);
        il[1] = 1.f / quad_sum(l[1]);
      }
      const int j0 = (n % tiles) * TILE_ROWS, buf = n & 1;
      const int steps = min(KT, (S - j0 + 15) / 16);
      float s[2 * KT][4];
      tile_scores<D, KT>(s, qf, k_s + buf * TILE_ROWS * ROW, j0, steps, S, key_word(a.mask, b, S, j0));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (NORMALIZE && !stats_walk) break;  // the max and sum are exact already
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float corr = exp2f((m[r] - m_new) * C);  // 0 on the first tile
        m[r] = m_new;
        if (stats_walk) {
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2 * KT; ++nt)
            sum += exp2f((s[nt][2 * r] - m_new) * C) + exp2f((s[nt][2 * r + 1] - m_new) * C);
          l[r] = l[r] * corr + sum;
        } else {  // online: rescale what the earlier tiles summed
          l[r] *= corr;
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn) {
            o[dn][2 * r] *= corr;
            o[dn][2 * r + 1] *= corr;
          }
        }
      }
      if (!stats_walk) {
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = exp2f((s[nt][e] - m[e >> 1]) * C);
            if (NORMALIZE)
              s[nt][e] *= il[e >> 1];  // P normalised before it is rounded
            else
              l[e >> 1] += s[nt][e];
          }
        // P (rounded to bf16) . V: score tiles 2kk and 2kk + 1 are the A fragment of
        // 16-key step kk as they stand; V^T's fragments come through ldmatrix.trans
        const bf16* v_rows = v_s + buf * TILE_ROWS * ROW;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          if (kk < steps) {
            uint32_t pa[4];
            bwd::pack_a(pa, s, kk);
            bwd::mma_rows<D>(o, pa, v_rows + 16 * kk * ROW);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buffer n & 1 before step n + 2 refills it
  }
  if (!live) return;
  float inv[2] = {1.f, 1.f};
  if (!NORMALIZE) {  // P was rounded unnormalised: 1/l on the f32 output
    inv[0] = 1.f / quad_sum(l[0]);
    inv[1] = 1.f / quad_sum(l[1]);
  }
  bf16* rows = q_s + 16 * warp * ROW;
  __syncwarp();
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    *reinterpret_cast<uint32_t*>(rows + g * ROW + 8 * dn + 2 * t) = pack_bf16(o[dn][0] * inv[0], o[dn][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(rows + (g + 8) * ROW + 8 * dn + 2 * t) =
        pack_bf16(o[dn][2] * inv[1], o[dn][3] * inv[1]);
  }
  __syncwarp();
  const size_t stride = (size_t)H * D;
  bf16* out = a.out + (size_t)b * S * stride + (size_t)h * D;
  constexpr int P = PIECES<D>, RPI = 32 / P;  // 16-byte pieces of a row; rows at a time
#pragma unroll
  for (int it = 0; it < 16 / RPI; ++it) {  // 16 rows x 2D bytes, 16 bytes a lane
    const int r = RPI * it + lane / P, piece = lane % P;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(out + (row0 + r) * stride + 8 * piece) =
          *reinterpret_cast<const uint4*>(rows + r * ROW + 8 * piece);
  }
}

// normalize: P normalised before its rounding (#5) or not (#1 at S >= 128).
template <int D>
cudaError_t launch_fwd(const FwdArgs& a, bool normalize, cudaStream_t stream) {
  const long long blocks = (long long)a.B * a.H * ((a.S + ROWS - 1) / ROWS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kernel = normalize ? &split_fwd_kernel<D, true> : &split_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- the backward: #3 and #6 ------------------------------------------------

// T: the type of dq and dk (bf16 for #6; f32 for #3's dq~ and dk~, which its LN +
// RoPE pass reads); dv is bf16.
template <typename T>
struct BwdArgs {
  In q, k, v, g;  // q (#3: q~), k (k~), v, dO
  const unsigned char* mask;  // (B, S) or null
  Out<T> dq, dk;
  Out<bf16> dv;
  float* stats;  // m | 1/l | row, each B H S long, row (pair, i) at pair S + i
  int B, S, H;
  HeadScale hs;  // the true head dim's 1/d and softmax scale
};

// Query-major: one block per (pair, tile of ROWS query rows), a pair's tiles
// adjacent; two walks over the key tiles, k and v double-buffered.
template <int D, typename T>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) split_bwd_query_kernel(const BwdArgs<T> a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  constexpr int ROW = fa_mma::ROW<D>, KT = BWD_KT, CH = 16 * KT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int S = a.S, H = a.H, qtiles = (S + ROWS - 1) / ROWS, tiles = tiles_of(S);
  const long long pair = blockIdx.x / qtiles, b = pair / H;
  const int h = (int)(pair % H), row0 = (int)(blockIdx.x % qtiles) * ROWS + 16 * warp;
  bf16* k_s = smem;                       // [2][TILE_ROWS][ROW]
  bf16* v_s = k_s + 2 * TILE_ROWS * ROW;  // [2][TILE_ROWS][ROW]
  const bf16* kp = a.k.base + b * S * a.k.stride + h * D;
  const bf16* vp = a.v.base + b * S * a.v.stride + h * D;
  auto issue = [&](int n) {
    const int buf = n & 1, j0 = (n % tiles) * TILE_ROWS;
    copy_tile<D>(k_s + buf * TILE_ROWS * ROW, kp, a.k.stride, j0, S);
    copy_tile<D>(v_s + buf * TILE_ROWS * ROW, vp, a.v.stride, j0, S);
    cp_async_commit();
  };
  issue(0);
  const bool live = row0 < S;  // uniform per warp
  uint32_t qf[D / 16][4], df[D / 16][4];
  bwd::load_rows_global<D>(qf, a.q.base + b * S * a.q.stride + h * D, a.q.stride, row0, S);
  bwd::load_rows_global<D>(df, a.g.base + b * S * a.g.stride + h * D, a.g.stride, row0, S);
  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  float il[2], row[2], st[2][3];
  for (int n = 0; n < 2 * tiles; ++n) {
    if (n + 1 < 2 * tiles) {
      issue(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (n == tiles) bwd::finish_stats(m, l, rs, il, row, st);
      const int j0 = (n % tiles) * TILE_ROWS, buf = n & 1;
      const unsigned long long word = key_word(a.mask, b, S, j0);
      const bf16* k_rows = k_s + buf * TILE_ROWS * ROW;
      const bf16* v_rows = v_s + buf * TILE_ROWS * ROW;
      for (int lc = 0; lc < TILE_ROWS && j0 + lc < S; lc += CH) {  // chunks of 32 keys
        const int jc = j0 + lc, steps = min(KT, (S - jc + 15) / 16);
        float s[2 * KT][4], dp[2 * KT][4];
        bwd::row_dots<D, KT>(s, qf, k_rows, lc, steps);
        mask_chunk<KT>(s, jc, S, word >> lc);
        bwd::row_dots<D, KT>(dp, df, v_rows, lc, steps);
        if (n < tiles) {  // first walk: m, l and sum_j exp(s - m) dP, online
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < 2 * KT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
            const float m_new = fmaxf(m[r], quad_max(mx));
            const float corr = exp2f((m[r] - m_new) * a.hs.c);  // 0 on the first chunk
            float sum = 0.f, acc = 0.f;
#pragma unroll
            for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) {
                const float p = exp2f((s[nt][e] - m_new) * a.hs.c);
                sum += p;
                acc += p * dp[nt][e];
              }
            l[r] = l[r] * corr + sum;
            rs[r] = rs[r] * corr + acc;
            m[r] = m_new;
          }
        } else {  // second walk: P (normalised, f32), dS, dq += dS (bf16) . k
#pragma unroll
          for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = exp2f((s[nt][e] - m[e >> 1]) * a.hs.c) * il[e >> 1];
              dp[nt][e] = p * (dp[nt][e] - row[e >> 1]) * a.hs.scale;
            }
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            if (kk < steps) {
              uint32_t da[4];
              bwd::pack_a(da, dp, kk);
              bwd::mma_rows<D>(dq, da, k_rows + (lc + 16 * kk) * ROW);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  if (t == 0) {
    const long long rows = (long long)a.B * H * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + g + 8 * r;
      if (i < S) {
        const long long me = pair * S + i;
        a.stats[me] = st[r][0], a.stats[rows + me] = st[r][1], a.stats[2 * rows + me] = st[r][2];
      }
    }
  }
  store_acc<D, T>(dq, a.dq.base + b * a.dq.b_stride + h * a.dq.h_stride, a.dq.i_stride, row0, S);
}

// Key-major: one block per (pair, tile of ROWS key rows), a pair's tiles
// adjacent; one walk over the query tiles, q, dO and their statistics
// double-buffered.
template <int D, typename T>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) split_bwd_key_kernel(const BwdArgs<T> a) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  constexpr int ROW = fa_mma::ROW<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int S = a.S, H = a.H, ktiles = (S + ROWS - 1) / ROWS, tiles = tiles_of(S);
  const long long pair = blockIdx.x / ktiles, b = pair / H, rows = (long long)a.B * H * S;
  const int h = (int)(pair % H), j0 = (int)(blockIdx.x % ktiles) * ROWS, kl = 16 * warp, k0 = j0 + kl;
  bf16* k_s = smem;                        // the block's key rows
  bf16* v_s = k_s + ROWS * ROW;            // their v rows
  bf16* q_s = v_s + ROWS * ROW;            // [2][TILE_ROWS][ROW]
  bf16* do_s = q_s + 2 * TILE_ROWS * ROW;  // [2][TILE_ROWS][ROW]
  float* stat_s = reinterpret_cast<float*>(do_s + 2 * TILE_ROWS * ROW);  // [2][m, 1/l, row][TILE_ROWS]
  const bf16* qp = a.q.base + b * S * a.q.stride + h * D;
  const bf16* gp = a.g.base + b * S * a.g.stride + h * D;
  auto issue = [&](int n) {
    const int buf = n & 1, i0 = n * TILE_ROWS;
    copy_tile<D>(q_s + buf * TILE_ROWS * ROW, qp, a.q.stride, i0, S);
    copy_tile<D>(do_s + buf * TILE_ROWS * ROW, gp, a.g.stride, i0, S);
    cp_async_commit();
    for (int e = threadIdx.x; e < 3 * TILE_ROWS; e += blockDim.x) {  // a query past S: zeros (its P is 0)
      const int part = e / TILE_ROWS, i = i0 + e % TILE_ROWS;
      stat_s[buf * 3 * TILE_ROWS + e] = i < S ? a.stats[part * rows + pair * S + i] : 0.f;
    }
  };
  copy_tile<D>(k_s, a.k.base + b * S * a.k.stride + h * D, a.k.stride, j0, S);  // in step 0's group
  copy_tile<D>(v_s, a.v.base + b * S * a.v.stride + h * D, a.v.stride, j0, S);
  issue(0);
  const bool live = k0 < S;  // uniform per warp
  bool masked[2];  // keys k0 + g and k0 + g + 8: masked, or past S (whose rows are not written)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + g + 8 * r;
    masked[r] = j >= S || (a.mask != nullptr && !a.mask[b * S + j]);
  }
  float dv[D / 8][4], dk[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[dn][e] = dk[dn][e] = 0.f;
  for (int n = 0; n < tiles; ++n) {
    if (n + 1 < tiles) {
      issue(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const int buf = n & 1;
      const bf16* q_rows = q_s + buf * TILE_ROWS * ROW;
      const bf16* do_rows = do_s + buf * TILE_ROWS * ROW;
      const float* m_s = stat_s + buf * 3 * TILE_ROWS;
      for (int ql = 0; ql < TILE_ROWS && n * TILE_ROWS + ql < S; ql += 16) {  // 16 queries at a time
        float st[2][4], dt[2][4];
        {  // k and v fragments loaded again each time, so that dv and dk keep their registers
          uint32_t f[D / 16][4];
          bwd::load_rows<D>(f, k_s + kl * ROW);
          bwd::row_dots<D, 1>(st, f, q_rows, ql, 1);
          bwd::load_rows<D>(f, v_s + kl * ROW);
          bwd::row_dots<D, 1>(dt, f, do_rows, ql, 1);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int il_ = ql + 8 * nt + 2 * t + e1;  // the query's row in the tile
            const bool in = n * TILE_ROWS + il_ < S;
            const float mi = m_s[il_], inv = m_s[TILE_ROWS + il_], row = m_s[2 * TILE_ROWS + il_];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + e1;
              const float p = in ? exp2f(((masked[r] ? NEG_INF : st[nt][e]) - mi) * a.hs.c) * inv : 0.f;
              st[nt][e] = p;
              dt[nt][e] = p * (dt[nt][e] - row) * a.hs.scale;
            }
          }
        uint32_t ap[4], ad[4];
        bwd::pack_a(ap, st, 0);
        bwd::pack_a(ad, dt, 0);
        bwd::mma_rows<D>(dv, ap, do_rows + ql * ROW);
        bwd::mma_rows<D>(dk, ad, q_rows + ql * ROW);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  store_acc<D, bf16>(dv, a.dv.base + b * a.dv.b_stride + h * a.dv.h_stride, a.dv.i_stride, k0, S);
  store_acc<D, T>(dk, a.dk.base + b * a.dk.b_stride + h * a.dk.h_stride, a.dk.i_stride, k0, S);
}

// Both sides, query side first (the key side reads its statistics).
template <int D, typename T>
cudaError_t launch_bwd(const BwdArgs<T>& a, cudaStream_t stream) {
  const long long blocks = (long long)a.B * a.H * ((a.S + ROWS - 1) / ROWS);
  if (blocks > 0x7fffffffLL || a.stats == nullptr) return cudaErrorInvalidValue;
  auto query = split_bwd_query_kernel<D, T>;
  constexpr size_t q_smem = query_smem_bytes<D>(), k_smem = key_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(query, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  query<<<(unsigned)blocks, WARPS * 32, q_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto key = split_bwd_key_kernel<D, T>;
  err = cudaFuncSetAttribute(key, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k_smem);
  if (err != cudaSuccess) return err;
  key<<<(unsigned)blocks, WARPS * 32, k_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace split
}  // namespace fa_mma
