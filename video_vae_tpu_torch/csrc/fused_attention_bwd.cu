// Backward of the fused QK-norm + RoPE + attention: dqkv and the two scale gradients.
//
// Replaces: video_vae_tpu/ops/flash_attention.py, _fused_bwd_pallas -> _fused_bwd_kernel.
// Per (sequence, head), from the saved fused qkv and the output gradient dO:
// recompute q~ = RoPE(LN(q) * q_scale), k~ likewise, and P = softmax(q~ k~^T / sqrt(D)
// + key mask, masked keys at -1e30); then dv = P^T dO, dP = dO v^T,
// row = sum_j P_ij dP_ij (f32), dS = P o (dP - row) / sqrt(D), dq~ = dS k~, dk~ = dS^T q~,
// and back through RoPE (its transpose), the scale (a per-dim partial
// sum_rows dln * xn) and the LN: dx = r * (dxn - mean(dxn) - xn * mean(dxn * xn)).
// D in {16, 32, 64, 128} (a template parameter of every kernel; another even D
// up to 128 runs the next, its heads padded by the wrapper, with the true D's
// 1/D and 1/sqrt(D) taken at run time: fa_mma::HeadScale), any S >= 1. A
// masked key (j < S, mask 0) scores -1e30, so a row
// whose keys are all masked spreads P evenly over all S keys; a key past S (a
// tile's padding) adds exactly 0.
//
// What bounds it on the H100: each call reads qkv and dO and writes dqkv once,
// 59 MB at the model's b2 calls (temporal S = 16 over 512 sequences, spatial
// S = 256 over 32), 17.5 us at 3.35 TB/s. The products are 10 S^2 D FLOPs per
// (sequence, head) on paper: 1.3 GFLOP a temporal b2 call, 21 GFLOP a spatial
// one, 21 us at the 989 TFLOP/s bf16 peak. So the temporal call is bytes, and the
// spatial call sits on the ridge, where any recompute or an mma.sync rate below
// the peak makes it the products'.
//
// bf16 qkv: a tensor-core kernel (fused_attention_bwd_mma.cuh), one launch, no
// workspace but the (blocks, D) dscale partials:
// - Products: mma.sync m16n8k16, bf16 operands and f32 accumulators, ldmatrix
//   (and .trans) from D + 8-element shared-memory rows, as the forward: 16-row tiles
//   suit S = 16, where wgmma's 64-row tile would waste 3/4 of its work. The
//   accumulators of P and dS are, as they stand, the A fragments of the next
//   product, and dims d and d + D/2 of a row sit in one lane, so the RoPE
//   transpose of the epilogue needs no shuffle.
// - Staging: cp.async copies the block's q, k (one group) and v, dO rows (a
//   second); then four lanes a row apply LN + RoPE to q and k in place and round
//   them to bf16 (the forward's norm_rope_pair).
// - Geometry (ops/flash_attention.py:fused_attention_bwd_plan: the variant, the
//   pairs a slab block, the warps; shared memory derived here). Both variants
//   deal the 16-row query tiles to the warps, then, after a barrier, the 16-row
//   key tiles, so every sum has one owner and one order: no atomics.
//   * S <= 64, "slab": a block stages several (sequence, head) pairs (the heads
//     of a sequence side by side in memory). The query side holds a tile's
//     scores and dP for all keys in registers (one chunk: the exact max), writes
//     P and dS as bf16 to shared memory and takes dq~ = dS k~; the key side reads
//     them back transposed (ldmatrix.trans) for dv = P^T dO and dk~ = dS^T q~.
//     5 products of S^2 D a pair, the fewest the function needs.
//     Small blocks (up to 4 warps, at least 4 blocks an SM, so 128 registers
//     a thread), so that one block's copies overlap another's products.
//   * S > 64, "tile" (head dims 16 and 32): a block owns one pair, all its
//     rows (147 KB at S = 256 and D = 64; P and dS of the pair would not fit
//     beside them). The query side walks the keys in 32-key chunks twice:
//     q~k~^T and dO v^T give m, l and row online, then again for P, dS and
//     dq~; m, 1/l and row go to shared memory. The key side walks the queries
//     in 16s: k~q~^T and v dO^T give P^T and dS^T, then dv and dk~. 9
//     products a pair, 3 exp a score.
//   * 64 < S <= 256 at head dims 64 and 128, "tile_wg": the same walks and 9
//     products on wgmma fed by TMA (fused_attention_bwd_wg.cuh: one block a
//     pair, two consumer warpgroups dealt 64-row tiles and a producer; at
//     D = 64 every row array resident and each epilogue's rows staged by TMA,
//     at 128 v and dO streamed). The plan picks it by (S, D) alone.
//   * S > 256, "split" (shared with #6): #1's LN + RoPE pass
//     (attention_split.cuh) writes q~ and k~ (bf16, rounded as above) to the
//     workspace; a query-major launch writes the rows' (m, 1/l, row) and dq~
//     in f32, a key-major launch dv and dk~ (dk~ in f32): at head dims 64
//     and 128 on wgmma fed by TMA rings (attention_split_bwd.cuh: 128 rows of
//     one pair a block, two consumer warpgroups and a producer), at 16 and 32
//     on mma.sync (attention_split.cuh: 64 rows a block, double buffers);
//     then pass 4 of the f32 path below runs the LN + RoPE backward on dq~
//     and dk~ and writes the scale partials, one (D,) row a 64-row block. 9
//     products a pair, no atomics, nothing in shared memory that grows with S.
// - Epilogue: a warp's 16 x D accumulators pass through its own 8 staging rows
//   in shared memory, so that D/4 lanes (a half-warp at D = 64) take a whole
//   row, a lane holding dims d and d + D/2 (RoPE's transpose needs no shuffle) and every global access of
//   a row being one contiguous piece: dv is rounded and stored; for dq~ and dk~
//   the raw q or k row is re-read (an L2 hit) for xn and r, and the LN backward
//   runs in f32. Each warp sums its rows' dln * xn in a fixed order into shared
//   memory and the block writes one (D,) partial of each scale, summed by the
//   wrapper.
// Measured on the H100 (PERF.md; video_vae_tpu_torch/utils/kernel_phases.py
// times copies with one phase cut out), the mma.sync kernel at the flagship's calls
// (the spatial call now takes "tile_wg"): neither call is near its bound. The
// spatial call issued about one mma.sync per 7 cycles an SM: 16 warps capped at
// 128 registers waited on their own chains. Its key side took 46 % (19 %
// recomputing k~q~^T and v dO^T), the query side 40 %, the staging and LN
// 18 %; within the sides, the epilogues took 24 % and the exp 10 %. The
// temporal call spends half its time staging and in the LN and 39 % in the
// epilogues, whose chains of loads and row sums wait on L2.
// Roundings (between the TPU kernel, whose products are f32, and the JAX
// package's non-TPU backward, the vjp of _reference_fused_chain, which rounds
// these and more; SDPA's backward rounds the same): q~ and k~ to bf16 after LN
// and RoPE, as the forward does, so P is the P the forward used; P normalised
// (exp(s - m) / l with the exact row max and sum, f32) and then rounded to bf16
// for dv; dS computed in f32 from f32 P and rounded to bf16 for dq~ and dk~;
// v and dO are bf16 already. Everything else is f32: LN statistics, scores,
// softmax, dP, row, accumulators, the RoPE transpose and the LN backward. dqkv
// is rounded once.
//
// f32 qkv keeps the first version, four passes on the CUDA cores through an
// f32 workspace, f32 throughout (it backs the f32 card-vs-CPU train step):
//   1. prep: one warp per row writes q~, k~ (LN, scale, RoPE), v and dO as f32
//      rows of a workspace (lane l < D/2 owns dims l and l + D/2);
//   2. query side: two threads per query row (each owns half of D, as
//      interleaved float4 chunks, so the pair reads two bank groups); the
//      keys (k~, v) of the block's sequences sit in shared memory; one online
//      pass gives the row max m, sum l and row term, a second gives dq~;
//   3. key side: two threads per key row stream the queries (q~, dO, m, l,
//      row) from shared memory and accumulate dk~ and dv;
//   4. LN/RoPE backward: one warp per row, lanes l < D/2 own dims l and
//      l + D/2 (the RoPE pairs); per-block dscale partials, summed by the wrapper.
//
// D = 128. bf16 slab blocks are the same code with one block an SM at least
// (bwd::SLAB_BLOCKS<128>: up to 255 registers for 16 x 128 accumulators); past
// 64 tokens the wgmma tile above. f32 passes 1 and 4 give a lane two RoPE
// pairs (LANE_PAIRS<128>); passes 2 and 3 are the quad kernels of
// attention_f32_wide.cuh (four lanes a row, the other side in 64-row chunks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_f32_wide.cuh"
#include "attention_split.cuh"
#include "attention_split_bwd.cuh"
#include "attention_wide.cuh"
#include "fused_attention_bwd_mma.cuh"
#include "fused_attention_bwd_wg.cuh"

namespace {

template <int D> constexpr int F32_ROW = D + 4;  // smem row stride in floats (16-byte rows)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SIDE_ROWS = THREADS / 2;  // query or key rows per block in passes 2, 3
constexpr int MAX_S = 256;  // passes 2 and 3 of a longer sequence take the quad kernels
constexpr int LN_ROWS_PER_WARP = 8;     // pass 4: 64 rows per block
constexpr float NEG_INF = -1e30f;
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Work {  // f32 workspace, rows = B * H * S, row index (b * H + h) * S + i
  float *qr, *kr, *v, *d_o, *dqr, *dkr, *m, *l, *row;
};

template <int D>
__host__ __device__ __forceinline__ Work carve(float* base, long long rows) {
  Work w;
  w.qr = base;
  w.kr = w.qr + rows * D;
  w.v = w.kr + rows * D;
  w.d_o = w.v + rows * D;
  w.dqr = w.d_o + rows * D;
  w.dkr = w.dqr + rows * D;
  w.m = w.dkr + rows * D;
  w.l = w.m + rows;
  w.row = w.l + rows;
  return w;
}

// ---- pass 1: LN + scale + RoPE of q and k, f32 copies of v and dO ----------

// Lane l < D/2 of a warp owns dims l and l + D/2 of a row (the RoPE pairs); at
// D = 128 it owns LANE_PAIRS = 2 such pairs, dims l + 32 j and l + 32 j + D/2.
// The other lanes (D < 64) hold zeros, which add nothing to the row's sums.
template <int D> constexpr int LANE_PAIRS = D == 128 ? 2 : 1;

template <int D>
__device__ __forceinline__ bool owns_dims(int lane) { return D >= 64 || lane < D / 2; }

// LN (no bias) then rotate-half RoPE; lane owns dims lane + 32 j and lane + 32 j + D/2.
template <int D>
__device__ __forceinline__ void norm_rope(float (&x0)[LANE_PAIRS<D>], float (&x1)[LANE_PAIRS<D>], int lane,
                                          const float* scale, const float* cos_row, const float* sin_row,
                                          float inv_d) {
  constexpr int HALF = D / 2;
  float s = x0[0] + x1[0], sq = x0[0] * x0[0] + x1[0] * x1[0];
#pragma unroll
  for (int j = 1; j < LANE_PAIRS<D>; ++j) {
    s += x0[j] + x1[j];
    sq += x0[j] * x0[j] + x1[j] * x1[j];
  }
  const float mean = warp_sum(s) * inv_d;
  const float var = fmaxf(warp_sum(sq) * inv_d - mean * mean, 0.f);
  const float r = rsqrtf(var + LN_EPS);
  if (!owns_dims<D>(lane)) return;
#pragma unroll
  for (int j = 0; j < LANE_PAIRS<D>; ++j) {
    const int d = lane + 32 * j;
    const float a = (x0[j] - mean) * r * scale[d];
    const float b = (x1[j] - mean) * r * scale[d + HALF];
    x0[j] = a * cos_row[d] - b * sin_row[d];
    x1[j] = b * cos_row[d + HALF] + a * sin_row[d + HALF];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
prep_kernel(const T* __restrict__ qkv, const float* __restrict__ q_scale,
            const float* __restrict__ k_scale, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, const T* __restrict__ g, Work w, int S, int H,
            long long rows, float inv_d) {
  const int lane = threadIdx.x % 32;
  const long long rr = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (rr >= rows) return;  // uniform per warp
  const long long pair = rr / S;
  const int i = (int)(rr % S), h = (int)(pair % H);
  const long long b = pair / H;
  constexpr int HALF = D / 2;
  const int HD = H * D;
  const T* src = qkv + ((size_t)b * S + i) * 3 * HD + h * D;
  const float* c = cos_t + (size_t)i * D;
  const float* s = sin_t + (size_t)i * D;
  constexpr int J = LANE_PAIRS<D>;
  const bool on = owns_dims<D>(lane);
  float q0[J], q1[J], k0[J], k1[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int d = lane + 32 * j;
    q0[j] = on ? to_float(src[d]) : 0.f, q1[j] = on ? to_float(src[d + HALF]) : 0.f;
    k0[j] = on ? to_float(src[HD + d]) : 0.f, k1[j] = on ? to_float(src[HD + d + HALF]) : 0.f;
  }
  norm_rope<D>(q0, q1, lane, q_scale, c, s, inv_d);
  norm_rope<D>(k0, k1, lane, k_scale, c, s, inv_d);
  if (!on) return;
  const size_t o = (size_t)rr * D;
  const T* go = g + ((size_t)b * S + i) * HD + h * D;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int d = lane + 32 * j;
    w.qr[o + d] = q0[j];
    w.qr[o + d + HALF] = q1[j];
    w.kr[o + d] = k0[j];
    w.kr[o + d + HALF] = k1[j];
    w.v[o + d] = to_float(src[2 * HD + d]);
    w.v[o + d + HALF] = to_float(src[2 * HD + d + HALF]);
    w.d_o[o + d] = to_float(go[d]);
    w.d_o[o + d + HALF] = to_float(go[d + HALF]);
  }
}

// ---- passes 2 and 3: two threads per row, each with half of D -------------
// Thread half hf owns float4 chunks 2c + hf (c = 0 .. D/8 - 1) of a D-float row.

template <int HALF>
__device__ __forceinline__ void load_half(float (&a)[HALF], const float* row, int hf) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c) {
    const float4 v = r4[2 * c + hf];
    a[4 * c] = v.x;
    a[4 * c + 1] = v.y;
    a[4 * c + 2] = v.z;
    a[4 * c + 3] = v.w;
  }
}

template <int HALF>
__device__ __forceinline__ void store_half(float* row, const float (&a)[HALF], int hf) {
  float4* r4 = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c)
    r4[2 * c + hf] = make_float4(a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]);
}

// the full D-dim dot product, identical on both threads of the pair
template <int HALF>
__device__ __forceinline__ float dot_pair(const float (&a)[HALF], const float* row, int hf) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c) {
    const float4 v = r4[2 * c + hf];
    p0 = fmaf(a[4 * c], v.x, p0);
    p1 = fmaf(a[4 * c + 1], v.y, p1);
    p2 = fmaf(a[4 * c + 2], v.z, p2);
    p3 = fmaf(a[4 * c + 3], v.w, p3);
  }
  const float part = (p0 + p1) + (p2 + p3);
  const float other = __shfl_xor_sync(0xffffffffu, part, 1);
  return hf == 0 ? part + other : other + part;
}

template <int HALF>
__device__ __forceinline__ void axpy_half(float (&acc)[HALF], float coef, const float* row, int hf) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c) {
    const float4 v = r4[2 * c + hf];
    acc[4 * c] = fmaf(coef, v.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(coef, v.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(coef, v.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(coef, v.w, acc[4 * c + 3]);
  }
}

// Which rows a block of passes 2/3 owns. S <= 128: several whole sequences
// (pairs), each row's partners are its own pair's rows; S > 128: one
// sequence, a chunk of 128 of its rows, the other side staged whole.
struct Tile {
  long long pair0;   // first (sequence, head) pair staged
  int staged;        // rows staged in shared memory (pairs_per_block * S)
  int g;             // this thread's pair, local to the block
  int i;             // this thread's row within its sequence
  bool active;
};

__device__ __forceinline__ Tile tile_of(int S, long long n_pairs) {
  Tile t;
  const int ppb = S <= SIDE_ROWS ? SIDE_ROWS / S : 1;
  const int chunks = (S + SIDE_ROWS - 1) / SIDE_ROWS;
  t.pair0 = (long long)(blockIdx.x / chunks) * ppb;
  t.staged = ppb * S;
  const int local = threadIdx.x / 2;
  if (S <= SIDE_ROWS) {
    t.g = min(local / S, ppb - 1);
    t.i = local % S;
    t.active = local < ppb * S && t.pair0 + local / S < n_pairs;
  } else {
    t.g = 0;
    t.i = (blockIdx.x % chunks) * SIDE_ROWS + local;
    t.active = t.i < S;
    t.i = min(t.i, S - 1);
  }
  return t;
}

// Copy `staged` f32 rows starting at row0 into smem rows of stride F32_ROW; rows
// past the end are zero.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long row0,
                                           int staged, long long rows) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int e = threadIdx.x; e < staged * (D / 4); e += blockDim.x) {
    const int r = e / (D / 4), c = e % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) v = s4[(row0 + r) * (D / 4) + c];
    reinterpret_cast<float4*>(dst + r * F32_ROW<D>)[c] = v;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
query_side_kernel(Work w, const unsigned char* __restrict__ mask, int S, int H,
                  long long n_pairs, float scale) {
  constexpr int HALF = D / 2, ROW = F32_ROW<D>;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  const Tile t = tile_of(S, n_pairs);
  float* v_s = k_s + t.staged * ROW;
  float* keep = v_s + t.staged * ROW;
  const long long rows = n_pairs * S;
  const long long row0 = t.pair0 * S;
  stage_rows<D>(k_s, w.kr, row0, t.staged, rows);
  stage_rows<D>(v_s, w.v, row0, t.staged, rows);
  for (int r = threadIdx.x; r < t.staged; r += blockDim.x) {
    const long long pair = t.pair0 + r / S;
    float kp = 1.f;
    if (mask != nullptr && pair < n_pairs) kp = mask[(size_t)(pair / H) * S + r % S] ? 1.f : 0.f;
    keep[r] = kp;
  }
  __syncthreads();

  const int hf = threadIdx.x & 1;
  const long long me = row0 + (long long)t.g * S + t.i;
  const long long src_row = t.active ? me : 0;  // inactive threads compute on row 0
  float q[HALF], d_o[HALF];
  load_half(q, w.qr + src_row * D, hf);
  load_half(d_o, w.d_o + src_row * D, hf);
  const float* kb = k_s + t.g * S * ROW;
  const float* vb = v_s + t.g * S * ROW;
  const float* kp = keep + t.g * S;

  // online pass: row max m, sum l = sum exp(s - m), racc = sum exp(s - m) dP
  float m = -INFINITY, l = 0.f, racc = 0.f;
  for (int j = 0; j < S; ++j) {
    float s = dot_pair(q, kb + j * ROW, hf) * scale;
    if (kp[j] == 0.f) s = NEG_INF;
    const float dp = dot_pair(d_o, vb + j * ROW, hf);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);  // 0 on the first key (m = -inf)
    const float p = expf(s - m_new);
    l = l * corr + p;
    racc = racc * corr + p * dp;
    m = m_new;
  }
  const float inv_l = 1.f / l;
  const float row = racc * inv_l;

  float dq[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) dq[d] = 0.f;
  for (int j = 0; j < S; ++j) {
    float s = dot_pair(q, kb + j * ROW, hf) * scale;
    if (kp[j] == 0.f) s = NEG_INF;
    const float dp = dot_pair(d_o, vb + j * ROW, hf);
    const float p = expf(s - m) * inv_l;
    axpy_half(dq, p * (dp - row) * scale, kb + j * ROW, hf);
  }
  if (!t.active) return;
  store_half(w.dqr + me * D, dq, hf);
  if (hf == 0) {
    w.m[me] = m;
    w.l[me] = l;
    w.row[me] = row;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
key_side_kernel(Work w, const unsigned char* __restrict__ mask, T* __restrict__ dqkv, int S,
                int H, long long n_pairs, float scale) {
  constexpr int HALF = D / 2, ROW = F32_ROW<D>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  const Tile t = tile_of(S, n_pairs);
  float* do_s = q_s + t.staged * ROW;
  float* m_s = do_s + t.staged * ROW;
  float* l_s = m_s + t.staged;
  float* r_s = l_s + t.staged;
  const long long rows = n_pairs * S;
  const long long row0 = t.pair0 * S;
  stage_rows<D>(q_s, w.qr, row0, t.staged, rows);
  stage_rows<D>(do_s, w.d_o, row0, t.staged, rows);
  for (int r = threadIdx.x; r < t.staged; r += blockDim.x) {
    const bool in = row0 + r < rows;
    m_s[r] = in ? w.m[row0 + r] : 0.f;
    l_s[r] = in ? w.l[row0 + r] : 1.f;
    r_s[r] = in ? w.row[row0 + r] : 0.f;
  }
  __syncthreads();

  const int hf = threadIdx.x & 1;
  const long long me = row0 + (long long)t.g * S + t.i;
  const long long src_row = t.active ? me : 0;
  const long long pair = t.active ? t.pair0 + t.g : 0;
  bool masked = false;
  if (mask != nullptr && t.active) masked = mask[(size_t)(pair / H) * S + t.i] == 0;
  float k[HALF], v[HALF], dk[HALF], dv[HALF];
  load_half(k, w.kr + src_row * D, hf);
  load_half(v, w.v + src_row * D, hf);
#pragma unroll
  for (int d = 0; d < HALF; ++d) dk[d] = dv[d] = 0.f;
  const int base = t.g * S;
  for (int i = 0; i < S; ++i) {
    const float* qrow = q_s + (base + i) * ROW;
    const float* dorow = do_s + (base + i) * ROW;
    float s = dot_pair(k, qrow, hf) * scale;
    if (masked) s = NEG_INF;
    const float p = expf(s - m_s[base + i]) * (1.f / l_s[base + i]);
    const float dp = dot_pair(v, dorow, hf);
    axpy_half(dv, p, dorow, hf);
    axpy_half(dk, p * (dp - r_s[base + i]) * scale, qrow, hf);
  }
  if (!t.active) return;
  store_half(w.dkr + me * D, dk, hf);
  const int HD = H * D;
  const long long b = pair / H;
  const int h = (int)(pair % H);
  T* dst = dqkv + ((size_t)b * S + t.i) * 3 * HD + 2 * HD + h * D;
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[4 * (2 * c + hf) + e] = from_float<T>(dv[4 * c + e]);
}

// ---- pass 4: back through RoPE, the scale and the LN ----------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
ln_rope_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ q_scale,
                   const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, Work w, T* __restrict__ dqkv,
                   float* __restrict__ dqs_part, float* __restrict__ dks_part, int S, int H,
                   long long rows, float inv_d) {
  constexpr int HALF = D / 2, J = LANE_PAIRS<D>;
  __shared__ float red[2][WARPS][D];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool on = owns_dims<D>(lane);
  const int HD = H * D;
  float acc[2][J][2] = {};  // [q/k][pair j][dim lane + 32 j, lane + 32 j + D/2]
  for (int n = 0; n < LN_ROWS_PER_WARP; ++n) {
    const long long rr =
        ((long long)blockIdx.x * WARPS + warp) * LN_ROWS_PER_WARP + n;
    if (rr >= rows) break;  // uniform per warp
    const long long pair = rr / S;
    const int i = (int)(rr % S), h = (int)(pair % H);
    const long long b = pair / H;
    const size_t base = ((size_t)b * S + i) * 3 * HD + h * D;
    const float* c = cos_t + (size_t)i * D;
    const float* s = sin_t + (size_t)i * D;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const float* scale = part == 0 ? q_scale : k_scale;
      const float* du = (part == 0 ? w.dqr : w.dkr) + (size_t)rr * D;
      const T* src = qkv + base + part * HD;
      float x0[J], x1[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        x0[j] = on ? to_float(src[lane + 32 * j]) : 0.f, x1[j] = on ? to_float(src[lane + 32 * j + HALF]) : 0.f;
      float sx = x0[0] + x1[0], sxx = x0[0] * x0[0] + x1[0] * x1[0];
#pragma unroll
      for (int j = 1; j < J; ++j) {
        sx += x0[j] + x1[j];
        sxx += x0[j] * x0[j] + x1[j] * x1[j];
      }
      const float mean = warp_sum(sx) * inv_d;
      const float var = fmaxf(warp_sum(sxx) * inv_d - mean * mean, 0.f);
      const float r = rsqrtf(var + LN_EPS);
      // a lane without dims holds zeros: its xn, dln and dxn are 0
      float xn0[J], xn1[J], dxn0[J], dxn1[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        xn0[j] = on ? (x0[j] - mean) * r : 0.f, xn1[j] = on ? (x1[j] - mean) * r : 0.f;
        const int dl = on ? lane + 32 * j : 0;  // a lane without dims reads dim 0's tables, times 0
        const float u0 = on ? du[dl] : 0.f, u1 = on ? du[dl + HALF] : 0.f;
        // RoPE transpose: rot^T(v)[d < D/2] = v[d + D/2], else -v[d - D/2]
        const float dln0 = u0 * c[dl] + u1 * s[dl + HALF];
        const float dln1 = u1 * c[dl + HALF] - u0 * s[dl];
        acc[part][j][0] += dln0 * xn0[j];
        acc[part][j][1] += dln1 * xn1[j];
        dxn0[j] = dln0 * scale[dl], dxn1[j] = dln1 * scale[dl + HALF];
      }
      float s1 = dxn0[0] + dxn1[0], s2 = dxn0[0] * xn0[0] + dxn1[0] * xn1[0];
#pragma unroll
      for (int j = 1; j < J; ++j) {
        s1 += dxn0[j] + dxn1[j];
        s2 += dxn0[j] * xn0[j] + dxn1[j] * xn1[j];
      }
      const float m1 = warp_sum(s1) * inv_d;
      const float m2 = warp_sum(s2) * inv_d;
      T* dst = dqkv + base + part * HD;
      if (on) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          dst[lane + 32 * j] = from_float<T>(r * (dxn0[j] - m1 - xn0[j] * m2));
          dst[lane + 32 * j + HALF] = from_float<T>(r * (dxn1[j] - m1 - xn1[j] * m2));
        }
      }
    }
  }
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    if (on) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        red[part][warp][lane + 32 * j] = acc[part][j][0];
        red[part][warp][lane + 32 * j + HALF] = acc[part][j][1];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * D) {
    const int part = threadIdx.x / D, d = threadIdx.x % D;
    float sum = 0.f;
    for (int wi = 0; wi < WARPS; ++wi) sum += red[part][wi][d];
    (part == 0 ? dqs_part : dks_part)[(size_t)blockIdx.x * D + d] = sum;
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                   const void* sin_t, const void* mask, const void* g, void* dqkv, void* dqs_part,
                   void* dks_part, void* work, int B, int S, int H, int n_blocks, const fa_mma::HeadScale& hs,
                   cudaStream_t stream) {
  const long long n_pairs = (long long)B * H;
  const long long rows = n_pairs * S;
  const int ln_rows = WARPS * LN_ROWS_PER_WARP;
  if ((long long)n_blocks != (rows + ln_rows - 1) / ln_rows) return cudaErrorInvalidValue;
  const Work w = carve<D>(static_cast<float*>(work), rows);
  const float scale = hs.scale;
  const T* qkv_t = static_cast<const T*>(qkv);
  const float* qs = static_cast<const float*>(q_scale);
  const float* ks = static_cast<const float*>(k_scale);
  const float* ct = static_cast<const float*>(cos_t);
  const float* st = static_cast<const float*>(sin_t);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  T* dq = static_cast<T*>(dqkv);

  prep_kernel<T, D><<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
      qkv_t, qs, ks, ct, st, static_cast<const T*>(g), w, S, H, rows, hs.inv_d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static_assert(sizeof(T) == 4, "the CUDA-core attention takes f32");
  if (D == 128 || S > MAX_S) {  // passes 2 and 3 by the quad kernels of attention_f32_wide.cuh
    const long long HD = (long long)H * D, token = 3 * HD;
    auto ws = [&](float* p) { return fa_wide::OutRows{p, H * (long long)S * D, (long long)S * D, D}; };
    auto in = [&](float* p) { return fa_wide::Rows{p, H * (long long)S * D, (long long)S * D, D}; };
    err = fa_wide::launch_sides<D>(in(w.qr), in(w.kr), in(w.v), in(w.d_o), mk, ws(w.dqr), ws(w.dkr),
                                   fa_wide::OutRows{dq + 2 * HD, S * token, D, token}, w.m, B, S, H, scale, stream);
  } else if constexpr (D < 128) {
  const int ppb = S <= SIDE_ROWS ? SIDE_ROWS / S : 1;
  const int chunks = (S + SIDE_ROWS - 1) / SIDE_ROWS;
  const unsigned side_blocks = (unsigned)(((n_pairs + ppb - 1) / ppb) * chunks);
  const int staged = ppb * S;
  const size_t q_smem = (2 * (size_t)staged * F32_ROW<D> + staged) * sizeof(float);
  const size_t k_smem = (2 * (size_t)staged * F32_ROW<D> + 3 * (size_t)staged) * sizeof(float);
  auto query_fn = query_side_kernel<D>;
  err = cudaFuncSetAttribute(query_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  query_fn<<<side_blocks, THREADS, q_smem, stream>>>(w, mk, S, H, n_pairs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto key_fn = key_side_kernel<T, D>;
  err = cudaFuncSetAttribute(key_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k_smem);
  if (err != cudaSuccess) return err;
  key_fn<<<side_blocks, THREADS, k_smem, stream>>>(w, mk, dq, S, H, n_pairs, scale);
  err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;

  ln_rope_bwd_kernel<T, D><<<(unsigned)n_blocks, THREADS, 0, stream>>>(
      qkv_t, qs, ks, ct, st, w, dq, static_cast<float*>(dqs_part),
      static_cast<float*>(dks_part), S, H, rows, hs.inv_d);
  return cudaGetLastError();
}

// The bf16 split variant: q~ and k~ by #1's LN + RoPE pass, the softmax
// backward's two launches on them (launch_split_bwd) with dq~ and dk~ in f32,
// then pass 4 above on those. work (f32 words): dq~ | dk~ (B H S D each, row
// pair * S + i, as Work's) | q~ | k~ (bf16, B S H D each) | m | 1/l | row (B H S each).
template <int D>
cudaError_t launch_split(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                         const void* sin_t, const void* mask, const void* g, void* dqkv, void* dqs_part,
                         void* dks_part, void* work, int B, int S, int H, int n_blocks, const fa_mma::HeadScale& hs,
                         cudaStream_t stream) {
  namespace sp = fa_mma::split;
  using bf16 = __nv_bfloat16;
  const long long rows = (long long)B * H * S, HD = (long long)H * D, token = 3 * HD;
  const int ln_rows = WARPS * LN_ROWS_PER_WARP;
  if (work == nullptr || (long long)n_blocks != (rows + ln_rows - 1) / ln_rows) return cudaErrorInvalidValue;
  float* base = static_cast<float*>(work);
  Work w{};
  w.dqr = base;
  w.dkr = base + rows * D;
  bf16* qn = reinterpret_cast<bf16*>(base + 2 * rows * D);
  bf16* kn = qn + rows * D;
  float* stats = base + 3 * rows * D;
  cudaError_t err = sp::launch_norm_rope<D>(qkv, q_scale, k_scale, cos_t, sin_t, qn, kn, B, S, H, hs.inv_d, stream);
  if (err != cudaSuccess) return err;
  const bf16* x = static_cast<const bf16*>(qkv);
  auto tilde = [&](float* p) { return sp::Out<float>{p, H * (long long)S * D, (long long)S * D, D}; };
  const sp::BwdArgs<float> a{{qn, HD}, {kn, HD}, {x + 2 * HD, token}, {static_cast<const bf16*>(g), HD},
                             static_cast<const unsigned char*>(mask), tilde(w.dqr), tilde(w.dkr),
                             sp::Out<bf16>{static_cast<bf16*>(dqkv) + 2 * HD, S * token, D, token}, stats,
                             B, S, H, hs};
  err = fa_mma::launch_split_bwd<D, float>(a, stream);
  if (err != cudaSuccess) return err;
  ln_rope_bwd_kernel<bf16, D><<<(unsigned)n_blocks, THREADS, 0, stream>>>(
      x, static_cast<const float*>(q_scale), static_cast<const float*>(k_scale), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), w, static_cast<bf16*>(dqkv), static_cast<float*>(dqs_part),
      static_cast<float*>(dks_part), S, H, rows, hs.inv_d);
  return cudaGetLastError();
}

}  // namespace

// head_dim D: 16, 32, 64 or 128; any other is refused. true_dim d and scale: the
// head dim of the call, even, 2 <= d <= D (the wrapper pads each head of d to D
// by halves, ops/flash_attention.py:pad_heads), and its softmax scale 1/sqrt(d)
// rounded to f32; the kernels take 1/d and that scale at run time (HeadScale).
// dtype: 0 = float32, 1 = bfloat16 (qkv, g, dqkv). mask: (B, S) uint8 key mask, or null.
// dqs_part, dks_part: (n_blocks, D) f32 partials of the scale gradients.
// f32: n_blocks = ceil(B * H * S / 64), work = f32 scratch of 6 * B * H * S * D +
// 3 * B * H * S floats; variant, unit and warps are not read.
// bf16: variant (slab 0, tile 1, split 2, tile_wg 3: the wgmma tile at head
// dims 64 and 128, 12 warps), unit (pairs a slab block, 1 otherwise) and warps
// from the plan; slab, tile and tile_wg: n_blocks = the grid, work is not
// read; split (12 warps at head dims 64 and 128, 4 at 16 and 32): n_blocks =
// ceil(B * H * S / 64), work = f32 scratch of 3 * B * H * S * D + 3 * B * H * S
// floats.
// variant 4 ("wide", both dtypes, head_dim a multiple of 128 past 128; unit 1):
// n_blocks = ceil(B * H * S / 8) (a (head_dim,) partial a warp of its LN + RoPE
// backward), work = f32 scratch of 2 * B * H * S * D floats, then 2 * B * H * S * D
// elements of qkv's dtype, then 3 * B * H * S floats (fa_mma::wide::launch_fused_bwd).
extern "C" int vvt_fused_attention_bwd(const void* qkv, const void* q_scale, const void* k_scale,
                                       const void* cos_t, const void* sin_t, const void* mask,
                                       const void* g, void* dqkv, void* dqs_part, void* dks_part,
                                       void* work, int B, int S, int H, int head_dim, int true_dim, float scale,
                                       int n_blocks, int dtype, int variant, int unit, int warps, void* stream) {
  if (S < 1 || B < 1 || H < 1 || n_blocks < 1 || (dtype != 0 && dtype != 1) ||
      !fa_mma::takes_head(true_dim, head_dim, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const fa_mma::HeadScale hs = fa_mma::head_scale(true_dim, scale);
  const fa_mma::bwd::Args a{static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(q_scale),
                            static_cast<const float*>(k_scale), static_cast<const float*>(cos_t),
                            static_cast<const float*>(sin_t), static_cast<const unsigned char*>(mask),
                            static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dqkv),
                            static_cast<float*>(dqs_part), static_cast<float*>(dks_part), B, S, H, unit, hs};
  if (variant == fa_mma::WIDE) {  // a head dim past 128 (attention_wide.cuh)
    if (unit != 1 || warps != fa_mma::wide::WARPS) return (int)cudaErrorInvalidValue;
    return (int)(dtype == 0 ? fa_mma::wide::launch_fused_bwd<float>(qkv, q_scale, k_scale, cos_t, sin_t, mask, g, dqkv,
                                                                   dqs_part, dks_part, work, B, S, H, head_dim,
                                                                   n_blocks, hs, st)
                            : fa_mma::wide::launch_fused_bwd<__nv_bfloat16>(qkv, q_scale, k_scale, cos_t, sin_t,
                                                                           mask, g, dqkv, dqs_part, dks_part, work, B,
                                                                           S, H, head_dim, n_blocks, hs, st));
  }
  return (int)fa_mma::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch<float, D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, g, dqkv, dqs_part, dks_part, work, B, S,
                              H, n_blocks, hs, st);
    if (variant == fa_mma::SPLIT) {
      if (unit != 1 || warps != fa_mma::split_bwd_warps<D>()) return cudaErrorInvalidValue;
      return launch_split<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, g, dqkv, dqs_part, dks_part, work, B, S, H,
                             n_blocks, hs, st);
    }
    if (variant == fa_mma::TILE_WG) {
      if constexpr (D >= 64)
        return fa_mma::tile_wg::launch_bwd<D>(a, warps, n_blocks, st);
      else
        return cudaErrorInvalidValue;
    }
    return fa_mma::bwd::launch_attention_bwd_mma<D>(a, variant, warps, n_blocks, st);
  });
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
