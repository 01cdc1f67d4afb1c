// Backward of the plain masked attention: dq, dk, dv over (B, S, H, D).
//
// Replaces: video_vae_tpu/ops/flash_attention.py, _flash_bwd -> _bwd_kernel.
// Per (sequence, head), from q, k, v and the output gradient dO: recompute
// p = softmax(q k^T / sqrt(D), masked keys at -1e30) with the exact row max and
// sum, then dv = p^T dO, dp = dO v^T, row = sum_j p_ij dp_ij,
// ds = p o (dp - row) / sqrt(D), dq = ds k, dk = ds^T q, each written once in
// its input's dtype. D in {16, 32, 64, 128} (a template parameter of every
// kernel; another even D up to 128 runs the next, zero-padded by the wrapper,
// with the true D's scale), any S >= 1. A row whose keys are all masked
// spreads p evenly over all S keys; a key past S (a tile's padding) adds
// exactly 0.
//
// What bounds it on the H100: each call reads q, k, v and dO and writes dq, dk
// and dv once, 59 MB at the model's b2 calls (temporal S = 16 over 512
// sequences, spatial S = 256 over 32), 17.5 us at 3.35 TB/s. The products are
// 10 S^2 D FLOPs per (sequence, head) on paper (five products): 0.67 GFLOP a
// temporal b2 call, 10.7 GFLOP a spatial one, 10.9 us at the 989 TFLOP/s bf16
// peak. So both calls are bytes on paper; at the rate mma.sync reaches, the
// spatial call's products set its pace.
//
// bf16: a tensor-core kernel (flash_attention_bwd_mma.cuh), one launch, no
// workspace, no atomics. It is the fused attention backward's design
// (fused_attention_bwd.cu) without the LN, RoPE and scale gradients around it,
// on the same device code (fa_mma::bwd in fused_attention_mma_common.cuh), and
// at S > 64 with the third walk over the scores replaced by an exchange of dS:
// - Products: mma.sync m16n8k16, bf16 operands and f32 accumulators, ldmatrix
//   (and .trans) from 144-byte shared-memory rows; 16-row tiles suit S = 16,
//   where wgmma's 64-row tile would waste 3/4 of its work.
// - Staging: cp.async copies the block's q, dO, k and v rows straight into
//   bf16 rows, each input addressed as base + (b * S + i) * row_stride + h * D
//   + d (the model's "pallas" path passes v as a view into the fused QKV
//   projection), 16 bytes at a time.
// - Geometry (ops/flash_attention.py:flash_attention_bwd_plan: the variant, the
//   pairs a slab block, the warps; shared memory derived here). Every sum has
//   one owner and one order:
//   * S <= 64, "slab": a block stages up to 4 (sequence, head) pairs and deals
//     their 16-row query tiles to its warps, then, after a barrier, the key
//     tiles. The query side holds a tile's scores and dP for all keys in
//     registers (the exact max), writes P and dS as bf16 to shared memory and
//     takes dq = dS k; the key side reads them back transposed for
//     dv = P^T dO and dk = dS^T q. 5 products of S^2 D a pair, the fewest.
//   * S > 64, "tile": a block owns one pair, all its rows (147 KB at S = 256),
//     and a warp each 16 rows. (1) Each warp walks the keys once for its query
//     rows' m, 1/l and row (scores and dP, online), starting on the first 64
//     keys while the copies of the others are in flight. (2) In rounds of 64
//     queries, each warp recomputes k q^T and v dO^T for its 16 key rows from
//     the staged statistics, adds to dv and dk, and leaves the round's dS^T
//     (bf16) in shared memory; after a barrier the warps take the round's
//     16 x 16 tiles of dq = dS k. 7 products of S^2 D a pair and 2 exp a
//     score, where the fused backward's tile takes 9 and 3.
//   * S > 256, "split" (shared with #3): two launches through an f32
//     workspace of (m, 1/l, row) per query. A query-major block walks the
//     key tiles twice for the statistics and then dq; a key-major block
//     walks the query tiles, with their statistics, for dv and dk. At head
//     dims 64 and 128 on wgmma fed by TMA rings (attention_split_bwd.cuh:
//     128 own rows a block, two consumer warpgroups and a producer), at
//     16 and 32 on mma.sync (attention_split.cuh: 64 rows, double buffers).
//     No atomics: every sum has one owner and one order. 9 products of S^2 D
//     a pair; nothing in shared memory grows with S.
// - Epilogue: a warp's 16 x D accumulators of dv, dk (and the slab's dq)
//   pass through its own 8 staging rows in shared memory, so that D/4 lanes (a
//   half-warp at D = 64) take a whole row and every global store of a row is
//   one contiguous 2D-byte piece; the tile's dq tiles are stored as they stand, 32 bytes a row.
// Roundings (between the TPU kernel, whose products are f32, and the JAX
// package's non-TPU backward, the autodiff of jax.nn.dot_product_attention,
// which rounds the probabilities to v's dtype; SDPA's backward rounds the same
// places): P normalised (exp(s - m) / l with the exact row max and sum, f32)
// and then rounded to bf16 for dv; dS computed in f32 from f32 P and rounded to
// bf16 for dq and dk; q, k, v and dO are bf16 already. Scores, softmax, dP, row
// and the accumulators are f32; each output is rounded once.
//
// f32 keeps the first version, two launches on the CUDA cores through an f32
// workspace of 3 * B * H * S floats, f32 throughout (it backs the f32
// card-vs-CPU phases of the "pallas" path):
//   1. query side: two threads per query row (each owns half of D as
//      interleaved float4 chunks); k and v of the block's sequences sit in
//      shared memory as f32; one online walk gives the row max m, the sum l and
//      the row term, a second gives dq; m, l and row go to the workspace;
//   2. key side: two threads per key row hold k_j and v_j and stream q, dO,
//      m, l, row of the block's sequences from shared memory, accumulating dk
//      and dv.
// For S <= 128 a block owns several whole sequences; above, one sequence with
// a chunk of 128 of its rows and the other side staged whole (139 KB).
//
// D = 128: bf16 slab blocks as above with one block an SM at least; a tile
// block runs the fused backward's wide tile without LN or RoPE
// (bwd::wide_tile_bwd: q | k | v rows, then dO over v; dO and v fragments
// from device memory; 8 warps, 212 KB): the exchange's four row arrays and a
// round's dS^T (315 KB) do not fit, so the key side recomputes the scores (9
// products, not 7). f32 runs the quad kernels of attention_f32_wide.cuh, as
// it does past S = 256 at every D (the two-thread-a-row kernels stage the
// other side whole).

#include "attention_f32_wide.cuh"
#include "attention_split.cuh"
#include "attention_split_bwd.cuh"
#include "attention_wide.cuh"
#include "flash_attention_bwd_mma.cuh"
#include "flash_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SIDE_ROWS = THREADS / 2;  // query or key rows per block
constexpr int MAX_S = 256;  // a longer sequence takes the quad kernels

// Thread half hf owns float4 chunks 2c + hf (c = 0..7) of a 64-element row.

template <int HALF, typename T>
__device__ __forceinline__ void load_half(float (&a)[HALF], const T* row, int hf) {
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[4 * c + e] = to_float(row[4 * (2 * c + hf) + e]);
}

template <int HALF, typename T>
__device__ __forceinline__ void store_half(T* row, const float (&a)[HALF], int hf) {
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) row[4 * (2 * c + hf) + e] = from_float<T>(a[4 * c + e]);
}

// the full 64-dim dot product with a shared-memory row, identical on both threads of the pair
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
__device__ __forceinline__ void axpy_half(float (&acc)[HALF], float coef, const float* row,
                                          int hf) {
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

// Which rows a block owns; see the note at the top.
struct Tile {
  long long pair0;  // first (sequence, head) pair staged
  int staged;       // rows staged in shared memory (pairs_per_block * S)
  int g;            // this thread's pair, local to the block
  int i;            // this thread's row within its sequence
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

struct Strides {
  long long q, k, v, d_o;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
query_side_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ d_o, const unsigned char* __restrict__ mask,
                  T* __restrict__ dq, float* __restrict__ stats, Strides st, int S, int H,
                  long long n_pairs, float scale) {
  constexpr int HALF = D / 2, ROW = F32_ROW<D>;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  const Tile t = tile_of(S, n_pairs);
  float* v_s = k_s + t.staged * ROW;
  float* keep = v_s + t.staged * ROW;
  stage_heads<D>(k_s, k, st.k, t.pair0, t.staged, S, H, n_pairs);
  stage_heads<D>(v_s, v, st.v, t.pair0, t.staged, S, H, n_pairs);
  for (int r = threadIdx.x; r < t.staged; r += blockDim.x) {
    const long long pair = t.pair0 + r / S;
    float kp = 1.f;
    if (mask != nullptr && pair < n_pairs) kp = mask[(pair / H) * S + r % S] ? 1.f : 0.f;
    keep[r] = kp;
  }
  __syncthreads();

  const int hf = threadIdx.x & 1;
  const long long pair = t.active ? t.pair0 + t.g : 0;  // inactive threads compute on pair 0
  const long long b = pair / H;
  const int h = (int)(pair % H);
  const int i = t.active ? t.i : 0;
  float qr[HALF], g[HALF];
  load_half(qr, q + (b * S + i) * st.q + h * D, hf);
  load_half(g, d_o + (b * S + i) * st.d_o + h * D, hf);
  const float* kb = k_s + t.g * S * ROW;
  const float* vb = v_s + t.g * S * ROW;
  const float* kp = keep + t.g * S;

  // online walk: row max m, sum l = sum exp(s - m), racc = sum exp(s - m) dp
  float m = -INFINITY, l = 0.f, racc = 0.f;
  for (int j = 0; j < S; ++j) {
    float s = dot_pair(qr, kb + j * ROW, hf) * scale;
    if (kp[j] == 0.f) s = NEG_INF;
    const float dp = dot_pair(g, vb + j * ROW, hf);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);  // 0 on the first key (m = -inf)
    const float p = expf(s - m_new);
    l = l * corr + p;
    racc = racc * corr + p * dp;
    m = m_new;
  }
  const float inv_l = 1.f / l;
  const float row = racc * inv_l;

  float acc[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
  for (int j = 0; j < S; ++j) {
    float s = dot_pair(qr, kb + j * ROW, hf) * scale;
    if (kp[j] == 0.f) s = NEG_INF;
    const float dp = dot_pair(g, vb + j * ROW, hf);
    const float p = expf(s - m) * inv_l;
    axpy_half(acc, p * (dp - row) * scale, kb + j * ROW, hf);
  }
  if (!t.active) return;
  store_half(dq + ((b * S + i) * H + h) * D, acc, hf);
  if (hf == 0) {
    const long long rows = n_pairs * S;
    const long long me = pair * S + i;
    stats[me] = m;
    stats[rows + me] = l;
    stats[2 * rows + me] = row;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
key_side_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ d_o, const unsigned char* __restrict__ mask,
                T* __restrict__ dk, T* __restrict__ dv, const float* __restrict__ stats,
                Strides st, int S, int H, long long n_pairs, float scale) {
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
  stage_heads<D>(q_s, q, st.q, t.pair0, t.staged, S, H, n_pairs);
  stage_heads<D>(do_s, d_o, st.d_o, t.pair0, t.staged, S, H, n_pairs);
  for (int r = threadIdx.x; r < t.staged; r += blockDim.x) {
    const bool in = row0 + r < rows;
    m_s[r] = in ? stats[row0 + r] : 0.f;
    l_s[r] = in ? stats[rows + row0 + r] : 1.f;
    r_s[r] = in ? stats[2 * rows + row0 + r] : 0.f;
  }
  __syncthreads();

  const int hf = threadIdx.x & 1;
  const long long pair = t.active ? t.pair0 + t.g : 0;
  const long long b = pair / H;
  const int h = (int)(pair % H);
  const int j = t.active ? t.i : 0;
  const bool masked = mask != nullptr && mask[b * S + j] == 0;
  float kr[HALF], vr[HALF], dk_acc[HALF], dv_acc[HALF];
  load_half(kr, k + (b * S + j) * st.k + h * D, hf);
  load_half(vr, v + (b * S + j) * st.v + h * D, hf);
#pragma unroll
  for (int d = 0; d < HALF; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  const int base = t.g * S;
  for (int i = 0; i < S; ++i) {
    const float* qrow = q_s + (base + i) * ROW;
    const float* dorow = do_s + (base + i) * ROW;
    float s = dot_pair(kr, qrow, hf) * scale;
    if (masked) s = NEG_INF;
    const float p = expf(s - m_s[base + i]) * (1.f / l_s[base + i]);
    const float dp = dot_pair(vr, dorow, hf);
    axpy_half(dv_acc, p, dorow, hf);
    axpy_half(dk_acc, p * (dp - r_s[base + i]) * scale, qrow, hf);
  }
  if (!t.active) return;
  const long long o = ((b * S + j) * H + h) * D;
  store_half(dk + o, dk_acc, hf);
  store_half(dv + o, dv_acc, hf);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* d_o, const void* mask,
                   void* dq, void* dk, void* dv, void* work, Strides st, int B, int S, int H, float scale,
                   cudaStream_t stream) {
  const long long n_pairs = (long long)B * H;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(d_o);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  float* stats = static_cast<float*>(work);
  static_assert(sizeof(T) == 4, "the CUDA-core attention takes f32");
  if (D == 128 || S > MAX_S) {  // the quad kernels of attention_f32_wide.cuh
    const long long HD = (long long)H * D;
    auto in = [&](const T* p, long long stride) { return fa_wide::Rows{p, S * stride, D, stride}; };
    auto out = [&](void* p) { return fa_wide::OutRows{static_cast<float*>(p), S * HD, D, HD}; };
    return fa_wide::launch_sides<D>(in(qt, st.q), in(kt, st.k), in(vt, st.v), in(gt, st.d_o), mk, out(dq), out(dk),
                                    out(dv), stats, B, S, H, scale, stream);
  }
  if constexpr (D < 128) {
  const int ppb = S <= SIDE_ROWS ? SIDE_ROWS / S : 1;
  const int chunks = (S + SIDE_ROWS - 1) / SIDE_ROWS;
  const unsigned blocks = (unsigned)(((n_pairs + ppb - 1) / ppb) * chunks);
  const int staged = ppb * S;
  const size_t q_smem = (2 * (size_t)staged * F32_ROW<D> + staged) * sizeof(float);
  const size_t k_smem = (2 * (size_t)staged * F32_ROW<D> + 3 * (size_t)staged) * sizeof(float);

  auto query_fn = query_side_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(query_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  query_fn<<<blocks, THREADS, q_smem, stream>>>(qt, kt, vt, gt, mk, static_cast<T*>(dq), stats, st,
                                                S, H, n_pairs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto key_fn = key_side_kernel<T, D>;
  err = cudaFuncSetAttribute(key_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k_smem);
  if (err != cudaSuccess) return err;
  key_fn<<<blocks, THREADS, k_smem, stream>>>(qt, kt, vt, gt, mk, static_cast<T*>(dk),
                                              static_cast<T*>(dv), stats, st, S, H, n_pairs, scale);
  return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // D = 128 took the quad kernels above
  }
}

// A head dim past 128 (attention_wide.cuh): the inputs' rows as launch_wide's of the
// forward, the gradients contiguous (B, S, H, Dp), work = m | 1/l | row (f32: m | l | row).
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* d_o, const void* mask, void* dq,
                        void* dk, void* dv, void* work, const Strides& st, int B, int S, int H, int Dp,
                        const fa_mma::HeadScale& hs, cudaStream_t stream) {
  using fa_mma::wide::Arr;
  auto in = [&](const void* p, long long stride) { return Arr<const T>{static_cast<const T*>(p), S * stride, Dp, stride}; };
  const long long HD = (long long)H * Dp;
  auto grad = [&](void* p) { return Arr<T>{static_cast<T*>(p), S * HD, Dp, HD}; };
  const fa_mma::wide::BwdArgs<T, T> a{in(q, st.q), in(k, st.k), in(v, st.v), in(d_o, st.d_o),
                                      static_cast<const unsigned char*>(mask), grad(dq), grad(dk), grad(dv),
                                      static_cast<float*>(work), B, S, H, Dp, hs};
  return fa_mma::wide::launch_bwd<T, T>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the three outputs).
// mask: (B, S) uint8 key mask, or null. *_stride: elements between rows (b, i)
// and (b, i + 1) of that input; dq, dk, dv are contiguous (B, S, H, D).
// work: f32 scratch of 3 * B * H * S floats for float32 and for the bf16 split
// variant (m, 1/l and row per query), null otherwise.
// variant (0 slab, 1 tile, 2 split), unit (pairs a slab block), warps and
// n_blocks: the bf16 kernel's plan (ops/flash_attention.py:flash_attention_bwd_plan;
// split: unit 1; at head dims 64 and 128 12 warps and B * H * ceil(S / 128)
// blocks, at 16 and 32 4 warps and B * H * ceil(S / 64)), checked against
// the shape; float32 ignores them.
// variant 4 ("wide", both dtypes, head_dim a multiple of 128 past 128): unit 1, 4 warps,
// n_blocks = B * H * ceil(S / 64) * head_dim / 128, work as float32's.
extern "C" int vvt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* d_o, const void* mask, void* dq, void* dk,
                                       void* dv, void* work, long long q_stride,
                                       long long k_stride, long long v_stride,
                                       long long do_stride, int B, int S, int H, int head_dim, int true_dim,
                                       float scale, int dtype, int variant, int unit, int warps, int n_blocks,
                                       void* stream) {
  if (S < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1) || (dtype == 0 && work == nullptr) ||
      !fa_mma::takes_head(true_dim, head_dim, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const Strides st{q_stride, k_stride, v_stride, do_stride};
  using fa_mma::bf16;
  const fa_mma::HeadScale hs = fa_mma::head_scale(true_dim, scale);
  const fa_mma::flash_bwd::Args a{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const unsigned char*>(mask), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), q_stride, k_stride, v_stride, do_stride,
      B, S, H, unit, hs};
  if (variant == fa_mma::WIDE) {
    if (unit != 1 || warps != fa_mma::wide::WARPS || work == nullptr || head_dim % fa_mma::wide::CHUNK ||
        n_blocks != fa_mma::wide::grid(B, S, H, head_dim / fa_mma::wide::CHUNK))
      return (int)cudaErrorInvalidValue;
    return (int)(dtype == 0 ? launch_wide<float>(q, k, v, d_o, mask, dq, dk, dv, work, st, B, S, H, head_dim, hs,
                                                 stream_)
                            : launch_wide<bf16>(q, k, v, d_o, mask, dq, dk, dv, work, st, B, S, H, head_dim, hs,
                                                stream_));
  }
  return (int)fa_mma::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0) return launch<float, D>(q, k, v, d_o, mask, dq, dk, dv, work, st, B, S, H, hs.scale, stream_);
    if (variant == fa_mma::SPLIT) {
      namespace sp = fa_mma::split;
      if (unit != 1 || warps != fa_mma::split_bwd_warps<D>() || n_blocks != fa_mma::split_bwd_grid<D>(B, S, H))
        return cudaErrorInvalidValue;
      const long long HD = (long long)H * D;
      auto grad = [&](void* p) { return sp::Out<bf16>{static_cast<bf16*>(p), S * HD, D, HD}; };
      const sp::BwdArgs<bf16> sa{{a.q, q_stride}, {a.k, k_stride}, {a.v, v_stride}, {a.g, do_stride}, a.mask,
                                 grad(dq), grad(dk), grad(dv), static_cast<float*>(work), B, S, H, hs};
      return fa_mma::launch_split_bwd<D, bf16>(sa, stream_);
    }
    return fa_mma::flash_bwd::launch_flash_bwd_mma<D>(a, variant, warps, n_blocks, stream_);
  });
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
