// Backward of the plain masked attention: dq, dk, dv over (B, S, H, D).
//
// Replaces: video_vae_tpu/ops/flash_attention.py, _flash_bwd -> _bwd_kernel.
// Per (sequence, head), from q, k, v and the output gradient dO: recompute
// p = softmax(q k^T / sqrt(D), masked keys at -1e30) in f32 (not rounded, as
// the TPU kernel's backward), then dv = p^T dO, dp = dO v^T,
// row = sum_j p_ij dp_ij, ds = p o (dp - row) / sqrt(D), dq = ds k, dk = ds^T q,
// all in f32, each written once in its input's dtype. D = 64, S <= 256.
//
// What bounds it on the H100: 10 * S^2 * D FLOPs per (sequence, head) (two
// score recomputes, dv, dp, dq, dk) over 4 * S * D inputs and 3 * S * D
// outputs: bytes-bound on paper at the model's shapes (about 20 us at
// 3.35 TB/s); in f32 on the CUDA cores the FLOPs at S = 256 are the real limit.
//
// What the design does about it: the query-side and key-side passes of
// fused_attention_bwd.cu, reading the tensors directly. dq sums over keys and
// dk, dv over queries, so two launches and no atomics (the same bits every
// run):
//   1. query side: two threads per query row (each owns half of D as
//      interleaved float4 chunks); k and v of the block's sequences sit in
//      shared memory as f32; one online walk gives the row max m, the sum l and
//      the row term, a second gives dq; m, l and row go to an f32 workspace of
//      3 * B * H * S floats;
//   2. key side: two threads per key row hold k_j and v_j and stream q, dO,
//      m, l, row of the block's sequences from shared memory, accumulating dk
//      and dv.
// For S <= 128 a block owns several whole sequences; above, one sequence with
// a chunk of 128 of its rows and the other side staged whole (139 KB).
// Each input is addressed as base + (b * S + i) * row_stride + h * D + d.

#include "flash_common.cuh"

namespace {

constexpr int HALF = D / 2;
constexpr int THREADS = 256;
constexpr int SIDE_ROWS = THREADS / 2;  // query or key rows per block
constexpr int MAX_S = 256;

// Thread half hf owns float4 chunks 2c + hf (c = 0..7) of a 64-element row.

template <typename T>
__device__ __forceinline__ void load_half(float (&a)[HALF], const T* row, int hf) {
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[4 * c + e] = to_float(row[4 * (2 * c + hf) + e]);
}

template <typename T>
__device__ __forceinline__ void store_half(T* row, const float (&a)[HALF], int hf) {
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) row[4 * (2 * c + hf) + e] = from_float<T>(a[4 * c + e]);
}

// the full 64-dim dot product with a shared-memory row, identical on both threads of the pair
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
query_side_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ d_o, const unsigned char* __restrict__ mask,
                  T* __restrict__ dq, float* __restrict__ stats, Strides st, int S, int H,
                  long long n_pairs, float scale) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  const Tile t = tile_of(S, n_pairs);
  float* v_s = k_s + t.staged * ROW;
  float* keep = v_s + t.staged * ROW;
  stage_heads(k_s, k, st.k, t.pair0, t.staged, S, H, n_pairs);
  stage_heads(v_s, v, st.v, t.pair0, t.staged, S, H, n_pairs);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
key_side_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ d_o, const unsigned char* __restrict__ mask,
                T* __restrict__ dk, T* __restrict__ dv, const float* __restrict__ stats,
                Strides st, int S, int H, long long n_pairs, float scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  const Tile t = tile_of(S, n_pairs);
  float* do_s = q_s + t.staged * ROW;
  float* m_s = do_s + t.staged * ROW;
  float* l_s = m_s + t.staged;
  float* r_s = l_s + t.staged;
  const long long rows = n_pairs * S;
  const long long row0 = t.pair0 * S;
  stage_heads(q_s, q, st.q, t.pair0, t.staged, S, H, n_pairs);
  stage_heads(do_s, d_o, st.d_o, t.pair0, t.staged, S, H, n_pairs);
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* d_o, const void* mask,
                   void* dq, void* dk, void* dv, void* work, Strides st, int B, int S, int H,
                   cudaStream_t stream) {
  const long long n_pairs = (long long)B * H;
  const float scale = 1.f / sqrtf((float)D);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(d_o);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  float* stats = static_cast<float*>(work);

  const int ppb = S <= SIDE_ROWS ? SIDE_ROWS / S : 1;
  const int chunks = (S + SIDE_ROWS - 1) / SIDE_ROWS;
  const unsigned blocks = (unsigned)(((n_pairs + ppb - 1) / ppb) * chunks);
  const int staged = ppb * S;
  const size_t q_smem = (2 * (size_t)staged * ROW + staged) * sizeof(float);
  const size_t k_smem = (2 * (size_t)staged * ROW + 3 * (size_t)staged) * sizeof(float);

  auto query_fn = query_side_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(query_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  query_fn<<<blocks, THREADS, q_smem, stream>>>(qt, kt, vt, gt, mk, static_cast<T*>(dq), stats, st,
                                                S, H, n_pairs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto key_fn = key_side_kernel<T>;
  err = cudaFuncSetAttribute(key_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k_smem);
  if (err != cudaSuccess) return err;
  key_fn<<<blocks, THREADS, k_smem, stream>>>(qt, kt, vt, gt, mk, static_cast<T*>(dk),
                                              static_cast<T*>(dv), stats, st, S, H, n_pairs, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the three outputs).
// mask: (B, S) uint8 key mask, or null. *_stride: elements between rows (b, i)
// and (b, i + 1) of that input; dq, dk, dv are contiguous (B, S, H, D).
// work: f32 scratch of 3 * B * H * S floats.
extern "C" int vvt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* d_o, const void* mask, void* dq, void* dk,
                                       void* dv, void* work, long long q_stride,
                                       long long k_stride, long long v_stride,
                                       long long do_stride, int B, int S, int H, int head_dim,
                                       int dtype, void* stream) {
  if (head_dim != D || S < 1 || S > MAX_S || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const Strides st{q_stride, k_stride, v_stride, do_stride};
  if (dtype == 0)
    return (int)launch<float>(q, k, v, d_o, mask, dq, dk, dv, work, st, B, S, H, stream_);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, d_o, mask, dq, dk, dv, work, st, B, S, H, stream_);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
