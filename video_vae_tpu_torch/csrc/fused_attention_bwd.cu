// Backward of the fused QK-norm + RoPE + attention: dqkv and the two scale gradients.
//
// Replaces: video_vae_tpu/ops/flash_attention.py, _fused_bwd_pallas -> _fused_bwd_kernel.
// Per (sequence, head), from the saved fused qkv and the output gradient dO:
// recompute q~ = RoPE(LN(q) * q_scale), k~ likewise, and P = softmax(q~ k~^T / sqrt(D)
// + key mask, masked keys at -1e30); then dv = P^T dO, dP = dO v^T,
// row = sum_j P_ij dP_ij (f32), dS = P o (dP - row) / sqrt(D), dq~ = dS k~, dk~ = dS^T q~,
// and back through RoPE (its transpose), the scale (a per-dim partial
// sum_rows dln * xn) and the LN: dx = r * (dxn - mean(dxn) - xn * mean(dxn * xn)).
// D = 64, S <= 256; f32 or bf16 in and out, f32 arithmetic throughout.
//
// What bounds it on the H100: per (sequence, head) it does 5 S x S x D products
// (two score recomputes, dv, dP, dq~/dk~ share the rest), 10 * S^2 * D FLOPs, over
// 4 * S * D inputs and 3 * S * D outputs. At the train step's shapes that is
// bytes-bound on paper (S = 16: 2.7 GFLOP over 67 MB for the decoder's temporal
// call; S = 256: 43 GFLOP over 67 MB for its spatial call, ~20 us either way at
// 3.35 TB/s). This first version does its arithmetic in f32 on the CUDA cores
// (67 TFLOP/s), so at S = 256 the FLOPs are the real limit.
//
// What the design does about it: the TPU kernel holds a whole (sequence, head)
// in VMEM and computes all of it in one grid step. A block here cannot hold
// f32 q~, k~, v and dO of one sequence at S = 256 (256 KB), and dk/dv sum over
// queries while dq sums over keys. So four passes, none with atomics:
//   1. prep: one warp per row writes q~, k~ (LN, scale, RoPE), v and dO as f32
//      rows of a workspace;
//   2. query side: two threads per query row (each owns half of D, as
//      interleaved float4 chunks, so the pair reads two bank groups); the
//      keys (k~, v) of the block's sequences sit in shared memory; one online
//      pass gives the row max m, sum l and row term, a second gives dq~;
//   3. key side: two threads per key row stream the queries (q~, dO, m, l,
//      row) from shared memory and accumulate dk~ and dv;
//   4. LN/RoPE backward: one warp per row, lanes own dims d and d + 32 (the
//      RoPE pairs); per-block dscale partials, summed by the wrapper.
// Tensor cores (mma/wgmma) and a bf16 workspace are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;
constexpr int HALF = D / 2;
constexpr int ROW = D + 4;        // smem row stride in floats (16-byte rows)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SIDE_ROWS = THREADS / 2;  // query or key rows per block in passes 2, 3
constexpr int MAX_S = 256;
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

// LN (no bias) then rotate-half RoPE; lane owns dims lane and lane + 32.
__device__ __forceinline__ void norm_rope(float& x0, float& x1, int lane, const float* scale,
                                          const float* cos_row, const float* sin_row) {
  const float mean = warp_sum(x0 + x1) * (1.f / D);
  const float var = fmaxf(warp_sum(x0 * x0 + x1 * x1) * (1.f / D) - mean * mean, 0.f);
  const float r = rsqrtf(var + LN_EPS);
  const float a = (x0 - mean) * r * scale[lane];
  const float b = (x1 - mean) * r * scale[lane + HALF];
  x0 = a * cos_row[lane] - b * sin_row[lane];
  x1 = b * cos_row[lane + HALF] + a * sin_row[lane + HALF];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
prep_kernel(const T* __restrict__ qkv, const float* __restrict__ q_scale,
            const float* __restrict__ k_scale, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, const T* __restrict__ g, Work w, int S, int H,
            long long rows) {
  const int lane = threadIdx.x % 32;
  const long long rr = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (rr >= rows) return;  // uniform per warp
  const long long pair = rr / S;
  const int i = (int)(rr % S), h = (int)(pair % H);
  const long long b = pair / H;
  const int HD = H * D;
  const T* src = qkv + ((size_t)b * S + i) * 3 * HD + h * D;
  const float* c = cos_t + (size_t)i * D;
  const float* s = sin_t + (size_t)i * D;
  float q0 = to_float(src[lane]), q1 = to_float(src[lane + HALF]);
  float k0 = to_float(src[HD + lane]), k1 = to_float(src[HD + lane + HALF]);
  norm_rope(q0, q1, lane, q_scale, c, s);
  norm_rope(k0, k1, lane, k_scale, c, s);
  const size_t o = (size_t)rr * D;
  w.qr[o + lane] = q0;
  w.qr[o + lane + HALF] = q1;
  w.kr[o + lane] = k0;
  w.kr[o + lane + HALF] = k1;
  w.v[o + lane] = to_float(src[2 * HD + lane]);
  w.v[o + lane + HALF] = to_float(src[2 * HD + lane + HALF]);
  const T* go = g + ((size_t)b * S + i) * HD + h * D;
  w.d_o[o + lane] = to_float(go[lane]);
  w.d_o[o + lane + HALF] = to_float(go[lane + HALF]);
}

// ---- passes 2 and 3: two threads per row, each with half of D -------------
// Thread half hf owns float4 chunks 2c + hf (c = 0..7) of a 64-float row.

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

__device__ __forceinline__ void store_half(float* row, const float (&a)[HALF], int hf) {
  float4* r4 = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c)
    r4[2 * c + hf] = make_float4(a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]);
}

// the full 64-dim dot product, identical on both threads of the pair
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

// Copy `staged` f32 rows starting at row0 into smem rows of stride ROW; rows
// past the end are zero.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long row0,
                                           int staged, long long rows) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int e = threadIdx.x; e < staged * (D / 4); e += blockDim.x) {
    const int r = e / (D / 4), c = e % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) v = s4[(row0 + r) * (D / 4) + c];
    reinterpret_cast<float4*>(dst + r * ROW)[c] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
query_side_kernel(Work w, const unsigned char* __restrict__ mask, int S, int H,
                  long long n_pairs, float scale) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  const Tile t = tile_of(S, n_pairs);
  float* v_s = k_s + t.staged * ROW;
  float* keep = v_s + t.staged * ROW;
  const long long rows = n_pairs * S;
  const long long row0 = t.pair0 * S;
  stage_rows(k_s, w.kr, row0, t.staged, rows);
  stage_rows(v_s, w.v, row0, t.staged, rows);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
key_side_kernel(Work w, const unsigned char* __restrict__ mask, T* __restrict__ dqkv, int S,
                int H, long long n_pairs, float scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  const Tile t = tile_of(S, n_pairs);
  float* do_s = q_s + t.staged * ROW;
  float* m_s = do_s + t.staged * ROW;
  float* l_s = m_s + t.staged;
  float* r_s = l_s + t.staged;
  const long long rows = n_pairs * S;
  const long long row0 = t.pair0 * S;
  stage_rows(q_s, w.qr, row0, t.staged, rows);
  stage_rows(do_s, w.d_o, row0, t.staged, rows);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_rope_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ q_scale,
                   const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, Work w, T* __restrict__ dqkv,
                   float* __restrict__ dqs_part, float* __restrict__ dks_part, int S, int H,
                   long long rows) {
  __shared__ float red[2][WARPS][D];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int HD = H * D;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [q/k][dim lane, lane + 32]
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
      const float x0 = to_float(src[lane]), x1 = to_float(src[lane + HALF]);
      const float mean = warp_sum(x0 + x1) * (1.f / D);
      const float var = fmaxf(warp_sum(x0 * x0 + x1 * x1) * (1.f / D) - mean * mean, 0.f);
      const float r = rsqrtf(var + LN_EPS);
      const float xn0 = (x0 - mean) * r, xn1 = (x1 - mean) * r;
      const float u0 = du[lane], u1 = du[lane + HALF];
      // RoPE transpose: rot^T(v)[d < D/2] = v[d + D/2], else -v[d - D/2]
      const float dln0 = u0 * c[lane] + u1 * s[lane + HALF];
      const float dln1 = u1 * c[lane + HALF] - u0 * s[lane];
      acc[part][0] += dln0 * xn0;
      acc[part][1] += dln1 * xn1;
      const float dxn0 = dln0 * scale[lane], dxn1 = dln1 * scale[lane + HALF];
      const float m1 = warp_sum(dxn0 + dxn1) * (1.f / D);
      const float m2 = warp_sum(dxn0 * xn0 + dxn1 * xn1) * (1.f / D);
      T* dst = dqkv + base + part * HD;
      dst[lane] = from_float<T>(r * (dxn0 - m1 - xn0 * m2));
      dst[lane + HALF] = from_float<T>(r * (dxn1 - m1 - xn1 * m2));
    }
  }
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    red[part][warp][lane] = acc[part][0];
    red[part][warp][lane + HALF] = acc[part][1];
  }
  __syncthreads();
  if (threadIdx.x < 2 * D) {
    const int part = threadIdx.x / D, d = threadIdx.x % D;
    float sum = 0.f;
    for (int wi = 0; wi < WARPS; ++wi) sum += red[part][wi][d];
    (part == 0 ? dqs_part : dks_part)[(size_t)blockIdx.x * D + d] = sum;
  }
}

template <typename T>
cudaError_t launch(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                   const void* sin_t, const void* mask, const void* g, void* dqkv, void* dqs_part,
                   void* dks_part, void* work, int B, int S, int H, int n_blocks,
                   cudaStream_t stream) {
  const long long n_pairs = (long long)B * H;
  const long long rows = n_pairs * S;
  const int ln_rows = WARPS * LN_ROWS_PER_WARP;
  if ((long long)n_blocks != (rows + ln_rows - 1) / ln_rows) return cudaErrorInvalidValue;
  const Work w = carve(static_cast<float*>(work), rows);
  const float scale = 1.f / sqrtf((float)D);
  const T* qkv_t = static_cast<const T*>(qkv);
  const float* qs = static_cast<const float*>(q_scale);
  const float* ks = static_cast<const float*>(k_scale);
  const float* ct = static_cast<const float*>(cos_t);
  const float* st = static_cast<const float*>(sin_t);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  T* dq = static_cast<T*>(dqkv);

  prep_kernel<T><<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
      qkv_t, qs, ks, ct, st, static_cast<const T*>(g), w, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int ppb = S <= SIDE_ROWS ? SIDE_ROWS / S : 1;
  const int chunks = (S + SIDE_ROWS - 1) / SIDE_ROWS;
  const unsigned side_blocks = (unsigned)(((n_pairs + ppb - 1) / ppb) * chunks);
  const int staged = ppb * S;
  const size_t q_smem = (2 * (size_t)staged * ROW + staged) * sizeof(float);
  const size_t k_smem = (2 * (size_t)staged * ROW + 3 * (size_t)staged) * sizeof(float);
  auto query_fn = query_side_kernel;
  err = cudaFuncSetAttribute(query_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  query_fn<<<side_blocks, THREADS, q_smem, stream>>>(w, mk, S, H, n_pairs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto key_fn = key_side_kernel<T>;
  err = cudaFuncSetAttribute(key_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k_smem);
  if (err != cudaSuccess) return err;
  key_fn<<<side_blocks, THREADS, k_smem, stream>>>(w, mk, dq, S, H, n_pairs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ln_rope_bwd_kernel<T><<<(unsigned)n_blocks, THREADS, 0, stream>>>(
      qkv_t, qs, ks, ct, st, w, dq, static_cast<float*>(dqs_part),
      static_cast<float*>(dks_part), S, H, rows);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qkv, g, dqkv). mask: (B, S) uint8 key mask, or null.
// dqs_part, dks_part: (n_blocks, D) f32 partials, n_blocks = ceil(B * H * S / 64).
// work: f32 scratch of 6 * B * H * S * D + 3 * B * H * S floats.
extern "C" int vvt_fused_attention_bwd(const void* qkv, const void* q_scale, const void* k_scale,
                                       const void* cos_t, const void* sin_t, const void* mask,
                                       const void* g, void* dqkv, void* dqs_part, void* dks_part,
                                       void* work, int B, int S, int H, int head_dim, int n_blocks,
                                       int dtype, void* stream) {
  if (head_dim != D || S < 1 || S > MAX_S || B < 1 || H < 1 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(qkv, q_scale, k_scale, cos_t, sin_t, mask, g, dqkv, dqs_part,
                              dks_part, work, B, S, H, n_blocks, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(qkv, q_scale, k_scale, cos_t, sin_t, mask, g, dqkv,
                                      dqs_part, dks_part, work, B, S, H, n_blocks, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
