// The f32 attention kernels at head_dim 128, and at every head dim past S =
// 256, on the CUDA cores: the forward of the fused attention (#1 and the
// attention sublayer's for f32 x, with LN and RoPE) and of the plain attention
// (#5), and the query and key sides of both backwards (#3's passes 2 and 3,
// #6's two passes). They back the f32 card-vs-CPU checks; f32 throughout, no
// rounding but the output's. A block owns ROWS = 64 rows of its own side and
// streams the other side in chunks, so no S caps it: past 256 rows the D <= 64
// kernels, which stage a block's sequences whole (a thread a row, up to 256),
// hand their calls to these.
//
// Why not the D <= 64 kernels: those give a thread (or two) a whole row in
// registers and stage a block's other-side rows whole as f32. At D = 128 that
// is 256 registers a thread, and 256 rows of k and v take 2 * 256 * 132 * 4 =
// 270 KB, over a block's 227 KB. Here four lanes share a row (a quad: lane q
// holds the float4 chunks 4 c + q, 32 floats, and dim d + 64, the RoPE partner
// of dim d, sits in the same lane), a dot product takes two __shfl_xor, and
// the other side's rows are staged in chunks of CHUNK positions (k and v, or
// q and dO, 67.6 KB), each chunk waited for by the whole block. A block owns
// ROWS = 64 rows of its own side: the rows of 64 / S whole sequences for S <=
// 64, else 64 rows of one. The softmax is online over 16-key steps (the plain
// forward's exact-max walk and its rounding of P are no-ops in f32).
//
// What bounds it: the f32 pipe (67 TFLOP/s), 4 S^2 D FLOPs a (sequence, head)
// forward and 10 S^2 D backward; nothing here is tuned for it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fa_wide {

constexpr int QUAD = 4;                // lanes a row
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / QUAD;   // a block's rows of its own side
constexpr int CHUNK = 64;              // positions of the other side staged at a time
constexpr int STEP = 16;               // keys of an online-softmax step
constexpr float NEG_INF = -1e30f;      // the JAX kernels' masked score
constexpr float LN_EPS = 1e-6f;
template <int D> constexpr int SROW = D + 4;  // f32 shared-memory row: conflict-free float4 by row
template <int D> constexpr int PART = D / QUAD;

// The f32 rows of one (B, S, H, D) array: row (pair, i), pair = b H + h, at
// base + b * b_stride + h * h_stride + i * i_stride.
struct Rows {
  const float* base;
  long long b_stride, h_stride, i_stride;
  __device__ __forceinline__ const float* at(long long pair, int H, int i) const {
    return base + (pair / H) * b_stride + (pair % H) * h_stride + (long long)i * i_stride;
  }
};

struct OutRows {
  float* base;
  long long b_stride, h_stride, i_stride;
  __device__ __forceinline__ float* at(long long pair, int H, int i) const {
    return base + (pair / H) * b_stride + (pair % H) * h_stride + (long long)i * i_stride;
  }
};

// Which row of its side a thread's quad owns (the block's pairs begin at pair0).
struct Geo {
  long long pair0;
  int ppb;       // pairs staged a block: ROWS / S for S <= ROWS, else 1
  int lp, i;     // this quad's local pair and position (clamped into range)
  bool active;   // the row exists
};

__host__ __device__ __forceinline__ int pairs_a_block(int S) { return S <= ROWS ? ROWS / S : 1; }
__host__ __device__ __forceinline__ int tiles_a_pair(int S) { return (S + ROWS - 1) / ROWS; }

__device__ __forceinline__ Geo geometry(int S, long long n_pairs) {
  Geo g;
  g.ppb = pairs_a_block(S);
  const int tiles = tiles_a_pair(S), local = threadIdx.x / QUAD;
  g.pair0 = (long long)(blockIdx.x / tiles) * g.ppb;
  if (S <= ROWS) {
    g.lp = min(local / S, g.ppb - 1);
    g.i = local % S;
    g.active = local < g.ppb * S && g.pair0 + local / S < n_pairs;
  } else {
    g.lp = 0;
    g.i = (blockIdx.x % tiles) * ROWS + local;
    g.active = g.i < S;
    g.i = min(g.i, S - 1);
  }
  if (g.pair0 + g.lp >= n_pairs) g.lp = 0;  // an inactive quad computes on the block's first pair
  return g;
}

// A lane's quarter of a row: float4 chunks 4 c + q.
template <int D>
__device__ __forceinline__ void load_part(float (&a)[PART<D>], const float* row, int q) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < PART<D> / 4; ++c) {
    const float4 v = r4[4 * c + q];
    a[4 * c] = v.x, a[4 * c + 1] = v.y, a[4 * c + 2] = v.z, a[4 * c + 3] = v.w;
  }
}

template <int D>
__device__ __forceinline__ void store_part(float* row, const float (&a)[PART<D>], int q) {
  float4* r4 = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int c = 0; c < PART<D> / 4; ++c) r4[4 * c + q] = make_float4(a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]);
}

__device__ __forceinline__ float quad_sum(float x) {  // the same bits on the quad's four lanes
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The whole row's dot product with the lane's quarter a, on all four lanes.
template <int D>
__device__ __forceinline__ float quad_dot(const float (&a)[PART<D>], const float* row, int q) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
  for (int c = 0; c < PART<D> / 4; ++c) {
    const float4 v = r4[4 * c + q];
    p0 = fmaf(a[4 * c], v.x, p0);
    p1 = fmaf(a[4 * c + 1], v.y, p1);
    p2 = fmaf(a[4 * c + 2], v.z, p2);
    p3 = fmaf(a[4 * c + 3], v.w, p3);
  }
  return quad_sum((p0 + p1) + (p2 + p3));
}

template <int D>
__device__ __forceinline__ void axpy_part(float (&acc)[PART<D>], float coef, const float* row, int q) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < PART<D> / 4; ++c) {
    const float4 v = r4[4 * c + q];
    acc[4 * c] = fmaf(coef, v.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(coef, v.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(coef, v.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(coef, v.w, acc[4 * c + 3]);
  }
}

// LayerNorm (no bias; E[x^2] - mean^2 clamped at 0) times the scale, then
// rotate-half RoPE, of the row whose quarter the lane holds: element 4 c + k is
// dim 4 (4 c + q) + k, and for c < PART / 8 its partner dim + D/2 is element
// 4 c + k + PART / 2; at D = 16 a lane's four dims have their partners in lane
// q ^ 2 of its quad, taken by a shuffle. inv_d: 1/d of the true head dim d <= D,
// whose heads the wrapper padded to D with zeros (the statistics' sums are d's).
template <int D>
__device__ __forceinline__ void norm_rope(float (&x)[PART<D>], int q, const float* __restrict__ scale,
                                          const float* __restrict__ cos_row, const float* __restrict__ sin_row,
                                          float inv_d) {
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int e = 0; e < PART<D>; ++e) {
    s += x[e];
    sq += x[e] * x[e];
  }
  const float mean = quad_sum(s) * inv_d;
  const float r = rsqrtf(fmaxf(quad_sum(sq) * inv_d - mean * mean, 0.f) + LN_EPS);
#pragma unroll
  for (int c = 0; c < PART<D> / 4; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * c + k] = (x[4 * c + k] - mean) * r * scale[4 * (4 * c + q) + k];
  if constexpr (D == 16) {  // a lane holds dims 4 q .. 4 q + 3; their partners are lane q ^ 2's
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = 4 * q + k;
      const float partner = __shfl_xor_sync(0xffffffffu, x[k], 2);
      x[k] = q < 2 ? x[k] * cos_row[d] - partner * sin_row[d] : x[k] * cos_row[d] + partner * sin_row[d];
    }
  } else {
#pragma unroll
    for (int c = 0; c < PART<D> / 8; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = 4 * (4 * c + q) + k, e = 4 * c + k;
        const float a = x[e], b = x[e + PART<D> / 2];
        x[e] = a * cos_row[d] - b * sin_row[d];
        x[e + PART<D> / 2] = b * cos_row[d + D / 2] + a * sin_row[d + D / 2];
      }
  }
}

// Stage positions j0 .. j0 + n - 1 of two arrays of the block's pairs into
// shared memory (row lp * n + j - j0), and kept[r] from the key mask (1 where
// there is none). A pair past the end stages zeros.
template <int D>
__device__ __forceinline__ void stage_chunk(float* a_s, float* b_s, float* kept, const Rows& a, const Rows& b,
                                            const unsigned char* __restrict__ mask, const Geo& geo, int j0, int n,
                                            int S, int H, long long n_pairs) {
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < geo.ppb * n * C4; e += blockDim.x) {
    const int r = e / C4, c = e % C4;
    const long long pair = geo.pair0 + r / n;
    const int j = j0 + r % n;
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
    if (pair < n_pairs) {
      va = reinterpret_cast<const float4*>(a.at(pair, H, j))[c];
      vb = reinterpret_cast<const float4*>(b.at(pair, H, j))[c];
    }
    reinterpret_cast<float4*>(a_s + r * SROW<D>)[c] = va;
    reinterpret_cast<float4*>(b_s + r * SROW<D>)[c] = vb;
  }
  if (kept != nullptr)
    for (int r = threadIdx.x; r < geo.ppb * n; r += blockDim.x) {
      const long long pair = geo.pair0 + r / n;
      kept[r] = mask == nullptr || pair >= n_pairs || mask[(pair / H) * S + j0 + r % n] ? 1.f : 0.f;
    }
}

// Forward: out = softmax(q k^T scale + key mask) v (scale: 1/sqrt(d) of the true
// head dim), with LN_ROPE the q and k rows first LayerNormed, scaled and rotated
// (the fused attention's q~, k~).
template <int D, bool LN_ROPE>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(Rows qr, Rows kr, Rows vr, const unsigned char* __restrict__ mask, OutRows out, int B, int S, int H,
           const float* __restrict__ q_scale, const float* __restrict__ k_scale, const float* __restrict__ cos_t,
           const float* __restrict__ sin_t, float scale, float inv_d) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + CHUNK * SROW<D>;
  float* kept = v_s + CHUNK * SROW<D>;
  const long long n_pairs = (long long)B * H;
  const Geo geo = geometry(S, n_pairs);
  const int q = threadIdx.x % QUAD;
  const long long pair = geo.pair0 + geo.lp;
  float qv[PART<D>], acc[PART<D>];
  load_part<D>(qv, qr.at(pair, H, geo.i), q);
  if (LN_ROPE) norm_rope<D>(qv, q, q_scale, cos_t + (size_t)geo.i * D, sin_t + (size_t)geo.i * D, inv_d);
#pragma unroll
  for (int d = 0; d < PART<D>; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < S; j0 += CHUNK) {
    const int n = min(CHUNK, S - j0), rows = geo.ppb * n;
    __syncthreads();  // every quad is done with the last chunk
    stage_chunk<D>(k_s, v_s, kept, kr, vr, mask, geo, j0, n, S, H, n_pairs);
    __syncthreads();
    if (LN_ROPE) {  // k~ of the staged rows, a quad a row; every lane runs the shuffles
      for (int r0 = 0; r0 < rows; r0 += ROWS) {
        const int r = r0 + threadIdx.x / QUAD;
        const bool live = r < rows;
        const int at = live ? r : 0, j = j0 + at % n;
        float kv[PART<D>];
        load_part<D>(kv, k_s + at * SROW<D>, q);
        norm_rope<D>(kv, q, k_scale, cos_t + (size_t)j * D, sin_t + (size_t)j * D, inv_d);
        if (live) store_part<D>(k_s + at * SROW<D>, kv, q);
      }
      __syncthreads();
    }
    const float* kb = k_s + geo.lp * n * SROW<D>;
    const float* vb = v_s + geo.lp * n * SROW<D>;
    const float* kp = kept + geo.lp * n;
    for (int s0 = 0; s0 < n; s0 += STEP) {
      float s[STEP], cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < STEP; ++c) {
        float v = -INFINITY;
        if (s0 + c < n) {
          v = quad_dot<D>(qv, kb + (s0 + c) * SROW<D>, q) * scale;
          if (kp[s0 + c] == 0.f) v = NEG_INF;
        }
        s[c] = v;
        cmax = fmaxf(cmax, v);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);  // 0 on the first step (m = -inf)
      m = m_new;
      l *= corr;
#pragma unroll
      for (int d = 0; d < PART<D>; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < STEP; ++c) {
        if (s0 + c < n) {
          const float p = expf(s[c] - m);
          l += p;
          axpy_part<D>(acc, p, vb + (s0 + c) * SROW<D>, q);
        }
      }
    }
  }
  if (!geo.active) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < PART<D>; ++d) acc[d] *= inv;
  store_part<D>(out.at(pair, H, geo.i), acc, q);
}

// Backward, query side: for each query row, the online pass over the keys gives
// m, l = sum exp(s - m) and row = sum_j P dP; the second pass dq = sum_j
// P (dP - row) / sqrt(D) k_j. stats: m | l | row, each n_pairs * S long,
// row (pair, i) at pair * S + i.
template <int D>
__global__ void __launch_bounds__(THREADS)
attention_query_kernel(Rows qr, Rows kr, Rows vr, Rows dor, const unsigned char* __restrict__ mask, OutRows dq,
             float* __restrict__ stats, int B, int S, int H, float scale) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + CHUNK * SROW<D>;
  float* kept = v_s + CHUNK * SROW<D>;
  const long long n_pairs = (long long)B * H;
  const Geo geo = geometry(S, n_pairs);
  const int q = threadIdx.x % QUAD;
  const long long pair = geo.pair0 + geo.lp;
  float qv[PART<D>], dov[PART<D>], acc[PART<D>];
  load_part<D>(qv, qr.at(pair, H, geo.i), q);
  load_part<D>(dov, dor.at(pair, H, geo.i), q);
#pragma unroll
  for (int d = 0; d < PART<D>; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f, racc = 0.f, inv_l = 0.f, row = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < S; j0 += CHUNK) {
      const int n = min(CHUNK, S - j0);
      __syncthreads();
      stage_chunk<D>(k_s, v_s, kept, kr, vr, mask, geo, j0, n, S, H, n_pairs);
      __syncthreads();
      const float* kb = k_s + geo.lp * n * SROW<D>;
      const float* vb = v_s + geo.lp * n * SROW<D>;
      const float* kp = kept + geo.lp * n;
      for (int j = 0; j < n; ++j) {
        float s = quad_dot<D>(qv, kb + j * SROW<D>, q) * scale;
        if (kp[j] == 0.f) s = NEG_INF;
        const float dp = quad_dot<D>(dov, vb + j * SROW<D>, q);
        if (pass == 0) {
          const float m_new = fmaxf(m, s);
          const float corr = expf(m - m_new);  // 0 on the first key (m = -inf)
          const float p = expf(s - m_new);
          l = l * corr + p;
          racc = racc * corr + p * dp;
          m = m_new;
        } else {
          const float p = expf(s - m) * inv_l;
          axpy_part<D>(acc, p * (dp - row) * scale, kb + j * SROW<D>, q);
        }
      }
    }
    inv_l = 1.f / l;
    row = racc * inv_l;
  }
  if (!geo.active) return;
  store_part<D>(dq.at(pair, H, geo.i), acc, q);
  if (q == 0) {
    const long long rows = n_pairs * S, me = pair * S + geo.i;
    stats[me] = m;
    stats[rows + me] = l;
    stats[2 * rows + me] = row;
  }
}

// Backward, key side: for each key row j, over the queries i: P_ij from the
// query side's m and l, dv += P_ij dO_i, dk += P_ij (dP_ij - row_i) / sqrt(D) q_i.
template <int D>
__global__ void __launch_bounds__(THREADS)
attention_key_kernel(Rows qr, Rows kr, Rows vr, Rows dor, const unsigned char* __restrict__ mask, OutRows dk, OutRows dv,
           const float* __restrict__ stats, int B, int S, int H, float scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + CHUNK * SROW<D>;
  float* m_s = do_s + CHUNK * SROW<D>;
  float* l_s = m_s + CHUNK;
  float* r_s = l_s + CHUNK;
  const long long n_pairs = (long long)B * H, rows = n_pairs * S;
  const Geo geo = geometry(S, n_pairs);
  const int q = threadIdx.x % QUAD;
  const long long pair = geo.pair0 + geo.lp;
  const bool masked = mask != nullptr && mask[(pair / H) * S + geo.i] == 0;
  float kv[PART<D>], vv[PART<D>], dk_acc[PART<D>], dv_acc[PART<D>];
  load_part<D>(kv, kr.at(pair, H, geo.i), q);
  load_part<D>(vv, vr.at(pair, H, geo.i), q);
#pragma unroll
  for (int d = 0; d < PART<D>; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  for (int i0 = 0; i0 < S; i0 += CHUNK) {
    const int n = min(CHUNK, S - i0);
    __syncthreads();
    stage_chunk<D>(q_s, do_s, nullptr, qr, dor, mask, geo, i0, n, S, H, n_pairs);
    for (int r = threadIdx.x; r < geo.ppb * n; r += blockDim.x) {
      const long long p = geo.pair0 + r / n;
      const long long me = p * S + i0 + r % n;
      const bool in = p < n_pairs;
      m_s[r] = in ? stats[me] : 0.f;
      l_s[r] = in ? stats[rows + me] : 1.f;
      r_s[r] = in ? stats[2 * rows + me] : 0.f;
    }
    __syncthreads();
    const int base = geo.lp * n;
    for (int i = 0; i < n; ++i) {
      const float* qrow = q_s + (base + i) * SROW<D>;
      const float* dorow = do_s + (base + i) * SROW<D>;
      float s = quad_dot<D>(kv, qrow, q) * scale;
      if (masked) s = NEG_INF;
      const float p = expf(s - m_s[base + i]) * (1.f / l_s[base + i]);
      const float dp = quad_dot<D>(vv, dorow, q);
      axpy_part<D>(dv_acc, p, dorow, q);
      axpy_part<D>(dk_acc, p * (dp - r_s[base + i]) * scale, qrow, q);
    }
  }
  if (!geo.active) return;
  store_part<D>(dk.at(pair, H, geo.i), dk_acc, q);
  store_part<D>(dv.at(pair, H, geo.i), dv_acc, q);
}

inline unsigned grid(int S, long long n_pairs) {
  const int ppb = pairs_a_block(S);
  return (unsigned)(((n_pairs + ppb - 1) / ppb) * tiles_a_pair(S));
}

// scale, inv_d: 1/sqrt(d) and 1/d of the true head dim d <= D.
template <int D>
cudaError_t launch_fwd(bool ln_rope, Rows q, Rows k, Rows v, const unsigned char* mask, OutRows out, int B, int S,
                       int H, const float* q_scale, const float* k_scale, const float* cos_t, const float* sin_t,
                       float scale, float inv_d, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)CHUNK * SROW<D> + CHUNK) * sizeof(float);
  auto kernel = ln_rope ? &attention_fwd_kernel<D, true> : &attention_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid(S, (long long)B * H), THREADS, smem, stream>>>(q, k, v, mask, out, B, S, H, q_scale, k_scale, cos_t,
                                                               sin_t, scale, inv_d);
  return cudaGetLastError();
}

// Both sides of the backward, in turn; stats: an f32 scratch of 3 * B * H * S;
// scale: 1/sqrt(d) of the true head dim d <= D.
template <int D>
cudaError_t launch_sides(Rows q, Rows k, Rows v, Rows d_o, const unsigned char* mask, OutRows dq, OutRows dk,
                         OutRows dv, float* stats, int B, int S, int H, float scale, cudaStream_t stream) {
  const unsigned blocks = grid(S, (long long)B * H);
  const size_t q_smem = (2 * (size_t)CHUNK * SROW<D> + CHUNK) * sizeof(float);
  const size_t k_smem = (2 * (size_t)CHUNK * SROW<D> + 3 * CHUNK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_query_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  attention_query_kernel<D><<<blocks, THREADS, q_smem, stream>>>(q, k, v, d_o, mask, dq, stats, B, S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_key_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k_smem);
  if (err != cudaSuccess) return err;
  attention_key_kernel<D><<<blocks, THREADS, k_smem, stream>>>(q, k, v, d_o, mask, dk, dv, stats, B, S, H, scale);
  return cudaGetLastError();
}

}  // namespace fa_wide
