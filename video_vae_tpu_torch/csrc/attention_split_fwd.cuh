// The split variant's forward (#1, fused_attention.cu, and #7's attention,
// attention_sublayer.cu, after #1's LN + RoPE pass; #5, flash_attention.cu)
// past 256 tokens, on Hopper's warpgroup tensor cores for head dims 64 and
// 128: wgmma fed by a TMA ring. It replaces attention_split.cuh's mma.sync
// forward (split_fwd_kernel), which stays for head dims 16 and 32 only: their
// 32- and 64-byte rows are below the 128-byte swizzle span that every tile,
// descriptor and transpose read here is laid out on. The plan picks by head dim
// alone (launch_split_fwd below; ops/flash_attention.py:split_fwd_grid).
//
// What bounds it on the H100: the products and the exps. At the flagship's
// 512² spatial call (S = 1024, 8 heads of 64, b2: 256 pairs) the two products
// of S^2 D a pair are 68.7 GFLOP (0.0695 ms at the 989 TFLOP/s bf16 peak), and
// the S^2 exps a pair 0.27 G (about 0.07 ms at 16 a clock an SM): at D = 64 the
// exps cost as much as the products, so each warpgroup's exps have to run
// under some product. #5 walks the keys twice (3 products and 2 S^2 exps a
// pair), as its rounding needs the exact row max and sum before P is rounded.
//
// #5 is two launches of the kernel: the first walks the keys (k alone) for
// each row's exact max and sum and parks them in the first 8 bytes of the
// row's own output; the second reads them back and walks k and v for P.V. In
// one kernel the two walks made ptxas serialise every wgmma (FwdMode below).
//
// One block owns BLOCK_ROWS = 128 query rows of one (sequence, head) pair, 64
// for each of two consumer warpgroups, beside a producer warpgroup that gives
// its registers up (setmaxnreg, as the backward's). The producer's lane 0
// stages the own q rows once (TMA, on an mbarrier of their own) and fills a
// ring of FWD_STAGES stages with key tiles of KEY_TILE<D> keys (128 at D = 64,
// 64 at D = 128, so that a tile's f32 scores fit the registers): TMA boxes of
// 128 bytes a row (64 columns, 128-byte swizzle; D = 128 takes two a tile),
// counted on the stage's `full` mbarrier by bytes: k and v, or k alone in
// #5's first launch. Each consumer warp frees a stage on its `empty` mbarrier
// once its products on it are done. The tensor maps are 3-D (B x S x H D, rows
// `stride` elements apart), so a box never reaches into the next sequence, and
// a row past S reads as zeros.
//
// A consumer warpgroup, a key tile at a time: S = q k^T (wgmma; k K-major from
// the ring, q as register A fragments at D = 64 and from shared memory at 128,
// as the backward's own rows), the mask, the softmax in f32, then P rounded to
// bf16 from the score accumulators as the register A operand (wgmma's A
// fragment is mma.sync's) and O += P V with v read MN-major (the transpose
// bit). The P.V of tile n stays in flight under the scores and the softmax of
// tile n + 1 (FlashAttention-3's intra-warpgroup overlap), and
// the two warpgroups of a block overlap each other's softmax with their
// products. O leaves through the warpgroup's own q tile, rounded to bf16 and
// stored by TMA (rows past S are clipped).
//
// Roundings as attention_split.cuh's: scores and softmax in f32 (the scale in
// the exp2 domain), P rounded to bf16 before P.V, o rounded once. #1 at S > 256
// is on JAX's unpacked path: one walk with a running max, P = exp(s - m)
// rounded unnormalised, 1/l on the f32 output; its running max steps a key tile
// (128 keys at D = 64, where the mma.sync forward stepped 64), so its bits
// past 256 tokens differ from that kernel's, within the same tolerance. #5
// rounds P after normalising it: its first launch streams k alone and gives the
// exact row max and sum, its second streams k and v and takes P.V. Masks: a masked key scores
// -1e30 (NEG_INF), a key past S -inf, so a row whose keys are all masked
// averages all S keys, and a tile whose keys are all masked leaves the running
// max finite.
//
// #1's q~: the block stages its own raw q rows from the fused qkv and runs
// the LN + RoPE pass's arithmetic on them in place (norm_rope_own_q), once, so
// the pass writes k~ alone (a pass that also wrote q~ took 23 % of #1 at b2).
//
// Operands: #1 passes its raw q rows and v strided in the fused qkv (rows 3 H
// D apart) and k~ (the LN + RoPE pass's workspace, rows H D apart); #5 q, k and v as
// ops/flash_attention.py:_rows_of_heads hands them over. Every row stride
// reaches here as a multiple of 8 elements at a 16-byte aligned base, which is
// TMA's rule, so every operand, and the output, is a TMA tensor map; the entry
// point refuses any other.
//
// Shared memory of a block (1 KB alignment slack, then):
//   own q [2][64 x D] | ring [FWD_STAGES][k, v: KEY_TILE x D] | mbarriers
// 113 KB at D = 64 and 129 KB at 128: one block an SM (384 threads).
// tests/helpers/split_geometry.py (WgmmaFwdGeometry) mirrors these sizes.

#pragma once

#include "attention_split.cuh"
#include "attention_split_bwd.cuh"

namespace fa_mma {
namespace split_wg {

constexpr int FWD_STAGES = 3;  // ring stages of the forward
constexpr int TURN_BAR = 3;    // named barriers 3 and 4: each warpgroup's turn (1 and 2: the epilogue's)
constexpr size_t FWD_BAR_BYTES = (size_t)(1 + 2 * FWD_STAGES) * 8;

template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return ALIGN + (size_t)CONSUMERS * TILE_BYTES<D, WG_ROWS> + (size_t)FWD_STAGES * 2 * TILE_BYTES<D, KEY_TILE<D>> +
         FWD_BAR_BYTES;
}
static_assert(fwd_smem_bytes<128>() <= (size_t)MAX_SMEM, "a D = 128 forward block fits the H100");

struct FwdMaps {
  CUtensorMap q, k, v, o;
};

// #1's LN + RoPE of its q rows, done in the block (scale null: q is taken as it is).
struct QNorm {
  const float* scale;
  const float* cos_t;
  const float* sin_t;
};

// LN + RoPE of a warpgroup's 64 own q rows, staged raw by TMA, in place in the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), rounded to
// bf16: the arithmetic of norm_rope_pair (D / 16 lanes a row, lane c holding
// elements 8 c .. + 7 and their rotate-half partners D / 2 + 8 c .. + 7, f32
// statistics, E[x^2] - mean^2 clamped at 0), so q~ has the bits the LN + RoPE
// pass gives it. A row at or past S is left as it is (zeros). The lane's
// scale and cos / sin entries are loaded first (QTables), while q is still on
// its way.
template <int D> constexpr int Q_LANES = LN_LANES<D>;
template <int D> constexpr int Q_PASSES = WG_ROWS * Q_LANES<D> / 128;  // rows a lane takes in turn

template <int D>
struct QTables {
  float sc[16], cs[Q_PASSES<D>][16], sn[Q_PASSES<D>][16];
};

template <int D>
__device__ __forceinline__ int q_row(int pass) { return pass * (128 / Q_LANES<D>) + (threadIdx.x & 127) / Q_LANES<D>; }

template <int D>
__device__ __forceinline__ void load_q_tables(QTables<D>& tb, int own0, int S, const QNorm& qn) {
  const int c = threadIdx.x & (Q_LANES<D> - 1);
  load_lane_scale<D>(tb.sc, qn.scale);
#pragma unroll
  for (int ps = 0; ps < Q_PASSES<D>; ++ps) {
    const int i = own0 + q_row<D>(ps);
    const bool live = i < S;
    const float* cos_row = qn.cos_t + (size_t)(live ? i : 0) * D;
    const float* sin_row = qn.sin_t + (size_t)(live ? i : 0) * D;
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // float4 q of the lane's 16 table entries
      const int d = (q >> 1) * D / 2 + 8 * c + 4 * (q & 1);
      const float4 cv = live ? __ldg(reinterpret_cast<const float4*>(cos_row + d)) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 sv = live ? __ldg(reinterpret_cast<const float4*>(sin_row + d)) : make_float4(0.f, 0.f, 0.f, 0.f);
      tb.cs[ps][4 * q] = cv.x, tb.cs[ps][4 * q + 1] = cv.y, tb.cs[ps][4 * q + 2] = cv.z, tb.cs[ps][4 * q + 3] = cv.w;
      tb.sn[ps][4 * q] = sv.x, tb.sn[ps][4 * q + 1] = sv.y, tb.sn[ps][4 * q + 2] = sv.z, tb.sn[ps][4 * q + 3] = sv.w;
    }
  }
}

template <int D>
__device__ __forceinline__ void norm_rope_own_q(uint8_t* q_tile, int own0, int S, const QTables<D>& tb, float inv_d) {
  const int c = threadIdx.x & (Q_LANES<D> - 1);
#pragma unroll
  for (int ps = 0; ps < Q_PASSES<D>; ++ps) {
    const int r = q_row<D>(ps);
    const bool live = own0 + r < S;
    uint4* half[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int e = hf * D / 2 + 8 * c;  // the first element of the lane's chunk
      half[hf] = reinterpret_cast<uint4*>(q_tile + (e / PANEL) * PANEL_BYTES<WG_ROWS> + r * 128 +
                                          ((((e % PANEL) / 8) ^ (r & 7)) << 4));
    }
    uint4 raw[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) raw[hf] = live ? *half[hf] : make_uint4(0u, 0u, 0u, 0u);
    float x[16], s = 0.f, sq = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const bf16* xb = reinterpret_cast<const bf16*>(&raw[hf]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[8 * hf + e] = __bfloat162float(xb[e]);
        s += x[8 * hf + e];
        sq += x[8 * hf + e] * x[8 * hf + e];
      }
    }
#pragma unroll
    for (int off = 1; off < Q_LANES<D>; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    const float mean = s * inv_d;
    const float rs = rsqrtf(fmaxf(sq * inv_d - mean * mean, 0.f) + LN_EPS);
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float ya[2], yb[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float a = (x[e + v] - mean) * rs * tb.sc[e + v];          // x1 (element 8c + e)
        const float b = (x[8 + e + v] - mean) * rs * tb.sc[8 + e + v];  // x2 (D/2 + 8c + e)
        ya[v] = a * tb.cs[ps][e + v] - b * tb.sn[ps][e + v];  // rotate_half: (-x2, x1)
        yb[v] = b * tb.cs[ps][8 + e + v] + a * tb.sn[ps][8 + e + v];
      }
      lo[e / 2] = pack_bf16(ya[0], ya[1]);
      hi[e / 2] = pack_bf16(yb[0], yb[1]);
    }
    if (live) {
      *half[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *half[1] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
}

// One box of a 3-D tensor map from shared memory (the bulk async group of this
// thread); rows past the tensor's edge are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// 2^x on the MUFU alone: exp2f's own range step only keeps results below 2^-126
// (a P that no bf16 sum can feel) from flushing to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// O (64 x D) += P (64 x KT, bf16 fragments) . the stage's v tile (MN-major).
template <int D, int KT>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[KT / 16][4], const uint8_t* v_tile) {
  mma_rows<D, KT>(o, p, v_tile);
  wgmma_commit();
}

// What a launch walks the keys for: #1's one walk with a running max (ONLINE);
// #5's two launches, the exact row max and sum (STATS: k alone, no P.V; each
// row's m and 1/l parked in the first 8 bytes of its own output row), then P
// normalised with them (NORMALIZED: each block reads its rows' statistics back
// before its output overwrites them). Two launches, not two walks in one: with
// both walks in one function ptxas serialised every wgmma (C7511, "insufficient
// register resources for the wgmma pipeline"; #5 0.43 ms at the b2 512² call,
// of which the P.V walk alone 0.19).
enum FwdMode { ONLINE, STATS, NORMALIZED };

// grid: one block per (pair, tile of BLOCK_ROWS query rows), a pair's tiles
// adjacent, so that they read its k and v from L2 together. Step n streams key
// tile n: k and v, or k alone (STATS).
template <int D, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
split_wg_fwd_kernel(const __grid_constant__ FwdMaps maps, const split::FwdArgs a, const QNorm qn) {
  constexpr bool NORMALIZE = MODE == NORMALIZED;
  constexpr int KT = KEY_TILE<D>, OB = TILE_BYTES<D, WG_ROWS>, KB = TILE_BYTES<D, KT>;
  const float SC = a.hs.c;  // the softmax scale in the exp2 domain
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  uint8_t* own_q = smem;                   // [CONSUMERS][OB]; each warpgroup's output leaves through its own
  uint8_t* ring = own_q + CONSUMERS * OB;  // [FWD_STAGES][k KB | v KB]
  uint64_t* own_full = reinterpret_cast<uint64_t*>(ring + FWD_STAGES * 2 * KB);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + FWD_STAGES;
  const int S = a.S, steps = tiles_of(S, KT);
  const Block blk = block_of(S, a.H);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * blk.live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(own_full, CONSUMERS * OB);
      for (int w = 0; w < CONSUMERS; ++w)
        load_tile<D, WG_ROWS>(own_q + w * OB, &maps.q, own_full, (int)blk.b, blk.h, blk.row0 + w * WG_ROWS);
      constexpr bool with_v = MODE != STATS;
      for (int n = 0; n < steps; ++n) {
        const int stage = n % FWD_STAGES;
        mbar_wait(&empty[stage], ((n / FWD_STAGES) & 1) ^ 1);
        uint8_t* st = ring + stage * 2 * KB;
        mbar_expect_tx(&full[stage], with_v ? 2 * KB : KB);
        load_tile<D, KT>(st, &maps.k, &full[stage], (int)blk.b, blk.h, n * KT);
        if (with_v) load_tile<D, KT>(st + KB, &maps.v, &full[stage], (int)blk.b, blk.h, n * KT);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  if (wg >= blk.live) return;  // every row of this warpgroup is past S
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3, g = lane >> 2;
  uint8_t* q_tile = own_q + wg * OB;
  const int own0 = blk.row0 + wg * WG_ROWS;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, il[2] = {1.f, 1.f};
  // where row own0 + 16 warp + g + 8 r parks its statistics (STATS) or finds them
  auto stat_slot = [&](int r) {
    const long long i = own0 + 16 * warp + g + 8 * r;
    return reinterpret_cast<float2*>(a.out + ((blk.b * S + i) * a.H + blk.h) * D);
  };
  if constexpr (NORMALIZE) {  // a row past S: P = 0 (its output is never stored)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = own0 + 16 * warp + g + 8 * r < S;
      const float2 st = in ? *stat_slot(r) : make_float2(0.f, 0.f);
      m[r] = st.x, il[r] = st.y;
    }
  }
  const unsigned char* mask_row = a.mask == nullptr ? nullptr : a.mask + blk.b * S;
  Keep<KT> keep = load_keep<KT>(mask_row, S, 0);
  if (qn.scale != nullptr) {  // #1: q~ from the raw q rows, once (the LN + RoPE pass writes k~ alone)
    QTables<D> tables;
    load_q_tables<D>(tables, blk.row0 + wg * WG_ROWS, S, qn);
    mbar_wait(own_full, 0);
    norm_rope_own_q<D>(q_tile, blk.row0 + wg * WG_ROWS, S, tables, a.hs.inv_d);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for the products' reads of q (D = 128)
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  } else {
    mbar_wait(own_full, 0);
  }
  OwnFrags<D> qf;
  if constexpr (OWN_IN_REGS<D>) load_frags<D>(qf, q_tile);
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };
  // FlashAttention-3's ping-pong: a warpgroup issues its products only in its
  // turn and then hands the turn over, so that one warpgroup's softmax runs
  // under the other's products (both live: the same number of turns each)
  const bool pingpong = blk.live == CONSUMERS;
  auto take_turn = [&] {
    if (pingpong) asm volatile("bar.sync %0, 256;" ::"r"(TURN_BAR + wg) : "memory");
  };
  auto pass_turn = [&] {
    if (pingpong) asm volatile("bar.arrive %0, 256;" ::"r"(TURN_BAR + 1 - wg) : "memory");
  };
  if (pingpong && wg == 1) asm volatile("bar.arrive %0, 256;" ::"r"(TURN_BAR) : "memory");  // 0 goes first
  // Step n's scores, issued as one commit group: waits for its stage, takes the
  // next step's mask bytes while the product runs. Returns the tile's key bits.
  auto issue_scores = [&](float (&s)[KT / 2], int n) {
    mbar_wait(&full[n % FWD_STAGES], (n / FWD_STAGES) & 1);
    __syncwarp();
    fence_acc(s);
    wgmma_fence();
    scores<D, KT>(s, q_tile, qf, ring + (n % FWD_STAGES) * 2 * KB);
    wgmma_commit();
  };
  auto tile_bits = [&](int n) {
    const Keep<KT> kept = keep;
    if (n + 1 < steps) keep = load_keep<KT>(mask_row, S, (n + 1) * KT);
    return key_bits<KT>(kept, n * KT, S);
  };
  // The running max over a tile's masked scores; corr rescales what the earlier
  // tiles summed (0 on the first tile).
  auto step_max = [&](const float (&s)[KT / 2], float (&corr)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      corr[r] = exp2_ftz((m[r] - m_new) * SC);
      m[r] = m_new;
    }
  };
  // The scores to P in f32: #1 unnormalised against the running max (its sum
  // into l), #5 normalised with the exact max and sum of its first launch.
  auto softmax = [&](float (&s)[KT / 2], float (&corr)[2]) {
    if (!NORMALIZE) step_max(s, corr);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = exp2_ftz((s[e] - m[r]) * SC);
      if (NORMALIZE)
        s[e] *= il[r];  // P normalised before it is rounded
      else
        sum[r] += s[e];
    }
    if (!NORMALIZE) {
      l[0] = l[0] * corr[0] + sum[0];
      l[1] = l[1] * corr[1] + sum[1];
    }
  };

  if constexpr (MODE == STATS) {  // #5's first launch: k alone, the exact row max and sum
    for (int n = 0; n < steps; ++n) {
      // defined accumulators for the product's first step (which adds nothing to
      // them): left undefined, ptxas serialised this walk's wgmma (C7511; 9 %)
      float s[KT / 2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) s[e] = 0.f;
      take_turn();
      issue_scores(s, n);
      if (wg == 0 || n + 1 < steps) pass_turn();  // warpgroup 1's last turn hands over nothing
      const KeyBits<KT> bits = tile_bits(n);
      wgmma_wait_group<0>();
      fence_acc(s);
      release(n % FWD_STAGES);
      mask_tile<KT>(s, bits, n * KT, S);
      step_max(s, corr);
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) sum[(e >> 1) & 1] += exp2_ftz((s[e] - m[(e >> 1) & 1]) * SC);
      l[0] = l[0] * corr[0] + sum[0];
      l[1] = l[1] * corr[1] + sum[1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(l[r]);
      if (t == 0 && own0 + 16 * warp + g + 8 * r < S) *stat_slot(r) = make_float2(m[r], inv);
    }
    return;
  }

  // P.V's walk: tile n's P.V stays in flight under tile n + 1's scores and
  // softmax; the accumulators are rescaled once it is done
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t p[KT / 16][4];  // P of the last tile, bf16, the P.V product's A operand
  {
    float s[KT / 2], corr[2];
    take_turn();
    issue_scores(s, 0);
    pass_turn();
    const KeyBits<KT> bits = tile_bits(0);
    wgmma_wait_group<0>();
    fence_acc(s);
    mask_tile<KT>(s, bits, 0, S);
    softmax(s, corr);
    pack_frags<KT>(p, s);
  }
  for (int n = 1; n < steps; ++n) {
    float s[KT / 2], corr[2];
    const int last = (n - 1) % FWD_STAGES;
    take_turn();
    issue_scores(s, n);
    fence_acc(o);
    fence_regs(p);
    issue_pv<D, KT>(o, p, ring + last * 2 * KB + KB);
    pass_turn();
    const KeyBits<KT> bits = tile_bits(n);
    wgmma_wait_group<1>();
    fence_acc(s);
    mask_tile<KT>(s, bits, n * KT, S);
    softmax(s, corr);
    wgmma_wait_group<0>();
    fence_acc(o);
    fence_regs(p);
    release(last);
    if (!NORMALIZE) {  // online: rescale what the earlier tiles summed
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    }
    pack_frags<KT>(p, s);
  }
  take_turn();
  fence_acc(o);
  fence_regs(p);
  wgmma_fence();
  issue_pv<D, KT>(o, p, ring + ((steps - 1) % FWD_STAGES) * 2 * KB + KB);
  if (wg == 0) pass_turn();  // warpgroup 1's last turn is the last: no one takes it up
  wgmma_wait_group<0>();
  fence_acc(o);
  fence_regs(p);
  release((steps - 1) % FWD_STAGES);

  // the epilogue: O (with 1/l for #1) rounded to bf16 into the own q tile, laid
  // out as TMA's 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8):
  // the 8 rows g of a store are 8 chunks, so no two lanes share a bank), then
  // stored by TMA, which clips the rows past S
  float inv[2] = {1.f, 1.f};
  if (!NORMALIZE) {
    inv[0] = 1.f / quad_sum(l[0]);
    inv[1] = 1.f / quad_sum(l[1]);
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");  // the warpgroup's products are done with q
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      *reinterpret_cast<uint32_t*>(q_tile + (j / 8) * PANEL_BYTES<WG_ROWS> + row * 128 + (((j % 8) ^ g) << 4) +
                                   4 * t) = pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int pn = 0; pn < D / PANEL; ++pn)
      tma_store_3d(&maps.o, q_tile + pn * PANEL_BYTES<WG_ROWS>, blk.h * D + pn * PANEL, blk.row0 + wg * WG_ROWS,
                   (int)blk.b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // the tile stays until TMA has read it
  }
}

// normalize: P normalised before its rounding (#5) or not (#1 at S >= 128);
// qn: #1's LN + RoPE of q in the block (a.q then the raw q rows), or none.
template <int D>
cudaError_t launch_fwd(const split::FwdArgs& a, bool normalize, cudaStream_t stream, const QNorm& qn = {}) {
  static_assert(D == 64 || D == 128, "the wgmma split forward takes head dims 64 and 128");
  const long long blocks = grid(a.B, a.S, a.H);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  FwdMaps maps;
  const split::In out{a.out, (long long)a.H * D};
  const split::In* ins[4] = {&a.q, &a.k, &a.v, &out};
  CUtensorMap* outs[4] = {&maps.q, &maps.k, &maps.v, &maps.o};
  const int rows[4] = {WG_ROWS, KEY_TILE<D>, KEY_TILE<D>, WG_ROWS};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode_rows(outs[i], *ins[i], a.B, a.S, a.H, D, rows[i]);
    if (err != cudaSuccess) return err;
  }
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto run = [&](auto kernel) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(maps, a, qn);
    return cudaGetLastError();
  };
  if (!normalize) return run(&split_wg_fwd_kernel<D, ONLINE>);
  const cudaError_t err = run(&split_wg_fwd_kernel<D, STATS>);
  return err != cudaSuccess ? err : run(&split_wg_fwd_kernel<D, NORMALIZED>);
}

}  // namespace split_wg

// The split forward by head dim, as the plan picks it (ops/flash_attention.py:
// split_fwd_warps, split_fwd_grid): the launch above at 64 and 128,
// attention_split.cuh's mma.sync launch at 16 and 32.
template <int D>
cudaError_t launch_split_fwd(const split::FwdArgs& a, bool normalize, cudaStream_t stream) {
  if constexpr (D >= 64)
    return split_wg::launch_fwd<D>(a, normalize, stream);
  else
    return split::launch_fwd<D>(a, normalize, stream);
}

// #1 (and #7's attention): the LN + RoPE pass into work, then the forward on
// q~, k~ and qkv's v, P rounded unnormalised (JAX's unpacked path: the split
// variant runs S > 256, past its packed path's S < 128). At head dims 64 and
// 128 the pass writes k~ alone (work: B S H D bf16) and the forward's blocks
// normalise their own q rows, which they stage once; at 16 and 32 it writes
// q~ | k~ (work: 2 B S H D bf16) for the mma.sync forward.
template <int D>
cudaError_t launch_split_fused_fwd(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                                   const void* sin_t, const void* mask, void* out, void* work, int B, int S, int H,
                                   const HeadScale& hs, cudaStream_t stream) {
  if (work == nullptr) return cudaErrorInvalidValue;
  const long long HD = (long long)H * D;
  const bf16* raw = static_cast<const bf16*>(qkv);
  bf16* qn = D >= 64 ? nullptr : static_cast<bf16*>(work);
  bf16* kn = static_cast<bf16*>(work) + (D >= 64 ? 0 : (long long)B * S * HD);
  cudaError_t err = split::launch_norm_rope<D>(qkv, q_scale, k_scale, cos_t, sin_t, qn, kn, B, S, H, hs.inv_d, stream);
  if (err != cudaSuccess) return err;
  const split::FwdArgs a{D >= 64 ? split::In{raw, 3 * HD} : split::In{qn, HD}, {kn, HD}, {raw + 2 * HD, 3 * HD},
                         static_cast<const unsigned char*>(mask), static_cast<bf16*>(out), B, S, H, hs};
  if constexpr (D >= 64)
    return split_wg::launch_fwd<D>(a, false, stream,
                                   {static_cast<const float*>(q_scale), static_cast<const float*>(cos_t),
                                    static_cast<const float*>(sin_t)});
  else
    return split::launch_fwd<D>(a, false, stream);
}

}  // namespace fa_mma
