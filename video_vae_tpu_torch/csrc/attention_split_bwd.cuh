// The split variant's backward (#3, fused_attention_bwd.cu, and #6,
// flash_attention_bwd.cu, past 256 tokens) on Hopper's warpgroup tensor cores,
// for head dims 64 and 128: wgmma fed by TMA rings. It replaces the mma.sync
// launches of attention_split.cuh (split_bwd_query_kernel and
// split_bwd_key_kernel), which stay for head dims 16 and 32 only: their 32- and
// 64-byte rows are below the 128-byte swizzle span that every tile,
// descriptor and transpose read here is laid out on. The plan picks by head
// dim alone (ops/flash_attention.py:fused_attention_bwd_plan).
//
// What bounds it on the H100: the products. At the flagship's 512² spatial
// call (S = 1024, 8 heads of 64, b2: 256 pairs) the backward is 5 products of
// S^2 D a pair on paper (0.174 ms at the 989 TFLOP/s bf16 peak); this design
// runs 9, as the mma.sync launches do, so that no gradient is summed by
// atomics and two launches give the same bits: 309 GFLOP.
//
// Two launches of the same grid: a block owns BLOCK_ROWS = 128 rows of one
// (sequence, head) pair, 64 for each of two consumer warpgroups, and streams
// the other side's rows through a ring of STAGES stages. A third warpgroup is
// the producer: it gives its registers up (setmaxnreg 40; the consumers take
// 232) and one of its warps fills the ring, lane 0 with TMA boxes of 128
// bytes a row (64 columns, 128-byte swizzle; D = 128 takes two a tile)
// counted on the stage's `full` mbarrier by bytes, and (key side) all 32 lanes
// with the stage's per-query statistics by 4-byte cp.async, counted on the
// same mbarrier through cp.async.mbarrier.arrive. Each consumer warp frees a
// stage on its `empty` mbarrier once its products on it are done. The block's
// own rows are staged once, by TMA, on an mbarrier of their own. A row past S
// reads as zeros (the tensor maps are 3-D, B x S x H D, so a box never reaches
// into the next sequence).
//
//   query side (split_wg_query_kernel): q and dO own, k and v streamed in
//     tiles of KEY_TILE<D> keys (128 at D = 64, 64 at D = 128, as the f32
//     scores and dP of a tile fit the registers), two walks over the key
//     tiles. Walk 1: S = q k^T and dP = dO v^T by wgmma (both operands in
//     shared memory, K-major), then each row's running max m, sum l and
//     rs = sum_j exp(s - m) dP. Walk 2: the same two products, P and
//     dS = P (dP - row) / sqrt(D) in f32, then dq += dS k with dS rounded to
//     bf16 as the register A operand and k read MN-major (the transpose bit).
//     It writes dq and (m, 1/l, row) to the f32 workspace.
//   key side (split_wg_key_kernel): k and v own, q, dO and their statistics
//     streamed in tiles of QUERY_TILE = 64 queries, one walk. S^T = k q^T and
//     dP^T = v dO^T, P^T and dS^T in f32 registers, then dv += P^T dO and
//     dk += dS^T q with P^T and dS^T rounded to bf16 as the register A operand
//     and dO and q read MN-major.
// At D = 64 a warpgroup's own rows sit in registers as the score products' A
// operand (loaded once by ldmatrix through the swizzle), so those products read
// only B from shared memory; at 128 they stay in shared memory (their 64
// registers a thread do not fit beside the accumulators). Per tile a
// warpgroup issues its two score products as two commit groups and starts the
// softmax on the first while the second runs; the two warpgroups of a block
// overlap each other's elementwise work with their products.
// Measured no faster on the H100 (within 1 %; and the D = 128 key side's wgmma
// serialised for want of registers): leaving a tile's gradient products in
// flight under the next tile's scores, and 128 queries a key-side stage at
// D = 64.
//
// Roundings as attention_split.cuh's (and the tile variant's): P normalised
// with the exact max and sum in f32, then rounded to bf16 for dv; dS in f32,
// rounded to bf16 for dq and dk; each gradient rounded once. Masks: a masked
// key scores -1e30 (NEG_INF), a key past S -inf, so a row whose keys are all
// masked averages all S keys. A query past S reads zero q, dO and statistics,
// so its P and dS are 0.
//
// Operands: #3 passes q~ and k~ (the LN + RoPE pass's workspace), v strided in
// the fused qkv and dO; #6 four strided inputs. Every row stride reaches the
// kernels as a multiple of 8 elements at a 16-byte aligned base (the wrappers
// copy any other, ops/flash_attention.py:_rows_of_heads), which is TMA's rule,
// so every operand is a TMA tensor map; the entry point refuses any other.
//
// Shared memory of a block (own: 64 rows a warpgroup; 1 KB alignment slack,
// then the mbarriers):
//   query side: own q [2][64 x D] | own dO [2][64 x D] | ring [STAGES][k, v: KEY_TILE x D]
//   key side:   own k [2][64 x D] | own v [2][64 x D]  | ring [STAGES][q, dO: 64 x D],
//               then [STAGES][m, 1/l, row][64] f32
// 132 / 85 KB at D = 64 and 165 / 167 KB at 128: one block an SM (384
// threads). tests/helpers/split_geometry.py mirrors these sizes.

#pragma once

#include "attention_split.cuh"
#include "gemm_sm90.cuh"

namespace fa_mma {
namespace split_wg {

using vvt_sm90::fence_acc;
using vvt_sm90::mbar_arrive;
using vvt_sm90::mbar_expect_tx;
using vvt_sm90::mbar_init;
using vvt_sm90::mbar_wait;
using vvt_sm90::smem_addr;
using vvt_sm90::smem_desc;
using vvt_sm90::wgmma_commit;
using vvt_sm90::wgmma_fence;
using vvt_sm90::wgmma_wait_group;

constexpr int WG_ROWS = 64;                         // own rows of a consumer warpgroup
constexpr int CONSUMERS = 2;                        // consumer warpgroups a block
constexpr int BLOCK_ROWS = WG_ROWS * CONSUMERS;     // a block's own rows
template <int D> constexpr int KEY_TILE = D == 64 ? 128 : 64;  // keys a query-side stage holds
constexpr int QUERY_TILE = 64;                                 // queries a key-side stage holds
constexpr int STAGES = 3;                           // ring stages
constexpr int THREADS = 128 * (CONSUMERS + 1);      // the consumers, then the producer
constexpr int WARPS = THREADS / 32;                 // the plan's warps (ops/flash_attention.py)
constexpr int PANEL = 64;                           // columns of a TMA box: 128 bytes, the swizzle span
constexpr int ALIGN = 1024;                         // a 128-byte swizzled tile starts on 1024 bytes
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
template <int R> constexpr int PANEL_BYTES = R * PANEL * 2;                  // one box: R rows x 64 columns
template <int D, int R> constexpr int TILE_BYTES = (D / PANEL) * PANEL_BYTES<R>;  // R rows of one operand

__host__ __device__ __forceinline__ int row_tiles(int S) { return (S + BLOCK_ROWS - 1) / BLOCK_ROWS; }
__host__ __device__ __forceinline__ int tiles_of(int S, int rows) { return (S + rows - 1) / rows; }

template <int D>
__host__ __device__ constexpr size_t own_bytes() { return (size_t)2 * CONSUMERS * TILE_BYTES<D, WG_ROWS>; }
constexpr size_t STAT_BYTES = (size_t)STAGES * 3 * QUERY_TILE * sizeof(float);
constexpr size_t BAR_BYTES = (size_t)(1 + 2 * STAGES) * 8;
template <int D>
__host__ __device__ constexpr size_t query_smem_bytes() {
  return ALIGN + own_bytes<D>() + (size_t)STAGES * 2 * TILE_BYTES<D, KEY_TILE<D>> + BAR_BYTES;
}
template <int D>
__host__ __device__ constexpr size_t key_smem_bytes() {
  return ALIGN + own_bytes<D>() + (size_t)STAGES * 2 * TILE_BYTES<D, QUERY_TILE> + STAT_BYTES + BAR_BYTES;
}
static_assert(query_smem_bytes<128>() <= (size_t)MAX_SMEM && key_smem_bytes<128>() <= (size_t)MAX_SMEM,
              "a D = 128 block fits the H100");

// ---- PTX ------------------------------------------------------------------------

// One box of a 3-D tensor map into shared memory; its bytes count on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 4 bytes to shared memory (zeros where src_bytes is 0), and the arrival on
// `bar` once every cp.async of this thread before it has landed.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Keeps registers that an in-flight wgmma reads from being reused before its wait.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

#define VVT_WG_ACC8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N a warpgroup, f32) = [d +] A (64 x 16) . B (16 x N), both from
// shared memory, both K-major; `accumulate` 0 on a product's first k step.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : VVT_WG_ACC8(0), VVT_WG_ACC8(8), VVT_WG_ACC8(16), VVT_WG_ACC8(24)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : VVT_WG_ACC8(0), VVT_WG_ACC8(8), VVT_WG_ACC8(16), VVT_WG_ACC8(24), VVT_WG_ACC8(32),
          VVT_WG_ACC8(40), VVT_WG_ACC8(48), VVT_WG_ACC8(56)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// d (64 x N a warpgroup, f32) = [d +] A (64 x 16, bf16 in registers: wgmma's
// A fragment, as mma.sync's m16n8k16 for each warp's 16 rows) . B (16 x N, from
// shared memory; TRANS_B 1: MN-major, the transpose bit; 0: K-major);
// `accumulate` 0 on a product's first k step.
template <int N, int TRANS_B>
struct WgmmaRS;

template <int TRANS_B>
struct WgmmaRS<64, TRANS_B> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : VVT_WG_ACC8(0), VVT_WG_ACC8(8), VVT_WG_ACC8(16), VVT_WG_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TRANS_B));
  }
};

template <int TRANS_B>
struct WgmmaRS<128, TRANS_B> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : VVT_WG_ACC8(0), VVT_WG_ACC8(8), VVT_WG_ACC8(16), VVT_WG_ACC8(24), VVT_WG_ACC8(32),
          VVT_WG_ACC8(40), VVT_WG_ACC8(48), VVT_WG_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TRANS_B));
  }
};

#undef VVT_WG_ACC8

// ---- tiles ----------------------------------------------------------------------

// A tile of R rows of one operand, K-major: k16 step kk of a product over D
// (its D / 64 panels of R rows x 128 bytes, 8-row groups 1024 bytes apart).
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int kk) {
  return smem_desc(tile + (kk / 4) * PANEL_BYTES<R> + (kk % 4) * 32, 16, 1024);
}
// The same tile as the MN-major B of a product over its R rows (N = D): k16
// step kq is rows 16 kq .. + 15; the panels lie PANEL_BYTES<R> apart.
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int kq) {
  return smem_desc(tile + kq * 16 * 128, PANEL_BYTES<R>, 1024);
}

// The tile's D / 64 boxes (the map's box: R rows): rows i0 .. i0 + R - 1 of pair (b, h).
template <int D, int R>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int b, int h,
                                          int i0) {
#pragma unroll
  for (int p = 0; p < D / PANEL; ++p) tma_load_3d(dst + p * PANEL_BYTES<R>, map, bar, h * D + p * PANEL, i0, b);
}

// A warpgroup's 64 own rows of a K-major tile as wgmma A fragments, one a k16
// step: warp w's rows 16 w .. + 15 through ldmatrix, whose lane addresses undo
// the 128-byte swizzle (16-byte chunk c of row r lies at chunk c ^ (r % 8)).
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&f)[D / 16][4], const uint8_t* own_tile) {
  const int lane = threadIdx.x & 31, r = 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 2 * (kk % 4) + (lane >> 4);
    ldsm_x4(f[kk], reinterpret_cast<const bf16*>(own_tile + (kk / 4) * PANEL_BYTES<WG_ROWS> + r * 128 +
                                                 ((c ^ (r & 7)) << 4)));
  }
}

// The own rows of a score product: at D = 64 in registers (measured 5 % faster
// at the 512² calls on the H100 than both operands from shared memory), at 128
// in shared memory.
template <int D> constexpr bool OWN_IN_REGS = D == 64;
template <int D> using OwnFrags = uint32_t[OWN_IN_REGS<D> ? D / 16 : 1][4];

// Score products of a warpgroup's 64 own rows (own_tile, or their fragments)
// against a tile's N rows: d = A . B^T over D.
template <int D, int N>
__device__ __forceinline__ void scores(float (&d)[N / 2], const uint8_t* own_tile, const OwnFrags<D>& own,
                                       const uint8_t* tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (OWN_IN_REGS<D>)
      WgmmaRS<N, 0>::mma(d, own[kk], kmajor_desc<N>(tile, kk), kk > 0);
    else
      WgmmaSS<N>::mma(d, kmajor_desc<WG_ROWS>(own_tile, kk), kmajor_desc<N>(tile, kk), kk > 0);
  }
}

// 64 x N f32 accumulators (wgmma's layout: d[4 j + 2 r + c] is row
// 16 warp + g + 8 r, column 8 j + 2 t + c) rounded to bf16 as the A fragments
// of the N / 16 k16 steps over their columns.
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq) {
    a[kq][0] = pack_bf16(d[8 * kq + 0], d[8 * kq + 1]);
    a[kq][1] = pack_bf16(d[8 * kq + 2], d[8 * kq + 3]);
    a[kq][2] = pack_bf16(d[8 * kq + 4], d[8 * kq + 5]);
    a[kq][3] = pack_bf16(d[8 * kq + 6], d[8 * kq + 7]);
  }
}

// acc (64 x D) += A (64 x R, fragments a) . the tile's R rows (MN-major).
template <int D, int R>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 2], const uint32_t (&a)[R / 16][4], const uint8_t* tile) {
#pragma unroll
  for (int kq = 0; kq < R / 16; ++kq) WgmmaRS<D, 1>::mma(acc, a[kq], mnmajor_desc<R>(tile, kq), 1);
}

// A warpgroup's 64 rows of f32 accumulators (64 x D) to dst, rounded to T, the
// rows row0 + .. below S: lane (g, t) of warp w stores columns 8 j + 2 t, + 1
// of rows 16 w + g and + 8.
template <int D, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], T* __restrict__ dst, long long stride, int row0,
                                           int S) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3, g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 16 * warp + g + 8 * r;
    if (i >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      T* at = dst + i * stride + 8 * j + 2 * t;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      else
        *reinterpret_cast<float2*>(at) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// Which of N keys j0 .. j0 + N - 1 are kept (below S, and kept by the mask row,
// where there is one): lane's keys j0 + lane + 32 i, loaded a tile ahead and
// ballotted into the tile's key bits (bit (j - j0) % 64 of word (j - j0) / 64)
// when it is taken.
template <int N>
struct Keep {
  bool k[N / 32];
};
template <int N>
__device__ __forceinline__ Keep<N> load_keep(const unsigned char* __restrict__ mask_row, int S, int j0) {
  Keep<N> out;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const int j = j0 + (threadIdx.x & 31) + 32 * i;
    out.k[i] = j < S && (mask_row == nullptr || mask_row[j]);
  }
  return out;
}

// A tile's key bits (bit (j - j0) % 64 of word (j - j0) / 64 set where key j is
// kept), ballotted from `kept`, and whether every key of the tile is kept and
// below S. Every lane of the warp calls it.
template <int N>
struct KeyBits {
  unsigned long long word[N / 64];
  bool all_kept;
};
template <int N>
__device__ __forceinline__ KeyBits<N> key_bits(const Keep<N>& kept, int j0, int S) {
  KeyBits<N> out;
  out.all_kept = j0 + N <= S;
#pragma unroll
  for (int w = 0; w < N / 64; ++w) {
    out.word[w] = (unsigned long long)__ballot_sync(0xffffffffu, kept.k[2 * w]) |
                  ((unsigned long long)__ballot_sync(0xffffffffu, kept.k[2 * w + 1]) << 32);
    out.all_kept = out.all_kept && out.word[w] == ~0ull;
  }
  return out;
}

// Mask a warpgroup's 64 x N scores of keys j0 .. j0 + N - 1 (wgmma's layout:
// s[4 j + 2 r + c] is column 8 j + 2 t + c): a masked key NEG_INF, a key past S
// -inf.
template <int N>
__device__ __forceinline__ void mask_tile(float (&s)[N / 2], const KeyBits<N>& bits, int j0, int S) {
  if (bits.all_kept) return;
  const int t = threadIdx.x & 3;
  if (j0 + N > S) {  // the last tile of a ragged S
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int jl = 8 * (e / 4) + 2 * t + (e & 1);
      s[e] = j0 + jl >= S ? -INFINITY : ((bits.word[e / 32] >> (jl & 63)) & 1ull) ? s[e] : NEG_INF;
    }
  } else {  // this lane's columns 2 t + 8 j + c of each word: constant shifts
#pragma unroll
    for (int w = 0; w < N / 64; ++w) {
      const unsigned long long mine = bits.word[w] >> (2 * t);
#pragma unroll
      for (int e = 32 * w; e < 32 * w + 32; ++e)
        s[e] = ((mine >> (8 * ((e / 4) % 8) + (e & 1))) & 1ull) ? s[e] : NEG_INF;
    }
  }
}

struct Maps {
  CUtensorMap q, k, v, g;
};

// The block's pair, first own row, consumer warpgroups with rows below S.
struct Block {
  long long pair, b;
  int h, row0, live;
};

__device__ __forceinline__ Block block_of(int S, int H) {
  const int tiles = row_tiles(S);
  Block k;
  k.pair = blockIdx.x / tiles;
  k.b = k.pair / H;
  k.h = (int)(k.pair % H);
  k.row0 = (int)(blockIdx.x % tiles) * BLOCK_ROWS;
  k.live = min(CONSUMERS, (S - k.row0 + WG_ROWS - 1) / WG_ROWS);
  return k;
}

// ---- query side: statistics and dq ---------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
split_wg_query_kernel(const __grid_constant__ Maps maps, const split::BwdArgs<T> a) {
  constexpr int KT = KEY_TILE<D>, OB = TILE_BYTES<D, WG_ROWS>, KB = TILE_BYTES<D, KT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  uint8_t* own_q = smem;                       // [CONSUMERS][OB]
  uint8_t* own_do = own_q + CONSUMERS * OB;    // [CONSUMERS][OB]
  uint8_t* ring = own_do + CONSUMERS * OB;     // [STAGES][k KB | v KB]
  uint64_t* own_full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * KB);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;
  const int S = a.S, tiles = tiles_of(S, KT), steps = 2 * tiles;
  const Block blk = block_of(S, a.H);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * blk.live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(own_full, 2 * CONSUMERS * OB);
      for (int w = 0; w < CONSUMERS; ++w) {
        load_tile<D, WG_ROWS>(own_q + w * OB, &maps.q, own_full, (int)blk.b, blk.h, blk.row0 + w * WG_ROWS);
        load_tile<D, WG_ROWS>(own_do + w * OB, &maps.g, own_full, (int)blk.b, blk.h, blk.row0 + w * WG_ROWS);
      }
      for (int n = 0; n < steps; ++n) {
        const int stage = n % STAGES, j0 = (n % tiles) * KT;
        mbar_wait(&empty[stage], ((n / STAGES) & 1) ^ 1);
        uint8_t* st = ring + stage * 2 * KB;
        mbar_expect_tx(&full[stage], 2 * KB);
        load_tile<D, KT>(st, &maps.k, &full[stage], (int)blk.b, blk.h, j0);
        load_tile<D, KT>(st + KB, &maps.v, &full[stage], (int)blk.b, blk.h, j0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  if (wg >= blk.live) return;  // every row of this warpgroup is past S
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3, g = lane >> 2;
  const uint8_t* q_tile = own_q + wg * OB;
  const uint8_t* do_tile = own_do + wg * OB;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  float il[2] = {0.f, 0.f}, row[2] = {0.f, 0.f}, stat[2][3];
  const unsigned char* mask_row = a.mask == nullptr ? nullptr : a.mask + blk.b * S;
  Keep<KT> keep = load_keep<KT>(mask_row, S, 0);
  mbar_wait(own_full, 0);
  OwnFrags<D> qf, df;
  if constexpr (OWN_IN_REGS<D>) {
    load_frags<D>(qf, q_tile);
    load_frags<D>(df, do_tile);
  }
  for (int n = 0; n < steps; ++n) {
    const int stage = n % STAGES, j0 = (n % tiles) * KT;
    const bool first_walk = n < tiles;
    const Keep<KT> kept = keep;
    if (n + 1 < steps) keep = load_keep<KT>(mask_row, S, ((n + 1) % tiles) * KT);
    if (n == tiles) bwd::finish_stats(m, l, rs, il, row, stat);
    const uint8_t* k_tile = ring + stage * 2 * KB;
    const uint8_t* v_tile = k_tile + KB;
    mbar_wait(&full[stage], (n / STAGES) & 1);
    __syncwarp();
    float s[KT / 2], dp[KT / 2];
    wgmma_fence();
    scores<D, KT>(s, q_tile, qf, k_tile);
    wgmma_commit();
    scores<D, KT>(dp, do_tile, df, v_tile);
    wgmma_commit();
    const KeyBits<KT> bits = key_bits<KT>(kept, j0, S);  // while the products run
    wgmma_wait_group<1>();
    fence_acc(s);
    mask_tile<KT>(s, bits, j0, S);
    if (first_walk) {  // m, l and sum_j exp(s - m) dP, online
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        corr[r] = exp2f((m[r] - m_new) * a.hs.c);  // 0 on the first tile
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f((s[4 * j + 2 * r + c] - m_new) * a.hs.c);
            s[4 * j + 2 * r + c] = p;
            sum += p;
          }
        l[r] = l[r] * corr[r] + sum;
        m[r] = m_new;
      }
      wgmma_wait_group<0>();
      fence_acc(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) acc += s[4 * j + 2 * r + c] * dp[4 * j + 2 * r + c];
        rs[r] = rs[r] * corr[r] + acc;
      }
    } else {  // P (normalised, f32), dS, dq += dS (bf16) . k
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) s[e] = exp2f((s[e] - m[(e >> 1) & 1]) * a.hs.c) * il[(e >> 1) & 1];
      wgmma_wait_group<0>();
      fence_acc(dp);
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) dp[e] = s[e] * (dp[e] - row[(e >> 1) & 1]) * a.hs.scale;
      uint32_t ds[KT / 16][4];
      pack_frags<KT>(ds, dp);
      wgmma_fence();
      mma_rows<D, KT>(dq, ds, k_tile);
      wgmma_commit();
      wgmma_wait_group<0>();
      fence_acc(dq);
      fence_regs(ds);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    __syncwarp();
  }
  const int own0 = blk.row0 + wg * WG_ROWS;
  if (t == 0) {
    const long long rows = (long long)a.B * a.H * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = own0 + 16 * warp + g + 8 * r;
      if (i < S) {
        const long long me = blk.pair * S + i;
        a.stats[me] = stat[r][0], a.stats[rows + me] = stat[r][1], a.stats[2 * rows + me] = stat[r][2];
      }
    }
  }
  store_rows<D, T>(dq, a.dq.base + blk.b * a.dq.b_stride + blk.h * a.dq.h_stride, a.dq.i_stride, own0, S);
}

// ---- key side: dk and dv ---------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
split_wg_key_kernel(const __grid_constant__ Maps maps, const split::BwdArgs<T> a) {
  constexpr int QT = QUERY_TILE, OB = TILE_BYTES<D, WG_ROWS>, QB = TILE_BYTES<D, QT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  uint8_t* own_k = smem;                       // [CONSUMERS][OB]
  uint8_t* own_v = own_k + CONSUMERS * OB;     // [CONSUMERS][OB]
  uint8_t* ring = own_v + CONSUMERS * OB;      // [STAGES][q QB | dO QB]
  float* stat_s = reinterpret_cast<float*>(ring + STAGES * 2 * QB);  // [STAGES][m, 1/l, row][QT]
  uint64_t* own_full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * QB + STAT_BYTES);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;
  const int S = a.S, tiles = tiles_of(S, QT);
  const Block blk = block_of(S, a.H);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA boxes' arrival and the producer warp's cp.async
      mbar_init(&empty[s], 4 * blk.live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 128 * CONSUMERS + 32) {
      const int lane = threadIdx.x & 31;
      const long long rows = (long long)a.B * a.H * S;
      const float* pair_stats = a.stats + blk.pair * S;
      if (lane == 0) {
        mbar_expect_tx(own_full, 2 * CONSUMERS * OB);
        for (int w = 0; w < CONSUMERS; ++w) {
          load_tile<D, WG_ROWS>(own_k + w * OB, &maps.k, own_full, (int)blk.b, blk.h, blk.row0 + w * WG_ROWS);
          load_tile<D, WG_ROWS>(own_v + w * OB, &maps.v, own_full, (int)blk.b, blk.h, blk.row0 + w * WG_ROWS);
        }
      }
      for (int n = 0; n < tiles; ++n) {
        const int stage = n % STAGES, i0 = n * QT;
        mbar_wait(&empty[stage], ((n / STAGES) & 1) ^ 1);
        uint8_t* st = ring + stage * 2 * QB;
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * QB);
          load_tile<D, QT>(st, &maps.q, &full[stage], (int)blk.b, blk.h, i0);
          load_tile<D, QT>(st + QB, &maps.g, &full[stage], (int)blk.b, blk.h, i0);
        }
        float* dst = stat_s + stage * 3 * QT;
        for (int e = lane; e < 3 * QT; e += 32) {  // a query past S: zeros (its P is 0)
          const int part = e / QT, i = i0 + e % QT;
          cp_async4(dst + e, i < S ? pair_stats + part * rows + i : a.stats, i < S ? 4 : 0);
        }
        cp_async_arrive(&full[stage]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  if (wg >= blk.live) return;  // every key of this warpgroup is past S
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3, g = lane >> 2;
  const int own0 = blk.row0 + wg * WG_ROWS;
  const uint8_t* k_tile = own_k + wg * OB;
  const uint8_t* v_tile = own_v + wg * OB;
  bool masked[2];  // keys own0 + 16 warp + g (+ 8): masked, or past S (whose rows are not written)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = own0 + 16 * warp + g + 8 * r;
    masked[r] = j >= S || (a.mask != nullptr && !a.mask[blk.b * S + j]);
  }
  float dv[D / 2], dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;
  mbar_wait(own_full, 0);
  OwnFrags<D> kf, vf;
  if constexpr (OWN_IN_REGS<D>) {
    load_frags<D>(kf, k_tile);
    load_frags<D>(vf, v_tile);
  }
  for (int n = 0; n < tiles; ++n) {
    const int stage = n % STAGES;
    const uint8_t* q_tile = ring + stage * 2 * QB;
    const uint8_t* do_tile = q_tile + QB;
    const float* st = stat_s + stage * 3 * QT;
    mbar_wait(&full[stage], (n / STAGES) & 1);
    __syncwarp();
    float s[QT / 2], dp[QT / 2];
    wgmma_fence();
    scores<D, QT>(s, k_tile, kf, q_tile);  // S^T: keys by queries
    wgmma_commit();
    scores<D, QT>(dp, v_tile, vf, do_tile);  // dP^T
    wgmma_commit();
    wgmma_wait_group<1>();
    fence_acc(s);
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {  // P^T, normalised, f32: columns 8 j + 2 t, + 1 are queries
      const float2 mi = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
      const float2 inv = *reinterpret_cast<const float2*>(st + QT + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& p0 = s[4 * j + 2 * r];
        float& p1 = s[4 * j + 2 * r + 1];
        p0 = exp2f(((masked[r] ? NEG_INF : p0) - mi.x) * a.hs.c) * inv.x;
        p1 = exp2f(((masked[r] ? NEG_INF : p1) - mi.y) * a.hs.c) * inv.y;
      }
    }
    wgmma_wait_group<0>();
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {  // dS^T, f32
      const float2 rw = *reinterpret_cast<const float2*>(st + 2 * QT + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dp[4 * j + 2 * r] = s[4 * j + 2 * r] * (dp[4 * j + 2 * r] - rw.x) * a.hs.scale;
        dp[4 * j + 2 * r + 1] = s[4 * j + 2 * r + 1] * (dp[4 * j + 2 * r + 1] - rw.y) * a.hs.scale;
      }
    }
    uint32_t pa[QT / 16][4], da[QT / 16][4];
    pack_frags<QT>(pa, s);
    pack_frags<QT>(da, dp);
    wgmma_fence();
    mma_rows<D, QT>(dv, pa, do_tile);  // dv += P^T (bf16) . dO
    mma_rows<D, QT>(dk, da, q_tile);   // dk += dS^T (bf16) . q
    wgmma_commit();
    wgmma_wait_group<0>();
    fence_acc(dv);
    fence_acc(dk);
    fence_regs(pa);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    __syncwarp();
  }
  store_rows<D, bf16>(dv, a.dv.base + blk.b * a.dv.b_stride + blk.h * a.dv.h_stride, a.dv.i_stride, own0, S);
  store_rows<D, T>(dk, a.dk.base + blk.b * a.dk.b_stride + blk.h * a.dk.h_stride, a.dk.i_stride, own0, S);
}

// ---- host --------------------------------------------------------------------------

// One (B, S, H, D) operand as a 3-D tensor map (H D columns, S rows, B
// sequences; rows `stride` elements apart) cut in boxes of `rows` rows by 64
// columns, 128-byte swizzle, zeros past S. TMA's rule: a 16-byte aligned base
// and row stride.
inline cudaError_t encode_rows(CUtensorMap* map, const split::In& in, int B, int S, int H, int D, int rows) {
  const vvt_sm90::EncodeTiledFn encode = vvt_sm90::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (in.stride % 8 != 0 || reinterpret_cast<uintptr_t>(in.base) % 16 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)in.stride * 2, (cuuint64_t)in.stride * 2 * S};
  const cuuint32_t box[3] = {PANEL, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(in.base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The four operands' maps for one launch: q and dO in boxes of q_rows rows, k
// and v of k_rows.
inline cudaError_t encode_maps(Maps* maps, const split::In (&ins)[4], int B, int S, int H, int D, int q_rows,
                               int k_rows) {
  CUtensorMap* outs[4] = {&maps->q, &maps->k, &maps->v, &maps->g};
  const int rows[4] = {q_rows, k_rows, k_rows, q_rows};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode_rows(outs[i], ins[i], B, S, H, D, rows[i]);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Blocks of each launch: a pair's row tiles adjacent, so that they read its
// streamed side from L2 together.
inline long long grid(int B, int S, int H) { return (long long)B * H * row_tiles(S); }

// Both sides, query side first (the key side reads its statistics).
template <int D, typename T>
cudaError_t launch_bwd(const split::BwdArgs<T>& a, cudaStream_t stream) {
  static_assert(D == 64 || D == 128, "the wgmma split backward takes head dims 64 and 128");
  const long long blocks = grid(a.B, a.S, a.H);
  if (blocks > 0x7fffffffLL || a.stats == nullptr) return cudaErrorInvalidValue;
  const split::In ins[4] = {a.q, a.k, a.v, a.g};
  Maps query_maps, key_maps;
  cudaError_t err = encode_maps(&query_maps, ins, a.B, a.S, a.H, D, WG_ROWS, KEY_TILE<D>);
  if (err != cudaSuccess) return err;
  err = encode_maps(&key_maps, ins, a.B, a.S, a.H, D, QUERY_TILE, WG_ROWS);
  if (err != cudaSuccess) return err;
  auto query = split_wg_query_kernel<D, T>;
  constexpr size_t q_smem = query_smem_bytes<D>(), k_smem = key_smem_bytes<D>();
  err = cudaFuncSetAttribute(query, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return err;
  query<<<(unsigned)blocks, THREADS, q_smem, stream>>>(query_maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto key = split_wg_key_kernel<D, T>;
  err = cudaFuncSetAttribute(key, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k_smem);
  if (err != cudaSuccess) return err;
  key<<<(unsigned)blocks, THREADS, k_smem, stream>>>(key_maps, a);
  return cudaGetLastError();
}

}  // namespace split_wg

// The split backward by head dim, as the plan picks it (ops/flash_attention.py:
// fused_attention_bwd_plan): the launches above at 64 and 128,
// attention_split.cuh's mma.sync launches at 16 and 32. Warps a block and
// blocks a launch, which the entry points hold the plan to, and the launch.
template <int D>
constexpr int split_bwd_warps() { return D >= 64 ? split_wg::WARPS : split::WARPS; }

template <int D>
long long split_bwd_grid(int B, int S, int H) {
  return D >= 64 ? split_wg::grid(B, S, H) : (long long)B * H * split::tiles_of(S);
}

template <int D, typename T>
cudaError_t launch_split_bwd(const split::BwdArgs<T>& a, cudaStream_t stream) {
  if constexpr (D >= 64)
    return split_wg::launch_bwd<D, T>(a, stream);
  else
    return split::launch_bwd<D, T>(a, stream);
}

}  // namespace fa_mma
