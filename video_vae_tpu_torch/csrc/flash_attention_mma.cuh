// Device code of the bf16 plain attention forward on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators). The design note is in
// flash_attention.cu. launch_flash_mma() enqueues the kernel on a stream and
// returns the launch's cudaError_t. Its warps run the fused forward's softmax
// (fa_mma::attend in fused_attention_mma.cuh) with P normalised before its
// rounding at every S, on q, k and v as they are, with no LN or RoPE; the
// geometry, the shared-memory layout and its size are the fused forward's:
//   slab: per sequence of the block, q | k | v, each [head][row], then the key
//         bits of every sequence;
//   tile: k [row] | v [row] | q [row] of one (sequence, head) pair, then the
//         pair's key bits.
// Rows of D bf16 in D + 8-element rows (144 bytes at D = 64), staged in 16-row
// units, a row past the sequence zero-filled (a padding key's v row adds exactly 0).

#pragma once

#include "fused_attention_mma.cuh"

namespace fa_mma {
namespace flash_fwd {

struct Args {
  const bf16* q;  // each input (B, S, H, D), row (b, i) at base + (b S + i) stride
  const bf16* k;
  const bf16* v;
  const unsigned char* mask;  // (B, S) or null
  bf16* out;                  // (B, S, H, D), contiguous
  long long q_stride, k_stride, v_stride;
  int B, S, H, unit;
  HeadScale hs;  // the true head dim's softmax scale (its 1/d is not read here)
};

// cp.async the 16-byte piece `piece` of row i of head h of sequence b of
// input `part` (0 q, 1 k, 2 v) to dst; zero-filled where `inside` is false.
template <int D>
__device__ __forceinline__ void copy_piece(bf16* dst, const Args& a, int part, long long b, int i, int h, int piece,
                                           bool inside) {
  const bf16* src = part == 0 ? a.q : part == 1 ? a.k : a.v;
  const long long stride = part == 0 ? a.q_stride : part == 1 ? a.k_stride : a.v_stride;
  cp_async16(dst, inside ? src + (b * a.S + i) * stride + h * D + 8 * piece : src, inside ? 16 : 0);
}

// grid: slab, one block per `unit` sequences, its warps taking the 16-row query
// tiles of every head in turn; tile, one block per (sequence, head) pair, a warp
// for each 16 of its query rows (up to FWD_WARPS<D>, each then taking the tiles
// in turn). Every q, k and v row of the block is copied in
// one cp.async group before any warp starts. tests/test_torch_flash_plan.py
// walks the same items on the CPU.
template <int D, int KT>
__global__ void __launch_bounds__(FWD_WARPS<D> * 32) flash_fwd_kernel(const Args a, int variant) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  constexpr int ROW = fa_mma::ROW<D>, P = PIECES<D>;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int S = a.S, H = a.H, s16 = rows16(S), words = key_words(S);
  const size_t out_row = (size_t)H * D;  // elements of one (b, i) row of the output

  if (variant == SLAB) {
    const int unit = a.unit;
    const long long seq0 = (long long)blockIdx.x * unit;
    const size_t head_rows = (size_t)s16 * ROW, seq_elems = 3 * (size_t)H * head_rows;
    auto row_of = [&](int sl, int part, int h, int i) {  // [sequence][part][head][row]
      return smem + sl * seq_elems + (part * H + h) * head_rows + (size_t)i * ROW;
    };
    unsigned long long* keep = reinterpret_cast<unsigned long long*>(smem + unit * seq_elems);
    // Thread p copies one 16-byte piece of one head row, (input, head, piece)
    // = (p / PH, p / P % H, p % P), at every position of the block's sequences:
    // consecutive threads take consecutive pieces of a position's heads of one
    // input, adjacent in memory, and no index is divided inside the loops.
    for (int p = threadIdx.x; p < 3 * H * P; p += blockDim.x) {
      const int piece = p % P, part = (p / P) / H, h = (p / P) % H;
      for (int sl = 0; sl < unit; ++sl) {
        const long long b = seq0 + sl;
        for (int i = 0; i < s16; ++i)
          copy_piece<D>(row_of(sl, part, h, i) + 8 * piece, a, part, b, i, h, piece, b < a.B && i < S);
      }
    }
    cp_async_commit();
    for (int sl = 0; sl < unit; ++sl)
      stage_key_bits(keep + sl * words, a.mask, seq0 + sl < a.B ? seq0 + sl : 0, S, warp, warps);
    cp_async_wait<0>();
    __syncthreads();
    const int tiles = s16 / 16, items = unit * H * tiles;
    for (int it = warp; it < items; it += warps) {
      const int mt = it % tiles, h = (it / tiles) % H, sl = it / (tiles * H);
      const long long b = seq0 + sl;
      if (b >= a.B) continue;
      attend<D, KT>(row_of(sl, 0, h, 16 * mt), row_of(sl, 1, h, 0), row_of(sl, 2, h, 0), keep + sl * words, S, true,
                    a.out + (size_t)b * S * out_row + h * D, 16 * mt, H, a.hs.c);
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
  // a row's 8 pieces on consecutive threads; each thread steps down the rows
  const int piece = threadIdx.x % P, row_step = blockDim.x / P;
  for (int part = 0; part < 3; ++part) {
    bf16* rows = part == 0 ? q_s : part == 1 ? k_s : v_s;
    for (int i = threadIdx.x / P; i < s16; i += row_step)
      copy_piece<D>(rows + (size_t)i * ROW + 8 * piece, a, part, b, i, h, piece, i < S);
  }
  cp_async_commit();
  stage_key_bits(keep, a.mask, b, S, warp, warps);
  cp_async_wait<0>();
  __syncthreads();
  // warps = min(rows16(S) / 16, FWD_WARPS<D>), so every warp has query rows
  for (int mt = warp; 16 * mt < S; mt += warps)
    attend<D, KT>(q_s + (size_t)16 * mt * ROW, k_s, v_s, keep, S, true, a.out + (size_t)b * S * out_row + h * D,
                  16 * mt, H, a.hs.c);
}

template <int D, int KT>
cudaError_t launch_kt(const Args& a, int variant, int warps, int smem, unsigned blocks, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * warps, smem, stream>>>(a, variant);
  return cudaGetLastError();
}

// Checks the plan (ops/flash_attention.py:flash_attention_plan: the variant, and
// the sequences a slab block) against the shape, derives the rest as
// launch_attention_mma does, and launches.
template <int D>
cudaError_t launch_flash_mma(const Args& a, int variant, cudaStream_t stream) {
  const int S = a.S, H = a.H;
  const long long tiles = rows16(S) / 16;  // 16-row query tiles of one head
  long long blocks, warps;
  if (variant == SLAB) {
    if (S > SLAB_MAX_SEQ || a.unit < 1) return cudaErrorInvalidValue;
    blocks = ((long long)a.B + a.unit - 1) / a.unit;
    warps = std::min<long long>(SLAB_WARPS, (long long)a.unit * H * tiles);
  } else if (variant == TILE) {
    if (a.unit != 1 || S > TILE_MAX_SEQ) return cudaErrorInvalidValue;
    blocks = (long long)a.B * H;
    warps = std::min<long long>(tiles, FWD_WARPS<D>);  // tiles <= 16, as S <= 256
  } else {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<D>(variant, S, H, a.unit);
  if (blocks > 0x7fffffffLL || smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  switch (chunk_steps(S)) {
    case 1: return launch_kt<D, 1>(a, variant, (int)warps, (int)smem, (unsigned)blocks, stream);
    case 2: return launch_kt<D, 2>(a, variant, (int)warps, (int)smem, (unsigned)blocks, stream);
    default: return launch_kt<D, 4>(a, variant, (int)warps, (int)smem, (unsigned)blocks, stream);
  }
}

}  // namespace flash_fwd
}  // namespace fa_mma
