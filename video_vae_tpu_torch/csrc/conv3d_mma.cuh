// Device code of the bf16 direct conv on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators). The design note is in conv3d.cu; launch_conv_mma()
// enqueues the kernel on a stream and returns the launch's cudaError_t.
//
// Shared memory: two buffers, each holding one stage (a temporal tap dt and a
// 16-channel input chunk) of one work item for the consumers, then two raw
// windows:
//   window  [IH][IWP][24] bf16, the halo'd input tile TRANSPOSED: the 16 channels
//           of a pixel in a 48-byte line (3 units of 16 bytes, the last unused),
//           IWP = TW + kw (odd) pixels a row. An ldmatrix phase (8 consecutive
//           pixels, one 8-channel half) hits 8 distinct 16-byte bank groups at any
//           tap shift, and so does a producer's store phase (8 rows, one pixel);
//           a tap's offset is one add, (dh * IWP + dw) * 24.
//   weights [kh*kw][16][W_LD] bf16, the chunk's rows of every spatial tap over the
//           block's N output channels, zero past cin and cout; W_LD makes a row an
//           odd number of 16-byte units, so ldmatrix.trans is conflict-free.
//   raw     [16][IH][48] bf16, the same window as the sources hold it: channel
//           planes of rows of 48 pixels (x0 - 8 .. x0 + 39) in six 16-byte
//           pieces, pieces 2i and 2i + 1 swapped in rows with bit 2 set, so that
//           a transposing phase (8 rows, one piece) hits 8 bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace conv_mma {

using bf16 = __nv_bfloat16;

constexpr int TW = 32;  // output columns of a tile: two 16-pixel M tiles a row
constexpr int CK = 16;  // input channels of a chunk: one mma K step
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_WARPS = 4;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS, PRODUCERS = 32 * PRODUCER_WARPS;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int WM = 4;  // 16-pixel M tiles of a warp: 2 rows x 32 columns
constexpr int PIX = 24;     // bf16 elements of a window pixel's line
constexpr int RAW_PIECES = 6;  // 16-byte pieces of a raw window row
constexpr int RAW_W = 8 * RAW_PIECES;
constexpr int MAX_K = 7;
constexpr int MAX_SMEM = 232448;  // what one block may ask for on the H100 (227 KB)
// named barriers (0 is __syncthreads): buffer b is full, buffer b is free again,
// the producers are done with a raw window
constexpr int FULL = 1, EMPTY = 3, RAW_DONE = 5;

// Geometry shared with the host: wn n8 tiles a warp, wgn warps side by side in N.
__host__ __device__ __forceinline__ int tile_h(int wgn) { return 2 * CONSUMER_WARPS / wgn; }
__host__ __device__ __forceinline__ int n_block(int wn, int wgn) { return 8 * wn * wgn; }
__host__ __device__ __forceinline__ int w_ld(int n) { return (n / 8) % 2 ? n : n + 8; }
__host__ __device__ __forceinline__ int win_rows(int th, int kh) { return th + kh - 1; }
__host__ __device__ __forceinline__ int win_stride(int kw) { return TW + kw; }
__host__ __device__ __forceinline__ size_t round128(size_t b) { return (b + 127) / 128 * 128; }
__host__ __device__ __forceinline__ size_t window_bytes(int wgn, int kh, int kw) {
  return round128((size_t)win_rows(tile_h(wgn), kh) * win_stride(kw) * PIX * 2);
}
__host__ __device__ __forceinline__ size_t weight_bytes(int wn, int wgn, int kh, int kw) {
  return round128((size_t)kh * kw * CK * w_ld(n_block(wn, wgn)) * 2);
}
__host__ __device__ __forceinline__ size_t raw_bytes(int wgn, int kh) {
  return round128((size_t)CK * win_rows(tile_h(wgn), kh) * RAW_W * 2);
}
__host__ __device__ __forceinline__ size_t smem_bytes(int wn, int wgn, int kh, int kw) {
  return 2 * (window_bytes(wgn, kh, kw) + weight_bytes(wn, wgn, kh, kw) + raw_bytes(wgn, kh));
}

struct Params {
  const bf16* x1;  // (frames, c1, Hh, Ww)
  const bf16* x2;  // (frames, c2, Hh, Ww) or null with c2 = 0
  const bf16* w;   // (kt, kh, kw, cin, cout)
  const float* bias;
  bf16* y;       // (frames, cout, Hh, Ww)
  bf16* pooled;  // (frames, cout, Hh/2, Ww/2) or null
  int c1, c2, cin, cout, Tn, Hh, Ww, kt, kh, kw;
  int wgn, th, nb, tiles_w, tiles_hw, co_tiles, chunks;
  long long items;  // frames * tiles_hw * co_tiles
  int vec_x;        // Ww % 8 == 0 and 16-byte aligned sources: 16-byte window copies
  int w_mode;       // 2: 16-byte weight copies, 1: 4-byte, 0: element loads
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(RAW_DONE), "n"(PRODUCERS) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16 x 16, row major) * b (16 x 8, column major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of channel half `half` of window pixel (wr, wc).
__device__ __forceinline__ int win_off(int wr, int wc, int half, int iwp) { return (wr * iwp + wc) * PIX + 8 * half; }

// Element offset of piece `piece` of raw window row r (of channel 0).
__device__ __forceinline__ int raw_off(int r, int piece) { return r * RAW_W + 8 * (piece ^ ((r >> 2) & 1)); }

__device__ __forceinline__ const bf16* channel_plane(const Params& p, long long frame, int c) {
  const size_t plane = (size_t)p.Hh * p.Ww;
  return c < p.c1 ? p.x1 + ((size_t)frame * p.c1 + c) * plane
                  : p.x2 + ((size_t)frame * p.c2 + (c - p.c1)) * plane;
}

// One work item: an output frame, a th x TW pixel tile and nb output channels.
struct Item {
  long long frame;
  int t, y0, x0, co0;
  int dt_lo, dt_hi;  // the temporal taps whose input frame lies inside the clip
};

__device__ __forceinline__ Item decode(const Params& p, long long q) {
  Item it;
  const int co_tile = (int)(q % p.co_tiles);
  const int tile = (int)((q / p.co_tiles) % p.tiles_hw);
  it.frame = q / ((long long)p.co_tiles * p.tiles_hw);
  it.t = (int)(it.frame % p.Tn);
  it.y0 = (tile / p.tiles_w) * p.th;
  it.x0 = (tile % p.tiles_w) * TW;
  it.co0 = co_tile * p.nb;
  it.dt_lo = max(0, p.kt / 2 - it.t);
  it.dt_hi = min(p.kt, p.Tn - it.t + p.kt / 2);
  return it;
}

// One stage of a block's sequence: item q, temporal tap dt, input chunk ci0.
struct Stage {
  long long q;
  Item it;
  int dt, ci0;
};

__device__ __forceinline__ Stage first_stage(const Params& p) {
  const Item it = decode(p, blockIdx.x);
  return {blockIdx.x, it, it.dt_lo, 0};
}

// The stage after s in the block's sequence; false past its last.
__device__ __forceinline__ bool advance(const Params& p, Stage& s) {
  s.ci0 += CK;
  if (s.ci0 < p.cin) return true;
  s.ci0 = 0;
  if (++s.dt < s.it.dt_hi) return true;
  s.q += gridDim.x;
  if (s.q >= p.items) return false;
  s.it = decode(p, s.q);
  s.dt = s.it.dt_lo;
  return true;
}

// Copy stage s's window as the sources hold it into raw: a thread takes one (row,
// 16-byte piece) of the window and walks the chunk's channels (half of them
// where the window has few rows, so that every producer thread has work), with
// cp.async, zero-filled outside the frame and past the last channel; element by
// element where the rows are not 16-byte pieces.
__device__ __forceinline__ void fill_raw(bf16* raw, const Params& p, const Stage& s, int ptid) {
  const int ih = win_rows(p.th, p.kh);
  const long long frame = s.it.frame + s.dt - p.kt / 2;
  const int y_top = s.it.y0 - p.kh / 2, x_left = s.it.x0 - 8;
  const size_t plane = (size_t)p.Hh * p.Ww;
  if (p.vec_x) {  // Ww % 8 == 0: a piece is all inside the row or all outside
    const int slots = ih * RAW_PIECES, groups = 2 * slots <= PRODUCERS ? 2 : 1;
    for (int e = ptid; e < slots * groups; e += PRODUCERS) {
      const int slot = e % slots, c0 = (e / slots) * (CK / groups);
      const int piece = slot % RAW_PIECES, r = slot / RAW_PIECES;
      const int gy = y_top + r, gx = x_left + 8 * piece;
      const bool pix_in = gy >= 0 && gy < p.Hh && gx >= 0 && gx < p.Ww;
      const size_t off = pix_in ? (size_t)gy * p.Ww + gx : 0;
      int cg = s.ci0 + c0;  // the channel in the concat of the two sources
      const bf16* src = cg < p.c1 ? p.x1 + ((size_t)frame * p.c1 + cg) * plane + off
                                  : p.x2 + ((size_t)frame * p.c2 + (cg - p.c1)) * plane + off;
      bf16* dst = raw + c0 * ih * RAW_W + raw_off(r, piece);
      for (int c = 0; c < CK / groups; ++c, ++cg, src += plane, dst += ih * RAW_W) {
        if (cg == p.c1 && p.c2 > 0) src = p.x2 + (size_t)frame * p.c2 * plane + off;
        const bool inside = pix_in && cg < p.cin;
        cp_async16(dst, inside ? src : p.x1, inside ? 16 : 0);
      }
    }
  } else {
    for (int e = ptid; e < CK * ih * 8 * RAW_PIECES; e += PRODUCERS) {
      const int px = e % (8 * RAW_PIECES), rest = e / (8 * RAW_PIECES);
      const int r = rest % ih, c = rest / ih;
      const int gy = y_top + r, gx = x_left + px;
      bf16 v = __float2bfloat16(0.f);
      if (s.ci0 + c < p.cin && gy >= 0 && gy < p.Hh && gx >= 0 && gx < p.Ww)
        v = channel_plane(p, frame, s.ci0 + c)[(size_t)gy * p.Ww + gx];
      raw[c * ih * RAW_W + raw_off(r, px / 8) + px % 8] = v;
    }
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// raw -> window: item (row r, piece, channel half) reads 8 pixels of 8 channels,
// transposes them with byte permutes and stores the pixels that fall inside the
// window as 16-byte half lines. The 8 lanes of a phase take 8 consecutive rows.
__device__ __forceinline__ void transpose_raw(bf16* win, const bf16* raw, const Params& p, int ptid) {
  const int ih = win_rows(p.th, p.kh), iw = TW + p.kw - 1, iwp = win_stride(p.kw), pw = p.kw / 2;
  const int row_groups = (ih + 7) / 8;
  for (int e = ptid; e < row_groups * 8 * RAW_PIECES * 2; e += PRODUCERS) {
    const int rest = e >> 3;
    const int r = (rest / (2 * RAW_PIECES)) * 8 + (e & 7);
    const int piece = rest % RAW_PIECES, half = (rest / RAW_PIECES) & 1;
    if (r >= ih) continue;
    uint4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = *reinterpret_cast<const uint4*>(raw + (8 * half + j) * ih * RAW_W + raw_off(r, piece));
    const int wc0 = 8 * piece - 8 + pw;  // the window column of the piece's first pixel
#pragma unroll
    for (int px = 0; px < 8; ++px) {
      const int wc = wc0 + px;
      if (wc < 0 || wc >= iw) continue;
      const unsigned sel = px & 1 ? 0x7632u : 0x5410u;
      uint4 out;
      out.x = __byte_perm(word(v[0], px / 2), word(v[1], px / 2), sel);
      out.y = __byte_perm(word(v[2], px / 2), word(v[3], px / 2), sel);
      out.z = __byte_perm(word(v[4], px / 2), word(v[5], px / 2), sel);
      out.w = __byte_perm(word(v[6], px / 2), word(v[7], px / 2), sel);
      *reinterpret_cast<uint4*>(win + win_off(r, wc, half, iwp)) = out;
    }
  }
}

// The stage's weights: rows (tap, ci0 + cl) of W[dt], columns co0 .. co0 + nb, in
// pieces of 8, 2 or 1 channels by w_mode (nb and the piece counts are powers of 2).
__device__ __forceinline__ void stage_weights(bf16* ws, const Params& p, int dt, int ci0, int co0, int ptid) {
  const int ld = w_ld(p.nb);
  const int width = p.w_mode == 2 ? 8 : p.w_mode == 1 ? 2 : 1;
  const int shift = __ffs(p.nb / width) - 1;  // log2 of the pieces a row
  const int rows = p.kh * p.kw * CK;
  const bf16* w_dt = p.w + (size_t)dt * p.kh * p.kw * p.cin * p.cout;
  for (int e = ptid; e < rows << shift; e += PRODUCERS) {
    const int r = e >> shift, col = (e & ((1 << shift) - 1)) * width;
    const int tap = r >> 4, c = ci0 + (r & (CK - 1)), co = co0 + col;
    const bool inside = c < p.cin && co < p.cout;  // a piece is all inside cout or all outside
    const bf16* src = w_dt + ((size_t)tap * p.cin + c) * p.cout + co;
    bf16* dst = ws + r * ld + col;
    if (width == 8) {
      cp_async16(dst, inside ? src : p.w, inside ? 16 : 0);
    } else if (width == 2) {
      cp_async4(dst, inside ? src : p.w, inside ? 4 : 0);
    } else {
      *dst = inside ? *src : __float2bfloat16(0.f);
    }
  }
}

// A spatial tap's offsets into the window (dh * IWP + dw pixels) and into the
// weights (tap * 16 rows), stepped tap by tap without a division.
struct TapWalk {
  int dw, a, b;
  __device__ __forceinline__ const TapWalk& next(int kw, int iwp, int ld) {
    a += PIX;
    if (++dw == kw) {
      dw = 0;
      a += (iwp - kw) * PIX;
    }
    b += CK * ld;
    return *this;
  }
};

// One tap's A fragments (WM M tiles) and B fragments (WN n8 tiles) of a warp.
template <int WN>
struct Fragments {
  uint32_t a[WM][4];
  uint32_t b[WN][2];

  __device__ __forceinline__ void load(const bf16* buf, const int (&a_off)[WM], int b_off, const TapWalk& t) {
#pragma unroll
    for (int m = 0; m < WM; ++m) ldsm_x4(a[m], buf + a_off[m] + t.a);
    const bf16* wt = buf + b_off + t.b;
    if constexpr (WN == 1) {
      ldsm_x2_trans(b[0][0], b[0][1], wt);
    } else {
#pragma unroll
      for (int j = 0; j < WN; j += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, wt + 8 * j);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
    }
  }

  __device__ __forceinline__ void multiply(float (&acc)[WM][WN][4]) const {
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int j = 0; j < WN; ++j) mma(acc[m][j], a[m], b[j][0], b[j][1]);
  }
};

// Stages of the block: every item's inside-the-clip temporal taps x input chunks.
__device__ __forceinline__ int block_stages(const Params& p) {
  int n = 0;
  for (long long q = blockIdx.x; q < p.items; q += gridDim.x) {
    const Item it = decode(p, q);
    n += (it.dt_hi - it.dt_lo) * p.chunks;
  }
  return n;
}

// grid: persistent blocks, block b owning items b, b + gridDim.x, ... Producer warps
// stage stage k of that sequence into buffer k % 2 while the consumer warps multiply
// stage k - 1 from the other, across item boundaries. Consumer warp w: M group
// mg = w / wgn (output rows 2 mg and 2 mg + 1 of the tile, 32 columns: 4 M tiles)
// and N group ng = w % wgn (WN n8 tiles): 4 x WN accumulator fragments in
// registers for the item's whole K loop, then the epilogue straight from them.
template <int WN>
__global__ void __launch_bounds__(THREADS, 1) conv3d_mma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int win_elems = (int)(window_bytes(p.wgn, p.kh, p.kw) / 2);
  const int stage_elems = win_elems + (int)(weight_bytes(WN, p.wgn, p.kh, p.kw) / 2);
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_stages = block_stages(p);
  const int iwp = win_stride(p.kw);

  if (warp >= CONSUMER_WARPS) {  // producers
    // Stage k: its weights are copied into buffer k % 2 and stage k + 1's raw window
    // into raw (k + 1) % 2, both with cp.async; then stage k's raw window, copied
    // one stage earlier, is transposed into buffer k % 2, which is handed over.
    const int ptid = tid - CONSUMERS;
    bf16* raws = smem + 2 * stage_elems;
    const int raw_elems = (int)(raw_bytes(p.wgn, p.kh) / 2);
    Stage cur = first_stage(p), ahead = cur;
    fill_raw(raws, p, cur, ptid);
    cp_async_commit();
    for (int k = 0; k < n_stages; ++k) {
      const int b = k & 1;
      const bool more = advance(p, ahead);
      if (k >= 2) bar_sync(EMPTY + b);  // the consumers are done with stage k - 2
      bf16* buf = smem + b * stage_elems;
      stage_weights(buf + win_elems, p, cur.dt, cur.ci0, cur.it.co0, ptid);
      cp_async_commit();
      if (more) fill_raw(raws + (b ^ 1) * raw_elems, p, ahead, ptid);
      cp_async_commit();
      cp_async_wait<2>();  // this thread's pieces of raw window k have landed
      producers_sync();    // and everyone's
      transpose_raw(buf, raws + b * raw_elems, p, ptid);
      cp_async_wait<1>();  // stage k's weights
      producers_sync();    // raw window k is read: stage k + 2 may refill it
      bar_arrive(FULL + b);
      cur = ahead;
    }
    return;
  }

  // consumers
  const int mg = warp / p.wgn, ng = warp % p.wgn;
  const int ld = w_ld(p.nb);
  const int nbase = ng * WN * 8;
  const int g = lane >> 2, q2 = 2 * (lane & 3);  // accumulator row and column pair
  // this lane's ldmatrix rows at tap (0, 0): A pixel lane % 16, channel half lane / 16
  // of each M tile; B input channel lane % 16, output channels + 8 * (lane / 16)
  int a_off[WM];
#pragma unroll
  for (int m = 0; m < WM; ++m) a_off[m] = win_off(2 * mg + (m >> 1), 16 * (m & 1) + (lane & 15), lane >> 4, iwp);
  const int b_off = win_elems + (lane & 15) * ld + nbase + 8 * (lane >> 4);
  const int taps = p.kh * p.kw;
  int k = 0;
  for (long long q = blockIdx.x; q < p.items; q += gridDim.x) {
    const Item it = decode(p, q);
    float acc[WM][WN][4];
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

    const int stages = (it.dt_hi - it.dt_lo) * p.chunks;
    for (int s = 0; s < stages; ++s, ++k) {
      const int b = k & 1;
      bar_sync(FULL + b);
      const bf16* buf = smem + b * stage_elems;
      // two sets of fragments: tap i + 1's are loaded while tap i's are multiplied
      Fragments<WN> f0, f1;
      TapWalk walk{0, 0, 0};
      f0.load(buf, a_off, b_off, walk);
      for (int tap = 0; tap < taps; tap += 2) {
        if (tap + 1 < taps) f1.load(buf, a_off, b_off, walk.next(p.kw, iwp, ld));
        f0.multiply(acc);
        if (tap + 1 < taps) {
          if (tap + 2 < taps) f0.load(buf, a_off, b_off, walk.next(p.kw, iwp, ld));
          f1.multiply(acc);
        }
      }
      if (k + 2 < n_stages) bar_arrive(EMPTY + b);  // the producers may refill buffer b
    }

    // epilogue: the f32 sums + bias, one rounding; the pool from the same f32 values
    const size_t plane = (size_t)p.Hh * p.Ww;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int co = it.co0 + nbase + 8 * j + q2 + e2;
        const bool co_in = co < p.cout;
        const float bv = co_in ? p.bias[co] : 0.f;
        bf16* out = p.y + ((size_t)it.frame * p.cout + (co_in ? co : 0)) * plane;
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          const int gy = it.y0 + 2 * mg + (m >> 1);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int gx = it.x0 + 16 * (m & 1) + g + 8 * hi;
            if (co_in && gy < p.Hh && gx < p.Ww)
              out[(size_t)gy * p.Ww + gx] = __float2bfloat16(acc[m][j][2 * hi + e2] + bv);
          }
        }
        if (p.pooled != nullptr) {  // Hh and Ww are even; rows 2 mg, 2 mg + 1 are this warp's
          const int H2 = p.Hh / 2, W2 = p.Ww / 2;
          const int gy = it.y0 + 2 * mg;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int e = 2 * hi + e2;
              float v = fmaxf(acc[m][j][e], acc[m + 2][j][e]) + bv;
              v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));  // the next pixel of the row
              const int gx = it.x0 + 16 * m + g + 8 * hi;
              if (co_in && (g & 1) == 0 && gy < p.Hh && gx < p.Ww)
                p.pooled[((size_t)it.frame * p.cout + co) * H2 * W2 + (size_t)(gy / 2) * W2 + gx / 2] =
                    __float2bfloat16(v);
            }
          }
        }
      }
    }
  }
}

template <int WN>
cudaError_t launch_wn(const Params& p, int blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(conv3d_mma_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv3d_mma_kernel<WN><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// wn n8 tiles a warp (1, 2 or 4), wgn warps side by side in N (1, 2 or 4), blocks
// persistent blocks (video_vae_tpu_torch/ops/conv3d.py: conv_plan).
inline cudaError_t launch_conv_mma(const void* x1, const void* x2, int c1, int c2, const void* w,
                                   const void* bias, void* y, void* pooled, int B, int Tn, int Hh, int Ww,
                                   int cout, int kt, int kh, int kw, int wn, int wgn, int blocks,
                                   cudaStream_t stream) {
  if (wn != 1 && wn != 2 && wn != 4) return cudaErrorInvalidValue;
  if (wgn != 1 && wgn != 2 && wgn != 4) return cudaErrorInvalidValue;
  if (kw < 1 || kw % 2 == 0 || kw > MAX_K || blocks < 1) return cudaErrorInvalidValue;
  if (c2 > 0 && x2 == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(wn, wgn, kh, kw);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  Params p;
  p.x1 = static_cast<const bf16*>(x1);
  p.x2 = static_cast<const bf16*>(x2);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<bf16*>(y);
  p.pooled = static_cast<bf16*>(pooled);
  p.c1 = c1;
  p.c2 = c2;
  p.cin = c1 + c2;
  p.cout = cout;
  p.Tn = Tn;
  p.Hh = Hh;
  p.Ww = Ww;
  p.kt = kt;
  p.kh = kh;
  p.kw = kw;
  p.wgn = wgn;
  p.th = tile_h(wgn);
  p.nb = n_block(wn, wgn);
  p.tiles_w = (Ww + TW - 1) / TW;
  p.tiles_hw = p.tiles_w * ((Hh + p.th - 1) / p.th);
  p.co_tiles = (cout + p.nb - 1) / p.nb;
  p.chunks = (p.cin + CK - 1) / CK;
  p.items = (long long)B * Tn * p.tiles_hw * p.co_tiles;
  const uintptr_t xs = reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2);
  p.vec_x = Ww % 8 == 0 && xs % 16 == 0;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  p.w_mode = cout % 8 == 0 && wa % 16 == 0 ? 2 : cout % 2 == 0 && wa % 4 == 0 ? 1 : 0;
  if (blocks > p.items) return cudaErrorInvalidValue;
  switch (wn) {
    case 1: return launch_wn<1>(p, blocks, smem, stream);
    case 2: return launch_wn<2>(p, blocks, smem, stream);
    default: return launch_wn<4>(p, blocks, smem, stream);
  }
}

}  // namespace conv_mma
