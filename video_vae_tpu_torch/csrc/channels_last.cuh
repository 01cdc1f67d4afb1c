// The channels-last copy that TMA needs before it can shift a tile by one
// pixel: on the H100 a box whose innermost coordinate is not 16-byte aligned
// stops the kernel (an illegal instruction), so a shift along the pixels must
// move an outer coordinate, which a (frames, P, C) copy makes of them. The
// tap-dot conv (conv3d_tapdot.cu) and the direct conv's wgmma kernel
// (conv3d_wg.cuh) copy their input sources, the filter gradient's wgmma
// kernel (conv3d_wgrad_wg.cuh) its cotangent g.
//
// x: (frames, C, P) -> xt: (frames, P, Cp), Cp >= C a multiple of 8, the
// channels C .. Cp - 1 written as zeros, through a 64 x 64 tile in shared
// memory: 16-byte loads along the pixels (where P % 8 == 0), 16-byte stores of
// 8 channels of a pixel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace channels_last {

constexpr int TILE = 64;        // channels and pixels of a block's tile
constexpr int LD = TILE + 2;    // a tile row in shared memory: 132 bytes, 33 banks apart
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
channels_last_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ xt, int C, int Cp,
                     int P) {
  __shared__ __align__(16) uint16_t tile[TILE * LD];
  const int frame = blockIdx.z, c0 = blockIdx.y * TILE, p0 = blockIdx.x * TILE;
  const uint16_t* src = reinterpret_cast<const uint16_t*>(x) + (size_t)frame * C * P;
  const bool vec = P % 8 == 0;
  for (int i = threadIdx.x; i < TILE * TILE / 8; i += THREADS) {
    const int c = i / 8, u = i % 8, p = p0 + 8 * u;
    uint16_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (c0 + c < C) {
      const uint16_t* row = src + (size_t)(c0 + c) * P;
      if (vec && p + 8 <= P) {
        const uint4 q = *reinterpret_cast<const uint4*>(row + p);
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[2 * k] = (uint16_t)(w[k] & 0xffffu);
          v[2 * k + 1] = (uint16_t)(w[k] >> 16);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (p + k < P) v[k] = row[p + k];
      }
    }
    unsigned* dst = reinterpret_cast<unsigned*>(tile + c * LD + 8 * u);
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = (unsigned)v[2 * k] | ((unsigned)v[2 * k + 1] << 16);
  }
  __syncthreads();
  uint16_t* out = reinterpret_cast<uint16_t*>(xt) + (size_t)frame * P * Cp;
  for (int i = threadIdx.x; i < TILE * TILE / 8; i += THREADS) {
    const int p = i / 8, u = i % 8, c = c0 + 8 * u;
    if (p0 + p >= P || c >= Cp) continue;
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (unsigned)tile[(8 * u + 2 * k) * LD + p] | ((unsigned)tile[(8 * u + 2 * k + 1) * LD + p] << 16);
    *reinterpret_cast<uint4*>(out + (size_t)(p0 + p) * Cp + c) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

inline cudaError_t copy(const __nv_bfloat16* x, __nv_bfloat16* xt, int frames, int C, int Cp, long long P,
                        cudaStream_t s) {
  const dim3 grid((unsigned)((P + TILE - 1) / TILE), (unsigned)((Cp + TILE - 1) / TILE), (unsigned)frames);
  channels_last_kernel<<<grid, THREADS, 0, s>>>(x, xt, C, Cp, (int)P);
  return cudaGetLastError();
}

}  // namespace channels_last
