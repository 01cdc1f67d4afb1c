// Card-test helper, on no path of the model: the MLP kernel's SiLU
// (gemm_sm90.cuh:silu8) beside the formula it must equal bit for bit,
// v * (1.f / (1.f + expf(-v))) with an IEEE division, at n bf16 inputs
// (tests/test_torch_cuda.py:test_fused_mlp_silu_matches_the_division).

#include "gemm_sm90.cuh"

namespace {

__global__ void silu_check_kernel(const unsigned short* __restrict__ in, float* __restrict__ fast,
                                  float* __restrict__ exact, int n) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = __uint_as_float((unsigned)in[i + k] << 16);
    exact[i + k] = v[k] * (1.f / (1.f + expf(-v[k])));
  }
  vvt_sm90::silu8(v);
#pragma unroll
  for (int k = 0; k < 8; ++k) fast[i + k] = v[k];
}

}  // namespace

// in: n bf16 bit patterns; fast, exact: n f32. n a multiple of 8.
extern "C" int vvt_mlp_silu_check(const void* in, void* fast, void* exact, int n, void* stream) {
  if (n < 8 || n % 8) return (int)cudaErrorInvalidValue;
  const int threads = 256, blocks = (n / 8 + threads - 1) / threads;
  silu_check_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(in), static_cast<float*>(fast), static_cast<float*>(exact), n);
  return (int)cudaGetLastError();
}

extern "C" const char* vvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
