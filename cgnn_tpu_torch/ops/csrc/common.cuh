// Device helpers shared by the port's CUDA sources (each .cu builds into
// its own shared library and includes this header).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cgnn {

constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in per block on sm_90

// A stored value as f32: an f32 as it is, a bf16 widened (exact: every
// bf16 value is an f32 value). The bf16 instances of the kernels load
// through these and do all their arithmetic in f32, as the TPU kernels do
// on bf16 inputs.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An f32 result stored in the output's type (bf16: rounded to nearest
// even, as jnp's astype rounds).
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// the jax.nn.softplus form: stable for large |x|
__device__ __forceinline__ float softplus_f32(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// out[k] = sum over b < nb of part[b * width + k], in one fixed order:
// lane j of a 32-lane column group sums blocks j, j + 32, j + 64, ... in
// turn, then lane 0 adds the 32 lane totals in lane order. No atomics, so
// the same partials give the same bits on every run. Launch with blocks
// of (32, 32) threads, ceil(width / 32) of them.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int nb,
                                    int width) {
  __shared__ float acc_s[32][33];
  const int k = blockIdx.x * 32 + threadIdx.x;
  const int j = threadIdx.y;
  float acc = 0.0f;
  if (k < width) {
    for (int b = j; b < nb; b += 32) acc += part[(size_t)b * width + k];
  }
  acc_s[j][threadIdx.x] = acc;
  __syncthreads();
  if (j == 0 && k < width) {
    float total = 0.0f;
    for (int q = 0; q < 32; ++q) total += acc_s[q][threadIdx.x];
    out[k] = total;
  }
}

inline cudaError_t launch_sum_partials(const float* part, float* out, int nb,
                                       int width, cudaStream_t stream) {
  const dim3 block(32, 32);
  const dim3 grid((width + 31) / 32);
  sum_partials_kernel<<<grid, block, 0, stream>>>(part, out, nb, width);
  return cudaGetLastError();
}

}  // namespace cgnn
