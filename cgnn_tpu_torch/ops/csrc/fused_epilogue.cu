// Fused conv epilogue on a materialized z [N, M, 2F], for Hopper (sm_90a):
// the BN1 normalize -> sigmoid * softplus gate -> edge mask -> sum over M
// chain and its hand backward, as three kernels.
//
// Replaces, in cgnn_tpu/ops/fused_epilogue.py:
//   kernel 3  epilogue_apply_kernel   <- `_apply_kernel`
//   kernel 4  epilogue_reduce_kernel  <- `_reduce_kernel`
//   kernel 5  epilogue_dz_kernel      <- `_dz_kernel`
// cst [4, 2F] holds the rows mean, rstd, scale, bias. With
// xhat = (z - mean) * rstd, y = xhat * scale + bias and ct = dL/d agg [N, F]:
//   apply:  agg[i, c] = sum over real slots s of sigmoid(y[c]) * softplus(y[c+F])
//   reduce: per channel, over real slots: sum g, sum g*xhat, sum dxhat,
//           sum dxhat*xhat, where g = dL/dy and dxhat = g * scale
//   dz:     dz = rstd * (dxhat - (mean dxhat + xhat * mean(dxhat*xhat)))
//           on real slots, 0 on padding slots.
//
// What bounds them on an H100: each touches every element of z a few
// times with a handful of f32 operations, so the bytes of z bound all
// three. At the flagship's batch-256 training shape (N ~ 7,000, M = 12,
// F = 64) z is ~43 MB: ~13 us of HBM at 3.35 TB/s for apply and reduce,
// ~26 us for dz, which also writes dz once.
//
// Design (simple first): one thread owns gate channel c and core channel
// c + F of one node row, so the gate and its gradient need no exchange
// between threads; a block holds `rows` node rows (blockDim = (F, rows)).
// Neighbouring threads read neighbouring channels of z: coalesced. Each
// thread walks its row's M slots in order and keeps its sums in registers.
// Padding slots (mask 0) are SELECTED to 0, never multiplied, so a NaN
// there cannot reach a sum. The reduce writes one [4, 2F] partial per
// block (the block's rows summed through shared memory in row order), and
// a second small kernel sums the partials in a fixed order: no float
// atomics, so the result is bit-identical from run to run.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using cgnn::sigmoid_f32;
using cgnn::softplus_f32;

struct Channel {
  float mean, rstd, scale, bias;
};

__device__ __forceinline__ Channel load_channel(const float* cst, int k,
                                                int two_f) {
  return {cst[k], cst[two_f + k], cst[2 * two_f + k], cst[3 * two_f + k]};
}

// g = dL/dy for the pair (y_g, y_c) from dmsg = ct of the row's channel
// (the JAX `_gate_grad`, same order of products)
__device__ __forceinline__ void gate_grad(float y_g, float y_c, float dmsg,
                                          float* g_g, float* g_c) {
  const float sg = sigmoid_f32(y_g);
  const float spg = sigmoid_f32(y_c);
  const float sp = softplus_f32(y_c);
  *g_g = dmsg * sg * (1.0f - sg) * sp;
  *g_c = dmsg * sg * spg;
}

__global__ void epilogue_apply_kernel(const float* __restrict__ z,
                                      const float* __restrict__ mask,
                                      const float* __restrict__ cst,
                                      float* __restrict__ out, int n, int m,
                                      int f) {
  const int c = threadIdx.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n) return;  // no block-wide barrier in this kernel
  const int two_f = 2 * f;
  const Channel kg = load_channel(cst, c, two_f);
  const Channel kc = load_channel(cst, c + f, two_f);
  const float rs_g = kg.rstd * kg.scale, rs_c = kc.rstd * kc.scale;
  float acc = 0.0f;
  for (int s = 0; s < m; ++s) {
    const size_t slot = (size_t)row * m + s;
    if (mask[slot] > 0.0f) {
      const float* zr = z + slot * two_f;
      const float y_g = (zr[c] - kg.mean) * rs_g + kg.bias;
      const float y_c = (zr[c + f] - kc.mean) * rs_c + kc.bias;
      acc += sigmoid_f32(y_g) * softplus_f32(y_c);
    }
  }
  out[(size_t)row * f + c] = acc;
}

__global__ void epilogue_reduce_kernel(const float* __restrict__ z,
                                       const float* __restrict__ mask,
                                       const float* __restrict__ cst,
                                       const float* __restrict__ ct,
                                       float* __restrict__ part, int n,
                                       int m, int f) {
  extern __shared__ float red_s[];  // [8][rows][F]
  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const int rows = blockDim.y;
  const int row = blockIdx.x * rows + r;
  const int two_f = 2 * f;
  // acc[0..3]: gate channel's sum g, g*xhat, dxhat, dxhat*xhat; [4..7] core
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (row < n) {
    const Channel kg = load_channel(cst, c, two_f);
    const Channel kc = load_channel(cst, c + f, two_f);
    const float dmsg = ct[(size_t)row * f + c];
    for (int s = 0; s < m; ++s) {
      const size_t slot = (size_t)row * m + s;
      if (mask[slot] > 0.0f) {
        const float* zr = z + slot * two_f;
        const float x_g = (zr[c] - kg.mean) * kg.rstd;
        const float x_c = (zr[c + f] - kc.mean) * kc.rstd;
        float g_g, g_c;
        gate_grad(x_g * kg.scale + kg.bias, x_c * kc.scale + kc.bias, dmsg,
                  &g_g, &g_c);
        const float d_g = g_g * kg.scale, d_c = g_c * kc.scale;
        acc[0] += g_g;
        acc[1] += g_g * x_g;
        acc[2] += d_g;
        acc[3] += d_g * x_g;
        acc[4] += g_c;
        acc[5] += g_c * x_c;
        acc[6] += d_c;
        acc[7] += d_c * x_c;
      }
    }
  }
  for (int q = 0; q < 8; ++q) red_s[(q * rows + r) * f + c] = acc[q];
  __syncthreads();
  if (r == 0) {
    // partial [4, 2F] of this block: quantity q, gate channel c / core c+F
    float* p = part + (size_t)blockIdx.x * 4 * two_f;
    for (int q = 0; q < 4; ++q) {
      float t_g = 0.0f, t_c = 0.0f;
      for (int rr = 0; rr < rows; ++rr) {
        t_g += red_s[(q * rows + rr) * f + c];
        t_c += red_s[((q + 4) * rows + rr) * f + c];
      }
      p[q * two_f + c] = t_g;
      p[q * two_f + c + f] = t_c;
    }
  }
}

__global__ void epilogue_dz_kernel(const float* __restrict__ z,
                                   const float* __restrict__ mask,
                                   const float* __restrict__ cst,
                                   const float* __restrict__ red5,
                                   const float* __restrict__ ct,
                                   float* __restrict__ dz, int n, int m,
                                   int f) {
  const int c = threadIdx.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n) return;  // no block-wide barrier in this kernel
  const int two_f = 2 * f;
  const Channel kg = load_channel(cst, c, two_f);
  const Channel kc = load_channel(cst, c + f, two_f);
  const float inv_c = red5[4 * two_f];  // 1 / max(n_real, 1)
  const float mdx_g = red5[2 * two_f + c] * inv_c;
  const float mdx_c = red5[2 * two_f + c + f] * inv_c;
  const float mdxx_g = red5[3 * two_f + c] * inv_c;
  const float mdxx_c = red5[3 * two_f + c + f] * inv_c;
  const float dmsg = ct[(size_t)row * f + c];
  for (int s = 0; s < m; ++s) {
    const size_t slot = (size_t)row * m + s;
    float out_g = 0.0f, out_c = 0.0f;
    if (mask[slot] > 0.0f) {
      const float* zr = z + slot * two_f;
      const float x_g = (zr[c] - kg.mean) * kg.rstd;
      const float x_c = (zr[c + f] - kc.mean) * kc.rstd;
      float g_g, g_c;
      gate_grad(x_g * kg.scale + kg.bias, x_c * kc.scale + kc.bias, dmsg,
                &g_g, &g_c);
      out_g = kg.rstd * (g_g * kg.scale - (mdx_g + x_g * mdxx_g));
      out_c = kc.rstd * (g_c * kc.scale - (mdx_c + x_c * mdxx_c));
    }
    dz[slot * two_f + c] = out_g;
    dz[slot * two_f + c + f] = out_c;
  }
}

bool bad_shape(int n, int m, int f, int rows) {
  return n <= 0 || m <= 0 || f <= 0 || rows <= 0 || f * rows > 1024;
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of its
// launches (0 = queued). All pointers are device pointers to contiguous
// row-major f32 data; `rows` node rows per block, F * rows <= 1024.

extern "C" int epilogue_apply_f32(const void* z, const void* mask,
                                  const void* cst, void* out, int n, int m,
                                  int f, int rows, void* stream) {
  if (bad_shape(n, m, f, rows)) return (int)cudaErrorInvalidValue;
  const dim3 block(f, rows);
  const dim3 grid((n + rows - 1) / rows);
  epilogue_apply_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)mask, (const float*)cst, (float*)out, n,
      m, f);
  return (int)cudaGetLastError();
}

// `part` is scratch of [ceil(N / rows), 4, 2F] floats; `out` is [4, 2F].
extern "C" int epilogue_reduce_f32(const void* z, const void* mask,
                                   const void* cst, const void* ct,
                                   void* part, void* out, int n, int m,
                                   int f, int rows, void* stream) {
  if (bad_shape(n, m, f, rows)) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(float) * 8 * rows * f);
  if (smem > cgnn::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        epilogue_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nb = (n + rows - 1) / rows;
  const dim3 block(f, rows);
  epilogue_reduce_kernel<<<nb, block, smem, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)mask, (const float*)cst,
      (const float*)ct, (float*)part, n, m, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cgnn::launch_sum_partials((const float*)part, (float*)out, nb,
                                        8 * f, (cudaStream_t)stream);
}

// red5 [5, 2F]: the reduce's four rows, then 1 / max(n_real, 1) broadcast.
extern "C" int epilogue_dz_f32(const void* z, const void* mask,
                               const void* cst, const void* red5,
                               const void* ct, void* dz, int n, int m, int f,
                               int rows, void* stream) {
  if (bad_shape(n, m, f, rows)) return (int)cudaErrorInvalidValue;
  const dim3 block(f, rows);
  const dim3 grid((n + rows - 1) / rows);
  epilogue_dz_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)mask, (const float*)cst,
      (const float*)red5, (const float*)ct, (float*)dz, n, m, f);
  return (int)cudaGetLastError();
}
