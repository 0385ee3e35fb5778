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
// Design of kernels 3 and 5 (simple first): one thread owns gate channel
// c and core channel c + F of one node row, so the gate and its gradient
// need no exchange between threads; a block holds `rows` node rows
// (blockDim = (F, rows)). Neighbouring threads read neighbouring channels
// of z: coalesced. Each thread walks its row's M slots in order and keeps
// its sums in registers. Padding slots (mask 0) are SELECTED to 0, never
// multiplied, so a NaN there cannot reach a sum.
//
// Kernel 4, redesigned for the card. Its first design (kernel 3's layout,
// one [4, 2F] partial a block of 8 rows: 979 at the training shape) took
// 0.050 ms on the device against a byte bound of 0.015 ms: a warp had
// about two 4-byte loads in flight (a data-dependent branch on each slot's
// mask before its z loads), `gate_grad` took three expf, a log1pf and two
// IEEE divisions a channel pair, and 16 blocks added 979 partials. Now:
//   - thread (tx, ty) owns V adjacent channels of each half, gate
//     V tx .. V tx + V-1 and core F + V tx .., read as float4s (V = 4
//     where F is a multiple of 4 and z and ct are 16-byte aligned, else
//     V = 1, the scalar path of the same kernel); a row's 4-slot chunk of
//     mask and z is loaded unconditionally, every load of the chunk in
//     flight before its arithmetic, and a padding slot's gradient terms are
//     then selected to 0 (NaN z in a padding slot never reaches a sum);
//   - `gate_grad_fast` takes t = exp(-|y|) once a half: sigmoid(y) =
//     1/(1+t) for y >= 0, else t/(1+t), softplus(y_c) = max(y_c, 0) +
//     log1p(t), with `__expf` and `__fdividef` (1 + t lies in [1, 2]) and
//     an accurate log1pf; kernel 5 keeps `gate_grad`;
//   - a persistent grid of at most `blocks` blocks (the wrapper's 264, two
//     an SM) walks row groups at a fixed stride, each thread summing its
//     rows in order; one [4, 2F] partial a block, added through shared
//     memory in thread-row order, then `sum_partials` in a fixed order: the
//     result is bit-identical from run to run.
//
// bf16 instances of kernels 3, 4 and 5 (`epilogue_apply_bf16`,
// `epilogue_reduce_bf16`, `epilogue_dz_bf16`): the TPU's `_apply_kernel`,
// `_reduce_kernel` and `_dz_kernel` read z of any dtype and work in f32;
// `_apply_kernel` writes its sum in f32 and `_dz_kernel` writes dz in z's
// dtype (fused_epilogue.py:142-189). The three kernels are templates on
// z's storage type T: T = __nv_bfloat16 widens z on load (kernel 4's V =
// 4 path reads 4 bf16 = 8 bytes a load), runs the f32 instance's
// arithmetic in its order, kernel 3 writes its f32 sum as the f32 instance
// does, and kernel 5 rounds dz to bf16 on its store. ct, cst, red5 and the
// partials stay f32. All three stay byte-bound; z's bytes (and dz's)
// halve.

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using cgnn::sigmoid_f32;
using cgnn::softplus_f32;
using cgnn::store_as;
using cgnn::to_f32;
using bf16 = __nv_bfloat16;

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

// The same gradient with one exp a half (kernel 4): t = exp(-|y|),
// sigmoid(y) = 1/(1+t) (y >= 0) or t/(1+t), softplus(y) = max(y, 0) +
// log1p(t); fast exp and reciprocal (1 + t in [1, 2]), accurate log1p.
__device__ __forceinline__ void gate_grad_fast(float y_g, float y_c,
                                               float dmsg, float* g_g,
                                               float* g_c) {
  const float t_g = __expf(-fabsf(y_g));
  const float r_g = __fdividef(1.0f, 1.0f + t_g);
  const float sg = y_g >= 0.0f ? r_g : t_g * r_g;
  const float t_c = __expf(-fabsf(y_c));
  const float r_c = __fdividef(1.0f, 1.0f + t_c);
  const float spg = y_c >= 0.0f ? r_c : t_c * r_c;
  const float sp = fmaxf(y_c, 0.0f) + log1pf(t_c);
  *g_g = dmsg * sg * (1.0f - sg) * sp;
  *g_c = dmsg * sg * spg;
}

template <typename T>
__global__ void epilogue_apply_kernel(const T* __restrict__ z,
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
      const T* zr = z + slot * two_f;
      const float y_g = (to_f32(zr[c]) - kg.mean) * rs_g + kg.bias;
      const float y_c = (to_f32(zr[c + f]) - kc.mean) * rs_c + kc.bias;
      acc += sigmoid_f32(y_g) * softplus_f32(y_c);
    }
  }
  out[(size_t)row * f + c] = acc;
}

constexpr int kReduceThreads = 256;  // a block: (F / V) x rows threads
                                     // (the scalar path: F x 1 past 256)
constexpr int kReduceChunk = 4;      // slots whose loads are in flight at once

// V values of `src` at `i` as f32 (V = 4: one 16-byte load of f32, one
// 8-byte load of bf16, aligned to its size).
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* __restrict__ src, size_t i,
                                       float* out) {
  if constexpr (V == 4 && std::is_same_v<T, float>) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(src + i);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = to_f32(src[i + k]);
  }
}

// Kernel 4: blockDim (F / V, rows); block b takes row groups b, b +
// gridDim.x, ... of `rows` rows, thread row ty row ty of each. Per real
// slot and channel: g = dL/dy, xhat, dxhat = g * scale, summed as g,
// g xhat, dxhat, dxhat xhat; one [4, 2F] partial a block.
template <int V, typename T>
__global__ void __launch_bounds__(V == 4 ? kReduceThreads : 1024)
    epilogue_reduce_kernel(const T* __restrict__ z,
                           const float* __restrict__ mask,
                           const float* __restrict__ cst,
                           const float* __restrict__ ct,
                           float* __restrict__ part, int n, int m, int f) {
  extern __shared__ float red_s[];  // [8][rows][F]
  const int tx = threadIdx.x, ty = threadIdx.y, rows = blockDim.y;
  const int two_f = 2 * f;
  const int c0 = V * tx;
  Channel kg[V], kc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    kg[v] = load_channel(cst, c0 + v, two_f);
    kc[v] = load_channel(cst, f + c0 + v, two_f);
  }
  // acc[q][v]: q 0..3 the gate channel's sum g, g*xhat, dxhat,
  // dxhat*xhat; 4..7 the core channel's
  float acc[8][V];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[q][v] = 0.0f;
  }
  for (int row = blockIdx.x * rows + ty; row < n; row += gridDim.x * rows) {
    float dmsg[V];
    load_v<V>(ct, (size_t)row * f + c0, dmsg);
    const T* zr = z + (size_t)row * m * two_f;
    const float* mr = mask + (size_t)row * m;
    for (int s0 = 0; s0 < m; s0 += kReduceChunk) {
      float mk[kReduceChunk], zg[kReduceChunk][V], zc[kReduceChunk][V];
#pragma unroll
      for (int u = 0; u < kReduceChunk; ++u) {
        const int s = s0 + u < m ? s0 + u : m - 1;  // past M: selected away
        mk[u] = s0 + u < m ? mr[s] : 0.0f;
        load_v<V>(zr, (size_t)s * two_f + c0, zg[u]);
        load_v<V>(zr, (size_t)s * two_f + f + c0, zc[u]);
      }
#pragma unroll
      for (int u = 0; u < kReduceChunk; ++u) {
        const bool real = mk[u] > 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float x_g = (zg[u][v] - kg[v].mean) * kg[v].rstd;
          const float x_c = (zc[u][v] - kc[v].mean) * kc[v].rstd;
          float g_g, g_c;
          gate_grad_fast(x_g * kg[v].scale + kg[v].bias,
                         x_c * kc[v].scale + kc[v].bias, dmsg[v], &g_g,
                         &g_c);
          // padding slots: every term selected to 0, never multiplied in
          const float sg = real ? g_g : 0.0f, sc = real ? g_c : 0.0f;
          const float xg = real ? x_g : 0.0f, xc = real ? x_c : 0.0f;
          const float d_g = sg * kg[v].scale, d_c = sc * kc[v].scale;
          acc[0][v] += sg;
          acc[1][v] += sg * xg;
          acc[2][v] += d_g;
          acc[3][v] += d_g * xg;
          acc[4][v] += sc;
          acc[5][v] += sc * xc;
          acc[6][v] += d_c;
          acc[7][v] += d_c * xc;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red_s[(q * rows + ty) * f + c0 + v] = acc[q][v];
    }
  }
  __syncthreads();
  // partial [4, 2F] of this block: quantity q of gate channel c (q < 4) or
  // of core channel F + c, its rows added in thread-row order
  float* p = part + (size_t)blockIdx.x * 4 * two_f;
  const int nthreads = blockDim.x * rows;
  for (int o = ty * blockDim.x + tx; o < 8 * f; o += nthreads) {
    const int q = o / f, c = o - q * f;
    float t = 0.0f;
    for (int r = 0; r < rows; ++r) t += red_s[(q * rows + r) * f + c];
    p[(q & 3) * two_f + (q >> 2) * f + c] = t;
  }
}

template <typename T>
__global__ void epilogue_dz_kernel(const T* __restrict__ z,
                                   const float* __restrict__ mask,
                                   const float* __restrict__ cst,
                                   const float* __restrict__ red5,
                                   const float* __restrict__ ct,
                                   T* __restrict__ dz, int n, int m, int f) {
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
      const T* zr = z + slot * two_f;
      const float x_g = (to_f32(zr[c]) - kg.mean) * kg.rstd;
      const float x_c = (to_f32(zr[c + f]) - kc.mean) * kc.rstd;
      float g_g, g_c;
      gate_grad(x_g * kg.scale + kg.bias, x_c * kc.scale + kc.bias, dmsg,
                &g_g, &g_c);
      out_g = kg.rstd * (g_g * kg.scale - (mdx_g + x_g * mdxx_g));
      out_c = kc.rstd * (g_c * kc.scale - (mdx_c + x_c * mdxx_c));
    }
    store_as(dz + slot * two_f + c, out_g);
    store_as(dz + slot * two_f + c + f, out_c);
  }
}

bool bad_shape(int n, int m, int f, int rows) {
  return n <= 0 || m <= 0 || f <= 0 || rows <= 0 || f * rows > 1024;
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of its
// launches (0 = queued). All pointers are device pointers to contiguous
// row-major f32 data; `rows` node rows per block, F * rows <= 1024
// (kernels 3 and 5).

namespace {
template <typename T>
int apply(const void* z, const void* mask, const void* cst, void* out, int n,
          int m, int f, int rows, void* stream) {
  if (bad_shape(n, m, f, rows)) return (int)cudaErrorInvalidValue;
  const dim3 block(f, rows);
  const dim3 grid((n + rows - 1) / rows);
  epilogue_apply_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)z, (const float*)mask, (const float*)cst, (float*)out, n, m,
      f);
  return (int)cudaGetLastError();
}
}  // namespace

// z f32 (`_f32`) or bf16 (`_bf16`, widened on load); out [N, F] f32 in both.
extern "C" int epilogue_apply_f32(const void* z, const void* mask,
                                  const void* cst, void* out, int n, int m,
                                  int f, int rows, void* stream) {
  return apply<float>(z, mask, cst, out, n, m, f, rows, stream);
}

extern "C" int epilogue_apply_bf16(const void* z, const void* mask,
                                   const void* cst, void* out, int n, int m,
                                   int f, int rows, void* stream) {
  return apply<bf16>(z, mask, cst, out, n, m, f, rows, stream);
}

// Kernel 4 sizes its own blocks (F / V x 256 V / F threads) and takes
// `blocks` in place of `rows`: `part` is scratch of [blocks, 4, 2F] floats
// with blocks <= N, of which the kernel fills min(blocks, row groups);
// `out` is [4, 2F].
namespace {
template <int V, typename T>
cudaError_t launch_reduce(const T* z, const float* mask,
                          const float* cst, const float* ct, float* part,
                          float* out, int n, int m, int f, int blocks,
                          cudaStream_t st) {
  const int t = f / V;
  const int rows = t >= kReduceThreads ? 1 : kReduceThreads / t;
  if (t > 1024) return cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * 8 * rows * f;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)epilogue_reduce_kernel<V, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int groups = (n + rows - 1) / rows;
  const int nb = groups < blocks ? groups : blocks;
  epilogue_reduce_kernel<V, T><<<nb, dim3(t, rows), smem, st>>>(
      z, mask, cst, ct, part, n, m, f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cgnn::launch_sum_partials(part, out, nb, 8 * f, st);
}

template <typename T>
int reduce(const void* z, const void* mask, const void* cst, const void* ct,
           void* part, void* out, int n, int m, int f, int blocks,
           void* stream) {
  if (bad_shape(n, m, f, 1) || blocks <= 0 || blocks > n) {
    return (int)cudaErrorInvalidValue;
  }
  // V = 4: four z values a load, aligned to the load's size
  const size_t align = 4 * sizeof(T) - 1;
  const bool vec = f % 4 == 0 && (reinterpret_cast<size_t>(z) & align) == 0 &&
                   (reinterpret_cast<size_t>(ct) & 15) == 0;
  const auto launch = vec ? &launch_reduce<4, T> : &launch_reduce<1, T>;
  return (int)launch((const T*)z, (const float*)mask, (const float*)cst,
                     (const float*)ct, (float*)part, (float*)out, n, m, f,
                     blocks, (cudaStream_t)stream);
}

template <typename T>
int dz_pass(const void* z, const void* mask, const void* cst,
            const void* red5, const void* ct, void* dz, int n, int m, int f,
            int rows, void* stream) {
  if (bad_shape(n, m, f, rows)) return (int)cudaErrorInvalidValue;
  const dim3 block(f, rows);
  const dim3 grid((n + rows - 1) / rows);
  epilogue_dz_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)z, (const float*)mask, (const float*)cst, (const float*)red5,
      (const float*)ct, (T*)dz, n, m, f);
  return (int)cudaGetLastError();
}
}  // namespace

// z (and dz) f32 in the `_f32` entries, bf16 in the `_bf16` ones.
extern "C" int epilogue_reduce_f32(const void* z, const void* mask,
                                   const void* cst, const void* ct,
                                   void* part, void* out, int n, int m,
                                   int f, int blocks, void* stream) {
  return reduce<float>(z, mask, cst, ct, part, out, n, m, f, blocks, stream);
}

extern "C" int epilogue_reduce_bf16(const void* z, const void* mask,
                                    const void* cst, const void* ct,
                                    void* part, void* out, int n, int m,
                                    int f, int blocks, void* stream) {
  return reduce<bf16>(z, mask, cst, ct, part, out, n, m, f, blocks, stream);
}

// red5 [5, 2F]: the reduce's four rows, then 1 / max(n_real, 1) broadcast.
extern "C" int epilogue_dz_f32(const void* z, const void* mask,
                               const void* cst, const void* red5,
                               const void* ct, void* dz, int n, int m, int f,
                               int rows, void* stream) {
  return dz_pass<float>(z, mask, cst, red5, ct, dz, n, m, f, rows, stream);
}

extern "C" int epilogue_dz_bf16(const void* z, const void* mask,
                                const void* cst, const void* red5,
                                const void* ct, void* dz, int n, int m,
                                int f, int rows, void* stream) {
  return dz_pass<bf16>(z, mask, cst, red5, ct, dz, n, m, f, rows, stream);
}
