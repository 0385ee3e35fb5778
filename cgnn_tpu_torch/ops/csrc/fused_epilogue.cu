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
// Kernels 3 and 5, redesigned for the card (after kernel 4). Their first
// design (one thread a channel pair (c, c + F) of one row, blockDim (F,
// rows)) took 0.027 and 0.047 ms on the device at the training shape
// against byte bounds of 0.015 and 0.029 ms, and their bf16 instances ran
// at about the f32 rate (0.98 and 0.79 of its time) on half the bytes: a
// thread loaded a slot's mask, branched on it, then issued two 4- or
// 2-byte z loads, so a warp had one slot's 128 (f32) or 64 (bf16) bytes in
// flight; and kernel 5's `gate_grad` took three expf, a log1pf and two
// IEEE divisions a pair.
// Now, in both dtypes:
//   - thread (tx, ty) owns V adjacent channels of each half, gate V tx ..
//     V tx + V-1 and core F + V tx .., read as one 16-byte load a half and
//     slot (`ZVec`: V = 4 f32 in a float4, V = 8 bf16 in a uint4 widened
//     with __bfloat1622float2), where F is a multiple of V and every
//     vector pointer is 16-byte aligned; else V = 1, the scalar path of
//     the same template;
//   - a chunk of slots (mask and z) is loaded unconditionally, every load
//     in flight before its arithmetic, and a padding slot's term is then
//     selected to 0 (slots past M load slot M-1, mask 0);
//   - one exp a half: t = exp(-|y|), sigmoid(y) = 1/(1+t) for y >= 0,
//     else t/(1+t), softplus(y_c) = max(y_c, 0) + log(1 + t_c), each of
//     exp, 1/x and log one MUFU instruction (`exp_neg`, `rcp_12`,
//     `log_12`): with the accurate log1pf of kernel 4 the bf16 instances
//     were bound by their instruction issue, not by their bytes;
//   - every operation outside the gate is an explicit _rn intrinsic, so no
//     instance contracts otherwise than another: each V gives the same
//     bits, and a bf16 instance the f32 instance's on the widened z;
//   - kernel 3 keeps a row's slots in one thread and adds them in order s
//     = 0 .. M-1, kApplyChunk slots at a time (its f32 [N, F] row slice
//     stored as float4s); kernel 5 has no sum over M, so a thread takes one
//     chunk of kDzChunk<T> slots of one row (N ceil(M / C) units) and
//     writes its dz as 16-byte stores (bf16: __floats2bfloat162_rn,
//     rounded to nearest even as `store_as`). Kernel 5's bf16 instance
//     takes 4 slots a thread with one block an SM (its arithmetic a byte
//     is twice f32's, so it wants a thread's work in flight more than
//     more threads), the f32 one 2 slots with two blocks an SM.
// Blocks of kPassThreads threads: at the training shape (N = 7832, F =
// 64) kernel 3 has 490 (f32) or 245 (bf16) blocks, kernel 5 2937 (f32)
// or 735 (bf16).
//
// Kernel 4, redesigned for the card. Its first design (the first layout
// of kernels 3 and 5, one [4, 2F] partial a block of 8 rows: 979 at the
// training shape) took 0.050 ms on the device against a byte bound of
// 0.015 ms: a warp had about two 4-byte loads in flight (a data-dependent
// branch on each slot's mask before its z loads), `gate_grad` took three
// expf, a log1pf and two IEEE divisions a channel pair, and 16 blocks
// added 979 partials. Now:
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
//     an accurate log1pf;
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
// 4 path reads 4 bf16 = 8 bytes a load, kernels 3 and 5 read 8 bf16 = 16
// bytes), runs the f32 instance's
// arithmetic in its order, kernel 3 writes its f32 sum as the f32 instance
// does, and kernel 5 rounds dz to bf16 on its store. ct, cst, red5 and the
// partials stay f32. All three stay byte-bound; z's bytes (and dz's)
// halve.

#include <cuda_runtime.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

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

// The gate's three transcendental functions on the arguments kernels 3
// and 5 give them, one MUFU instruction each (PTX .approx.ftz): exp(x)
// for x = -|y| <= 0 (as `__expf`: ex2 of x log2(e)), 1/x and log(x) for x
// = 1 + t in [1, 2]. `__fdividef` and `__logf` add guards for arguments
// outside that range (huge divisors, subnormals), which these never get.
// log(1 + t) stands for log1p(t): the rounding of 1 + t moves a softplus
// by at most 6e-8, which counts against rtol 1e-4 only where it is below
// the kernels' atol, 1e-5.
__device__ __forceinline__ float exp_neg(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.44269504f));
  return r;
}

__device__ __forceinline__ float rcp_12(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float log_12(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r * 0.693147181f;
}

// g = dL/dy for the pair (y_g, y_c) from dmsg = ct of the row's channel
// (the JAX `_gate_grad`, same order of products) with one exp a half
// (kernels 4 and 5): t = exp(-|y|), sigmoid(y) = 1/(1+t) (y >= 0) or
// t/(1+t), softplus(y) = max(y, 0) + log1p(t). Kernel 4: `__expf`,
// `__fdividef` (1 + t in [1, 2]) and an accurate log1pf; kernel 5
// (kFast): `exp_neg`, `rcp_12` and `log_12`.
template <bool kFast = false>
__device__ __forceinline__ void gate_grad_fast(float y_g, float y_c,
                                               float dmsg, float* g_g,
                                               float* g_c) {
  const float t_g = kFast ? exp_neg(-fabsf(y_g)) : __expf(-fabsf(y_g));
  const float r_g =
      kFast ? rcp_12(1.0f + t_g) : __fdividef(1.0f, 1.0f + t_g);
  const float sg = y_g >= 0.0f ? r_g : t_g * r_g;
  const float t_c = kFast ? exp_neg(-fabsf(y_c)) : __expf(-fabsf(y_c));
  const float r_c =
      kFast ? rcp_12(1.0f + t_c) : __fdividef(1.0f, 1.0f + t_c);
  const float spg = y_c >= 0.0f ? r_c : t_c * r_c;
  const float sp =
      fmaxf(y_c, 0.0f) + (kFast ? log_12(1.0f + t_c) : log1pf(t_c));
  *g_g = dmsg * sg * (1.0f - sg) * sp;
  *g_c = dmsg * sg * spg;
}

// The one-exp gate of kernel 3: sigmoid(y_g) * softplus(y_c) from t =
// exp(-|y|) a half, as `gate_grad_fast<true>` takes it.
__device__ __forceinline__ float gate_fast(float y_g, float y_c) {
  const float t_g = exp_neg(-fabsf(y_g));
  const float r_g = rcp_12(1.0f + t_g);
  const float sg = y_g >= 0.0f ? r_g : t_g * r_g;
  const float t_c = exp_neg(-fabsf(y_c));
  const float sp = fmaxf(y_c, 0.0f) + log_12(1.0f + t_c);
  return sg * sp;
}

constexpr int kPassThreads = 256;  // kernels 3 and 5: a block's threads on
                                   // the vector path, (F / V) x rows
// slots whose z loads a thread has in flight at once
constexpr int kApplyChunk = 2;
// kernel 5, by z's type: bf16 takes 4 slots a thread and the registers
// they need (one block an SM); f32, whose bytes bound it, 2 slots and
// two blocks an SM (<= 128 registers). Neither spills (ptxas -v).
template <typename T>
constexpr int kDzChunk = sizeof(T) == 2 ? 4 : 2;
template <typename T>
constexpr int kDzMinBlocks = sizeof(T) == 2 ? 1 : 2;

// V adjacent values of z (or dz) in their stored form, moved by one
// instruction: V = 4 f32 in a float4, V = 8 bf16 in a uint4 (16 bytes
// either way), V = 1 one value of either type (the scalar path). `widen`
// gives them as f32, `narrow` stores f32 values back in T (bf16: rounded
// to nearest even, as `store_as`).
template <int V, typename T>
struct ZVec {
  static_assert(V == 1, "a vector width with no ZVec");
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = *p; }
  __device__ __forceinline__ void widen(float* out) const {
    out[0] = to_f32(raw);
  }
  __device__ __forceinline__ static void narrow(T* p, const float* v) {
    store_as(p, v[0]);
  }
};

template <>
struct ZVec<4, float> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void widen(float* out) const {
    out[0] = raw.x;
    out[1] = raw.y;
    out[2] = raw.z;
    out[3] = raw.w;
  }
  __device__ __forceinline__ static void narrow(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct ZVec<8, bf16> {
  uint4 raw;
  __device__ __forceinline__ void load(const bf16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void widen(float* out) const {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 p =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      out[2 * k] = p.x;
      out[2 * k + 1] = p.y;
    }
  }
  __device__ __forceinline__ static void narrow(bf16* p, const float* v) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// V f32 values at p (V a multiple of 4: float4 loads, 16-byte aligned)
template <int V>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float* out) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      out[k] = q.x;
      out[k + 1] = q.y;
      out[k + 2] = q.z;
      out[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = p[k];
  }
}

// A row's C slots from s0 on: the mask values and both halves' z at
// channels c0 .. c0 + V-1, every load issued before any is used. Slots
// past M load slot M-1 and get mask 0, so they are selected away.
template <int C, int V, typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ zr,
                                           const float* __restrict__ mr,
                                           int s0, int m, int f, int c0,
                                           float* mk, ZVec<V, T>* zg,
                                           ZVec<V, T>* zc) {
#pragma unroll
  for (int u = 0; u < C; ++u) {
    const int s = s0 + u < m ? s0 + u : m - 1;
    const float mv = mr[s];
    mk[u] = s0 + u < m ? mv : 0.0f;
    zg[u].load(zr + (size_t)s * 2 * f + c0);
    zc[u].load(zr + (size_t)s * 2 * f + f + c0);
  }
}

// Kernel 3: blockDim (F / V, rows); thread (tx, ty) sums, for node row
// blockIdx.x * rows + ty, gate channels V tx .. V tx + V-1 with their core
// channels F + V tx .., over the slots s = 0 .. M-1 in order, a padding
// slot's term selected to 0 (NaN z there reaches nothing).
template <int V, typename T>
__global__ void __launch_bounds__(V == 1 ? 1024 : kPassThreads)
    epilogue_apply_kernel(const T* __restrict__ z,
                          const float* __restrict__ mask,
                          const float* __restrict__ cst,
                          float* __restrict__ out, int n, int m, int f) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n) return;  // no block-wide barrier in this kernel
  const int two_f = 2 * f, c0 = V * threadIdx.x;
  float mean_g[V], rs_g[V], bias_g[V], mean_c[V], rs_c[V], bias_c[V];
  float sc_g[V], sc_c[V];
  load_f32<V>(cst + c0, mean_g);
  load_f32<V>(cst + f + c0, mean_c);
  load_f32<V>(cst + two_f + c0, rs_g);
  load_f32<V>(cst + two_f + f + c0, rs_c);
  load_f32<V>(cst + 2 * two_f + c0, sc_g);
  load_f32<V>(cst + 2 * two_f + f + c0, sc_c);
  load_f32<V>(cst + 3 * two_f + c0, bias_g);
  load_f32<V>(cst + 3 * two_f + f + c0, bias_c);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    rs_g[v] = __fmul_rn(rs_g[v], sc_g[v]);  // rstd * scale
    rs_c[v] = __fmul_rn(rs_c[v], sc_c[v]);
    acc[v] = 0.0f;
  }
  const T* zr = z + (size_t)row * m * two_f;
  const float* mr = mask + (size_t)row * m;
  for (int s0 = 0; s0 < m; s0 += kApplyChunk) {
    float mk[kApplyChunk];
    ZVec<V, T> zg[kApplyChunk], zc[kApplyChunk];
    load_chunk<kApplyChunk>(zr, mr, s0, m, f, c0, mk, zg, zc);
#pragma unroll
    for (int u = 0; u < kApplyChunk; ++u) {
      float xg[V], xc[V];
      zg[u].widen(xg);
      zc[u].widen(xc);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float y_g =
            __fmaf_rn(__fsub_rn(xg[v], mean_g[v]), rs_g[v], bias_g[v]);
        const float y_c =
            __fmaf_rn(__fsub_rn(xc[v], mean_c[v]), rs_c[v], bias_c[v]);
        const float msg = gate_fast(y_g, y_c);
        acc[v] = __fadd_rn(acc[v], mk[u] > 0.0f ? msg : 0.0f);
      }
    }
  }
  float* o = out + (size_t)row * f + c0;
  if constexpr (V == 1) {
    o[0] = acc[0];
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      *reinterpret_cast<float4*>(o + k) =
          make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    }
  }
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

// Kernel 5: blockDim (F / V, units); thread (tx, ty) takes unit blockIdx.x *
// units + ty, one node row's chunk of C = kDzChunk<T> slots (ceil(M / C)
// units a row), at gate channels V tx .. V tx + V-1 and their core
// channels F + V tx ..: its mask and z loads first, then ct, cst and red5
// (L1 hits after the first unit of a block), then dz of each slot, written
// as 16-byte stores; a padding slot's dz is selected to 0.
template <int V, typename T>
__global__ void __launch_bounds__(V == 1 ? 1024 : kPassThreads,
                                  V == 1 ? 1 : kDzMinBlocks<T>)
    epilogue_dz_kernel(const T* __restrict__ z,
                       const float* __restrict__ mask,
                       const float* __restrict__ cst,
                       const float* __restrict__ red5,
                       const float* __restrict__ ct, T* __restrict__ dz,
                       int n, int m, int f) {
  constexpr int C = kDzChunk<T>;
  const int chunks = (m + C - 1) / C;
  const long long unit = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (unit >= (long long)n * chunks) return;  // no block-wide barrier
  const int row = (int)(unit / chunks);
  const int s0 = (int)(unit - (long long)row * chunks) * C;
  const int two_f = 2 * f, c0 = V * threadIdx.x;
  const T* zr = z + (size_t)row * m * two_f;
  float mk[C];
  ZVec<V, T> zg[C], zc[C];
  load_chunk<C>(zr, mask + (size_t)row * m, s0, m, f, c0, mk, zg, zc);
  float dmsg[V], mean_g[V], mean_c[V], rstd_g[V], rstd_c[V];
  float sc_g[V], sc_c[V], bias_g[V], bias_c[V];
  float mdx_g[V], mdx_c[V], mdxx_g[V], mdxx_c[V];
  load_f32<V>(ct + (size_t)row * f + c0, dmsg);
  load_f32<V>(cst + c0, mean_g);
  load_f32<V>(cst + f + c0, mean_c);
  load_f32<V>(cst + two_f + c0, rstd_g);
  load_f32<V>(cst + two_f + f + c0, rstd_c);
  load_f32<V>(cst + 2 * two_f + c0, sc_g);
  load_f32<V>(cst + 2 * two_f + f + c0, sc_c);
  load_f32<V>(cst + 3 * two_f + c0, bias_g);
  load_f32<V>(cst + 3 * two_f + f + c0, bias_c);
  load_f32<V>(red5 + 2 * two_f + c0, mdx_g);
  load_f32<V>(red5 + 2 * two_f + f + c0, mdx_c);
  load_f32<V>(red5 + 3 * two_f + c0, mdxx_g);
  load_f32<V>(red5 + 3 * two_f + f + c0, mdxx_c);
  const float inv_c = red5[4 * two_f];  // 1 / max(n_real, 1)
#pragma unroll
  for (int v = 0; v < V; ++v) {  // the means over the real slots
    mdx_g[v] = __fmul_rn(mdx_g[v], inv_c);
    mdx_c[v] = __fmul_rn(mdx_c[v], inv_c);
    mdxx_g[v] = __fmul_rn(mdxx_g[v], inv_c);
    mdxx_c[v] = __fmul_rn(mdxx_c[v], inv_c);
  }
#pragma unroll
  for (int u = 0; u < C; ++u) {
    float og[V], oc[V];
    zg[u].widen(og);
    zc[u].widen(oc);
    const bool real = mk[u] > 0.0f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float x_g = __fmul_rn(__fsub_rn(og[v], mean_g[v]), rstd_g[v]);
      const float x_c = __fmul_rn(__fsub_rn(oc[v], mean_c[v]), rstd_c[v]);
      float g_g, g_c;
      gate_grad_fast<true>(__fmaf_rn(x_g, sc_g[v], bias_g[v]),
                           __fmaf_rn(x_c, sc_c[v], bias_c[v]), dmsg[v],
                           &g_g, &g_c);
      // rstd * (dxhat - (mean dxhat + xhat * mean(dxhat * xhat)))
      const float d_g = __fmul_rn(
          rstd_g[v],
          __fmaf_rn(g_g, sc_g[v], -__fmaf_rn(x_g, mdxx_g[v], mdx_g[v])));
      const float d_c = __fmul_rn(
          rstd_c[v],
          __fmaf_rn(g_c, sc_c[v], -__fmaf_rn(x_c, mdxx_c[v], mdx_c[v])));
      og[v] = real ? d_g : 0.0f;
      oc[v] = real ? d_c : 0.0f;
    }
    if (s0 + u < m) {
      T* d = dz + ((size_t)row * m + s0 + u) * two_f + c0;
      ZVec<V, T>::narrow(d, og);
      ZVec<V, T>::narrow(d + f, oc);
    }
  }
}

bool bad_shape(int n, int m, int f, int rows) {
  return n <= 0 || m <= 0 || f <= 0 || rows <= 0 || f * rows > 1024;
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of its
// launches (0 = queued). All pointers are device pointers to contiguous
// row-major data, f32 but for z and dz.
//
// Kernels 3 and 5 take the vector width `v` as their last int, chosen by
// the wrapper (ops/fused_epilogue.py `vector_width`): kVec<T> (16 bytes
// of z a load) where F is a multiple of it and every pointer that vectors
// move through is 16-byte aligned, else 1, the scalar path. Any other `v`
// is refused. blockDim is (F / v, rows) with (F / v) * rows =
// kPassThreads where F / v <= kPassThreads, else (F, 1).

namespace {
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);  // 4 f32 or 8 bf16

template <typename T>
bool vector_fits(int f, int v, std::initializer_list<const void*> ptrs) {
  if (v == 1) return true;
  if (v != kVec<T> || f % v != 0) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<size_t>(p) & 15) return false;
  }
  return true;
}

dim3 pass_block(int f, int v) {
  const int t = f / v;
  return dim3(t, t >= kPassThreads ? 1 : kPassThreads / t);
}

template <typename T>
int apply(const void* z, const void* mask, const void* cst, void* out, int n,
          int m, int f, int v, void* stream) {
  if (bad_shape(n, m, f, 1) || !vector_fits<T>(f, v, {z, cst, out})) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block = pass_block(f, v);
  const dim3 grid((n + block.y - 1) / block.y);
  const auto kernel = v == 1 ? &epilogue_apply_kernel<1, T>
                             : &epilogue_apply_kernel<kVec<T>, T>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)z, (const float*)mask, (const float*)cst, (float*)out, n, m,
      f);
  return (int)cudaGetLastError();
}
}  // namespace

// z f32 (`_f32`) or bf16 (`_bf16`, widened on load); out [N, F] f32 in both.
extern "C" int epilogue_apply_f32(const void* z, const void* mask,
                                  const void* cst, void* out, int n, int m,
                                  int f, int v, void* stream) {
  return apply<float>(z, mask, cst, out, n, m, f, v, stream);
}

extern "C" int epilogue_apply_bf16(const void* z, const void* mask,
                                   const void* cst, void* out, int n, int m,
                                   int f, int v, void* stream) {
  return apply<bf16>(z, mask, cst, out, n, m, f, v, stream);
}

// Kernel 4 sizes its own blocks (F / V x 256 V / F threads) and takes
// `blocks` as its last int: `part` is scratch of [blocks, 4, 2F] floats
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
            int v, void* stream) {
  if (bad_shape(n, m, f, 1) ||
      !vector_fits<T>(f, v, {z, cst, red5, ct, dz})) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block = pass_block(f, v);
  const long long units =
      (long long)n * ((m + kDzChunk<T> - 1) / kDzChunk<T>);
  const dim3 grid((unsigned)((units + block.y - 1) / block.y));
  const auto kernel = v == 1 ? &epilogue_dz_kernel<1, T>
                             : &epilogue_dz_kernel<kVec<T>, T>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
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
                               int v, void* stream) {
  return dz_pass<float>(z, mask, cst, red5, ct, dz, n, m, f, v, stream);
}

extern "C" int epilogue_dz_bf16(const void* z, const void* mask,
                                const void* cst, const void* red5,
                                const void* ct, void* dz, int n, int m,
                                int f, int v, void* stream) {
  return dz_pass<bf16>(z, mask, cst, red5, ct, dz, n, m, f, v, stream);
}
