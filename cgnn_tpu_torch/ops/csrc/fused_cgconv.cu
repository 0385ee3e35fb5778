// Whole-conv fused CGConv for Hopper (sm_90a): the apply pass (kernel 1)
// and the batch-statistics pass (kernel 2) of cgnn_tpu/ops/pallas_cgconv.py.
//
// Replaces, in cgnn_tpu/ops/pallas_cgconv.py:
//   kernel 1  fused_cgconv_eval_kernel  <- `_apply_kernel` (through
//             `_pallas_apply`, from `fused_cgconv_eval` and the training
//             forward `_forward_pallas`)
//   kernel 2  fused_cgconv_stats_kernel <- `_stats_kernel` (through
//             `_pallas_stats`, from `_forward_pallas`)
// Per node row i and edge slot s < M, with j = nbr[i*M + s]:
//
//   z   = v_i . W[0:F] + v_j . W[F:2F] + e_is . W[2F:2F+G] + b      [2F]
//   apply: y = (z - mean) * rstd_scale + bn_bias
//          agg = sum over real slots of sigmoid(y[0:F]) * softplus(y[F:2F])
//   stats: over all real slots, sum (z - shift) and sum (z - shift)^2
//
// Only agg [N, F] (apply) or the [2, 2F] sums (stats) are written; neither
// the gathered v_j rows nor z ever reach device memory. All arithmetic is
// f32.
//
// What bounds them on an H100: at the flagship's top serving rung (N=1784,
// M=12, F=64, G=41) one launch does ~0.6 GFLOP of f32 FMA against ~4.7 MB
// of compulsory traffic, ~130 FLOP per byte, and at the batch-256 training
// shape (N ~ 7,000) about 4x both: f32 arithmetic (67 TFLOP/s outside the
// tensor cores) bounds them, not the 3.35 TB/s of HBM.
//
// Design (a simple one, right first): a block owns `rows` node rows with
// one thread per gate channel c < F, and that thread also owns core channel
// c + F, so the gate needs no exchange between threads. W [(2F+G), 2F]
// (86.5 KB at full width) is staged once per block in dynamic shared memory.
// The v_i term is computed once per node, not once per slot. For each slot
// the row's v_j and edge rows are staged in shared memory by coalesced
// loads, then every thread takes its two dot products against W; neighbours
// of a warp read consecutive W columns (no bank conflicts) and the staged
// row is a broadcast. Both kernels share this z computation
// (`for_each_real_slot`). The GPU gathers rows directly, so the TPU
// kernels' one-hot window tiles and tail-block garbage rows are gone.
// Padding slots (mask 0) are skipped, which selects them to 0 and never
// multiplies a value into a sum. Sums over slots run in registers in slot
// order. The stats kernel adds its block's rows through shared memory in
// row order into one [2, 2F] partial per block, and a second small kernel
// sums the partials in a fixed order: no float atomics, so the statistics
// are bit-identical from run to run (the TPU grid accumulates in a fixed
// sequential order too). Making it fast (tensor cores, precomputing
// nodes . W[F:2F] once per node so the v_j term becomes a gather of a
// product) is later work.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using cgnn::sigmoid_f32;
using cgnn::softplus_f32;

// Calls visit(z_g, z_c) for every real slot of this thread's row, in slot
// order, where z_g = z[c] and z_c = z[c + F]. Every thread of the block
// must call it (it holds block-wide barriers). Shared memory layout from
// `smem`: W [(2F+G), 2F], then per row v_i [F], v_j [F], e [G].
template <class Visit>
__device__ __forceinline__ void for_each_real_slot(
    const float* __restrict__ nodes, const float* __restrict__ edges,
    const int* __restrict__ nbr, const float* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ bias,
    float* smem, int n, int m, int f, int g, Visit&& visit) {
  const int two_f = 2 * f;
  const int w_len = (two_f + g) * two_f;
  const int rows = blockDim.y;
  float* w_s = smem;
  float* vi_s = w_s + w_len;
  float* vj_s = vi_s + rows * f;
  float* e_s = vj_s + rows * f;

  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const int tid = r * blockDim.x + c;
  const int nthreads = blockDim.x * rows;
  const int row = blockIdx.x * rows + r;
  const bool live = row < n;
  float* vi_r = vi_s + r * f;
  float* vj_r = vj_s + r * f;
  float* e_r = e_s + r * g;

  for (int i = tid; i < w_len; i += nthreads) w_s[i] = w[i];
  if (live) vi_r[c] = nodes[(size_t)row * f + c];
  __syncthreads();

  // v_i . W[0:F] + b, once per node
  float zi_g = 0.0f, zi_c = 0.0f;
  if (live) {
    for (int k = 0; k < f; ++k) {
      const float v = vi_r[k];
      zi_g = fmaf(v, w_s[k * two_f + c], zi_g);
      zi_c = fmaf(v, w_s[k * two_f + c + f], zi_c);
    }
  }
  zi_g += bias[c];
  zi_c += bias[c + f];

  const float* w_j = w_s + f * two_f;
  const float* w_e = w_s + two_f * two_f;
  for (int s = 0; s < m; ++s) {
    const size_t slot = (size_t)row * m + s;
    const bool real = live && mask[slot] > 0.0f;
    if (real) {
      const int j = nbr[slot];
      vj_r[c] = nodes[(size_t)j * f + c];
      for (int q = c; q < g; q += f) e_r[q] = edges[slot * g + q];
    }
    __syncthreads();
    if (real) {
      float zj_g = 0.0f, zj_c = 0.0f;
      for (int k = 0; k < f; ++k) {
        const float v = vj_r[k];
        zj_g = fmaf(v, w_j[k * two_f + c], zj_g);
        zj_c = fmaf(v, w_j[k * two_f + c + f], zj_c);
      }
      float ze_g = 0.0f, ze_c = 0.0f;
      for (int q = 0; q < g; ++q) {
        const float v = e_r[q];
        ze_g = fmaf(v, w_e[q * two_f + c], ze_g);
        ze_c = fmaf(v, w_e[q * two_f + c + f], ze_c);
      }
      visit(zi_g + zj_g + ze_g, zi_c + zj_c + ze_c);
    }
    __syncthreads();
  }
}

__global__ void fused_cgconv_eval_kernel(
    const float* __restrict__ nodes,       // [N, F]
    const float* __restrict__ edges,       // [N, M, G]
    const int* __restrict__ nbr,           // [N * M]
    const float* __restrict__ mask,        // [N, M]
    const float* __restrict__ w,           // [(2F+G), 2F]
    const float* __restrict__ bias,        // [2F]
    const float* __restrict__ mean,        // [2F]
    const float* __restrict__ rstd_scale,  // [2F]
    const float* __restrict__ bn_bias,     // [2F]
    float* __restrict__ out,               // [N, F]
    int n, int m, int f, int g) {
  extern __shared__ float smem[];
  const int c = threadIdx.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const float mu_g = mean[c], mu_c = mean[c + f];
  const float rs_g = rstd_scale[c], rs_c = rstd_scale[c + f];
  const float bb_g = bn_bias[c], bb_c = bn_bias[c + f];
  float acc = 0.0f;
  for_each_real_slot(nodes, edges, nbr, mask, w, bias, smem, n, m, f, g,
                     [&](float z_g, float z_c) {
                       const float y_g = (z_g - mu_g) * rs_g + bb_g;
                       const float y_c = (z_c - mu_c) * rs_c + bb_c;
                       acc += sigmoid_f32(y_g) * softplus_f32(y_c);
                     });
  if (row < n) out[(size_t)row * f + c] = acc;
}

__global__ void fused_cgconv_stats_kernel(
    const float* __restrict__ nodes, const float* __restrict__ edges,
    const int* __restrict__ nbr, const float* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ shift,  // [2F]
    float* __restrict__ part,         // [nblocks, 2, 2F]
    int n, int m, int f, int g) {
  extern __shared__ float smem[];
  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const int rows = blockDim.y;
  const int two_f = 2 * f;
  const float sh_g = shift[c], sh_c = shift[c + f];
  // acc: sum (z_g - shift), sum (z_c - shift), and their squares
  float s1_g = 0.0f, s1_c = 0.0f, s2_g = 0.0f, s2_c = 0.0f;
  for_each_real_slot(nodes, edges, nbr, mask, w, bias, smem, n, m, f, g,
                     [&](float z_g, float z_c) {
                       const float d_g = z_g - sh_g, d_c = z_c - sh_c;
                       s1_g += d_g;
                       s1_c += d_c;
                       s2_g += d_g * d_g;
                       s2_c += d_c * d_c;
                     });
  // after the staging area: [4][rows][F] per-row sums (the loop above
  // ended on a barrier, so the block is past every staged read)
  float* red_s = smem + (two_f + g) * two_f + rows * (two_f + g);
  red_s[(0 * rows + r) * f + c] = s1_g;
  red_s[(1 * rows + r) * f + c] = s1_c;
  red_s[(2 * rows + r) * f + c] = s2_g;
  red_s[(3 * rows + r) * f + c] = s2_c;
  __syncthreads();
  if (r == 0) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = 0; q < 4; ++q) {
      for (int rr = 0; rr < rows; ++rr) t[q] += red_s[(q * rows + rr) * f + c];
    }
    float* p = part + (size_t)blockIdx.x * 2 * two_f;
    p[c] = t[0];
    p[c + f] = t[1];
    p[two_f + c] = t[2];
    p[two_f + c + f] = t[3];
  }
}

bool bad_shape(int n, int m, int f, int g, int rows) {
  return n <= 0 || m <= 0 || f <= 0 || g <= 0 || rows <= 0 || f * rows > 1024;
}

cudaError_t opt_in_smem(const void* kernel, int smem) {
  if (smem > cgnn::kMaxSmemBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// Dynamic shared memory one apply launch needs, in bytes.
extern "C" int cgconv_fused_eval_smem_bytes(int f, int g, int rows) {
  return (int)(sizeof(float) *
               ((size_t)(2 * f + g) * 2 * f + (size_t)rows * (2 * f + g)));
}

// ... and one stats launch: the same, plus [4][rows][F] for the block sums.
extern "C" int cgconv_fused_stats_smem_bytes(int f, int g, int rows) {
  return cgconv_fused_eval_smem_bytes(f, g, rows) +
         (int)(sizeof(float) * 4 * (size_t)rows * f);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// All pointers are device pointers to contiguous row-major f32/i32 data.
extern "C" int cgconv_fused_eval_f32(
    const void* nodes, const void* edges, const void* nbr, const void* mask,
    const void* w, const void* bias, const void* mean,
    const void* rstd_scale, const void* bn_bias, void* out,
    int n, int m, int f, int g, int rows, void* stream) {
  if (bad_shape(n, m, f, g, rows)) return (int)cudaErrorInvalidValue;
  const int smem = cgconv_fused_eval_smem_bytes(f, g, rows);
  cudaError_t err =
      opt_in_smem((const void*)fused_cgconv_eval_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(f, rows);
  const dim3 grid((n + rows - 1) / rows);
  fused_cgconv_eval_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)nodes, (const float*)edges, (const int*)nbr,
      (const float*)mask, (const float*)w, (const float*)bias,
      (const float*)mean, (const float*)rstd_scale, (const float*)bn_bias,
      (float*)out, n, m, f, g);
  return (int)cudaGetLastError();
}

// The stats pass: `part` is scratch of [ceil(N / rows), 2, 2F] floats,
// `out` [2, 2F] receives sum (z - shift) and sum (z - shift)^2.
extern "C" int cgconv_fused_stats_f32(
    const void* nodes, const void* edges, const void* nbr, const void* mask,
    const void* w, const void* bias, const void* shift, void* part,
    void* out, int n, int m, int f, int g, int rows, void* stream) {
  if (bad_shape(n, m, f, g, rows)) return (int)cudaErrorInvalidValue;
  const int smem = cgconv_fused_stats_smem_bytes(f, g, rows);
  cudaError_t err =
      opt_in_smem((const void*)fused_cgconv_stats_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = (n + rows - 1) / rows;
  const dim3 block(f, rows);
  fused_cgconv_stats_kernel<<<nb, block, smem, (cudaStream_t)stream>>>(
      (const float*)nodes, (const float*)edges, (const int*)nbr,
      (const float*)mask, (const float*)w, (const float*)bias,
      (const float*)shift, (float*)part, n, m, f, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cgnn::launch_sum_partials((const float*)part, (float*)out, nb,
                                        4 * f, (cudaStream_t)stream);
}
