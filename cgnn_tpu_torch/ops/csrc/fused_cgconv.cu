// Whole-conv fused CGConv, eval pass, for Hopper (sm_90a).
//
// Replaces: cgnn_tpu/ops/pallas_cgconv.py `_apply_kernel` (reached through
// `_pallas_apply` from `fused_cgconv_eval`). Per node row i and edge slot
// s < M, with j = nbr[i*M + s]:
//
//   z   = v_i . W[0:F] + v_j . W[F:2F] + e_is . W[2F:2F+G] + b      [2F]
//   y   = (z - mean) * rstd_scale + bn_bias                         [2F]
//   agg = sum over real slots of sigmoid(y[0:F]) * softplus(y[F:2F]) [F]
//
// Only agg [N, F] is written; neither the gathered v_j rows nor z ever
// reach device memory. All arithmetic is f32.
//
// What bounds it on an H100: at the flagship's top serving rung (N=1784,
// M=12, F=64, G=41) one launch does ~0.6 GFLOP of f32 FMA against ~4.7 MB
// of compulsory traffic, ~130 FLOP per byte, so f32 arithmetic (67 TFLOP/s
// outside the tensor cores) bounds it, not the 3.35 TB/s of HBM.
//
// Design (a simple one, right first): a block owns `rows` node rows with
// one thread per gate channel c < F, and that thread also owns core channel
// c + F, so the gate needs no exchange between threads. W [(2F+G), 2F]
// (86.5 KB at full width) is staged once per block in dynamic shared memory.
// The v_i term is computed once per node, not once per slot. For each slot
// the row's v_j and edge rows are staged in shared memory by coalesced
// loads, then every thread takes its two dot products against W; neighbours
// of a warp read consecutive W columns (no bank conflicts) and the staged
// row is a broadcast. The GPU gathers rows directly, so the TPU kernel's
// one-hot window tiles are gone. Padding slots (mask 0) are skipped, which
// selects them to 0 and never multiplies a value into the sum. The sum over
// slots runs in a register in slot order: deterministic, no atomics.
// Making it fast (tensor cores, precomputing nodes . W[F:2F] once per node
// so the v_j term becomes a gather of a product) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in per block on sm_90

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// the jax.nn.softplus form: stable for large |x|
__device__ __forceinline__ float softplus_f32(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
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
  const int two_f = 2 * f;
  const int w_len = (two_f + g) * two_f;
  const int rows = blockDim.y;
  float* w_s = smem;                    // [(2F+G), 2F]
  float* vi_s = w_s + w_len;            // [rows, F]
  float* vj_s = vi_s + rows * f;        // [rows, F]
  float* e_s = vj_s + rows * f;         // [rows, G]

  const int c = threadIdx.x;  // gate channel c, core channel c + F
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

  const float mu_g = mean[c], mu_c = mean[c + f];
  const float rs_g = rstd_scale[c], rs_c = rstd_scale[c + f];
  const float bb_g = bn_bias[c], bb_c = bn_bias[c + f];
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
  float acc = 0.0f;
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
      const float y_g = ((zi_g + zj_g + ze_g) - mu_g) * rs_g + bb_g;
      const float y_c = ((zi_c + zj_c + ze_c) - mu_c) * rs_c + bb_c;
      acc += sigmoid_f32(y_g) * softplus_f32(y_c);
    }
    __syncthreads();
  }
  if (live) out[(size_t)row * f + c] = acc;
}

}  // namespace

// Dynamic shared memory one launch needs, in bytes.
extern "C" int cgconv_fused_eval_smem_bytes(int f, int g, int rows) {
  return (int)(sizeof(float) *
               ((size_t)(2 * f + g) * 2 * f + (size_t)rows * (2 * f + g)));
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// All pointers are device pointers to contiguous row-major f32/i32 data.
extern "C" int cgconv_fused_eval_f32(
    const void* nodes, const void* edges, const void* nbr, const void* mask,
    const void* w, const void* bias, const void* mean,
    const void* rstd_scale, const void* bn_bias, void* out,
    int n, int m, int f, int g, int rows, void* stream) {
  if (n <= 0 || m <= 0 || f <= 0 || g <= 0 || rows <= 0 ||
      f * rows > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = cgconv_fused_eval_smem_bytes(f, g, rows);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_cgconv_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
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
