// Whole-conv fused CGConv for Hopper (sm_90a): the apply pass (kernel 1)
// and the batch-statistics pass (kernel 2) of cgnn_tpu/ops/pallas_cgconv.py.
//
// Replaces, in cgnn_tpu/ops/pallas_cgconv.py:
//   kernel 1  fused_cgconv_eval_node_kernel + fused_cgconv_eval_slot_kernel
//             <- `_apply_kernel` (through `_pallas_apply`, from
//             `fused_cgconv_eval` and the training forward
//             `_forward_pallas`)
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
// f32. Padding slots (mask 0) are skipped: selected to 0, never multiplied
// into a sum. Sums over slots run in registers in slot order.
//
// Kernel 1. What bounds it on an H100: f32 FMAs (67 TFLOP/s outside the
// tensor cores). Its first design took z whole per slot, W staged in
// shared memory by every block of 8 rows: each FMA loaded ~1.5 floats from
// shared memory, so the shared-memory port, not the FMA units, set the
// time (0.080 ms on the device at the top serving rung, N=1784, M=12,
// F=64, G=41, ~10x its bound), and v_j . W[F:2F], which depends on j
// alone, was recomputed for each of the M slots that point at j. This
// design splits z by where each term varies:
//   launch 1a, the node pass: P [N, 4F] = nodes . [W[0:F] | W[F:2F]] +
//     [b | 0], once per node (58 MFLOP at N=1784), a register-tiled
//     product: a 32 x 64 tile of P a block, 2 x 4 outputs a thread, 64 of
//     the F inputs of nodes and W at a time in shared memory. P is scratch
//     (1.8 MB at N=1784): it stays in L2 for launch 1b.
//   launch 1b, the slot pass: thread (c, y) owns channel pair (c, c + F),
//     so the gate needs no exchange; its two W_e = W[2F:2F+G] columns (82
//     floats at G=41) live in registers, loaded once. A node row's [M, G]
//     edge block, neighbors and mask are staged by cp.async (16-byte copies
//     where G = 44 and rows stay 16-byte aligned, else 4-byte; staged rows
//     are 44 floats apart), double-buffered, so the
//     next row's edges are in flight while this row computes; one barrier
//     a row. Per real slot: z = P[i, 0:2F] + P[j, 2F:4F] + e . W_e, the
//     edge row read from shared memory as broadcast float4s (~0.25 loads
//     an FMA), then BN1 with rstd_scale = rsqrt(var + eps) * scale folded
//     here, and the gate. The register arrays have one size, 44 columns
//     (W_e zero-padded past G, as the staged edge rows are), which holds
//     the flagship's G=41; for G > 44 the slot pass keeps W_e in shared
//     memory instead (`fused_cgconv_eval_slot_smem_kernel`). A slot-pass
//     block takes 8 node rows.
// Tensor cores are not used: the only per-slot product left has depth G,
// and TF32 keeps ~3 digits, short of the kernel's rtol 1e-4 contract.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W at the top
// serving rung: 0.029 ms on the device (node pass 0.0076, slot pass
// 0.0217), against 0.080 ms for the first design and a least-work bound
// of 0.0041 ms. The slot pass's e . W_e FMAs (~3.3 us at the f32 peak)
// take 0.0217 ms: at 128 registers a thread, 16 warps an SM hide too
// little of their latency. PERF.md's kernel table keeps the latest
// times.
//
// Kernel 2 still uses the first design's z routine, `for_each_real_slot`:
// W [(2F+G), 2F] staged once per block in dynamic shared memory; per slot
// the row's v_j and edge rows are staged by coalesced loads, then every
// thread takes its two dot products against W. It adds its block's rows
// through shared memory in row order into one [2, 2F] partial per block,
// and a second small kernel sums the partials in a fixed order: no float
// atomics, so the statistics are bit-identical from run to run (the TPU
// grid accumulates in a fixed sequential order too). The GPU gathers rows
// directly, so the TPU kernels' one-hot window tiles and tail-block
// garbage rows are gone.

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

// ---------------------------------------------------------------------------
// kernel 1, the apply pass: launch 1a (node pass), then launch 1b (slot pass)
// ---------------------------------------------------------------------------

constexpr int kNodeRows = 32;  // node pass: a block's [32 rows x 64 columns]
constexpr int kNodeCols = 64;
constexpr int kNodeK = 64;     // ... over 64 of the F inputs at a time
constexpr int kSlotThreads = 256;  // slot pass: F x RY threads at most
constexpr int kRegQ = 11;          // float4s of W_e columns in registers:
constexpr int kRegG = 4 * kRegQ;   // W_e in registers while G <= 44
constexpr int kStageBudget = 48 * 1024;  // bytes of staged edge rows a block
constexpr int kSlotRowsPerBlock = 8;     // node rows a slot-pass block

// Launch 1a: P [N, 4F] = nodes [N, F] . [W_i | W_j] + [b | 0], with
// W_i = W[0:F] and W_j = W[F:2F] (each [F, 2F]). A block computes a 32 x 64
// tile of P; each of its 256 threads a 2 x 4 block of it in registers.
// Up to 64 of the F inputs are staged at a time (one load phase at F=64,
// every load in flight at once), nodes' rows and W's columns in shared
// memory. Each output adds its F products in k order, then the bias.
__global__ void __launch_bounds__(256) fused_cgconv_eval_node_kernel(
    const float* __restrict__ nodes, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ p, int n, int f) {
  __shared__ __align__(16) float a_s[kNodeK][kNodeRows + 4];  // [k][row]
  __shared__ __align__(16) float b_s[kNodeK][kNodeCols];      // [k][col]
  const int two_f = 2 * f, four_f = 4 * f;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kNodeRows, col0 = blockIdx.y * kNodeCols;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < f; k0 += kNodeK) {
    // fixed trip counts: every load of the slice is in flight at once
#pragma unroll
    for (int it = 0; it < kNodeK * kNodeRows / 256; ++it) {
      const int i = tid + it * 256;
      const int r = i / kNodeK, kk = i % kNodeK;
      const int row = row0 + r, k = k0 + kk;
      a_s[kk][r] = (row < n && k < f) ? nodes[(size_t)row * f + k] : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < kNodeK * kNodeCols / 256; ++it) {
      const int i = tid + it * 256;
      const int kk = i / kNodeCols, cc = i % kNodeCols;
      const int k = k0 + kk, col = col0 + cc;
      float v = 0.0f;
      if (k < f && col < four_f) {
        v = col < two_f ? w[(size_t)k * two_f + col]
                        : w[(size_t)(f + k) * two_f + col - two_f];
      }
      b_s[kk][cc] = v;
    }
    __syncthreads();
    // the next k's shared loads are issued before this k's FMAs
    const int k_end = min(kNodeK, f - k0);
    float2 a_next = *reinterpret_cast<const float2*>(&a_s[0][ty * 2]);
    float4 b_next = *reinterpret_cast<const float4*>(&b_s[0][tx * 4]);
#pragma unroll 8
    for (int kk = 0; kk < k_end; ++kk) {
      const float2 a = a_next;
      const float4 b = b_next;
      if (kk + 1 < kNodeK) {
        a_next = *reinterpret_cast<const float2*>(&a_s[kk + 1][ty * 2]);
        b_next = *reinterpret_cast<const float4*>(&b_s[kk + 1][tx * 4]);
      }
      const float av[2] = {a.x, a.y};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  const int col = col0 + tx * 4;  // 4F is a multiple of 4: a whole float4
  if (col >= four_f) return;
  float bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bv[j] = col + j < two_f ? bias[col + j] : 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ty * 2 + i;
    if (row < n) {
      *reinterpret_cast<float4*>(p + (size_t)row * four_f + col) =
          make_float4(acc[i][0] + bv[0], acc[i][1] + bv[1], acc[i][2] + bv[2],
                      acc[i][3] + bv[3]);
    }
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Floats one staged node row takes in shared memory: its edges [M][G4]
// (rows padded to 16 bytes), then nbr [M] and mask [M], rounded up to 4.
__host__ __device__ inline int stage_floats(int m, int g4) {
  return m * g4 + ((2 * m + 3) & ~3);
}

// The BN fold and gate of one slot, added into agg.
__device__ __forceinline__ void add_gated(float z_g, float z_c, float mu_g,
                                          float mu_c, float rs_g, float rs_c,
                                          float bb_g, float bb_c, float& agg) {
  const float y_g = (z_g - mu_g) * rs_g + bb_g;
  const float y_c = (z_c - mu_c) * rs_c + bb_c;
  agg += sigmoid_f32(y_g) * softplus_f32(y_c);
}

// Launch 1b, W_e in registers (G <= kRegG): block (F, RY); thread (c, y)
// owns channel pair (c, c + F) of rows row0 + y + RY * k, k < k_rows.
// The 2 * kRegG floats of its two W_e columns (0 past G) are loaded once. Each row's
// edge block [M, G] (contiguous in device memory), neighbors and mask are
// staged by cp.async into one of two buffers while the block computes the
// row before (one barrier a row). Per real slot, in slot order:
//   z = P[row, 0:2F] + P[j, 2F:4F] + e . W_e,
// the edge row read as broadcast float4s; then BN1 with the given stats,
// sigmoid * softplus, added into agg. Padding slots are skipped.
__global__ void __launch_bounds__(kSlotThreads, 2)
    fused_cgconv_eval_slot_kernel(
    const float* __restrict__ p, const float* __restrict__ edges,
    const int* __restrict__ nbr, const float* __restrict__ mask,
    const float* __restrict__ w_e, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ scale,
    const float* __restrict__ bn_bias, float eps, float* __restrict__ out,
    int n, int m, int f, int g, int k_rows) {
  constexpr int KQ = kRegQ, G4 = kRegG;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c = threadIdx.x, y = threadIdx.y, ry = blockDim.y;
  const int tid = y * f + c, nthreads = f * ry;
  const int two_f = 2 * f, four_f = 4 * f;
  const int stage = stage_floats(m, G4);
  const int row0 = blockIdx.x * ry * k_rows;
  const bool vec16 = g == G4 && (reinterpret_cast<size_t>(edges) & 15) == 0;

  // the pad columns [G, G4) stay 0 (the copies never write them)
  for (int i = tid; i < 2 * ry * stage; i += nthreads) smem[i] = 0.0f;
  __syncthreads();

  auto stage_row = [&](int k) {
    const int row = row0 + y + ry * k;
    if (row >= n) return;
    float* e_s = smem + ((k & 1) * ry + y) * stage;
    const float* src = edges + (size_t)row * m * g;
    if (vec16) {
      for (int i = c; i < m * KQ; i += f) cp_async16(e_s + 4 * i, src + 4 * i);
    } else {
      int s = c / g, q = c % g;
      for (int i = c; i < m * g; i += f) {
        cp_async4(e_s + s * G4 + q, src + i);
        for (q += f; q >= g; q -= g) ++s;
      }
    }
    for (int i = c; i < m; i += f) {
      cp_async4(e_s + m * G4 + i, nbr + (size_t)row * m + i);
      cp_async4(e_s + m * G4 + m + i, mask + (size_t)row * m + i);
    }
  };

  stage_row(0);
  cp_async_commit();

  float wg[G4], wc[G4];
#pragma unroll
  for (int q = 0; q < G4; ++q) {
    wg[q] = q < g ? w_e[q * two_f + c] : 0.0f;
    wc[q] = q < g ? w_e[q * two_f + c + f] : 0.0f;
  }
  const float mu_g = mean[c], mu_c = mean[c + f];
  const float rs_g = rsqrtf(var[c] + eps) * scale[c];
  const float rs_c = rsqrtf(var[c + f] + eps) * scale[c + f];
  const float bb_g = bn_bias[c], bb_c = bn_bias[c + f];

  for (int k = 0; k < k_rows; ++k) {
    cp_async_wait_all();
    __syncthreads();  // row k is staged; every thread is done with row k - 1
    if (k + 1 < k_rows) {
      stage_row(k + 1);  // into the buffer row k - 1 used
      cp_async_commit();
    }
    const int row = row0 + y + ry * k;
    if (row >= n) continue;
    const float* e_s = smem + ((k & 1) * ry + y) * stage;
    const int* nb_s = reinterpret_cast<const int*>(e_s + m * G4);
    const float* mk_s = e_s + m * G4 + m;
    const float* p_row = p + (size_t)row * four_f;
    const float pi_g = p_row[c], pi_c = p_row[f + c];
    float agg = 0.0f;
    // real slots only (padding: selected to 0, never multiplied); the next
    // real slot's P[j] row is loaded while this one computes
    int s = 0;
    while (s < m && !(mk_s[s] > 0.0f)) ++s;
    float pj_g = 0.0f, pj_c = 0.0f;
    if (s < m) {
      const float* p_j = p + (size_t)nb_s[s] * four_f + two_f;
      pj_g = p_j[c];
      pj_c = p_j[f + c];
    }
    while (s < m) {
      int t = s + 1;
      while (t < m && !(mk_s[t] > 0.0f)) ++t;
      float nj_g = 0.0f, nj_c = 0.0f;
      if (t < m) {
        const float* p_j = p + (size_t)nb_s[t] * four_f + two_f;
        nj_g = p_j[c];
        nj_c = p_j[f + c];
      }
      const float4* e4 = reinterpret_cast<const float4*>(e_s + s * G4);
      float g0 = 0.0f, g1 = 0.0f, c0 = 0.0f, c1 = 0.0f;
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        const float4 v = e4[q];
        g0 = fmaf(v.x, wg[4 * q], g0);
        c0 = fmaf(v.x, wc[4 * q], c0);
        g1 = fmaf(v.y, wg[4 * q + 1], g1);
        c1 = fmaf(v.y, wc[4 * q + 1], c1);
        g0 = fmaf(v.z, wg[4 * q + 2], g0);
        c0 = fmaf(v.z, wc[4 * q + 2], c0);
        g1 = fmaf(v.w, wg[4 * q + 3], g1);
        c1 = fmaf(v.w, wc[4 * q + 3], c1);
      }
      add_gated((pi_g + pj_g) + (g0 + g1), (pi_c + pj_c) + (c0 + c1), mu_g,
                mu_c, rs_g, rs_c, bb_g, bb_c, agg);
      s = t;
      pj_g = nj_g;
      pj_c = nj_c;
    }
    out[(size_t)row * f + c] = agg;
  }
}

// Launch 1b for G > kRegG: W_e [G, 2F] in shared memory, the edge
// rows read from device memory (a broadcast within a row's threads).
__global__ void __launch_bounds__(kSlotThreads)
    fused_cgconv_eval_slot_smem_kernel(
    const float* __restrict__ p, const float* __restrict__ edges,
    const int* __restrict__ nbr, const float* __restrict__ mask,
    const float* __restrict__ w_e, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ scale,
    const float* __restrict__ bn_bias, float eps, float* __restrict__ out,
    int n, int m, int f, int g, int k_rows) {
  extern __shared__ float4 smem4[];
  float* we_s = reinterpret_cast<float*>(smem4);  // [G, 2F]
  const int c = threadIdx.x, y = threadIdx.y, ry = blockDim.y;
  const int two_f = 2 * f, four_f = 4 * f;
  for (int i = y * f + c; i < g * two_f; i += f * ry) we_s[i] = w_e[i];
  __syncthreads();
  const float mu_g = mean[c], mu_c = mean[c + f];
  const float rs_g = rsqrtf(var[c] + eps) * scale[c];
  const float rs_c = rsqrtf(var[c + f] + eps) * scale[c + f];
  const float bb_g = bn_bias[c], bb_c = bn_bias[c + f];
  const int row0 = blockIdx.x * ry * k_rows;
  for (int k = 0; k < k_rows; ++k) {
    const int row = row0 + y + ry * k;
    if (row >= n) break;
    const float* p_row = p + (size_t)row * four_f;
    const float pi_g = p_row[c], pi_c = p_row[f + c];
    float agg = 0.0f;
    for (int s = 0; s < m; ++s) {
      const size_t slot = (size_t)row * m + s;
      if (!(mask[slot] > 0.0f)) continue;
      const float* p_j = p + (size_t)nbr[slot] * four_f + two_f;
      const float* e = edges + slot * g;
      float z_g = 0.0f, z_c = 0.0f;
      for (int q = 0; q < g; ++q) {
        const float v = e[q];
        z_g = fmaf(v, we_s[q * two_f + c], z_g);
        z_c = fmaf(v, we_s[q * two_f + c + f], z_c);
      }
      add_gated((pi_g + p_j[c]) + z_g, (pi_c + p_j[f + c]) + z_c, mu_g, mu_c,
                rs_g, rs_c, bb_g, bb_c, agg);
    }
    out[(size_t)row * f + c] = agg;
  }
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

// Thread rows of one slot-pass block (blockDim.y) for M, F, G.
int slot_pass_rows(int m, int f, int g) {
  int ry = f >= kSlotThreads ? 1 : kSlotThreads / f;
  if (g > kRegG) return ry;
  while (ry > 1 && 2 * ry * stage_floats(m, kRegG) * 4 > kStageBudget) --ry;
  return ry;
}

// Whether the slot pass keeps W_e in registers (G <= kRegG and the staged
// rows fit), else its shared-memory variant runs.
bool slot_pass_in_registers(int m, int f, int g) {
  const int smem = 2 * slot_pass_rows(m, f, g) * stage_floats(m, kRegG) * 4;
  return g <= kRegG && smem <= cgnn::kMaxSmemBytes;
}

}  // namespace

// Dynamic shared memory of `for_each_real_slot`: W plus a row of v_i, v_j
// and e for each of the block's rows, in bytes.
extern "C" int cgconv_fused_z_smem_bytes(int f, int g, int rows) {
  return (int)(sizeof(float) *
               ((size_t)(2 * f + g) * 2 * f + (size_t)rows * (2 * f + g)));
}

// ... and one stats launch: the same, plus [4][rows][F] for the block sums.
extern "C" int cgconv_fused_stats_smem_bytes(int f, int g, int rows) {
  return cgconv_fused_z_smem_bytes(f, g, rows) +
         (int)(sizeof(float) * 4 * (size_t)rows * f);
}

// Kernel 1, the apply pass: launch 1a writes P [N, 4F] (scratch, `p`), then
// launch 1b reads it; rstd_scale = rsqrt(var + eps) * scale is folded in
// the kernel.
// Launches on `stream`; returns the cudaError_t of the launches (0 =
// queued). All pointers are device pointers to contiguous row-major
// f32/i32 data.
extern "C" int cgconv_fused_eval_f32(
    const void* nodes, const void* edges, const void* nbr, const void* mask,
    const void* w, const void* bias, const void* mean, const void* var,
    const void* scale, const void* bn_bias, void* p, void* out, int n, int m,
    int f, int g, float eps, void* stream) {
  if (bad_shape(n, m, f, g, 1) || f > kSlotThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 node_grid((n + kNodeRows - 1) / kNodeRows,
                       (4 * f + kNodeCols - 1) / kNodeCols);
  fused_cgconv_eval_node_kernel<<<node_grid, 256, 0, st>>>(
      (const float*)nodes, (const float*)w, (const float*)bias, (float*)p, n,
      f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int ry = slot_pass_rows(m, f, g);
  const int k_rows = (kSlotRowsPerBlock + ry - 1) / ry;
  const dim3 block(f, ry);
  const dim3 grid((n + ry * k_rows - 1) / (ry * k_rows));
  const float* w_e = (const float*)w + (size_t)2 * f * 2 * f;
  if (!slot_pass_in_registers(m, f, g)) {
    const int smem = (int)sizeof(float) * g * 2 * f;
    err = opt_in_smem((const void*)fused_cgconv_eval_slot_smem_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fused_cgconv_eval_slot_smem_kernel<<<grid, block, smem, st>>>(
        (const float*)p, (const float*)edges, (const int*)nbr,
        (const float*)mask, w_e, (const float*)mean, (const float*)var,
        (const float*)scale, (const float*)bn_bias, eps, (float*)out, n, m, f,
        g, k_rows);
    return (int)cudaGetLastError();
  }
  const int smem = 2 * ry * stage_floats(m, kRegG) * (int)sizeof(float);
  if (smem > kStageBudget) {
    err = opt_in_smem((const void*)fused_cgconv_eval_slot_kernel, smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_cgconv_eval_slot_kernel<<<grid, block, smem, st>>>(
      (const float*)p, (const float*)edges, (const int*)nbr,
      (const float*)mask, w_e, (const float*)mean, (const float*)var,
      (const float*)scale, (const float*)bn_bias, eps, (float*)out, n, m, f,
      g, k_rows);
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
