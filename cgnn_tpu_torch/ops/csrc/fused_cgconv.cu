// Whole-conv fused CGConv for Hopper (sm_90a): the apply pass (kernel 1)
// and the batch-statistics pass (kernel 2) of cgnn_tpu/ops/pallas_cgconv.py.
//
// Replaces, in cgnn_tpu/ops/pallas_cgconv.py:
//   kernel 1  fused_cgconv_eval_node_kernel + fused_cgconv_eval_slot_kernel
//             <- `_apply_kernel` (through `_pallas_apply`, from
//             `fused_cgconv_eval` and the training forward
//             `_forward_pallas`)
//   kernel 2  fused_cgconv_eval_node_kernel + fused_cgconv_stats_slot_kernel
//             <- `_stats_kernel` (through `_pallas_stats`, from
//             `_forward_pallas`)
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
// Kernel 2, the stats pass, runs on the same factored z. What bounds it
// on an H100: f32 FMAs, as kernel 1. Its first design took z whole per
// slot (W [(2F+G), 2F] staged by every block of 8 rows, two block barriers
// a slot, about one shared-memory load an FMA): 0.340 ms on the device at
// the flagship's training shape (N=7832, M=12, F=64, G=41), 8.5x the count
// of the work it did. This design:
//   launch 2a, kernel 1's node pass (above), writing P [N, 4F]; in
//     training one node pass a conv feeds both slot passes, so the stats
//     pass skips it when handed P;
//   launch 2b, the stats slot pass: the N*M slots, in their flat order,
//     are the rows of an [N*M, G] x [G, 2F] product whose epilogue takes
//     moments. A block owns a column tile of 128 channels (blockIdx.y)
//     and stages its W_e columns [G, 128] in shared memory once; a
//     persistent grid of at most kStatsBlocks blocks walks tiles of 64
//     slots at a fixed stride. A tile's edge rows (64 G contiguous floats),
//     neighbors and mask are staged by 4-byte cp.async copies into one of
//     two buffers while the block computes the tile before (rows padded to
//     a multiple of 4 floats with zeros, so they read as float4s). Thread
//     (tx, ty) of 256 keeps a 4-slot x 8-channel tile of e . W_e in
//     registers (slots 4 ty .. 4 ty + 3; channels 4 tx .. 4 tx + 3 and
//     64 + 4 tx .. 64 + 4 tx + 3 of the tile, so a quarter warp's W_e
//     loads cover 128 contiguous bytes): per 4 of the G inputs, 4 float4
//     edge loads (each a broadcast to 16 threads) and 8 float4 W_e loads
//     for 128 FMAs. The epilogue adds P[i, 0:2F] + P[j, 2F:4F] from L2,
//     subtracts the shift and, on a real slot only (a padding slot's z,
//     NaN edges included, is selected away, never added), adds d and d^2
//     to the thread's per-channel sums, kept in registers across every
//     tile the block walks;
//   launch 2c: each block adds its threads' sums through shared memory in
//     thread-row order into one [2, 2F] partial, and `sum_partials`
//     adds the partials in a fixed order.
// No float atomics: the statistics are bit-identical from run to run (the
// TPU grid accumulates in a fixed sequential order too), and the same
// whether the node pass ran inside the stats call or before it. Tensor
// cores are not used: 3xTF32 mma.sync would hold the tolerance, but at
// G=41 the FFMA design's bound (~0.019 ms with the node pass) leaves the
// staging and the epilogue, not the product, as the question to measure
// first. The GPU gathers rows directly, so the TPU kernels' one-hot window
// tiles and tail-block garbage rows are gone.
//
// bf16 instances (`cgconv_fused_*_bf16`). The TPU kernel loads bf16 nodes
// and edges and widens them to f32 before any arithmetic
// (`_z_block`, pallas_cgconv.py:250-256); its constants (W, b, the BN
// vectors) stay f32. Each kernel above is therefore a template on the
// storage type T of nodes (the node pass) and edges (the slot passes):
// T = __nv_bfloat16 widens every element on load (`cgnn::to_f32`) and
// runs the f32 instance's arithmetic in the same order, so a bf16
// instance gives the f32 instance's bits on the widened inputs. P, agg
// and the stats stay f32. The staged copies differ: a bf16 edge row of
// G = 41 is 82 bytes, not a multiple of 16 or even 4, so a bf16 slot pass
// stages its rows by plain 2-byte loads widened into the same f32 staging
// layout (no cp.async; shared-memory sizes unchanged), issued after the
// barrier of the row or tile before, as the f32 copies are. What bounds
// them: the same f32 FMAs; the edge bytes halve.

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using cgnn::sigmoid_f32;
using cgnn::softplus_f32;
using cgnn::to_f32;
using bf16 = __nv_bfloat16;

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
template <typename T>
__global__ void __launch_bounds__(256) fused_cgconv_eval_node_kernel(
    const T* __restrict__ nodes, const float* __restrict__ w,
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
      a_s[kk][r] = (row < n && k < f) ? to_f32(nodes[(size_t)row * f + k])
                                      : 0.0f;
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
template <typename T>
__global__ void __launch_bounds__(kSlotThreads, 2)
    fused_cgconv_eval_slot_kernel(
    const float* __restrict__ p, const T* __restrict__ edges,
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
  const bool vec16 = std::is_same_v<T, float> && g == G4 &&
                     (reinterpret_cast<size_t>(edges) & 15) == 0;

  // the pad columns [G, G4) stay 0 (the copies never write them)
  for (int i = tid; i < 2 * ry * stage; i += nthreads) smem[i] = 0.0f;
  __syncthreads();

  auto stage_row = [&](int k) {
    const int row = row0 + y + ry * k;
    if (row >= n) return;
    float* e_s = smem + ((k & 1) * ry + y) * stage;
    const T* src = edges + (size_t)row * m * g;
    if constexpr (std::is_same_v<T, float>) {
      if (vec16) {
        for (int i = c; i < m * KQ; i += f) {
          cp_async16(e_s + 4 * i, src + 4 * i);
        }
      } else {
        int s = c / g, q = c % g;
        for (int i = c; i < m * g; i += f) {
          cp_async4(e_s + s * G4 + q, src + i);
          for (q += f; q >= g; q -= g) ++s;
        }
      }
    } else {  // bf16: widened on the way in (header note)
      int s = c / g, q = c % g;
      for (int i = c; i < m * g; i += f) {
        e_s[s * G4 + q] = to_f32(src[i]);
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
template <typename T>
__global__ void __launch_bounds__(kSlotThreads)
    fused_cgconv_eval_slot_smem_kernel(
    const float* __restrict__ p, const T* __restrict__ edges,
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
      const T* e = edges + slot * g;
      float z_g = 0.0f, z_c = 0.0f;
      for (int q = 0; q < g; ++q) {
        const float v = to_f32(e[q]);
        z_g = fmaf(v, we_s[q * two_f + c], z_g);
        z_c = fmaf(v, we_s[q * two_f + c + f], z_c);
      }
      add_gated((pi_g + p_j[c]) + z_g, (pi_c + p_j[f + c]) + z_c, mu_g, mu_c,
                rs_g, rs_c, bb_g, bb_c, agg);
    }
    out[(size_t)row * f + c] = agg;
  }
}

// ---------------------------------------------------------------------------
// kernel 2, the stats pass: launch 2a (the node pass above), then launch 2b
// ---------------------------------------------------------------------------

constexpr int kStatsThreads = 256;   // 16 column threads x 16 slot threads
constexpr int kStatsTileSlots = 64;  // slots a tile: 16 thread rows x 4
constexpr int kStatsTileCols = 128;  // channels a block: 16 threads x 8
constexpr int kStatsRed = 2 * 16 * kStatsTileCols;  // floats of the block sum

// Floats between two staged edge rows: G rounded up to 4, plus 4 where
// that is a multiple of 8 (two thread rows' float4 loads then fall on
// different banks).
__host__ __device__ inline int stats_row_stride(int g) {
  const int g4 = (g + 3) & ~3;
  return (g4 & 7) ? g4 : g4 + 4;
}

// Floats one staged tile takes: its edge rows, then nbr and mask.
__host__ __device__ inline int stats_stage_floats(int g) {
  return kStatsTileSlots * (stats_row_stride(g) + 2);
}

// Dynamic shared memory of launch 2b: W_e's columns [G4][128], then two
// staged tiles; at least the block sum's [2][16][128] (which reuses it).
__host__ __device__ inline int stats_smem_floats(int g) {
  const int used = ((g + 3) & ~3) * kStatsTileCols + 2 * stats_stage_floats(g);
  return used > kStatsRed ? used : kStatsRed;
}

// Launch 2b: over the real slots, sum (z - shift) and (z - shift)^2 per
// channel, z = P[i, 0:2F] + P[j, 2F:4F] + e . W_e; block (x, y) walks
// tiles x, x + gridDim.x, ... over columns 128 y .. 128 y + 127 and writes
// its [2, 128] share of partial x (see the header note).
template <typename T>
__global__ void __launch_bounds__(kStatsThreads, 2)
    fused_cgconv_stats_slot_kernel(
    const float* __restrict__ p, const T* __restrict__ edges,
    const int* __restrict__ nbr, const float* __restrict__ mask,
    const float* __restrict__ w_e, const float* __restrict__ shift,
    float* __restrict__ part, int n, int m, int f, int g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int two_f = 2 * f, four_f = 4 * f;
  const int g4 = (g + 3) & ~3;
  const int stride = stats_row_stride(g);
  const int stage = stats_stage_floats(g);
  float* w_s = smem;                         // [G4][128]
  float* st_s = smem + g4 * kStatsTileCols;  // two staged tiles
  const int col0 = blockIdx.y * kStatsTileCols;
  const long long total = (long long)n * m;
  const int n_tiles = (int)((total + kStatsTileSlots - 1) / kStatsTileSlots);
  // P's rows as float4s where every column group of 4 is whole
  const bool vec_p =
      (two_f & 3) == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;

  // the pad columns [G, stride) of staged rows stay 0 (copies never
  // write them); W_e is 0 past G and past 2F
  for (int i = tid; i < 2 * stage; i += kStatsThreads) st_s[i] = 0.0f;
  for (int i = tid; i < g4 * kStatsTileCols; i += kStatsThreads) {
    const int k = i / kStatsTileCols, col = col0 + i % kStatsTileCols;
    w_s[i] = (k < g && col < two_f) ? w_e[(size_t)k * two_f + col] : 0.0f;
  }
  __syncthreads();

  // thread element i of a tile's 64 G edge floats -> staged (slot, column)
  const int ds = kStatsThreads / g, dq = kStatsThreads - ds * g;
  auto stage_tile = [&](int tile, int buf) {
    float* e_s = st_s + buf * stage;
    const long long base = (long long)tile * kStatsTileSlots;
    const int slots = (int)min((long long)kStatsTileSlots, total - base);
    const T* src = edges + base * g;
    int s = tid / g, q = tid - s * g;
    for (int i = tid; i < slots * g; i += kStatsThreads) {
      if constexpr (std::is_same_v<T, float>) {
        cp_async4(e_s + s * stride + q, src + i);
      } else {  // bf16: widened on the way in (header note)
        e_s[s * stride + q] = to_f32(src[i]);
      }
      s += ds;
      q += dq;
      if (q >= g) {
        q -= g;
        ++s;
      }
    }
    float* nb_s = e_s + kStatsTileSlots * stride;
    for (int i = tid; i < slots; i += kStatsThreads) {
      cp_async4(nb_s + i, nbr + base + i);
      cp_async4(nb_s + kStatsTileSlots + i, mask + base + i);
    }
  };

  int cols[8];  // this thread's channels (>= 2F: none)
  float sh[8], s1[8], s2[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    cols[c] = col0 + (c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4);
    sh[c] = cols[c] < two_f ? shift[cols[c]] : 0.0f;
    s1[c] = 0.0f;
    s2[c] = 0.0f;
  }

  const int step = gridDim.x;
  if ((int)blockIdx.x < n_tiles) stage_tile(blockIdx.x, 0);
  cp_async_commit();
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += step, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is staged; every thread is past the last
    if (tile + step < n_tiles) stage_tile(tile + step, buf ^ 1);
    cp_async_commit();
    const float* e_s = st_s + buf * stage;
    const float* e_row = e_s + 4 * ty * stride;

    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[q][c] = 0.0f;
    }
    for (int k = 0; k < g4; k += 4) {
      float4 e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        e[q] = *reinterpret_cast<const float4*>(e_row + q * stride + k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* w_k = w_s + (k + kk) * kStatsTileCols + 4 * tx;
        const float4 wa = *reinterpret_cast<const float4*>(w_k);
        const float4 wb = *reinterpret_cast<const float4*>(w_k + 64);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float ev = kk == 0 ? e[q].x
                           : kk == 1 ? e[q].y
                           : kk == 2 ? e[q].z : e[q].w;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(ev, wv[c], acc[q][c]);
        }
      }
    }

    // the epilogue: real slots only, in slot order
    const int* nb_s =
        reinterpret_cast<const int*>(e_s + kStatsTileSlots * stride);
    const float* mk_s = e_s + kStatsTileSlots * stride + kStatsTileSlots;
    const long long base = (long long)tile * kStatsTileSlots;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ls = 4 * ty + q;
      if (base + ls >= total || !(mk_s[ls] > 0.0f)) continue;
      const float* p_i = p + (size_t)((base + ls) / m) * four_f;
      const float* p_j = p + (size_t)nb_s[ls] * four_f + two_f;
      float pv[8];
      if (vec_p) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = cols[4 * h];
          if (col < two_f) {
            const float4 a = *reinterpret_cast<const float4*>(p_i + col);
            const float4 b = *reinterpret_cast<const float4*>(p_j + col);
            pv[4 * h] = a.x + b.x;
            pv[4 * h + 1] = a.y + b.y;
            pv[4 * h + 2] = a.z + b.z;
            pv[4 * h + 3] = a.w + b.w;
          } else {
            pv[4 * h] = pv[4 * h + 1] = pv[4 * h + 2] = pv[4 * h + 3] = 0.0f;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          pv[c] = cols[c] < two_f ? p_i[cols[c]] + p_j[cols[c]] : 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float d = (pv[c] + acc[q][c]) - sh[c];
        s1[c] += d;
        s2[c] += d * d;
      }
    }
  }

  // the block's sums, in thread-row order, through shared memory
  __syncthreads();  // every thread is past its last staged read
  float* red = smem;  // [2][16][128]
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int lc = cols[c] - col0;
    red[ty * kStatsTileCols + lc] = s1[c];
    red[(16 + ty) * kStatsTileCols + lc] = s2[c];
  }
  __syncthreads();
  const int moment = tid >> 7, lc = tid & (kStatsTileCols - 1);
  float t = 0.0f;
  for (int r = 0; r < 16; ++r) {
    t += red[(moment * 16 + r) * kStatsTileCols + lc];
  }
  if (col0 + lc < two_f) {
    part[((size_t)blockIdx.x * 2 + moment) * two_f + col0 + lc] = t;
  }
}

bool bad_shape(int n, int m, int f, int g) {
  return n <= 0 || m <= 0 || f <= 0 || g <= 0;
}

cudaError_t opt_in_smem(const void* kernel, int smem) {
  if (smem > cgnn::kMaxSmemBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// Launch 1a / 2a: P [N, 4F] = nodes . [W_i | W_j] + [b | 0].
template <typename T>
cudaError_t launch_node_pass(const void* nodes, const void* w,
                             const void* bias, void* p, int n, int f,
                             cudaStream_t st) {
  const dim3 grid((n + kNodeRows - 1) / kNodeRows,
                  (4 * f + kNodeCols - 1) / kNodeCols);
  fused_cgconv_eval_node_kernel<T><<<grid, 256, 0, st>>>(
      (const T*)nodes, (const float*)w, (const float*)bias, (float*)p, n, f);
  return cudaGetLastError();
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

// Kernel 1, the apply pass, on nodes and edges of type T (module note
// at the entry points below).
template <typename T>
int eval_pass(const void* nodes, const void* edges, const void* nbr,
              const void* mask, const void* w, const void* bias,
              const void* mean, const void* var, const void* scale,
              const void* bn_bias, void* p, void* out, int n, int m, int f,
              int g, int node_pass, float eps, void* stream) {
  if (bad_shape(n, m, f, g) || f > kSlotThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (node_pass) {
    err = launch_node_pass<T>(nodes, w, bias, p, n, f, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int ry = slot_pass_rows(m, f, g);
  const int k_rows = (kSlotRowsPerBlock + ry - 1) / ry;
  const dim3 block(f, ry);
  const dim3 grid((n + ry * k_rows - 1) / (ry * k_rows));
  const float* w_e = (const float*)w + (size_t)2 * f * 2 * f;
  if (!slot_pass_in_registers(m, f, g)) {
    const int smem = (int)sizeof(float) * g * 2 * f;
    err = opt_in_smem((const void*)fused_cgconv_eval_slot_smem_kernel<T>,
                      smem);
    if (err != cudaSuccess) return (int)err;
    fused_cgconv_eval_slot_smem_kernel<T><<<grid, block, smem, st>>>(
        (const float*)p, (const T*)edges, (const int*)nbr,
        (const float*)mask, w_e, (const float*)mean, (const float*)var,
        (const float*)scale, (const float*)bn_bias, eps, (float*)out, n, m, f,
        g, k_rows);
    return (int)cudaGetLastError();
  }
  const int smem = 2 * ry * stage_floats(m, kRegG) * (int)sizeof(float);
  if (smem > kStageBudget) {
    err = opt_in_smem((const void*)fused_cgconv_eval_slot_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_cgconv_eval_slot_kernel<T><<<grid, block, smem, st>>>(
      (const float*)p, (const T*)edges, (const int*)nbr,
      (const float*)mask, w_e, (const float*)mean, (const float*)var,
      (const float*)scale, (const float*)bn_bias, eps, (float*)out, n, m, f,
      g, k_rows);
  return (int)cudaGetLastError();
}

// Kernel 2, the stats pass, on nodes and edges of type T.
template <typename T>
int stats_pass(const void* nodes, const void* edges, const void* nbr,
               const void* mask, const void* w, const void* bias,
               const void* shift, void* p, void* part, void* out, int n,
               int m, int f, int g, int blocks, int node_pass,
               void* stream) {
  const long long tiles =
      ((long long)n * m + kStatsTileSlots - 1) / kStatsTileSlots;
  if (bad_shape(n, m, f, g) || blocks <= 0 || blocks > tiles) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (node_pass) {
    err = launch_node_pass<T>(nodes, w, bias, p, n, f, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int smem = (int)sizeof(float) * stats_smem_floats(g);
  if (smem > 48 * 1024) {
    err = opt_in_smem((const void*)fused_cgconv_stats_slot_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(blocks, (2 * f + kStatsTileCols - 1) / kStatsTileCols);
  fused_cgconv_stats_slot_kernel<T><<<grid, kStatsThreads, smem, st>>>(
      (const float*)p, (const T*)edges, (const int*)nbr,
      (const float*)mask, (const float*)w + (size_t)2 * f * 2 * f,
      (const float*)shift, (float*)part, n, m, f, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cgnn::launch_sum_partials((const float*)part, (float*)out,
                                        blocks, 4 * f, st);
}

}  // namespace

// Dynamic shared memory of the stats slot pass for G, in bytes (the same
// for both storage types: bf16 rows are staged widened to f32).
extern "C" int cgconv_fused_stats_smem_bytes(int g) {
  return (int)sizeof(float) * stats_smem_floats(g);
}

// Every entry point launches on `stream` and returns the cudaError_t of its
// launches (0 = queued). All pointers are device pointers to contiguous
// row-major data: nodes and edges f32 (`_f32`) or bf16 (`_bf16`), nbr i32,
// everything else f32.

// Kernel 1's node pass alone: P [N, 4F] into `p`, for a caller that hands
// the same P to the stats pass and the apply pass (`node_pass` = 0 there).
extern "C" int cgconv_fused_node_f32(const void* nodes, const void* w,
                                     const void* bias, void* p, int n, int f,
                                     void* stream) {
  if (n <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_node_pass<float>(nodes, w, bias, p, n, f,
                                      (cudaStream_t)stream);
}

extern "C" int cgconv_fused_node_bf16(const void* nodes, const void* w,
                                      const void* bias, void* p, int n, int f,
                                      void* stream) {
  if (n <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_node_pass<bf16>(nodes, w, bias, p, n, f,
                                     (cudaStream_t)stream);
}

// Kernel 1, the apply pass: with `node_pass` 1, launch 1a writes P [N, 4F]
// into `p` (scratch) first; with 0, `p` already holds the node pass's P.
// Launch 1b reads it; rstd_scale = rsqrt(var + eps) * scale is folded in
// the kernel.
extern "C" int cgconv_fused_eval_f32(
    const void* nodes, const void* edges, const void* nbr, const void* mask,
    const void* w, const void* bias, const void* mean, const void* var,
    const void* scale, const void* bn_bias, void* p, void* out, int n, int m,
    int f, int g, int node_pass, float eps, void* stream) {
  return eval_pass<float>(nodes, edges, nbr, mask, w, bias, mean, var, scale,
                          bn_bias, p, out, n, m, f, g, node_pass, eps,
                          stream);
}

extern "C" int cgconv_fused_eval_bf16(
    const void* nodes, const void* edges, const void* nbr, const void* mask,
    const void* w, const void* bias, const void* mean, const void* var,
    const void* scale, const void* bn_bias, void* p, void* out, int n, int m,
    int f, int g, int node_pass, float eps, void* stream) {
  return eval_pass<bf16>(nodes, edges, nbr, mask, w, bias, mean, var, scale,
                         bn_bias, p, out, n, m, f, g, node_pass, eps, stream);
}

// Kernel 2, the stats pass: with `node_pass` 1, launch 2a writes P into
// `p` first (as kernel 1 does); launch 2b writes one [2, 2F] partial for
// each of `blocks` blocks (`part`: [blocks, 2, 2F] floats of scratch,
// blocks = min(tiles of 64 slots, kStatsBlocks) as the wrapper sizes it);
// `out` [2, 2F] receives sum (z - shift) and sum (z - shift)^2.
extern "C" int cgconv_fused_stats_f32(
    const void* nodes, const void* edges, const void* nbr, const void* mask,
    const void* w, const void* bias, const void* shift, void* p, void* part,
    void* out, int n, int m, int f, int g, int blocks, int node_pass,
    void* stream) {
  return stats_pass<float>(nodes, edges, nbr, mask, w, bias, shift, p, part,
                           out, n, m, f, g, blocks, node_pass, stream);
}

extern "C" int cgconv_fused_stats_bf16(
    const void* nodes, const void* edges, const void* nbr, const void* mask,
    const void* w, const void* bias, const void* shift, void* p, void* part,
    void* out, int n, int m, int f, int g, int blocks, int node_pass,
    void* stream) {
  return stats_pass<bf16>(nodes, edges, nbr, mask, w, bias, shift, p, part,
                          out, n, m, f, g, blocks, node_pass, stream);
}
