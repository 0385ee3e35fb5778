// Periodic neighbor search on the raw wire, for Hopper (sm_90a): kernel 8.
//
// Replaces `_search_kernel` in cgnn_tpu/ops/neighbor_search.py. Per
// structure g of a RawBatch, every (atom j, periodic image k) pair is a
// candidate neighbor of center atom i, with candidate index c = j*K + k
// (source atom major, lexicographic image minor). A candidate is valid when
// atoms i and j are both real, (j, k) is not i itself in the home image,
// and its distance d <= radius. Each center keeps its M smallest valid
// candidates in lexicographic (d, c) order:
//   nbr[g, i, t]  = c / K, or i on an empty slot
//   dist[g, i, t] = d, or 0 on an empty slot
//   em[g, i, t]   = 1 on a filled slot, else 0
//   ne[g]        += the structure's filled slots (integer atomics: exact,
//                   independent of order; the wrapper zeroes ne)
//
// Arithmetic: cart = f0*L0 + f1*L1 + f2*L2 per component, the image shifts
// the same way, pos = cart_j + shift_k, diff = pos - cart_i,
// d = sqrt((dx*dx + dy*dy) + dz*dz), each product and sum rounded once
// (no FMA contraction) and sqrt correctly rounded: the order of the plain
// PyTorch version's elementwise ops, so distances, and with them the radius
// and tie decisions, are bit-equal to it.
//
// What bounds it on an H100: per candidate of a real (i, j) pair ~14 f32
// operations (3 adds, 3 subtractions, 3 multiplies, 2 adds, a sqrt, the
// radius and list-threshold compares) against ~12 bytes of output per
// center slot, so operations bound it: at the flagship's top raw rung
// (G=72, S=64, K=125, ~30 real atoms a structure) ~9 M real candidates,
// ~2 us at the 67 TFLOP/s f32 peak.
//
// Design (simple first). The TPU kernel builds the whole [S, S*K] distance
// plane of a structure in VMEM (2 MB at S=64, K=125), which does not fit a
// block's shared memory, so the candidates are streamed instead:
// - one warp per center row (g, i); a block holds 8 rows of one structure
//   and stages that structure's S cartesian positions, its K lattice
//   shifts and its atom mask in shared memory ((4S + 3K) floats);
// - for each real atom j (a warp-uniform branch), lane q walks the images
//   k = q, q + 32, ... Each lane so meets its candidates in increasing c
//   and keeps the MAXM best (d, c) in registers by insertion; a strict
//   d < comparison keeps the earlier c first on equal d, which is the
//   lexicographic order;
// - then M rounds of a warp argmin over the lanes' list heads, with
//   __shfl_xor_sync on the pair (d, c); the one lane holding the winner
//   pops it. Lane t keeps round t's result and writes slot t.
// Padding rows (mask 0) and padding structures (identity lattice, zero
// mask) get no candidates: their slots self-loop with a zero mask.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // warps per block, one center row each
constexpr unsigned kFullMask = 0xffffffffu;

// (x0*l0 + x1*l1) + x2*l2, each product and sum rounded once
__device__ __forceinline__ float dot3_rn(float x0, float x1, float x2,
                                        float l0, float l1, float l2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, l0), __fmul_rn(x1, l1)),
                   __fmul_rn(x2, l2));
}

template <int MAXM>
__global__ void __launch_bounds__(kWarp* kRowsPerBlock)
    neighbor_search_kernel(const float* __restrict__ frac,
                           const float* __restrict__ lats,
                           const unsigned char* __restrict__ amask,
                           const float* __restrict__ offsets,
                           int* __restrict__ nbr, float* __restrict__ dist,
                           float* __restrict__ em, int* __restrict__ n_edges,
                           int s, int k, int m, int home, float radius) {
  extern __shared__ float smem[];
  float* cart = smem;             // [S][3]
  float* shift = cart + 3 * s;    // [K][3]
  float* live = shift + 3 * k;    // [S], 1 = real atom
  const int g = blockIdx.y;
  const int tid = threadIdx.y * kWarp + threadIdx.x;
  const int nthreads = kWarp * blockDim.y;

  const float* lat = lats + (size_t)g * 9;  // row vectors L[r][c]
  float l[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) l[q] = lat[q];
  for (int j = tid; j < s; j += nthreads) {
    const float* f = frac + ((size_t)g * s + j) * 3;
    const float f0 = f[0], f1 = f[1], f2 = f[2];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cart[3 * j + c] = dot3_rn(f0, f1, f2, l[c], l[3 + c], l[6 + c]);
    live[j] = amask[(size_t)g * s + j] ? 1.0f : 0.0f;
  }
  for (int q = tid; q < k; q += nthreads) {
    const float* o = offsets + (size_t)q * 3;
    const float o0 = o[0], o1 = o[1], o2 = o[2];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      shift[3 * q + c] = dot3_rn(o0, o1, o2, l[c], l[3 + c], l[6 + c]);
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= s) return;  // no barrier below
  const int lane = threadIdx.x;

  // this lane's best candidates, ascending in (d, c); empty = (inf, INT_MAX)
  float ld[MAXM];
  int lc[MAXM];
#pragma unroll
  for (int t = 0; t < MAXM; ++t) {
    ld[t] = INFINITY;
    lc[t] = INT_MAX;
  }
  if (live[i] != 0.0f) {
    const float xi = cart[3 * i], yi = cart[3 * i + 1], zi = cart[3 * i + 2];
    for (int j = 0; j < s; ++j) {
      if (live[j] == 0.0f) continue;  // the same j in every lane
      const float xj = cart[3 * j], yj = cart[3 * j + 1],
                  zj = cart[3 * j + 2];
      for (int q = lane; q < k; q += kWarp) {
        if (j == i && q == home) continue;
        const float dx = __fsub_rn(__fadd_rn(xj, shift[3 * q]), xi);
        const float dy = __fsub_rn(__fadd_rn(yj, shift[3 * q + 1]), yi);
        const float dz = __fsub_rn(__fadd_rn(zj, shift[3 * q + 2]), zi);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        const float d = __fsqrt_rn(d2);
        if (!(d <= radius) || !(d < ld[MAXM - 1])) continue;
        // insert (d, c): it follows every entry with d' <= d, since this
        // lane meets c in increasing order
        const int c = j * k + q;
#pragma unroll
        for (int t = MAXM - 1; t > 0; --t) {
          const bool up = d < ld[t - 1];  // entry t-1 moves down to t
          const bool here = !up && d < ld[t];
          ld[t] = up ? ld[t - 1] : (here ? d : ld[t]);
          lc[t] = up ? lc[t - 1] : (here ? c : lc[t]);
        }
        if (d < ld[0]) {
          ld[0] = d;
          lc[0] = c;
        }
      }
    }
  }

  // M rounds of a lexicographic warp argmin over the list heads
  int out_nbr = i;
  float out_d = 0.0f, out_em = 0.0f;
  int hits = 0;
  for (int t = 0; t < m; ++t) {
    float bd = ld[0];
    int bc = lc[0];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFullMask, bd, off);
      const int oc = __shfl_xor_sync(kFullMask, bc, off);
      if (od < bd || (od == bd && oc < bc)) {
        bd = od;
        bc = oc;
      }
    }
    if (bc == INT_MAX) break;  // every list is empty (the same in all lanes)
    if (lc[0] == bc) {  // the one lane holding the winner pops it
#pragma unroll
      for (int u = 0; u < MAXM - 1; ++u) {
        ld[u] = ld[u + 1];
        lc[u] = lc[u + 1];
      }
      ld[MAXM - 1] = INFINITY;
      lc[MAXM - 1] = INT_MAX;
    }
    if (lane == t) {
      out_nbr = bc / k;
      out_d = bd;
      out_em = 1.0f;
    }
    ++hits;
  }
  if (lane < m) {
    const size_t slot = ((size_t)g * s + i) * m + lane;
    nbr[slot] = out_nbr;
    dist[slot] = out_d;
    em[slot] = out_em;
  }
  if (lane == 0 && hits > 0) atomicAdd(n_edges + g, hits);
}

template <int MAXM>
cudaError_t launch(const float* frac, const float* lats,
                   const unsigned char* amask, const float* offsets, int* nbr,
                   float* dist, float* em, int* ne, int g, int s, int k,
                   int m, int home, float radius, cudaStream_t stream) {
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid((s + kRowsPerBlock - 1) / kRowsPerBlock, g);
  const size_t smem = (size_t)(4 * s + 3 * k) * sizeof(float);
  neighbor_search_kernel<MAXM><<<grid, block, smem, stream>>>(
      frac, lats, amask, offsets, nbr, dist, em, ne, s, k, m, home, radius);
  return cudaGetLastError();
}

}  // namespace

// frac [G, S, 3] f32, lats [G, 3, 3] f32, amask [G, S] u8, offsets [K, 3]
// f32 -> nbr [G, S, M] i32, dist and em [G, S, M] f32, ne [G] i32 (zeroed
// by the caller). 1 <= M <= 32; (4S + 3K) floats of shared memory.
extern "C" int neighbor_search_f32(const float* frac, const float* lats,
                                   const unsigned char* amask,
                                   const float* offsets, int* nbr,
                                   float* dist, float* em, int* ne, int g,
                                   int s, int k, int m, int home,
                                   float radius, cudaStream_t stream) {
  if (m <= 16)
    return launch<16>(frac, lats, amask, offsets, nbr, dist, em, ne, g, s, k,
                      m, home, radius, stream);
  return launch<32>(frac, lats, amask, offsets, nbr, dist, em, ne, g, s, k,
                    m, home, radius, stream);
}
