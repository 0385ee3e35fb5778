// Segment sum over sorted centers, for Hopper (sm_90a): kernel 6.
//
// Replaces `_kernel` in cgnn_tpu/ops/pallas_scatter.py (reached from
// `segment_sum_pallas`): the flat COO layout's per-node sum of edge
// messages. The packer keeps `centers` non-decreasing, so node n's edges
// are the contiguous rows [offsets[n], offsets[n+1]) of the [E, F]
// messages (the wrapper takes the offsets from a device searchsorted):
//   out[n, f] = sum over e in [offsets[n], offsets[n+1]) of msg[e, f]
// in f32; an empty node gets 0.
//
// What bounds it on an H100: bytes. Every message row is read once and
// every node row written once, ~1 add a loaded float: at the flagship's
// COO training shape (E = 93,920, N = 7,832, F = 64) ~26 MB, ~8 us at
// 3.35 TB/s. What kept it from there was one node: the packer puts every
// padding edge on node N-1 (416 rows at the training shape, 528 at the
// top serving rung, against <= 12 real rows on any other node), and one
// warp walked that range alone in ceil(rows / kRows) dependent rounds
// (that one-warp-a-node design: 0.0165 ms on the device at the training
// shape, 0.0152 ms at the serving rung, 8.5x its bound there).
//
// Design. The TPU kernel turns each 128-node tile's edge span into
// interval one-hot matmuls on the MXU; a GPU reads the rows directly.
// A block of kWarpsPerBlock warps covers as many consecutive nodes, one
// warp a node: lane q owns channels q, q + 32, ... (up to PER_LANE of
// them). A round loads up to kRows rows at once (rows past the range are
// not loaded) and then adds them in edge order, so a short range's loads
// are all in flight together. A warp whose node has at most kLong rows
// (two rounds) sums it so and writes it. A longer node is summed by the
// whole block: its range is cut into kWarpsPerBlock contiguous parts,
// each warp sums its part in edge order, the partials go to shared
// memory, and one warp adds them in part order and writes the row. The
// block's flag (`__syncthreads_or` after the short pass) says whether it
// has any long node; a block without one is done. Long nodes are taken
// one after another. No atomics and no second pass: the order of every
// add is fixed by the offsets alone, so every run gives the same bits,
// whatever the skew (a real hub anywhere, not only padding on N-1).
// 416 rows become 26 a warp, two rounds.
//
// bf16 instance (`segment_sum_sorted_bf16`): the TPU kernel sums bf16
// messages in an f32 accumulator and casts the sums back to bf16
// (pallas_scatter.py:83-88). The kernel is a template on the message type
// T: T = __nv_bfloat16 widens each element on load, adds in f32 in the
// f32 instance's order and rounds each sum to bf16 on its store. Still
// byte-bound; the message and output bytes halve.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, each call's
// messages read from device memory (not L2): 0.0114 ms on the device at
// the training shape (bound 0.0079 ms), 0.0062 ms at the serving rung,
// 0.0117 ms with the 416 rows on node N/2; torch.segment_reduce on the
// same inputs 0.054 ms. PERF.md's kernel table keeps the latest times.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using cgnn::store_as;
using cgnn::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 16;

// acc += rows [begin, end) of msg, in edge order, kRows rows loaded a round
// (each element widened to f32 on load)
template <int PER_LANE, typename T>
__device__ __forceinline__ void sum_rows(const T* __restrict__ msg,
                                         int begin, int end, int f, int lane,
                                         float (&acc)[PER_LANE]) {
  constexpr int kRows = 32 / PER_LANE;
  for (int e = begin; e < end; e += kRows) {
    float v[kRows][PER_LANE];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const T* row = msg + (size_t)(e + u) * f;
#pragma unroll
      for (int p = 0; p < PER_LANE; ++p) {
        const int c = lane + p * kWarp;
        v[u][p] = (e + u < end && c < f) ? to_f32(row[c]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (e + u < end) {
#pragma unroll
        for (int p = 0; p < PER_LANE; ++p) acc[p] += v[u][p];
      }
    }
  }
}

template <int PER_LANE, typename T>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
    segment_sum_sorted_kernel(const T* __restrict__ msg,
                              const int* __restrict__ offsets,
                              T* __restrict__ out, int n, int f) {
  constexpr int kLong = 2 * (32 / PER_LANE);  // rows a warp sums alone
  __shared__ float part_s[kWarpsPerBlock][PER_LANE * kWarp];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int first = blockIdx.x * kWarpsPerBlock;
  const int node = first + warp;
  bool is_long = false;
  if (node < n) {
    const int begin = offsets[node];
    const int end = offsets[node + 1];
    if (end - begin > kLong) {
      is_long = true;
    } else {
      float acc[PER_LANE];
#pragma unroll
      for (int p = 0; p < PER_LANE; ++p) acc[p] = 0.0f;
      sum_rows<PER_LANE>(msg, begin, end, f, lane, acc);
      T* dst = out + (size_t)node * f;
#pragma unroll
      for (int p = 0; p < PER_LANE; ++p) {
        const int c = lane + p * kWarp;
        if (c < f) store_as(dst + c, acc[p]);
      }
    }
  }
  if (!__syncthreads_or(is_long)) return;  // the block's flag

  // the block's long nodes, one after another; every test below reads
  // only offsets, so it is the same for every thread (the barriers inside
  // are reached by the whole block)
  for (int w = 0; w < kWarpsPerBlock && first + w < n; ++w) {
    const int begin = offsets[first + w];
    const int end = offsets[first + w + 1];
    if (end - begin <= kLong) continue;
    const long long len = end - begin;
    const int part_begin = begin + (int)(len * warp / kWarpsPerBlock);
    const int part_end = begin + (int)(len * (warp + 1) / kWarpsPerBlock);
    float acc[PER_LANE];
#pragma unroll
    for (int p = 0; p < PER_LANE; ++p) acc[p] = 0.0f;
    sum_rows<PER_LANE>(msg, part_begin, part_end, f, lane, acc);
#pragma unroll
    for (int p = 0; p < PER_LANE; ++p) part_s[warp][lane + p * kWarp] = acc[p];
    __syncthreads();
    if (warp == w) {
      T* dst = out + (size_t)(first + w) * f;
#pragma unroll
      for (int p = 0; p < PER_LANE; ++p) {
        const int c = lane + p * kWarp;
        float total = 0.0f;
        for (int q = 0; q < kWarpsPerBlock; ++q) total += part_s[q][c];
        if (c < f) store_as(dst + c, total);
      }
    }
    __syncthreads();  // part_s is free for the next long node
  }
}

template <int PER_LANE, typename T>
cudaError_t launch(const T* msg, const int* offsets, T* out, int n, int f,
                   cudaStream_t stream) {
  const dim3 block(kWarp, kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segment_sum_sorted_kernel<PER_LANE, T>
      <<<grid, block, 0, stream>>>(msg, offsets, out, n, f);
  return cudaGetLastError();
}

template <typename T>
int segment_sum(const T* msg, const int* offsets, T* out, int n, int f,
                cudaStream_t stream) {
  if (f <= 32) return launch<1>(msg, offsets, out, n, f, stream);
  if (f <= 64) return launch<2>(msg, offsets, out, n, f, stream);
  if (f <= 128) return launch<4>(msg, offsets, out, n, f, stream);
  return launch<8>(msg, offsets, out, n, f, stream);
}

}  // namespace

// msg [E, F], offsets [N + 1] i32 (non-decreasing, offsets[N] <= E) ->
// out [N, F] in msg's type: f32 (`_f32`) or bf16 (`_bf16`, each sum
// accumulated in f32 in the f32 instance's order, then rounded to nearest
// even). 1 <= F <= 256.
extern "C" int segment_sum_sorted_f32(const float* msg, const int* offsets,
                                      float* out, int n, int f,
                                      cudaStream_t stream) {
  return segment_sum(msg, offsets, out, n, f, stream);
}

extern "C" int segment_sum_sorted_bf16(const bf16* msg, const int* offsets,
                                       bf16* out, int n, int f,
                                       cudaStream_t stream) {
  return segment_sum(msg, offsets, out, n, f, stream);
}
