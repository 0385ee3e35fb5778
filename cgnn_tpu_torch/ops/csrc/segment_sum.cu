// Segment sum over sorted centers, for Hopper (sm_90a): kernel 6.
//
// Replaces `_kernel` in cgnn_tpu/ops/pallas_scatter.py (reached from
// `segment_sum_pallas`): the flat COO layout's per-node sum of edge
// messages. The packer keeps `centers` non-decreasing, so node n's edges
// are the contiguous rows [offsets[n], offsets[n+1]) of the [E, F]
// messages (the wrapper takes the offsets from a device searchsorted):
//   out[n, f] = sum over e in [offsets[n], offsets[n+1]) of msg[e, f]
// in f32, in edge order; an empty node gets 0.
//
// What bounds it on an H100: bytes. Every message row is read once and
// every node row written once, ~1 add a loaded float: at the flagship's
// COO training shape (E = 93,920, N = 7,832, F = 64) ~26 MB, ~8 us at
// 3.35 TB/s.
//
// Design (simple first). The TPU kernel turns each 128-node tile's edge
// span into interval one-hot matmuls on the MXU; a GPU reads the rows
// directly. One warp per node: lane q owns channels q, q + 32, ... (up to
// PER_LANE of them) and walks the node's rows in order, adding each into
// its f32 accumulators. A round loads up to kRows rows at once (rows past
// the range are not loaded) and then adds them in order, so the loads of
// a whole short range are in flight together while the adds keep edge
// order. No atomics and no shared memory: the same bits on every run.
// Neighboring lanes read neighboring floats of a row (coalesced). The
// padding edges all point at node N-1, so its warp walks a range many
// times longer than the others (hundreds of rows at the training shape
// against <= 12): ceil(rows / kRows) dependent rounds, a serial tail the
// kernel accepts.
//
// Measured on an H100 (PERF.md): loading 4 rows a round, the tail set the
// time (0.028 ms at 416 rows, 0.032 ms at 528); kRows keeps ~32 loaded
// floats a lane in registers whatever F is.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

template <int PER_LANE>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
    segment_sum_sorted_kernel(const float* __restrict__ msg,
                              const int* __restrict__ offsets,
                              float* __restrict__ out, int n, int f) {
  constexpr int kRows = 32 / PER_LANE;  // rows loaded a round
  const int node = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (node >= n) return;
  const int lane = threadIdx.x;
  const int begin = offsets[node];
  const int end = offsets[node + 1];
  float acc[PER_LANE];
#pragma unroll
  for (int p = 0; p < PER_LANE; ++p) acc[p] = 0.0f;
  for (int e = begin; e < end; e += kRows) {
    float v[kRows][PER_LANE];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const float* row = msg + (size_t)(e + u) * f;
#pragma unroll
      for (int p = 0; p < PER_LANE; ++p) {
        const int c = lane + p * kWarp;
        v[u][p] = (e + u < end && c < f) ? row[c] : 0.0f;
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
  float* dst = out + (size_t)node * f;
#pragma unroll
  for (int p = 0; p < PER_LANE; ++p) {
    const int c = lane + p * kWarp;
    if (c < f) dst[c] = acc[p];
  }
}

template <int PER_LANE>
cudaError_t launch(const float* msg, const int* offsets, float* out, int n,
                   int f, cudaStream_t stream) {
  const dim3 block(kWarp, kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segment_sum_sorted_kernel<PER_LANE>
      <<<grid, block, 0, stream>>>(msg, offsets, out, n, f);
  return cudaGetLastError();
}

}  // namespace

// msg [E, F] f32, offsets [N + 1] i32 (non-decreasing, offsets[N] <= E)
// -> out [N, F] f32. 1 <= F <= 256.
extern "C" int segment_sum_sorted_f32(const float* msg, const int* offsets,
                                      float* out, int n, int f,
                                      cudaStream_t stream) {
  if (f <= 32) return launch<1>(msg, offsets, out, n, f, stream);
  if (f <= 64) return launch<2>(msg, offsets, out, n, f, stream);
  if (f <= 128) return launch<4>(msg, offsets, out, n, f, stream);
  return launch<8>(msg, offsets, out, n, f, stream);
}
