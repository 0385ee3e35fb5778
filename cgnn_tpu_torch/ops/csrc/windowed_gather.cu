// Windowed neighbor gather, for Hopper (sm_90a): kernel 7.
//
// Replaces `_kernel` in cgnn_tpu/ops/pallas_gather.py (reached from
// `windowed_gather`): the dense layout's v_j = nodes[neighbors] under the
// window contract. Node block b (rows [128 b, 128 b + 128)) may only read
// the node rows of its window [ws[b], ws[b] + window); an index outside
// it gives a zero row. With E = N * M edge slots:
//   out[n, j, f] = nodes[idx, f]  if ws[n / 128] <= idx < ws[n / 128] + W
//                  0              otherwise,       idx = nbr[n * M + j]
// The window starts are clamped and aligned exactly as the JAX wrapper
// does. The result is a copy, bit-exact.
//
// What bounds it on an H100: bytes. The [N, M, F] output is written once
// and the nodes, indices and window starts read once: at the flagship's
// dense training shape (N = 7,936, M = 12, F = 64, f32) ~26.8 MB, ~8 us
// at 3.35 TB/s. There is no arithmetic.
//
// Design (simple first). The TPU kernel walks each block's window tile by
// tile and gathers with one-hot matmuls on the MXU, because a TPU has no
// cheap row gather; that also spreads a non-finite value of any window
// row over its block (0 * inf). A GPU reads rows directly. A block holds
// kSlots slots of 16 threads; a slot's threads copy its row as float4s
// (or floats when F is not a multiple of 4), neighboring threads on
// neighboring words, so reads and writes are coalesced. The window test
// selects, never multiplies. The kernel clamps and aligns the window
// start itself, so a call is one launch and no host arithmetic:
// ws = min(win_starts[b], max(N - W, 0)), floored to a multiple of 128.
//
// Measured on an H100 (PERF.md): one thread an output float with 64-bit
// index division, and the start arithmetic as three more launches, read
// 0.071 ms a call at the training shape.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockRows = 128;  // node rows a window start covers
constexpr int kLanes = 16;       // threads a slot
constexpr int kSlots = 16;       // slots a block

template <typename T>
__global__ void __launch_bounds__(kLanes* kSlots)
    windowed_gather_kernel(const T* __restrict__ nodes,
                           const int* __restrict__ nbr,
                           const int* __restrict__ win_starts,
                           T* __restrict__ out, int n, int m, int words,
                           int window) {
  const int slot = blockIdx.x * kSlots + threadIdx.y;
  if (slot >= n * m) return;
  const int idx = nbr[slot];
  const int hi = max(n - window, 0);
  const int start = min(win_starts[slot / m / kBlockRows], hi);
  const int ws = (start >= 0 ? start / kBlockRows
                             : -((-start + kBlockRows - 1) / kBlockRows)) *
                 kBlockRows;
  // idx >= 0 as well: a negative index reads no row, even where a
  // negative window start would take it in
  const bool inside = idx >= 0 && idx >= ws && idx - ws < window;
  T* dst = out + (size_t)slot * words;
  const T* src = nodes + (size_t)(inside ? idx : 0) * words;
  for (int w = threadIdx.x; w < words; w += kLanes) {
    T zero = {};
    dst[w] = inside ? src[w] : zero;
  }
}

template <typename T>
cudaError_t launch(const T* nodes, const int* nbr, const int* ws, T* out,
                   int n, int m, int words, int window,
                   cudaStream_t stream) {
  const dim3 block(kLanes, kSlots);
  const dim3 grid((n * m + kSlots - 1) / kSlots);
  windowed_gather_kernel<T><<<grid, block, 0, stream>>>(
      nodes, nbr, ws, out, n, m, words, window);
  return cudaGetLastError();
}

}  // namespace

// nodes [N, F] f32, nbr [N * M] i32, win_starts [N / 128] i32 (as the
// caller gives them) -> out [N, M, F] f32. float4 copies when F % 4 == 0
// (torch's allocations are 16-byte aligned).
extern "C" int windowed_gather_f32(const float* nodes, const int* nbr,
                                   const int* ws, float* out, int n, int m,
                                   int f, int window, cudaStream_t stream) {
  if (f % 4 == 0)
    return launch<float4>(reinterpret_cast<const float4*>(nodes), nbr, ws,
                          reinterpret_cast<float4*>(out), n, m, f / 4,
                          window, stream);
  return launch<float>(nodes, nbr, ws, out, n, m, f, window, stream);
}
