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
//                   independent of order; the entry zeroes ne first)
//
// Arithmetic: cart = f0*L0 + f1*L1 + f2*L2 per component, the image shifts
// the same way, pos = cart_j + shift_k, diff = pos - cart_i,
// d2 = (dx*dx + dy*dy) + dz*dz, each product and sum rounded once (no FMA
// contraction), d = sqrt_rn(d2): the plain PyTorch version's elementwise
// ops in its order, so distances, and with them the radius and tie
// decisions, are bit-equal to it.
//
// What bounds it on an H100: operations. Per candidate of a real (i, j)
// pair 3 subtractions, 3 squares, 2 adds and the radius compare, none of
// them fusable, each an FMA slot; per real (j, k) the 3 adds of the image
// position; one correctly rounded root per filled slot on the SFU. At the
// flagship's top raw rung (G=72, S=64, K=125, ~25 real atoms a structure)
// 5.9 M candidates: 1.6 us at the 67 TFLOP/s f32 rate. On the card the
// candidate loop keeps every SM's issue busy: its queue bookkeeping (a
// ballot, a popc and a store a candidate) costs about what its distances
// do (PERF.md section 5).
//
// Design. One block of kSplit = 4 warps per center row (g, i); a padding
// row's block writes its self-loops and leaves. The block stages its
// structure's cartesian positions and K lattice shifts, and (warp 0) the
// slots of its real atoms, in shared memory behind one barrier. Warp w
// takes the real atoms w, w + 4, ...: a center's candidates are split four
// ways, so a center of a 63-atom structure is not a chain of 63 steps.
// - Candidates: lane q owns the images k = q + 32u (u < 4) of a chunk of
//   128, their shifts in registers; for each of its warp's real atoms j
//   (the same in all lanes) it forms its 4 candidates' d2 as independent
//   chains.
// - An exact radius cut on d2: sqrt_rn is monotone, so d <= r exactly
//   when d2 <= T, T the largest f32 whose correctly rounded root is <= r
//   (computed on the host, ops/neighbor_search.py radius_threshold). No
//   root is taken before the cut.
// - One 64-bit key a candidate: d >= 0 is finite, so its f32 bits order
//   like its value and key = bits(d) << 32 | c orders exactly as (d, c).
//   Keys are unique, so every compare is one unsigned compare, with no
//   tie-break and no dependence on the order keys arrive in.
// - Accepted candidates are compacted into a per-warp queue in shared
//   memory (__ballot_sync, a popc of the lanes below), as (d2 bits, c).
//   When it holds 32, every lane takes one, takes its root and inserts the
//   key into its own ascending list of M keys, kept in shared memory (a
//   branch-free pass carrying the greater key down): the insertion runs on
//   full warps only, one pass per 32 accepted candidates, never under
//   divergence, and the lists cost no registers (ptxas: 48 a thread, so
//   10 blocks of 4 warps an SM, 1320 of the top rung's 1507 real rows).
// - Each lane's list holds the M best keys it was given, so the global M
//   best are among the 128 lists' union: warp 0, each lane reading 4
//   lists, takes M rounds of an argmin over the list heads (the lane's
//   least head, then __reduce_min_sync on the high word and on the low
//   word among the lanes holding that high word); the one lane holding the
//   winner moves that list on. Lane t keeps round t's result and writes
//   slot t.
// Padding rows (mask 0) and padding structures (identity lattice, zero
// mask) get no candidates: their slots self-loop with a zero mask.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSplit = 4;            // warps a center, one block a center
constexpr int kPerLane = 4;          // images a lane takes of each chunk
constexpr int kChunk = kWarp * kPerLane;
constexpr int kQueue = 2 * kWarp;    // < 32 left over + one ballot's 32
constexpr int kLists = kSplit * kWarp;  // lane lists a center
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;  // above every real key

// (x0*l0 + x1*l1) + x2*l2, each product and sum rounded once
__device__ __forceinline__ float dot3_rn(float x0, float x1, float x2,
                                        float l0, float l1, float l2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, l0), __fmul_rn(x1, l1)),
                   __fmul_rn(x2, l2));
}

// a queued (d2 bits, c) -> its key (bits of sqrt_rn(d2), c)
__device__ __forceinline__ unsigned long long key_of(unsigned long long e) {
  const float d = __fsqrt_rn(__uint_as_float((unsigned)(e >> 32)));
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)e;
}

// key into a lane's ascending list of m keys in shared memory (entry t at
// list[t * kLists]): each entry keeps the lesser of itself and the key
// carried down, and carries the greater on; keys are unique
__device__ __forceinline__ void insert(unsigned long long* list, int m,
                                       unsigned long long key) {
  for (int t = 0; t < m; ++t) {
    const unsigned long long cur = list[t * kLists];
    list[t * kLists] = key < cur ? key : cur;
    key = key < cur ? cur : key;
  }
}

// Shared memory of one block: the warps' key queues and the lane lists
// ([M][kLists]: a warp's reads and writes of one entry are consecutive),
// then the cartesian positions by slot, the shifts and the real atoms'
// slots.
__host__ __device__ constexpr size_t keys_bytes(int m) {
  return (size_t)(kSplit * kQueue + m * kLists) * 8;
}

__global__ void __launch_bounds__(kWarp* kSplit)
    neighbor_search_kernel(const float* __restrict__ frac,
                           const float* __restrict__ lats,
                           const unsigned char* __restrict__ amask,
                           const float* __restrict__ offsets,
                           int* __restrict__ nbr, float* __restrict__ dist,
                           float* __restrict__ em, int* __restrict__ n_edges,
                           int s, int k, int m, int home, float t2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_real;
  auto* queues = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* lists = queues + kSplit * kQueue;
  float* cart = reinterpret_cast<float*>(smem + keys_bytes(m));  // [S][3]
  float* shift = cart + 3 * s;                                  // [K][3]
  int* real = reinterpret_cast<int*>(shift + 3 * k);            // [S]
  const int i = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const size_t row = ((size_t)g * s + i) * m;
  if (amask[(size_t)g * s + i] == 0) {  // a padding row: self-loops
    if (warp == 0 && lane < m) {
      nbr[row + lane] = i;
      dist[row + lane] = 0.0f;
      em[row + lane] = 0.0f;
    }
    return;  // the whole block
  }

  // staging, one barrier: positions by slot and shifts by all threads,
  // the real atoms' slots by warp 0
  const int tid = warp * kWarp + lane;
  const float* lat = lats + (size_t)g * 9;  // row vectors L[r][c]
  float l[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) l[q] = lat[q];
  for (int j = tid; j < s; j += kWarp * kSplit) {
    const float* f = frac + ((size_t)g * s + j) * 3;
    const float f0 = f[0], f1 = f[1], f2 = f[2];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cart[3 * j + c] = dot3_rn(f0, f1, f2, l[c], l[3 + c], l[6 + c]);
  }
  for (int q = tid; q < k; q += kWarp * kSplit) {
    const float* o = offsets + (size_t)q * 3;
    const float o0 = o[0], o1 = o[1], o2 = o[2];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      shift[3 * q + c] = dot3_rn(o0, o1, o2, l[c], l[3 + c], l[6 + c]);
  }
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < s; base += kWarp) {
      const int j = base + lane;
      const bool lv = j < s && amask[(size_t)g * s + j] != 0;
      const unsigned b = __ballot_sync(kFullMask, lv);
      if (lv) real[count + __popc(b & ((1u << lane) - 1u))] = j;
      count += __popc(b);
    }
    if (lane == 0) n_real = count;
  }
  unsigned long long* list = lists + warp * kWarp + lane;  // this lane's
  for (int t = 0; t < m; ++t) list[t * kLists] = kEmpty;
  __syncthreads();

  const int nr = n_real;
  const float xi = cart[3 * i], yi = cart[3 * i + 1], zi = cart[3 * i + 2];
  const unsigned below = (1u << lane) - 1u;
  unsigned long long* queue = queues + warp * kQueue;
  int qn = 0;  // keys in the queue, the same in every lane

  for (int kb = 0; kb < k; kb += kChunk) {
    float sx[kPerLane], sy[kPerLane], sz[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int kk = kb + u * kWarp + lane;
      sx[u] = kk < k ? shift[3 * kk] : 0.0f;
      sy[u] = kk < k ? shift[3 * kk + 1] : 0.0f;
      sz[u] = kk < k ? shift[3 * kk + 2] : 0.0f;
    }
    // warp w takes the real atoms r = w, w + kSplit, ...
    for (int r = warp; r < nr; r += kSplit) {
      const int j = real[r];  // the same in every lane
      const float xj = cart[3 * j], yj = cart[3 * j + 1], zj = cart[3 * j + 2];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int kk = kb + u * kWarp + lane;
        const float dx = __fsub_rn(__fadd_rn(xj, sx[u]), xi);
        const float dy = __fsub_rn(__fadd_rn(yj, sy[u]), yi);
        const float dz = __fsub_rn(__fadd_rn(zj, sz[u]), zi);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        const bool ok = kk < k && d2 <= t2 && !(j == i && kk == home);
        const unsigned b = __ballot_sync(kFullMask, ok);
        if (ok)
          queue[qn + __popc(b & below)] =
              ((unsigned long long)__float_as_uint(d2) << 32) |
              (unsigned)(j * k + kk);
        qn += __popc(b);
        if (qn >= kWarp) {  // a full warp: each lane inserts one key
          __syncwarp();
          qn -= kWarp;
          const unsigned long long key = key_of(queue[qn + lane]);
          __syncwarp();
          insert(list, m, key);
        }
      }
    }
  }
  __syncwarp();
  if (lane < qn) insert(list, m, key_of(queue[lane]));

  // warp 0 takes M rounds of an argmin over the kLists list heads, lane q
  // reading lists q, q + 32, ... (one per warp), each from its position
  __syncthreads();
  if (warp != 0) return;
  unsigned long long head[kSplit];
  int pos[kSplit];
#pragma unroll
  for (int w = 0; w < kSplit; ++w) {
    head[w] = lists[w * kWarp + lane];
    pos[w] = 0;
  }
  int out_nbr = i;
  float out_d = 0.0f, out_em = 0.0f;
  int hits = 0;
  for (int t = 0; t < m; ++t) {
    unsigned long long mine = head[0];
    int from = 0;
#pragma unroll
    for (int w = 1; w < kSplit; ++w) {
      if (head[w] < mine) {
        mine = head[w];
        from = w;
      }
    }
    const unsigned hi = (unsigned)(mine >> 32), lo = (unsigned)mine;
    const unsigned best_hi = __reduce_min_sync(kFullMask, hi);
    if (best_hi == kFullMask) break;  // every list is empty (in all lanes)
    const unsigned best_lo =
        __reduce_min_sync(kFullMask, hi == best_hi ? lo : kFullMask);
    if (hi == best_hi && lo == best_lo) {  // the one lane holding it
#pragma unroll
      for (int w = 0; w < kSplit; ++w) {
        if (w == from) {
          ++pos[w];
          head[w] = pos[w] < m ? lists[pos[w] * kLists + w * kWarp + lane]
                               : kEmpty;
        }
      }
    }
    if (lane == t) {
      out_nbr = (int)(best_lo / (unsigned)k);
      out_d = __uint_as_float(best_hi);
      out_em = 1.0f;
    }
    ++hits;
  }
  if (lane < m) {
    nbr[row + lane] = out_nbr;
    dist[row + lane] = out_d;
    em[row + lane] = out_em;
  }
  if (lane == 0 && hits > 0) atomicAdd(n_edges + g, hits);
}

}  // namespace

// frac [G, S, 3] f32, lats [G, 3, 3] f32, amask [G, S] u8, offsets [K, 3]
// f32 -> nbr [G, S, M] i32, dist and em [G, S, M] f32, ne [G] i32 (zeroed
// here, on the stream, before the launch). 1 <= M <= 32, S*K < 2^31; t2
// the squared-radius threshold T. One block of 128 threads a center row;
// shared memory: 2048 bytes of queues, 1024*M of lists, (4S + 3K) words.
extern "C" int neighbor_search_f32(const float* frac, const float* lats,
                                   const unsigned char* amask,
                                   const float* offsets, int* nbr,
                                   float* dist, float* em, int* ne, int g,
                                   int s, int k, int m, int home, float t2,
                                   cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(ne, 0, (size_t)g * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const dim3 block(kWarp, kSplit);
  const dim3 grid(s, g);
  const size_t smem = keys_bytes(m) +
                      (size_t)(3 * s + 3 * k) * sizeof(float) +
                      (size_t)s * sizeof(int);
  neighbor_search_kernel<<<grid, block, smem, stream>>>(
      frac, lats, amask, offsets, nbr, dist, em, ne, s, k, m, home, t2);
  return cudaGetLastError();
}
