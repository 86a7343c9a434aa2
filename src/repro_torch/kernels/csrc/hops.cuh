// The hop pass shared by pointer_jump and hook_compress: out[i] = k hops
// from snap[i] through snap, for every slot. Out of place, so every hop
// reads the same snapshot (an in-place hop changes what k = 3 returns).
//
// Bound: bytes, 8 a slot (snap read once, out written once); the k
// dependent gathers go to the same array, which must stay in L2 (16.8 MB
// at n = 2^22), so snap is read with normal caching loads, never
// evict-first. A lane takes 4 slots with one 16-byte load and issues each
// hop's 4 gathers before it uses any, so that 4 independent L2 reads are
// in flight a lane; then one 16-byte store. A gather is skipped where
// the label is negative (the -1 fixed point) or is the slot itself: a
// self-labeled slot is a fixed point of every hop, and after a hop the
// same test on (label, its parent) stops a chain that has reached a root.
#pragma once

#include "common.cuh"

namespace connectit {

struct HopStep {
  const int* __restrict__ snap;
  int* __restrict__ out;
  int64_t L;
  int k;

  template <int W>
  __device__ __forceinline__ void run(int64_t j, bool in) {
    if (!in) return;
    int cur[W];
    load_cached<W>(snap, j, cur);
    // from[q]: the slot whose label cur[q] is; cur[q] == from[q] is a root
    int from[W];
#pragma unroll
    for (int q = 0; q < W; ++q) from[q] = static_cast<int>(j + q);
    for (int h = 0; h < k; ++h) {
      int next[W];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        next[q] = cur[q] >= 0 && cur[q] != from[q]
                      ? __ldg(snap + clamp_index(cur[q], L)) : cur[q];
      }
#pragma unroll
      for (int q = 0; q < W; ++q) {
        from[q] = cur[q];
        cur[q] = next[q];
      }
    }
    store_vec<W>(out, j, cur);
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
    hops_kernel(const int* __restrict__ snap, int* __restrict__ out,
                int64_t L, int k, int64_t head) {
  HopStep step{snap, out, L, k};
  stream_steps<V>(L, head, step);
}

// Launch the hop pass on `st`: 16-byte loads and stores where snap and out
// lie equally far past a 16-byte boundary (a fresh out and a label view
// 4 bytes past one do not), scalars otherwise.
inline cudaError_t launch_hops(const int* snap, int* out, int64_t L, int k,
                               cudaStream_t st) {
  if (L > 0 && k > 0) {
    const StreamLayout lay = stream_layout({snap, out}, L);
    const unsigned grid = grid_for(lay.items);
    if (lay.vec) {
      hops_kernel<4><<<grid, kThreads, 0, st>>>(snap, out, L, k, lay.head);
    } else {
      hops_kernel<1><<<grid, kThreads, 0, st>>>(snap, out, L, k, 0);
    }
  }
  return cudaGetLastError();
}

}  // namespace connectit
