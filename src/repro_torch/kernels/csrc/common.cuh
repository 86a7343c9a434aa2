// Shared helpers of the connectivity kernels (int32 labels, sm_90a).
//
// Conventions, the same as the dispatch layer's (repro_torch/kernels/ops.py):
//   * a label array is (L,) int32 whose last slot is the dump row;
//   * -1 (any negative label) is the virtual minimum: a fixed point of every
//     hop, never a scatter target;
//   * every index these kernels gather through is clamped into [0, L), as the
//     reference's gathers clamp, so an out-of-contract input cannot read
//     outside the array.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace connectit {

constexpr int kThreads = 256;
// Grid-stride loops cover what one grid does not; past this many blocks a
// launch gains nothing on 132 SMs.
constexpr int64_t kMaxBlocks = 1 << 16;

inline unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

__device__ __forceinline__ int64_t clamp_index(int x, int64_t L) {
  int64_t i = x < 0 ? 0 : static_cast<int64_t>(x);
  return i < L ? i : L - 1;
}

// k chained hops x <- snap[x] through one snapshot; a negative label stops
// the chain.
__device__ __forceinline__ int hop_chain(const int* __restrict__ snap, int x,
                                         int k, int64_t L) {
  for (int h = 0; h < k && x >= 0; ++h) x = snap[clamp_index(x, L)];
  return x;
}

}  // namespace connectit
