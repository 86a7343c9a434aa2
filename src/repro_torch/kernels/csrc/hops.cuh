// The hop pass shared by pointer_jump and hook_compress.
#pragma once

#include "common.cuh"

namespace connectit {

// out[i] = k hops from snap[i] through snap, for every slot: out of place,
// so every hop reads the same snapshot.
__global__ void hops_kernel(const int* __restrict__ snap,
                            int* __restrict__ out, int64_t L, int k) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < L; i += stride) {
    out[i] = hop_chain(snap, snap[i], k, L);
  }
}

}  // namespace connectit
