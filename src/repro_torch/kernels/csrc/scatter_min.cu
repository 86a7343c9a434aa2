// scatter_min: out = labels; out[idx[j]] = min(out[idx[j]], vals[j]).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scatter_min/kernel.py
// (scatter_min / _scatter_min_kernel): the paper's writeMin. On the TPU the
// accumulator is one VMEM-resident block that sequential grid steps update
// in turn; Hopper runs blocks concurrently, so the output is a copy of the
// input labels and each proposal lands with a native atomicMin.
//
// Bound: bytes (labels read and written once, idx and vals read once).
// Proposals that hit one hub slot serialise on its atomic; that contention
// is data-dependent and left as it is.
#include <climits>

#include "common.cuh"

namespace {

__global__ void scatter_min_kernel(const int* __restrict__ idx,
                                   const int* __restrict__ vals,
                                   int* __restrict__ out, int64_t L,
                                   int64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < m; j += stride) {
    const int v = vals[j];
    if (v == INT_MAX) continue;  // dumped entry: a no-op under min
    const int i = idx[j];
    if (i < 0 || static_cast<int64_t>(i) >= L) continue;  // dropped, as JAX does
    atomicMin(out + i, v);
  }
}

}  // namespace

extern "C" int scatter_min_i32(const void* labels, const void* idx,
                               const void* vals, void* out, int64_t L,
                               int64_t m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(out, labels, L * sizeof(int),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0) {
    scatter_min_kernel<<<connectit::grid_for(m), connectit::kThreads, 0, st>>>(
        static_cast<const int*>(idx), static_cast<const int*>(vals),
        static_cast<int*>(out), L, m);
  }
  return static_cast<int>(cudaGetLastError());
}
