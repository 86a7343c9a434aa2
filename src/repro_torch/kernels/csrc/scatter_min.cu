// scatter_min: out = labels; out[idx[j]] = min(out[idx[j]], vals[j]).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scatter_min/kernel.py
// (scatter_min / _scatter_min_kernel): the paper's writeMin. On the TPU the
// accumulator is one VMEM-resident block that sequential grid steps update
// in turn; Hopper runs blocks concurrently, so the output is a copy of the
// input labels and proposals land with atomicMin.
//
// Bound: bytes (labels read and written once, every value read, an index
// only where its value is not the dump sentinel). The main path's call,
// min_vertex_labels, sends every vertex's id to its component's slot: on
// RMAT one component holds ~98% of the vertices, and one atomic per
// proposal serialised on that slot at 150x the bound. The proposals now go
// through warp_min.cuh: folded, combined along runs of a warp's lanes, and
// issued only where the slot's current value is higher. The ids arrive in
// ascending order, so the hub slot holds its minimum after the first few
// warps and the rest drop. Liu-Tarjan's masked writes over the whole edge
// list are almost all dumped: a lane reads its indices only where one of
// its values is live.
#include "warp_min.cuh"

namespace {

struct ScatterStep {
  const int* __restrict__ idx;
  const int* __restrict__ vals;
  int* out;
  int64_t L;

  template <int W>
  __device__ __forceinline__ void run(int64_t j, bool in) {
    int v[W] = {};
    if (in) connectit::load_stream<W>(vals, j, v);
    // a dumped entry (INT_MAX) is a no-op under min
    bool live = false;
#pragma unroll
    for (int q = 0; q < W; ++q) live = live || (in && v[q] != INT_MAX);
    int i[W] = {};
    if (live) connectit::load_stream<W>(idx, j, i);
    int slot[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      // an index outside [0, L) is dropped, as JAX drops it
      const bool ok = in && v[q] != INT_MAX && i[q] >= 0 &&
                      static_cast<int64_t>(i[q]) < L;
      slot[q] = ok ? i[q] : -1;
    }
    connectit::commit_min<W>(out, slot, v);
  }
};

template <int V>
__global__ void __launch_bounds__(connectit::kThreads)
    scatter_min_kernel(const int* __restrict__ idx,
                       const int* __restrict__ vals, int* out, int64_t L,
                       int64_t m, int64_t head) {
  ScatterStep step{idx, vals, out, L};
  connectit::stream_steps<V>(m, head, step);
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
    const connectit::StreamLayout lay =
        connectit::stream_layout({idx, vals}, m);
    const int* i = static_cast<const int*>(idx);
    const int* v = static_cast<const int*>(vals);
    int* o = static_cast<int*>(out);
    const unsigned grid = connectit::grid_for(lay.items);
    if (lay.vec) {
      scatter_min_kernel<4><<<grid, connectit::kThreads, 0, st>>>(
          i, v, o, L, m, lay.head);
    } else {
      scatter_min_kernel<1><<<grid, connectit::kThreads, 0, st>>>(
          i, v, o, L, m, 0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
