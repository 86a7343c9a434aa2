// edge_relabel and edge_rewrite: the undirected relabel round and the
// Liu-Tarjan alter step, on int32 labels and int32 edge endpoints.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/edge_relabel/
// kernel.py:
//   * edge_relabel (_edge_relabel_kernel): out = labels; out[r] min= labels[s];
//     out[s] min= labels[r]. On the TPU the output block accumulates across
//     ordered grid steps while every gather reads the input block. Hopper
//     runs blocks in no order, so the output is a copy of the input labels,
//     every gather reads `labels` (never `out`: reading `out` would let a
//     block see other blocks' proposals and turn the Jacobi round into a
//     Gauss-Seidel one), and each proposal lands with a native atomicMin.
//   * edge_rewrite (_edge_rewrite_kernel): s' = labels[s], r' = labels[r].
//     A pure gather with two outputs; blocks are independent.
// A negative endpoint (the -1 virtual minimum on altered edges) proposes its
// own value and is never a target, as in the reference.
//
// Bound: bytes. edge_relabel reads both endpoint arrays and the labels and
// writes the labels once; edge_rewrite reads both endpoint arrays and
// writes two. The label gathers are random reads that the 50 MB L2 holds at
// n = 2^22. out[t] starts at labels[t] and only falls, so a proposal that is
// not below the snapshot value at its target is a no-op and is skipped
// before the atomic: an edge whose ends already agree costs no atomic.
// Proposals that converge on an RMAT hub's slot still serialise on its
// atomic; that contention is left as it is.
#include "common.cuh"

namespace {

// labels[e] with a negative e kept as it is; other indices are clamped into
// [0, L) as the reference's gathers clamp.
__device__ __forceinline__ int gather_label(const int* __restrict__ labels,
                                            int e, int64_t L) {
  return e < 0 ? e : labels[connectit::clamp_index(e, L)];
}

__global__ void edge_relabel_kernel(const int* __restrict__ labels,
                                    const int* __restrict__ senders,
                                    const int* __restrict__ receivers,
                                    int* __restrict__ out, int64_t L,
                                    int64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < m; e += stride) {
    const int s = senders[e];
    const int r = receivers[e];
    const int ls = gather_label(labels, s, L);
    const int lr = gather_label(labels, r, L);
    // for 0 <= r < L, lr is the snapshot value at target r (and likewise ls
    // at s), so a proposal at or above it cannot lower out[r]
    if (r >= 0 && static_cast<int64_t>(r) < L && ls < lr) atomicMin(out + r, ls);
    if (s >= 0 && static_cast<int64_t>(s) < L && lr < ls) atomicMin(out + s, lr);
  }
}

__global__ void edge_rewrite_kernel(const int* __restrict__ labels,
                                    const int* __restrict__ senders,
                                    const int* __restrict__ receivers,
                                    int* __restrict__ s_out,
                                    int* __restrict__ r_out, int64_t L,
                                    int64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < m; e += stride) {
    s_out[e] = gather_label(labels, senders[e], L);
    r_out[e] = gather_label(labels, receivers[e], L);
  }
}

}  // namespace

extern "C" int edge_relabel_i32(const void* labels, const void* senders,
                                const void* receivers, void* out, int64_t L,
                                int64_t m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(out, labels, L * sizeof(int),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0 && L > 0) {
    edge_relabel_kernel<<<connectit::grid_for(m), connectit::kThreads, 0, st>>>(
        static_cast<const int*>(labels), static_cast<const int*>(senders),
        static_cast<const int*>(receivers), static_cast<int*>(out), L, m);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int edge_rewrite_i32(const void* labels, const void* senders,
                                const void* receivers, void* s_out,
                                void* r_out, int64_t L, int64_t m,
                                void* stream) {
  if (m > 0 && L > 0) {
    edge_rewrite_kernel<<<connectit::grid_for(m), connectit::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(labels), static_cast<const int*>(senders),
        static_cast<const int*>(receivers), static_cast<int*>(s_out),
        static_cast<int*>(r_out), L, m);
  }
  return static_cast<int>(cudaGetLastError());
}
