// hook_compress: one uf_sync round, root-masked min-hook then k shortcut hops.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hook_compress/kernel.py
// (hook_compress / _hook_compress_kernel). On the TPU the grid runs in order:
// every edge block hooks into one VMEM accumulator, and the last grid step
// runs the hops over the finished array. Hopper has no such order between
// blocks, so the round is three steps on one stream:
//   (a) copy labels -> hooked;
//   (b) hook kernel: gathers read the *input* labels (the round-start
//       snapshot), proposals atomicMin into `hooked`;
//   (c) hop kernel: a second launch, so it starts only after every hook has
//       landed, reads `hooked` and writes a third buffer.
// Fusing (b) and (c) without a grid-wide barrier, or hopping in place, would
// let a hop read a half-hooked array and change the round's result. With
// this order the output equals hook_compress_ref bit for bit.
//
// Bound: bytes. Per edge: two endpoint reads and up to three label gathers;
// per slot: one copy, one hop pass. Hooks that converge on an RMAT hub's
// root serialise on its atomicMin; that contention is left as it is.
#include "hops.cuh"

namespace {

__global__ void hook_kernel(const int* __restrict__ labels,
                            const int* __restrict__ senders,
                            const int* __restrict__ receivers,
                            int* __restrict__ hooked, int64_t L, int64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < m; e += stride) {
    const int pu = labels[connectit::clamp_index(senders[e], L)];
    if (pu < 0 || static_cast<int64_t>(pu) >= L) continue;  // -1 never hooks
    const int pv = labels[connectit::clamp_index(receivers[e], L)];
    if (pv >= pu) continue;                                 // min-based union
    if (labels[pu] != pu) continue;                         // roots only
    atomicMin(hooked + pu, pv);
  }
}

}  // namespace

// `out` may be null when k == 0: the hooked array is then the result.
extern "C" int hook_compress_i32(const void* labels, const void* senders,
                                 const void* receivers, void* hooked,
                                 void* out, int64_t L, int64_t m, int k,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(hooked, labels, L * sizeof(int),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0) {
    hook_kernel<<<connectit::grid_for(m), connectit::kThreads, 0, st>>>(
        static_cast<const int*>(labels), static_cast<const int*>(senders),
        static_cast<const int*>(receivers), static_cast<int*>(hooked), L, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (k > 0 && L > 0) {
    connectit::hops_kernel<<<connectit::grid_for(L), connectit::kThreads, 0,
                             st>>>(static_cast<const int*>(hooked),
                                   static_cast<int*>(out), L, k);
  }
  return static_cast<int>(cudaGetLastError());
}
