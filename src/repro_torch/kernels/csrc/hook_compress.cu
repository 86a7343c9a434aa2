// hook_compress: one uf_sync round, root-masked min-hook then k shortcut hops.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hook_compress/kernel.py
// (hook_compress / _hook_compress_kernel). On the TPU the grid runs in order:
// every edge block hooks into one VMEM accumulator, and the last grid step
// runs the hops over the finished array. Hopper has no such order between
// blocks, so the round is three steps on one stream:
//   (a) copy labels -> hooked;
//   (b) hook kernel: gathers read the *input* labels (the round-start
//       snapshot), proposals min into `hooked`;
//   (c) hop kernel (hops.cuh, shared with pointer_jump): a second launch,
//       so it starts only after every hook has landed, reads `hooked` and
//       writes a third buffer.
// Fusing (b) and (c) without a grid-wide barrier, or hopping in place, would
// let a hop read a half-hooked array and change the round's result. With
// this order the output equals hook_compress_ref bit for bit.
//
// Bound: bytes. Per edge: two endpoint reads and up to three label gathers;
// per slot: one copy, one hop pass. The hook pass streams the edges (8
// bytes an edge, read once) with 16-byte evict-first loads, so that they do
// not evict the label array (16.8 MB at n = 2^22) from the 50 MB L2 while
// its random gathers run. Hooks that converge on one root (an RMAT hub's)
// go through warp_min.cuh, which folds, combines and drops them before the
// atomic. `hooked` is read only there, by the relaxed load that decides
// whether an atomic can win; every gather reads `labels`.
#include "hops.cuh"
#include "warp_min.cuh"

namespace {

struct HookStep {
  const int* __restrict__ labels;
  const int* __restrict__ senders;
  const int* __restrict__ receivers;
  int* hooked;
  int64_t L;

  template <int W>
  __device__ __forceinline__ void run(int64_t j, bool in) {
    int s[W] = {};
    if (in) connectit::load_stream<W>(senders, j, s);
    int slot[W];
    bool any = false;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const int pu = in ? __ldg(labels + connectit::clamp_index(s[q], L)) : -1;
      slot[q] = pu >= 0 && static_cast<int64_t>(pu) < L ? pu : -1;  // -1 never hooks
      any = any || slot[q] >= 0;
    }
    // the receivers are read only where a sender can hook: with L_max
    // pinned to -1 most edges stop at their sender
    int r[W] = {};
    if (any) connectit::load_stream<W>(receivers, j, r);
    int val[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      val[q] = slot[q] >= 0
                   ? __ldg(labels + connectit::clamp_index(r[q], L)) : 0;
      if (val[q] >= slot[q]) slot[q] = -1;                   // min-based union
    }
#pragma unroll
    for (int q = 0; q < W; ++q) {
      if (slot[q] >= 0 && __ldg(labels + slot[q]) != slot[q]) slot[q] = -1;  // roots only
    }
    connectit::commit_min<W>(hooked, slot, val);
  }
};

template <int V>
__global__ void __launch_bounds__(connectit::kThreads)
    hook_kernel(const int* __restrict__ labels,
                const int* __restrict__ senders,
                const int* __restrict__ receivers, int* hooked, int64_t L,
                int64_t m, int64_t head) {
  HookStep step{labels, senders, receivers, hooked, L};
  connectit::stream_steps<V>(m, head, step);
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
    const connectit::StreamLayout lay =
        connectit::stream_layout({senders, receivers}, m);
    const int* lab = static_cast<const int*>(labels);
    const int* s = static_cast<const int*>(senders);
    const int* r = static_cast<const int*>(receivers);
    int* h = static_cast<int*>(hooked);
    const unsigned grid = connectit::grid_for(lay.items);
    if (lay.vec) {
      hook_kernel<4><<<grid, connectit::kThreads, 0, st>>>(lab, s, r, h, L, m,
                                                          lay.head);
    } else {
      hook_kernel<1><<<grid, connectit::kThreads, 0, st>>>(lab, s, r, h, L, m,
                                                          0);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(connectit::launch_hops(
      static_cast<const int*>(hooked), static_cast<int*>(out), L, k, st));
}
