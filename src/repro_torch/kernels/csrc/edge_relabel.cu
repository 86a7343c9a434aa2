// edge_relabel and edge_rewrite: the undirected relabel round and the
// Liu-Tarjan alter step, on int32 labels and int32 edge endpoints.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/edge_relabel/
// kernel.py. A negative endpoint (the -1 virtual minimum on altered edges)
// is never gathered through: it proposes, or is rewritten to, its own
// value, and is never a target; nor is an endpoint at or past L, whose
// gather reads the last slot, as the reference's gathers clamp.
//
// edge_relabel (_edge_relabel_kernel, kernel.py:63): out = labels;
// out[r] min= labels[s]; out[s] min= labels[r]. On the TPU the output block
// accumulates across ordered grid steps while every gather reads the input
// block. Hopper runs blocks in no order, so the output is a copy of the
// input labels, every gather reads `labels` (never `out`: reading `out`
// would let a block see other blocks' proposals and turn the Jacobi round
// into a Gauss-Seidel one), and proposals land with atomicMin. Bound:
// bytes, 4(2L + 2m) a call. It makes at most one proposal an edge: out[t]
// starts at labels[t] and only falls, and for a target t the edge's gather
// at t is that snapshot value, so only the end with the larger label can
// take the other's (ls < lr: ls to r; lr < ls: lr to s; equal ends, s == r
// among them, propose nothing). That makes it a warp_min.cuh step, as the
// hook pass is: senders and receivers stream with 16-byte evict-first
// loads, a label is gathered only for a non-negative endpoint (Liu-Tarjan's
// fused rounds carry mostly -1 ends, and an edge with both ends -1 gathers
// nothing), and proposals fold and combine along runs of equal targets
// (CSR runs of one sender; in Stergiou's rounds, runs of equal rewritten
// senders prev[s]) before the relaxed read and the atomic. On an H100 a
// round whose edges are dead (ends equal or -1) runs at the rate of a
// plain copy of the edge arrays; a live round is held by its random label
// gathers and by the read and atomic of proposals to random receivers
// (PERF.md).
//
// edge_rewrite (_edge_rewrite_kernel, kernel.py:96): s' = labels[s],
// r' = labels[r]; a pure gather with two outputs, so blocks are
// independent. Its callers: every Liu-Tarjan alter step (over the whole
// edge list in a fused run, where after the first rounds nearly every end
// is -1), Stergiou's endpoint rewrite each round (the original graph edges,
// every end live), and the stream's batch relabel (2^21 entries against
// 2^22 labels). Bound: bytes, 4(L + 4m) a call at most: both endpoint
// arrays read and both outputs written once, the labels read once. The
// gathers are random 4-byte reads, each a 32-byte L2 sector, and at
// n = 2^22 the 16.8 MB label array stays in the 50 MB L2 only if the 16m
// bytes streamed through it do not push it out. So a lane takes 4 edges
// through stream_steps: 16-byte evict-first loads of both endpoint arrays
// (load_stream), all 8 label gathers issued before any store (a -1 end
// issues none, so a dead call moves only the edge arrays, at the rate of a
// copy), and 16-byte streaming stores of both outputs (store_stream; with
// default stores the graph's call is 25% slower). The wrapper allocates
// each output at its input's 16-byte phase, so that the four arrays share
// one; arrays out of phase take one edge a lane, and so does a call with
// fewer edges than labels (the stream's batches, where 4 a lane measured
// 4% slower than one), and ragged heads and tails go through
// stream_steps' scalar step. What is left on the graph's
// calls is the random gathers' L2 traffic, which the bytes bound does not
// count. Measured and not kept (PERF.md): an L2 evict_last policy on the
// gathers, gathers that bypass L1, default loads, 8 edges a lane, blocks of
// 64 or 128 threads, a persistent grid, reusing a lane's gather along a
// run of equal ends.
#include "warp_min.cuh"

namespace {

// labels[e] with a negative e kept as it is; other indices are clamped into
// [0, L) as the reference's gathers clamp.
__device__ __forceinline__ int gather_label(const int* __restrict__ labels,
                                            int e, int64_t L) {
  return e < 0 ? e : labels[connectit::clamp_index(e, L)];
}

struct RelabelStep {
  const int* __restrict__ labels;
  const int* __restrict__ senders;
  const int* __restrict__ receivers;
  int* out;
  int64_t L;

  template <int W>
  __device__ __forceinline__ void run(int64_t j, bool in) {
    int s[W], r[W];
    if (in) {
      connectit::load_stream<W>(senders, j, s);
      connectit::load_stream<W>(receivers, j, r);
    } else {
#pragma unroll
      for (int q = 0; q < W; ++q) s[q] = r[q] = -1;
    }
    int ls[W], lr[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      ls[q] = gather_label(labels, s[q], L);
      lr[q] = gather_label(labels, r[q], L);
    }
    int slot[W], val[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const bool to_r = r[q] >= 0 && static_cast<int64_t>(r[q]) < L &&
                        ls[q] < lr[q];
      const bool to_s = s[q] >= 0 && static_cast<int64_t>(s[q]) < L &&
                        lr[q] < ls[q];
      slot[q] = to_r ? r[q] : to_s ? s[q] : -1;
      val[q] = to_r ? ls[q] : lr[q];
    }
    connectit::commit_min<W>(out, slot, val);
  }
};

template <int V>
__global__ void __launch_bounds__(connectit::kThreads)
    edge_relabel_kernel(const int* __restrict__ labels,
                        const int* __restrict__ senders,
                        const int* __restrict__ receivers, int* out,
                        int64_t L, int64_t m, int64_t head) {
  RelabelStep step{labels, senders, receivers, out, L};
  connectit::stream_steps<V>(m, head, step);
}

struct RewriteStep {
  const int* __restrict__ labels;
  const int* __restrict__ senders;
  const int* __restrict__ receivers;
  int* __restrict__ s_out;
  int* __restrict__ r_out;
  int64_t L;

  template <int W>
  __device__ __forceinline__ void run(int64_t j, bool in) {
    if (!in) return;
    int s[W], r[W];
    connectit::load_stream<W>(senders, j, s);
    connectit::load_stream<W>(receivers, j, r);
    int a[W], b[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      a[q] = gather_label(labels, s[q], L);
      b[q] = gather_label(labels, r[q], L);
    }
    connectit::store_stream<W>(s_out, j, a);
    connectit::store_stream<W>(r_out, j, b);
  }
};

template <int V>
__global__ void __launch_bounds__(connectit::kThreads)
    edge_rewrite_kernel(const int* __restrict__ labels,
                        const int* __restrict__ senders,
                        const int* __restrict__ receivers,
                        int* __restrict__ s_out, int* __restrict__ r_out,
                        int64_t L, int64_t m, int64_t head) {
  RewriteStep step{labels, senders, receivers, s_out, r_out, L};
  connectit::stream_steps<V>(m, head, step);
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
    const connectit::StreamLayout lay =
        connectit::stream_layout({senders, receivers}, m);
    const int* lab = static_cast<const int*>(labels);
    const int* s = static_cast<const int*>(senders);
    const int* r = static_cast<const int*>(receivers);
    int* o = static_cast<int*>(out);
    const unsigned grid = connectit::grid_for(lay.items);
    if (lay.vec) {
      edge_relabel_kernel<4><<<grid, connectit::kThreads, 0, st>>>(
          lab, s, r, o, L, m, lay.head);
    } else {
      edge_relabel_kernel<1><<<grid, connectit::kThreads, 0, st>>>(
          lab, s, r, o, L, m, 0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int edge_rewrite_i32(const void* labels, const void* senders,
                                const void* receivers, void* s_out,
                                void* r_out, int64_t L, int64_t m,
                                void* stream) {
  if (m > 0 && L > 0) {
    connectit::StreamLayout lay =
        connectit::stream_layout({senders, receivers, s_out, r_out}, m);
    if (m < L) lay = {false, 0, m};  // one edge a lane (see the header)
    const int* lab = static_cast<const int*>(labels);
    const int* s = static_cast<const int*>(senders);
    const int* r = static_cast<const int*>(receivers);
    int* so = static_cast<int*>(s_out);
    int* ro = static_cast<int*>(r_out);
    const unsigned grid = connectit::grid_for(lay.items);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (lay.vec) {
      edge_rewrite_kernel<4><<<grid, connectit::kThreads, 0, st>>>(
          lab, s, r, so, ro, L, m, lay.head);
    } else {
      edge_rewrite_kernel<1><<<grid, connectit::kThreads, 0, st>>>(
          lab, s, r, so, ro, L, m, 0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
