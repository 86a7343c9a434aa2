// Shared helpers of the connectivity kernels (int32 labels, sm_90a).
//
// Conventions, the same as the dispatch layer's (repro_torch/kernels/ops.py):
//   * a label array is (L,) int32 whose last slot is the dump row;
//   * -1 (any negative label) is the virtual minimum: a fixed point of every
//     hop, never a scatter target;
//   * every index these kernels gather through is read as the reference's
//     gathers read it (clamp_index), so an out-of-contract input cannot read
//     outside the array.
//
// Every kernel streams one or two int32 arrays once (edges, or the labels
// themselves) with 16-byte loads where the arrays' alignment allows it:
// stream_steps below hands each lane 4 consecutive elements, and the
// unaligned head and ragged tail go one element a lane.
#pragma once

#include <cstdint>
#include <initializer_list>

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

// The slot that the reference's gather x[i] reads in an (L,) array: a
// negative i counts from the end once, and what is still outside [0, L)
// clamps into it (repro_torch/kernels/index.py is the same map). In 32-bit
// arithmetic, exact for 1 <= L <= 2^31: with 64-bit arithmetic the hook
// pass of hook_compress ran 30% slower on the fused main path's labels.
__device__ __forceinline__ int64_t clamp_index(int x, int64_t L) {
  const int last = static_cast<int>(L - 1);
  int i = x < 0 ? x + last + 1 : x;
  i = i < 0 ? 0 : i;
  return i < last ? i : last;
}

// V consecutive elements of p from element j, with one load: 16 bytes for
// V = 4 (p + j must be 16-byte aligned), 4 for V = 1. Evict-first: for
// arrays read once (edges), so that they do not evict from L2 what the
// kernels gather.
template <int V>
__device__ __forceinline__ void load_stream(const int* p, int64_t j,
                                            int (&x)[V]) {
  if constexpr (V == 4) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p + j));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldcs(p + j);
  }
}

// The same with a normal caching load: for an array that is also the
// gather target, which must stay in L2.
template <int V>
__device__ __forceinline__ void load_cached(const int* __restrict__ p,
                                            int64_t j, int (&x)[V]) {
  if constexpr (V == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p + j));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p + j);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(int* p, int64_t j,
                                          const int (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p + j) = make_int4(x[0], x[1], x[2], x[3]);
  } else {
    p[j] = x[0];
  }
}

// The stores of load_stream: streaming (st.global.cs), for an output that
// no later step of the kernel reads, so that it does not evict from L2
// what the kernel gathers.
template <int V>
__device__ __forceinline__ void store_stream(int* p, int64_t j,
                                             const int (&x)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<int4*>(p + j), make_int4(x[0], x[1], x[2], x[3]));
  } else {
    __stcs(p + j, x[0]);
  }
}

// Call step.template run<W>(j, in) over elements [0, m): with V = 4, lanes
// take 4 elements each from `head` on, which the caller has made 16-byte
// aligned in every array the step streams; with V = 1, one each. The `head`
// leading elements and the ragged tail are one W = 1 step of the grid's
// first warp. Every lane of a warp runs every step (out-of-range lanes with
// in = false), so a step may use warp collectives.
template <int V, typename Step>
__device__ __forceinline__ void stream_steps(int64_t m, int64_t head,
                                             Step& step) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t nvec = (m - head) / V;
  if (V > 1 && warp == 0) {
    const int64_t tail = head + nvec * V;
    const int64_t j = lane < head ? lane : tail + (lane - head);
    step.template run<1>(j, j < m);
  }
  for (int64_t base = warp * 32; base < nvec; base += warps * 32) {
    const int64_t t = base + lane;
    step.template run<V>(head + t * V, t < nvec);
  }
}

// How a stream_steps kernel covers int32 arrays of length m: vectors of 4
// when all lie equally far past a 16-byte boundary (`head` scalar elements
// lead to it), scalars otherwise; `items` is the number of vectors (or
// scalars) the grid strides over.
struct StreamLayout {
  bool vec;
  int64_t head;
  int64_t items;
};

inline StreamLayout stream_layout(std::initializer_list<const void*> arrays,
                                  int64_t m) {
  const uintptr_t off = reinterpret_cast<uintptr_t>(*arrays.begin()) % 16;
  for (const void* p : arrays) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != off) return {false, 0, m};
  }
  if (off % sizeof(int) != 0) return {false, 0, m};
  int64_t head = static_cast<int64_t>((16 - off) % 16 / sizeof(int));
  if (head > m) head = m;
  return {true, head, (m - head) / 4};
}

}  // namespace connectit
