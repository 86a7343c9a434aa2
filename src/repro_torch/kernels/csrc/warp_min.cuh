// Streaming proposals into a label array with min, shared by scatter_min,
// the hook pass of hook_compress and edge_relabel.
//
// The three kernels stream int32 arrays once (idx/vals, senders/receivers;
// common.cuh's stream_steps), turn each element into at most one proposal
// (slot, value), and lower out[slot] to the value. RMAT inputs send most
// proposals to one hub slot, where one atomicMin per proposal serialised
// (3.06 ms for the canonicalization's 4.19M proposals on an H100). Three
// things keep a proposal off the atomic, none of which changes the result
// (min is order-free, and out only falls):
//   1. inside a lane, a run of equal slots commits its min once;
//   2. neighbouring lanes of a warp with equal slots combine with a
//      segmented min over shuffles, and only the first lane of each run
//      commits;
//   3. the committing lane first reads the slot's current value with a
//      relaxed device-scope load and issues the atomic only if it can win.
// Runs, not arbitrary groups, are combined: __match_any_sync costs more the
// more distinct slots a warp holds, which made uniform targets much slower,
// while equal slots arrive in runs on the paths that contend (ids in order
// in min_vertex_labels, CSR-ordered senders in the hook pass and
// edge_relabel, runs of equal rewritten senders in Stergiou's rounds). The
// read in 3 costs uniform random targets one more L2 access per proposal
// (0.066 -> 0.073 ms); without it the canonicalization took 0.072 ms
// instead of 0.035 and label propagation's fused rounds, whose proposals
// mostly find their slot already there, 1.84 ms instead of 1.52 (PERF.md).
// The load sees other blocks' atomics (it is served by L2, never by the
// non-coherent path), so a stale value can only be too high: an extra
// atomic, never a lost one.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda/atomic>

#include "common.cuh"

namespace connectit {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int load_relaxed(int* p) {
  return cuda::atomic_ref<int, cuda::thread_scope_device>(*p).load(
      cuda::memory_order_relaxed);
}

// Commit V proposals per lane into out (slot < 0: none). Every lane of the
// warp must call it, with the same V. Round q takes the q-th proposal of
// every lane.
template <int V>
__device__ __forceinline__ void commit_min(int* out, int (&slot)[V],
                                           int (&val)[V]) {
  // one vote lets a warp with nothing to commit leave at once (the common
  // case once L_max is pinned to -1) instead of voting round by round
  bool mine = false;
#pragma unroll
  for (int q = 0; q < V; ++q) mine = mine || slot[q] >= 0;
  if (!__any_sync(kFullMask, mine)) return;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  // a run of equal slots inside the lane: its first member takes the run's
  // min and commits it in its round; the others drop out of theirs
  bool follows[V];
  follows[0] = false;
#pragma unroll
  for (int q = 1; q < V; ++q) {
    follows[q] = slot[q] >= 0 && slot[q] == slot[q - 1];
  }
#pragma unroll
  for (int q = V - 2; q >= 0; --q) {
    if (follows[q + 1]) val[q] = min(val[q], val[q + 1]);
  }
  bool lead[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    if (follows[q]) slot[q] = -1;
    lead[q] = false;
    if (__any_sync(kFullMask, slot[q] >= 0)) {
      const int prev = __shfl_up_sync(kFullMask, slot[q], 1);
      const bool joins = slot[q] >= 0 && lane > 0 && prev == slot[q];
      lead[q] = slot[q] >= 0 && !joins;
      if (__any_sync(kFullMask, joins)) {
        // after the doubling steps each lane holds the min over the lanes
        // from itself to the end of its run (and perhaps later lanes of
        // the same slot, which min absorbs), so a run's first lane holds
        // the run's min
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_down_sync(kFullMask, val[q], d);
          const int s = __shfl_down_sync(kFullMask, slot[q], d);
          if (lane + d < 32 && s == slot[q]) val[q] = min(val[q], v);
        }
      }
    }
  }
  // each committing lane reads its slot, then issues the atomic only if it
  // can win; the loads go out together, then the atomics
  int cur[V];
#pragma unroll
  for (int q = 0; q < V; ++q) cur[q] = lead[q] ? load_relaxed(out + slot[q]) : 0;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    if (lead[q] && val[q] < cur[q]) atomicMin(out + slot[q], val[q]);
  }
}

}  // namespace connectit
