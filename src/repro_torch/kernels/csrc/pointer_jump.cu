// pointer_jump: k chained shortcut hops through the round-start snapshot.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pointer_jump/kernel.py
// (pointer_jump / _pointer_jump_kernel). On the TPU the whole label array
// sits in VMEM and each grid step writes one output block; here the hop
// pass of hops.cuh gathers through the label array in device memory (held
// in L2) and writes a separate output buffer, so every hop reads the
// snapshot (an in-place update would change what a k-hop call returns).
//
// Bound: bytes. Each slot reads its label once and writes its result once
// (8 bytes a slot); hops.cuh says how the k dependent gathers are kept in
// L2 and in flight. No shared memory is needed: a gather has no reuse a
// block could stage.
#include "hops.cuh"

extern "C" int pointer_jump_i32(const void* labels, void* out, int64_t L,
                                int k, void* stream) {
  return static_cast<int>(connectit::launch_hops(
      static_cast<const int*>(labels), static_cast<int*>(out), L, k,
      static_cast<cudaStream_t>(stream)));
}
