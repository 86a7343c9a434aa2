// threefry: jax.random's threefry2x32 draws (jax_threefry_partitionable).
//
// Replaces no TPU kernel: the JAX package draws with jax.random, plain jnp
// that XLA fuses into one pass. Written by hand because the port's plain
// version (repro_torch/kernels/threefry/ref.py) holds each uint32 word in
// int64 and runs ~170 elementwise passes a draw: on an H100 (700 W) the
// main path's k-out column over 2^22 rows took 11 ms that way, against
// ~10 ms for the whole rest of the path.
//
// Element i (a flat index, from `start`) hashes the counter (i >> 32,
// i & 0xFFFFFFFF) under the key (k0, k1) with 20 rounds; its bits are the
// XOR of the two output words (repro_torch/random.py says why).
//   bits_i64:     out[j] = bits of element start + j, as an int64 in
//                 [0, 2^32): the words the float draws (uniform, normal,
//                 exponential) are made from.
//   randint_i32:  jax.random.randint(key, (n,), minval, maxval) for an
//                 int32 maxval array: the bits of two keys (split(key)'s)
//                 reduced modulo the span in wrapping uint32, as
//                 jax._src.random._randint does.
//
// Bound: operations. Each element runs one (bits) or two (randint)
// threefry blocks of ~160 32-bit integer operations; the bytes are the
// output (8 or 4 a element) and randint's maxval (4 a element).
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  int64_t i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32) + ks[0];
  uint32_t x1 = static_cast<uint32_t>(i) + ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[r % 2][j]) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + static_cast<uint32_t>(r + 1);
  }
  return x0 ^ x1;
}

__global__ void bits_kernel(int64_t* __restrict__ out, int64_t n,
                            int64_t start, uint32_t k0, uint32_t k1) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       j < n; j += stride) {
    out[j] = static_cast<int64_t>(threefry_bits(k0, k1, start + j));
  }
}

__global__ void randint_kernel(const int* __restrict__ maxval,
                               int* __restrict__ out, int64_t n, int minval,
                               uint32_t a0, uint32_t a1, uint32_t b0,
                               uint32_t b1) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       j < n; j += stride) {
    const int hi = maxval[j];
    uint32_t span = static_cast<uint32_t>(hi) - static_cast<uint32_t>(minval);
    if (hi <= minval) span = 1u;
    uint32_t mult = 65536u % span;
    mult = (mult * mult) % span;
    const uint32_t higher = threefry_bits(a0, a1, j);
    const uint32_t lower = threefry_bits(b0, b1, j);
    const uint32_t offset = ((higher % span) * mult + lower % span) % span;
    out[j] = static_cast<int>(static_cast<uint32_t>(minval) + offset);
  }
}

}  // namespace

extern "C" int threefry_bits_i64(void* out, int64_t n, int64_t start, int64_t k0, int64_t k1, void* stream) {
  if (n < 1 || start < 0) return static_cast<int>(cudaErrorInvalidValue);
  bits_kernel<<<connectit::grid_for(n), connectit::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(out), n, start, static_cast<uint32_t>(k0),
      static_cast<uint32_t>(k1));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_randint_i32(const void* maxval, void* out, int64_t n, int64_t minval, int64_t a0, int64_t a1, int64_t b0, int64_t b1, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  randint_kernel<<<connectit::grid_for(n), connectit::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(maxval), static_cast<int*>(out), n,
      static_cast<int>(minval), static_cast<uint32_t>(a0),
      static_cast<uint32_t>(a1), static_cast<uint32_t>(b0),
      static_cast<uint32_t>(b1));
  return static_cast<int>(cudaGetLastError());
}
