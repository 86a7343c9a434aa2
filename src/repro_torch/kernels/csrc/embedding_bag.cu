// embedding_bag: out[b] = reduce over l of table[id(idx[b, l])], by sum,
// mean or max, for float32 and bfloat16 tables.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/legacy/embedding_bag/kernel.py (embedding_bag /
// _embedding_bag_kernel). The TPU kernel holds the whole (rows, D) table as
// one VMEM-resident block and gathers from it; at DLRM-RM2 width a table is
// 1,000,448 x 64 float32 = 256 MB, which no on-chip memory holds. Here the
// table stays in device memory and the gathered rows come through L2.
//
// Layout: a group of G lanes (a power of two, at most a warp) per bag, G
// just large enough that its lanes cover D with one vector each, so a D=64
// float32 row is one 256-byte request of 16 lanes x 16 bytes. Each lane
// loops over the bag's L ids, accumulating its VEC columns in float32
// registers, and writes its columns once in the table's dtype. Rows wider
// than G x VEC are covered by an outer loop over column chunks.
//
// Id contract (the reference's gather): a negative id wraps once
// (id + rows), then clamps into [0, rows - 1]; an id counts as valid for
// mean and max when the raw id is below rows - 1 (the dump row). mean
// divides the sum over all L rows by max(#valid, 1); max takes the dtype's
// lowest finite value where an id is not valid.
//
// Bound: bytes (B*L gathered rows of D values, B*L ids and B*D outputs,
// each moved once); the adds are 1 per gathered value.
#include <cuda_bf16.h>

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

enum Mode : int { kSum = 0, kMean = 1, kMax = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// finfo(dtype).min, exactly representable in float
template <typename T>
__device__ __forceinline__ float lowest();
template <>
__device__ __forceinline__ float lowest<float>() { return -FLT_MAX; }
template <>
__device__ __forceinline__ float lowest<__nv_bfloat16>() {
  return -0x1.fep+127f;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const int* __restrict__ idx,
                                     T* __restrict__ out, int64_t rows,
                                     int64_t D, int64_t B, int64_t L,
                                     int mode, int log2_group) {
  const int group = 1 << log2_group;
  const int lane = threadIdx.x & (group - 1);
  const int64_t groups_per_block = blockDim.x >> log2_group;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * groups_per_block;
  const float init = mode == kMax ? lowest<T>() : 0.0f;
  for (int64_t b = blockIdx.x * groups_per_block + (threadIdx.x >> log2_group);
       b < B; b += stride) {
    const int* ids = idx + b * L;
    for (int64_t c0 = static_cast<int64_t>(lane) * VEC; c0 < D;
         c0 += static_cast<int64_t>(group) * VEC) {
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = init;
      int64_t n_valid = 0;
      for (int64_t l = 0; l < L; ++l) {
        const int raw = ids[l];
        int64_t r = raw < 0 ? raw + rows : static_cast<int64_t>(raw);
        r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
        const bool valid = static_cast<int64_t>(raw) < rows - 1;
        n_valid += valid;
        const Vec<T, VEC> x =
            *reinterpret_cast<const Vec<T, VEC>*>(table + r * D + c0);
        if (mode == kMax) {
          if (valid) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = fmaxf(acc[k], to_float(x.v[k]));
          }
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += to_float(x.v[k]);
        }
      }
      if (mode == kMean) {
        const float cnt = static_cast<float>(n_valid > 0 ? n_valid : 1);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] /= cnt;
      }
      Vec<T, VEC> y;
#pragma unroll
      for (int k = 0; k < VEC; ++k) y.v[k] = from_float<T>(acc[k]);
      *reinterpret_cast<Vec<T, VEC>*>(out + b * D + c0) = y;
    }
  }
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// Launch with the widest vector of at most 16 bytes that divides D and
// keeps every row of the table and of the output aligned.
template <typename T, int VEC>
int launch(const void* table, const void* idx, void* out, int64_t rows,
           int64_t D, int64_t B, int64_t L, int mode, cudaStream_t st) {
  if constexpr (VEC > 1) {
    if (D % VEC != 0 || !aligned(table, sizeof(T) * VEC) ||
        !aligned(out, sizeof(T) * VEC)) {
      return launch<T, VEC / 2>(table, idx, out, rows, D, B, L, mode, st);
    }
  }
  const int64_t vectors = D / VEC;
  int log2_group = 0;
  while (log2_group < 5 && (int64_t{1} << log2_group) < vectors) ++log2_group;
  const int64_t groups_per_block = connectit::kThreads >> log2_group;
  int64_t blocks = (B + groups_per_block - 1) / groups_per_block;
  if (blocks > connectit::kMaxBlocks) blocks = connectit::kMaxBlocks;
  embedding_bag_kernel<T, VEC>
      <<<static_cast<unsigned>(blocks), connectit::kThreads, 0, st>>>(
          static_cast<const T*>(table), static_cast<const int*>(idx),
          static_cast<T*>(out), rows, D, B, L, mode, log2_group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int embedding_bag(const void* table, const void* idx, void* out, int64_t rows,
                  int64_t D, int64_t B, int64_t L, int mode, void* stream) {
  if (mode < kSum || mode > kMax || rows < 1 || D < 1 || B < 1 || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<T, 16 / sizeof(T)>(table, idx, out, rows, D, B, L, mode,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int embedding_bag_f32(const void* table, const void* idx, void* out, int64_t rows, int64_t D, int64_t B, int64_t L, int mode, void* stream) {
  return embedding_bag<float>(table, idx, out, rows, D, B, L, mode, stream);
}

extern "C" int embedding_bag_bf16(const void* table, const void* idx, void* out, int64_t rows, int64_t D, int64_t B, int64_t L, int mode, void* stream) {
  return embedding_bag<__nv_bfloat16>(table, idx, out, rows, D, B, L, mode,
                                      stream);
}
