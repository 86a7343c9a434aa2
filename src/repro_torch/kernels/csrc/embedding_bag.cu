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

// ---------------------------------------------------------------------------
// Backward: d table of a float32 bag, into a zeroed (rows, D) gradient.
//
// Replaces no TPU kernel: the JAX package's gradient is XLA's transpose of
// the gather (a scatter-add). Added so that DLRM trains on the card.
//
// grad[r] = sum over the positions p = b * L + l that read row r of
//   sum:  grad_out[b]
//   mean: grad_out[b] / max(#valid ids of bag b, 1)
//   max:  grad_out[b] / (#ties of the bag's max on that column), where
//         the position's id is valid and its row equals the max there
// with rows read through the forward's id contract (wrap once, clamp).
//
// Deterministic: a float add is not associative, and atomics add in an
// order that changes from run to run, so the positions are put in a fixed
// order instead. keys (launch 1) writes each position's row; the wrapper
// sorts (row, position) stably (a library sort: it orders the work and adds
// nothing); then reduce (launch 2) gives each warp a chunk of kChunk sorted
// positions and sums each run of one row in position order. A run inside
// one chunk is written whole. A run across chunks (RecsysStream's hub row
// 0 is read by ~5% of the bags, ~3,300 of 65,536) leaves one partial per
// chunk, and combine (launch 3) adds a run's partials in chunk order, so no
// row is summed by one warp alone from end to end.
//
// Bound: bytes. The ids (B*L), grad_out (B*D) and the touched rows of the
// gradient (written once); max also reads the bags' table rows. The zeroing
// of the whole gradient (rows*D) is the wrapper's, counted apart.

constexpr int kChunk = 32;  // sorted positions per warp
constexpr int kWarp = 32;

__device__ __forceinline__ int bag_row(int raw, int64_t rows) {
  int64_t r = raw < 0 ? raw + rows : static_cast<int64_t>(raw);
  r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
  return static_cast<int>(r);
}

// keys[p] = the row position p reads; for max, also contrib[p, :] = the
// gradient that position p passes to its row (0 where it is not a max).
__global__ void bag_backward_keys(const float* __restrict__ table,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ grad_out,
                                  int* __restrict__ keys,
                                  float* __restrict__ contrib, int64_t rows,
                                  int64_t D, int64_t B, int64_t L, int mode) {
  const int64_t N = B * L;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       p < N; p += stride) {
    keys[p] = bag_row(idx[p], rows);
  }
  if (mode != kMax) return;
  // one thread per (bag, column): the masked max over L, its ties, and each
  // position's share
  const float neg = -FLT_MAX;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       t < B * D; t += stride) {
    const int64_t b = t / D, c = t % D;
    const int* ids = idx + b * L;
    float mx = neg;
    for (int64_t l = 0; l < L; ++l) {
      const bool valid = static_cast<int64_t>(ids[l]) < rows - 1;
      const float v = valid ? table[bag_row(ids[l], rows) * D + c] : neg;
      mx = fmaxf(mx, v);
    }
    int ties = 0;
    for (int64_t l = 0; l < L; ++l) {
      const bool valid = static_cast<int64_t>(ids[l]) < rows - 1;
      const float v = valid ? table[bag_row(ids[l], rows) * D + c] : neg;
      ties += v == mx;
    }
    const float share = grad_out[b * D + c] / static_cast<float>(ties);
    for (int64_t l = 0; l < L; ++l) {
      const bool valid = static_cast<int64_t>(ids[l]) < rows - 1;
      const float v = valid ? table[bag_row(ids[l], rows) * D + c] : neg;
      contrib[(b * L + l) * D + c] = valid && v == mx ? share : 0.0f;
    }
  }
}

// The value that sorted position p passes to column c of its row.
__device__ __forceinline__ float bag_value(const float* __restrict__ src,
                                           const int* __restrict__ idx,
                                           int64_t p, int64_t c, int64_t rows,
                                           int64_t D, int64_t L, int mode) {
  if (mode == kMax) return src[p * D + c];
  const int64_t b = p / L;
  const float g = src[b * D + c];
  if (mode == kSum) return g;
  int64_t n_valid = 0;
  for (int64_t l = 0; l < L; ++l) {
    n_valid += static_cast<int64_t>(idx[b * L + l]) < rows - 1;
  }
  return g / static_cast<float>(n_valid > 0 ? n_valid : 1);
}

// One warp per chunk of sorted positions; lanes over columns.
__global__ void bag_backward_reduce(const float* __restrict__ src,
                                    const int* __restrict__ idx,
                                    const int* __restrict__ sorted_rows,
                                    const int64_t* __restrict__ perm,
                                    float* __restrict__ grad,
                                    float* __restrict__ head,
                                    float* __restrict__ tail, int64_t rows,
                                    int64_t D, int64_t B, int64_t L,
                                    int mode) {
  const int64_t N = B * L;
  const int64_t n_chunks = (N + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);
  for (int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x / kWarp) +
                   threadIdx.x / kWarp;
       k < n_chunks; k += warps) {
    const int64_t c0 = k * kChunk;
    const int64_t c1 = c0 + kChunk < N ? c0 + kChunk : N;
    const bool from_before = c0 > 0 && sorted_rows[c0 - 1] == sorted_rows[c0];
    const bool to_after = c1 < N && sorted_rows[c1] == sorted_rows[c1 - 1];
    for (int64_t c = lane; c < D; c += kWarp) {
      int cur = sorted_rows[c0];
      bool is_head = from_before;
      float acc = 0.0f;
      for (int64_t i = c0; i < c1; ++i) {
        const int r = sorted_rows[i];
        if (r != cur) {  // the run of cur ended inside this chunk
          (is_head ? head + k * D : grad + static_cast<int64_t>(cur) * D)[c] =
              acc;
          cur = r;
          is_head = false;
          acc = 0.0f;
        }
        acc += bag_value(src, idx, perm[i], c, rows, D, L, mode);
      }
      if (is_head) {
        head[k * D + c] = acc;
      } else if (to_after) {
        tail[k * D + c] = acc;
      } else {
        grad[static_cast<int64_t>(cur) * D + c] = acc;
      }
    }
  }
}

// One warp per chunk whose last run starts in it and goes on past it: that
// run's partials, in chunk order, into its row.
__global__ void bag_backward_combine(const int* __restrict__ sorted_rows,
                                     float* __restrict__ grad,
                                     const float* __restrict__ head,
                                     const float* __restrict__ tail,
                                     int64_t D, int64_t N) {
  const int64_t n_chunks = (N + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);
  for (int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x / kWarp) +
                   threadIdx.x / kWarp;
       k < n_chunks; k += warps) {
    const int64_t c0 = k * kChunk;
    const int64_t c1 = c0 + kChunk < N ? c0 + kChunk : N;
    const int row = sorted_rows[c1 - 1];
    const bool to_after = c1 < N && sorted_rows[c1] == row;
    const bool starts_here = !(c0 > 0 && sorted_rows[c0 - 1] == row);
    if (!(to_after && starts_here)) continue;
    for (int64_t c = lane; c < D; c += kWarp) {
      float acc = tail[k * D + c];
      for (int64_t j = k + 1; j < n_chunks; ++j) {
        acc += head[j * D + c];
        const int64_t e = (j + 1) * kChunk;
        if (!(e < N && sorted_rows[e] == row)) break;  // the run ends in j
      }
      grad[static_cast<int64_t>(row) * D + c] = acc;
    }
  }
}

unsigned warp_grid(int64_t n_chunks) {
  const int64_t per_block = connectit::kThreads / kWarp;
  int64_t blocks = (n_chunks + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > connectit::kMaxBlocks) blocks = connectit::kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" int embedding_bag_f32(const void* table, const void* idx, void* out, int64_t rows, int64_t D, int64_t B, int64_t L, int mode, void* stream) {
  return embedding_bag<float>(table, idx, out, rows, D, B, L, mode, stream);
}

extern "C" int embedding_bag_bf16(const void* table, const void* idx, void* out, int64_t rows, int64_t D, int64_t B, int64_t L, int mode, void* stream) {
  return embedding_bag<__nv_bfloat16>(table, idx, out, rows, D, B, L, mode,
                                      stream);
}

// Launch 1 of the backward: keys (B*L,) int32 rows; for max also contrib
// (B*L, D) float32. table is read for max only.
extern "C" int embedding_bag_backward_keys_f32(const void* table, const void* idx, const void* grad_out, void* keys, void* contrib, int64_t rows, int64_t D, int64_t B, int64_t L, int mode, void* stream) {
  if (mode < kSum || mode > kMax || rows < 1 || D < 1 || B < 1 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t work = mode == kMax && B * D > B * L ? B * D : B * L;
  bag_backward_keys<<<connectit::grid_for(work), connectit::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(grad_out), static_cast<int*>(keys),
      static_cast<float*>(contrib), rows, D, B, L, mode);
  return static_cast<int>(cudaGetLastError());
}

// Launches 2 and 3: src is grad_out (B, D) for sum and mean, contrib
// (B*L, D) for max; sorted_rows/perm the stable sort of keys; head/tail
// (ceil(B*L / 32), D) scratch; grad (rows, D) zeroed.
extern "C" int embedding_bag_backward_f32(const void* src, const void* idx, const void* sorted_rows, const void* perm, void* grad, void* head, void* tail, int64_t rows, int64_t D, int64_t B, int64_t L, int mode, void* stream) {
  if (mode < kSum || mode > kMax || rows < 1 || D < 1 || B < 1 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_chunks = (B * L + kChunk - 1) / kChunk;
  bag_backward_reduce<<<warp_grid(n_chunks), connectit::kThreads, 0, st>>>(
      static_cast<const float*>(src), static_cast<const int*>(idx),
      static_cast<const int*>(sorted_rows),
      static_cast<const int64_t*>(perm), static_cast<float*>(grad),
      static_cast<float*>(head), static_cast<float*>(tail), rows, D, B, L,
      mode);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bag_backward_combine<<<warp_grid(n_chunks), connectit::kThreads, 0, st>>>(
      static_cast<const int*>(sorted_rows), static_cast<float*>(grad),
      static_cast<const float*>(head), static_cast<const float*>(tail), D,
      B * L);
  return static_cast<int>(cudaGetLastError());
}
