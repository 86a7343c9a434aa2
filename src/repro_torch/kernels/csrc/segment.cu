// segment_sum: out[r, :] = sum of vals[order[k], :] over k in
// [offsets[r], offsets[r + 1]), for float32 and bfloat16 values, summed in
// float32 and rounded once; an empty row is written as 0.
//
// Replaces no TPU kernel: the reference aggregates its GNN messages with
// jax.ops.segment_sum, which XLA lowers itself (src/repro/legacy/models/
// gnn.py, nequip.py). It was added so that a GNN train step gives the same
// bits on every run: the library's scatter-adds (index_add_, scatter_add_,
// the backward of indexing) add with atomics, in another order each run.
// Here the caller sorts the ids once (a stable sort, the same every run)
// and every sum is taken in an order fixed by the layout alone.
//
// Layout: the sorted positions [0, offsets[R]) are cut into chunks of
// `chunk` positions (a power of two, 32 to 256), a warp a chunk and tile of
// columns, so a hub row (the dump row takes every padded edge) is spread
// over many warps, and so are the columns of a wide row.
//   1. segment_pieces_kernel: the warp walks the rows its chunk meets (the
//      first found by a binary search of offsets) and sums each row's
//      positions inside the chunk. A row wholly inside the chunk is written
//      to out; the piece of a row that began in an earlier chunk goes to
//      head[chunk], the piece of a row that goes on past the chunk to
//      tail[chunk] (float32 scratch, one row each).
//   2. segment_rows_kernel: a warp a row (and tile of 32 column vectors);
//      a row that spans chunks c0..c1 is tail[c0] + head[c0 + 1] + ... +
//      head[c1], added in that order and rounded once; an empty row is
//      written as 0.
// Inside a chunk the warp's 32 lanes are 32 / W entry slots of W lanes, W
// the least power of two whose lanes cover the row with one V-wide vector
// each, at most 32 (V the widest of at most 16 bytes that divides the
// width; a wider row takes a warp per tile of 32 vectors): a slot takes
// every (32 / W)-th position, its lanes adjacent vectors of columns, and
// the slots' sums are folded by an xor butterfly (the same pairs in the
// same order on every run). Element offsets are 64-bit: an ogb_products
// layer's messages are 61,865,984 x 100 elements, past INT32_MAX.
//
// Bound: bytes. Each position's row of vals is read once, with its 4-byte
// order entry, the offsets once and each output row written once; the
// adds are one per value read, far below the card's float32 rate. The
// scratch (two float32 rows a chunk, written for the rows that span
// chunks only) adds at most 8 d / chunk bytes a position.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

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

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void add_vec(float (&acc)[V], const T* p) {
  const Vec<T, V> x = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] += to_float(x.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&acc)[V]) {
  Vec<T, V> y;
#pragma unroll
  for (int i = 0; i < V; ++i) y.v[i] = from_float<T>(acc[i]);
  *reinterpret_cast<Vec<T, V>*>(p) = y;
}

template <typename T, int V>
__global__ void __launch_bounds__(connectit::kThreads)
    segment_pieces_kernel(const T* __restrict__ vals,
                          const int* __restrict__ order,
                          const int* __restrict__ offsets,
                          T* __restrict__ out, float* __restrict__ head,
                          float* __restrict__ tail, int64_t rows, int64_t d,
                          int64_t chunk, int64_t n_chunks, int log2_width) {
  const int width = 1 << log2_width;
  const int lane = threadIdx.x & 31;
  const int col = lane & (width - 1);
  const int slot = lane >> log2_width;
  const int slots = 32 >> log2_width;
  const int64_t groups = d / V;
  const int64_t tiles = (groups + width - 1) / width;
  const int64_t total = __ldg(offsets + rows);
  const int64_t warps = blockDim.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  // a warp a (chunk, column tile): W vectors of columns
  for (int64_t w = blockIdx.x * warps + (threadIdx.x >> 5);
       w < n_chunks * tiles; w += stride) {
    const int64_t c = w / tiles;
    const int64_t g = (w - c * tiles) * width + col;
    const int64_t cs = c * chunk;
    if (cs >= total) break;  // the chunks left hold dropped ids only
    const int64_t ce = cs + chunk < total ? cs + chunk : total;
    // the row holding position cs: the last r with offsets[r] <= cs
    // (offsets[0] = 0 <= cs < total = offsets[rows])
    int64_t lo = 0, hi = rows;
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(offsets + mid) <= cs) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    for (int64_t r = lo; r < rows; ++r) {
      const int64_t b = __ldg(offsets + r);
      if (b >= ce) break;
      const int64_t e = __ldg(offsets + r + 1);
      if (e == b) continue;  // empty: written by segment_rows_kernel
      const int64_t kb = b > cs ? b : cs;
      const int64_t ke = e < ce ? e : ce;
      float* piece = b < cs ? head + c * d : (e > ce ? tail + c * d : nullptr);
      {
        const bool live = g < groups;
        const int64_t at = g * V;
        float acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
        int64_t k = kb + slot;
        if (live) {
          // four positions at a time: their loads are in flight together,
          // and each is added in its turn
          for (; k + 3 * slots < ke; k += 4 * slots) {
            const T* p0 = vals + static_cast<int64_t>(__ldg(order + k)) * d;
            const T* p1 =
                vals + static_cast<int64_t>(__ldg(order + k + slots)) * d;
            const T* p2 =
                vals + static_cast<int64_t>(__ldg(order + k + 2 * slots)) * d;
            const T* p3 =
                vals + static_cast<int64_t>(__ldg(order + k + 3 * slots)) * d;
            const Vec<T, V> x0 = *reinterpret_cast<const Vec<T, V>*>(p0 + at);
            const Vec<T, V> x1 = *reinterpret_cast<const Vec<T, V>*>(p1 + at);
            const Vec<T, V> x2 = *reinterpret_cast<const Vec<T, V>*>(p2 + at);
            const Vec<T, V> x3 = *reinterpret_cast<const Vec<T, V>*>(p3 + at);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              acc[i] += to_float(x0.v[i]);
              acc[i] += to_float(x1.v[i]);
              acc[i] += to_float(x2.v[i]);
              acc[i] += to_float(x3.v[i]);
            }
          }
          for (; k < ke; k += slots) {
            add_vec<T, V>(acc,
                          vals + static_cast<int64_t>(__ldg(order + k)) * d +
                              at);
          }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          for (int off = width; off < 32; off <<= 1) {
            acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
          }
        }
        if (slot == 0 && live) {
          if (piece != nullptr) {
#pragma unroll
            for (int i = 0; i < V; ++i) piece[at + i] = acc[i];
          } else {
            store_vec<T, V>(out + r * d + at, acc);
          }
        }
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(connectit::kThreads)
    segment_rows_kernel(const int* __restrict__ offsets, T* __restrict__ out,
                        const float* __restrict__ head,
                        const float* __restrict__ tail, int64_t rows,
                        int64_t d, int64_t chunk) {
  const int lane = threadIdx.x & 31;
  const int64_t groups = d / V;
  const int64_t tiles = (groups + 31) / 32;
  const int64_t warps = blockDim.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  // a warp a (row, tile of 32 column vectors)
  for (int64_t w = blockIdx.x * warps + (threadIdx.x >> 5); w < rows * tiles;
       w += stride) {
    const int64_t r = w / tiles;
    const int64_t g = (w - r * tiles) * 32 + lane;
    const int64_t b = __ldg(offsets + r);
    const int64_t e = __ldg(offsets + r + 1);
    const int64_t c0 = b / chunk;
    const int64_t c1 = e > b ? (e - 1) / chunk : c0;
    if (e > b && c0 == c1) continue;  // written whole by the pieces kernel
    if (g < groups) {
      const int64_t at = g * V;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[i] = e > b ? tail[c0 * d + at + i] : 0.0f;
      }
#pragma unroll 4
      for (int64_t c = c0 + 1; c <= c1; ++c) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += head[c * d + at + i];
      }
      store_vec<T, V>(out + r * d + at, acc);
    }
  }
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// Launch with the widest vector of at most 16 bytes that divides d and
// keeps every row of vals and of out aligned.
template <typename T, int V>
int launch(const void* vals, const void* order, const void* offsets,
           void* out, void* scratch, int64_t rows, int64_t d, int64_t chunk,
           int64_t n_chunks, cudaStream_t st) {
  if constexpr (V > 1) {
    if (d % V != 0 || !aligned(vals, sizeof(T) * V) ||
        !aligned(out, sizeof(T) * V)) {
      return launch<T, V / 2>(vals, order, offsets, out, scratch, rows, d,
                              chunk, n_chunks, st);
    }
  }
  const int64_t groups = d / V;
  int log2_width = 0;
  while (log2_width < 5 && (int64_t{1} << log2_width) < groups) ++log2_width;
  const int64_t warps = connectit::kThreads / 32;
  float* head = static_cast<float*>(scratch);
  float* tail = head + n_chunks * d;
  const int64_t tiles = (groups + (int64_t{1} << log2_width) - 1) >>
                        log2_width;
  int64_t blocks = (n_chunks * tiles + warps - 1) / warps;
  if (blocks > connectit::kMaxBlocks) blocks = connectit::kMaxBlocks;
  if (blocks > 0) {
    segment_pieces_kernel<T, V>
        <<<static_cast<unsigned>(blocks), connectit::kThreads, 0, st>>>(
            static_cast<const T*>(vals), static_cast<const int*>(order),
            static_cast<const int*>(offsets), static_cast<T*>(out), head,
            tail, rows, d, chunk, n_chunks, log2_width);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blocks = (rows * ((groups + 31) / 32) + warps - 1) / warps;
  if (blocks > connectit::kMaxBlocks) blocks = connectit::kMaxBlocks;
  segment_rows_kernel<T, V>
      <<<static_cast<unsigned>(blocks), connectit::kThreads, 0, st>>>(
          static_cast<const int*>(offsets), static_cast<T*>(out), head, tail,
          rows, d, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int segment_sum(const void* vals, const void* order, const void* offsets,
                void* out, void* scratch, int64_t rows, int64_t d,
                int64_t chunk, int64_t n_chunks, void* stream) {
  if (rows < 0 || d < 1 || chunk < 1 || (chunk & (chunk - 1)) != 0 ||
      n_chunks < 0 || !aligned(scratch, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  return launch<T, 16 / sizeof(T)>(vals, order, offsets, out, scratch, rows,
                                   d, chunk, n_chunks,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// scratch: 2 * n_chunks * d float32 (head rows, then tail rows), n_chunks
// = ceil(m / chunk) for m = order's length.
extern "C" int segment_sum_f32(const void* vals, const void* order, const void* offsets, void* out, void* scratch, int64_t rows, int64_t d, int64_t chunk, int64_t n_chunks, void* stream) {
  return segment_sum<float>(vals, order, offsets, out, scratch, rows, d,
                            chunk, n_chunks, stream);
}

extern "C" int segment_sum_bf16(const void* vals, const void* order, const void* offsets, void* out, void* scratch, int64_t rows, int64_t d, int64_t chunk, int64_t n_chunks, void* stream) {
  return segment_sum<__nv_bfloat16>(vals, order, offsets, out, scratch, rows,
                                    d, chunk, n_chunks, stream);
}
