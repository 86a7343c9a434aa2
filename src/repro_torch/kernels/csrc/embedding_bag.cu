// embedding_bag: for T tables at once, out[t, b] = reduce over l of
// tables[t][id(idx[t, b, l])], by sum, mean or max, for float32 and
// bfloat16 tables; and the float32 gradients of those bags (the backward,
// below).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/legacy/embedding_bag/kernel.py (embedding_bag /
// _embedding_bag_kernel), one table a call. The TPU kernel holds the whole
// (rows, D) table as one VMEM-resident block and gathers from it; at
// DLRM-RM2 width a table is 1,000,448 x 64 float32 = 256 MB, which no
// on-chip memory holds. Here the tables stay in device memory and the
// gathered rows come through L2.
//
// One launch takes T <= kMaxTables tables of one D and one dtype (their
// rows may differ), passed by value in BagTables as the backward's are,
// their ids as one contiguous (T, B, L) int32 tensor, and writes one (T, B,
// D) output: DLRM's 26 bags of a step are one launch, where a launch a
// table cost the host ~0.04 ms each.
//
// Layout: a group of G lanes (a power of two, at most a warp) covers a row,
// G just large enough that its lanes cover D with one vector of at most 16
// bytes each (a D = 64 float32 row: 16 lanes x 16 bytes; bfloat16: 8
// lanes). A group takes a tile of NB consecutive bags of one table: it
// reads the ids of U positions of each bag at once, issues all NB x U row
// loads, then adds them in l order. A bag of L <= kMaxRun positions is one
// pass, U = L rounded up to a power of two and NB = kInFlight / U, so a
// one-hot bag (RM2, L = 1) shares the flight with 3 other bags; a longer
// bag is a tile of its own, kMaxRun positions a pass with a run-time tail.
// Rows wider than G vectors are covered by an outer loop over column
// chunks. Tiles are numbered table-major, and blocks start in that order,
// so the blocks resident at once read one or two tables, whose zipfian
// heads stay in L2 while their bags run.
//
// The flight is small on purpose: the SM hides the row latency with warps,
// and each load in flight costs registers, so warps. On the recorded
// DLRM-RM2 calls and 26 tables of multi-hot (L = 8) ids
// (compare_kernels.py --bags, H100), 8 rows a group in flight took
// 1.4-2.9x the time of 4 (NB = 4 at L = 1, 2 positions a pass) on the
// large one-hot calls as 8 bags, 3.3-7.9x on the multi-hot ones as all 8
// positions of a bag; 2 rows 1.00-1.08x. Bounds of 4 resident blocks an SM
// for the one-pass tiles and 6 for the passes beat 4 for both by 8-11% on
// the multi-hot calls, and no bound by 7-9% on the large one-hot ones.
// Interleaving the tables' tiles cost 13-31% on the large calls.
//
// The same bits as a launch a table: each bag accumulates in float32 in l
// order from 0 (sum, mean) or the dtype's lowest value (max), mean divides
// by max(#valid, 1) in float32, and the result is rounded once to the
// table's dtype. No atomics.
//
// Id contract (the reference's gather): a negative id wraps once
// (id + rows), then clamps into [0, rows - 1]; an id counts as valid for
// mean and max when the raw id is below rows - 1 (the dump row). mean
// divides the sum over all L rows by max(#valid, 1); max takes the dtype's
// lowest finite value where an id is not valid.
//
// Row windows (a rank's block of a table row-sharded over a mesh, see
// BagTables): rows counts the whole table's rows in the contract above; a
// row outside the window adds nothing to a sum bag, so the sum of the
// windows' bags over the ranks is the whole table's bag. At a window of the
// whole table every call gives the bits it gave before windows existed.
//
// Bound: bytes (each distinct row the bags read once, T*B*L ids and T*B*D
// outputs); the adds are 1 per gathered value.
#include <cuda_bf16.h>

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

enum Mode : int { kSum = 0, kMean = 1, kMax = 2 };

constexpr int kMaxTables = 64;  // tables a call takes (launch parameters)
constexpr int kInFlight = 4;  // row loads a forward group has in flight
constexpr int kMaxRun = 2;    // of them, positions of one bag at most

// Per-table arguments, passed by value with each launch: the forward reads
// table (of its dtype) and its window, the backward all of them.
//
// A table may be a window of rows of a larger one, as a rank of a mesh
// holds its block of a row-sharded table: it holds the rows_global-row
// table's rows [row_lo, row_lo + rows). An id's row is found in the whole
// table (wrapped once against rows_global, then clamped into it), and a
// row outside the window contributes nothing: the forward reads it as
// zeros (sum only; the wrapper refuses a window for mean and max), the
// backward gives its position no gradient row. A table that is whole has
// row_lo = 0 and rows_global = rows.
struct BagTables {
  const void* table[kMaxTables];      // (rows, D); the backward's float32
  const float* grad_out[kMaxTables];  // (B, D), rows go_stride apart
  int64_t go_stride[kMaxTables];
  int64_t rows[kMaxTables];           // the rows this table holds
  int64_t row_lo[kMaxTables];         // the first of them in the whole table
  int64_t rows_global[kMaxTables];    // the whole table's rows
  int64_t base[kMaxTables];           // the table's first flat row
};

// The row an id reads: wrapped once if negative, then clamped.
__device__ __forceinline__ int64_t bag_row(int raw, int64_t rows) {
  const int64_t r = raw < 0 ? raw + rows : static_cast<int64_t>(raw);
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// The row of table t that an id reads, counted from the window's first
// row: in [0, rows[t]) where the id's row lies in the window.
__device__ __forceinline__ int64_t window_row(const BagTables& tabs, int t,
                                              int raw) {
  return bag_row(raw, tabs.rows_global[t]) - tabs.row_lo[t];
}

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

// One vector of a table row, through the read-only path.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_row(const T* p) {
  constexpr int bytes = sizeof(Vec<T, VEC>);
  Vec<T, VEC> x;
  if constexpr (bytes == 16) {
    *reinterpret_cast<uint4*>(&x) = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (bytes == 8) {
    *reinterpret_cast<uint2*>(&x) = __ldg(reinterpret_cast<const uint2*>(p));
  } else if constexpr (bytes == 4) {
    *reinterpret_cast<unsigned*>(&x) =
        __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    *reinterpret_cast<unsigned short*>(&x) =
        __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return x;
}

// The ids and rows of positions [l0, l0 + n) of bags j < nb (n <= U), bag
// j's ids from ids + j * L: every id load first, then every row load, so
// that all of them are in flight at once.
//
// A row outside the table's window reads as zeros, which leave a sum's
// bits as they are: it starts at +0 and, rounding to nearest, never holds
// -0, so adding +0 changes nothing.
template <typename T, int VEC, int NB, int U>
__device__ __forceinline__ void load_rows(const T* table, int64_t rows,
                                          int64_t rows_global, int64_t row_lo,
                                          const int* ids, int64_t L,
                                          int64_t D, int64_t c0, int nb,
                                          int64_t l0, int n,
                                          int (&raw)[NB][U],
                                          Vec<T, VEC> (&x)[NB][U]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      raw[j][u] = j < nb && u < n ? __ldg(ids + j * L + l0 + u) : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j < nb && u < n) {
        const int64_t r = bag_row(raw[j][u], rows_global) - row_lo;
        if (r >= 0 && r < rows) {
          x[j][u] = load_row<T, VEC>(table + r * D + c0);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) x[j][u].v[k] = from_float<T>(0.0f);
        }
      }
    }
  }
}

// One bag's loaded positions u < n into acc, in l order: added (sum,
// mean), or max-ed where the id is valid (below the whole table's dump
// row, rows - 1); n_valid counts the valid ids.
template <typename T, int VEC, int U>
__device__ __forceinline__ void add_rows(float (&acc)[VEC], int& n_valid,
                                         const int (&raw)[U],
                                         const Vec<T, VEC> (&x)[U], int n,
                                         int64_t rows, int mode) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u >= n) break;
    const bool valid = static_cast<int64_t>(raw[u]) < rows - 1;
    n_valid += valid;
    if (mode == kMax) {
      if (valid) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          acc[k] = fmaxf(acc[k], to_float(x[u].v[k]));
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_float(x[u].v[k]);
    }
  }
}

// mean's divide, then one rounding to the table's dtype and one store.
template <typename T, int VEC>
__device__ __forceinline__ void store_bag(T* dst, float (&acc)[VEC],
                                          int n_valid, int mode) {
  if (mode == kMean) {
    const float cnt = static_cast<float>(n_valid > 0 ? n_valid : 1);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] /= cnt;
  }
  Vec<T, VEC> y;
#pragma unroll
  for (int k = 0; k < VEC; ++k) y.v[k] = from_float<T>(acc[k]);
  *reinterpret_cast<Vec<T, VEC>*>(dst) = y;
}

// Group g of the grid takes tiles g, g + groups, ...; tile i is bags
// [b0, b0 + NB) of table i / tiles_per_table. Each lane covers columns
// c0 .. c0 + VEC - 1 of every column chunk. NB > 1 only where L <= U: the
// tile's bags are one pass of loads, and each bag's sum lives only from its
// adds to its store; a bag longer than U (NB = 1) takes passes of U. At
// most 64 registers a thread for the one-pass tiles (4 blocks an SM), 40
// for the passes (6).
template <typename T, int VEC, int NB, int U>
__global__ void __launch_bounds__(connectit::kThreads, NB > 1 ? 4 : 6)
    embedding_bags_kernel(const BagTables tabs, const int* __restrict__ idx,
                          T* __restrict__ out, int64_t B, int64_t L,
                          int64_t D, int64_t tiles_per_table, int64_t tiles,
                          int mode, int log2_group) {
  const int64_t group = int64_t{1} << log2_group;
  const int64_t lane = threadIdx.x & (group - 1);
  const int64_t groups = static_cast<int64_t>(blockDim.x) >> log2_group;
  const float init = mode == kMax ? lowest<T>() : 0.0f;
  for (int64_t tile = blockIdx.x * groups + (threadIdx.x >> log2_group);
       tile < tiles; tile += gridDim.x * groups) {
    const int64_t t = tile / tiles_per_table;
    const int64_t b0 = (tile - t * tiles_per_table) * NB;
    const int nb = B - b0 < NB ? static_cast<int>(B - b0) : NB;
    const T* table = static_cast<const T*>(tabs.table[t]);
    const int64_t rows = tabs.rows[t];
    const int64_t rows_global = tabs.rows_global[t];
    const int64_t row_lo = tabs.row_lo[t];
    const int* ids = idx + (t * B + b0) * L;
    T* dst = out + (t * B + b0) * D;
    for (int64_t c0 = lane * VEC; c0 < D; c0 += group * VEC) {
      int raw[NB][U];
      Vec<T, VEC> x[NB][U];
      if constexpr (NB == 1) {
        float acc[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = init;
        int n_valid = 0;
        for (int64_t l0 = 0; l0 < L; l0 += U) {
          const int n = L - l0 < U ? static_cast<int>(L - l0) : U;
          load_rows<T, VEC, NB, U>(table, rows, rows_global, row_lo, ids, L,
                                   D, c0, nb, l0, n, raw, x);
          add_rows<T, VEC, U>(acc, n_valid, raw[0], x[0], n, rows_global,
                              mode);
        }
        store_bag<T, VEC>(dst + c0, acc, n_valid, mode);
      } else {
        const int n = static_cast<int>(L);
        load_rows<T, VEC, NB, U>(table, rows, rows_global, row_lo, ids, L, D,
                                 c0, nb, 0, n, raw, x);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (j >= nb) break;
          float acc[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = init;
          int n_valid = 0;
          add_rows<T, VEC, U>(acc, n_valid, raw[j], x[j], n, rows_global,
                              mode);
          store_bag<T, VEC>(dst + j * D + c0, acc, n_valid, mode);
        }
      }
    }
  }
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// The launch arguments of one call: its tables from the host arrays the
// wrapper passes (T device pointers of tables and, for the backward, of
// grad_outs and T strides; T row counts, and each table's window: its
// first row and the whole table's rows), and their total rows.
int bag_tables(BagTables* tabs, int64_t* total_rows, const void* tables,
               const void* grad_outs, const void* go_strides,
               const void* rows, const void* row_lo, const void* rows_global,
               int64_t T) {
  if (T < 1 || T > kMaxTables) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* tp = static_cast<const int64_t*>(tables);
  const int64_t* gp = static_cast<const int64_t*>(grad_outs);
  const int64_t* sp = static_cast<const int64_t*>(go_strides);
  const int64_t* rp = static_cast<const int64_t*>(rows);
  const int64_t* lp = static_cast<const int64_t*>(row_lo);
  const int64_t* wp = static_cast<const int64_t*>(rows_global);
  *tabs = BagTables{};
  int64_t base = 0;
  for (int64_t t = 0; t < T; ++t) {
    if (rp[t] < 1 || lp[t] < 0 || wp[t] < lp[t] + rp[t]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tabs->table[t] = reinterpret_cast<const void*>(tp[t]);
    if (gp != nullptr) {
      tabs->grad_out[t] = reinterpret_cast<const float*>(gp[t]);
      tabs->go_stride[t] = sp[t];
    }
    tabs->rows[t] = rp[t];
    tabs->row_lo[t] = lp[t];
    tabs->rows_global[t] = wp[t];
    tabs->base[t] = base;
    base += rp[t];
  }
  *total_rows = base;
  return 0;
}

// NB bags a tile, U positions a bag in flight.
template <typename T, int VEC, int NB, int U>
int launch_tiles(const BagTables& tabs, int64_t n_tables, const void* idx,
                 void* out, int64_t B, int64_t L, int64_t D, int mode,
                 cudaStream_t st) {
  const int64_t vectors = D / VEC;
  int log2_group = 0;
  while (log2_group < 5 && (int64_t{1} << log2_group) < vectors) ++log2_group;
  const int64_t groups = connectit::kThreads >> log2_group;
  const int64_t tiles_per_table = (B + NB - 1) / NB;
  const int64_t tiles = n_tables * tiles_per_table;
  int64_t blocks = (tiles + groups - 1) / groups;
  if (blocks > connectit::kMaxBlocks) blocks = connectit::kMaxBlocks;
  embedding_bags_kernel<T, VEC, NB, U>
      <<<static_cast<unsigned>(blocks), connectit::kThreads, 0, st>>>(
          tabs, static_cast<const int*>(idx), static_cast<T*>(out), B, L, D,
          tiles_per_table, tiles, mode, log2_group);
  return static_cast<int>(cudaGetLastError());
}

// The bags a tile of bags of U <= kMaxRun positions takes in one pass.
constexpr int bags_for(int u) { return u < kInFlight ? kInFlight / u : 1; }

// Launch with the widest vector of at most 16 bytes that divides D and
// keeps every row of every table and of the output aligned. A bag of L <=
// kMaxRun positions is one pass (U the least power of two >= L, NB =
// kInFlight / U bags a tile); a longer one passes of kMaxRun, a bag a tile.
template <typename T, int VEC>
int launch_bags(const BagTables& tabs, int64_t n_tables, const void* idx,
                void* out, int64_t B, int64_t L, int64_t D, int mode,
                cudaStream_t st) {
  if constexpr (VEC > 1) {
    bool ok = D % VEC == 0 && aligned(out, sizeof(T) * VEC);
    for (int64_t t = 0; ok && t < n_tables; ++t) {
      ok = aligned(tabs.table[t], sizeof(T) * VEC);
    }
    if (!ok) {
      return launch_bags<T, VEC / 2>(tabs, n_tables, idx, out, B, L, D, mode,
                                     st);
    }
  }
  if (L <= 1) {
    return launch_tiles<T, VEC, bags_for(1), 1>(tabs, n_tables, idx, out, B,
                                                L, D, mode, st);
  }
  if constexpr (kMaxRun >= 2) {
    if (L <= 2) {
      return launch_tiles<T, VEC, bags_for(2), 2>(tabs, n_tables, idx, out,
                                                  B, L, D, mode, st);
    }
  }
  if constexpr (kMaxRun >= 4) {
    if (L <= 4) {
      return launch_tiles<T, VEC, bags_for(4), 4>(tabs, n_tables, idx, out,
                                                  B, L, D, mode, st);
    }
  }
  if constexpr (kMaxRun >= 8) {
    if (L <= 8) {
      return launch_tiles<T, VEC, bags_for(8), 8>(tabs, n_tables, idx, out,
                                                  B, L, D, mode, st);
    }
  }
  return launch_tiles<T, VEC, 1, kMaxRun>(tabs, n_tables, idx, out, B, L, D,
                                          mode, st);
}

template <typename T>
int embedding_bags(const void* tables, const void* rows, const void* row_lo,
                   const void* rows_global, int64_t n_tables,
                   const void* idx, void* out, int64_t B, int64_t L,
                   int64_t D, int mode, void* stream) {
  if (mode < kSum || mode > kMax || B < 0 || L < 0 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BagTables tabs;
  int64_t total_rows = 0;
  const int rc = bag_tables(&tabs, &total_rows, tables, nullptr, nullptr,
                            rows, row_lo, rows_global, n_tables);
  if (rc != 0 || B == 0) return rc;
  return launch_bags<T, 16 / sizeof(T)>(tabs, n_tables, idx, out, B, L, D,
                                        mode,
                                        static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Backward: the float32 gradients of T bags at once, one per table.
//
// Replaces no TPU kernel: the JAX package's gradient is XLA's transpose of
// the gather, a scatter-add (src/repro/kernels/legacy/embedding_bag/ref.py).
// Added so that DLRM trains on the card.
//
// For table t, grad_t[r] = sum over the positions p = (t * B + b) * L + l
// that read row r of
//   sum:  grad_out_t[b]
//   mean: grad_out_t[b] / max(#valid ids of bag (t, b), 1)
//   max:  grad_out_t[b] / (#ties of the bag's max on that column), where
//         the position's id is valid and its row equals the max there
// with rows read through the forward's id contract (wrap once, clamp). The
// T gradients are one flat (sum of rows_t, D) buffer, table after table. A
// table that is a window of rows (BagTables) gets the gradient of its rows
// alone: a position whose row lies outside the window takes the sentinel
// key total_rows, which sorts after every row, and passes nothing.
//
// Bound: bytes. Every gradient written once, zeros included (rows_t * D
// floats each), the ids and grad_out read once, and for max the table rows
// the bags read. On DLRM-RM2's train step the 26 gradients of 256 MB each
// are ~97% of those bytes.
//
// Design. A backward per table cost a memset of its gradient, a sort and
// three launches, and the device waited on the host between these small
// steps (~230 of them in a train step). Here one call takes all T tables:
//   keys (launch 1): each position's flat gradient row (its table's first
//     row + its clamped row); for mean each bag's valid count, once; for
//     max each position's share of each column (contrib);
//   a stable library sort of the keys (it orders the work and adds
//     nothing): one ordering of all T * B * L positions by (table, row),
//     ties in position order;
//   mark (launch 2): a bit a flat row in `touched`, set for the rows the
//     sorted keys hold (a warp's 32 neighbouring keys share a few words:
//     one atomic a word);
//   rows (launch 3), which writes every gradient row exactly once, so that
//     nothing zeroes the gradient first:
//     - its first blocks sum: warp c takes the kChunk sorted positions from
//       c * kChunk and walks them in order, one position at a time across
//       its lanes (columns) with kHoist loads in flight; a run of one row
//       that ends in the chunk is written there. Splitting the sums by
//       positions, not rows, keeps a zipfian head off one block: a
//       table's first 1,024 rows hold ~40% of its positions;
//     - a run that crosses chunks (a hub row: RecsysStream's row 0 is read
//       by ~5% of the bags) leaves a partial in each of its chunks; the
//       last of them to arrive (a counter a run) adds the partials in chunk
//       order and writes the row, in the same launch;
//     - its other blocks, as many as fit on the card at once, take slices
//       of kSliceRows rows from a counter until none is left, and write
//       zeros (16-byte evict-first stores) to the rows whose bit is clear.
//       The bits come from the sorted keys, whose neighbours share words:
//       from the unsorted keys they are scattered writes.
// Every float add happens in an order fixed by the data and the constants
// below, so a call gives the same bits on every run; no atomic adds touch
// a float.

constexpr int kWarp = 32;
constexpr int kWarps = connectit::kThreads / kWarp;
constexpr int kChunk = 128;      // sorted positions a warp sums
constexpr int kHoist = 8;        // value loads a warp keeps in flight
constexpr int kSliceRows = 512;  // gradient rows a zeroing block takes

// keys[p] = the flat row position p reads (total_rows where the row lies
// outside its table's window); for mean, count[t * B + b] = max(#valid ids,
// 1); for max, contrib[p, :] = the gradient that position p passes to its
// row (0 where it is not a max). mean and max take whole tables.
template <typename K>
__global__ void bag_backward_keys(const BagTables tabs,
                                  const int* __restrict__ idx,
                                  K* __restrict__ keys,
                                  float* __restrict__ count,
                                  float* __restrict__ contrib, int64_t T,
                                  int64_t B, int64_t L, int64_t D, int mode,
                                  int64_t total_rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t bags = T * B;
  for (int64_t p = first; p < bags * L; p += stride) {
    // p < 2^31 (the wrapper's limit): 32-bit divisions
    const uint32_t t = static_cast<uint32_t>(p) / static_cast<uint32_t>(L) /
                       static_cast<uint32_t>(B);
    const int64_t r = window_row(tabs, t, idx[p]);
    keys[p] = static_cast<K>(r >= 0 && r < tabs.rows[t] ? tabs.base[t] + r
                                                        : total_rows);
  }
  if (mode == kMean) {
    for (int64_t tb = first; tb < bags; tb += stride) {
      const int64_t rows = tabs.rows_global[tb / B];
      int64_t n_valid = 0;
      for (int64_t l = 0; l < L; ++l) {
        n_valid += static_cast<int64_t>(idx[tb * L + l]) < rows - 1;
      }
      count[tb] = static_cast<float>(n_valid > 0 ? n_valid : 1);
    }
  }
  if (mode != kMax) return;
  // one thread per (bag, column): the masked max over L, its ties, and each
  // position's share
  const float neg = -FLT_MAX;
  for (int64_t x = first; x < bags * D; x += stride) {
    const int64_t tb = x / D, c = x % D, t = tb / B, b = tb % B;
    const int64_t rows = tabs.rows[t];
    const float* table = static_cast<const float*>(tabs.table[t]);
    const int* ids = idx + tb * L;
    float mx = neg;
    for (int64_t l = 0; l < L; ++l) {
      const bool valid = static_cast<int64_t>(ids[l]) < rows - 1;
      mx = fmaxf(mx, valid ? table[bag_row(ids[l], rows) * D + c] : neg);
    }
    int ties = 0;
    for (int64_t l = 0; l < L; ++l) {
      const bool valid = static_cast<int64_t>(ids[l]) < rows - 1;
      ties += (valid ? table[bag_row(ids[l], rows) * D + c] : neg) == mx;
    }
    const float share =
        tabs.grad_out[t][b * tabs.go_stride[t] + c] / static_cast<float>(ties);
    for (int64_t l = 0; l < L; ++l) {
      const bool valid = static_cast<int64_t>(ids[l]) < rows - 1;
      const float v = valid ? table[bag_row(ids[l], rows) * D + c] : neg;
      contrib[(tb * L + l) * D + c] = valid && v == mx ? share : 0.0f;
    }
  }
}

// touched: a bit a flat row, set for the rows the sorted keys hold (not
// the sentinel total_rows). A warp's 32 keys are neighbours, so their bits
// fall in few words: the lanes of one word set it with one atomic.
template <typename K>
__global__ void bag_backward_mark(const K* __restrict__ sorted, int64_t N,
                                  int64_t total_rows,
                                  unsigned* __restrict__ touched) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x % kWarp;
  // every lane of a warp runs the loop's trip count
  for (int64_t i0 = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x - lane;
       i0 < N; i0 += stride) {
    const int64_t i = i0 + lane;
    // the first position of each run of one row (-1 elsewhere)
    const int64_t key = i < N && (i == 0 || sorted[i - 1] != sorted[i]) &&
                                static_cast<int64_t>(sorted[i]) < total_rows
                            ? static_cast<int64_t>(sorted[i])
                            : -1;
    const unsigned same = __match_any_sync(~0u, key >> 5);
    const unsigned bits = __reduce_or_sync(same, 1u << (key & 31));
    if (key >= 0 && lane == __ffs(same) - 1) atomicOr(touched + (key >> 5), bits);
  }
}

// The first index of the sorted a[0, n) whose key is >= x, by one warp:
// 32 probes a step, ~5 dependent loads for 2^21 keys.
template <typename K>
__device__ int64_t warp_lower_bound(const K* __restrict__ a, int64_t n, K x,
                                    int lane) {
  int64_t lo = 0, hi = n;  // the answer is in [lo, hi]
  while (hi - lo > kWarp) {
    const int64_t step = (hi - lo + kWarp - 1) / kWarp;
    const int64_t q = lo + (lane + 1) * step - 1;
    const unsigned m = __ballot_sync(~0u, q >= hi || a[q] >= x);
    if (m == 0) return hi;
    const int f = __ffs(m) - 1;
    const int64_t qf = lo + (f + 1) * step - 1;
    lo += f * step;  // a[lo - 1] < x
    hi = qf < hi ? qf : hi;
  }
  const int64_t q = lo + lane;
  const unsigned m = __ballot_sync(~0u, q >= hi || a[q] >= x);
  return m ? lo + __ffs(m) - 1 : hi;
}

template <int VEC>
__device__ __forceinline__ void add_vec(float (&acc)[VEC],
                                        const Vec<float, VEC>& x) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] += x.v[k];
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  Vec<float, VEC> y;
#pragma unroll
  for (int k = 0; k < VEC; ++k) y.v[k] = v[k];
  *reinterpret_cast<Vec<float, VEC>*>(p) = y;
}

// The piece of a run that crossed chunks, just stored in its chunk's slot
// (side 0: the run went on from the chunk before; 1: it starts here): the
// piece arrives at the run's counter, and the last piece of the run to
// arrive adds all of them in chunk order into the row. head / tail: the
// run goes on before / after this chunk.
template <typename K, int VEC>
__device__ void arrive(const K* __restrict__ sorted,
                       int* __restrict__ arrivals,
                       const float* __restrict__ pieces,
                       float* __restrict__ grad, int64_t N, int64_t D, K k,
                       int64_t c, bool head, bool tail, int lane) {
  const int64_t c0 = c * kChunk;
  const int64_t c1 = c0 + kChunk < N ? c0 + kChunk : N;
  const int64_t cs = head ? warp_lower_bound(sorted, c0, k, lane) / kChunk
                          : c;
  const int64_t ce =
      tail ? (c1 + warp_lower_bound(sorted + c1, N - c1, k + 1, lane) - 1) /
                 kChunk
           : c;
  __threadfence();  // this warp's pieces, before its arrival
  __syncwarp();
  int before = 0;
  if (lane == 0) before = atomicAdd(&arrivals[cs], 1);
  before = __shfl_sync(~0u, before, 0);
  if (before != ce - cs) return;
  __threadfence();  // the other pieces, after their arrivals
  for (int64_t col = static_cast<int64_t>(lane) * VEC; col < D;
       col += kWarp * VEC) {
    float acc[VEC];
    const float* first = pieces + (cs * 2 + 1) * D + col;  // cs: side 1
#pragma unroll
    for (int k2 = 0; k2 < VEC; ++k2) acc[k2] = __ldcg(first + k2);
    for (int64_t q = cs + 1; q <= ce; ++q) {
      const float* p = pieces + q * 2 * D + col;  // the others: side 0
#pragma unroll
      for (int k2 = 0; k2 < VEC; ++k2) acc[k2] += __ldcg(p + k2);
    }
    store_vec<VEC>(grad + static_cast<int64_t>(k) * D + col, acc);
  }
}

// Warp c sums sorted positions [c * kChunk, (c + 1) * kChunk), one at a
// time in order, its lanes over columns col..col + VEC - 1 of each pass.
// The positions outside their windows (the sentinel key total_rows, sorted
// last) are left out: the chunk ends at the first of them.
template <typename K, int VEC>
__device__ void sum_chunk(const BagTables& tabs, const K* __restrict__ sorted,
                          const int64_t* __restrict__ perm,
                          const float* __restrict__ count,
                          const float* __restrict__ contrib,
                          int* __restrict__ arrivals,
                          float* __restrict__ pieces, float* __restrict__ grad,
                          int64_t N, int64_t B, int64_t L, int64_t D,
                          int mode, int64_t c, int lane, int64_t total_rows) {
  const int64_t c0 = c * kChunk;
  int64_t c1 = c0 + kChunk < N ? c0 + kChunk : N;
  const K sentinel = static_cast<K>(total_rows);
  if (sorted[c0] >= sentinel) return;
  if (sorted[c1 - 1] >= sentinel) {
    c1 = c0 + warp_lower_bound(sorted + c0, c1 - c0, sentinel, lane);
  }
  const bool head_open = c0 > 0 && sorted[c0 - 1] == sorted[c0];
  const bool tail_open = c1 < N && sorted[c1] == sorted[c1 - 1];
  const int64_t passes = (D + kWarp * VEC - 1) / (kWarp * VEC);
  for (int64_t pass = 0; pass < passes; ++pass) {
    const int64_t col = pass * kWarp * VEC + static_cast<int64_t>(lane) * VEC;
    const bool col_ok = col < D;
    float acc[VEC] = {};
    bool in_head = head_open;  // the run under way went on before c0
    for (int64_t base = c0; base < c1; base += kWarp) {
      const int n = c1 - base < kWarp ? static_cast<int>(c1 - base) : kWarp;
      // each lane decodes one position of the batch: its row, where its
      // values are, and whether its run ends with it
      const int64_t i = base + lane;
      K key = 0;
      unsigned long long src = 0;
      float div = 1.0f;
      if (lane < n) {
        key = sorted[i];
        const int64_t p = perm[i];
        if (mode == kMax) {
          src = reinterpret_cast<uintptr_t>(contrib + p * D);
        } else {  // p < 2^31 (the wrapper's limit): 32-bit divisions
          const uint32_t tb =
              static_cast<uint32_t>(p) / static_cast<uint32_t>(L);
          const uint32_t t = tb / static_cast<uint32_t>(B);
          src = reinterpret_cast<uintptr_t>(
              tabs.grad_out[t] + (tb - t * static_cast<uint32_t>(B)) *
                                     tabs.go_stride[t]);
          if (mode == kMean) div = count[tb];
        }
      }
      K next = __shfl_down_sync(~0u, key, 1);
      if (lane == n - 1 && i + 1 < c1) next = sorted[i + 1];
      const unsigned ends =
          __ballot_sync(~0u, lane < n && (i + 1 == c1 || next != key));
      for (int j0 = 0; j0 < n; j0 += kHoist) {
        Vec<float, VEC> v[kHoist];
        float d[kHoist];
#pragma unroll
        for (int u = 0; u < kHoist; ++u) {
          const int j = (j0 + u) & (kWarp - 1);
          const unsigned long long s = __shfl_sync(~0u, src, j);
          d[u] = __shfl_sync(~0u, div, j);
          if (j0 + u < n && col_ok) {
            v[u] = *reinterpret_cast<const Vec<float, VEC>*>(
                reinterpret_cast<const float*>(s) + col);
          }
        }
#pragma unroll
        for (int u = 0; u < kHoist; ++u) {
          const int j = j0 + u;
          if (j >= n) break;
          if (col_ok) {
            if (mode == kMean) {
#pragma unroll
              for (int k2 = 0; k2 < VEC; ++k2) v[u].v[k2] /= d[u];
            }
            add_vec<VEC>(acc, v[u]);
          }
          if (((ends >> j) & 1) == 0) continue;
          // a run ends with position base + j
          const K k = __shfl_sync(~0u, key, j);
          const bool tail = tail_open && base + j + 1 == c1;
          if (in_head || tail) {  // a piece of a run that crosses chunks
            if (col_ok) {
              store_vec<VEC>(pieces + (c * 2 + (in_head ? 0 : 1)) * D + col,
                             acc);
            }
            if (pass == passes - 1) {
              arrive<K, VEC>(sorted, arrivals, pieces, grad, N, D, k, c,
                             in_head, tail, lane);
            }
          } else if (col_ok) {
            store_vec<VEC>(grad + static_cast<int64_t>(k) * D + col, acc);
          }
#pragma unroll
          for (int k2 = 0; k2 < VEC; ++k2) acc[k2] = 0.0f;
          in_head = false;
        }
      }
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_zero(float* p) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(0.f, 0.f, 0.f, 0.f));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(0.f, 0.f));
  } else {
    __stcs(p, 0.0f);
  }
}

// Zeros in the rows [r0, r1) that no position reads (their bit in
// touched clear), a group of lanes a row.
template <int VEC>
__device__ void zero_rows(const unsigned* __restrict__ touched,
                          float* __restrict__ grad, int64_t r0, int64_t r1,
                          int64_t D) {
  int log2_group = 0;
  while (log2_group < 5 && (int64_t{VEC} << log2_group) < D) ++log2_group;
  const int group = 1 << log2_group;
  const int64_t glane = threadIdx.x & (group - 1);
  for (int64_t r = r0 + (threadIdx.x >> log2_group); r < r1;
       r += blockDim.x >> log2_group) {
    if ((touched[r >> 5] >> (r & 31)) & 1) continue;
    float* row = grad + r * D;
    for (int64_t c = glane * VEC; c < D; c += group * VEC) {
      store_zero<VEC>(row + c);
    }
  }
}

// Blocks [0, sum_blocks): the sums, kWarps chunks a block; the others:
// zeros, kSliceRows rows at a time from the counter next_slice. No block
// waits on another.
template <typename K, int VEC>
__global__ void __launch_bounds__(connectit::kThreads)
    bag_backward_rows(const BagTables tabs, const K* __restrict__ sorted,
                      const int64_t* __restrict__ perm,
                      const float* __restrict__ count,
                      const float* __restrict__ contrib,
                      const unsigned* __restrict__ touched,
                      int* __restrict__ next_slice,
                      int* __restrict__ arrivals, float* __restrict__ pieces,
                      float* __restrict__ grad, int64_t total_rows,
                      int64_t N, int64_t B, int64_t L, int64_t D, int mode,
                      int64_t sum_blocks) {
  if (blockIdx.x < sum_blocks) {
    const int64_t c =
        static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
    if (c * kChunk < N) {
      sum_chunk<K, VEC>(tabs, sorted, perm, count, contrib, arrivals, pieces,
                        grad, N, B, L, D, mode, c, threadIdx.x % kWarp,
                        total_rows);
    }
    return;
  }
  __shared__ int slice;
  const int64_t slices = (total_rows + kSliceRows - 1) / kSliceRows;
  for (;;) {
    if (threadIdx.x == 0) slice = atomicAdd(next_slice, 1);
    __syncthreads();
    const int64_t r0 = static_cast<int64_t>(slice) * kSliceRows;
    __syncthreads();  // every thread has read slice before the next one
    if (r0 >= slices * kSliceRows) return;
    const int64_t r1 = r0 + kSliceRows < total_rows ? r0 + kSliceRows
                                                    : total_rows;
    if (D % 4 == 0) {
      zero_rows<4>(touched, grad, r0, r1, D);
    } else if (D % 2 == 0) {
      zero_rows<2>(touched, grad, r0, r1, D);
    } else {
      zero_rows<1>(touched, grad, r0, r1, D);
    }
  }
}

// The zeroing blocks of a launch: as many as fit on the card at once.
template <typename K, int VEC>
int64_t zeroing_blocks(int64_t slices) {
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bag_backward_rows<K, VEC>, connectit::kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t fit = static_cast<int64_t>(sms) * per_sm;
  return slices < fit ? slices : fit;
}

bool bad_args(int mode, int key_bytes, int64_t B, int64_t L, int64_t D) {
  return mode < kSum || mode > kMax || (key_bytes != 4 && key_bytes != 8) ||
         B < 0 || L < 0 || D < 1;
}

// The columns a lane sums at once: the narrowest of 1, 2, 4 floats whose
// warp-wide pass covers D, else 4; each one dividing D and keeping every
// source row (grad_out, or contrib for max) aligned.
int sum_vec(const BagTables& tabs, int64_t T, const void* contrib,
            int64_t D, int mode) {
  int best = 0;
  for (int vec = 4; vec >= 1; vec /= 2) {
    bool ok = D % vec == 0 &&
              (mode != kMax || aligned(contrib, sizeof(float) * vec));
    for (int64_t t = 0; ok && t < T && mode != kMax; ++t) {
      ok = aligned(tabs.grad_out[t], sizeof(float) * vec) &&
           tabs.go_stride[t] % vec == 0;
    }
    if (ok && (best == 0 || kWarp * vec >= D)) best = vec;
  }
  return best;
}

template <typename K, int VEC>
int launch_rows(const BagTables& tabs, const void* sorted, const void* perm,
                const void* count, const void* contrib, void* counters,
                void* pieces, void* grad, int64_t total_rows, int64_t N,
                int64_t B, int64_t L, int64_t D, int mode, cudaStream_t st) {
  // counters: the slice counter, a counter a chunk, then touched
  const int64_t chunks = (N + kChunk - 1) / kChunk;
  int* next_slice = static_cast<int*>(counters);
  unsigned* touched = reinterpret_cast<unsigned*>(next_slice + 1 + chunks);
  if (N > 0) {
    bag_backward_mark<K><<<connectit::grid_for(N), connectit::kThreads, 0,
                           st>>>(static_cast<const K*>(sorted), N, total_rows,
                                 touched);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t sum_blocks = (chunks + kWarps - 1) / kWarps;
  const int64_t blocks = sum_blocks + zeroing_blocks<K, VEC>(
                                          (total_rows + kSliceRows - 1) /
                                          kSliceRows);
  bag_backward_rows<K, VEC>
      <<<static_cast<unsigned>(blocks), connectit::kThreads, 0, st>>>(
          tabs, static_cast<const K*>(sorted),
          static_cast<const int64_t*>(perm), static_cast<const float*>(count),
          static_cast<const float*>(contrib), touched, next_slice,
          next_slice + 1, static_cast<float*>(pieces),
          static_cast<float*>(grad), total_rows, N, B, L, D, mode,
          sum_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_rows(const BagTables& tabs, int64_t T, const void* sorted,
                const void* perm, const void* count, const void* contrib,
                void* counters, void* pieces, void* grad, int64_t total_rows,
                int64_t N, int64_t B, int64_t L, int64_t D, int mode,
                cudaStream_t st) {
  switch (sum_vec(tabs, T, contrib, D, mode)) {
    case 4:
      return launch_rows<K, 4>(tabs, sorted, perm, count, contrib, counters,
                               pieces, grad, total_rows, N, B, L, D, mode,
                               st);
    case 2:
      return launch_rows<K, 2>(tabs, sorted, perm, count, contrib, counters,
                               pieces, grad, total_rows, N, B, L, D, mode,
                               st);
    default:
      return launch_rows<K, 1>(tabs, sorted, perm, count, contrib, counters,
                               pieces, grad, total_rows, N, B, L, D, mode,
                               st);
  }
}

}  // namespace

// The forward of T tables. tables, rows, row_lo, rows_global: host arrays
// of T int64 (device pointers of the tables, of one dtype and D; their row
// counts; their windows, BagTables); idx (T, B, L) int32; out (T, B, D) of
// the tables' dtype.
extern "C" int embedding_bags_f32(const void* tables, const void* rows, const void* row_lo, const void* rows_global, int64_t T, const void* idx, void* out, int64_t B, int64_t L, int64_t D, int mode, void* stream) {
  return embedding_bags<float>(tables, rows, row_lo, rows_global, T, idx, out,
                               B, L, D, mode, stream);
}

extern "C" int embedding_bags_bf16(const void* tables, const void* rows, const void* row_lo, const void* rows_global, int64_t T, const void* idx, void* out, int64_t B, int64_t L, int64_t D, int mode, void* stream) {
  return embedding_bags<__nv_bfloat16>(tables, rows, row_lo, rows_global, T,
                                       idx, out, B, L, D, mode, stream);
}

// Launch 1 of the backward. tables, grad_outs: host arrays of T device
// pointers; go_strides, rows, row_lo, rows_global: host arrays of T int64;
// idx (T, B, L) int32; keys (T*B*L,) of key_bytes (4: int32, 8: int64);
// count (T*B,) float32 for mean; contrib (T*B*L, D) float32 for max.
// tables are read for max only.
extern "C" int embedding_bag_backward_keys_f32(const void* tables, const void* grad_outs, const void* go_strides, const void* rows, const void* row_lo, const void* rows_global, int64_t T, const void* idx, void* keys, int key_bytes, void* count, void* contrib, int64_t B, int64_t L, int64_t D, int mode, void* stream) {
  if (bad_args(mode, key_bytes, B, L, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BagTables tabs;
  int64_t total_rows = 0;
  const int rc = bag_tables(&tabs, &total_rows, tables, grad_outs, go_strides,
                            rows, row_lo, rows_global, T);
  if (rc != 0) return rc;
  int64_t work = T * B * L;
  if (mode == kMax && T * B * D > work) work = T * B * D;
  if (work == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4) {
    bag_backward_keys<int><<<connectit::grid_for(work), connectit::kThreads,
                             0, st>>>(
        tabs, static_cast<const int*>(idx), static_cast<int*>(keys),
        static_cast<float*>(count), static_cast<float*>(contrib), T, B, L, D,
        mode, total_rows);
  } else {
    bag_backward_keys<int64_t><<<connectit::grid_for(work),
                                 connectit::kThreads, 0, st>>>(
        tabs, static_cast<const int*>(idx), static_cast<int64_t*>(keys),
        static_cast<float*>(count), static_cast<float*>(contrib), T, B, L, D,
        mode, total_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches 2 and 3: sorted, perm (int64) the stable sort of launch 1's N
// keys; counters (1 + ceil(N / 128) + ceil(sum of rows / 32),) int32
// zeroed; pieces (2 * ceil(N / 128), D) float32 scratch; grad the flat (sum
// of rows, D) float32 gradient, 16-byte aligned, written whole.
extern "C" int embedding_bag_backward_f32(const void* tables, const void* grad_outs, const void* go_strides, const void* rows, const void* row_lo, const void* rows_global, int64_t T, const void* sorted, int key_bytes, const void* perm, void* counters, void* pieces, const void* count, const void* contrib, void* grad, int64_t N, int64_t B, int64_t L, int64_t D, int mode, void* stream) {
  if (bad_args(mode, key_bytes, B, L, D) || N != T * B * L ||
      N > INT32_MAX || !aligned(grad, 16) || !aligned(pieces, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BagTables tabs;
  int64_t total_rows = 0;
  const int rc = bag_tables(&tabs, &total_rows, tables, grad_outs, go_strides,
                            rows, row_lo, rows_global, T);
  if (rc != 0) return rc;
  if (key_bytes == 4 && total_rows > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return key_bytes == 4
             ? launch_rows<int>(tabs, T, sorted, perm, count, contrib,
                                counters, pieces, grad, total_rows, N, B, L,
                                D, mode, st)
             : launch_rows<int64_t>(tabs, T, sorted, perm, count, contrib,
                                    counters, pieces, grad, total_rows, N, B,
                                    L, D, mode, st);
}
