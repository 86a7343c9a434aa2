// segment_sum and gather_sum: sums over a sorted segment layout, for float32
// and bfloat16 values, each output row added in float32 in an order that
// the layout alone fixes and rounded once; an empty row is written as 0.
//
//   segment_sum: out[r, :] = sum of vals[order[k], :]
//   gather_sum:  out[r, :] = sum of x[ids[k], :] over the k with ids[k] >= 0
//
// over k in [offsets[r], offsets[r + 1]). For gather_sum, ids = idx[order]
// are the gathered ids in the layout's order, -1 where a position is masked
// (kernels/segments.py makes them once a layout and id array).
//
// Replaces no TPU kernel: the reference aggregates its GNN messages with
// jax.ops.segment_sum, which XLA lowers itself (src/repro/legacy/models/
// gnn.py, nequip.py). segment_sum was added so that a GNN train step gives
// the same bits on every run: the library's scatter-adds (index_add_,
// scatter_add_, the backward of indexing) add with atomics, in another order
// each run. Here the caller sorts the ids once (a stable sort, the same every
// run) and every sum is taken in an order fixed by the layout alone.
// gather_sum is GIN's aggregation, segment_sum(where(valid, h[senders], 0),
// receivers) (gnn.py:140-141), and its gradient, the same sum over the
// senders' layout gathering by receivers: it reads the gathered rows where
// they lie, so neither direction writes the (m, d) messages (at ogb_products
// 61,865,984 rows, 7.9-12.4 GB in bfloat16) that index_select and where
// wrote and the sum read back.
//
// Bound: bytes. A position costs its 4-byte id, read in sequence, and its
// gathered row, read at random (counted once a position, or x once where it
// stays in L2); the offsets are read once and each output row written once.
// The adds are one per value read, far below the card's float32 rate.
//
// Layout (kept from the kernel before it, so that a sum is the same bits
// as index_select + where + segment_sum on the same layout): the sorted
// positions [0, offsets[R]) are cut into chunks of `chunk` positions (a
// power of two, 32 to 256), a warp a chunk and tile of columns, so a hub
// row (the dump row takes every padded edge) spreads over many warps, and
// so do the columns of a wide row. The warp walks the rows its chunk meets
// (the first from first[c], made once a layout) and sums each row's
// positions inside the chunk. Its 32 lanes are 32 / W entry slots of W
// lanes, W the least power of two whose lanes cover the row with one V-wide
// vector each, at most 32 (V the widest of at most 16 bytes that divides
// the width; a wider row takes a warp per tile of 32 vectors): a slot takes
// every (32 / W)-th position, its lanes adjacent vectors of columns, and the
// slots' sums are folded by an xor butterfly (the same pairs in the same
// order on every run). A row wholly inside the chunk is written to out; the
// piece of a row that began in an earlier chunk goes to head[chunk], the
// piece of one that goes on past it to tail[chunk] (float32 scratch).
//
// What the design does for Hopper:
//   * A plan made once a layout (segment/kernel.py's SegmentPlan) keeps the
//     non-empty rows with their starts, the empty rows, each chunk's first
//     non-empty row and the rows that span chunks. A warp walks its chunk's
//     non-empty rows from a window of 31 starts held one a lane; the empty
//     rows are written by warps of their own, 32 rows each, in the same
//     launch; a second launch adds the pieces of the rows that span chunks
//     (a warp a row and 32 vectors of columns), so a call where no row spans
//     chunks is one launch. A small call allocates only its output.
//     (An arrival count a spanning row, whose last warp added the pieces in
//     the same launch, cost 18% on the ogb_products calls: its fences
//     stalled every warp.)
//   * Many gathered rows in flight. Hopper's TMA cannot gather rows. The
//     chunk's ids come into shared memory with one coalesced load a lane;
//     the rows then stream through a ring of kStages shared-memory stages
//     with cp.async (16 bytes a lane through L2; 8 or 4 where the width
//     allows no more), stage q holding positions q * slots .. q * slots +
//     slots - 1 of the chunk whatever rows they belong to, so the next
//     rows load while the warp adds the current ones; a round adds up to 4
//     positions a slot between two waits. kStages = 8 was chosen on the
//     calls recorded from the ogb_products GIN step (2/4/8/16 stages: 17.9/
//     14.0/12.3/13.1 ms on an H100 80GB HBM3 at 700 W); another depth is a
//     build of its own (kUnroll follows it). An odd bfloat16 width (2-byte
//     vectors, which cp.async does not take) goes through the same ring
//     with plain copies.
//   * Element offsets are 64-bit: an ogb_products layer's messages are
//     61,865,984 x 100 elements, past INT32_MAX.
//
// The order of every add is the earlier kernel's (the chunk, the slots,
// the xor fold, the pieces in chunk order), so gather_sum gives the same
// bits as index_select, where and segment_sum on the same layout.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = connectit::kThreads / 32;
// shared-memory stages of gathered rows a warp keeps in flight (a power of
// two), and the positions a slot a round adds between two waits, which the
// ring must hold with the stage the round starts in
constexpr int kStages = 8;
constexpr int kUnroll = kStages >= 8 ? 4 : kStages / 2;
static_assert(kStages >= 2 && (kStages & (kStages - 1)) == 0 &&
                  kStages >= kUnroll + 1,
              "kStages: a power of two that holds a round and its stage");

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
__device__ __forceinline__ void store_vec(T* p, const float (&acc)[V]) {
  Vec<T, V> y;
#pragma unroll
  for (int i = 0; i < V; ++i) y.v[i] = from_float<T>(acc[i]);
  *reinterpret_cast<Vec<T, V>*>(p) = y;
}

// One vector from device memory into shared memory, not waited for:
// cp.async takes 4, 8 or 16 bytes (16 through L2 only, so a gathered row
// does not evict the L1 lines of the offsets); a 2-byte vector is a plain
// load and store.
template <int Bytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (Bytes == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else if constexpr (Bytes == 8 || Bytes == 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(Bytes)
                 : "memory");
  } else {
    static_assert(Bytes == 2, "a vector is 2, 4, 8 or 16 bytes");
    *static_cast<unsigned short*>(dst) =
        __ldg(static_cast<const unsigned short*>(src));
  }
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 to N) of this lane's latest copy groups
// are in flight: the count is an immediate of the instruction.
template <int N>
__device__ __forceinline__ void wait_async(int pending) {
  if constexpr (N == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (pending >= N) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  } else {
    wait_async<N - 1>(pending);
  }
}

// A layout's part of a call, made once by the caller (segment/kernel.py's
// SegmentPlan) and passed by address: the non-empty rows in order with
// their starts, the empty rows, each chunk's first non-empty row, the rows
// that span chunks and the scratch.
struct Layout {
  const int* coff;   // (n_nz + 1,) the non-empty rows' starts, then the total
  const int* nz;     // (n_nz,) the non-empty rows, ascending
  const int* first;  // (n_chunks,) the non-empty row holding a chunk's start
  const int* empty;  // (n_empty,) the empty rows
  const int* spans;  // (n_span,) the rows that span chunks
  const int* offsets;  // (rows + 1,)
  float* scratch;    // 2 n_chunks d_max float32: head rows, then tail rows
  int64_t rows, n_nz, n_empty, n_span, chunk, n_chunks, d_max;
};

struct Args {
  const void* x;  // (rows_x, d) values
  const int* ids;  // (m,) the row of x each sorted position reads, -1: none
  void* out;      // (rows, d)
  Layout l;
  float* head;    // (n_chunks, d)
  float* tail;    // (n_chunks, d)
  int64_t d;
  int log2_width;
};

template <typename T, int V>
__device__ __forceinline__ void segment_body(const Args& a) {
  using Row = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ out = static_cast<T*>(a.out);
  const Layout& l = a.l;
  const int64_t d = a.d, chunk = l.chunk, n_nz = l.n_nz;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int width = 1 << a.log2_width;
  const int col = lane & (width - 1);
  const int slot = lane >> a.log2_width;
  const int log2_slots = 5 - a.log2_width;
  const int slots = 1 << log2_slots;
  const int per_round = kUnroll << log2_slots;
  // a warp's ring of kStages x 32 vectors, then (after every warp's ring)
  // its chunk's ids
  Row* ring = reinterpret_cast<Row*>(smem) + warp * kStages * 32;
  int* sid = reinterpret_cast<int*>(
                 smem + static_cast<size_t>(kWarps) * kStages * 32 *
                            sizeof(Row)) +
             warp * chunk;
  const int64_t groups = d / V;
  const int64_t tiles = (groups + width - 1) / width;
  const int64_t total = __ldg(l.coff + n_nz);
  const int64_t chunk_items = l.n_chunks * tiles;
  const int64_t items = chunk_items + (l.n_empty + 31) / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  const unsigned full = 0xffffffffu;
  Row zero;
#pragma unroll
  for (int i = 0; i < V; ++i) zero.v[i] = from_float<T>(0.0f);
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       w < items; w += stride) {
    if (w >= chunk_items) {
      // 32 empty rows a warp, every column
      const int64_t z0 = (w - chunk_items) * 32;
      const int64_t zr = z0 + lane < l.n_empty ? __ldg(l.empty + z0 + lane)
                                               : 0;
      const int nzr = l.n_empty - z0 < 32 ? static_cast<int>(l.n_empty - z0)
                                          : 32;
      for (int j = 0; j < nzr; ++j) {
        const int64_t row = __shfl_sync(full, zr, j);
        for (int64_t gg = lane; gg < groups; gg += 32) {
          *reinterpret_cast<Row*>(out + row * d + gg * V) = zero;
        }
      }
      continue;
    }
    // a (chunk, column tile): W vectors of columns
    const int64_t c = w / tiles;
    const int64_t g = (w - c * tiles) * width + col;
    const bool live = g < groups;
    const int64_t at = g * V;
    const int64_t cs = c * chunk;
    const int64_t ce = cs + chunk < total ? cs + chunk : total;
    const int n = static_cast<int>(ce - cs);  // 0 only if total is 0
    const int64_t i_first = __ldg(l.first + c);
    __syncwarp();  // the last item's reads of sid and the ring are done
    for (int i = lane; i < n; i += 32) sid[i] = __ldcs(a.ids + cs + i);
    __syncwarp();
    // stage q holds positions q * slots + [0, slots) of the chunk, slot s's
    // lanes copying position q * slots + s, whatever rows they are in
    const int n_stages = (n + slots - 1) >> log2_slots;
    int issued = 0;  // stages of this chunk whose copies are issued
    auto issue = [&]() {
      const int p = (issued << log2_slots) + slot;
      if (live && p < n) {
        const int id = sid[p];
        if (id >= 0) {
          copy_async<static_cast<int>(sizeof(Row))>(
              ring + (issued & (kStages - 1)) * 32 + lane,
              x + static_cast<int64_t>(id) * d + at);
        }
      }
      commit_async();
      ++issued;
    };
    // the first stages load while the rows' bounds do
    while (issued < n_stages && issued < kStages) issue();
    bool done = false;
    // the non-empty rows from i_first, 31 a window: lane j holds the start
    // of row i0 + j (the next one's is its end) and its output row
    for (int64_t i0 = i_first; i0 < n_nz && !done; i0 += 31) {
      const int64_t wb = i0 + lane <= n_nz ? __ldg(l.coff + i0 + lane) : 0;
      const int64_t wr = i0 + lane < n_nz ? __ldg(l.nz + i0 + lane) : 0;
      for (int j = 0; j < 31; ++j) {
        const int64_t b = __shfl_sync(full, wb, j);
        if (i0 + j >= n_nz || b >= ce) {
          done = true;
          break;
        }
        const int64_t e = __shfl_sync(full, wb, j + 1);
        const int64_t row = __shfl_sync(full, wr, j);
        float acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
        const int kb = static_cast<int>((b > cs ? b : cs) - cs);
        const int ke = static_cast<int>((e < ce ? e : ce) - cs);
        // a round: positions k0 .. k0 + per_round - 1, up to kUnroll a
        // slot, each slot's in order
        for (int k0 = kb; k0 < ke; k0 += per_round) {
          const int k1 = (k0 + per_round < ke ? k0 + per_round : ke) - 1;
          const int need = k1 >> log2_slots;  // the last stage it reads
          // keep the ring full: a stage is refilled once every position
          // of the one it held is added (positions go in order)
          const int stop = (k0 >> log2_slots) + kStages;
          while (issued < n_stages && issued < stop) issue();
          wait_async<kStages - 1>(issued - 1 - need);
          __syncwarp();  // every lane's copies of those stages are in
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int k = k0 + (u << log2_slots) + slot;
            if (live && k < ke && sid[k] >= 0) {
              const Row v = ring[((k >> log2_slots) & (kStages - 1)) * 32 +
                                 (k & (slots - 1)) * width + col];
#pragma unroll
              for (int i = 0; i < V; ++i) acc[i] += to_float(v.v[i]);
            }
          }
          __syncwarp();  // read before a later round refills the stage
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          for (int off = width; off < 32; off <<= 1) {
            acc[i] += __shfl_xor_sync(full, acc[i], off);
          }
        }
        if (b >= cs && e <= ce) {
          // wholly inside the chunk
          if (slot == 0 && live) store_vec<T, V>(out + row * d + at, acc);
          continue;
        }
        // a piece, which the spans launch adds to the row's others
        float* piece = (b < cs ? a.head : a.tail) + c * d;
        if (slot == 0 && live) {
#pragma unroll
          for (int i = 0; i < V; ++i) piece[at + i] = acc[i];
        }
      }
    }
  }
}

// The rows that span chunks, a warp a (row, 32 vectors of columns): the
// row's pieces tail[c0] + head[c0 + 1] + ... + head[c1], added in that
// order (the earlier kernel's second launch did the same adds), a batch of
// pieces in flight a lane.
template <typename T, int V>
__device__ __forceinline__ void spans_body(const Args& a) {
  constexpr int kBatch = 32 / V < 4 ? 4 : 32 / V;
  const Layout& l = a.l;
  T* __restrict__ out = static_cast<T*>(a.out);
  const int64_t d = a.d, chunk = l.chunk;
  const int lane = threadIdx.x & 31;
  const int64_t groups = d / V;
  const int64_t tiles = (groups + 31) / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       w < l.n_span * tiles; w += stride) {
    const int64_t s = w / tiles;
    const int64_t g = (w - s * tiles) * 32 + lane;
    const int64_t row = __ldg(l.spans + s);
    const int64_t c0 = __ldg(l.offsets + row) / chunk;
    const int64_t c1 = (__ldg(l.offsets + row + 1) - 1) / chunk;
    if (g >= groups) continue;
    const int64_t o = g * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = a.tail[c0 * d + o + i];
    for (int64_t cb = c0 + 1; cb <= c1; cb += kBatch) {
      float p[kBatch][V];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          p[q][i] = cb + q <= c1 ? a.head[(cb + q) * d + o + i] : 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (cb + q <= c1) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += p[q][i];
        }
      }
    }
    store_vec<T, V>(out + row * d + o, acc);
  }
}

// Two names for one body, so that a trace tells the entries apart.
template <typename T, int V>
__global__ void __launch_bounds__(connectit::kThreads)
    segment_sum_kernel(const Args a) {
  segment_body<T, V>(a);
}

template <typename T, int V>
__global__ void __launch_bounds__(connectit::kThreads)
    gather_sum_kernel(const Args a) {
  segment_body<T, V>(a);
}

template <typename T, int V>
__global__ void __launch_bounds__(connectit::kThreads)
    segment_sum_spans_kernel(const Args a) {
  spans_body<T, V>(a);
}

template <typename T, int V>
__global__ void __launch_bounds__(connectit::kThreads)
    gather_sum_spans_kernel(const Args a) {
  spans_body<T, V>(a);
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

template <typename Kernel>
int launch_kernel(Kernel kernel, const Args& a, int64_t items,
                  size_t smem_bytes, cudaStream_t st) {
  // above 48 KB a block's dynamic shared memory must be granted first
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t blocks = (items + kWarps - 1) / kWarps;
  if (blocks > connectit::kMaxBlocks) blocks = connectit::kMaxBlocks;
  kernel<<<static_cast<unsigned>(blocks), connectit::kThreads, smem_bytes,
           st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launch with the widest vector of at most 16 bytes that divides d and
// keeps every row of x and of out aligned.
template <typename T, int V>
int launch(bool gather, Args a, cudaStream_t st) {
  if constexpr (V > 1) {
    if (a.d % V != 0 || !aligned(a.x, sizeof(T) * V) ||
        !aligned(a.out, sizeof(T) * V)) {
      return launch<T, V / 2>(gather, a, st);
    }
  }
  const int64_t groups = a.d / V;
  a.log2_width = 0;
  while (a.log2_width < 5 && (int64_t{1} << a.log2_width) < groups) {
    ++a.log2_width;
  }
  const int64_t tiles = (groups + (int64_t{1} << a.log2_width) - 1) >>
                        a.log2_width;
  const int64_t items = a.l.n_chunks * tiles + (a.l.n_empty + 31) / 32;
  const size_t smem_bytes =
      static_cast<size_t>(kWarps) *
      (static_cast<size_t>(kStages) * 32 * sizeof(Vec<T, V>) +
       static_cast<size_t>(a.l.chunk) * sizeof(int));
  const int rc = gather ? launch_kernel(gather_sum_kernel<T, V>, a, items,
                                        smem_bytes, st)
                        : launch_kernel(segment_sum_kernel<T, V>, a, items,
                                        smem_bytes, st);
  if (rc != 0 || a.l.n_span == 0) return rc;  // one launch: no row spans
  const int64_t spans = a.l.n_span * ((groups + 31) / 32);
  return gather ? launch_kernel(gather_sum_spans_kernel<T, V>, a, spans, 0,
                                st)
                : launch_kernel(segment_sum_spans_kernel<T, V>, a, spans, 0,
                                st);
}

template <typename T>
int segment_call(bool gather, const void* x, const int* ids, void* out,
                 const void* layout, int64_t d, void* stream) {
  if (layout == nullptr || ids == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.l = *static_cast<const Layout*>(layout);
  const Layout& l = a.l;
  if (l.rows < 0 || d < 1 || d > l.d_max || l.chunk < 32 || l.chunk > 256 ||
      (l.chunk & (l.chunk - 1)) != 0 || l.n_chunks < 1 || l.n_nz < 0 ||
      l.n_empty < 0 || l.n_nz + l.n_empty != l.rows || l.n_span < 0 ||
      l.n_span > l.n_nz || !aligned(l.scratch, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (l.rows == 0) return 0;
  a.x = x;
  a.ids = ids;
  a.out = out;
  a.head = l.scratch;
  a.tail = l.scratch + l.n_chunks * d;
  a.d = d;
  a.log2_width = 0;
  return launch<T, 16 / sizeof(T)>(gather, a,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// Every entry: ids (m,) int32, the sorted positions' rows of the values
// (segment_sum's: the layout's order; gather_sum's: the gathered ids, -1
// where masked); layout the address of a Layout (above) whose scratch
// holds 2 n_chunks d_max float32 (d <= d_max); n_chunks = max(1, ceil(total
// / chunk)). One launch a call where no row spans chunks, else two.
extern "C" int segment_sum_f32(const void* vals, const int* order, void* out, const void* layout, int64_t d, void* stream) {
  return segment_call<float>(false, vals, order, out, layout, d, stream);
}

extern "C" int segment_sum_bf16(const void* vals, const int* order, void* out, const void* layout, int64_t d, void* stream) {
  return segment_call<__nv_bfloat16>(false, vals, order, out, layout, d,
                                     stream);
}

extern "C" int gather_sum_f32(const void* x, const int* ids, void* out, const void* layout, int64_t d, void* stream) {
  return segment_call<float>(true, x, ids, out, layout, d, stream);
}

extern "C" int gather_sum_bf16(const void* x, const int* ids, void* out, const void* layout, int64_t d, void* stream) {
  return segment_call<__nv_bfloat16>(true, x, ids, out, layout, d, stream);
}
