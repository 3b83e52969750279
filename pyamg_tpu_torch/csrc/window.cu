// Windowed-ELL transfer-operator kernels of pyamg_tpu_torch, for Hopper
// (sm_90a).
//
//   windowed_gather_kernel<T, V, kGatherSum> (K6)
//                            replaces pyamg_tpu/sparse/window.py::WindowedELL._matvec_pallas
//   windowed_rmatvec_kernel, windowed_rmatvec_tiles_kernel (K7)
//                            replace pyamg_tpu/sparse/window.py::WindowedELL._rmatvec_pallas
//   windowed_matmat_k_kernel (K12)
//                            replaces pyamg_tpu/sparse/window.py::WindowedELL._matmat_pallas_k
//   windowed_rmatmat_k_kernel (K13)
//                            replaces pyamg_tpu/sparse/window.py::WindowedELL._rmatmat_pallas_k
//   windowed_gather_kernel<T, V, kGatherSelect> (K14)
//                            replaces pyamg_tpu/sparse/window.py::WindowedELL._select_pallas
//   windowed_matvec_rows_kernel
//                            one thread per row: K6's first form, kept as
//                            its bit reference (no path launches it)
//
// Layout (built on the host by windowed_from_scipy, identical to the JAX
// package's): rows in blocks of `block`; block b reads the source window
// starting at starts[b] * w2; data and idx are slot-major
// (n_blocks, k, block), idx window-relative.  The entry (b, s, row) is
// A[b * block + row, starts[b] * w2 + idx[b, s, row]]; padding slots hold
// data 0 and idx 0.
//
// The TPU resolved each index with one-hot products on the MXU because it
// cannot gather; Hopper can, so the forward apply is a direct indexed load
// and the transpose an indexed gather through a column plan.
//
// Bound: device-memory bandwidth.  The forward apply (K6) reads data and
// idx (k * n * (sizeof(T) + 4) bytes), the starts and the window of x, and
// writes n values; the select (K14) reads idx and writes one value per
// entry.  Both are one template, windowed_gather_kernel, with a sum
// epilogue (K6) or a per-slot store (K14), launched by a plan made on the
// host (sparse/window.py::gather_plan).  A CTA works inside one row block
// b (blockIdx.x = b * ctas_per_block + chunk), so the window start
// starts[b] * w2 is one uniform load; the CTA's base pointers into data,
// idx, out and x are 64-bit, and every offset inside the row block 32-bit
// (k * block < 2^31, which the launch checks).  A thread moves 16 bytes of
// each stream at a time: V = 4 float32 or 2 float64 rows (K6: each slot's
// data and idx, then one store of V sums) or entries (K14: one idx load, V
// gathers, one store), or V = 1 where the operands are unaligned or, for
// K6, where 16 bytes a thread would leave the card too few threads; the
// slot-major layout makes neighbouring threads' accesses neighbouring.  K6 sums a row's slots in ascending order with
// one explicit FMA each from 0, the arithmetic nvcc's contraction of acc
// += data * x gave the per-row kernel, so the bits are the per-row
// kernel's.  The gathers of x go through L1: staging a row block's window
// (2 * w2 values) in shared memory first gained nothing measurable on the
// card (PERF.md §6; scripts/window_variants.cu keeps that form).
//
// The transpose (K7) replaces the TPU's VMEM-resident output accumulated
// over a sequential grid (window.py:253-293).  Blocks here run in no
// order, so a scatter from the entries would meet in atomics and sum in an
// order that changes from run to run; with theta = 0 an entry that
// cancels to a few ulp then moves the unstructured setup's strength graph
// and its deep levels.  So the transpose gathers instead: the wrapper
// builds a column plan once per operator (sparse/window.py::
// WindowedELL.column_plan: every entry keyed by its global column
// starts[b] * w2 + idx, a dead one (data == 0) by the sentinel m =
// m_chunks * w2, sorted stably on the device into an int32 permutation
// `perm`, with int32 column pointers `colptr` of length m + 1; no count is
// read back to the host), and each output column is summed over its
// entries in ascending entry order and written once.  That is the order
// of the plain version's index_add_ on the CPU, and the products and sums
// are rounded separately (__fmul_rn / __fadd_rn, no FMA contraction), so
// the result is the same bit for bit from launch to launch, from run to
// run, and as the CPU plain version's.  Structural zeros (data == 0, the
// padding rows) sort past colptr[m], where no column reads: they add
// nothing.  No output is zeroed first: every column is written, an empty
// one with 0.
//
// K7 has two forms, chosen by the wrapper from the operator's stored
// slots per column (sparse/window.py::windowed_rmatvec).  For short
// columns (under 16 slots each, as in the host-built T and the 640k A
// and P),
// one thread per column walks its entries through perm, the row's
// division done in 32 bits (the plan's int32 perm bounds e).  For longer
// ones the tile form walks the plan in K13's tiles of whole columns
// (below; a table built once per operator): a CTA first forms its tile's
// products data[e] * r[row(e)], every entry of the tile in parallel (four
// per thread in flight), and stages them rounded in shared memory; then a
// thread per column adds its column's products in plan order.  So a long
// column's loads are spread over the CTA instead of one thread's serial
// chain, and the serial part is one add per entry from shared memory.  A
// column longer than the tile budget is staged in budget-sized pieces and
// summed by one thread.  Both forms give the same bits.  Bound:
// device-memory bandwidth, the live entries' data, perm and the r values
// they read (nnz * (2 * sizeof(T) + 4) bytes), colptr and y; the gathers
// of data and r through perm are the price of the fixed order.
//
// The K-lane forms take K-major lane stacks (the batched solve's layout):
// X (lanes, m_chunks * w2) -> Y (lanes, n_pad) forward (K12), R (lanes,
// n_pad) -> Y (lanes, m_chunks * w2) transposed (K13).  The point of the
// TPU kernels is that the operator's bytes are paid once per batch, not
// once per lane, so every lane of a call (up to kLaneTile = 64, the
// setup's probe width; more tile over gridDim.y) runs in ONE launch, and
// each CTA stages its share of the operator in shared memory once for all
// its lanes.  Threads own (output, lane group) pairs, LT lanes to a
// group, so the parallelism is outputs x lanes / LT, not outputs alone,
// and a thread keeps LT gathers in flight per entry:
//
// - K12: a CTA takes `rows` consecutive rows of one row block (one window
//   start; a block's last CTA the rows left) and stages their k slots'
//   data and idx (slot-major, so the loads are coalesced); a thread
//   takes (row, lane group) pairs of kK12Lanes = 4 lanes, rows fastest
//   within a warp (neighbouring rows gather neighbouring x and write
//   neighbouring y), and sums its row's slots for each of its lanes in
//   ascending slot order with one explicit fma per slot from 0, the
//   arithmetic the 16-lane loop of earlier versions got from nvcc's
//   contraction of acc += a * x (same bits).
//   The x window is not staged: 2 * w2 entries per lane, 1 MB for 64
//   float32 lanes at w2 = 2048, exceeds a CTA's shared memory.
// - K13: K7's column plan, cut into tiles of consecutive columns by a
//   tile table (sparse/window.py::WindowedELL.column_tiles, built once per
//   column cap on the device): a tile holds at most `budget` live entries
//   and `max_cols` columns, or a single longer column (the launch sizes
//   shared memory by those caps, so it takes them from the table's own
//   record).  A CTA stages its tile's entries (row and value, through perm, four
//   entries per thread in flight; the entry_row division done once per
//   entry) in shared memory, then threads take (column, lane group) pairs
//   of LT lanes (a template parameter, 1 to 16, set per call by the
//   wrapper from the operator's column length), consecutive columns of
//   one lane group fastest within a warp, and walk their column's staged
//   entries in ascending plan order with separately rounded products and
//   sums (mul_add_rn), writing each output once.  A column is never split,
//   so each (column, lane) sums in K7's order: the same bits on every
//   launch and as the CPU twin's index_add_.  A single column longer than
//   the budget is summed from device memory, its lanes over the threads.
//
// Bound: device-memory bandwidth, the operator's bytes once plus the K
// input and output rows; the gathers of x (K12) and r (K13) through the
// entries' columns and rows are the price of the K-major layout.
//
// The select (K14) reads x at every entry's column and writes it to that
// entry's slot: out[b, s, row] = x[starts[b] * w2 + idx[b, s, row]], no
// arithmetic; a row block's entries are contiguous, so a K14 thread's V
// entries are V neighbours of the flat (n_blocks, k, block) array.  The
// TPU resolved the index by a one-hot product through a three-way bf16
// split of x (exact for integers below 2^24, within 2^-26 relative
// otherwise); here the load is exact for every payload, so the
// unstructured setup's integer payloads (coarse indices, cumulative root
// counts riding float32) and its finite sentinels come back unchanged.  x
// is the payload's own dtype, not the operator's: the setup selects
// float32 indices from a float64 operator.  Bound: device-memory
// bandwidth, idx read and out written once (k * n * (4 + sizeof(T))
// bytes) plus the starts and the window of x.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// lanes per CTA of the K-lane kernels; more lanes tile over gridDim.y
constexpr int kLaneTile = 64;
// lanes per K12 thread: LT gathers of a slot in flight together
constexpr int kK12Lanes = 4;

// a * b + c with the product and the sum each rounded (no FMA), the
// plain version's arithmetic
__device__ __forceinline__ float mul_add_rn(float a, float b, float c) {
  return __fadd_rn(c, __fmul_rn(a, b));
}
__device__ __forceinline__ double mul_add_rn(double a, double b, double c) {
  return __dadd_rn(c, __dmul_rn(a, b));
}

// a * b and a + b, each rounded (never contracted into an FMA)
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// a * b + c rounded once (an explicit FMA)
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// K6 by row (the first form, kept as the bit reference): one thread per
// row, its slots in order.
template <typename T>
__global__ void windowed_matvec_rows_kernel(const T* __restrict__ data,
                                            const int* __restrict__ idx,
                                            const int* __restrict__ starts,
                                            int k, int block, int w2,
                                            int64_t n_rows,
                                            const T* __restrict__ x,
                                            T* __restrict__ y) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_rows) return;
  const int64_t blk = g / block;
  const int64_t row = g - blk * block;
  const int64_t base = static_cast<int64_t>(starts[blk]) * w2;
  const int64_t e0 = blk * k * block + row;
  T acc = T(0);
  for (int s = 0; s < k; ++s) {
    const int64_t e = e0 + static_cast<int64_t>(s) * block;
    acc += data[e] * x[base + idx[e]];
  }
  y[g] = acc;
}

// V consecutive values of T, loaded or stored as one access of V *
// sizeof(T) bytes (16 for 4 float32 or 2 float64; idx's 4 or 2 ints)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <int V, typename T>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <int V, typename T>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

enum GatherMode : int { kGatherSum = 0, kGatherSelect = 1 };

// K6 (kGatherSum) and K14 (kGatherSelect).  CTA blockIdx.x = (row block
// b, chunk c) with b = blockIdx.x / ctas_per_block: the chunk's items are
// [c * items_per_cta, +items_per_cta) of the block's, an item being V
// rows (K6: block / V items) or V entries of the block's flat k * block
// (K14), taken by the CTA's threads in turn.  The block's base pointers
// are 64-bit; the offsets inside it fit 32 bits (the launch's check).
template <typename T, int V, int MODE>
__global__ void windowed_gather_kernel(const T* __restrict__ data,
                                       const int* __restrict__ idx,
                                       const int* __restrict__ starts,
                                       int k, int block, int w2,
                                       int ctas_per_block, int items_per_cta,
                                       const T* __restrict__ x,
                                       T* __restrict__ out) {
  const int b = blockIdx.x / ctas_per_block;
  const int i0 = (blockIdx.x - b * ctas_per_block) * items_per_cta;
  const int i1 = min(i0 + items_per_cta,
                     (MODE == kGatherSum ? block : k * block) / V);
  const T* xw = x + static_cast<int64_t>(starts[b]) * w2;
  const int64_t eb = static_cast<int64_t>(b) * k * block;
  const int* ib = idx + eb;
  if constexpr (MODE == kGatherSum) {
    const T* db = data + eb;
    T* yb = out + static_cast<int64_t>(b) * block;
    for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
      const int r = i * V;
      T acc[V];
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = T(0);
      // the slots' loads of four iterations in flight before their sums
#pragma unroll 4
      for (int s = 0; s < k; ++s) {
        const int e = s * block + r;
        const Pack<T, V> d = load_pack<V>(db + e);
        const Pack<int, V> c = load_pack<V>(ib + e);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          acc[u] = fma_rn(d.v[u], xw[c.v[u]], acc[u]);
        }
      }
      Pack<T, V> y;
#pragma unroll
      for (int u = 0; u < V; ++u) y.v[u] = acc[u];
      store_pack<V>(yb + r, y);
    }
  } else {
    T* ob = out + eb;
    for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
      const int e = i * V;
      const Pack<int, V> c = load_pack<V>(ib + e);
      Pack<T, V> o;
#pragma unroll
      for (int u = 0; u < V; ++u) o.v[u] = xw[c.v[u]];
      store_pack<V>(ob + e, o);
    }
  }
}

// the row of entry e of the slot-major (n_blocks, k, block) layout
__device__ __forceinline__ int64_t entry_row(int64_t e, int64_t per_block,
                                             int block) {
  return (e / per_block) * block + e % block;
}

// the row of entry e, in 32 bits (the plan's int32 perm bounds e)
__device__ __forceinline__ int entry_row32(int e, unsigned per_block,
                                           unsigned block) {
  const unsigned u = static_cast<unsigned>(e);
  return static_cast<int>((u / per_block) * block + u % block);
}

// K7's products data[e] * r[row(e)] of the plan entries [j0, j0 + cnt),
// rounded, into sprod[0, cnt): four entries per thread and pass, their
// perm loads, then their data and r gathers, in flight together
template <typename T>
__device__ __forceinline__ void stage_products(
    const T* __restrict__ data, const int* __restrict__ perm,
    const T* __restrict__ r, int j0, int cnt, unsigned per_block,
    unsigned block, T* sprod) {
  for (int i0 = threadIdx.x; i0 < cnt; i0 += 4 * blockDim.x) {
    int e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      e[u] = i < cnt ? perm[j0 + i] : 0;
    }
    T d[4], x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < cnt) {
        d[u] = data[e[u]];
        x[u] = r[entry_row32(e[u], per_block, block)];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < cnt) sprod[i] = mul_rn(d[u], x[u]);
    }
  }
}

// K7 by column: one thread per output column c < m walks the column's
// live entries perm[colptr[c] .. colptr[c + 1]) in plan order.
template <typename T>
__global__ void windowed_rmatvec_kernel(const T* __restrict__ data,
                                        const int* __restrict__ perm,
                                        const int* __restrict__ colptr,
                                        int k, int block, int64_t m,
                                        const T* __restrict__ r,
                                        T* __restrict__ y) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= m) return;
  const unsigned per_block = static_cast<unsigned>(k) * block;
  T acc = T(0);
  for (int j = colptr[c], j1 = colptr[c + 1]; j < j1; ++j) {
    const int e = perm[j];
    acc = mul_add_rn(data[e], r[entry_row32(e, per_block, block)], acc);
  }
  y[c] = acc;
}

// K7 by tile: CTA blockIdx.x = tile blockIdx.x of the tile table (columns
// [tiles[t], tiles[t + 1]); an empty tile's CTA exits at once).  Shared
// memory holds the tile's rounded products (at most `budget`) and its
// column pointers (at most max_cols + 1); a thread per column then adds
// its column's products in plan order.  A single column longer than the
// budget is staged `budget` products at a time and summed by thread 0.
template <typename T>
__global__ void windowed_rmatvec_tiles_kernel(const T* __restrict__ data,
                                        const int* __restrict__ perm,
                                        const int* __restrict__ colptr,
                                        const int* __restrict__ tiles,
                                        int budget, int k, int block,
                                        const T* __restrict__ r,
                                        T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sprod = reinterpret_cast<T*>(smem);
  int* sptr = reinterpret_cast<int*>(sprod + budget);
  const int c0 = tiles[blockIdx.x];
  const int n_cols = tiles[blockIdx.x + 1] - c0;
  if (n_cols == 0) return;
  const int j0 = colptr[c0];
  const int n_ent = colptr[c0 + n_cols] - j0;
  const unsigned per_block = static_cast<unsigned>(k) * block;
  if (n_ent > budget) {
    T acc = T(0);
    for (int done = 0; done < n_ent; done += budget) {
      const int cnt = min(budget, n_ent - done);
      stage_products(data, perm, r, j0 + done, cnt, per_block, block, sprod);
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int j = 0; j < cnt; ++j) acc = add_rn(acc, sprod[j]);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) y[c0] = acc;
    return;
  }
  stage_products(data, perm, r, j0, n_ent, per_block, block, sprod);
  for (int c = threadIdx.x; c <= n_cols; c += blockDim.x) {
    sptr[c] = colptr[c0 + c] - j0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_cols; c += blockDim.x) {
    T acc = T(0);
    for (int j = sptr[c], j1 = sptr[c + 1]; j < j1; ++j) {
      acc = add_rn(acc, sprod[j]);
    }
    y[c0 + c] = acc;
  }
}

// K12: CTA (blockIdx.x, blockIdx.y) = rows [r0, r0 + nr) of row block
// blockIdx.x / cpb, r0 = rows * (blockIdx.x % cpb), cpb = ceil(block /
// rows) CTAs a row block (its last one takes the rows left, so any block
// size keeps `rows` rows a CTA) x lanes [64 * blockIdx.y, +64); shared
// memory holds the rows' k slots, data then idx, slot-major (k * nr
// each).
template <typename T>
__global__ void windowed_matmat_k_kernel(const T* __restrict__ data,
                                         const int* __restrict__ idx,
                                         const int* __restrict__ starts,
                                         int k, int block, int w2,
                                         int64_t n_rows, int64_t m,
                                         int lanes, int rows, int cpb,
                                         const T* __restrict__ x,
                                         T* __restrict__ y) {
  constexpr int LT = kK12Lanes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sdata = reinterpret_cast<T*>(smem);
  int* sidx = reinterpret_cast<int*>(sdata + k * rows);
  const int64_t blk = blockIdx.x / cpb;
  const int r0 = static_cast<int>(blockIdx.x - blk * cpb) * rows;
  const int nr = min(rows, block - r0);
  const int64_t g0 = blk * block + r0;
  const int64_t e0 = blk * k * block + r0;
  for (int i = threadIdx.x; i < k * nr; i += blockDim.x) {
    const int s = i / nr;
    const int64_t e = e0 + static_cast<int64_t>(s) * block + (i - s * nr);
    sdata[i] = data[e];
    sidx[i] = idx[e];
  }
  __syncthreads();
  const int l0 = blockIdx.y * kLaneTile;
  const int kl = min(kLaneTile, lanes - l0);
  const int n_pairs = nr * ((kl + LT - 1) / LT);
  const int64_t base = static_cast<int64_t>(starts[blk]) * w2;
  // pair p: row p % nr (rows fastest in a warp) and LT lanes from
  // l0 + LT * (p / nr); the LT gathers of a slot are in flight together
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int rr = p % nr;
    const int la = LT * (p / nr);
    const int nl = kl - la;
    const T* xl = x + static_cast<int64_t>(l0 + la) * m + base;
    T acc[LT];
#pragma unroll
    for (int j = 0; j < LT; ++j) acc[j] = T(0);
    for (int i = rr; i < k * nr; i += nr) {
      const T a = sdata[i];
      const int col = sidx[i];
#pragma unroll
      for (int j = 0; j < LT; ++j) {
        if (j < nl) acc[j] = fma_rn(a, xl[j * m + col], acc[j]);
      }
    }
    T* yl = y + static_cast<int64_t>(l0 + la) * n_rows + g0 + rr;
#pragma unroll
    for (int j = 0; j < LT; ++j) {
      if (j < nl) yl[j * n_rows] = acc[j];
    }
  }
}

// K13: CTA (blockIdx.x, blockIdx.y) = tile blockIdx.x of the tile table
// (columns [tiles[t], tiles[t + 1]); an empty tile's CTA exits at once) x
// lanes [64 * blockIdx.y, +64); shared memory holds the tile's live
// entries' values and rows (at most `budget` each) and its column
// pointers (at most max_cols + 1).
template <typename T, int LT>
__global__ void windowed_rmatmat_k_kernel(const T* __restrict__ data,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ colptr,
                                          const int* __restrict__ tiles,
                                          int budget, int k, int block,
                                          int64_t n_rows, int64_t m,
                                          int lanes,
                                          const T* __restrict__ r,
                                          T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sdata = reinterpret_cast<T*>(smem);
  int* srow = reinterpret_cast<int*>(sdata + budget);
  int* sptr = srow + budget;
  const int c0 = tiles[blockIdx.x];
  const int n_cols = tiles[blockIdx.x + 1] - c0;
  if (n_cols == 0) return;
  const int j0 = colptr[c0];
  const int n_ent = colptr[c0 + n_cols] - j0;
  const int l0 = blockIdx.y * kLaneTile;
  const int kl = min(kLaneTile, lanes - l0);
  const int64_t per_block = static_cast<int64_t>(k) * block;
  r += static_cast<int64_t>(l0) * n_rows;
  y += static_cast<int64_t>(l0) * m + c0;
  if (n_ent > budget) {
    // a single column longer than the budget: its lanes over the threads,
    // its entries read from device memory in plan order
    for (int l = threadIdx.x; l < kl; l += blockDim.x) {
      const T* rl = r + l * n_rows;
      T acc = T(0);
      for (int j = j0; j < j0 + n_ent; ++j) {
        const int64_t e = perm[j];
        acc = mul_add_rn(data[e], rl[entry_row(e, per_block, block)], acc);
      }
      y[l * m] = acc;
    }
    return;
  }
  // four entries per thread and pass: their perm loads, then their data
  // loads, in flight together
  for (int i0 = threadIdx.x; i0 < n_ent; i0 += 4 * blockDim.x) {
    int64_t e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      e[u] = i < n_ent ? perm[j0 + i] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n_ent) {
        sdata[i] = data[e[u]];
        srow[i] = static_cast<int>(entry_row(e[u], per_block, block));
      }
    }
  }
  for (int c = threadIdx.x; c <= n_cols; c += blockDim.x) {
    sptr[c] = colptr[c0 + c] - j0;
  }
  __syncthreads();
  // pair p: column p % n_cols (consecutive columns of one lane group in
  // a warp) and LT lanes from LT * (p / n_cols)
  const int n_lg = (kl + LT - 1) / LT;
  const int n_pairs = n_cols * n_lg;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int c = p % n_cols;
    const int lg = p / n_cols;
    // never taken (p < n_pairs); with it nvcc's code for the lane loop
    // runs LT = 4 about 20 % faster on the H100 (PERF.md §6)
    if (lg >= n_lg) continue;
    const int nl = kl - LT * lg;
    const T* rl = r + static_cast<int64_t>(LT * lg) * n_rows;
    T acc[LT];
#pragma unroll
    for (int jj = 0; jj < LT; ++jj) acc[jj] = T(0);
    // the column's entries in plan order; the LT gathers of an entry (and
    // of the next, unrolled) are in flight together
#pragma unroll 2
    for (int j = sptr[c], j1 = sptr[c + 1]; j < j1; ++j) {
      const T d = sdata[j];
      const int g = srow[j];
#pragma unroll
      for (int jj = 0; jj < LT; ++jj) {
        if (jj < nl) acc[jj] = mul_add_rn(d, rl[jj * n_rows + g], acc[jj]);
      }
    }
    T* yl = y + static_cast<int64_t>(LT * lg) * m + c;
#pragma unroll
    for (int jj = 0; jj < LT; ++jj) {
      if (jj < nl) yl[jj * m] = acc[jj];
    }
  }
}

constexpr int kThreads = 256;

inline unsigned int grid_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_matvec_rows(const void* data, const void* idx, const void* starts,
                       int k, int block, int w2, long long n_rows,
                       const void* x, void* y, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  windowed_matvec_rows_kernel<T><<<grid_for(n_rows), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(starts), k, block, w2, n_rows,
      static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory above the default 48 KB needs the kernel's
// attribute raised first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline unsigned int lane_tiles(int lanes) {
  return static_cast<unsigned int>((lanes + kLaneTile - 1) / kLaneTile);
}

// The K-lane launches, one per call: x (lanes, m) in, y (lanes, n_rows)
// out for the forward form, `rows` rows per CTA (a divisor of block);
// r (lanes, n_rows) in, y (lanes, m) out for the transpose, one CTA per
// tile of the n_tiles + 1 boundaries in `tiles` (at most `budget`
// entries and `max_cols` columns each, or one longer column).  `lt`
// lanes per K13 thread: 1, 2, 4, 8 or 16.
template <typename T>
int launch_matmat_k(const void* data, const void* idx, const void* starts,
                    int k, int block, int w2, long long n_rows, long long m,
                    int lanes, int rows, const void* x, void* y,
                    void* stream) {
  if (lanes < 1 || rows < 1 || rows > block || n_rows % block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(k) * rows * (sizeof(T) + sizeof(int));
  cudaError_t err = allow_smem(windowed_matmat_k_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cpb = (block + rows - 1) / rows;
  const long long ctas = n_rows / block * cpb;
  if (ctas >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(ctas), lane_tiles(lanes));
  windowed_matmat_k_kernel<T><<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(starts), k, block, w2, n_rows, m, lanes, rows,
      cpb, static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

// K7 by column: one thread per column c < m; r (n_rows) in, y (m) out.
template <typename T>
int launch_rmatvec(const void* data, const void* perm, const void* colptr,
                   int k, int block, long long m, const void* r, void* y,
                   void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  windowed_rmatvec_kernel<T><<<grid_for(m), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(perm),
      static_cast<const int*>(colptr), k, block, m, static_cast<const T*>(r),
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

// K7 by tile: one CTA per tile of the n_tiles + 1 boundaries in `tiles`
// (at most `budget` entries and `max_cols` columns each, or one longer
// column); r (n_rows) in, y (m) out.
template <typename T>
int launch_rmatvec_tiles(const void* data, const void* perm,
                         const void* colptr, const void* tiles, int n_tiles,
                         int budget, int max_cols, int k, int block,
                         const void* r, void* y, void* stream) {
  if (budget < 1 || max_cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(budget) * sizeof(T)
                      + static_cast<size_t>(max_cols + 1) * sizeof(int);
  cudaError_t err = allow_smem(windowed_rmatvec_tiles_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  windowed_rmatvec_tiles_kernel<T><<<static_cast<unsigned int>(n_tiles),
                                     kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(perm),
      static_cast<const int*>(colptr), static_cast<const int*>(tiles),
      budget, k, block, static_cast<const T*>(r), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LT>
int launch_rmatmat_k_lt(const void* data, const void* perm,
                        const void* colptr, const void* tiles, int n_tiles,
                        int budget, int max_cols, int k, int block,
                        long long n_rows, long long m, int lanes,
                        const void* r, void* y, void* stream) {
  const size_t smem = static_cast<size_t>(budget) * (sizeof(T) + sizeof(int))
                      + static_cast<size_t>(max_cols + 1) * sizeof(int);
  cudaError_t err = allow_smem(windowed_rmatmat_k_kernel<T, LT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(n_tiles), lane_tiles(lanes));
  windowed_rmatmat_k_kernel<T, LT><<<grid, kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(perm),
      static_cast<const int*>(colptr), static_cast<const int*>(tiles),
      budget, k, block, n_rows, m, lanes, static_cast<const T*>(r),
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rmatmat_k(const void* data, const void* perm, const void* colptr,
                     const void* tiles, int n_tiles, int budget, int max_cols,
                     int k, int block, long long n_rows, long long m,
                     int lanes, int lt, const void* r, void* y,
                     void* stream) {
  if (lanes < 1 || budget < 1 || max_cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  switch (lt) {
#define PYAMG_K13_LT(L)                                                     \
    case L:                                                                 \
      return launch_rmatmat_k_lt<T, L>(data, perm, colptr, tiles, n_tiles,  \
                                       budget, max_cols, k, block, n_rows,  \
                                       m, lanes, r, y, stream);
    PYAMG_K13_LT(1) PYAMG_K13_LT(2) PYAMG_K13_LT(4) PYAMG_K13_LT(8)
    PYAMG_K13_LT(16)
#undef PYAMG_K13_LT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int V, int MODE>
int launch_gather_form(const void* data, const void* idx, const void* starts,
                       int k, int block, int w2, unsigned int grid,
                       int threads, int ctas_per_block, int items_per_cta,
                       const void* x, void* out, void* stream) {
  windowed_gather_kernel<T, V, MODE><<<grid, threads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(starts), k, block, w2, ctas_per_block,
      items_per_cta, static_cast<const T*>(x), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K6 (mode kGatherSum: y of n_blocks * block rows) or K14 (kGatherSelect:
// out like idx; data unused) by a plan: `vec` values a thread and item (1
// or 16 bytes' worth), `threads` a CTA, ctas_per_block CTAs of
// items_per_cta items for each row block.  The 16-byte alignment of every
// pack operand (data, idx, out) is the caller's
// (sparse/window.py::gather_plan); the shape's consistency, and the 32-bit
// bound on offsets inside a row block (k * block < 2^31), are checked here.
template <typename T>
int launch_gather(int mode, const void* data, const void* idx,
                  const void* starts, int k, int block, int w2, int n_blocks,
                  int vec, int threads, int ctas_per_block, int items_per_cta,
                  const void* x, void* out, void* stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if ((mode != kGatherSum && mode != kGatherSelect)
      || (vec != 1 && vec != kVec) || block % vec != 0 || k < 1
      || static_cast<long long>(k) * block >= (1LL << 31)
      || static_cast<long long>(ctas_per_block) * items_per_cta >= (1LL << 31)
      || threads < 32 || threads > 1024 || threads % 32 != 0
      || ctas_per_block < 1 || items_per_cta < 1
      || static_cast<long long>(ctas_per_block) * items_per_cta
             < (mode == kGatherSum ? block : static_cast<long long>(k) * block)
                   / vec
      || static_cast<long long>(n_blocks) * ctas_per_block >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks <= 0) return static_cast<int>(cudaSuccess);
  const unsigned int grid = static_cast<unsigned int>(n_blocks) * ctas_per_block;
#define PYAMG_GATHER(V, M)                                                   \
  return launch_gather_form<T, V, M>(data, idx, starts, k, block, w2, grid,  \
                                     threads, ctas_per_block, items_per_cta, \
                                     x, out, stream)
  if (mode == kGatherSum) {
    if (vec == 1) PYAMG_GATHER(1, kGatherSum);
    PYAMG_GATHER(kVec, kGatherSum);
  }
  if (vec == 1) PYAMG_GATHER(1, kGatherSelect);
  PYAMG_GATHER(kVec, kGatherSelect);
#undef PYAMG_GATHER
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// K6 or K14 by a plan: mode, data, idx, starts, k, block, w2, n_blocks,
// vec, threads, ctas_per_block, items_per_cta, x, out, stream
int pyamg_windowed_gather_f32(int mode, const void* data, const void* idx,
                              const void* starts, int k, int block, int w2,
                              int n_blocks, int vec, int threads,
                              int ctas_per_block, int items_per_cta,
                              const void* x, void* out, void* stream) {
  return launch_gather<float>(mode, data, idx, starts, k, block, w2,
                              n_blocks, vec, threads, ctas_per_block,
                              items_per_cta, x, out, stream);
}

int pyamg_windowed_gather_f64(int mode, const void* data, const void* idx,
                              const void* starts, int k, int block, int w2,
                              int n_blocks, int vec, int threads,
                              int ctas_per_block, int items_per_cta,
                              const void* x, void* out, void* stream) {
  return launch_gather<double>(mode, data, idx, starts, k, block, w2,
                               n_blocks, vec, threads, ctas_per_block,
                               items_per_cta, x, out, stream);
}

// K6 by row: data, idx, starts, k, block, w2, n_rows, x, y, stream
int pyamg_windowed_matvec_rows_f32(const void* data, const void* idx,
                                   const void* starts, int k, int block,
                                   int w2, long long n_rows, const void* x,
                                   void* y, void* stream) {
  return launch_matvec_rows<float>(data, idx, starts, k, block, w2, n_rows,
                                   x, y, stream);
}

int pyamg_windowed_matvec_rows_f64(const void* data, const void* idx,
                                   const void* starts, int k, int block,
                                   int w2, long long n_rows, const void* x,
                                   void* y, void* stream) {
  return launch_matvec_rows<double>(data, idx, starts, k, block, w2, n_rows,
                                    x, y, stream);
}

// an empty kernel on `grid` CTAs of `threads`: the floor a launch of that
// grid reaches in a timer (a yardstick; no path launches it)
int pyamg_empty_launch(long long grid, int threads, void* stream) {
  if (grid <= 0 || grid >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  empty_kernel<<<static_cast<unsigned int>(grid), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// K7 by column: data, perm, colptr, k, block, m, r, y, stream
int pyamg_windowed_rmatvec_f32(const void* data, const void* perm,
                               const void* colptr, int k, int block,
                               long long m, const void* r, void* y,
                               void* stream) {
  return launch_rmatvec<float>(data, perm, colptr, k, block, m, r, y, stream);
}

int pyamg_windowed_rmatvec_f64(const void* data, const void* perm,
                               const void* colptr, int k, int block,
                               long long m, const void* r, void* y,
                               void* stream) {
  return launch_rmatvec<double>(data, perm, colptr, k, block, m, r, y,
                                stream);
}

// K7 by tile: data, perm, colptr, tiles, n_tiles, budget, max_cols, k,
// block, r, y, stream
int pyamg_windowed_rmatvec_tiles_f32(const void* data, const void* perm,
                                     const void* colptr, const void* tiles,
                                     int n_tiles, int budget, int max_cols,
                                     int k, int block, const void* r, void* y,
                                     void* stream) {
  return launch_rmatvec_tiles<float>(data, perm, colptr, tiles, n_tiles,
                                     budget, max_cols, k, block, r, y,
                                     stream);
}

int pyamg_windowed_rmatvec_tiles_f64(const void* data, const void* perm,
                                     const void* colptr, const void* tiles,
                                     int n_tiles, int budget, int max_cols,
                                     int k, int block, const void* r, void* y,
                                     void* stream) {
  return launch_rmatvec_tiles<double>(data, perm, colptr, tiles, n_tiles,
                                      budget, max_cols, k, block, r, y,
                                      stream);
}

// data, idx, starts, k, block, w2, n_rows, m, lanes, rows, x, y, stream
int pyamg_windowed_matmat_k_f32(const void* data, const void* idx,
                                const void* starts, int k, int block, int w2,
                                long long n_rows, long long m, int lanes,
                                int rows, const void* x, void* y,
                                void* stream) {
  return launch_matmat_k<float>(data, idx, starts, k, block, w2, n_rows, m,
                                lanes, rows, x, y, stream);
}

int pyamg_windowed_matmat_k_f64(const void* data, const void* idx,
                                const void* starts, int k, int block, int w2,
                                long long n_rows, long long m, int lanes,
                                int rows, const void* x, void* y,
                                void* stream) {
  return launch_matmat_k<double>(data, idx, starts, k, block, w2, n_rows, m,
                                 lanes, rows, x, y, stream);
}

// data, perm, colptr, tiles, n_tiles, budget, max_cols, k, block, n_rows,
// m, lanes, lt, r, y, stream
int pyamg_windowed_rmatmat_k_f32(const void* data, const void* perm,
                                 const void* colptr, const void* tiles,
                                 int n_tiles, int budget, int max_cols, int k,
                                 int block, long long n_rows, long long m,
                                 int lanes, int lt, const void* r, void* y,
                                 void* stream) {
  return launch_rmatmat_k<float>(data, perm, colptr, tiles, n_tiles, budget,
                                 max_cols, k, block, n_rows, m, lanes, lt, r,
                                 y, stream);
}

int pyamg_windowed_rmatmat_k_f64(const void* data, const void* perm,
                                 const void* colptr, const void* tiles,
                                 int n_tiles, int budget, int max_cols, int k,
                                 int block, long long n_rows, long long m,
                                 int lanes, int lt, const void* r, void* y,
                                 void* stream) {
  return launch_rmatmat_k<double>(data, perm, colptr, tiles, n_tiles, budget,
                                  max_cols, k, block, n_rows, m, lanes, lt, r,
                                  y, stream);
}

}  // extern "C"
