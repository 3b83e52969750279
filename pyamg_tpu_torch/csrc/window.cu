// Windowed-ELL transfer-operator kernels of pyamg_tpu_torch, for Hopper
// (sm_90a).
//
//   windowed_matvec_kernel   replaces pyamg_tpu/sparse/window.py::WindowedELL._matvec_pallas
//   windowed_rmatvec_kernel  replaces pyamg_tpu/sparse/window.py::WindowedELL._rmatvec_pallas
//   windowed_matmat_k_kernel (K12)
//                            replaces pyamg_tpu/sparse/window.py::WindowedELL._matmat_pallas_k
//   windowed_rmatmat_k_kernel (K13)
//                            replaces pyamg_tpu/sparse/window.py::WindowedELL._rmatmat_pallas_k
//   windowed_select_kernel (K14)
//                            replaces pyamg_tpu/sparse/window.py::WindowedELL._select_pallas
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
// Bound: device-memory bandwidth.  The forward pass reads data and idx
// (k * n * (sizeof(T) + 4) bytes), the starts and the window of x, and
// writes n values.  The slot-major layout makes each slot's data/idx loads
// coalesced across a warp, and the window of x a warp touches is narrow
// (rows of one block map into 2 * w2 contiguous source entries), so its
// gathers mostly hit L1/L2.
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
// read back to the host), and one thread per output column sums that
// column's entries in ascending entry order and writes the column once.
// That is the order of the plain version's index_add_ on the CPU, and the
// products and sums are rounded separately (__fmul_rn / __fadd_rn, no FMA
// contraction), so the result is the same bit for bit from launch to
// launch, from run to run, and as the CPU plain version's.  Structural
// zeros (data == 0, the padding rows) sort past colptr[m], where no column
// reads: they add nothing.  No output is zeroed first: every column is
// written, an empty one with 0.  Bound: device-memory bandwidth, the live
// entries' data, perm and the r values they read (nnz * (2 * sizeof(T) +
// 4) bytes), colptr and y; the gathers of data and r through perm are the
// price of the fixed order.
//
// The K-lane forms take K-major lane stacks (the batched solve's layout):
// X (lanes, m_chunks * w2) -> Y (lanes, n_pad) forward, R (lanes, n_pad)
// -> Y (lanes, m_chunks * w2) transposed.  Each entry's data and idx (or
// plan slot) are read once for all lanes of a launch (the point of the
// TPU kernels: the operator's bytes are paid once per batch instead of
// once per lane), the lanes loop inside the thread with a register
// accumulator of kMaxLanes (indexed only by unrolled constants), and a
// launch covers at most kMaxLanes lanes (the wrapper launches larger K in
// chunks).  The forward form (K12) keeps K6's indexed load; the transpose
// (K13) K7's column plan, one thread per column summing each lane in
// ascending entry order, so it too is the same on every run and equals
// the CPU plain version lane by lane.  Bound: device-memory bandwidth,
// the operator's bytes once plus the K input and output rows.
//
// The select (K14) reads x at every entry's column and writes it to that
// entry's slot: out[b, s, row] = x[starts[b] * w2 + idx[b, s, row]], one
// thread per entry, no arithmetic.  The TPU resolved the index by a
// one-hot product through a three-way bf16 split of x (exact for integers
// below 2^24, within 2^-26 relative otherwise); here the load is exact for
// every payload, so the unstructured setup's integer payloads (coarse
// indices, cumulative root counts riding float32) and its finite sentinels
// come back unchanged.  x is the payload's own dtype, not the operator's:
// the setup selects float32 indices from a float64 operator.  Bound:
// device-memory bandwidth, idx read and out written once (k * n * (4 +
// sizeof(T)) bytes) plus the starts and the window of x.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxLanes = 16;

// a * b + c with the product and the sum each rounded (no FMA), the
// plain version's arithmetic
__device__ __forceinline__ float mul_add_rn(float a, float b, float c) {
  return __fadd_rn(c, __fmul_rn(a, b));
}
__device__ __forceinline__ double mul_add_rn(double a, double b, double c) {
  return __dadd_rn(c, __dmul_rn(a, b));
}

template <typename T>
__global__ void windowed_matvec_kernel(const T* __restrict__ data,
                                       const int* __restrict__ idx,
                                       const int* __restrict__ starts, int k,
                                       int block, int w2, int64_t n_rows,
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

// the row of entry e of the slot-major (n_blocks, k, block) layout
__device__ __forceinline__ int64_t entry_row(int64_t e, int64_t per_block,
                                             int block) {
  return (e / per_block) * block + e % block;
}

template <typename T>
__global__ void windowed_rmatvec_kernel(const T* __restrict__ data,
                                        const int* __restrict__ perm,
                                        const int* __restrict__ colptr, int k,
                                        int block, int64_t m,
                                        const T* __restrict__ r,
                                        T* __restrict__ y) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= m) return;
  const int64_t per_block = static_cast<int64_t>(k) * block;
  T acc = T(0);
  for (int j = colptr[c], j1 = colptr[c + 1]; j < j1; ++j) {
    const int64_t e = perm[j];
    acc = mul_add_rn(data[e], r[entry_row(e, per_block, block)], acc);
  }
  y[c] = acc;
}

template <typename T>
__global__ void windowed_matmat_k_kernel(const T* __restrict__ data,
                                         const int* __restrict__ idx,
                                         const int* __restrict__ starts,
                                         int k, int block, int w2,
                                         int64_t n_rows, int64_t m,
                                         int lanes, const T* __restrict__ x,
                                         T* __restrict__ y) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_rows) return;
  const int64_t blk = g / block;
  const int64_t row = g - blk * block;
  const int64_t base = static_cast<int64_t>(starts[blk]) * w2;
  const int64_t e0 = blk * k * block + row;
  T acc[kMaxLanes];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) acc[l] = T(0);
  for (int s = 0; s < k; ++s) {
    const int64_t e = e0 + static_cast<int64_t>(s) * block;
    const T a = data[e];
    const int64_t col = base + idx[e];
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l) {
      if (l < lanes) acc[l] += a * x[static_cast<int64_t>(l) * m + col];
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    if (l < lanes) y[static_cast<int64_t>(l) * n_rows + g] = acc[l];
  }
}

template <typename T>
__global__ void windowed_rmatmat_k_kernel(const T* __restrict__ data,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ colptr,
                                          int k, int block, int64_t n_rows,
                                          int64_t m, int lanes,
                                          const T* __restrict__ r,
                                          T* __restrict__ y) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= m) return;
  const int64_t per_block = static_cast<int64_t>(k) * block;
  T acc[kMaxLanes];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) acc[l] = T(0);
  for (int j = colptr[c], j1 = colptr[c + 1]; j < j1; ++j) {
    const int64_t e = perm[j];
    const T a = data[e];
    const int64_t g = entry_row(e, per_block, block);
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l) {
      if (l < lanes)
        acc[l] = mul_add_rn(a, r[static_cast<int64_t>(l) * n_rows + g],
                            acc[l]);
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    if (l < lanes) y[static_cast<int64_t>(l) * m + c] = acc[l];
  }
}

template <typename T>
__global__ void windowed_select_kernel(const int* __restrict__ idx,
                                       const int* __restrict__ starts, int k,
                                       int block, int w2, int64_t n_entries,
                                       const T* __restrict__ x,
                                       T* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int64_t blk = e / (static_cast<int64_t>(k) * block);
  out[e] = x[static_cast<int64_t>(starts[blk]) * w2 + idx[e]];
}

constexpr int kThreads = 256;

inline unsigned int grid_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_matvec(const void* data, const void* idx, const void* starts, int k,
                  int block, int w2, long long n_rows, const void* x, void* y,
                  void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  windowed_matvec_kernel<T><<<grid_for(n_rows), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(starts), k, block, w2, n_rows,
      static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

// The transposes: one thread per output column c < m, the column's live
// entries perm[colptr[c] .. colptr[c + 1]) in ascending entry order.
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

// The K-lane launches: x (lanes, m) in, y (lanes, n_rows) out for the
// forward form; r (lanes, n_rows) in, y (lanes, m) out for the transpose.
template <typename T>
int launch_matmat_k(const void* data, const void* idx, const void* starts,
                    int k, int block, int w2, long long n_rows, long long m,
                    int lanes, const void* x, void* y, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  windowed_matmat_k_kernel<T><<<grid_for(n_rows), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(starts), k, block, w2, n_rows, m, lanes,
      static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rmatmat_k(const void* data, const void* perm, const void* colptr,
                     int k, int block, long long n_rows, long long m,
                     int lanes, const void* r, void* y, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m <= 0) return static_cast<int>(cudaSuccess);
  windowed_rmatmat_k_kernel<T><<<grid_for(m), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(perm),
      static_cast<const int*>(colptr), k, block, n_rows, m, lanes,
      static_cast<const T*>(r), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_select(const void* idx, const void* starts, int k, int block,
                  int w2, long long n_rows, const void* x, void* out,
                  void* stream) {
  const long long n_entries = n_rows * k;
  if (n_entries <= 0) return static_cast<int>(cudaSuccess);
  windowed_select_kernel<T><<<grid_for(n_entries), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const int*>(starts), k, block,
      w2, n_entries, static_cast<const T*>(x), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pyamg_windowed_matvec_f32(const void* data, const void* idx,
                              const void* starts, int k, int block, int w2,
                              long long n_rows, const void* x, void* y,
                              void* stream) {
  return launch_matvec<float>(data, idx, starts, k, block, w2, n_rows, x, y,
                              stream);
}

int pyamg_windowed_matvec_f64(const void* data, const void* idx,
                              const void* starts, int k, int block, int w2,
                              long long n_rows, const void* x, void* y,
                              void* stream) {
  return launch_matvec<double>(data, idx, starts, k, block, w2, n_rows, x, y,
                               stream);
}

// data, perm, colptr, k, block, m, r, y, stream
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

// data, idx, starts, k, block, w2, n_rows, m, lanes, x, y, stream
int pyamg_windowed_matmat_k_f32(const void* data, const void* idx,
                                const void* starts, int k, int block, int w2,
                                long long n_rows, long long m, int lanes,
                                const void* x, void* y, void* stream) {
  return launch_matmat_k<float>(data, idx, starts, k, block, w2, n_rows, m,
                                lanes, x, y, stream);
}

int pyamg_windowed_matmat_k_f64(const void* data, const void* idx,
                                const void* starts, int k, int block, int w2,
                                long long n_rows, long long m, int lanes,
                                const void* x, void* y, void* stream) {
  return launch_matmat_k<double>(data, idx, starts, k, block, w2, n_rows, m,
                                 lanes, x, y, stream);
}

// data, perm, colptr, k, block, n_rows, m, lanes, r, y, stream
int pyamg_windowed_rmatmat_k_f32(const void* data, const void* perm,
                                 const void* colptr, int k, int block,
                                 long long n_rows, long long m, int lanes,
                                 const void* r, void* y, void* stream) {
  return launch_rmatmat_k<float>(data, perm, colptr, k, block, n_rows, m,
                                 lanes, r, y, stream);
}

int pyamg_windowed_rmatmat_k_f64(const void* data, const void* perm,
                                 const void* colptr, int k, int block,
                                 long long n_rows, long long m, int lanes,
                                 const void* r, void* y, void* stream) {
  return launch_rmatmat_k<double>(data, perm, colptr, k, block, n_rows, m,
                                  lanes, r, y, stream);
}

// idx, starts, k, block, w2, n_rows, x, out, stream
int pyamg_windowed_select_f32(const void* idx, const void* starts, int k,
                              int block, int w2, long long n_rows,
                              const void* x, void* out, void* stream) {
  return launch_select<float>(idx, starts, k, block, w2, n_rows, x, out,
                              stream);
}

int pyamg_windowed_select_f64(const void* idx, const void* starts, int k,
                              int block, int w2, long long n_rows,
                              const void* x, void* out, void* stream) {
  return launch_select<double>(idx, starts, k, block, w2, n_rows, x, out,
                               stream);
}

}  // extern "C"
