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
// and the transpose a scatter with atomics.
//
// Bound: device-memory bandwidth and, for the transpose, atomic
// throughput.  The forward pass reads data and idx (k * n * (sizeof(T) + 4)
// bytes), the starts and the window of x, and writes n values.  The
// slot-major layout makes each slot's data/idx loads coalesced across a
// warp, and the window of x a warp touches is narrow (rows of one block
// map into 2 * w2 contiguous source entries), so its gathers mostly hit
// L1/L2.
//
// The transpose runs one thread per (row, slot) and atomicAdds
// data * r into y[starts[b] * w2 + idx] on an output the wrapper zeroed.
// This replaces the TPU's VMEM-resident output accumulated over a
// sequential grid (window.py:253-293): blocks here run in no order, so
// overlapping windows meet in atomics.  Consequence: the float32 summation
// order changes from run to run.  Each output sums the entries of one
// column (for the SA tentative operator, one aggregate: about 9 terms at
// level 0), so the run-to-run spread is a few ulp of the sum of |terms|;
// tests hold the result against the ordered plain version to 1e-5 of
// max|y| in float32 (1e-12 in float64).  Structural zeros (data == 0,
// the padding rows) are skipped: they add nothing and would otherwise
// pile atomics onto one address.  A deterministic transpose is left for
// later.
//
// The K-lane forms take K-major lane stacks (the batched solve's layout):
// X (lanes, m_chunks * w2) -> Y (lanes, n_pad) forward, R (lanes, n_pad)
// -> Y (lanes, m_chunks * w2) transposed.  Each entry's data and idx are
// read once for all lanes of a launch (the point of the TPU kernels: the
// operator's bytes are paid once per batch instead of once per lane),
// the lanes loop inside the thread with a register accumulator of
// kMaxLanes (indexed only by unrolled constants), and a launch covers at
// most kMaxLanes lanes (the wrapper launches larger K in chunks).  The
// forward form keeps K6's indexed load; the transpose K7's atomicAdd
// scatter, one atomic per lane and entry, so its float32 sum order varies
// from run to run exactly as K7's does.  Bound: device-memory bandwidth,
// data and idx once (k * n * (sizeof(T) + 4) bytes) plus the K input and
// output rows.
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

template <typename T>
__global__ void windowed_rmatvec_kernel(const T* __restrict__ data,
                                        const int* __restrict__ idx,
                                        const int* __restrict__ starts, int k,
                                        int block, int w2, int64_t n_entries,
                                        const T* __restrict__ r,
                                        T* __restrict__ y) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const T a = data[e];
  if (a == T(0)) return;
  const int64_t per_block = static_cast<int64_t>(k) * block;
  const int64_t blk = e / per_block;
  const int64_t row = e % block;
  atomicAdd(&y[static_cast<int64_t>(starts[blk]) * w2 + idx[e]],
            a * r[blk * block + row]);
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
                                          const int* __restrict__ idx,
                                          const int* __restrict__ starts,
                                          int k, int block, int w2,
                                          int64_t n_rows, int64_t m,
                                          int lanes,
                                          const T* __restrict__ r,
                                          T* __restrict__ y) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_rows * k) return;
  const T a = data[e];
  if (a == T(0)) return;
  const int64_t per_block = static_cast<int64_t>(k) * block;
  const int64_t blk = e / per_block;
  const int64_t g = blk * block + e % block;
  const int64_t col = static_cast<int64_t>(starts[blk]) * w2 + idx[e];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    if (l < lanes)
      atomicAdd(&y[static_cast<int64_t>(l) * m + col],
                a * r[static_cast<int64_t>(l) * n_rows + g]);
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

template <typename T>
int launch_rmatvec(const void* data, const void* idx, const void* starts,
                   int k, int block, int w2, long long n_rows, const void* r,
                   void* y, void* stream) {
  const long long n_entries = n_rows * k;
  if (n_entries <= 0) return static_cast<int>(cudaSuccess);
  windowed_rmatvec_kernel<T><<<grid_for(n_entries), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(starts), k, block, w2, n_entries,
      static_cast<const T*>(r), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

// The K-lane launches: x (lanes, m) in, y (lanes, n_rows) out for the
// forward form; r (lanes, n_rows) in, y (lanes, m) accumulated (zeroed by
// the caller) for the transpose.
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
int launch_rmatmat_k(const void* data, const void* idx, const void* starts,
                     int k, int block, int w2, long long n_rows, long long m,
                     int lanes, const void* r, void* y, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_entries = n_rows * k;
  if (n_entries <= 0) return static_cast<int>(cudaSuccess);
  windowed_rmatmat_k_kernel<T><<<grid_for(n_entries), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(starts), k, block, w2, n_rows, m, lanes,
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

int pyamg_windowed_rmatvec_f32(const void* data, const void* idx,
                               const void* starts, int k, int block, int w2,
                               long long n_rows, const void* r, void* y,
                               void* stream) {
  return launch_rmatvec<float>(data, idx, starts, k, block, w2, n_rows, r, y,
                               stream);
}

int pyamg_windowed_rmatvec_f64(const void* data, const void* idx,
                               const void* starts, int k, int block, int w2,
                               long long n_rows, const void* r, void* y,
                               void* stream) {
  return launch_rmatvec<double>(data, idx, starts, k, block, w2, n_rows, r, y,
                                stream);
}

// data, idx, starts, k, block, w2, n_rows, m, lanes, x|r, y, stream
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

int pyamg_windowed_rmatmat_k_f32(const void* data, const void* idx,
                                 const void* starts, int k, int block,
                                 int w2, long long n_rows, long long m,
                                 int lanes, const void* r, void* y,
                                 void* stream) {
  return launch_rmatmat_k<float>(data, idx, starts, k, block, w2, n_rows, m,
                                 lanes, r, y, stream);
}

int pyamg_windowed_rmatmat_k_f64(const void* data, const void* idx,
                                 const void* starts, int k, int block,
                                 int w2, long long n_rows, long long m,
                                 int lanes, const void* r, void* y,
                                 void* stream) {
  return launch_rmatmat_k<double>(data, idx, starts, k, block, w2, n_rows,
                                  m, lanes, r, y, stream);
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
