// Row-sharded DIA SpMV with the halo read in place (K16) of
// pyamg_tpu_torch, for Hopper (sm_90a).
//
//   halo_spmv_kernel  replaces pyamg_tpu/parallel/pallas_halo.py::make_pallas_halo_spmv
//
// One rank (or one shard) owns rows [0, n_local) of a DIA operator whose
// offsets all lie in [-halo, halo]: data is (nd, ld) row-major with
// data[d, i] = A[row0 + i, row0 + i + offsets[d]] for the block's first
// global row row0, zero where A has no entry or the column falls outside
// the matrix.  Row i needs x at local positions i + offsets[d], which
// fall in one of three sources: the left neighbour's last `halo` entries
// (j < 0), the local block x (0 <= j < n_local) or the right neighbour's
// first `halo` entries (j >= n_local).  The kernel picks the source by
// index, so the TPU kernel's copy of x into an extended VMEM buffer
// (pallas_halo.py:89-95) goes away, and a halo can be a received buffer
// or a view into another shard's x.
//
// The launch covers the rows [a0, a1) and [b0, b1), one thread per row:
// the wrapper (parallel/halo_spmv.py) follows the TPU kernel's order
// (pallas_halo.py:97-139): it starts the halo exchange, launches the
// interior rows [halo, n_local - halo), which read only x, while the
// exchange runs, waits for it, and launches the two boundary ranges
// [0, halo) and [n_local - halo, n_local) in one launch.
//
// The ring wraps around: the first block's left halo is the last block's
// tail, and with one block the halos are x's own tail and head.  A data
// slot whose column falls outside the matrix holds a structural zero, so
// its term adds exactly 0 (0 * x_j = 0 and fma(0, x_j, acc) = acc for a
// finite x_j): the result is K1's (csrc/dia.cu, which skips those terms)
// bit for bit.  The diagonals are summed in offset order with FMA
// contraction, as K1 does.
//
// Bound: device-memory bandwidth, as K1: the nd diagonals and x read and
// y written once ((nd + 2) * n_local * sizeof(T) bytes at 2 flops per
// stored entry).  Neighbouring threads read neighbouring addresses of
// data[d] and of the shifted source, so each warp issues full 128-byte
// transactions; the shifted re-reads of x hit L1/L2.  Overlap: the
// interior launch holds the card while the boundary slices travel; the
// boundary launch covers 2 * halo rows, a few thousand at most.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void halo_spmv_kernel(const T* __restrict__ data, int64_t ld,
                                 const int* __restrict__ offsets, int nd,
                                 int64_t n_local, int halo,
                                 const T* __restrict__ left,
                                 const T* __restrict__ x,
                                 const T* __restrict__ right, int64_t a0,
                                 int64_t a1, int64_t b0, int64_t b1,
                                 T* __restrict__ y) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t na = a1 - a0;
  const int64_t i = t < na ? a0 + t : b0 + (t - na);
  if (t >= na && i >= b1) return;
  T acc = T(0);
  for (int d = 0; d < nd; ++d) {
    const int64_t j = i + offsets[d];
    const T xj = j < 0 ? left[halo + j]
                       : (j < n_local ? x[j] : right[j - n_local]);
    acc += data[static_cast<int64_t>(d) * ld + i] * xj;
  }
  y[i] = acc;
}

constexpr int kThreads = 256;

template <typename T>
int launch_halo(const void* data, long long ld, const void* offsets, int nd,
                long long n_local, int halo, const void* left, const void* x,
                const void* right, long long a0, long long a1, long long b0,
                long long b1, void* y, void* stream) {
  if (a0 < 0 || a1 < a0 || b1 < b0 || b0 < a1 || b1 > n_local || halo < 1 ||
      halo > n_local || ld < n_local) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = (a1 - a0) + (b1 - b0);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const unsigned int blocks =
      static_cast<unsigned int>((rows + kThreads - 1) / kThreads);
  halo_spmv_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), ld, static_cast<const int*>(offsets), nd,
      n_local, halo, static_cast<const T*>(left), static_cast<const T*>(x),
      static_cast<const T*>(right), a0, a1, b0, b1, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data, ld, offsets, nd, n_local, halo, left, x, right, a0, a1, b0, b1, y,
// stream
int pyamg_halo_spmv_f32(const void* data, long long ld, const void* offsets,
                        int nd, long long n_local, int halo, const void* left,
                        const void* x, const void* right, long long a0,
                        long long a1, long long b0, long long b1, void* y,
                        void* stream) {
  return launch_halo<float>(data, ld, offsets, nd, n_local, halo, left, x,
                            right, a0, a1, b0, b1, y, stream);
}

int pyamg_halo_spmv_f64(const void* data, long long ld, const void* offsets,
                        int nd, long long n_local, int halo, const void* left,
                        const void* x, const void* right, long long a0,
                        long long a1, long long b0, long long b1, void* y,
                        void* stream) {
  return launch_halo<double>(data, ld, offsets, nd, n_local, halo, left, x,
                             right, a0, a1, b0, b1, y, stream);
}

}  // extern "C"
