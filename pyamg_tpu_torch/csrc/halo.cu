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
// first `halo` entries (j >= n_local).  The kernel reads each source in
// place, so the TPU kernel's copy of x into an extended VMEM buffer
// (pallas_halo.py:89-95) goes away, and a halo can be a received buffer
// or a view into another shard's x.
//
// The rows go in row blocks of 256 * VEC, one CTA each, VEC rows a thread:
// 4 float32 rows in 16-byte loads and stores where n_local is a multiple
// of 4 and data, x and y are 16-byte aligned, else 1 (float64, odd
// blocks).  The wrapper's plan (parallel/halo_spmv.py::halo_plan) names
// the interior row blocks [lo, hi), whose every neighbour, with VEC - 1
// rows to spare for the aligned 16-byte runs (csrc/lane_io.cuh::ld_x),
// lies in [0, n_local): those read x only, with no select and no check.
// The other row blocks pick the source per term, as the TPU kernel's
// extended buffer does by position.  A launch covers the row blocks
// [a0, a1) and [b0, b1): a ring of one (no exchange: its halos are x's
// own tail and head) takes one launch over every block; with an exchange
// the wrapper follows the TPU kernel's order (pallas_halo.py:97-139): it
// starts the exchange, launches the interior blocks, which read only x,
// while it runs, waits for it, and launches the boundary blocks of both
// ends in one launch.
//
// ND, when not 0, fixes the diagonal count (5 and 7, the 2-D and 3-D
// grids' levels), so the term loop unrolls and a row's loads go out
// together, and the offsets arrive as a kernel argument; the run-time
// form stages them in shared memory, one load a thread from the device
// array (a level may hold up to 600 diagonals), never a load per term.
//
// The ring wraps around: the first block's left halo is the last block's
// tail, and with one block the halos are x's own tail and head.  A data
// slot whose column falls outside the matrix holds a structural zero, so
// its term adds exactly 0 (fma(0, x_j, acc) = acc for a finite x_j): the
// result is K1's (csrc/dia.cu, which skips those terms) bit for bit.  The
// diagonals are summed in offset order, one FMA a term (what nvcc made of
// K1's acc += a * x_j), in every form.
//
// Bound: device-memory bandwidth, as K1: the nd diagonals and x read and
// y written once ((nd + 2) * n_local * sizeof(T) bytes at 2 flops per
// stored entry).  The diagonals stream through L2 evict-first (read once),
// so x's runs, read nd times, stay there.

#include <cuda_runtime.h>
#include <cstdint>

#include "lane_io.cuh"

namespace {

constexpr int kThreads = 256;

// the offsets of the unrolled forms, a kernel argument
template <int ND>
struct HaloOffsets {
  int o[ND > 0 ? ND : 1];
};

// rows [i0, i0 + VEC) of the block; INTERIOR: every neighbour run (and
// the aligned runs around it) lies in [0, n_local)
template <typename T, int ND, int VEC, bool INTERIOR>
__device__ __forceinline__ void halo_rows(const T* __restrict__ data,
                                          int64_t ld, const int* offs,
                                          int nd, int64_t n_local, int halo,
                                          const T* __restrict__ left,
                                          const T* __restrict__ x,
                                          const T* __restrict__ right,
                                          int64_t i0, T* __restrict__ y) {
  T acc[VEC];
#pragma unroll
  for (int t = 0; t < VEC; ++t) acc[t] = T(0);
  const int n_d = ND > 0 ? ND : nd;
#pragma unroll
  for (int d = 0; d < n_d; ++d) {
    const int o = offs[d];
    T a[VEC];
    ld_vec<T, VEC, true>(a, data + static_cast<int64_t>(d) * ld + i0);
    if (INTERIOR) {
      T xv[VEC];
      ld_x<T, VEC>(xv, x + i0 + o, o);
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = fma_rn(a[t], xv[t], acc[t]);
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const int64_t j = i0 + t + o;
        const T xj = j < 0 ? left[halo + j]
                           : (j < n_local ? x[j] : right[j - n_local]);
        acc[t] = fma_rn(a[t], xj, acc[t]);
      }
    }
  }
  st_vec<T, VEC, false>(y + i0, acc);
}

// K16 over the row blocks [a0, a1) and [b0, b1) (see the header); the row
// blocks [lo, hi) are interior.  offsets: the device array the run-time
// form (ND 0) stages in shared memory.
template <typename T, int ND, int VEC>
__global__ void __launch_bounds__(kThreads)
halo_spmv_kernel(const T* __restrict__ data, int64_t ld, HaloOffsets<ND> offs,
                 const int* __restrict__ offsets, int nd, int64_t n_local,
                 int halo, const T* __restrict__ left,
                 const T* __restrict__ x, const T* __restrict__ right,
                 int lo, int hi, int a0, int a1, int b0,
                 T* __restrict__ y) {
  const int bid = static_cast<int>(blockIdx.x);
  const int na = a1 - a0;
  const int rb = bid < na ? a0 + bid : b0 + (bid - na);
  const int64_t i0 = static_cast<int64_t>(rb) * (kThreads * VEC) +
                     static_cast<int64_t>(threadIdx.x) * VEC;
  const int* o;
  if constexpr (ND > 0) {
    o = offs.o;
  } else {
    extern __shared__ int s_offs[];
    for (int d = static_cast<int>(threadIdx.x); d < nd; d += kThreads) {
      s_offs[d] = offsets[d];
    }
    __syncthreads();
    o = s_offs;
  }
  if (i0 >= n_local) return;
  if (rb >= lo && rb < hi) {
    halo_rows<T, ND, VEC, true>(data, ld, o, nd, n_local, halo, left, x,
                                right, i0, y);
  } else {
    halo_rows<T, ND, VEC, false>(data, ld, o, nd, n_local, halo, left, x,
                                 right, i0, y);
  }
}

// a shared-memory budget for the staged offsets without opting in
constexpr int kMaxStagedDiags = 48 * 1024 / 4;

template <typename T, int ND, int VEC>
int launch_halo(const void* data, long long ld, const int* offsets,
                const void* offsets_dev, int nd, long long n_local, int halo,
                const void* left, const void* x, const void* right, int lo,
                int hi, int a0, int a1, int b0, int b1, void* y,
                cudaStream_t s) {
  HaloOffsets<ND> offs{};
  if constexpr (ND > 0) {
    for (int d = 0; d < ND; ++d) offs.o[d] = offsets[d];
  }
  const size_t smem = ND > 0 ? 0 : static_cast<size_t>(nd) * sizeof(int);
  const unsigned int blocks = static_cast<unsigned int>((a1 - a0) + (b1 - b0));
  halo_spmv_kernel<T, ND, VEC><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(data), ld, offs,
      static_cast<const int*>(offsets_dev), nd, n_local, halo,
      static_cast<const T*>(left), static_cast<const T*>(x),
      static_cast<const T*>(right), lo, hi, a0, a1, b0, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_halo_nd(const void* data, long long ld, const int* offsets,
                   const void* offsets_dev, int nd, long long n_local,
                   int halo, const void* left, const void* x,
                   const void* right, int lo, int hi, int a0, int a1, int b0,
                   int b1, void* y, cudaStream_t s) {
#define PYAMG_K16(ND)                                                       \
  return launch_halo<T, ND, VEC>(data, ld, offsets, offsets_dev, nd,        \
                                 n_local, halo, left, x, right, lo, hi, a0, \
                                 a1, b0, b1, y, s)
  if (nd == 5) PYAMG_K16(5);
  if (nd == 7) PYAMG_K16(7);
  PYAMG_K16(0);
#undef PYAMG_K16
}

template <typename T>
int launch_halo_vec(const void* data, long long ld, const int* offsets,
                    const void* offsets_dev, int nd, long long n_local,
                    int halo, const void* left, const void* x,
                    const void* right, int vec, int lo, int hi, int a0,
                    int a1, int b0, int b1, void* y, void* stream) {
  const long long rows = static_cast<long long>(kThreads) * vec;
  const long long row_blocks = (n_local + rows - 1) / rows;
  if (nd < 1 || nd > kMaxStagedDiags || halo < 1 || halo > n_local ||
      ld < n_local || !(vec == 1 || (vec == 4 && sizeof(T) == 4)) ||
      n_local % vec != 0 || row_blocks >= (1LL << 31) || lo < 0 ||
      hi < lo || hi > row_blocks || a0 < 0 || a1 < a0 || b0 < a1 ||
      b1 < b0 || b1 > row_blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int d = 0; d < nd; ++d) {
    if (offsets[d] < -halo || offsets[d] > halo) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (a1 - a0 + b1 - b0 == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) {
      return launch_halo_nd<T, 4>(data, ld, offsets, offsets_dev, nd,
                                  n_local, halo, left, x, right, lo, hi, a0,
                                  a1, b0, b1, y, s);
    }
  }
  return launch_halo_nd<T, 1>(data, ld, offsets, offsets_dev, nd, n_local,
                              halo, left, x, right, lo, hi, a0, a1, b0, b1, y,
                              s);
}

}  // namespace

extern "C" {

// data, ld (data's row stride), offsets (a host array of nd ints),
// offsets_dev (the same on the device), nd, n_local, halo, left, x, right,
// vec (rows a thread: 4, float32 only, with n_local a multiple of 4 and
// data, ld, x and y 16-byte aligned; or 1), lo, hi (the interior row
// blocks of 256 * vec rows), a0, a1, b0, b1 (the row blocks to compute:
// [a0, a1) and [b0, b1)), y, stream
int pyamg_halo_spmv_f32(const void* data, long long ld, const int* offsets,
                        const void* offsets_dev, int nd, long long n_local,
                        int halo, const void* left, const void* x,
                        const void* right, int vec, int lo, int hi, int a0,
                        int a1, int b0, int b1, void* y, void* stream) {
  return launch_halo_vec<float>(data, ld, offsets, offsets_dev, nd, n_local,
                                halo, left, x, right, vec, lo, hi, a0, a1,
                                b0, b1, y, stream);
}

int pyamg_halo_spmv_f64(const void* data, long long ld, const int* offsets,
                        const void* offsets_dev, int nd, long long n_local,
                        int halo, const void* left, const void* x,
                        const void* right, int vec, int lo, int hi, int a0,
                        int a1, int b0, int b1, void* y, void* stream) {
  return launch_halo_vec<double>(data, ld, offsets, offsets_dev, nd,
                                 n_local, halo, left, x, right, vec, lo, hi,
                                 a0, a1, b0, b1, y, stream);
}

}  // extern "C"
