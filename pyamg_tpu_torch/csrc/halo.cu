// Row-sharded DIA SpMV with the halo read in place (K16) of
// pyamg_tpu_torch, for Hopper (sm_90a).
//
//   halo_spmv_kernel  replaces pyamg_tpu/parallel/pallas_halo.py::make_pallas_halo_spmv
//                     (one vector), and on K lanes the arithmetic of
//                     pyamg_tpu/sparse/dia.py::_dia_pallas_matmat_k on a
//                     rank's rows (the reference's sharded batched apply)
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
// The K-lane mode (a batched solve's K-major (K, n_local) stacks, x and y
// lane k at k * ldx, ldx = n_local or, for a row block of a wider stack,
// its width; the halos (K, halo) stacks whose lanes lie ldl and ldr
// values apart: a received buffer, ldl = halo, or in a ring of one x's
// own tail and head, ldl = n_local) puts the lane on the grid as
// K8 does (csrc/dia_k.cu::dia_k_lane_kernel): a CTA streams one lane's
// row block, and the CTAs walk super tiles of the launch's row blocks (128
// in float32, 1 in float64, K8's), the lanes of a tile one after another,
// so the tile's diagonals are read from device memory once for all K
// lanes; with K8's cache policy (the diagonals kept in L2, y stored
// evict-first), not the one-vector form's.  Every lane in one launch,
// one exchange a side for all lanes.  A lane's value is the one-vector
// form's, so in a ring of one the mode
// gives K8's bits (K8 skips an out-of-range term, this adds its stored
// zero, fma(0, x_j, acc) = acc).  Bound: (nd + 2K) n_local values.
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
// stored entry).  One vector streams the diagonals through L2 evict-first
// (read once), so x's runs, read nd times, stay there.

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

// launch row blocks a super tile of the lane form (K8's: 128 in float32,
// 1 in float64)
template <typename T>
struct HaloSuper {
  static constexpr int value = sizeof(T) == 4 ? 128 : 1;
};

// rows [i0, i0 + VEC) of the block; INTERIOR: every neighbour run (and
// the aligned runs around it) lies in [0, n_local).  LANES: the lane
// mode's cache policy (K8's): the diagonals, read again by the tile's
// other lanes, stay in L2 and y leaves evict-first; one vector streams
// the diagonals evict-first instead, so that x's runs stay
template <typename T, int ND, int VEC, bool INTERIOR, bool LANES>
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
    ld_vec<T, VEC, !LANES>(a, data + static_cast<int64_t>(d) * ld + i0);
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
  st_vec<T, VEC, LANES>(y + i0, acc);
}

// K16 over the row blocks [a0, a1) and [b0, b1) of each of `lanes` lanes
// (see the header); the row blocks [lo, hi) are interior.  The launch's
// row blocks, [a0, a1) then [b0, b1), are nrb in all; the CTAs walk super
// tiles of SUPER of them, the lanes of a tile one after another (K8's
// order, csrc/dia_k.cu::dia_k_lane_kernel), so a tile's diagonals come
// from device memory once and from L2 for the other lanes.  Lane k's x
// and y start k * ldx values in, its halos k * ldl and k * ldr.
// offsets: the device array the run-time form (ND 0) stages in shared
// memory.
template <typename T, int ND, int VEC, bool LANES>
__global__ void __launch_bounds__(kThreads)
halo_spmv_kernel(const T* __restrict__ data, int64_t ld, HaloOffsets<ND> offs,
                 const int* __restrict__ offsets, int nd, int64_t n_local,
                 int halo, const T* __restrict__ left, int64_t ldl,
                 const T* __restrict__ x, int64_t ldx,
                 const T* __restrict__ right, int64_t ldr, int lanes,
                 int lo, int hi, int a0, int a1, int b0, int nrb,
                 T* __restrict__ y) {
  const int bid = static_cast<int>(blockIdx.x);
  // one vector: the CTA's row block is its index, with no division
  int k = 0, v = bid;
  if constexpr (LANES) {
    constexpr int SUPER = HaloSuper<T>::value;
    const int st = bid / (SUPER * lanes);
    const int base = st * SUPER;
    const int tile = min(SUPER, nrb - base);
    const int rem = bid - st * SUPER * lanes;
    k = rem / tile;
    v = base + rem - k * tile;
  }
  const int na = a1 - a0;
  const int rb = v < na ? a0 + v : b0 + (v - na);
  const int64_t i0 = static_cast<int64_t>(rb) * (kThreads * VEC) +
                     static_cast<int64_t>(threadIdx.x) * VEC;
  const int64_t lane = static_cast<int64_t>(k) * ldx;
  const T* xl = x + lane;
  const T* ll = left + static_cast<int64_t>(k) * ldl;
  const T* rl = right + static_cast<int64_t>(k) * ldr;
  T* yl = y + lane;
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
    halo_rows<T, ND, VEC, true, LANES>(data, ld, o, nd, n_local, halo, ll,
                                       xl, rl, i0, yl);
  } else {
    halo_rows<T, ND, VEC, false, LANES>(data, ld, o, nd, n_local, halo, ll,
                                        xl, rl, i0, yl);
  }
}

// a shared-memory budget for the staged offsets without opting in
constexpr int kMaxStagedDiags = 48 * 1024 / 4;

template <typename T, int ND, int VEC>
int launch_halo(const void* data, long long ld, const int* offsets,
                const void* offsets_dev, int nd, long long n_local, int halo,
                const void* left, long long ldl, const void* x,
                long long ldx, const void* right, long long ldr, int lanes,
                int lo, int hi, int a0, int a1, int b0, int b1, void* y,
                cudaStream_t s) {
  HaloOffsets<ND> offs{};
  if constexpr (ND > 0) {
    for (int d = 0; d < ND; ++d) offs.o[d] = offsets[d];
  }
  const size_t smem = ND > 0 ? 0 : static_cast<size_t>(nd) * sizeof(int);
  const int nrb = (a1 - a0) + (b1 - b0);
  const unsigned int blocks = static_cast<unsigned int>(
      static_cast<long long>(nrb) * lanes);
  auto kernel = lanes > 1 ? halo_spmv_kernel<T, ND, VEC, true>
                          : halo_spmv_kernel<T, ND, VEC, false>;
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(data), ld, offs,
      static_cast<const int*>(offsets_dev), nd, n_local, halo,
      static_cast<const T*>(left), ldl, static_cast<const T*>(x), ldx,
      static_cast<const T*>(right), ldr, lanes, lo, hi, a0, a1, b0, nrb,
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_halo_nd(const void* data, long long ld, const int* offsets,
                   const void* offsets_dev, int nd, long long n_local,
                   int halo, const void* left, long long ldl, const void* x,
                   long long ldx, const void* right, long long ldr,
                   int lanes, int lo, int hi, int a0, int a1, int b0, int b1,
                   void* y, cudaStream_t s) {
#define PYAMG_K16(ND)                                                       \
  return launch_halo<T, ND, VEC>(data, ld, offsets, offsets_dev, nd,        \
                                 n_local, halo, left, ldl, x, ldx, right,   \
                                 ldr, lanes, lo, hi, a0, a1, b0, b1, y, s)
  if (nd == 5) PYAMG_K16(5);
  if (nd == 7) PYAMG_K16(7);
  PYAMG_K16(0);
#undef PYAMG_K16
}

template <typename T>
int launch_halo_vec(const void* data, long long ld, const int* offsets,
                    const void* offsets_dev, int nd, long long n_local,
                    int halo, const void* left, long long ldl, const void* x,
                    long long ldx, const void* right, long long ldr,
                    int lanes, int vec, int lo, int hi, int a0, int a1,
                    int b0, int b1, void* y, void* stream) {
  const long long rows = static_cast<long long>(kThreads) * vec;
  const long long row_blocks = (n_local + rows - 1) / rows;
  const long long nrb = static_cast<long long>(a1 - a0) + (b1 - b0);
  if (nd < 1 || nd > kMaxStagedDiags || halo < 1 || halo > n_local ||
      ld < n_local || !(vec == 1 || (vec == 4 && sizeof(T) == 4)) ||
      n_local % vec != 0 || row_blocks >= (1LL << 31) || lo < 0 ||
      hi < lo || hi > row_blocks || a0 < 0 || a1 < a0 || b0 < a1 ||
      b1 < b0 || b1 > row_blocks || lanes < 1 ||
      nrb * lanes >= (1LL << 31) ||
      (lanes > 1 && (ldl < halo || ldr < halo || ldx < n_local ||
                     ldx % vec != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int d = 0; d < nd; ++d) {
    if (offsets[d] < -halo || offsets[d] > halo) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (nrb == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) {
      return launch_halo_nd<T, 4>(data, ld, offsets, offsets_dev, nd,
                                  n_local, halo, left, ldl, x, ldx, right,
                                  ldr, lanes, lo, hi, a0, a1, b0, b1, y, s);
    }
  }
  return launch_halo_nd<T, 1>(data, ld, offsets, offsets_dev, nd, n_local,
                              halo, left, ldl, x, ldx, right, ldr, lanes, lo,
                              hi, a0, a1, b0, b1, y, s);
}

}  // namespace

extern "C" {

// data, ld (data's row stride), offsets (a host array of nd ints),
// offsets_dev (the same on the device), nd, n_local, halo, left, ldl
// (values between its lanes), x, ldx (values between the lanes of x and
// y), right, ldr, lanes (x and y K-major stacks of n_local values a
// lane, a vector for 1), vec (rows a thread: 4, float32 only, with
// n_local and ldx multiples of 4 and data, ld, x and y 16-byte aligned;
// or 1), lo, hi (the interior row blocks of 256 * vec rows), a0,
// a1, b0, b1 (the row blocks to compute: [a0, a1) and [b0, b1)), y,
// stream
int pyamg_halo_spmv_f32(const void* data, long long ld, const int* offsets,
                        const void* offsets_dev, int nd, long long n_local,
                        int halo, const void* left, long long ldl,
                        const void* x, long long ldx, const void* right,
                        long long ldr, int lanes, int vec, int lo, int hi,
                        int a0, int a1, int b0, int b1, void* y,
                        void* stream) {
  return launch_halo_vec<float>(data, ld, offsets, offsets_dev, nd, n_local,
                                halo, left, ldl, x, ldx, right, ldr, lanes,
                                vec, lo, hi, a0, a1, b0, b1, y, stream);
}

int pyamg_halo_spmv_f64(const void* data, long long ld, const int* offsets,
                        const void* offsets_dev, int nd, long long n_local,
                        int halo, const void* left, long long ldl,
                        const void* x, long long ldx, const void* right,
                        long long ldr, int lanes, int vec, int lo, int hi,
                        int a0, int a1, int b0, int b1, void* y,
                        void* stream) {
  return launch_halo_vec<double>(data, ld, offsets, offsets_dev, nd,
                                 n_local, halo, left, ldl, x, ldx, right,
                                 ldr, lanes, vec, lo, hi, a0, a1, b0, b1, y,
                                 stream);
}

}  // extern "C"
