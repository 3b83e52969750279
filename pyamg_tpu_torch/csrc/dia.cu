// DIA (diagonal-stored) operator kernels of pyamg_tpu_torch, for Hopper
// (sm_90a).
//
// One kernel template, dia_kernel<T, Mode>, replaces three TPU kernels of
// the JAX package, K1 in its three epilogue modes:
//   SPMV            y = A x                          pyamg_tpu/sparse/dia.py::_dia_pallas_matvec (plain mode)
//   SPMV_SCALED     y = s * (A x)                    pyamg_tpu/sparse/dia.py::_dia_pallas_matvec (scale=, via dia_spmv_scaled)
//   SPMV_ADD        y = v + A x                      pyamg_tpu/sparse/dia.py::_dia_pallas_matvec (addv=, via dia_spmv_add)
//   JACOBI          y = x + w * dinv * (b - A x)     pyamg_tpu/sparse/dia.py::dia_pallas_jacobi
//   JACOBI_ZERO_RES x = w * dinv * b, r = b - A x    pyamg_tpu/sparse/dia.py::dia_pallas_jacobi_zero_res
// T is float or double (the mixed-precision outer loop's f64 operator
// runs through the same template).  The epilogue vector of SPMV_SCALED
// (s) and SPMV_ADD (v) arrives in the b slot.
//
// Layout: data is (nd, n_pad) row-major, data[d, i] = A[i, i + offsets[d]],
// zero where A has no entry or i + offsets[d] falls outside [0, n_pad).
// One thread computes one row, summing the diagonals in offset order, as
// the reference's padded-slice form does (pyamg_tpu/sparse/dia.py,
// DIAMatrix._matvec_impl); the epilogue follows the sum, as in the TPU
// kernel.  nvcc contracts the sum to FMAs, so results agree with the plain
// PyTorch form to rounding, not bitwise.
//
// The Jacobi weight w is either passed by value (omega) or read from a
// 0-d device tensor (omega_dev, non-null): the device-built hierarchy
// keeps its weights on the card, and reading one to the host per launch
// would synchronise the stream.
//
// Bound: device-memory bandwidth.  A pass reads the nd diagonals plus
// x (SPMV), x and s or v (the epilogues), x, b and dinv (JACOBI) or b and
// dinv (JACOBI_ZERO_RES), and writes one or two vectors:
// (nd + 2..4) * n * sizeof(T) bytes at ~2 flops per diagonal entry.  The
// design's answer is coalescing: for every diagonal, neighbouring threads
// read neighbouring addresses of data[d] and of the shifted vector, so
// each warp issues full 128-byte transactions; the shifted re-reads of
// x/b/dinv across diagonals hit L1/L2.  An epilogue costs one more
// coalesced vector read instead of a separate pass over y.
// JACOBI_ZERO_RES recomputes x_j = w * dinv_j * b_j for every neighbour it
// reads instead of storing x first, so x is written once and never read
// back.
//
// Out-of-range neighbours: the TPU kernels clamp their halo reads and
// rely on out-of-range slots holding zero.  Here a read past
// [0, n_pad) would fault, so the term is skipped instead.
//
// The row sum and the Jacobi update live in dia_row.cuh, which the
// one-launch multicolour sweep (csrc/mcgs.cu) shares, so a sweep's colour
// phase gives K2's bits.

#include <cuda_runtime.h>
#include <cstdint>

#include "dia_row.cuh"

namespace {

enum DiaMode : int {
  SPMV = 0,
  JACOBI = 1,
  JACOBI_ZERO_RES = 2,
  SPMV_SCALED = 3,
  SPMV_ADD = 4
};

template <typename T, int Mode>
__global__ void dia_kernel(const T* __restrict__ data,
                           const int* __restrict__ offsets, int nd,
                           int64_t n_pad, const T* __restrict__ x,
                           const T* __restrict__ b,
                           const T* __restrict__ dinv, T omega,
                           const T* __restrict__ omega_dev,
                           T* __restrict__ y, T* __restrict__ r) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  T w = omega;
  if (Mode == JACOBI || Mode == JACOBI_ZERO_RES) {
    if (omega_dev != nullptr) w = *omega_dev;
  }
  const T acc = dia_row_sum(data, offsets, nd, n_pad, i, [&](int64_t j) {
    if (Mode == JACOBI_ZERO_RES) return w * (dinv[j] * b[j]);
    return x[j];
  });
  if (Mode == SPMV) {
    y[i] = acc;
  } else if (Mode == SPMV_SCALED) {
    y[i] = acc * b[i];
  } else if (Mode == SPMV_ADD) {
    y[i] = acc + b[i];
  } else if (Mode == JACOBI) {
    y[i] = jacobi_update(x[i], w, dinv[i], b[i], acc);
  } else {
    y[i] = w * (dinv[i] * b[i]);
    r[i] = b[i] - acc;
  }
}

constexpr int kThreads = 256;

template <typename T, int Mode>
void launch_mode(unsigned int blocks, cudaStream_t s, const T* d,
                 const int* o, int nd, long long n_pad, const T* xp,
                 const T* bp, const T* dp, T omega, const T* wp, T* yp,
                 T* rp) {
  dia_kernel<T, Mode><<<blocks, kThreads, 0, s>>>(d, o, nd, n_pad, xp, bp, dp,
                                                  omega, wp, yp, rp);
}

template <typename T>
int launch_dia(const void* data, const void* offsets, int nd, long long n_pad,
               const void* x, const void* b, const void* dinv, T omega,
               const void* omega_dev, void* y, void* r, int mode,
               void* stream) {
  if (n_pad <= 0) return static_cast<int>(cudaSuccess);
  const unsigned int blocks =
      static_cast<unsigned int>((n_pad + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(data);
  const int* o = static_cast<const int*>(offsets);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  const T* dp = static_cast<const T*>(dinv);
  const T* wp = static_cast<const T*>(omega_dev);
  T* yp = static_cast<T*>(y);
  T* rp = static_cast<T*>(r);
  switch (mode) {
    case SPMV:
      launch_mode<T, SPMV>(blocks, s, d, o, nd, n_pad, xp, bp, dp, omega, wp,
                           yp, rp);
      break;
    case JACOBI:
      launch_mode<T, JACOBI>(blocks, s, d, o, nd, n_pad, xp, bp, dp, omega,
                             wp, yp, rp);
      break;
    case JACOBI_ZERO_RES:
      launch_mode<T, JACOBI_ZERO_RES>(blocks, s, d, o, nd, n_pad, xp, bp, dp,
                                      omega, wp, yp, rp);
      break;
    case SPMV_SCALED:
      launch_mode<T, SPMV_SCALED>(blocks, s, d, o, nd, n_pad, xp, bp, dp,
                                  omega, wp, yp, rp);
      break;
    case SPMV_ADD:
      launch_mode<T, SPMV_ADD>(blocks, s, d, o, nd, n_pad, xp, bp, dp, omega,
                               wp, yp, rp);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pyamg_dia_f32(const void* data, const void* offsets, int nd,
                  long long n_pad, const void* x, const void* b,
                  const void* dinv, float omega, const void* omega_dev,
                  void* y, void* r, int mode, void* stream) {
  return launch_dia<float>(data, offsets, nd, n_pad, x, b, dinv, omega,
                           omega_dev, y, r, mode, stream);
}

int pyamg_dia_f64(const void* data, const void* offsets, int nd,
                  long long n_pad, const void* x, const void* b,
                  const void* dinv, double omega, const void* omega_dev,
                  void* y, void* r, int mode, void* stream) {
  return launch_dia<double>(data, offsets, nd, n_pad, x, b, dinv, omega,
                            omega_dev, y, r, mode, stream);
}

const char* pyamg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
