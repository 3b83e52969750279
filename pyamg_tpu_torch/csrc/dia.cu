// DIA (diagonal-stored) operator kernels of pyamg_tpu_torch, for Hopper
// (sm_90a).
//
// One kernel template, dia_kernel<T, Mode>, replaces three TPU kernels of
// the JAX package:
//   SPMV            y = A x                          pyamg_tpu/sparse/dia.py::_dia_pallas_matvec (plain mode)
//   JACOBI          y = x + w * dinv * (b - A x)     pyamg_tpu/sparse/dia.py::dia_pallas_jacobi
//   JACOBI_ZERO_RES x = w * dinv * b, r = b - A x    pyamg_tpu/sparse/dia.py::dia_pallas_jacobi_zero_res
// T is float or double (the mixed-precision outer loop's f64 operator
// runs through the same template).
//
// Layout: data is (nd, n_pad) row-major, data[d, i] = A[i, i + offsets[d]],
// zero where A has no entry or i + offsets[d] falls outside [0, n_pad).
// One thread computes one row, summing the diagonals in offset order, as
// the reference's padded-slice form does (pyamg_tpu/sparse/dia.py,
// DIAMatrix._matvec_impl).  nvcc contracts the sum to FMAs, so results
// agree with the plain PyTorch form to rounding, not bitwise.
//
// Bound: device-memory bandwidth.  A pass reads the nd diagonals plus
// x (SPMV), x, b and dinv (JACOBI) or b and dinv (JACOBI_ZERO_RES), and
// writes one or two vectors: (nd + 2..4) * n * sizeof(T) bytes at ~2 flops
// per diagonal entry.  The design's answer is coalescing: for every
// diagonal, neighbouring threads read neighbouring addresses of data[d]
// and of the shifted vector, so each warp issues full 128-byte
// transactions; the shifted re-reads of x/b/dinv across diagonals hit
// L1/L2.  JACOBI_ZERO_RES recomputes x_j = w * dinv_j * b_j for every
// neighbour it reads instead of storing x first, so x is written once
// and never read back.
//
// Out-of-range neighbours: the TPU kernels clamp their halo reads and
// rely on out-of-range slots holding zero.  Here a read past
// [0, n_pad) would fault, so the term is skipped instead.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum DiaMode : int { SPMV = 0, JACOBI = 1, JACOBI_ZERO_RES = 2 };

template <typename T, int Mode>
__global__ void dia_kernel(const T* __restrict__ data,
                           const int* __restrict__ offsets, int nd,
                           int64_t n_pad, const T* __restrict__ x,
                           const T* __restrict__ b,
                           const T* __restrict__ dinv, T omega,
                           T* __restrict__ y, T* __restrict__ r) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  T acc = T(0);
  for (int d = 0; d < nd; ++d) {
    const int64_t j = i + offsets[d];
    if (j < 0 || j >= n_pad) continue;
    T xj;
    if (Mode == JACOBI_ZERO_RES) {
      xj = omega * (dinv[j] * b[j]);
    } else {
      xj = x[j];
    }
    acc += data[static_cast<int64_t>(d) * n_pad + i] * xj;
  }
  if (Mode == SPMV) {
    y[i] = acc;
  } else if (Mode == JACOBI) {
    y[i] = x[i] + omega * (dinv[i] * (b[i] - acc));
  } else {
    y[i] = omega * (dinv[i] * b[i]);
    r[i] = b[i] - acc;
  }
}

constexpr int kThreads = 256;

template <typename T>
int launch_dia(const void* data, const void* offsets, int nd, long long n_pad,
               const void* x, const void* b, const void* dinv, T omega,
               void* y, void* r, int mode, void* stream) {
  if (n_pad <= 0) return static_cast<int>(cudaSuccess);
  const unsigned int blocks =
      static_cast<unsigned int>((n_pad + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(data);
  const int* o = static_cast<const int*>(offsets);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  const T* dp = static_cast<const T*>(dinv);
  T* yp = static_cast<T*>(y);
  T* rp = static_cast<T*>(r);
  switch (mode) {
    case SPMV:
      dia_kernel<T, SPMV><<<blocks, kThreads, 0, s>>>(d, o, nd, n_pad, xp, bp,
                                                       dp, omega, yp, rp);
      break;
    case JACOBI:
      dia_kernel<T, JACOBI><<<blocks, kThreads, 0, s>>>(d, o, nd, n_pad, xp,
                                                         bp, dp, omega, yp, rp);
      break;
    case JACOBI_ZERO_RES:
      dia_kernel<T, JACOBI_ZERO_RES><<<blocks, kThreads, 0, s>>>(
          d, o, nd, n_pad, xp, bp, dp, omega, yp, rp);
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
                  const void* dinv, float omega, void* y, void* r, int mode,
                  void* stream) {
  return launch_dia<float>(data, offsets, nd, n_pad, x, b, dinv, omega, y, r,
                           mode, stream);
}

int pyamg_dia_f64(const void* data, const void* offsets, int nd,
                  long long n_pad, const void* x, const void* b,
                  const void* dinv, double omega, void* y, void* r, int mode,
                  void* stream) {
  return launch_dia<double>(data, offsets, nd, n_pad, x, b, dinv, omega, y, r,
                            mode, stream);
}

const char* pyamg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
