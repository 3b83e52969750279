// Two-stage DIA kernels of pyamg_tpu_torch, for Hopper (sm_90a): a banded
// sum whose result feeds a second banded sum, without the intermediate
// vector ever reaching device memory.
//
//   ZERO_CHAIN  x = w * dinv * b,  y = tv * (St (b - A x))
//               replaces pyamg_tpu/sparse/dia.py::dia_pallas_zero_chain (K5):
//               the zero-entry pre-smooth, residual and scaled restrict
//               front-end of a V-cycle level.  r = b - A x is dead after
//               the restrict, so it is never stored.
//   JACOBI_RES  y = x + w * dinv * (b - A x),  r = b - A y
//               replaces pyamg_tpu/sparse/dia.py::dia_pallas_jacobi_res (K4):
//               a pre-smooth from a nonzero guess and the residual of the
//               updated iterate, in one pass; y is written once and never
//               read back.
//
// A and St are DIA operators of one n_pad: data (nd, n_pad) row-major,
// data[d, i] = A[i, i + offsets[d]], zero where A has no entry or the
// column falls outside [0, n_pad).  T is float or double.
//
// Design (simple and compute-redundant): one thread per output row i.
// The outer sum runs over the outer operator's diagonals (St for
// ZERO_CHAIN, A for JACOBI_RES); for each neighbour j = i + off it
// RECOMPUTES the inner value it needs (r_j, resp. y_j) from A's row j:
// nd * nds inner terms per row (25 on a 5-point level, 81 on a 9-point
// one) instead of a stored intermediate.  The order of summation is the
// reference's composed form: the inner sum over A's offsets in order,
// then b - acc (resp. the Jacobi update), then the outer sum over the
// outer offsets in order, then the tv scale.  nvcc contracts to FMAs, so
// results agree with the plain PyTorch form to rounding.
//
// Bytes: each row's unique traffic is the same as the stored-intermediate
// chain minus the intermediate's write and re-read.  ZERO_CHAIN reads
// (nd + nds + 3) * sizeof(T) (A's and St's diagonals, b, dinv, tv) and
// writes 2 * sizeof(T) per row; JACOBI_RES reads (nd + 3) * sizeof(T)
// (A's diagonals, x, b, dinv) and writes 2 * sizeof(T).  The redundant
// re-reads (nds * (3 nd + 2) loads per row for ZERO_CHAIN) hit L1/L2,
// since neighbouring threads read neighbouring rows of the same
// diagonals.  Staging a row tile with its halo in shared memory, so each
// inner value is computed once, is the later redesign.
//
// Out-of-range neighbours: the TPU kernels clamp their halo reads and
// multiply the garbage by structurally-zero slots.  Here any index
// outside [0, n_pad), at either stage, skips its term, since the read
// would fault.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum ChainMode : int { ZERO_CHAIN = 0, JACOBI_RES = 1 };

// r_j = b_j - sum_e A[e, j] * (w * dinv_k * b_k), k = j + offsets[e]
template <typename T>
__device__ __forceinline__ T zero_residual_row(
    const T* __restrict__ data, const int* __restrict__ offsets, int nd,
    int64_t n_pad, int64_t j, const T* __restrict__ b,
    const T* __restrict__ dinv, T w) {
  T acc = T(0);
  for (int e = 0; e < nd; ++e) {
    const int64_t k = j + offsets[e];
    if (k < 0 || k >= n_pad) continue;
    acc += data[static_cast<int64_t>(e) * n_pad + j] * (w * (dinv[k] * b[k]));
  }
  return b[j] - acc;
}

// y_j = x_j + w * dinv_j * (b_j - sum_e A[e, j] * x_k), k = j + offsets[e]
template <typename T>
__device__ __forceinline__ T jacobi_row(
    const T* __restrict__ data, const int* __restrict__ offsets, int nd,
    int64_t n_pad, int64_t j, const T* __restrict__ x,
    const T* __restrict__ b, const T* __restrict__ dinv, T w) {
  T acc = T(0);
  for (int e = 0; e < nd; ++e) {
    const int64_t k = j + offsets[e];
    if (k < 0 || k >= n_pad) continue;
    acc += data[static_cast<int64_t>(e) * n_pad + j] * x[k];
  }
  return x[j] + w * (dinv[j] * (b[j] - acc));
}

template <typename T>
__global__ void zero_chain_kernel(
    const T* __restrict__ data, const int* __restrict__ offsets, int nd,
    const T* __restrict__ sdata, const int* __restrict__ soffsets, int nds,
    int64_t n_pad, const T* __restrict__ b, const T* __restrict__ dinv,
    const T* __restrict__ tv, T omega, const T* __restrict__ omega_dev,
    T* __restrict__ x_out, T* __restrict__ y_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const T w = omega_dev != nullptr ? *omega_dev : omega;
  T acc = T(0);
  for (int s = 0; s < nds; ++s) {
    const int64_t j = i + soffsets[s];
    if (j < 0 || j >= n_pad) continue;
    const T rj = zero_residual_row(data, offsets, nd, n_pad, j, b, dinv, w);
    acc += sdata[static_cast<int64_t>(s) * n_pad + i] * rj;
  }
  x_out[i] = w * (dinv[i] * b[i]);
  y_out[i] = tv[i] * acc;
}

template <typename T>
__global__ void jacobi_res_kernel(
    const T* __restrict__ data, const int* __restrict__ offsets, int nd,
    int64_t n_pad, const T* __restrict__ x, const T* __restrict__ b,
    const T* __restrict__ dinv, T omega, const T* __restrict__ omega_dev,
    T* __restrict__ y_out, T* __restrict__ r_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const T w = omega_dev != nullptr ? *omega_dev : omega;
  T acc = T(0);
  for (int d = 0; d < nd; ++d) {
    const int64_t j = i + offsets[d];
    if (j < 0 || j >= n_pad) continue;
    const T yj = jacobi_row(data, offsets, nd, n_pad, j, x, b, dinv, w);
    acc += data[static_cast<int64_t>(d) * n_pad + i] * yj;
  }
  y_out[i] = jacobi_row(data, offsets, nd, n_pad, i, x, b, dinv, w);
  r_out[i] = b[i] - acc;
}

constexpr int kThreads = 256;

template <typename T>
int launch_chain(const void* data, const void* offsets, int nd,
                 const void* sdata, const void* soffsets, int nds,
                 long long n_pad, const void* x, const void* b,
                 const void* dinv, const void* tv, T omega,
                 const void* omega_dev, void* out0, void* out1, int mode,
                 void* stream) {
  if (n_pad <= 0) return static_cast<int>(cudaSuccess);
  const unsigned int blocks =
      static_cast<unsigned int>((n_pad + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(data);
  const int* o = static_cast<const int*>(offsets);
  const T* wp = static_cast<const T*>(omega_dev);
  T* y0 = static_cast<T*>(out0);
  T* y1 = static_cast<T*>(out1);
  switch (mode) {
    case ZERO_CHAIN:
      zero_chain_kernel<T><<<blocks, kThreads, 0, s>>>(
          d, o, nd, static_cast<const T*>(sdata),
          static_cast<const int*>(soffsets), nds, n_pad,
          static_cast<const T*>(b), static_cast<const T*>(dinv),
          static_cast<const T*>(tv), omega, wp, y0, y1);
      break;
    case JACOBI_RES:
      jacobi_res_kernel<T><<<blocks, kThreads, 0, s>>>(
          d, o, nd, n_pad, static_cast<const T*>(x),
          static_cast<const T*>(b), static_cast<const T*>(dinv), omega, wp,
          y0, y1);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data, offsets, nd, sdata, soffsets, nds, n_pad, x, b, dinv, tv, omega,
// omega_dev, out0, out1, mode, stream.  ZERO_CHAIN: out0 = x, out1 = y
// (x and the slot are unused on input).  JACOBI_RES: out0 = y, out1 = r
// (sdata, soffsets and tv unused).
int pyamg_dia_chain_f32(const void* data, const void* offsets, int nd,
                        const void* sdata, const void* soffsets, int nds,
                        long long n_pad, const void* x, const void* b,
                        const void* dinv, const void* tv, float omega,
                        const void* omega_dev, void* out0, void* out1,
                        int mode, void* stream) {
  return launch_chain<float>(data, offsets, nd, sdata, soffsets, nds, n_pad,
                             x, b, dinv, tv, omega, omega_dev, out0, out1,
                             mode, stream);
}

int pyamg_dia_chain_f64(const void* data, const void* offsets, int nd,
                        const void* sdata, const void* soffsets, int nds,
                        long long n_pad, const void* x, const void* b,
                        const void* dinv, const void* tv, double omega,
                        const void* omega_dev, void* out0, void* out1,
                        int mode, void* stream) {
  return launch_chain<double>(data, offsets, nd, sdata, soffsets, nds, n_pad,
                              x, b, dinv, tv, omega, omega_dev, out0, out1,
                              mode, stream);
}

}  // extern "C"
