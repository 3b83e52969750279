// K-lane DIA kernels of pyamg_tpu_torch, for Hopper (sm_90a): one
// operator applied to K right-hand sides at once, lanes K-major
// ((K, n_pad) stacks, lane k's row contiguous), as the batched solve
// carries them.
//
//   dia_k_kernel<T, Mode>, K8 and K9:
//     SPMM         Y = A X                  pyamg_tpu/sparse/dia.py::_dia_pallas_matmat_k (plain)
//     SPMM_SCALED  Y = s * (A X), s (n_pad,) shared by the lanes
//                                           pyamg_tpu/sparse/dia.py::_dia_pallas_matmat_k (scale=)
//     SPMM_ADD     Y = V + A X, V (K, n_pad) per lane
//                                           pyamg_tpu/sparse/dia.py::_dia_pallas_matmat_k (addk=)
//     JACOBI_K     Y = X + w * dinv * (B - A X)
//                                           pyamg_tpu/sparse/dia.py::dia_pallas_jacobi_km
//   and K10:
//     ZERO_RES_K   Y = w * dinv * B,  R = B - A Y
//                                           pyamg_tpu/sparse/dia.py::dia_pallas_jacobi_zero_res_km
//   zero_chain_k_kernel<T>, K11:
//     X = w * dinv * B,  Y = tv * (St (B - A X)); the residual is never
//     stored                                pyamg_tpu/sparse/dia.py::dia_pallas_zero_chain_km
//
// Layout: data (nd, n_pad) row-major, data[d, i] = A[i, i + offsets[d]],
// zero where A has no entry or the column falls outside [0, n_pad).
// Stacks are (lanes, n_pad) row-major; a launch covers at most kMaxLanes
// lanes (the wrapper launches larger K in chunks on slices of the stack).
//
// Design: one thread per row i, looping over the lanes inside.  data[d, i],
// dinv[i], tv[i] and the offsets are loaded once per row for all lanes,
// which is the point of the TPU kernels (the diagonal data read once for
// K lanes instead of K times).  For a fixed lane and diagonal,
// neighbouring threads read neighbouring addresses of X[k, :], so every
// load is coalesced.  Each lane's sum runs over the diagonals in offset
// order, then the epilogue, as the reference's composed form and the
// single-lane kernels (csrc/dia.cu) do; nvcc contracts to FMAs, so results
// agree with the plain PyTorch twins to rounding.  The per-lane sums live
// in a register array of kMaxLanes, indexed only by unrolled constants.
//
// Bound: device-memory bandwidth.  Unique traffic per row is nd diagonals
// plus 2K (SPMM), 2K + 1 (SPMM_SCALED), 3K (SPMM_ADD), 3K + 1 (JACOBI_K)
// or 3K + 1 (ZERO_RES_K) values, against 2 nd K flops: at K = 8, nd = 5
// about one flop per byte in f32, far below the card's ~20 flops per
// byte.  The shifted re-reads of X across diagonals hit L1/L2.
//
// K11 recomputes each inner residual value r_j it needs for every St
// neighbour j of row i, per lane (as K5 does for one lane,
// csrc/dia_chain.cu): nd * nds inner terms per row and lane instead of a
// stored (K, n_pad) residual.  That keeps r out of device memory at the
// price of instructions and L1 traffic that grow with K; a shared-memory
// tile of rows plus halo that computes each r_j once is the redesign.
//
// ZERO_RES_K forms each neighbour's iterate w * dinv_j * b_j from b as it
// goes (the zero-guess sweep needs no x input), so Y and R leave in one
// pass and Y is never read back: the reference's point, which saves the
// composed form's extra (K, n_pad) round trip.
//
// Out-of-range neighbours: the TPU kernels clamp their halo reads and
// multiply the garbage by structurally-zero slots.  Here an index outside
// [0, n_pad), at either stage, skips its term, since the read would fault.
// All stack offsets k * n_pad + i are 64-bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxLanes = 16;
constexpr int kThreads = 256;

enum DiaKMode : int {
  SPMM = 0, SPMM_SCALED = 1, SPMM_ADD = 2, JACOBI_K = 3, ZERO_RES_K = 4
};

template <typename T, int Mode>
__global__ void __launch_bounds__(kThreads)
dia_k_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
             int nd, int64_t n_pad, int lanes, const T* __restrict__ x,
             const T* __restrict__ b, const T* __restrict__ dinv, T omega,
             const T* __restrict__ omega_dev, T* __restrict__ y,
             T* __restrict__ r) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  T w = T(0);
  if (Mode == JACOBI_K || Mode == ZERO_RES_K)
    w = omega_dev != nullptr ? *omega_dev : omega;
  T acc[kMaxLanes];
#pragma unroll
  for (int k = 0; k < kMaxLanes; ++k) acc[k] = T(0);
  for (int d = 0; d < nd; ++d) {
    const int64_t j = i + offsets[d];
    if (j < 0 || j >= n_pad) continue;
    const T a = data[static_cast<int64_t>(d) * n_pad + i];
    if (Mode == ZERO_RES_K) {
      const T dj = dinv[j];
#pragma unroll
      for (int k = 0; k < kMaxLanes; ++k) {
        if (k < lanes)
          acc[k] += a * (w * (dj * b[static_cast<int64_t>(k) * n_pad + j]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kMaxLanes; ++k) {
        if (k < lanes) acc[k] += a * x[static_cast<int64_t>(k) * n_pad + j];
      }
    }
  }
  if (Mode == SPMM_SCALED) {
    const T s = b[i];
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) y[static_cast<int64_t>(k) * n_pad + i] = acc[k] * s;
    }
  } else if (Mode == JACOBI_K) {
    const T di = dinv[i];
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) {
        const int64_t o = static_cast<int64_t>(k) * n_pad + i;
        y[o] = x[o] + w * (di * (b[o] - acc[k]));
      }
    }
  } else if (Mode == ZERO_RES_K) {
    const T di = dinv[i];
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) {
        const int64_t o = static_cast<int64_t>(k) * n_pad + i;
        y[o] = w * (di * b[o]);
        r[o] = b[o] - acc[k];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) {
        const int64_t o = static_cast<int64_t>(k) * n_pad + i;
        y[o] = Mode == SPMM_ADD ? acc[k] + b[o] : acc[k];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
zero_chain_k_kernel(const T* __restrict__ data,
                    const int* __restrict__ offsets, int nd,
                    const T* __restrict__ sdata,
                    const int* __restrict__ soffsets, int nds, int64_t n_pad,
                    int lanes, const T* __restrict__ b,
                    const T* __restrict__ dinv, const T* __restrict__ tv,
                    T omega, const T* __restrict__ omega_dev,
                    T* __restrict__ x_out, T* __restrict__ y_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const T w = omega_dev != nullptr ? *omega_dev : omega;
  T acc2[kMaxLanes];
#pragma unroll
  for (int k = 0; k < kMaxLanes; ++k) acc2[k] = T(0);
  for (int s = 0; s < nds; ++s) {
    const int64_t j = i + soffsets[s];
    if (j < 0 || j >= n_pad) continue;
    // r_j = b_j - sum_e A[e, j] * (w * dinv_m * b_m), m = j + offsets[e]
    T acc1[kMaxLanes];
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) acc1[k] = T(0);
    for (int e = 0; e < nd; ++e) {
      const int64_t m = j + offsets[e];
      if (m < 0 || m >= n_pad) continue;
      const T a = data[static_cast<int64_t>(e) * n_pad + j];
      const T dm = dinv[m];
#pragma unroll
      for (int k = 0; k < kMaxLanes; ++k) {
        if (k < lanes)
          acc1[k] += a * (w * (dm * b[static_cast<int64_t>(k) * n_pad + m]));
      }
    }
    const T sv = sdata[static_cast<int64_t>(s) * n_pad + i];
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes)
        acc2[k] += sv * (b[static_cast<int64_t>(k) * n_pad + j] - acc1[k]);
    }
  }
  const T di = dinv[i];
  const T t = tv[i];
#pragma unroll
  for (int k = 0; k < kMaxLanes; ++k) {
    if (k < lanes) {
      const int64_t o = static_cast<int64_t>(k) * n_pad + i;
      x_out[o] = w * (di * b[o]);
      y_out[o] = t * acc2[k];
    }
  }
}

unsigned int blocks_for(long long n_pad) {
  return static_cast<unsigned int>((n_pad + kThreads - 1) / kThreads);
}

template <typename T, int Mode>
void launch_mode(long long n_pad, cudaStream_t s, const void* data,
                 const void* offsets, int nd, int lanes, const void* x,
                 const void* b, const void* dinv, T omega,
                 const void* omega_dev, void* y, void* r) {
  dia_k_kernel<T, Mode><<<blocks_for(n_pad), kThreads, 0, s>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), nd,
      n_pad, lanes, static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(dinv), omega, static_cast<const T*>(omega_dev),
      static_cast<T*>(y), static_cast<T*>(r));
}

template <typename T>
int launch_dia_k(const void* data, const void* offsets, int nd,
                 long long n_pad, int lanes, const void* x, const void* b,
                 const void* dinv, T omega, const void* omega_dev, void* y,
                 void* r, int mode, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case SPMM:
      launch_mode<T, SPMM>(n_pad, s, data, offsets, nd, lanes, x, b, dinv,
                           omega, omega_dev, y, r);
      break;
    case SPMM_SCALED:
      launch_mode<T, SPMM_SCALED>(n_pad, s, data, offsets, nd, lanes, x, b,
                                  dinv, omega, omega_dev, y, r);
      break;
    case SPMM_ADD:
      launch_mode<T, SPMM_ADD>(n_pad, s, data, offsets, nd, lanes, x, b,
                               dinv, omega, omega_dev, y, r);
      break;
    case JACOBI_K:
      launch_mode<T, JACOBI_K>(n_pad, s, data, offsets, nd, lanes, x, b,
                               dinv, omega, omega_dev, y, r);
      break;
    case ZERO_RES_K:
      launch_mode<T, ZERO_RES_K>(n_pad, s, data, offsets, nd, lanes, x, b,
                                 dinv, omega, omega_dev, y, r);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_zero_chain_k(const void* data, const void* offsets, int nd,
                        const void* sdata, const void* soffsets, int nds,
                        long long n_pad, int lanes, const void* b,
                        const void* dinv, const void* tv, T omega,
                        const void* omega_dev, void* x_out, void* y_out,
                        void* stream) {
  if (lanes < 1 || lanes > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad <= 0) return static_cast<int>(cudaSuccess);
  zero_chain_k_kernel<T><<<blocks_for(n_pad), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), nd,
      static_cast<const T*>(sdata), static_cast<const int*>(soffsets), nds,
      n_pad, lanes, static_cast<const T*>(b), static_cast<const T*>(dinv),
      static_cast<const T*>(tv), omega, static_cast<const T*>(omega_dev),
      static_cast<T*>(x_out), static_cast<T*>(y_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data, offsets, nd, n_pad, lanes, x, b, dinv, omega, omega_dev, y, r,
// mode, stream.  x, y: (lanes, n_pad) stacks; b: s (n_pad,) for
// SPMM_SCALED, the per-lane V (SPMM_ADD) or B (JACOBI_K, ZERO_RES_K)
// stack; dinv for JACOBI_K and ZERO_RES_K; r (a stack) only for
// ZERO_RES_K, whose x is unused.
int pyamg_dia_k_f32(const void* data, const void* offsets, int nd,
                    long long n_pad, int lanes, const void* x, const void* b,
                    const void* dinv, float omega, const void* omega_dev,
                    void* y, void* r, int mode, void* stream) {
  return launch_dia_k<float>(data, offsets, nd, n_pad, lanes, x, b, dinv,
                             omega, omega_dev, y, r, mode, stream);
}

int pyamg_dia_k_f64(const void* data, const void* offsets, int nd,
                    long long n_pad, int lanes, const void* x, const void* b,
                    const void* dinv, double omega, const void* omega_dev,
                    void* y, void* r, int mode, void* stream) {
  return launch_dia_k<double>(data, offsets, nd, n_pad, lanes, x, b, dinv,
                              omega, omega_dev, y, r, mode, stream);
}

// data, offsets, nd, sdata, soffsets, nds, n_pad, lanes, b, dinv, tv,
// omega, omega_dev, x_out, y_out, stream; b, x_out, y_out (lanes, n_pad).
int pyamg_dia_zero_chain_k_f32(const void* data, const void* offsets, int nd,
                               const void* sdata, const void* soffsets,
                               int nds, long long n_pad, int lanes,
                               const void* b, const void* dinv,
                               const void* tv, float omega,
                               const void* omega_dev, void* x_out,
                               void* y_out, void* stream) {
  return launch_zero_chain_k<float>(data, offsets, nd, sdata, soffsets, nds,
                                    n_pad, lanes, b, dinv, tv, omega,
                                    omega_dev, x_out, y_out, stream);
}

int pyamg_dia_zero_chain_k_f64(const void* data, const void* offsets, int nd,
                               const void* sdata, const void* soffsets,
                               int nds, long long n_pad, int lanes,
                               const void* b, const void* dinv,
                               const void* tv, double omega,
                               const void* omega_dev, void* x_out,
                               void* y_out, void* stream) {
  return launch_zero_chain_k<double>(data, offsets, nd, sdata, soffsets, nds,
                                     n_pad, lanes, b, dinv, tv, omega,
                                     omega_dev, x_out, y_out, stream);
}

}  // extern "C"
