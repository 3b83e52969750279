// Block-DIA kernels of pyamg_tpu_torch, for Hopper (sm_90a): BSR
// operators of bs x bs node blocks on a node grid, stored by block
// diagonal (sparse/block_dia.py::BlockDIAMatrix).
//
// They replace no TPU kernel: the JAX package's block algebra is plain
// jnp (pyamg_tpu/sparse/block_dia.py:77, BlockDIAMatrix.matvec;
// pyamg_tpu/engine/relaxation.py:232, _block_apply, and the block
// smoothers), which XLA fuses on the TPU.  Composed from PyTorch ops on
// the card, one apply was five launches and about four times its bytes
// (a 9x copy of x and an (nb, bs, nd * bs) product written and read
// again); these kernels take one pass.
//
//   block_dia_spmv_kernel<T, BS, Mode>, B1:
//     PLAIN     y = A x
//     RESID     y = b - A x
//   block_dia_jacobi_kernel<T, BS, Mode>, B2 (and B3's colour step):
//     ZERO      y = w Dinv b                     (no read of A)
//     ZERO_RES  y = w Dinv b,  r = b - A y       (y's neighbours recomputed)
//     STEP      y = x + w Dinv (b - A x)
//     COLOUR    y = x + Dinv (b - A x) on the nodes of colour c, y = x
//               on every other node (which reads no A data)
// T is float or double.  Every mode writes out of place.
//
// Layout: data (nd, nb, bs, bs) row-major, data[d, i] = A_block[i, i +
// offsets[d]] (a zero block where A has none or the neighbour falls
// outside the matrix); Dinv (nb, bs, bs); vectors (lanes, nb * bs), node
// i's components contiguous; colours int32 (nb,).  A K-major lane stack
// puts the lane on gridDim.y (the wrapper launches at most MAX_LANES
// lanes at a time, sparse/block_dia.py).
//
// Bound: device-memory bandwidth.  A PLAIN apply must read the nd
// diagonals' blocks (nd * nb * bs^2 values) and x and write y, at 2 flops
// per block entry: a quarter of a flop per byte in float32.  STEP and
// ZERO_RES add the (nb, bs, bs) Dinv and one or two vectors.  The design:
//   - one thread per node row produces that node's bs outputs; a CTA of
//     256 threads covers consecutive nodes, so for each diagonal the warp
//     reads one contiguous run of blocks in their stored layout (16-byte
//     vector loads where a block is a multiple of 16 bytes: bs = 2, 4 in
//     float32, bs = 2, 4 in float64) and the neighbours' x blocks, also
//     one contiguous run (x is small enough to stay in L2);
//   - data is read once and nothing is materialised: no padded copy of
//     x, no row strips, no per-entry product;
//   - a neighbour outside [0, nb) is skipped, not read (its block is zero
//     by construction), as K1 skips out-of-range DIA slots;
//   - each output is summed in registers in a fixed order, the diagonals
//     ascending and within a block the columns ascending (nvcc contracts
//     acc += a * x to FMAs); no atomics, so two launches give the same
//     bits;
//   - ZERO_RES recomputes each neighbour's w (Dinv_j b_j) instead of
//     storing y first and reading it back, as K3 does for the scalar
//     sweep;
//   - COLOUR: a node of another colour copies x and reads no A data.  A
//     sweep still moves more than the blocks' bytes once: where colours
//     alternate node by node (the parity colouring of a node grid), a
//     warp's block loads touch every 32-byte sector of its rows, so a
//     4-colour sweep reads about twice the blocks (PERF.md §6, B3).
// BS = 1 .. 4 are unrolled template instances; BS = 0 takes the block size
// at run time (any bs, and bs 2 or 4 whose blocks are not 16-byte
// aligned), one thread per output component, with the same summation
// order.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum SpmvMode : int { PLAIN = 0, RESID = 1 };
enum JacobiMode : int { ZERO = 0, ZERO_RES = 1, STEP = 2, COLOUR = 3 };

constexpr int kThreads = 256;

template <typename T>
struct Args {
  const T* data;          // (nd, nb, bs, bs)
  const int* offsets;     // (nd,) ascending, in nodes
  int nd;
  long long nb;
  int bs;
  long long n;            // nb * bs: a lane's stride
  const T* x;             // (lanes, n)
  const T* b;             // (lanes, n)
  const T* dinv;          // (nb, bs, bs)
  T omega;
  const T* omega_dev;     // 0-d device weight, or null
  const int* colors;      // (nb,)
  int colour;
  T* y;                   // (lanes, n)
  T* r;                   // (lanes, n), ZERO_RES
};

// N consecutive values from p: 16-byte loads when N values fill whole
// 16-byte words (p is then 16-byte aligned: the launcher checks the base,
// and a block's offset is a multiple of its size), else scalar loads.
template <typename T, int N>
__device__ __forceinline__ void load_run(const T* __restrict__ p, T (&v)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    if constexpr (sizeof(T) == 4) {
      const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        const float4 w = __ldg(q + k);
        v[4 * k] = w.x;
        v[4 * k + 1] = w.y;
        v[4 * k + 2] = w.z;
        v[4 * k + 3] = w.w;
      }
    } else {
      const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const double2 w = __ldg(q + k);
        v[2 * k] = w.x;
        v[2 * k + 1] = w.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = __ldg(p + k);
  }
}

template <typename T>
__device__ __forceinline__ T weight(const Args<T>& a) {
  return a.omega_dev != nullptr ? *a.omega_dev : a.omega;
}

// ---- compile-time block size: one thread per node, BS outputs ----------

// Node j's zero-guess sweep, w (Dinv_j b_j), into v.
template <typename T, int BS>
__device__ __forceinline__ void zero_sweep(const Args<T>& a,
                                           const T* __restrict__ b,
                                           long long j, T w, T (&v)[BS]) {
  T D[BS * BS], bj[BS];
  load_run<T, BS * BS>(a.dinv + j * (BS * BS), D);
#pragma unroll
  for (int q = 0; q < BS; ++q) bj[q] = b[j * BS + q];
#pragma unroll
  for (int p = 0; p < BS; ++p) {
    T s = T(0);
#pragma unroll
    for (int q = 0; q < BS; ++q) s += D[p * BS + q] * bj[q];
    v[p] = w * s;
  }
}

// acc = (A v)_i, v = x or (ZERO_GUESS) the zero-guess sweep of b.
template <typename T, int BS, bool ZERO_GUESS>
__device__ __forceinline__ void node_product(const Args<T>& a,
                                             const T* __restrict__ x,
                                             const T* __restrict__ b,
                                             long long i, T w, T (&acc)[BS]) {
#pragma unroll
  for (int p = 0; p < BS; ++p) acc[p] = T(0);
  const T* __restrict__ blocks = a.data + i * (BS * BS);
  const long long stride = a.nb * (BS * BS);
#pragma unroll 3
  for (int d = 0; d < a.nd; ++d) {
    const long long j = i + __ldg(a.offsets + d);
    if (j < 0 || j >= a.nb) continue;
    T blk[BS * BS], xj[BS];
    load_run<T, BS * BS>(blocks + d * stride, blk);
    if constexpr (ZERO_GUESS) {
      zero_sweep<T, BS>(a, b, j, w, xj);
    } else {
#pragma unroll
      for (int q = 0; q < BS; ++q) xj[q] = x[j * BS + q];
    }
#pragma unroll
    for (int p = 0; p < BS; ++p) {
#pragma unroll
      for (int q = 0; q < BS; ++q) acc[p] += blk[p * BS + q] * xj[q];
    }
  }
}

// ---- run-time block size: one thread per output component -------------

template <typename T>
__device__ __forceinline__ T zero_sweep_rt(const Args<T>& a,
                                           const T* __restrict__ b,
                                           long long j, int q, T w) {
  const int bs = a.bs;
  const T* D = a.dinv + (j * bs + q) * bs;
  T s = T(0);
  for (int u = 0; u < bs; ++u) s += D[u] * b[j * bs + u];
  return w * s;
}

template <typename T, bool ZERO_GUESS>
__device__ __forceinline__ T row_product_rt(const Args<T>& a,
                                            const T* __restrict__ x,
                                            const T* __restrict__ b,
                                            long long i, int p, T w) {
  const int bs = a.bs;
  const long long bs2 = static_cast<long long>(bs) * bs;
  T acc = T(0);
  for (int d = 0; d < a.nd; ++d) {
    const long long j = i + a.offsets[d];
    if (j < 0 || j >= a.nb) continue;
    const T* blk = a.data + (d * a.nb + i) * bs2 + static_cast<long long>(p) * bs;
    for (int q = 0; q < bs; ++q) {
      const T xq = ZERO_GUESS ? zero_sweep_rt(a, b, j, q, w) : x[j * bs + q];
      acc += blk[q] * xq;
    }
  }
  return acc;
}

// ---- B1 -----------------------------------------------------------------

template <typename T, int BS, int Mode>
__global__ void __launch_bounds__(kThreads)
    block_dia_spmv_kernel(const Args<T> a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long lane = static_cast<long long>(blockIdx.y) * a.n;
  const T* __restrict__ x = a.x + lane;
  T* __restrict__ y = a.y + lane;
  if constexpr (BS > 0) {
    if (t >= a.nb) return;
    T acc[BS];
    node_product<T, BS, false>(a, x, nullptr, t, T(0), acc);
#pragma unroll
    for (int p = 0; p < BS; ++p) {
      const long long e = t * BS + p;
      y[e] = Mode == RESID ? a.b[lane + e] - acc[p] : acc[p];
    }
  } else {
    const long long i = t / a.bs;
    const int p = static_cast<int>(t - i * a.bs);
    if (i >= a.nb) return;
    const T acc = row_product_rt<T, false>(a, x, nullptr, i, p, T(0));
    y[t] = Mode == RESID ? a.b[lane + t] - acc : acc;
  }
}

// ---- B2 -----------------------------------------------------------------

template <typename T, int BS, int Mode>
__global__ void __launch_bounds__(kThreads)
    block_dia_jacobi_kernel(const Args<T> a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long lane = static_cast<long long>(blockIdx.y) * a.n;
  const T* __restrict__ x = Mode == STEP || Mode == COLOUR ? a.x + lane : nullptr;
  const T* __restrict__ b = a.b + lane;
  T* __restrict__ y = a.y + lane;
  const T w = Mode == COLOUR ? T(1) : weight(a);
  if constexpr (BS > 0) {
    const long long i = t;
    if (i >= a.nb) return;
    if (Mode == COLOUR && a.colors[i] != a.colour) {
#pragma unroll
      for (int p = 0; p < BS; ++p) y[i * BS + p] = x[i * BS + p];
      return;
    }
    if constexpr (Mode == ZERO || Mode == ZERO_RES) {
      T xi[BS];
      zero_sweep<T, BS>(a, b, i, w, xi);
#pragma unroll
      for (int p = 0; p < BS; ++p) y[i * BS + p] = xi[p];
      if constexpr (Mode == ZERO_RES) {
        T acc[BS];
        node_product<T, BS, true>(a, nullptr, b, i, w, acc);
        T* __restrict__ r = a.r + lane;
#pragma unroll
        for (int p = 0; p < BS; ++p) r[i * BS + p] = b[i * BS + p] - acc[p];
      }
    } else {
      T acc[BS], res[BS], D[BS * BS];
      node_product<T, BS, false>(a, x, b, i, w, acc);
#pragma unroll
      for (int q = 0; q < BS; ++q) res[q] = b[i * BS + q] - acc[q];
      load_run<T, BS * BS>(a.dinv + i * (BS * BS), D);
#pragma unroll
      for (int p = 0; p < BS; ++p) {
        T s = T(0);
#pragma unroll
        for (int q = 0; q < BS; ++q) s += D[p * BS + q] * res[q];
        y[i * BS + p] = Mode == COLOUR ? x[i * BS + p] + s
                                       : x[i * BS + p] + w * s;
      }
    }
  } else {
    const int bs = a.bs;
    const long long i = t / bs;
    const int p = static_cast<int>(t - i * bs);
    if (i >= a.nb) return;
    if (Mode == COLOUR && a.colors[i] != a.colour) {
      y[t] = x[t];
      return;
    }
    if constexpr (Mode == ZERO || Mode == ZERO_RES) {
      y[t] = zero_sweep_rt(a, b, i, p, w);
      if constexpr (Mode == ZERO_RES) {
        a.r[lane + t] = b[t] - row_product_rt<T, true>(a, nullptr, b, i, p, w);
      }
    } else {
      // this component's row of Dinv against the node's whole residual
      const T* D = a.dinv + (i * bs + p) * bs;
      T s = T(0);
      for (int q = 0; q < bs; ++q) {
        const T res = b[i * bs + q] - row_product_rt<T, false>(a, x, b, i, q, w);
        s += D[q] * res;
      }
      y[t] = Mode == COLOUR ? x[t] + s : x[t] + w * s;
    }
  }
}

// ---- launchers ----------------------------------------------------------

template <typename T, int BS>
dim3 grid_of(const Args<T>& a, int lanes) {
  const long long threads = BS > 0 ? a.nb : a.nb * a.bs;
  return dim3(static_cast<unsigned int>((threads + kThreads - 1) / kThreads),
              static_cast<unsigned int>(lanes));
}

template <typename T, int BS>
struct SpmvLaunch {
  static void run(const Args<T>& a, int lanes, int mode, cudaStream_t s) {
    const dim3 g = grid_of<T, BS>(a, lanes);
    if (mode == RESID) {
      block_dia_spmv_kernel<T, BS, RESID><<<g, kThreads, 0, s>>>(a);
    } else {
      block_dia_spmv_kernel<T, BS, PLAIN><<<g, kThreads, 0, s>>>(a);
    }
  }
};

template <typename T, int BS>
struct JacobiLaunch {
  static void run(const Args<T>& a, int lanes, int mode, cudaStream_t s) {
    const dim3 g = grid_of<T, BS>(a, lanes);
    switch (mode) {
      case ZERO:
        block_dia_jacobi_kernel<T, BS, ZERO><<<g, kThreads, 0, s>>>(a);
        break;
      case ZERO_RES:
        block_dia_jacobi_kernel<T, BS, ZERO_RES><<<g, kThreads, 0, s>>>(a);
        break;
      case STEP:
        block_dia_jacobi_kernel<T, BS, STEP><<<g, kThreads, 0, s>>>(a);
        break;
      default:
        block_dia_jacobi_kernel<T, BS, COLOUR><<<g, kThreads, 0, s>>>(a);
        break;
    }
  }
};

// The instance for a.bs: the unrolled one, or the run-time one where a
// block of 16-byte words (bs 2, 4) does not start 16-byte aligned.
template <typename T, template <typename, int> class Launch>
int dispatch(const Args<T>& a, int lanes, int mode, void* stream) {
  if (a.nb <= 0 || lanes <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool words = (a.bs * a.bs * sizeof(T)) % 16 == 0;
  const bool aligned =
      reinterpret_cast<uintptr_t>(a.data) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.dinv) % 16 == 0;
  switch (words && !aligned ? 0 : a.bs) {
    case 1: Launch<T, 1>::run(a, lanes, mode, s); break;
    case 2: Launch<T, 2>::run(a, lanes, mode, s); break;
    case 3: Launch<T, 3>::run(a, lanes, mode, s); break;
    case 4: Launch<T, 4>::run(a, lanes, mode, s); break;
    default: Launch<T, 0>::run(a, lanes, mode, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(const void* data, const void* offsets, int nd,
                  long long nb, int bs, const void* x, const void* b,
                  const void* dinv, T omega, const void* omega_dev,
                  const void* colors, int colour, void* y, void* r) {
  return Args<T>{static_cast<const T*>(data),
                 static_cast<const int*>(offsets),
                 nd,
                 nb,
                 bs,
                 nb * bs,
                 static_cast<const T*>(x),
                 static_cast<const T*>(b),
                 static_cast<const T*>(dinv),
                 omega,
                 static_cast<const T*>(omega_dev),
                 static_cast<const int*>(colors),
                 colour,
                 static_cast<T*>(y),
                 static_cast<T*>(r)};
}

}  // namespace

extern "C" {

// B1: data, offsets, nd, nb, bs, lanes, x, b, y, mode, stream
int pyamg_block_dia_spmv_f32(const void* data, const void* offsets, int nd,
                             long long nb, int bs, int lanes, const void* x,
                             const void* b, void* y, int mode, void* stream) {
  return dispatch<float, SpmvLaunch>(
      make_args<float>(data, offsets, nd, nb, bs, x, b, nullptr, 0.0f,
                       nullptr, nullptr, 0, y, nullptr),
      lanes, mode, stream);
}

int pyamg_block_dia_spmv_f64(const void* data, const void* offsets, int nd,
                             long long nb, int bs, int lanes, const void* x,
                             const void* b, void* y, int mode, void* stream) {
  return dispatch<double, SpmvLaunch>(
      make_args<double>(data, offsets, nd, nb, bs, x, b, nullptr, 0.0,
                        nullptr, nullptr, 0, y, nullptr),
      lanes, mode, stream);
}

// B2: data, offsets, nd, nb, bs, lanes, x, b, dinv, omega, omega_dev,
// colors, colour, y, r, mode, stream
int pyamg_block_dia_jacobi_f32(const void* data, const void* offsets, int nd,
                               long long nb, int bs, int lanes, const void* x,
                               const void* b, const void* dinv, float omega,
                               const void* omega_dev, const void* colors,
                               int colour, void* y, void* r, int mode,
                               void* stream) {
  return dispatch<float, JacobiLaunch>(
      make_args<float>(data, offsets, nd, nb, bs, x, b, dinv, omega,
                       omega_dev, colors, colour, y, r),
      lanes, mode, stream);
}

int pyamg_block_dia_jacobi_f64(const void* data, const void* offsets, int nd,
                               long long nb, int bs, int lanes, const void* x,
                               const void* b, const void* dinv, double omega,
                               const void* omega_dev, const void* colors,
                               int colour, void* y, void* r, int mode,
                               void* stream) {
  return dispatch<double, JacobiLaunch>(
      make_args<double>(data, offsets, nd, nb, bs, x, b, dinv, omega,
                        omega_dev, colors, colour, y, r),
      lanes, mode, stream);
}

}  // extern "C"
