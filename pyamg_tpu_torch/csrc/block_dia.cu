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
//   block_dia_halo_kernel<T, BS, Mode>, B1's halo mode: PLAIN or RESID on
//     one rank's block of node rows of a row-sharded operator, x read from
//     three sources in place (see "B1's halo mode" below)
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
//
// B1's halo mode (the row-sharded block levels, parallel/partition.py::
// _ShardedBlockDIA): a rank owns node rows [0, nb) of the operator, data
// (nd, nb, bs, bs) with ld values between diagonals (a column slice of a
// wider operator's data is fine).  Node i needs x at i + offsets[d],
// which lies in one of three sources, read in place as K16 reads them
// (csrc/halo.cu): the left neighbour's last `halo` nodes (j < 0), the
// local x (0 <= j < nb) or the right neighbour's first `halo` nodes (j >=
// nb); no extended copy of x is made.  The node rows go in row blocks of
// 256 nodes, one CTA each; the wrapper's plan (parallel/halo_spmv.py::
// block_halo_plan) names the interior blocks [lo, hi), whose every
// neighbour lies in [0, nb): those read x only, with no select and no
// check.  A launch covers the row blocks [a0, a1) and [b0, b1): a ring of
// one takes one launch over every block; with an exchange the wrapper
// launches the interior while the halos travel, then the boundary blocks
// of both ends.  A neighbour is never skipped here: where the ring wraps
// (a ring of one, or the first and last ranks) its block is a stored
// zero block (BlockDIAMatrix keeps one wherever a column falls outside
// the operator), and an FMA with a zero block leaves the sum's bits as
// they were (the sum starts at +0 and never becomes -0), so the result
// equals B1 PLAIN / RESID on the whole operator bit for bit, in the same
// instance (the unrolled BS or the run-time one) and the same summation
// order.  On a K-major lane stack (the wrapper launches at most MAX_LANES
// lanes at a time, as B1's) the CTAs walk super tiles of the launch's row
// blocks (128 in float32, 1 in float64), the lanes of a tile one after
// another, as K16's lane mode does, so a tile's blocks are read from
// device memory once for all its lanes (B1 puts the lane on gridDim.y
// and reads them once a lane); the halos are (K, halo * bs) stacks whose
// lanes lie ldl and ldr values apart (a received buffer, or in a ring of
// one x's own tail and head), and every lane's value is B1's lane value.

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

// ---- the node product, shared by B1, B2 and B1's halo mode ------------
//
// acc = (A v)_i over every diagonal in order: one summation order for
// every mode and every source of v.  Node j's components of v come from a
// source policy:
//   take(j)         whether the term is summed (B1 and B2 skip a
//                   neighbour outside the operator; the halo mode never
//                   does)
//   load<BS>(j, v)  node j's BS components (compile-time block size)
//   at(j, q)        node j's component q (run-time block size)

// v = x (read-only in every kernel), a neighbour outside [0, nb) skipped
template <typename T>
struct LocalSource {
  const T* x;
  long long nb;
  int bs;
  __device__ __forceinline__ bool take(long long j) const {
    return j >= 0 && j < nb;
  }
  template <int BS>
  __device__ __forceinline__ void load(long long j, T (&v)[BS]) const {
#pragma unroll
    for (int q = 0; q < BS; ++q) v[q] = __ldg(x + j * BS + q);
  }
  __device__ __forceinline__ T at(long long j, int q) const {
    return __ldg(x + j * bs + q);
  }
};

// v = the zero-guess sweep w Dinv b, recomputed at each neighbour (B2
// ZERO_RES), a neighbour outside [0, nb) skipped
template <typename T>
struct ZeroGuessSource {
  const Args<T>& a;
  const T* b;
  T w;
  __device__ __forceinline__ bool take(long long j) const {
    return j >= 0 && j < a.nb;
  }
  template <int BS>
  __device__ __forceinline__ void load(long long j, T (&v)[BS]) const {
    zero_sweep<T, BS>(a, b, j, w, v);
  }
  __device__ __forceinline__ T at(long long j, int q) const {
    return zero_sweep_rt(a, b, j, q, w);
  }
};

// B1's halo mode: x, or (not INTERIOR) a halo, none skipped
template <typename T, bool INTERIOR>
struct HaloSource {
  const T* x;
  const T* left;
  const T* right;
  long long nb;
  int halo;
  int bs;
  __device__ __forceinline__ const T* node(long long j) const {
    if (INTERIOR || (j >= 0 && j < nb)) return x + j * bs;
    return j < 0 ? left + (halo + j) * bs : right + (j - nb) * bs;
  }
  __device__ __forceinline__ bool take(long long) const { return true; }
  template <int BS>
  __device__ __forceinline__ void load(long long j, T (&v)[BS]) const {
    const T* p = node(j);
#pragma unroll
    for (int q = 0; q < BS; ++q) v[q] = p[q];
  }
  __device__ __forceinline__ T at(long long j, int q) const {
    return node(j)[q];
  }
};

// compile-time block size: node i's BS outputs; `blocks` is node i's
// block of diagonal 0, each diagonal's `stride` values after the last
template <typename T, int BS, typename Src>
__device__ __forceinline__ void node_product(const T* __restrict__ blocks,
                                             long long stride,
                                             const int* __restrict__ offsets,
                                             int nd, long long i,
                                             const Src& src, T (&acc)[BS]) {
#pragma unroll
  for (int p = 0; p < BS; ++p) acc[p] = T(0);
#pragma unroll 3
  for (int d = 0; d < nd; ++d) {
    const long long j = i + __ldg(offsets + d);
    if (!src.take(j)) continue;
    T blk[BS * BS], xj[BS];
    load_run<T, BS * BS>(blocks + d * stride, blk);
    src.template load<BS>(j, xj);
#pragma unroll
    for (int p = 0; p < BS; ++p) {
#pragma unroll
      for (int q = 0; q < BS; ++q) acc[p] += blk[p * BS + q] * xj[q];
    }
  }
}

// run-time block size: output p of node i; `row` is that output's row of
// node i's block of diagonal 0, each diagonal's `stride` values after
template <typename T, typename Src>
__device__ __forceinline__ T row_product_rt(const T* row, long long stride,
                                            const int* offsets, int nd,
                                            long long i, int bs,
                                            const Src& src) {
  T acc = T(0);
  for (int d = 0; d < nd; ++d) {
    const long long j = i + offsets[d];
    if (!src.take(j)) continue;
    const T* blk = row + d * stride;
    for (int q = 0; q < bs; ++q) acc += blk[q] * src.at(j, q);
  }
  return acc;
}

// B1 and B2 over the whole operator: node i's outputs, or its output p
template <typename T, int BS, typename Src>
__device__ __forceinline__ void node_product(const Args<T>& a, long long i,
                                             const Src& src, T (&acc)[BS]) {
  node_product<T, BS>(a.data + i * (BS * BS), a.nb * (BS * BS), a.offsets,
                      a.nd, i, src, acc);
}

template <typename T, typename Src>
__device__ __forceinline__ T row_product_rt(const Args<T>& a, long long i,
                                            int p, const Src& src) {
  const long long bs = a.bs;
  return row_product_rt<T>(a.data + (i * bs + p) * bs, a.nb * bs * bs,
                           a.offsets, a.nd, i, a.bs, src);
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
    node_product<T, BS>(a, t, LocalSource<T>{x, a.nb, BS}, acc);
#pragma unroll
    for (int p = 0; p < BS; ++p) {
      const long long e = t * BS + p;
      y[e] = Mode == RESID ? a.b[lane + e] - acc[p] : acc[p];
    }
  } else {
    const long long i = t / a.bs;
    const int p = static_cast<int>(t - i * a.bs);
    if (i >= a.nb) return;
    const T acc = row_product_rt<T>(a, i, p, LocalSource<T>{x, a.nb, a.bs});
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
        node_product<T, BS>(a, i, ZeroGuessSource<T>{a, b, w}, acc);
        T* __restrict__ r = a.r + lane;
#pragma unroll
        for (int p = 0; p < BS; ++p) r[i * BS + p] = b[i * BS + p] - acc[p];
      }
    } else {
      T acc[BS], res[BS], D[BS * BS];
      node_product<T, BS>(a, i, LocalSource<T>{x, a.nb, BS}, acc);
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
        a.r[lane + t] = b[t] - row_product_rt<T>(a, i, p,
                                                 ZeroGuessSource<T>{a, b, w});
      }
    } else {
      // this component's row of Dinv against the node's whole residual
      const T* D = a.dinv + (i * bs + p) * bs;
      T s = T(0);
      for (int q = 0; q < bs; ++q) {
        const T res = b[i * bs + q] -
                      row_product_rt<T>(a, i, q, LocalSource<T>{x, a.nb, bs});
        s += D[q] * res;
      }
      y[t] = Mode == COLOUR ? x[t] + s : x[t] + w * s;
    }
  }
}

// ---- B1's halo mode -------------------------------------------------------

template <typename T>
struct HaloArgs {
  const T* data;          // (nd, nb, bs, bs), ld values between diagonals
  long long ld;
  const int* offsets;     // (nd,) ascending, in nodes, |offset| <= halo
  int nd;
  long long nb;           // the block's node rows
  int bs;
  int halo;               // nodes in each halo
  const T* left;          // (lanes, halo * bs), lanes ldl values apart
  long long ldl;
  const T* x;             // (lanes, nb * bs), lanes ldx values apart
  long long ldx;          // (and y's and b's)
  const T* right;         // (lanes, halo * bs), lanes ldr values apart
  long long ldr;
  const T* b;             // (lanes, nb * bs), RESID
  T* y;                   // (lanes, nb * bs)
  int lo, hi;             // the interior row blocks
  int a0, a1, b0;         // the row blocks of this launch: [a0, a1), [b0, ...)
  int nrb;                // their count
  int lanes;
};

// node j's source of x (HaloSource) for this block of node rows
template <typename T, bool INTERIOR>
__device__ __forceinline__ HaloSource<T, INTERIOR> halo_source(
    const HaloArgs<T>& a, int bs) {
  return HaloSource<T, INTERIOR>{a.x, a.left, a.right, a.nb, a.halo, bs};
}

template <typename T, int BS, int Mode>
__global__ void __launch_bounds__(kThreads)
    block_dia_halo_kernel(HaloArgs<T> a) {
  // the launch's row blocks, [a0, a1) then [b0, ...), nrb in all, in
  // super tiles of SUPER, the lanes of a tile one after another (K16's
  // lane order): a tile's blocks come from device memory once and from L2
  // for the other lanes
  constexpr int SUPER = sizeof(T) == 4 ? 128 : 1;
  const int bid = static_cast<int>(blockIdx.x);
  const int st = bid / (SUPER * a.lanes);
  const int base = st * SUPER;
  const int tile = min(SUPER, a.nrb - base);
  const int rem = bid - st * SUPER * a.lanes;
  const int k = rem / tile;
  const int v = base + rem - k * tile;
  const long long lane = k;
  a.x += lane * a.ldx;
  a.y += lane * a.ldx;
  if (Mode == RESID) a.b += lane * a.ldx;
  a.left += lane * a.ldl;
  a.right += lane * a.ldr;
  const int na = a.a1 - a.a0;
  const int rb = v < na ? a.a0 + v : a.b0 + (v - na);
  const bool interior = rb >= a.lo && rb < a.hi;
  const long long n0 = static_cast<long long>(rb) * kThreads;
  if constexpr (BS > 0) {
    const long long i = n0 + threadIdx.x;
    if (i >= a.nb) return;
    T acc[BS];
    const T* blocks = a.data + i * (BS * BS);
    if (interior) {
      node_product<T, BS>(blocks, a.ld, a.offsets, a.nd, i,
                          halo_source<T, true>(a, BS), acc);
    } else {
      node_product<T, BS>(blocks, a.ld, a.offsets, a.nd, i,
                          halo_source<T, false>(a, BS), acc);
    }
#pragma unroll
    for (int p = 0; p < BS; ++p) {
      const long long e = i * BS + p;
      a.y[e] = Mode == RESID ? a.b[e] - acc[p] : acc[p];
    }
  } else {
    // run-time bs: the CTA's 256 nodes, a thread per component in turn
    const int bs = a.bs;
    const long long n1 = n0 + kThreads < a.nb ? n0 + kThreads : a.nb;
    for (long long t = n0 * bs + threadIdx.x; t < n1 * bs; t += kThreads) {
      const long long i = t / bs;
      const int p = static_cast<int>(t - i * bs);
      const T* row = a.data + t * bs;
      const T acc =
          interior ? row_product_rt<T>(row, a.ld, a.offsets, a.nd, i, bs,
                                       halo_source<T, true>(a, bs))
                   : row_product_rt<T>(row, a.ld, a.offsets, a.nd, i, bs,
                                       halo_source<T, false>(a, bs));
      a.y[t] = Mode == RESID ? a.b[t] - acc : acc;
    }
  }
}

template <typename T, int BS>
void launch_halo_mode(const HaloArgs<T>& a, dim3 blocks, int mode,
                      cudaStream_t s) {
  if (mode == RESID) {
    block_dia_halo_kernel<T, BS, RESID><<<blocks, kThreads, 0, s>>>(a);
  } else {
    block_dia_halo_kernel<T, BS, PLAIN><<<blocks, kThreads, 0, s>>>(a);
  }
}

template <typename T>
int block_halo(const void* data, long long ld, const void* offsets, int nd,
               long long nb, int bs, int halo, const void* left,
               long long ldl, const void* x, long long ldx,
               const void* right, long long ldr, const void* b, void* y,
               int lanes, int lo, int hi, int a0, int a1, int b0, int b1,
               int mode, void* stream) {
  const long long row_blocks = (nb + kThreads - 1) / kThreads;
  if (nb <= 0 || nd < 1 || bs < 1 || halo < 1 || halo > nb ||
      ld < nb * bs * bs || row_blocks >= (1LL << 31) || lo < 0 || hi < lo ||
      hi > row_blocks || a0 < 0 || a1 < a0 || b0 < a1 || b1 < b0 ||
      b1 > row_blocks || (mode != PLAIN && mode != RESID) ||
      (mode == RESID && b == nullptr) || lanes < 1 ||
      (static_cast<long long>(a1 - a0) + (b1 - b0)) * lanes >= (1LL << 31) ||
      (lanes > 1 && (ldl < halo * bs || ldr < halo * bs ||
                     ldx < nb * bs))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a1 - a0 + b1 - b0 == 0) return static_cast<int>(cudaSuccess);
  const HaloArgs<T> a{static_cast<const T*>(data), ld,
                      static_cast<const int*>(offsets), nd, nb, bs, halo,
                      static_cast<const T*>(left), ldl,
                      static_cast<const T*>(x), ldx,
                      static_cast<const T*>(right), ldr,
                      static_cast<const T*>(b), static_cast<T*>(y), lo, hi,
                      a0, a1, b0, (a1 - a0) + (b1 - b0), lanes};
  const dim3 blocks(static_cast<unsigned int>(
      static_cast<long long>(a.nrb) * lanes));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // B1's instance choice (dispatch below): the unrolled bs, or the
  // run-time one where a block of 16-byte words does not start aligned
  const bool words = (bs * bs * sizeof(T)) % 16 == 0;
  const bool aligned = reinterpret_cast<uintptr_t>(data) % 16 == 0;
  switch (words && !aligned ? 0 : bs) {
    case 1: launch_halo_mode<T, 1>(a, blocks, mode, s); break;
    case 2: launch_halo_mode<T, 2>(a, blocks, mode, s); break;
    case 3: launch_halo_mode<T, 3>(a, blocks, mode, s); break;
    case 4: launch_halo_mode<T, 4>(a, blocks, mode, s); break;
    default: launch_halo_mode<T, 0>(a, blocks, mode, s); break;
  }
  return static_cast<int>(cudaGetLastError());
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

// B1's halo mode: data, ld (values between diagonals), offsets (device),
// nd, nb (the block's node rows), bs, halo (nodes), left, ldl (values
// between its lanes), x, ldx (values between the lanes of x, b and y),
// right, ldr, b (RESID, else null), y, lanes (x, b and y K-major stacks
// of nb * bs values a lane, a vector for 1), lo, hi (the
// interior row blocks of 256 nodes), a0, a1, b0, b1 (the row blocks to
// compute), mode, stream
int pyamg_block_dia_halo_f32(const void* data, long long ld,
                             const void* offsets, int nd, long long nb,
                             int bs, int halo, const void* left,
                             long long ldl, const void* x, long long ldx,
                             const void* right, long long ldr, const void* b,
                             void* y, int lanes, int lo, int hi, int a0,
                             int a1, int b0, int b1, int mode,
                             void* stream) {
  return block_halo<float>(data, ld, offsets, nd, nb, bs, halo, left, ldl,
                           x, ldx, right, ldr, b, y, lanes, lo, hi, a0, a1,
                           b0, b1, mode, stream);
}

int pyamg_block_dia_halo_f64(const void* data, long long ld,
                             const void* offsets, int nd, long long nb,
                             int bs, int halo, const void* left,
                             long long ldl, const void* x, long long ldx,
                             const void* right, long long ldr, const void* b,
                             void* y, int lanes, int lo, int hi, int a0,
                             int a1, int b0, int b1, int mode,
                             void* stream) {
  return block_halo<double>(data, ld, offsets, nd, nb, bs, halo, left, ldl,
                            x, ldx, right, ldr, b, y, lanes, lo, hi, a0, a1,
                            b0, b1, mode, stream);
}

}  // extern "C"
