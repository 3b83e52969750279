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
//   block_dia_spmv_kernel<T, BS, L, Mode>, B1:
//     PLAIN     y = A x
//     RESID     y = b - A x
//   block_dia_halo_kernel<T, BS, L, Mode>, B1's halo mode: PLAIN or RESID
//     on one rank's block of node rows of a row-sharded operator, x read
//     from three sources in place (see "B1's halo mode" below)
//   block_dia_jacobi_kernel<T, BS, L, Mode>, B2:
//     ZERO      y = w Dinv b                     (no read of A)
//     ZERO_RES  y = w Dinv b,  r = b - A y       (y's neighbours recomputed)
//     STEP      y = x + w Dinv (b - A x)
//     COLOUR    y = x + Dinv (b - A x) on the nodes of colour c, y = x
//               on every other node (which reads no A data)
//   block_mcgs_sweep_kernel<T, BS, GRID>, B3, the block
//     multicolour Gauss-Seidel sweep in one launch (see "B3" below)
// T is float or double.  Every mode of B1 and B2 writes out of place; B3
// updates x in place.
//
// Layout: data (nd, nb, bs, bs) row-major, data[d, i] = A_block[i, i +
// offsets[d]] (a zero block where A has none or the neighbour falls
// outside the matrix); Dinv (nb, bs, bs); vectors (lanes, nb * bs), node
// i's components contiguous; colours int32 (nb,).
//
// Bound: device-memory bandwidth.  A PLAIN apply must read the nd
// diagonals' blocks (nd * nb * bs^2 values) once, x of every lane and
// write y of every lane, at 2 flops per block entry and lane: a quarter
// of a flop per byte a lane in float32.  STEP and ZERO_RES add the (nb,
// bs, bs) Dinv and one or two vectors a lane.  The design:
//   - one thread per node row produces that node's bs outputs for every
//     lane of the launch; a CTA of 256 threads covers consecutive nodes,
//     so for each diagonal the warp reads one contiguous run of blocks in
//     their stored layout (16-byte vector loads where a block is a
//     multiple of 16 bytes: bs = 2, 4 in float32, bs = 2, 4 in float64)
//     and each lane's neighbour x blocks, also one contiguous run (x is
//     small enough to stay in L2);
//   - the lane order, the one order of every kernel here (node_product):
//     the diagonals outermost; for each diagonal the thread loads the
//     node's block once into registers, then walks the lanes of its lane
//     tile, loading that lane's neighbour block of x and adding into that
//     lane's sums (acc[L][BS] in registers).  So the blocks come from
//     device memory once for all the lanes of a tile;
//   - a lane tile is a compile-time count L: 1 (the one-vector kernel), or
//     8 lanes (lane_tile: 4 in float64 at bs 3 and 4, where 8 lanes' sums
//     would take more than 32 registers).  A tile of 16 at bs <= 2 saved
//     little at K = 16 (PERF.md §6, B1) and doubled the instances the
//     build compiles; a larger tile spills or halves the resident CTAs,
//     and shared-memory staging of the CTA's blocks buys nothing the
//     registers do not (each block is used by one thread).  A launch
//     takes up to MAX_LANES = 16 lanes (sparse/block_dia.py): a thread
//     walks them in one or more tiles, re-reading its blocks from L1 / L2
//     between them;
//   - data is read once and nothing is materialised: no padded copy of
//     x, no row strips, no per-entry product;
//   - a neighbour outside [0, nb) is skipped, not read (its block is zero
//     by construction), as K1 skips out-of-range DIA slots;
//   - each output is summed in registers in a fixed order, the diagonals
//     ascending and within a block the columns ascending (nvcc contracts
//     acc += a * x to FMAs), lane by lane exactly as for one vector: every
//     lane of a stack gets the bits of a one-vector call on that lane.  No
//     atomics, so two launches give the same bits;
//   - ZERO_RES recomputes each neighbour's w (Dinv_j b_j) instead of
//     storing y first and reading it back, as K3 does for the scalar
//     sweep; the neighbour's Dinv block is loaded once for the tile's
//     lanes, STEP's and COLOUR's own Dinv block once after the sums;
//   - COLOUR: a node of another colour copies x and reads no A data.  A
//     sweep still moves more than the blocks' bytes once: where colours
//     alternate node by node (the parity colouring of a node grid), a
//     warp's block loads touch every 32-byte sector of its rows, so a
//     4-colour sweep reads about twice the blocks (PERF.md §6, B3).
// BS = 1 .. 4 are unrolled template instances; BS = 0 takes the block size
// at run time (any bs, and bs 2 or 4 whose blocks are not 16-byte
// aligned), one thread per output component, in the same lane order and
// summation order (a block row's entry loaded once for the tile's lanes).
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
// instance (the unrolled BS or the run-time one), the same lane tile and
// the same summation order: both kernels call node_product.  On a K-major
// lane stack the halos are (K, halo * bs) stacks whose lanes lie ldl and
// ldr values apart (a received buffer, or in a ring of one x's own tail
// and head), and every lane's value is B1's lane value.
//
// B3, the block multicolour sweep (sparse/block_dia.py::block_mcgs_sweep):
// one launch runs a whole smoother call, every phase of `order` (a colour
// of each direction of every iteration, in turn), as the scalar sweep of
// csrc/mcgs.cu does with the barriers of sweep.cuh.  A colour phase
// updates only that colour's nodes (the plan's nodes sorted by colour,
// sparse/block_dia.py::block_mcgs_plan): node_product, then the node's own
// Dinv block, B2 COLOUR's arithmetic in B2 COLOUR's instance, so every
// node gets the bits of the parent's B2 COLOUR chain.  On the grid route
// the first phase alone runs over every node, out of place (its colour's
// nodes from the caller's x, the others copied), so a call needs no copy
// launch and leaves its x as it was.  The later phases update the result
// in place where no stored nonzero block couples two nodes of one colour;
// else staged (the new values to scratch, a barrier, then to the result).
// The run-time block size is always staged: its threads each own one
// component, and a node's components read each other.  On the grid route
// the result is read through L2 (__ldcg); on the one-CTA route x is
// staged in the CTA's shared memory for the whole call (sweep.cuh).

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "sweep.cuh"

namespace {

enum SpmvMode : int { PLAIN = 0, RESID = 1 };
enum JacobiMode : int { ZERO = 0, ZERO_RES = 1, STEP = 2, COLOUR = 3 };

constexpr int kThreads = 256;

// The lane tile of an instance's stacks: 8 lanes, or 4 where 8 lanes'
// sums (8 x max(BS, 1) values of T) would exceed 32 registers.
template <typename T, int BS>
constexpr int lane_tile() {
  constexpr int regs = (BS > 0 ? BS : 1) * static_cast<int>(sizeof(T)) / 4;
  return 8 * regs <= 32 ? 8 : 4;
}

template <typename T>
struct Args {
  const T* data;          // (nd, nb, bs, bs)
  const int* offsets;     // (nd,) ascending, in nodes
  int nd;
  long long nb;
  int bs;
  long long n;            // nb * bs: a lane's stride
  int lanes;              // lanes of x, b, y and r
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

// whether lane l of a tile of L is one of its `lanes` live lanes
template <int L>
__device__ __forceinline__ bool live(int l, int lanes) {
  return L == 1 || l < lanes;
}

// ---- the zero-guess sweep w (Dinv_j b_j) ----------------------------------

// compile-time block size: node j's BS values from its Dinv block D
template <typename T, int BS>
__device__ __forceinline__ void zero_sweep(const T (&D)[BS * BS],
                                           const T* __restrict__ bj, T w,
                                           T (&v)[BS]) {
  T bq[BS];
#pragma unroll
  for (int q = 0; q < BS; ++q) bq[q] = bj[q];
#pragma unroll
  for (int p = 0; p < BS; ++p) {
    T s = T(0);
#pragma unroll
    for (int q = 0; q < BS; ++q) s += D[p * BS + q] * bq[q];
    v[p] = w * s;
  }
}

// run-time block size: component q of node j on each live lane, `row`
// that component's row of Dinv_j (each entry loaded once for the lanes),
// `bj` node j's components of lane 0, lanes ld values apart
template <typename T, int L>
__device__ __forceinline__ void zero_sweep_rt(const T* row,
                                              const T* __restrict__ bj,
                                              long long ld, int bs, T w,
                                              int lanes, T (&v)[L]) {
  T s[L];
#pragma unroll
  for (int l = 0; l < L; ++l) s[l] = T(0);
  for (int u = 0; u < bs; ++u) {
    const T du = row[u];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (live<L>(l, lanes)) s[l] += du * bj[l * ld + u];
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) v[l] = w * s[l];
}

// ---- the node product, shared by B1, B2 and B1's halo mode ------------
//
// acc[l] = (A v_l)_i over every diagonal in order, for each live lane l
// of a tile: one summation order for every mode, every lane and every
// source of v.  A source policy gives node j's components of v:
//   take(j)            whether the term is summed (B1 and B2 skip a
//                      neighbour outside the operator; the halo mode
//                      never does)
//   node<BS>(j)        what every lane shares at node j (an address and
//                      the lanes' stride; ZeroGuessSource: node j's Dinv
//                      block, loaded once)
//   load<BS>(nd, l, v) lane l's BS components (compile-time block size)
//   at<L>(nd, q, lanes, v)  component q on every live lane (run-time)

// a node of a source that reads vectors: its components on lane 0, and
// the values between lanes
template <typename T>
struct Strided {
  const T* p;
  long long ld;
};

// How a source reads x: LOAD_RO through the read-only path (x is never
// written during the launch: B1, B2, B3's first phase); LOAD_L2 through L2
// only (B3's later phases on the grid route, where other CTAs update x
// between phases and a read-only line could be stale); LOAD_SHARED a plain
// load (B3's one-CTA route, x in shared memory)
enum XLoad : int { LOAD_RO = 0, LOAD_L2 = 1, LOAD_SHARED = 2 };

template <int M, typename T>
__device__ __forceinline__ T load_x(const T* p) {
  if constexpr (M == LOAD_RO) {
    return __ldg(p);
  } else if constexpr (M == LOAD_L2) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// v = x, lanes ld values apart, a neighbour outside [0, nb) skipped
template <typename T, int M = LOAD_RO>
struct LocalSource {
  const T* x;
  long long ld;
  long long nb;
  int bs;
  __device__ __forceinline__ bool take(long long j) const {
    return j >= 0 && j < nb;
  }
  template <int BS>
  __device__ __forceinline__ Strided<T> node(long long j) const {
    return {x + j * (BS > 0 ? BS : bs), ld};
  }
  template <int BS>
  __device__ __forceinline__ void load(const Strided<T>& nd, int l,
                                       T (&v)[BS]) const {
#pragma unroll
    for (int q = 0; q < BS; ++q) v[q] = load_x<M>(nd.p + l * nd.ld + q);
  }
  template <int L>
  __device__ __forceinline__ void at(const Strided<T>& nd, int q, int lanes,
                                     T (&v)[L]) const {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (live<L>(l, lanes)) v[l] = load_x<M>(nd.p + l * nd.ld + q);
    }
  }
};

// a node of ZeroGuessSource: its Dinv block (compile-time block size) or
// its Dinv rows (run time), and its components of b on lane 0
template <typename T, int BS>
struct ZeroNode {
  T D[BS > 0 ? BS * BS : 1];
  const T* dinv;
  const T* b;
};

// v = the zero-guess sweep w Dinv b, recomputed at each neighbour (B2
// ZERO_RES), lanes of b ld values apart, a neighbour outside [0, nb)
// skipped
template <typename T>
struct ZeroGuessSource {
  const Args<T>& a;
  const T* b;
  long long ld;
  T w;
  __device__ __forceinline__ bool take(long long j) const {
    return j >= 0 && j < a.nb;
  }
  template <int BS>
  __device__ __forceinline__ ZeroNode<T, BS> node(long long j) const {
    ZeroNode<T, BS> nd;
    if constexpr (BS > 0) {
      load_run<T, BS * BS>(a.dinv + j * (BS * BS), nd.D);
      nd.b = b + j * BS;
    } else {
      nd.dinv = a.dinv + j * a.bs * a.bs;
      nd.b = b + j * a.bs;
    }
    return nd;
  }
  template <int BS>
  __device__ __forceinline__ void load(const ZeroNode<T, BS>& nd, int l,
                                       T (&v)[BS]) const {
    zero_sweep<T, BS>(nd.D, nd.b + l * ld, w, v);
  }
  template <int L>
  __device__ __forceinline__ void at(const ZeroNode<T, 0>& nd, int q,
                                     int lanes, T (&v)[L]) const {
    zero_sweep_rt<T, L>(nd.dinv + q * a.bs, nd.b, ld, a.bs, w, lanes, v);
  }
};

// B1's halo mode: x, or (not INTERIOR) a halo, none skipped; each
// source's lanes its own stride apart
template <typename T, bool INTERIOR>
struct HaloSource {
  const T* x;
  long long ldx;
  const T* left;
  long long ldl;
  const T* right;
  long long ldr;
  long long nb;
  int halo;
  int bs;
  __device__ __forceinline__ bool take(long long) const { return true; }
  template <int BS>
  __device__ __forceinline__ Strided<T> node(long long j) const {
    if (INTERIOR || (j >= 0 && j < nb)) return {x + j * bs, ldx};
    return j < 0 ? Strided<T>{left + (halo + j) * bs, ldl}
                 : Strided<T>{right + (j - nb) * bs, ldr};
  }
  template <int BS>
  __device__ __forceinline__ void load(const Strided<T>& nd, int l,
                                       T (&v)[BS]) const {
#pragma unroll
    for (int q = 0; q < BS; ++q) v[q] = nd.p[l * nd.ld + q];
  }
  template <int L>
  __device__ __forceinline__ void at(const Strided<T>& nd, int q, int lanes,
                                     T (&v)[L]) const {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (live<L>(l, lanes)) v[l] = nd.p[l * nd.ld + q];
    }
  }
};

// compile-time block size: node i's BS outputs on each live lane of a
// tile; `blocks` is node i's block of diagonal 0, each diagonal's
// `stride` values after the last.  The diagonals outermost, the block
// loaded once, then the lanes.  CH > 1 (one vector only, B3): the blocks
// and neighbours of CH diagonals are loaded before their terms are summed
// (one round trip to L2 a node where a sweep's phase leaves few warps an
// SM), in the same order; the offsets may lie in shared memory.
template <typename T, int BS, int L, int CH = 1, typename Src>
__device__ __forceinline__ void node_product(const T* __restrict__ blocks,
                                             long long stride,
                                             const int* __restrict__ offsets,
                                             int nd, long long i,
                                             const Src& src, int lanes,
                                             T (&acc)[L][BS]) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int p = 0; p < BS; ++p) acc[l][p] = T(0);
  }
  if constexpr (CH > 1) {
    static_assert(L == 1, "the batched loads serve one vector");
    for (int d0 = 0; d0 < nd; d0 += CH) {
      T blk[CH][BS * BS], xj[CH][BS];
      bool ok[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int d = d0 + c;
        const long long j = i + (d < nd ? offsets[d] : 0);
        ok[c] = d < nd && src.take(j);
        if (ok[c]) {
          load_run<T, BS * BS>(blocks + d * stride, blk[c]);
          src.template load<BS>(src.template node<BS>(j), 0, xj[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (!ok[c]) continue;
#pragma unroll
        for (int p = 0; p < BS; ++p) {
#pragma unroll
          for (int q = 0; q < BS; ++q) acc[0][p] += blk[c][p * BS + q] * xj[c][q];
        }
      }
    }
  } else {
#pragma unroll (L == 1 ? 3 : 2)
    for (int d = 0; d < nd; ++d) {
      const long long j = i + __ldg(offsets + d);
      if (!src.take(j)) continue;
      T blk[BS * BS];
      load_run<T, BS * BS>(blocks + d * stride, blk);
      const auto node = src.template node<BS>(j);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (!live<L>(l, lanes)) continue;
        T xj[BS];
        src.template load<BS>(node, l, xj);
#pragma unroll
        for (int p = 0; p < BS; ++p) {
#pragma unroll
          for (int q = 0; q < BS; ++q) acc[l][p] += blk[p * BS + q] * xj[q];
        }
      }
    }
  }
}

// run-time block size: output p of node i on each live lane; `row` is
// that output's row of node i's block of diagonal 0, each diagonal's
// `stride` values after.  The same order: the diagonals, the row's
// entries (each loaded once), then the lanes.
template <typename T, int L, typename Src>
__device__ __forceinline__ void row_product_rt(const T* row, long long stride,
                                               const int* offsets, int nd,
                                               long long i, int bs,
                                               const Src& src, int lanes,
                                               T (&acc)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = T(0);
  for (int d = 0; d < nd; ++d) {
    const long long j = i + offsets[d];
    if (!src.take(j)) continue;
    const T* blk = row + d * stride;
    const auto node = src.template node<0>(j);
    for (int q = 0; q < bs; ++q) {
      T v[L];
      src.template at<L>(node, q, lanes, v);
      const T e = blk[q];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (live<L>(l, lanes)) acc[l] += e * v[l];
      }
    }
  }
}

// B1 and B2 over the whole operator: node i's outputs, or its output p
template <typename T, int BS, int L, int CH = 1, typename Src>
__device__ __forceinline__ void node_product(const Args<T>& a, long long i,
                                             const Src& src, int lanes,
                                             T (&acc)[L][BS]) {
  node_product<T, BS, L, CH>(a.data + i * (BS * BS), a.nb * (BS * BS),
                             a.offsets, a.nd, i, src, lanes, acc);
}

template <typename T, int L, typename Src>
__device__ __forceinline__ void row_product_rt(const Args<T>& a, long long i,
                                               int p, const Src& src,
                                               int lanes, T (&acc)[L]) {
  const long long bs = a.bs;
  row_product_rt<T, L>(a.data + (i * bs + p) * bs, a.nb * bs * bs,
                       a.offsets, a.nd, i, a.bs, src, lanes, acc);
}

// ---- B1 -----------------------------------------------------------------

template <typename T, int BS, int L, int Mode>
__global__ void __launch_bounds__(kThreads)
    block_dia_spmv_kernel(const Args<T> a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (BS > 0) {
    if (t >= a.nb) return;
    for (int k0 = 0; k0 < a.lanes; k0 += L) {       // the lane tiles
      const int lanes = a.lanes - k0 < L ? a.lanes - k0 : L;
      const long long lane0 = k0 * a.n;
      T acc[L][BS];
      node_product<T, BS, L>(a, t, LocalSource<T>{a.x + lane0, a.n, a.nb, BS},
                             lanes, acc);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (!live<L>(l, lanes)) continue;
#pragma unroll
        for (int p = 0; p < BS; ++p) {
          const long long e = lane0 + l * a.n + t * BS + p;
          a.y[e] = Mode == RESID ? a.b[e] - acc[l][p] : acc[l][p];
        }
      }
    }
  } else {
    const long long i = t / a.bs;
    const int p = static_cast<int>(t - i * a.bs);
    if (i >= a.nb) return;
    for (int k0 = 0; k0 < a.lanes; k0 += L) {
      const int lanes = a.lanes - k0 < L ? a.lanes - k0 : L;
      const long long lane0 = k0 * a.n;
      T acc[L];
      row_product_rt<T, L>(a, i, p,
                           LocalSource<T>{a.x + lane0, a.n, a.nb, a.bs},
                           lanes, acc);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (!live<L>(l, lanes)) continue;
        const long long e = lane0 + l * a.n + t;
        a.y[e] = Mode == RESID ? a.b[e] - acc[l] : acc[l];
      }
    }
  }
}

// ---- B2 -----------------------------------------------------------------

template <typename T, int BS, int L, int Mode>
__global__ void __launch_bounds__(kThreads)
    block_dia_jacobi_kernel(const Args<T> a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const T w = Mode == COLOUR ? T(1) : weight(a);
  const long long n = a.n;
  if constexpr (BS > 0) {
    const long long i = t;
    if (i >= a.nb) return;
    const bool other = Mode == COLOUR && a.colors[i] != a.colour;
    for (int k0 = 0; k0 < a.lanes; k0 += L) {       // the lane tiles
      const int lanes = a.lanes - k0 < L ? a.lanes - k0 : L;
      const long long lane0 = k0 * n;
      const T* __restrict__ x =
          Mode == STEP || Mode == COLOUR ? a.x + lane0 : nullptr;
      const T* __restrict__ b = a.b + lane0;
      T* __restrict__ y = a.y + lane0;
      if (other) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (!live<L>(l, lanes)) continue;
#pragma unroll
          for (int p = 0; p < BS; ++p) {
            y[l * n + i * BS + p] = x[l * n + i * BS + p];
          }
        }
        continue;
      }
      if constexpr (Mode == ZERO || Mode == ZERO_RES) {
        T D[BS * BS];
        load_run<T, BS * BS>(a.dinv + i * (BS * BS), D);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (!live<L>(l, lanes)) continue;
          T xi[BS];
          zero_sweep<T, BS>(D, b + l * n + i * BS, w, xi);
#pragma unroll
          for (int p = 0; p < BS; ++p) y[l * n + i * BS + p] = xi[p];
        }
        if constexpr (Mode == ZERO_RES) {
          T acc[L][BS];
          node_product<T, BS, L>(a, i, ZeroGuessSource<T>{a, b, n, w}, lanes,
                                 acc);
          T* __restrict__ r = a.r + lane0;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            if (!live<L>(l, lanes)) continue;
#pragma unroll
            for (int p = 0; p < BS; ++p) {
              const long long e = l * n + i * BS + p;
              r[e] = b[e] - acc[l][p];
            }
          }
        }
      } else {
        T acc[L][BS], D[BS * BS];
        node_product<T, BS, L>(a, i, LocalSource<T>{x, n, a.nb, BS}, lanes,
                               acc);
        load_run<T, BS * BS>(a.dinv + i * (BS * BS), D);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (!live<L>(l, lanes)) continue;
          T res[BS];
#pragma unroll
          for (int q = 0; q < BS; ++q) {
            res[q] = b[l * n + i * BS + q] - acc[l][q];
          }
#pragma unroll
          for (int p = 0; p < BS; ++p) {
            T s = T(0);
#pragma unroll
            for (int q = 0; q < BS; ++q) s += D[p * BS + q] * res[q];
            const long long e = l * n + i * BS + p;
            y[e] = Mode == COLOUR ? x[e] + s : x[e] + w * s;
          }
        }
      }
    }
  } else {
    const int bs = a.bs;
    const long long i = t / bs;
    const int p = static_cast<int>(t - i * bs);
    if (i >= a.nb) return;
    const bool other = Mode == COLOUR && a.colors[i] != a.colour;
    // this component's row of Dinv_i
    const T* Drow = a.dinv + (i * bs + p) * bs;
    for (int k0 = 0; k0 < a.lanes; k0 += L) {
      const int lanes = a.lanes - k0 < L ? a.lanes - k0 : L;
      const long long lane0 = k0 * n;
      const T* __restrict__ x =
          Mode == STEP || Mode == COLOUR ? a.x + lane0 : nullptr;
      const T* __restrict__ b = a.b + lane0;
      T* __restrict__ y = a.y + lane0;
      if (other) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (live<L>(l, lanes)) y[l * n + t] = x[l * n + t];
        }
        continue;
      }
      if constexpr (Mode == ZERO || Mode == ZERO_RES) {
        T v[L];
        zero_sweep_rt<T, L>(Drow, b + i * bs, n, bs, w, lanes, v);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (live<L>(l, lanes)) y[l * n + t] = v[l];
        }
        if constexpr (Mode == ZERO_RES) {
          T acc[L];
          row_product_rt<T, L>(a, i, p, ZeroGuessSource<T>{a, b, n, w},
                               lanes, acc);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            if (live<L>(l, lanes)) a.r[lane0 + l * n + t] = b[l * n + t] - acc[l];
          }
        }
      } else {
        // the row of Dinv_i against the node's whole residual, lane by lane
        T s[L];
#pragma unroll
        for (int l = 0; l < L; ++l) s[l] = T(0);
        for (int q = 0; q < bs; ++q) {
          T acc[L];
          row_product_rt<T, L>(a, i, q, LocalSource<T>{x, n, a.nb, bs},
                               lanes, acc);
          const T dq = Drow[q];
#pragma unroll
          for (int l = 0; l < L; ++l) {
            if (live<L>(l, lanes)) {
              const T res = b[l * n + i * bs + q] - acc[l];
              s[l] += dq * res;
            }
          }
        }
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (!live<L>(l, lanes)) continue;
          const long long e = l * n + t;
          y[e] = Mode == COLOUR ? x[e] + s[l] : x[e] + w * s[l];
        }
      }
    }
  }
}

// ---- B3 -----------------------------------------------------------------

// block diagonals whose loads a node issues together (node_product): on
// the grid route all of a 9-point node stencil's at bs <= 2 and a third
// of them at larger blocks; on the one-CTA route, whose 1024 threads have
// 64 registers each, a third, or two at bs > 2
template <int BS, bool GRID>
struct SweepChunk {
  static constexpr int value =
      GRID ? (BS > 0 && BS <= 2 ? 9 : 3) : (BS > 0 && BS <= 2 ? 3 : 2);
};

template <typename T>
struct SweepArgs {
  Args<T> a;              // x the caller's iterate (read only), y the
                          // result (x itself for a launch that continues
                          // one), b, Dinv, the colours
  const int* rows;        // the coloured nodes, by colour
  const int* coff;        // (ncolours + 1,)
  int ncolours;
  T* scratch;             // (largest colour * bs,), where staged
  int staged;             // a phase's values go through scratch
};

// B2 COLOUR's update of node i less its x: Dinv_i (b_i - (A v)_i), v
// from `src`; compile-time block size, one vector.  Dinv_i and b_i are
// loaded with the neighbours, not after them (one round trip a node).
template <typename T, int BS, int CH, typename Src>
__device__ __forceinline__ void colour_delta(const Args<T>& a, long long i,
                                             const Src& src, T (&out)[BS]) {
  T acc[1][BS], D[BS * BS], bi[BS];
  load_run<T, BS * BS>(a.dinv + i * (BS * BS), D);
#pragma unroll
  for (int q = 0; q < BS; ++q) bi[q] = __ldg(a.b + i * BS + q);
  node_product<T, BS, 1, CH>(a, i, src, 1, acc);
  T res[BS];
#pragma unroll
  for (int q = 0; q < BS; ++q) res[q] = bi[q] - acc[0][q];
#pragma unroll
  for (int p = 0; p < BS; ++p) {
    T sum = T(0);
#pragma unroll
    for (int q = 0; q < BS; ++q) sum += D[p * BS + q] * res[q];
    out[p] = sum;
  }
}

// ... its component p (run-time block size), as B2's run-time instance
template <typename T, typename Src>
__device__ __forceinline__ T colour_delta_rt(const Args<T>& a, long long i,
                                             int p, const Src& src) {
  const long long bs = a.bs;
  const T* Drow = a.dinv + (i * bs + p) * bs;
  T sum = T(0);
  for (int q = 0; q < a.bs; ++q) {
    T acc[1];
    row_product_rt<T, 1>(a, i, q, src, 1, acc);
    const T dq = Drow[q];
    const T res = __ldg(a.b + i * bs + q) - acc[0];
    sum += dq * res;
  }
  return sum;
}

// The grid route: the first phase out of place over every node, the later
// ones in place in y (or staged), a grid-wide barrier between phases.
template <typename T, int BS>
__device__ __forceinline__ void grid_block_sweep(const SweepArgs<T>& s,
                                                 const Args<T>& a,
                                                 const Order& order,
                                                 const int* coff) {
  constexpr int CH = SweepChunk<BS, true>::value;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long bs = BS > 0 ? BS : a.bs;
  int ph = 0;
  if (a.x != a.y) {
    // the first phase out of place, over every node: its colour's nodes
    // from x, every other node (the padding too) copied
    const int c = order.c[0];
    const LocalSource<T> in{a.x, 0, a.nb, a.bs};
    if constexpr (BS > 0) {
      for (long long i = t0; i < a.nb; i += stride) {
        const bool mine = __ldg(a.colors + i) == c;
        T xi[BS], delta[BS];
#pragma unroll
        for (int p = 0; p < BS; ++p) xi[p] = __ldg(a.x + i * BS + p);
        if (mine) colour_delta<T, BS, CH>(a, i, in, delta);
#pragma unroll
        for (int p = 0; p < BS; ++p) {
          a.y[i * BS + p] = mine ? xi[p] + delta[p] : xi[p];
        }
      }
    } else {
      for (long long t = t0; t < a.nb * bs; t += stride) {
        const long long i = t / bs;
        const T xi = __ldg(a.x + t);
        a.y[t] = __ldg(a.colors + i) == c
                     ? xi + colour_delta_rt(a, i, static_cast<int>(t - i * bs), in)
                     : xi;
      }
    }
    ph = 1;
  }
  // the thread's first node of phase q, loaded before the barrier that
  // opens the phase (the nodes are read only; the run-time block size
  // takes its nodes one component a thread, and no prefetch)
  auto first_node = [&](int q) -> long long {
    if (BS == 0 || q >= order.n) return -1;
    const long long k = coff[order.c[q]] + t0;
    return k < coff[order.c[q] + 1] ? __ldg(s.rows + k) : -1;
  };
  long long next = first_node(ph);
  if (ph == 1) phase_barrier<true>();
  const LocalSource<T, LOAD_L2> src{a.y, 0, a.nb, a.bs};
  for (; ph < order.n; ++ph) {
    const int c = order.c[ph];
    const long long lo = coff[c], hi = coff[c + 1];
    const long long mine = next;
    if constexpr (BS > 0) {
      // a thread a node
      for (long long k = lo + t0; k < hi; k += stride) {
        const long long i = k == lo + t0 ? mine : __ldg(s.rows + k);
        T xi[BS], delta[BS];
#pragma unroll
        for (int p = 0; p < BS; ++p) xi[p] = __ldcg(a.y + i * BS + p);
        colour_delta<T, BS, CH>(a, i, src, delta);
#pragma unroll
        for (int p = 0; p < BS; ++p) {
          const T v = xi[p] + delta[p];
          if (s.staged) {
            s.scratch[(k - lo) * BS + p] = v;
          } else {
            a.y[i * BS + p] = v;
          }
        }
      }
    } else {
      // a thread a component
      for (long long t = lo * bs + t0; t < hi * bs; t += stride) {
        const long long k = t / bs;
        const int p = static_cast<int>(t - k * bs);
        const long long i = __ldg(s.rows + k);
        s.scratch[t - lo * bs] =
            __ldcg(a.y + i * bs + p) + colour_delta_rt(a, i, p, src);
      }
    }
    next = first_node(ph + 1);
    phase_barrier<true>();
    if (s.staged) {
      for (long long t = lo * bs + t0; t < hi * bs; t += stride) {
        const long long k = t / bs;
        a.y[__ldg(s.rows + k) * bs + (t - k * bs)] = s.scratch[t - lo * bs];
      }
      phase_barrier<true>();
    }
  }
}

// The one-CTA route: x copied into shared memory (xs), every phase in
// place there (its colour's nodes only), the result written to y at the
// end.
template <typename T, int BS>
__device__ __forceinline__ void cta_block_sweep(const SweepArgs<T>& s,
                                                const Args<T>& a,
                                                const Order& order,
                                                const int* coff, T* xs) {
  constexpr int CH = SweepChunk<BS, false>::value;
  const long long bs = BS > 0 ? BS : a.bs;
  const long long n = a.nb * bs;
  for (long long t = threadIdx.x; t < n; t += blockDim.x) xs[t] = a.x[t];
  __syncthreads();
  const LocalSource<T, LOAD_SHARED> src{xs, 0, a.nb, a.bs};
  for (int ph = 0; ph < order.n; ++ph) {
    const int c = order.c[ph];
    const long long lo = coff[c], hi = coff[c + 1];
    if constexpr (BS > 0) {
      for (long long k = lo + threadIdx.x; k < hi; k += blockDim.x) {
        const long long i = __ldg(s.rows + k);
        T delta[BS];
        colour_delta<T, BS, CH>(a, i, src, delta);
#pragma unroll
        for (int p = 0; p < BS; ++p) {
          const T v = xs[i * BS + p] + delta[p];
          if (s.staged) {
            s.scratch[(k - lo) * BS + p] = v;
          } else {
            xs[i * BS + p] = v;
          }
        }
      }
    } else {
      for (long long t = lo * bs + threadIdx.x; t < hi * bs;
           t += blockDim.x) {
        const long long k = t / bs;
        const int p = static_cast<int>(t - k * bs);
        const long long i = __ldg(s.rows + k);
        s.scratch[t - lo * bs] = xs[i * bs + p] + colour_delta_rt(a, i, p, src);
      }
    }
    __syncthreads();
    if (s.staged) {
      for (long long t = lo * bs + threadIdx.x; t < hi * bs;
           t += blockDim.x) {
        const long long k = t / bs;
        xs[__ldg(s.rows + k) * bs + (t - k * bs)] = s.scratch[t - lo * bs];
      }
      __syncthreads();
    }
  }
  for (long long t = threadIdx.x; t < n; t += blockDim.x) a.y[t] = xs[t];
}

template <typename T, int BS, bool GRID>
__global__ void __launch_bounds__(GRID ? kGridThreads : kMaxThreads)
    block_mcgs_sweep_kernel(const SweepArgs<T> s, const Order order) {
  extern __shared__ __align__(16) int smem[];
  // the operator with its diagonal offsets in shared memory
  Args<T> a = s.a;
  a.offsets = stage_offsets(smem, s.coff, s.ncolours, s.a.offsets, a.nd);
  if constexpr (GRID) {
    grid_block_sweep<T, BS>(s, a, order, smem);
  } else {
    cta_block_sweep<T, BS>(s, a, order, smem,
                           shared_x<T>(smem, s.ncolours, a.nd));
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
  int lanes;
};

// node j's source of x (HaloSource) for lanes [k0, ...) of this block of
// node rows
template <typename T, bool INTERIOR>
__device__ __forceinline__ HaloSource<T, INTERIOR> halo_source(
    const HaloArgs<T>& a, int k0, int bs) {
  return HaloSource<T, INTERIOR>{a.x + k0 * a.ldx, a.ldx,
                                 a.left + k0 * a.ldl, a.ldl,
                                 a.right + k0 * a.ldr, a.ldr,
                                 a.nb, a.halo, bs};
}

template <typename T, int BS, int L, int Mode>
__global__ void __launch_bounds__(kThreads)
    block_dia_halo_kernel(const HaloArgs<T> a) {
  // the launch's row blocks, [a0, a1) then [b0, ...), one a CTA; every
  // lane in the thread, in B1's lane tiles
  const int v = static_cast<int>(blockIdx.x);
  const int na = a.a1 - a.a0;
  const int rb = v < na ? a.a0 + v : a.b0 + (v - na);
  const bool interior = rb >= a.lo && rb < a.hi;
  const long long n0 = static_cast<long long>(rb) * kThreads;
  if constexpr (BS > 0) {
    const long long i = n0 + threadIdx.x;
    if (i >= a.nb) return;
    const T* blocks = a.data + i * (BS * BS);
    for (int k0 = 0; k0 < a.lanes; k0 += L) {
      const int lanes = a.lanes - k0 < L ? a.lanes - k0 : L;
      T acc[L][BS];
      if (interior) {
        node_product<T, BS, L>(blocks, a.ld, a.offsets, a.nd, i,
                               halo_source<T, true>(a, k0, BS), lanes, acc);
      } else {
        node_product<T, BS, L>(blocks, a.ld, a.offsets, a.nd, i,
                               halo_source<T, false>(a, k0, BS), lanes, acc);
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (!live<L>(l, lanes)) continue;
#pragma unroll
        for (int p = 0; p < BS; ++p) {
          const long long e = (k0 + l) * a.ldx + i * BS + p;
          a.y[e] = Mode == RESID ? a.b[e] - acc[l][p] : acc[l][p];
        }
      }
    }
  } else {
    // run-time bs: the CTA's 256 nodes, a thread per component in turn
    const int bs = a.bs;
    const long long n1 = n0 + kThreads < a.nb ? n0 + kThreads : a.nb;
    for (long long t = n0 * bs + threadIdx.x; t < n1 * bs; t += kThreads) {
      const long long i = t / bs;
      const T* row = a.data + t * bs;
      for (int k0 = 0; k0 < a.lanes; k0 += L) {
        const int lanes = a.lanes - k0 < L ? a.lanes - k0 : L;
        T acc[L];
        if (interior) {
          row_product_rt<T, L>(row, a.ld, a.offsets, a.nd, i, bs,
                               halo_source<T, true>(a, k0, bs), lanes, acc);
        } else {
          row_product_rt<T, L>(row, a.ld, a.offsets, a.nd, i, bs,
                               halo_source<T, false>(a, k0, bs), lanes, acc);
        }
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (!live<L>(l, lanes)) continue;
          const long long e = (k0 + l) * a.ldx + t;
          a.y[e] = Mode == RESID ? a.b[e] - acc[l] : acc[l];
        }
      }
    }
  }
}

// ---- launchers ----------------------------------------------------------

// The lane tile of a launch of `lanes` lanes for the instance (T, BS): 1
// for one vector, else lane_tile (the kernel walks more lanes in two or
// more tiles).  Calls run(std::integral_constant<int, L>{}).
template <typename T, int BS, typename Run>
void with_tile(int lanes, Run&& run) {
  if (lanes == 1) {
    run(std::integral_constant<int, 1>{});
  } else {
    run(std::integral_constant<int, lane_tile<T, BS>()>{});
  }
}

template <typename T, int BS>
void launch_halo_mode(const HaloArgs<T>& a, dim3 blocks, int mode,
                      cudaStream_t s) {
  with_tile<T, BS>(a.lanes, [&](auto tile) {
    constexpr int L = decltype(tile)::value;
    if (mode == RESID) {
      block_dia_halo_kernel<T, BS, L, RESID><<<blocks, kThreads, 0, s>>>(a);
    } else {
      block_dia_halo_kernel<T, BS, L, PLAIN><<<blocks, kThreads, 0, s>>>(a);
    }
  });
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
                      a0, a1, b0, lanes};
  const dim3 blocks(static_cast<unsigned int>((a1 - a0) + (b1 - b0)));
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

template <typename T, int BS>
dim3 grid_of(const Args<T>& a) {
  const long long threads = BS > 0 ? a.nb : a.nb * a.bs;
  return dim3(static_cast<unsigned int>((threads + kThreads - 1) / kThreads));
}

template <typename T, int BS>
struct SpmvLaunch {
  static void run(const Args<T>& a, int mode, cudaStream_t s) {
    const dim3 g = grid_of<T, BS>(a);
    with_tile<T, BS>(a.lanes, [&](auto tile) {
      constexpr int L = decltype(tile)::value;
      if (mode == RESID) {
        block_dia_spmv_kernel<T, BS, L, RESID><<<g, kThreads, 0, s>>>(a);
      } else {
        block_dia_spmv_kernel<T, BS, L, PLAIN><<<g, kThreads, 0, s>>>(a);
      }
    });
  }
};

template <typename T, int BS>
struct JacobiLaunch {
  static void run(const Args<T>& a, int mode, cudaStream_t s) {
    const dim3 g = grid_of<T, BS>(a);
    with_tile<T, BS>(a.lanes, [&](auto tile) {
      constexpr int L = decltype(tile)::value;
      switch (mode) {
        case ZERO:
          block_dia_jacobi_kernel<T, BS, L, ZERO><<<g, kThreads, 0, s>>>(a);
          break;
        case ZERO_RES:
          block_dia_jacobi_kernel<T, BS, L, ZERO_RES><<<g, kThreads, 0, s>>>(a);
          break;
        case STEP:
          block_dia_jacobi_kernel<T, BS, L, STEP><<<g, kThreads, 0, s>>>(a);
          break;
        default:
          block_dia_jacobi_kernel<T, BS, L, COLOUR><<<g, kThreads, 0, s>>>(a);
          break;
      }
    });
  }
};

// The instance for a.bs: the unrolled one, or the run-time one where a
// block of 16-byte words (bs 2, 4) does not start 16-byte aligned.
template <typename T, template <typename, int> class Launch>
int dispatch(const Args<T>& a, int mode, void* stream) {
  if (a.nb <= 0 || a.lanes <= 0) return static_cast<int>(cudaSuccess);
  if (a.nb * a.bs / kThreads + 1 >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool words = (a.bs * a.bs * sizeof(T)) % 16 == 0;
  const bool aligned =
      reinterpret_cast<uintptr_t>(a.data) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.dinv) % 16 == 0;
  switch (words && !aligned ? 0 : a.bs) {
    case 1: Launch<T, 1>::run(a, mode, s); break;
    case 2: Launch<T, 2>::run(a, mode, s); break;
    case 3: Launch<T, 3>::run(a, mode, s); break;
    case 4: Launch<T, 4>::run(a, mode, s); break;
    default: Launch<T, 0>::run(a, mode, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(const void* data, const void* offsets, int nd,
                  long long nb, int bs, int lanes, const void* x,
                  const void* b, const void* dinv, T omega,
                  const void* omega_dev, const void* colors, int colour,
                  void* y, void* r) {
  return Args<T>{static_cast<const T*>(data),
                 static_cast<const int*>(offsets),
                 nd,
                 nb,
                 bs,
                 nb * bs,
                 lanes,
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

template <typename T, int BS>
cudaError_t launch_block_sweep(const SweepArgs<T>& s, const Order& o,
                               int threads, long long max_nodes,
                               int grid_route, cudaStream_t st) {
  // the run-time block size's threads own a component each: staged
  if (BS == 0 && !s.staged) return cudaErrorInvalidValue;
  return launch_sweep_route(
      block_mcgs_sweep_kernel<T, BS, true>,
      block_mcgs_sweep_kernel<T, BS, false>, s, o, threads,
      BS > 0 ? max_nodes : max_nodes * s.a.bs, grid_route, s.ncolours,
      s.a.nd, static_cast<size_t>(s.a.n) * sizeof(T), st);
}

template <typename T>
int block_sweep(const void* data, const void* offsets, int nd, long long nb,
                int bs, const void* x_in, void* x, const void* b,
                const void* dinv, const void* colors, const void* rows,
                const void* coff, int ncolours, long long max_nodes,
                void* scratch, const int* order, int norder, int threads,
                int grid_route, int staged, void* stream) {
  Order o;
  if (nb <= 0 || bs < 1 || nd < 0 || ncolours < 1 ||
      nb * bs / kMaxThreads + 1 >= (1LL << 31) ||
      !make_order(order, norder, o) ||
      !sweep_threads_ok(threads, grid_route) ||
      max_nodes < 0 || (staged && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SweepArgs<T> s{
      make_args<T>(data, offsets, nd, nb, bs, 1, x_in, b, dinv, T(1),
                   nullptr, colors, 0, x, nullptr),
      static_cast<const int*>(rows), static_cast<const int*>(coff), ncolours,
      static_cast<T*>(scratch), staged};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // B2's instance choice (dispatch above), so each node keeps B2's bits
  const bool words = (bs * bs * sizeof(T)) % 16 == 0;
  const bool aligned = reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dinv) % 16 == 0;
  cudaError_t err;
  switch (words && !aligned ? 0 : bs) {
    case 1:
      err = launch_block_sweep<T, 1>(s, o, threads, max_nodes, grid_route,
                                     st);
      break;
    case 2:
      err = launch_block_sweep<T, 2>(s, o, threads, max_nodes, grid_route,
                                     st);
      break;
    case 3:
      err = launch_block_sweep<T, 3>(s, o, threads, max_nodes, grid_route,
                                     st);
      break;
    case 4:
      err = launch_block_sweep<T, 4>(s, o, threads, max_nodes, grid_route,
                                     st);
      break;
    default:
      err = launch_block_sweep<T, 0>(s, o, threads, max_nodes, grid_route,
                                     st);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B1: data, offsets, nd, nb, bs, lanes, x, b, y, mode, stream
int pyamg_block_dia_spmv_f32(const void* data, const void* offsets, int nd,
                             long long nb, int bs, int lanes, const void* x,
                             const void* b, void* y, int mode, void* stream) {
  return dispatch<float, SpmvLaunch>(
      make_args<float>(data, offsets, nd, nb, bs, lanes, x, b, nullptr, 0.0f,
                       nullptr, nullptr, 0, y, nullptr),
      mode, stream);
}

int pyamg_block_dia_spmv_f64(const void* data, const void* offsets, int nd,
                             long long nb, int bs, int lanes, const void* x,
                             const void* b, void* y, int mode, void* stream) {
  return dispatch<double, SpmvLaunch>(
      make_args<double>(data, offsets, nd, nb, bs, lanes, x, b, nullptr, 0.0,
                        nullptr, nullptr, 0, y, nullptr),
      mode, stream);
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
      make_args<float>(data, offsets, nd, nb, bs, lanes, x, b, dinv, omega,
                       omega_dev, colors, colour, y, r),
      mode, stream);
}

int pyamg_block_dia_jacobi_f64(const void* data, const void* offsets, int nd,
                               long long nb, int bs, int lanes, const void* x,
                               const void* b, const void* dinv, double omega,
                               const void* omega_dev, const void* colors,
                               int colour, void* y, void* r, int mode,
                               void* stream) {
  return dispatch<double, JacobiLaunch>(
      make_args<double>(data, offsets, nd, nb, bs, lanes, x, b, dinv, omega,
                        omega_dev, colors, colour, y, r),
      mode, stream);
}

// B3: data, offsets, nd, nb, bs, x_in (the caller's iterate, read only;
// x itself for a launch that continues one), x (the result), b, dinv,
// colors, rows, coff, ncolours, max_nodes (the largest colour), scratch
// (staged, else null), order (host ints), norder, threads, grid_route,
// staged (the run-time block size requires it), stream
int pyamg_block_mcgs_sweep_f32(const void* data, const void* offsets, int nd,
                               long long nb, int bs, const void* x_in,
                               void* x, const void* b, const void* dinv,
                               const void* colors, const void* rows,
                               const void* coff, int ncolours,
                               long long max_nodes, void* scratch,
                               const int* order, int norder, int threads,
                               int grid_route, int staged, void* stream) {
  return block_sweep<float>(data, offsets, nd, nb, bs, x_in, x, b, dinv,
                            colors, rows, coff, ncolours, max_nodes, scratch,
                            order, norder, threads, grid_route, staged,
                            stream);
}

int pyamg_block_mcgs_sweep_f64(const void* data, const void* offsets, int nd,
                               long long nb, int bs, const void* x_in,
                               void* x, const void* b, const void* dinv,
                               const void* colors, const void* rows,
                               const void* coff, int ncolours,
                               long long max_nodes, void* scratch,
                               const int* order, int norder, int threads,
                               int grid_route, int staged, void* stream) {
  return block_sweep<double>(data, offsets, nd, nb, bs, x_in, x, b, dinv,
                             colors, rows, coff, ncolours, max_nodes,
                             scratch, order, norder, threads, grid_route,
                             staged, stream);
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
