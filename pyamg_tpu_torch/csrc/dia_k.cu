// K-lane DIA kernels of pyamg_tpu_torch, for Hopper (sm_90a): one
// operator applied to K right-hand sides at once, lanes K-major
// ((K, n_pad) stacks, lane k's row contiguous), as the batched solve
// carries them.
//
//   dia_k_lane_kernel<T, Mode, ND, VEC> (and, for the shapes it refuses,
//   dia_k_kernel<T, Mode>), K8, K9 and K10:
//     SPMM         Y = A X                  pyamg_tpu/sparse/dia.py::_dia_pallas_matmat_k (plain)
//     SPMM_SCALED  Y = s * (A X), s (n_pad,) shared by the lanes
//                                           pyamg_tpu/sparse/dia.py::_dia_pallas_matmat_k (scale=)
//     SPMM_ADD     Y = V + A X, V (K, n_pad) per lane
//                                           pyamg_tpu/sparse/dia.py::_dia_pallas_matmat_k (addk=)
//     JACOBI_K     Y = X + w * dinv * (B - A X)
//                                           pyamg_tpu/sparse/dia.py::dia_pallas_jacobi_km
//     ZERO_RES_K   Y = w * dinv * B,  R = B - A Y
//                                           pyamg_tpu/sparse/dia.py::dia_pallas_jacobi_zero_res_km
//   zero_chain_k_ring_kernel<T, ND, NDS> and zero_chain_k_kernel<T>, K11:
//     X = w * dinv * B,  Y = tv * (St (B - A X)); the residual is never
//     stored                                pyamg_tpu/sparse/dia.py::dia_pallas_zero_chain_km
//
// Layout: data (nd, n_pad) row-major, data[d, i] = A[i, i + offsets[d]],
// zero where A has no entry or the column falls outside [0, n_pad).
// Stacks are (lanes, n_pad) row-major; dia_k_kernel covers at most
// kMaxLanes lanes a launch (the wrapper launches larger K in chunks on
// slices of the stack), dia_k_lane_kernel every lane in one launch.
//
// Bound: device-memory bandwidth.  Unique traffic per row is nd diagonals
// plus 2K (SPMM), 2K + 1 (SPMM_SCALED), 3K (SPMM_ADD), 3K + 1 (JACOBI_K)
// or 3K + 1 (ZERO_RES_K) values, against 2 nd K flops: at K = 8, nd = 5
// about one flop per byte in f32, far below the card's ~20 flops per
// byte.
//
// K8, K9 and K10, dia_k_lane_kernel: the lane on the grid.  A CTA of 256
// threads streams one lane's contiguous rows, as the single-lane K1 does:
// 4 float32 rows a thread in 16-byte loads and stores (the row's
// diagonals, V, B, X, dinv, Y and R; a neighbour run at an offset that is
// no multiple of 4 from the two aligned 16-byte runs around it,
// csrc/lane_io.cuh::ld_x), or 1 row a thread in
// float64 and where a float32 n_pad is no multiple of 4 or an operand not
// 16-byte aligned (the coarse levels' odd n_pad).
// The blocks walk super tiles of row blocks (128 in float32, 1 in
// float64: each the faster of the two in its type, PERF.md §6), the lanes
// of a tile one after another, so the diagonals, dinv
// and s come from device memory once and from L2 for the other K - 1
// lanes, and few of the lanes' streams are open at once; the stacks
// stream through evict-first (__ldcs/__stcs: V, B and Y are touched
// once).  What held the thread-per-row form (dia_k_kernel) at half its
// bound is the layout of its loads, not its loop: for each diagonal, a
// warp of it issued one load per lane, K runs of 128 bytes n_pad values
// apart, and the form with the loop unrolled, the offsets as arguments and
// no interior checks ran no faster (scripts/dia_k_variants.cu, PERF.md
// §6).  ND, when not 0, fixes the diagonal count at compile time (5 and
// 9, the 2-D grids' levels; for K10 also 7, the 3-D grids' fine levels),
// so the term loop unrolls and all of a row's
// loads issue together; the offsets arrive as a kernel argument (copied to
// shared memory for the run-time loop), not as a load per thread and
// diagonal; the row blocks whose neighbours all lie in [0, n_pad), with 3
// rows to spare on either side for the aligned runs (the wrapper's plan,
// sparse/dia.py::k8_plan), carry no bounds checks, the others select the
// sum they had for an out-of-range term.  Each value is
// the thread-per-row form's: the diagonals in offset order, one FMA a term
// (what nvcc's contraction made of acc += a * x), an out-of-range
// neighbour's term left out, then the epilogue with that form's
// contraction (JACOBI_K: fma(w, dinv * (b - acc), x)); so both forms give
// the same bits.  Rows are int: n_pad < 2^31.
//
// dia_k_kernel, one thread per row, looping over the lanes inside:
// data[d, i], dinv[i] and the offsets are loaded once per row for all
// lanes.  K8, K9 and K10 take it where the lane kernel does not take the
// shape (rows past 2^31, more than kMaxArgDiags diagonals).
// Each lane's sum runs over the diagonals in offset order, then the
// epilogue, as the reference's composed form and the single-lane kernels
// (csrc/dia.cu) do; nvcc contracts to FMAs, so results agree with the
// plain PyTorch twins to rounding.  The per-lane sums live in a register
// array of kMaxLanes, indexed only by unrolled constants.
//
// K11 keeps the residual r = B - A X out of device memory, as the TPU
// kernel does, but computes each r_j once: zero_chain_k_ring_kernel is a
// strip march.  A CTA owns a contiguous strip of rows and one group of up
// to kRingLanes lanes (blockIdx.y), and walks its strip in steps of 1024
// rows, one per thread.  Shared memory holds a ring of r for the rows
// [i - hl, i + 2048 + hr) (hl and hr the reach of St's offsets below and
// above the diagonal): before the march the first step's window, then in
// each step's one pass the next step's new r rows (their reads of B at
// A's offsets mostly hit L2) and this step's X and Y rows, X from B and Y
// from the ring, with one barrier per step.  Only the hl + hr rows at each
// strip's start are computed twice (by this strip and the one before).
// The wrapper's plan (sparse/dia.py::k11_plan) sizes the ring to the
// card's 227 KB of shared memory per block: lanes go in groups that fit,
// and the operator's diagonals are read once per group.  The ring allows
// one CTA per SM (32 warps, 64 registers a thread), so the kernel hides
// latency by the loads it keeps in flight: the term loops unroll for the
// 5- and 9-diagonal operators of 2-D grids (float32), an out-of-range
// neighbour selects the sum it had instead of branching around its term
// (only in passes that reach past either end), and the streamed arrays
// leave L2 first, so that it keeps the rows of B and dinv read again
// within the reach.  Every value keeps the per-row kernel's arithmetic:
// e ascending with the out-of-range skip, one FMA per term (what nvcc's
// contraction made of acc += a * (w * (dm * b)) and acc2 += sv * (b_j -
// acc1)), r_j = b_j - acc1 rounded to T, then s ascending; so the ring
// kernel gives the per-row kernel's bits.
//
// zero_chain_k_kernel, one thread per row, stays for an St whose reach
// is too large for one lane's ring (2048 + hl + hr rows beyond 227 KB,
// as with a 3-D grid's +-n^2 offset): it recomputes each r_j it needs for
// every St neighbour j of row i, per lane (as K5 does for one lane,
// csrc/dia_chain.cu), nd * nds inner terms per row and lane.
//
// ZERO_RES_K forms each neighbour's iterate w * dinv_j * b_j from b as it
// goes (the zero-guess sweep needs no x input), so Y and R leave in one
// pass and Y is never read back: the reference's point, which saves the
// composed form's extra (K, n_pad) round trip.  In the lane kernel the
// neighbour's B and dinv come as runs through ld_x (dinv, shared by the
// lanes, from L2 after the super tile's first lane), B and dinv of the
// row itself as plain 16-byte loads (B is read again by the neighbouring
// rows, so it is not streamed evict-first), Y and R leave evict-first;
// each term is fma(a, w * (dinv_j * b_j), acc) in offset order with the
// out-of-range ones left out, then Y = w * (dinv_i * b_i), R = b_i - acc:
// the thread-per-row form's contraction, so both forms give the same
// bits.  Bound: (nd + 1 + 3K) n_pad values.
//
// Out-of-range neighbours: the TPU kernels clamp their halo reads and
// multiply the garbage by structurally-zero slots.  Here an index outside
// [0, n_pad), at either stage, skips its term, since the read would fault.
// All stack offsets k * n_pad + i are 64-bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "lane_io.cuh"

namespace {

constexpr int kMaxLanes = 16;
constexpr int kThreads = 256;
// K8 and K9's lane kernel: the offsets it takes as a kernel argument at
// most
constexpr int kMaxArgDiags = 32;
// K11's strip march: threads per CTA and rows per step, and lanes per
// group (its register arrays); the ring's shared memory per block at most
// kMaxSmem (an H100's 227 KB)
constexpr int kRingThreads = 1024;
constexpr int kRingLanes = 8;
constexpr int kMaxSmem = 232448;

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

struct DiaOffsets {
  int o[kMaxArgDiags];
};

// K8 / K9's lane kernel: rows a thread (VEC: 4 in 16-byte loads and
// stores, float32 only, or 1), rows a block, and row blocks a super tile
// (per value type)
template <typename T, int VEC>
struct LaneShape {
  static_assert(VEC == 1 || (VEC == 4 && sizeof(T) == 4),
                "4 rows a thread in float32, else 1");
  static constexpr int ROWS = kThreads * VEC;
  static constexpr int SUPER = sizeof(T) == 4 ? 128 : 1;
};

// rows [i0, i0 + VEC) of the lane at xl, bl, yl, rl (bl: s for
// SPMM_SCALED, shared by the lanes; rl: ZERO_RES_K's residual, whose X is
// formed from bl, the lane's B, as it goes); offs the offsets (a kernel
// argument when ND fixes their count, else shared memory); CHECK true
// where a neighbour may fall outside [0, n_pad) (its term left out by a
// select) or the rows past n_pad
template <typename T, int Mode, int ND, int VEC, bool CHECK>
__device__ __forceinline__ void lane_rows(const T* __restrict__ data,
                                          const int* offs, int nd, int n_pad,
                                          int i0, const T* __restrict__ xl,
                                          const T* __restrict__ bl,
                                          const T* __restrict__ dinv, T w,
                                          T* __restrict__ yl,
                                          T* __restrict__ rl) {
  if (CHECK && i0 >= n_pad) return;
  T acc[VEC];
#pragma unroll
  for (int t = 0; t < VEC; ++t) acc[t] = T(0);
  const int n_d = ND > 0 ? ND : nd;
#pragma unroll
  for (int d = 0; d < n_d; ++d) {
    const int o = offs[d];
    T a[VEC];
    ld_vec<T, VEC, false>(a, data + static_cast<int64_t>(d) * n_pad + i0);
    if (Mode == ZERO_RES_K && !CHECK) {
      // the neighbours' iterate w * dinv_j * b_j, formed from the runs of
      // B and dinv (the thread-per-row form's contraction: one FMA a term)
      T bv[VEC], dv[VEC];
      ld_x<T, VEC>(bv, bl + i0 + o, o);
      ld_x<T, VEC>(dv, dinv + i0 + o, o);
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        acc[t] = fma_rn(a[t], w * (dv[t] * bv[t]), acc[t]);
      }
    } else if (Mode == ZERO_RES_K) {
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const int j = i0 + t + o;
        const bool in = j >= 0 && j < n_pad;
        const int jc = in ? j : i0;
        const T v = fma_rn(a[t], w * (dinv[jc] * bl[jc]), acc[t]);
        acc[t] = in ? v : acc[t];
      }
    } else if (!CHECK) {
      T xv[VEC];
      ld_x<T, VEC>(xv, xl + i0 + o, o);
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = fma_rn(a[t], xv[t], acc[t]);
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const int j = i0 + t + o;
        const bool in = !CHECK || (j >= 0 && j < n_pad);
        const T v = fma_rn(a[t], xl[in ? j : i0], acc[t]);
        acc[t] = in ? v : acc[t];
      }
    }
  }
  T out[VEC];
  if (Mode == SPMM_SCALED) {
    T s[VEC];
    ld_vec<T, VEC, false>(s, bl + i0);
#pragma unroll
    for (int t = 0; t < VEC; ++t) out[t] = acc[t] * s[t];
  } else if (Mode == SPMM_ADD) {
    T v[VEC];
    ld_vec<T, VEC, true>(v, bl + i0);
#pragma unroll
    for (int t = 0; t < VEC; ++t) out[t] = acc[t] + v[t];
  } else if (Mode == JACOBI_K) {
    T xv[VEC], bv[VEC], dv[VEC];
    ld_vec<T, VEC, false>(xv, xl + i0);
    ld_vec<T, VEC, true>(bv, bl + i0);
    ld_vec<T, VEC, false>(dv, dinv + i0);
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      out[t] = fma_rn(w, dv[t] * (bv[t] - acc[t]), xv[t]);
    }
  } else if (Mode == ZERO_RES_K) {
    // B stays in L2 for the neighbouring blocks' runs: no evict-first
    T bv[VEC], dv[VEC], res[VEC];
    ld_vec<T, VEC, false>(bv, bl + i0);
    ld_vec<T, VEC, false>(dv, dinv + i0);
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      out[t] = w * (dv[t] * bv[t]);
      res[t] = bv[t] - acc[t];
    }
    st_vec<T, VEC>(rl + i0, res);
  } else {
#pragma unroll
    for (int t = 0; t < VEC; ++t) out[t] = acc[t];
  }
  st_vec<T, VEC>(yl + i0, out);
}

template <typename T, int Mode, int ND, int VEC>
__device__ __forceinline__ void lane_block(bool check,
                                           const T* __restrict__ data,
                                           const int* offs, int nd,
                                           int n_pad, int i0,
                                           const T* __restrict__ xl,
                                           const T* __restrict__ bl,
                                           const T* __restrict__ dinv, T w,
                                           T* __restrict__ yl,
                                           T* __restrict__ rl) {
  if (check) {
    lane_rows<T, Mode, ND, VEC, true>(data, offs, nd, n_pad, i0, xl, bl,
                                      dinv, w, yl, rl);
  } else {
    lane_rows<T, Mode, ND, VEC, false>(data, offs, nd, n_pad, i0, xl, bl,
                                       dinv, w, yl, rl);
  }
}

// K8, K9 and K10 with the lane on the grid (see the header): the blocks
// walk super tiles of SUPER row blocks, the lanes of a super tile one
// after another (block b of super tile st: lane (b - st * SUPER * lanes)
// / s, row block st * SUPER + its remainder, s the tile's row blocks); the
// row blocks [lo_int, hi_int) need no bounds checks.  ND, when not 0,
// fixes the diagonal count; otherwise the offsets go to shared memory
// first.  VEC rows a thread.  r: ZERO_RES_K's residual stack (x unused).
template <typename T, int Mode, int ND, int VEC>
__global__ void __launch_bounds__(kThreads)
dia_k_lane_kernel(const T* __restrict__ data, DiaOffsets offs, int nd,
                  int n_pad, int lanes, int row_blocks, int lo_int,
                  int hi_int, const T* __restrict__ x,
                  const T* __restrict__ b, const T* __restrict__ dinv,
                  T omega, const T* __restrict__ omega_dev,
                  T* __restrict__ y, T* __restrict__ r) {
  using S = LaneShape<T, VEC>;
  const int bid = static_cast<int>(blockIdx.x);
  const int st = bid / (S::SUPER * lanes);
  const int base = st * S::SUPER;
  const int tile = min(S::SUPER, row_blocks - base);
  const int rem = bid - st * S::SUPER * lanes;
  const int k = rem / tile;
  const int rb = base + rem - k * tile;
  const int64_t lo = static_cast<int64_t>(k) * n_pad;
  T w = T(0);
  if (Mode == JACOBI_K || Mode == ZERO_RES_K) {
    w = omega_dev != nullptr ? *omega_dev : omega;
  }
  const T* bl = Mode == SPMM_SCALED ? b : (Mode == SPMM ? nullptr : b + lo);
  const T* xl = Mode == ZERO_RES_K ? nullptr : x + lo;
  T* rl = Mode == ZERO_RES_K ? r + lo : nullptr;
  const int i0 = rb * S::ROWS + static_cast<int>(threadIdx.x) * VEC;
  const bool check = rb < lo_int || rb >= hi_int;
  if constexpr (ND > 0) {
    lane_block<T, Mode, ND, VEC>(check, data, offs.o, nd, n_pad, i0, xl, bl,
                                 dinv, w, y + lo, rl);
  } else {
    // a run-time index into the argument would copy it to local memory
    __shared__ int s_offs[kMaxArgDiags];
    if (threadIdx.x == 0) {
#pragma unroll
      for (int d = 0; d < kMaxArgDiags; ++d) s_offs[d] = offs.o[d];
    }
    __syncthreads();
    lane_block<T, Mode, ND, VEC>(check, data, s_offs, nd, n_pad, i0, xl, bl,
                                 dinv, w, y + lo, rl);
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

// K11's strip march, one row of a pass per thread.  The operators'
// diagonals, tv and the outputs stream through L2 evict-first (__ldcs,
// __stcs), so that L2 keeps the rows of B and dinv that a strip reads
// again within its reach: 132 strips at once each hold 2 * step + 2 *
// reach rows of them.  r_j for lanes [0, gl) of the group into ring slot
// `slot` (lane-major, ring stride cap); CHECK false when every neighbour
// of the row lies in [0, n_pad), true to skip the terms whose neighbour
// does not (a select keeps the sum as it was, so no branch holds the
// loads back).
template <typename T, int ND, bool CHECK>
__device__ __forceinline__ void ring_fill_row(
    const T* __restrict__ data, const int* __restrict__ offsets, int nd,
    int n_pad, int gl, int j, const T* __restrict__ b,
    const T* __restrict__ dinv, T w, T* ring, int cap, int slot) {
  T acc[kRingLanes];
#pragma unroll
  for (int k = 0; k < kRingLanes; ++k) acc[k] = T(0);
  const int n_e = ND > 0 ? ND : nd;
#pragma unroll
  for (int e = 0; e < n_e; ++e) {
    const int m = j + offsets[e];
    const bool in = !CHECK || (m >= 0 && m < n_pad);
    const int mc = in ? m : j;
    const T a = __ldcs(data + static_cast<int64_t>(e) * n_pad + j);
    const T dm = dinv[mc];
#pragma unroll
    for (int k = 0; k < kRingLanes; ++k) {
      if (k < gl) {
        const T v = fma_rn(a, w * (dm * b[static_cast<int64_t>(k) * n_pad
                                          + mc]), acc[k]);
        acc[k] = in ? v : acc[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRingLanes; ++k) {
    if (k < gl)
      ring[k * cap + slot] = b[static_cast<int64_t>(k) * n_pad + j] - acc[k];
  }
}

// X and Y of row `row` from the ring (its slot `base`); CHECK as above.
template <typename T, int NDS, bool CHECK>
__device__ __forceinline__ void ring_out_row(
    const T* __restrict__ sdata, const int* __restrict__ soffsets, int nds,
    int n_pad, int gl, int row, const T* __restrict__ b,
    const T* __restrict__ dinv, const T* __restrict__ tv, T w,
    const T* ring, int cap, int base, T* __restrict__ x_out,
    T* __restrict__ y_out) {
  T acc[kRingLanes];
#pragma unroll
  for (int k = 0; k < kRingLanes; ++k) acc[k] = T(0);
  const int n_s = NDS > 0 ? NDS : nds;
#pragma unroll
  for (int s = 0; s < n_s; ++s) {
    const int so = soffsets[s];
    const bool in = !CHECK || (row + so >= 0 && row + so < n_pad);
    const T sv = __ldcs(sdata + static_cast<int64_t>(s) * n_pad + row);
    int sl = base + so;
    if (sl < 0) sl += cap;
    else if (sl >= cap) sl -= cap;
#pragma unroll
    for (int k = 0; k < kRingLanes; ++k) {
      if (k < gl) {
        const T v = fma_rn(sv, ring[k * cap + sl], acc[k]);
        acc[k] = in ? v : acc[k];
      }
    }
  }
  const T di = dinv[row];
  const T t = __ldcs(tv + row);
#pragma unroll
  for (int k = 0; k < kRingLanes; ++k) {
    if (k < gl) {
      const int64_t o = static_cast<int64_t>(k) * n_pad + row;
      __stcs(x_out + o, w * (di * b[o]));
      __stcs(y_out + o, t * acc[k]);
    }
  }
}

// r for the rows [f0, f1) of a strip whose ring starts at row lo, one
// row per thread and pass; the neighbours are checked only where a pass
// reaches outside [0, n_pad) (al, ar: A's reach)
template <typename T, int ND>
__device__ __forceinline__ void ring_fill(
    const T* __restrict__ data, const int* __restrict__ offsets, int nd,
    int n_pad, int gl, int al, int ar, int f0, int f1,
    const T* __restrict__ b, const T* __restrict__ dinv, T w, T* ring,
    int cap, int lo) {
  for (int p0 = f0; p0 < f1; p0 += kRingThreads) {
    const int j = p0 + static_cast<int>(threadIdx.x);
    if (j >= f1 || j < 0 || j >= n_pad) continue;
    const int slot = static_cast<int>(static_cast<unsigned>(j - lo) %
                                      static_cast<unsigned>(cap));
    if (p0 - al >= 0 && p0 + kRingThreads + ar <= n_pad) {
      ring_fill_row<T, ND, false>(data, offsets, nd, n_pad, gl, j, b, dinv,
                                  w, ring, cap, slot);
    } else {
      ring_fill_row<T, ND, true>(data, offsets, nd, n_pad, gl, j, b, dinv,
                                 w, ring, cap, slot);
    }
  }
}

// K11's strip march (see the header): CTA (blockIdx.x, blockIdx.y) =
// rows [blockIdx.x * strip, +strip) x lanes [blockIdx.y * group, +group).
// The ring holds 2 * kRingThreads + hl + hr rows of r per lane, row j at
// slot (j - (s0 - hl)) mod cap, so a step's pass can form the next step's
// r rows while it forms its own Y rows: one barrier per step.  ND and NDS,
// when not 0, fix A's and St's diagonal counts at compile time, so the
// term loops unroll.  Rows are int: n_pad < 2^31.
template <typename T, int ND, int NDS>
__global__ void __launch_bounds__(kRingThreads, 1)
zero_chain_k_ring_kernel(const T* __restrict__ data,
                         const int* __restrict__ offsets, int nd,
                         const T* __restrict__ sdata,
                         const int* __restrict__ soffsets, int nds,
                         int n_pad, int lanes, int group, int strip, int al,
                         int ar, int hl, int hr, const T* __restrict__ b,
                         const T* __restrict__ dinv,
                         const T* __restrict__ tv, T omega,
                         const T* __restrict__ omega_dev,
                         T* __restrict__ x_out, T* __restrict__ y_out) {
  constexpr int kStep = kRingThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int cap = 2 * kStep + hl + hr;
  const int s0 = blockIdx.x * strip;
  if (s0 >= n_pad) return;
  const int s1 = min(s0 + strip, n_pad);
  const int k0 = blockIdx.y * group;
  const int gl = min(group, lanes - k0);
  b += static_cast<int64_t>(k0) * n_pad;
  x_out += static_cast<int64_t>(k0) * n_pad;
  y_out += static_cast<int64_t>(k0) * n_pad;
  const T w = omega_dev != nullptr ? *omega_dev : omega;
  const int lo = s0 - hl;                 // the row in ring slot 0
  // the first step's window
  int filled = min(s0 + kStep, s1) + hr;
  ring_fill<T, ND>(data, offsets, nd, n_pad, gl, al, ar, lo, filled, b,
                   dinv, w, ring, cap, lo);
  __syncthreads();
  for (int i = s0; i < s1; i += kStep) {
    // the next step's new r rows (their slots held rows no longer read),
    // then this step's X and Y rows
    const int next = min(i + 2 * kStep, s1) + hr;
    if (i + kStep < s1) {
      ring_fill<T, ND>(data, offsets, nd, n_pad, gl, al, ar, filled, next,
                       b, dinv, w, ring, cap, lo);
    }
    filled = next;
    const int row = i + static_cast<int>(threadIdx.x);
    if (row < s1) {
      const int base = static_cast<int>(static_cast<unsigned>(row - lo) %
                                        static_cast<unsigned>(cap));
      if (i - hl >= 0 && i + kStep + hr <= n_pad) {
        ring_out_row<T, NDS, false>(sdata, soffsets, nds, n_pad, gl, row, b,
                                    dinv, tv, w, ring, cap, base, x_out,
                                    y_out);
      } else {
        ring_out_row<T, NDS, true>(sdata, soffsets, nds, n_pad, gl, row, b,
                                   dinv, tv, w, ring, cap, base, x_out,
                                   y_out);
      }
    }
    __syncthreads();
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

template <typename T, int Mode, int ND, int VEC>
int launch_lane(const void* data, const DiaOffsets& offs, int nd, int n_pad,
                int lanes, int lo_int, int hi_int, const void* x,
                const void* b, const void* dinv, T omega,
                const void* omega_dev, void* y, void* r, cudaStream_t s) {
  constexpr int kRows = LaneShape<T, VEC>::ROWS;
  if (n_pad % VEC != 0 || n_pad >= (1LL << 31) - kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_blocks = (n_pad + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(row_blocks) * lanes;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  dia_k_lane_kernel<T, Mode, ND, VEC><<<static_cast<unsigned int>(blocks),
                                        kThreads, 0, s>>>(
      static_cast<const T*>(data), offs, nd, n_pad, lanes, row_blocks,
      lo_int, hi_int, static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(dinv), omega, static_cast<const T*>(omega_dev),
      static_cast<T*>(y), static_cast<T*>(r));
  return static_cast<int>(cudaGetLastError());
}

// the term loop unrolls for the 5- and 9-diagonal operators of 2-D grids
// (float32 and float64: neither spills), and for K10 the 7-diagonal
// operators of 3-D grids, else runs to nd
template <typename T, int Mode, int VEC>
int launch_lane_nd(const void* data, const DiaOffsets& offs, int nd,
                   int n_pad, int lanes, int lo_int, int hi_int,
                   const void* x, const void* b, const void* dinv, T omega,
                   const void* omega_dev, void* y, void* r, cudaStream_t s) {
#define PYAMG_K8_LANE(ND)                                                   \
  return launch_lane<T, Mode, ND, VEC>(data, offs, nd, n_pad, lanes,        \
                                       lo_int, hi_int, x, b, dinv, omega,   \
                                       omega_dev, y, r, s)
  if (nd == 5) PYAMG_K8_LANE(5);
  if (nd == 9) PYAMG_K8_LANE(9);
  if constexpr (Mode == ZERO_RES_K) {
    if (nd == 7) PYAMG_K8_LANE(7);
  }
  PYAMG_K8_LANE(0);
#undef PYAMG_K8_LANE
}

// 4 rows a thread for float32 where the caller asks (n_pad a multiple of
// 4, 16-byte aligned stacks), else 1
template <typename T, int Mode>
int launch_lane_vec(int vec, const void* data, const DiaOffsets& offs,
                    int nd, int n_pad, int lanes, int lo_int, int hi_int,
                    const void* x, const void* b, const void* dinv, T omega,
                    const void* omega_dev, void* y, void* r,
                    cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) {
      return launch_lane_nd<T, Mode, 4>(data, offs, nd, n_pad, lanes,
                                        lo_int, hi_int, x, b, dinv, omega,
                                        omega_dev, y, r, s);
    }
  }
  if (vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_lane_nd<T, Mode, 1>(data, offs, nd, n_pad, lanes, lo_int,
                                    hi_int, x, b, dinv, omega, omega_dev, y,
                                    r, s);
}

template <typename T>
int launch_dia_k_lanes(const void* data, const int* offsets, int nd,
                       long long n_pad, int lanes, int vec, int lo_int,
                       int hi_int, const void* x, const void* b,
                       const void* dinv, T omega, const void* omega_dev,
                       void* y, void* r, int mode, void* stream) {
  if (lanes < 1 || nd < 1 || nd > kMaxArgDiags || n_pad >= (1LL << 31) ||
      lo_int < 0 || hi_int < lo_int || (mode == ZERO_RES_K) != (r != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad <= 0) return static_cast<int>(cudaSuccess);
  DiaOffsets offs{};
  for (int d = 0; d < nd; ++d) offs.o[d] = offsets[d];
  const int n = static_cast<int>(n_pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PYAMG_K8_MODE(MODE)                                                 \
  return launch_lane_vec<T, MODE>(vec, data, offs, nd, n, lanes, lo_int,    \
                                  hi_int, x, b, dinv, omega, omega_dev, y,  \
                                  r, s)
  switch (mode) {
    case SPMM: PYAMG_K8_MODE(SPMM);
    case SPMM_SCALED: PYAMG_K8_MODE(SPMM_SCALED);
    case SPMM_ADD: PYAMG_K8_MODE(SPMM_ADD);
    case JACOBI_K: PYAMG_K8_MODE(JACOBI_K);
    case ZERO_RES_K: PYAMG_K8_MODE(ZERO_RES_K);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PYAMG_K8_MODE
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

template <typename T, int ND, int NDS>
int launch_ring(const void* data, const void* offsets, int nd,
                const void* sdata, const void* soffsets, int nds, int n_pad,
                int lanes, int group, int strip, int al, int ar, int hl,
                int hr, const void* b, const void* dinv, const void* tv,
                T omega, const void* omega_dev, void* x_out, void* y_out,
                cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * kRingThreads + hl + hr) *
                      group * sizeof(T);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        zero_chain_k_ring_kernel<T, ND, NDS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>((n_pad + strip - 1) / strip),
                  static_cast<unsigned int>((lanes + group - 1) / group));
  zero_chain_k_ring_kernel<T, ND, NDS><<<grid, kRingThreads, smem,
                                         stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), nd,
      static_cast<const T*>(sdata), static_cast<const int*>(soffsets), nds,
      n_pad, lanes, group, strip, al, ar, hl, hr, static_cast<const T*>(b),
      static_cast<const T*>(dinv), static_cast<const T*>(tv), omega,
      static_cast<const T*>(omega_dev), static_cast<T*>(x_out),
      static_cast<T*>(y_out));
  return static_cast<int>(cudaGetLastError());
}

// the term loops unroll for the 5- and 9-diagonal operators of 2-D grids
// (A and St alike) in float32, else run to nd and nds
template <typename T>
int launch_zero_chain_k_ring(const void* data, const void* offsets, int nd,
                             const void* sdata, const void* soffsets,
                             int nds, long long n_pad, int lanes, int group,
                             long long strip, int al, int ar, int hl, int hr,
                             const void* b, const void* dinv, const void* tv,
                             T omega, const void* omega_dev, void* x_out,
                             void* y_out, void* stream) {
  if (lanes < 1 || group < 1 || group > kRingLanes || strip < 1 ||
      al < 0 || ar < 0 || hl < 0 || hr < 0 || n_pad >= (1LL << 31) ||
      strip > n_pad + kRingThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad <= 0) return static_cast<int>(cudaSuccess);
  const int n = static_cast<int>(n_pad);
  const int st = static_cast<int>(strip);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PYAMG_K11_RING(ND, NDS)                                             \
  return launch_ring<T, ND, NDS>(data, offsets, nd, sdata, soffsets, nds, n, \
                                 lanes, group, st, al, ar, hl, hr, b, dinv,  \
                                 tv, omega, omega_dev, x_out, y_out, s)
  // unrolled in float32 only: the float64 forms spill at 64 registers
  // and ran faster as loops (PERF.md §6, PR 8)
  if (sizeof(T) == 4 && nd == 5 && nds == 5) PYAMG_K11_RING(5, 5);
  if (sizeof(T) == 4 && nd == 9 && nds == 9) PYAMG_K11_RING(9, 9);
  PYAMG_K11_RING(0, 0);
#undef PYAMG_K11_RING
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

// K8, K9 and K10 with the lane on the grid, every lane in one launch:
// data, offsets (a host array of nd ints, passed to the kernel by value),
// nd, n_pad, lanes, vec (rows a thread: 4, float32 only, with n_pad a
// multiple of 4 and every pointer 16-byte aligned; or 1), lo_int, hi_int
// (the row blocks of 256 * vec rows that need no bounds checks), x, b,
// dinv, omega, omega_dev, y, r, mode (SPMM, SPMM_SCALED, SPMM_ADD,
// JACOBI_K, ZERO_RES_K; b, x and r as for pyamg_dia_k_*: r non-null for
// ZERO_RES_K only), stream.
int pyamg_dia_k_lanes_f32(const void* data, const int* offsets, int nd,
                          long long n_pad, int lanes, int vec, int lo_int,
                          int hi_int, const void* x, const void* b,
                          const void* dinv, float omega,
                          const void* omega_dev, void* y, void* r, int mode,
                          void* stream) {
  return launch_dia_k_lanes<float>(data, offsets, nd, n_pad, lanes, vec,
                                   lo_int, hi_int, x, b, dinv, omega,
                                   omega_dev, y, r, mode, stream);
}

int pyamg_dia_k_lanes_f64(const void* data, const int* offsets, int nd,
                          long long n_pad, int lanes, int vec, int lo_int,
                          int hi_int, const void* x, const void* b,
                          const void* dinv, double omega,
                          const void* omega_dev, void* y, void* r, int mode,
                          void* stream) {
  return launch_dia_k_lanes<double>(data, offsets, nd, n_pad, lanes, vec,
                                    lo_int, hi_int, x, b, dinv, omega,
                                    omega_dev, y, r, mode, stream);
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

// K11's strip march: data, offsets, nd, sdata, soffsets, nds, n_pad,
// lanes, group, strip, al, ar, hl, hr, b, dinv, tv, omega, omega_dev,
// x_out, y_out, stream; b, x_out, y_out (lanes, n_pad), n_pad < 2^31,
// every lane in one launch (groups of `group` lanes over gridDim.y, strips
// of `strip` rows over gridDim.x); al, ar and hl, hr the reaches of A's
// and St's offsets; shared memory (2048 + hl + hr) * group values.
int pyamg_dia_zero_chain_k_ring_f32(
    const void* data, const void* offsets, int nd, const void* sdata,
    const void* soffsets, int nds, long long n_pad, int lanes, int group,
    long long strip, int al, int ar, int hl, int hr, const void* b,
    const void* dinv, const void* tv, float omega, const void* omega_dev,
    void* x_out, void* y_out, void* stream) {
  return launch_zero_chain_k_ring<float>(
      data, offsets, nd, sdata, soffsets, nds, n_pad, lanes, group, strip,
      al, ar, hl, hr, b, dinv, tv, omega, omega_dev, x_out, y_out, stream);
}

int pyamg_dia_zero_chain_k_ring_f64(
    const void* data, const void* offsets, int nd, const void* sdata,
    const void* soffsets, int nds, long long n_pad, int lanes, int group,
    long long strip, int al, int ar, int hl, int hr, const void* b,
    const void* dinv, const void* tv, double omega, const void* omega_dev,
    void* x_out, void* y_out, void* stream) {
  return launch_zero_chain_k_ring<double>(
      data, offsets, nd, sdata, soffsets, nds, n_pad, lanes, group, strip,
      al, ar, hl, hr, b, dinv, tv, omega, omega_dev, x_out, y_out, stream);
}

}  // extern "C"
