// The one-launch multicolour Gauss-Seidel sweep on a DIA operator (row S1
// of PERF.md §6), for Hopper (sm_90a).
//
// It replaces the chain of K2 passes that a multicolour smoother ran, one
// launch a colour step (pyamg_tpu/sparse/dia.py::dia_pallas_jacobi with
// that colour's inverse diagonal; the reference's step is
// pyamg_tpu/engine/relaxation.py:400, x = where(colors == c, x + dinv (b -
// A x), x)).  One launch runs a whole smoother call: every phase of
// `order` (the colours of each direction of every iteration, in turn).
//
//   mcgs_sweep_kernel<T, GRID>:
//     for c in order:  x_i = x_i + 1 * (dinv_i (b_i - (A x)_i)), i of colour c
//
// Layout: data (nd, n_pad) as K1's; rows (the coloured rows, sorted by
// colour, padding dropped) and coff (ncolours + 1, colour c's rows are
// rows[coff[c] .. coff[c + 1])) from the plan (sparse/dia.py::
// mcgs_plan), built once on the device; the kernel reads coff itself.
//
// Bound: device-memory bandwidth, A's diagonals once a direction plus x,
// b and dinv; what the chain lost was launches (one a colour step, ~25 us
// of host issue each) and bytes (every step read all of A and wrote all n
// rows, of which 1/ncolours changed).  The design:
//   - a colour phase touches only its own rows: a thread takes rows of
//     the colour's slice of `rows` (grid-stride) and updates x in place.
//     On the grid route the first phase alone runs over every row, out of
//     place: its colour's rows from the caller's x_in, every other row
//     copied, so the call leaves x_in as it was and needs no copy launch
//     of its own;
//   - the row sum and the update are K2's (dia_row.cuh), with the weight
//     1 passed at run time as K2's omega is, so each row gets the bits of
//     the parent's K2 colour step.  A phase leaves a thread one row or a
//     few and an SM few warps, so a row issues the loads of up to 16
//     diagonals, and of its own x, b and dinv, before it sums them (in
//     K2's order): one round trip to L2 a row, not one a diagonal;
//   - between phases a barrier: on a large level a cooperative launch
//     (cooperative_groups grid sync), the grid at most the blocks that
//     stay resident (occupancy x SMs) and no more than the largest
//     colour needs; on a small level one CTA of up to 1024 threads with
//     __syncthreads(), x staged in its shared memory for the whole call
//     (sweep.cuh).  The plan picks the route from the shape;
//   - x is read through L2 (__ldcg): other CTAs write it between phases,
//     and a read-only (non-coherent) load could return a stale line;
//   - in place is right when no stored nonzero couples two rows of one
//     colour (the plan checks that once): every row of the colour then
//     reads only other colours' rows, as in the reference's step.  Where
//     one does (a one-sided pattern coloured as it is), the phase is
//     staged: the new values go to scratch, a barrier, then to x, and a
//     barrier, so every row reads x as it stood before the step.
// A smoother call longer than kMaxPhases phases (sweep.cuh) takes more
// launches (the wrapper splits the order).

#include <cuda_runtime.h>
#include <cstdint>

#include "dia_row.cuh"
#include "sweep.cuh"

namespace {

// diagonals whose loads a row issues together (dia_row.cuh): on the grid
// route (up to 256 threads a CTA) every diagonal of config 3's levels 0-5
// (nd <= 9) in one round trip; on the one-CTA route, whose 1024 threads
// have 64 registers each, 8
template <bool GRID>
constexpr int kChunk = GRID ? 16 : 8;

template <typename T>
struct SweepArgs {
  const T* data;          // (nd, n_pad)
  const int* offsets;     // (nd,) ascending
  int nd;
  int64_t n_pad;
  const T* x_in;          // (n_pad,), the caller's iterate (or x itself)
  T* x;                   // (n_pad,), the result, updated in place
  const T* b;             // (n_pad,)
  const T* dinv;          // (n_pad,)
  T omega;                // 1: a multicolour step's weight
  const int* colors;      // (n_pad,), -1 on padded rows
  const int* rows;        // the coloured rows, by colour
  const int* coff;        // (ncolours + 1,)
  int ncolours;
  T* scratch;             // (largest colour,), where staged
  int staged;             // a phase's values go through scratch
};

// x_in[j]: never written during the launch
template <typename T>
struct InputLoad {
  const T* x;
  __device__ __forceinline__ T operator()(int64_t j) const {
    return __ldg(x + j);
  }
};

// x[j] through L2: the values other CTAs wrote before the last barrier
template <typename T>
struct CoherentLoad {
  const T* x;
  __device__ __forceinline__ T operator()(int64_t j) const {
    return __ldcg(x + j);
  }
};

// The grid route: the first phase out of place over every row, the later
// ones in place in x (or staged), a grid-wide barrier between phases.
template <typename T>
__device__ __forceinline__ void grid_sweep(const SweepArgs<T>& a,
                                           const Order& order,
                                           const int* offs, const int* coff) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int p = 0;
  if (a.x_in != a.x) {
    // the first phase out of place, over every row: its colour's rows
    // from x_in, every other row (the padding too) copied
    const int c = order.c[0];
    for (int64_t i = t0; i < a.n_pad; i += stride) {
      T v = __ldg(a.x_in + i);
      if (__ldg(a.colors + i) == c) {
        const T di = __ldg(a.dinv + i), bi = __ldg(a.b + i);
        const T acc = dia_row_sum<kChunk<true>>(a.data, offs, a.nd, a.n_pad,
                                                i, InputLoad<T>{a.x_in});
        v = jacobi_update(v, a.omega, di, bi, acc);
      }
      a.x[i] = v;
    }
    p = 1;
  }
  // the thread's first row of phase p, loaded before the barrier that
  // opens the phase (the rows are read only)
  auto first_row = [&](int q) -> int64_t {
    if (q >= order.n) return -1;
    const int64_t k = coff[order.c[q]] + t0;
    return k < coff[order.c[q] + 1] ? __ldg(a.rows + k) : -1;
  };
  int64_t next = first_row(p);
  if (p == 1) phase_barrier<true>();
  const CoherentLoad<T> load{a.x};
  for (; p < order.n; ++p) {
    const int c = order.c[p];
    const int64_t lo = coff[c], hi = coff[c + 1];
    const int64_t mine = next;
    for (int64_t k = lo + t0; k < hi; k += stride) {
      const int64_t i = k == lo + t0 ? mine : __ldg(a.rows + k);
      // the row's own operands loaded with its neighbours, not after them
      const T xi = __ldcg(a.x + i), di = __ldg(a.dinv + i), bi = __ldg(a.b + i);
      const T acc = dia_row_sum<kChunk<true>>(a.data, offs, a.nd, a.n_pad, i,
                                              load);
      const T v = jacobi_update(xi, a.omega, di, bi, acc);
      if (a.staged) {
        a.scratch[k - lo] = v;
      } else {
        a.x[i] = v;
      }
    }
    next = first_row(p + 1);
    phase_barrier<true>();
    if (a.staged) {
      for (int64_t k = lo + t0; k < hi; k += stride) {
        a.x[__ldg(a.rows + k)] = a.scratch[k - lo];
      }
      phase_barrier<true>();
    }
  }
}

// x[j] from the one-CTA route's copy in shared memory
template <typename T>
struct SharedLoad {
  const T* x;
  __device__ __forceinline__ T operator()(int64_t j) const { return x[j]; }
};

// The one-CTA route: x_in copied into shared memory, every phase in place
// there (its colour's rows only), the result written to x at the end.
template <typename T>
__device__ __forceinline__ void cta_sweep(const SweepArgs<T>& a,
                                          const Order& order, const int* offs,
                                          const int* coff, T* xs) {
  for (int64_t i = threadIdx.x; i < a.n_pad; i += blockDim.x) {
    xs[i] = a.x_in[i];
  }
  __syncthreads();
  const SharedLoad<T> load{xs};
  for (int p = 0; p < order.n; ++p) {
    const int c = order.c[p];
    const int64_t lo = coff[c], hi = coff[c + 1];
    for (int64_t k = lo + threadIdx.x; k < hi; k += blockDim.x) {
      const int64_t i = __ldg(a.rows + k);
      const T di = __ldg(a.dinv + i), bi = __ldg(a.b + i);
      const T acc = dia_row_sum<kChunk<false>>(a.data, offs, a.nd, a.n_pad, i,
                                               load);
      const T v = jacobi_update(xs[i], a.omega, di, bi, acc);
      if (a.staged) {
        a.scratch[k - lo] = v;
      } else {
        xs[i] = v;
      }
    }
    __syncthreads();
    if (a.staged) {
      for (int64_t k = lo + threadIdx.x; k < hi; k += blockDim.x) {
        xs[__ldg(a.rows + k)] = a.scratch[k - lo];
      }
      __syncthreads();
    }
  }
  for (int64_t i = threadIdx.x; i < a.n_pad; i += blockDim.x) a.x[i] = xs[i];
}

template <typename T, bool GRID>
__global__ void __launch_bounds__(GRID ? kGridThreads : kMaxThreads)
    mcgs_sweep_kernel(const SweepArgs<T> a, const Order order) {
  extern __shared__ __align__(16) int smem[];
  const int* offs = stage_offsets(smem, a.coff, a.ncolours, a.offsets, a.nd);
  const int* coff = smem;
  if constexpr (!GRID) {
    cta_sweep<T>(a, order, offs, coff, shared_x<T>(smem, a.ncolours, a.nd));
  } else {
    grid_sweep<T>(a, order, offs, coff);
  }
}

template <typename T>
int launch_sweep(const void* data, const void* offsets, int nd,
                 long long n_pad, const void* x_in, void* x, const void* b,
                 const void* dinv, T omega, const void* colors,
                 const void* rows, const void* coff, int ncolours,
                 long long max_rows, void* scratch, const int* order,
                 int norder, int threads, int grid_route, int staged,
                 void* stream) {
  Order o;
  if (n_pad <= 0 || nd < 0 || ncolours < 1 ||
      !make_order(order, norder, o) ||
      !sweep_threads_ok(threads, grid_route) || max_rows < 0 ||
      (staged && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SweepArgs<T> a{static_cast<const T*>(data),
                       static_cast<const int*>(offsets), nd, n_pad,
                       static_cast<const T*>(x_in), static_cast<T*>(x),
                       static_cast<const T*>(b), static_cast<const T*>(dinv),
                       omega, static_cast<const int*>(colors),
                       static_cast<const int*>(rows),
                       static_cast<const int*>(coff), ncolours,
                       static_cast<T*>(scratch), staged};
  const cudaError_t err = launch_sweep_route(
      mcgs_sweep_kernel<T, true>, mcgs_sweep_kernel<T, false>, a, o, threads,
      max_rows, grid_route, ncolours, nd,
      static_cast<size_t>(n_pad) * sizeof(T),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data, offsets, nd, n_pad, x_in (the caller's iterate, read only; x
// itself for a launch that continues one), x (the result), b, dinv, omega,
// colors, rows, coff, ncolours, max_rows (the largest colour), scratch
// (staged, else null), order (host ints), norder, threads, grid_route,
// staged, stream
int pyamg_mcgs_sweep_f32(const void* data, const void* offsets, int nd,
                         long long n_pad, const void* x_in, void* x,
                         const void* b, const void* dinv, float omega,
                         const void* colors, const void* rows,
                         const void* coff, int ncolours,
                         long long max_rows, void* scratch, const int* order,
                         int norder, int threads, int grid_route, int staged,
                         void* stream) {
  return launch_sweep<float>(data, offsets, nd, n_pad, x_in, x, b, dinv,
                             omega, colors, rows, coff, ncolours, max_rows,
                             scratch, order, norder, threads, grid_route,
                             staged, stream);
}

int pyamg_mcgs_sweep_f64(const void* data, const void* offsets, int nd,
                         long long n_pad, const void* x_in, void* x,
                         const void* b, const void* dinv, double omega,
                         const void* colors, const void* rows,
                         const void* coff, int ncolours,
                         long long max_rows, void* scratch, const int* order,
                         int norder, int threads, int grid_route, int staged,
                         void* stream) {
  return launch_sweep<double>(data, offsets, nd, n_pad, x_in, x, b, dinv,
                              omega, colors, rows, coff, ncolours, max_rows,
                              scratch, order, norder, threads, grid_route,
                              staged, stream);
}

}  // extern "C"
