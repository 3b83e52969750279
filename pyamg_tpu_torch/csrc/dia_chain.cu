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
// Bound: device-memory bandwidth.  ZERO_CHAIN must read (nd + nds + 3)
// values a row (A's and St's diagonals, b, dinv, tv) and write 2 (x, y);
// JACOBI_RES reads (nd + 3) (A's diagonals, x, b, dinv) and writes 2 (y,
// r).  About 1 flop per byte in float32, far below the card's ~20.
//
// chain_ring_kernel<T, MODE, ND, NDS, VEC>, the strip march: each inner
// value (ZERO_CHAIN's r_j, JACOBI_RES's y_j) is computed once and read
// from shared memory by every outer row that needs it.  A CTA owns a
// contiguous strip of rows [s0, s1) and walks it in passes of S = threads
// * VEC rows, VEC consecutive rows a thread (16-byte loads and stores of
// float32 quads or float64 pairs, or one row a thread), through three
// stages:
//
//   stage 1  u_q   = w * (dinv_q * b_q)   (ZERO_CHAIN; it is x, stored)
//                  = x_q                  (JACOBI_RES)
//            into ring 1;
//   stage 2  v_j   = b_j - sum_e A[e, j] u_{j + off_e}           (r_j)
//                  = fma(w, dinv_j (b_j - sum_e ...), u_j)       (y_j, stored)
//            into ring 2, the neighbours' u from ring 1;
//   stage 3  out_i = tv_i * sum_s St[s, i] v_{i + soff_s}        (y_i)
//                  = b_i - sum_d A[d, i] v_{i + off_d}           (r_i)
//            the neighbours' v from ring 2.
//
// In pass p stage k takes the S rows from its anchor A_k + p S; stage 2
// lags stage 1 by S rows plus A's reach above the diagonal, stage 3 lags
// stage 2 by S plus the outer operator's reach above, so each stage reads
// only what earlier passes wrote, and one barrier a pass suffices.  Ring
// 1 holds 2 S + al + ar rows (A's reach below and above), ring 2 2 S + hl
// + hr (the outer operator's), row q in slot (q - base) mod cap: a slot
// is written again only after the last pass that reads it.  Every global
// load and store is aligned and whole: the neighbours at odd offsets come
// from shared memory.  The rows hl + al below a strip and hr + ar above
// it are formed by both strips that need them (the plan keeps them a
// small share); the rest is read from device memory once, apart from
// JACOBI_RES's second read of A's diagonals and b (S + hr rows later, so
// from L2).  What bounds a pass is the latency of its loads, so the step
// is long: the wrapper's plan (sparse/dia.py::chain_plan) takes 1024
// threads of 16 bytes of rows (4096 float32 or 2048 float64 rows a pass,
// every thread's loads of all three stages in flight at once) and one
// strip per SM, the fastest of the launches measured at levels 0 and 1
// (PERF.md §6, K4 and K5); more, shorter strips form more halo rows
// twice.  A coarse level too small to give half the SMs a strip takes
// smaller CTAs, for more strips.  Rows are int: the plan keeps n_pad plus
// the halos below 2^31.
//
// zero_chain_kernel / jacobi_res_kernel, one thread per output row, stay
// for the shapes the plan refuses (an outer operator whose reach makes
// the rings exceed a block's shared memory, as a 3-D grid's +-n^2 offset
// does; more than kMaxDiags diagonals; rows near 2^31).  They RECOMPUTE
// the inner value for every outer neighbour: nd * nds inner terms a row.
//
// Every value keeps one arithmetic in both forms (and the first form's,
// whose nvcc contractions these FMAs write out): the inner sum one FMA a
// term over A's offsets in ascending order, an out-of-range neighbour's
// term left out, ZERO_CHAIN's u as two rounded products, r = b - acc
// rounded to T, the Jacobi update fma(w, dinv (b - acc), x); then the
// outer sum one FMA a term in the outer operator's offset order, then the
// tv scale (ZERO_CHAIN) or b - acc (JACOBI_RES).  So the forms give the
// same bits.  In the ring kernel an out-of-range term is skipped by a
// select, which keeps the sum as it was and lets all loads issue.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum ChainMode : int { ZERO_CHAIN = 0, JACOBI_RES = 1 };

constexpr int kThreads = 256;         // the per-row kernels' CTA
constexpr int kRingMaxThreads = 1024;  // the ring kernel's CTA at most
constexpr int kMaxDiags = 32;         // diagonals per operator, ring kernel
constexpr int kMaxSmem = 232448;      // a block's shared memory (227 KB)

// a * b + c rounded once (an explicit FMA)
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// ---------------------------------------------------------------------------
// per-row kernels
// ---------------------------------------------------------------------------

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
    acc = fma_rn(data[static_cast<int64_t>(e) * n_pad + j],
                 w * (dinv[k] * b[k]), acc);
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
    acc = fma_rn(data[static_cast<int64_t>(e) * n_pad + j], x[k], acc);
  }
  return fma_rn(w, dinv[j] * (b[j] - acc), x[j]);
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
    acc = fma_rn(sdata[static_cast<int64_t>(s) * n_pad + i], rj, acc);
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
    acc = fma_rn(data[static_cast<int64_t>(d) * n_pad + i], yj, acc);
  }
  y_out[i] = jacobi_row(data, offsets, nd, n_pad, i, x, b, dinv, w);
  r_out[i] = b[i] - acc;
}

// ---------------------------------------------------------------------------
// the ring kernel
// ---------------------------------------------------------------------------

// VEC values of T in one aligned load or store (16 bytes for float32 quads
// and float64 pairs)
template <typename T, int VEC> struct VecOf;
template <> struct VecOf<float, 1> { using type = float; };
template <> struct VecOf<float, 2> { using type = float2; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<double, 1> { using type = double; };
template <> struct VecOf<double, 2> { using type = double2; };

// STREAM: the values are not read again, so they leave L2 first
template <typename T, int VEC, bool STREAM>
__device__ __forceinline__ void load_vec(T (&v)[VEC], const T* p) {
  using V = typename VecOf<T, VEC>::type;
  const V* vp = reinterpret_cast<const V*>(p);
  V t;
  if constexpr (STREAM) {
    t = __ldcs(vp);
  } else {
    t = *vp;
  }
  const T* e = reinterpret_cast<const T*>(&t);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = e[k];
}

template <typename T, int VEC, bool STREAM>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[VEC]) {
  using V = typename VecOf<T, VEC>::type;
  V t;
  T* e = reinterpret_cast<T*>(&t);
#pragma unroll
  for (int k = 0; k < VEC; ++k) e[k] = v[k];
  if constexpr (STREAM) {
    __stcs(reinterpret_cast<V*>(p), t);
  } else {
    *reinterpret_cast<V*>(p) = t;
  }
}

__host__ __device__ __forceinline__ int ceil_to(int v, int m) {
  return (v + m - 1) / m * m;
}

// The march's geometry, from the CTA's threads, VEC and the reaches below
// and above the diagonal of A (al, ar: stage 2) and of the outer operator
// (hl, hr: stage 3), each rounded up to whole VEC groups.  Anchors a1..a3
// and ring bases are rows relative to the strip's first row s0.
struct RingGeom {
  int step;          // rows a pass
  int AL, AR, HL, HR;
  int a1, a2, a3;    // stage k's rows in pass p: [s0 + a_k + p step, +step)
  int cap1, cap2;    // ring sizes in rows
};

__host__ __device__ __forceinline__ RingGeom ring_geom(int threads, int vec,
                                                       int al, int ar,
                                                       int hl, int hr) {
  RingGeom g;
  g.step = threads * vec;
  g.AL = ceil_to(al, vec);
  g.AR = ceil_to(ar, vec);
  g.HL = ceil_to(hl, vec);
  g.HR = ceil_to(hr, vec);
  g.a1 = -(g.HL + g.AL);
  g.a2 = g.a1 - g.step - g.AR;
  g.a3 = g.a2 - g.step - g.HR;
  g.cap1 = 2 * g.step + g.AL + g.AR;
  g.cap2 = 2 * g.step + g.HL + g.HR;
  return g;
}

// stage 1 for the VEC rows from q: u into ring 1 (slot sl), and
// ZERO_CHAIN's x for the strip's own rows
template <typename T, int MODE, int VEC>
__device__ __forceinline__ void ring_stage1(
    int q, const T* __restrict__ x, const T* __restrict__ b,
    const T* __restrict__ dinv, T w, T* ring1, int sl, bool own,
    T* __restrict__ x_out) {
  T u[VEC];
  if constexpr (MODE == ZERO_CHAIN) {
    T bv[VEC], dv[VEC];
    load_vec<T, VEC, false>(bv, b + q);   // read again in stage 2
    load_vec<T, VEC, true>(dv, dinv + q);
#pragma unroll
    for (int t = 0; t < VEC; ++t) u[t] = w * (dv[t] * bv[t]);
    if (own) store_vec<T, VEC, true>(x_out + q, u);
  } else {
    load_vec<T, VEC, true>(u, x + q);
  }
  store_vec<T, VEC, false>(ring1 + sl, u);
}

// the sum over an operator's diagonals for the VEC rows from i, the
// neighbours' values from `ring` (row i in slot sl); CHECK: skip the
// terms whose neighbour lies outside [0, n_pad) (by a select)
template <typename T, int NDIAG, int VEC, bool CHECK, bool STREAM>
__device__ __forceinline__ void ring_sum(
    T (&acc)[VEC], const T* __restrict__ data, const int* s_off, int nd,
    int n_pad, int i, const T* ring, int cap, int sl) {
#pragma unroll
  for (int t = 0; t < VEC; ++t) acc[t] = T(0);
  const int n_e = NDIAG > 0 ? NDIAG : nd;
#pragma unroll
  for (int e = 0; e < n_e; ++e) {
    const int off = s_off[e];
    T a[VEC];
    load_vec<T, VEC, STREAM>(a, data + static_cast<int64_t>(e) * n_pad + i);
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      int s = sl + t + off;
      if (s < 0) {
        s += cap;
      } else if (s >= cap) {
        s -= cap;
      }
      const T v = fma_rn(a[t], ring[s], acc[t]);
      if constexpr (CHECK) {
        const int m = i + t + off;
        acc[t] = (m >= 0 && m < n_pad) ? v : acc[t];
      } else {
        acc[t] = v;
      }
    }
  }
}

// stage 2 for the VEC rows from j: v into ring 2 (slot sl2), from ring 1
// (slot sl1); JACOBI_RES's y for the strip's own rows
template <typename T, int MODE, int ND, int VEC, bool CHECK>
__device__ __forceinline__ void ring_stage2(
    int j, const T* __restrict__ data, const int* s_off, int nd, int n_pad,
    const T* __restrict__ b, const T* __restrict__ dinv, T w,
    const T* ring1, int cap1, int sl1, T* ring2, int sl2, bool own,
    T* __restrict__ y_out) {
  T acc[VEC];
  // ZERO_CHAIN reads A's diagonals once; JACOBI_RES again in stage 3
  ring_sum<T, ND, VEC, CHECK, MODE == ZERO_CHAIN>(acc, data, s_off, nd,
                                                  n_pad, j, ring1, cap1,
                                                  sl1);
  T bv[VEC], v[VEC];
  // JACOBI_RES reads b again in stage 3
  load_vec<T, VEC, MODE == ZERO_CHAIN>(bv, b + j);
  if constexpr (MODE == ZERO_CHAIN) {
#pragma unroll
    for (int t = 0; t < VEC; ++t) v[t] = bv[t] - acc[t];
  } else {
    T dv[VEC];
    load_vec<T, VEC, true>(dv, dinv + j);
#pragma unroll
    for (int t = 0; t < VEC; ++t)
      v[t] = fma_rn(w, dv[t] * (bv[t] - acc[t]), ring1[sl1 + t]);
    if (own) store_vec<T, VEC, true>(y_out + j, v);
  }
  store_vec<T, VEC, false>(ring2 + sl2, v);
}

// stage 3 for the VEC rows from i (all the strip's own), from ring 2
template <typename T, int MODE, int NDS, int VEC, bool CHECK>
__device__ __forceinline__ void ring_stage3(
    int i, const T* __restrict__ sdata, const int* s_soff, int nds,
    int n_pad, const T* __restrict__ b, const T* __restrict__ tv,
    const T* ring2, int cap2, int sl2, T* __restrict__ out) {
  T acc[VEC], o[VEC], s[VEC];
  ring_sum<T, NDS, VEC, CHECK, true>(acc, sdata, s_soff, nds, n_pad, i,
                                     ring2, cap2, sl2);
  if constexpr (MODE == ZERO_CHAIN) {
    load_vec<T, VEC, true>(s, tv + i);
#pragma unroll
    for (int t = 0; t < VEC; ++t) o[t] = s[t] * acc[t];
  } else {
    load_vec<T, VEC, true>(s, b + i);
#pragma unroll
    for (int t = 0; t < VEC; ++t) o[t] = s[t] - acc[t];
  }
  store_vec<T, VEC, true>(out + i, o);
}

// The strip march (see the header).  CTA blockIdx.x owns the rows
// [blockIdx.x * strip, +strip); strip, n_pad and every anchor are whole
// VEC groups.  ND and NDS, when not 0, fix the diagonal counts of A and
// of the outer operator at compile time, so the term loops unroll; the
// offsets are staged in shared memory.  ZERO_CHAIN: sdata / soffsets are
// St, out0 = x, out1 = y.  JACOBI_RES: they are A again, out0 = y, out1 =
// r.
template <typename T, int MODE, int ND, int NDS, int VEC>
__global__ void __launch_bounds__(kRingMaxThreads)
chain_ring_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
                  int nd, const T* __restrict__ sdata,
                  const int* __restrict__ soffsets, int nds, int n_pad,
                  int strip, int al, int ar, int hl, int hr,
                  const T* __restrict__ x, const T* __restrict__ b,
                  const T* __restrict__ dinv, const T* __restrict__ tv,
                  T omega, const T* __restrict__ omega_dev,
                  T* __restrict__ out0, T* __restrict__ out1) {
  __shared__ int s_off[kMaxDiags];
  __shared__ int s_soff[kMaxDiags];
  extern __shared__ __align__(16) unsigned char smem[];
  const RingGeom g = ring_geom(blockDim.x, VEC, al, ar, hl, hr);
  T* ring1 = reinterpret_cast<T*>(smem);
  T* ring2 = ring1 + g.cap1;
  const int s0 = static_cast<int>(blockIdx.x) * strip;
  if (s0 >= n_pad) return;
  const int s1 = min(s0 + strip, n_pad);
  for (int k = threadIdx.x; k < nd; k += blockDim.x) s_off[k] = offsets[k];
  for (int k = threadIdx.x; k < nds; k += blockDim.x) s_soff[k] = soffsets[k];
  const T w = omega_dev != nullptr ? *omega_dev : omega;
  const int S = g.step;
  const int A1 = s0 + g.a1, A2 = s0 + g.a2, A3 = s0 + g.a3;
  const int base1 = A2 - g.AL, base2 = A3 - g.HL;
  // each stage's rows within the matrix
  const int lo1 = max(A1, 0), hi1 = min(s1 + g.HR + g.AR, n_pad);
  const int lo2 = max(s0 - g.HL, 0), hi2 = min(s1 + g.HR, n_pad);
  const int passes = (s1 - 1 - A3) / S + 1;
  const int tq = static_cast<int>(threadIdx.x) * VEC;
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const int c1 = A1 + p * S, c2 = A2 + p * S, c3 = A3 + p * S;
    const int q = c1 + tq, j = c2 + tq, i = c3 + tq;
    if (q >= lo1 && q < hi1) {
      ring_stage1<T, MODE, VEC>(q, x, b, dinv, w, ring1,
                                (q - base1) % g.cap1, q >= s0 && q < s1,
                                out0);
    }
    if (j >= lo2 && j < hi2) {
      const int sl1 = (j - base1) % g.cap1, sl2 = (j - base2) % g.cap2;
      const bool own = j >= s0 && j < s1;
      if (c2 - al >= 0 && c2 + S + ar <= n_pad) {
        ring_stage2<T, MODE, ND, VEC, false>(j, data, s_off, nd, n_pad, b,
                                             dinv, w, ring1, g.cap1, sl1,
                                             ring2, sl2, own, out0);
      } else {
        ring_stage2<T, MODE, ND, VEC, true>(j, data, s_off, nd, n_pad, b,
                                            dinv, w, ring1, g.cap1, sl1,
                                            ring2, sl2, own, out0);
      }
    }
    if (i >= s0 && i < s1) {
      const int sl2 = (i - base2) % g.cap2;
      if (c3 - hl >= 0 && c3 + S + hr <= n_pad) {
        ring_stage3<T, MODE, NDS, VEC, false>(i, sdata, s_soff, nds, n_pad,
                                              b, tv, ring2, g.cap2, sl2,
                                              out1);
      } else {
        ring_stage3<T, MODE, NDS, VEC, true>(i, sdata, s_soff, nds, n_pad,
                                             b, tv, ring2, g.cap2, sl2,
                                             out1);
      }
    }
    __syncthreads();
  }
}

template <typename T, int MODE, int ND, int NDS, int VEC>
int launch_ring(const void* data, const void* offsets, int nd,
                const void* sdata, const void* soffsets, int nds, int n_pad,
                int threads, int strip, int al, int ar, int hl, int hr,
                const void* x, const void* b, const void* dinv,
                const void* tv, T omega, const void* omega_dev, void* out0,
                void* out1, cudaStream_t stream) {
  // both rings (the offsets are static)
  const RingGeom g = ring_geom(threads, VEC, al, ar, hl, hr);
  const size_t smem = static_cast<size_t>(g.cap1 + g.cap2) * sizeof(T);
  if (smem + 2 * kMaxDiags * sizeof(int) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // raised once per instantiation to the most any launch asked for
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        chain_ring_kernel<T, MODE, ND, NDS, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const unsigned int blocks =
      static_cast<unsigned int>((static_cast<long long>(n_pad) + strip - 1) /
                                strip);
  chain_ring_kernel<T, MODE, ND, NDS, VEC><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), nd,
      static_cast<const T*>(sdata), static_cast<const int*>(soffsets), nds,
      n_pad, strip, al, ar, hl, hr, static_cast<const T*>(x),
      static_cast<const T*>(b), static_cast<const T*>(dinv),
      static_cast<const T*>(tv), omega, static_cast<const T*>(omega_dev),
      static_cast<T*>(out0), static_cast<T*>(out1));
  return static_cast<int>(cudaGetLastError());
}

// the term loops unroll for the 5- and 9-diagonal operators of 2-D grids
// (A and the outer operator alike), else run to nd and nds
template <typename T, int MODE, int VEC>
int launch_ring_nd(const void* data, const void* offsets, int nd,
                   const void* sdata, const void* soffsets, int nds,
                   int n_pad, int threads, int strip, int al, int ar, int hl,
                   int hr, const void* x, const void* b, const void* dinv,
                   const void* tv, T omega, const void* omega_dev,
                   void* out0, void* out1, cudaStream_t stream) {
#define PYAMG_CHAIN_RING(ND, NDS)                                           \
  return launch_ring<T, MODE, ND, NDS, VEC>(                                \
      data, offsets, nd, sdata, soffsets, nds, n_pad, threads, strip, al,   \
      ar, hl, hr, x, b, dinv, tv, omega, omega_dev, out0, out1, stream)
  if (nd == 5 && nds == 5) PYAMG_CHAIN_RING(5, 5);
  if (nd == 9 && nds == 9) PYAMG_CHAIN_RING(9, 9);
  PYAMG_CHAIN_RING(0, 0);
#undef PYAMG_CHAIN_RING
}

template <typename T, int MODE>
int launch_ring_vec(int vec, const void* data, const void* offsets, int nd,
                    const void* sdata, const void* soffsets, int nds,
                    int n_pad, int threads, int strip, int al, int ar, int hl,
                    int hr, const void* x, const void* b, const void* dinv,
                    const void* tv, T omega, const void* omega_dev,
                    void* out0, void* out1, cudaStream_t stream) {
#define PYAMG_CHAIN_VEC(VEC)                                                \
  return launch_ring_nd<T, MODE, VEC>(                                      \
      data, offsets, nd, sdata, soffsets, nds, n_pad, threads, strip, al,   \
      ar, hl, hr, x, b, dinv, tv, omega, omega_dev, out0, out1, stream)
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) PYAMG_CHAIN_VEC(4);
  } else {
    if (vec == 2) PYAMG_CHAIN_VEC(2);
  }
  if (vec == 1) PYAMG_CHAIN_VEC(1);
  return static_cast<int>(cudaErrorInvalidValue);
#undef PYAMG_CHAIN_VEC
}

template <typename T>
int launch_chain_ring(const void* data, const void* offsets, int nd,
                      const void* sdata, const void* soffsets, int nds,
                      long long n_pad, int threads, int vec, long long strip,
                      int al, int ar, int hl, int hr, const void* x,
                      const void* b, const void* dinv, const void* tv,
                      T omega, const void* omega_dev, void* out0, void* out1,
                      int mode, void* stream) {
  if (mode == JACOBI_RES) {
    // the outer operator is A itself
    sdata = data;
    soffsets = offsets;
    nds = nd;
    hl = al;
    hr = ar;
  }
  if (threads < 32 || threads > kRingMaxThreads || threads % 32 != 0 ||
      vec < 1 || n_pad % vec != 0 || strip < vec || strip % vec != 0 ||
      nd < 1 || nd > kMaxDiags || nds < 1 || nds > kMaxDiags || al < 0 ||
      ar < 0 || hl < 0 || hr < 0 ||
      n_pad + strip + 4LL * (threads * vec) + al + ar + hl + hr + 4 * vec >=
          (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad <= 0) return static_cast<int>(cudaSuccess);
  const int n = static_cast<int>(n_pad);
  const int st = static_cast<int>(strip);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case ZERO_CHAIN:
      return launch_ring_vec<T, ZERO_CHAIN>(
          vec, data, offsets, nd, sdata, soffsets, nds, n, threads, st, al,
          ar, hl, hr, x, b, dinv, tv, omega, omega_dev, out0, out1, s);
    case JACOBI_RES:
      return launch_ring_vec<T, JACOBI_RES>(
          vec, data, offsets, nd, sdata, soffsets, nds, n, threads, st, al,
          ar, hl, hr, x, b, dinv, tv, omega, omega_dev, out0, out1, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

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

// The per-row kernels: data, offsets, nd, sdata, soffsets, nds, n_pad, x,
// b, dinv, tv, omega, omega_dev, out0, out1, mode, stream.  ZERO_CHAIN:
// out0 = x, out1 = y (x unused on input).  JACOBI_RES: out0 = y, out1 = r
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
  return launch_chain<double>(data, offsets, nd, sdata, soffsets, nds,
                              n_pad, x, b, dinv, tv, omega, omega_dev, out0,
                              out1, mode, stream);
}

// The strip march: data, offsets, nd, sdata, soffsets, nds, n_pad,
// threads (a multiple of 32, at most 1024), vec (rows a thread: 4 float32
// or 2 float64 rows in 16-byte loads, with n_pad a multiple of vec and
// every pointer 16-byte aligned; or 1), strip (rows a CTA, a multiple of
// vec), al, ar (A's reach below and
// above the diagonal), hl, hr (St's; unused for JACOBI_RES), x, b, dinv,
// tv, omega, omega_dev, out0, out1 (as for the per-row kernels), mode,
// stream.  Shared memory (4 threads vec + al + ar + hl + hr) values,
// each reach rounded up to vec.
int pyamg_dia_chain_ring_f32(const void* data, const void* offsets, int nd,
                             const void* sdata, const void* soffsets,
                             int nds, long long n_pad, int threads, int vec,
                             long long strip, int al, int ar, int hl, int hr,
                             const void* x, const void* b, const void* dinv,
                             const void* tv, float omega,
                             const void* omega_dev, void* out0, void* out1,
                             int mode, void* stream) {
  return launch_chain_ring<float>(data, offsets, nd, sdata, soffsets, nds,
                                  n_pad, threads, vec, strip, al, ar, hl, hr,
                                  x, b, dinv, tv, omega, omega_dev, out0,
                                  out1, mode, stream);
}

int pyamg_dia_chain_ring_f64(const void* data, const void* offsets, int nd,
                             const void* sdata, const void* soffsets,
                             int nds, long long n_pad, int threads, int vec,
                             long long strip, int al, int ar, int hl, int hr,
                             const void* x, const void* b, const void* dinv,
                             const void* tv, double omega,
                             const void* omega_dev, void* out0, void* out1,
                             int mode, void* stream) {
  return launch_chain_ring<double>(data, offsets, nd, sdata, soffsets, nds,
                                   n_pad, threads, vec, strip, al, ar, hl,
                                   hr, x, b, dinv, tv, omega, omega_dev, out0,
                                   out1, mode, stream);
}

}  // extern "C"
