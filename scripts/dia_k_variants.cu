// One-off variants of the K-lane DIA SpMV and Jacobi sweep (K8 and K9,
// pyamg_tpu_torch/csrc/dia_k.cu) for scripts/measure_k8_k9.py, which
// builds this file with nvcc and times it beside the package's kernels;
// nothing in the package uses it.
//
// The package's first form (dia_k_kernel) runs one thread per row and
// loops over the lanes inside: for one diagonal, a warp issues one load
// per lane, and the lanes lie n_pad values apart.  These variants ask
// where the time goes:
//
// - variant 0, "rows": the same thread-per-row shape with the diagonals
//   unrolled (5 or 9), the offsets as kernel arguments, no bounds checks
//   in interior blocks and the streamed arrays evict-first; it isolates
//   the loop and its checks from the layout of the loads;
// - variant 1, "lane grid": the lane on the grid.  A CTA streams VEC rows
//   a thread (16-byte loads and stores where VEC > 1) of one lane; the
//   blocks walk super tiles of `super` row blocks with the lanes of a
//   super tile consecutive (super = 1: lane fastest, the K CTAs of a row
//   block side by side, so the diagonals come from DRAM once and from L2
//   K - 1 times);
// - variant 3, "lane grid pairs": variant 1 with 4 float32 rows a thread
//   and super tiles, every X load 16 bytes wide (a misaligned neighbour
//   run picked from the two aligned runs around it): the package's
//   float32 form;
// - variant 2, "staged": a CTA owns `tile` rows of every lane and copies
//   each lane's rows with a halo of 16 bytes on each side, and the
//   diagonals, into shared memory by bulk asynchronous copies
//   (cp.async.bulk completing on an mbarrier); the short offsets read
//   shared memory, the long ones device memory (mostly L2).
//
// Every variant sums each value in the package's order (the diagonals in
// offset order, one FMA a term, an out-of-range neighbour's term left out)
// with its epilogue, so it gives the package's bits.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxArgDiags = 32;
constexpr int kMaxLanes = 16;

struct Offsets {
  int o[kMaxArgDiags];
};

enum Mode : int { SPMM = 0, SPMM_SCALED = 1, SPMM_ADD = 2, JACOBI_K = 3 };

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// VEC values at p (16-byte aligned when VEC > 1); CS: evict-first
template <typename T, int VEC, bool CS>
__device__ __forceinline__ void ld_vec(T (&v)[VEC], const T* p) {
  if constexpr (VEC == 1) {
    v[0] = CS ? __ldcs(p) : *p;
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(VEC == 4, "float: 4 values a load");
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 u = CS ? __ldcs(q) : *q;
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
    static_assert(VEC == 2, "double: 2 values a load");
    const double2* q = reinterpret_cast<const double2*>(p);
    const double2 u = CS ? __ldcs(q) : *q;
    v[0] = u.x; v[1] = u.y;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void st_vec_cs(T* p, const T (&v)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(p, v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
}

// the epilogue of one value: acc the row's sum, xv the lane's x at the
// row (JACOBI_K), bv the lane's V (SPMM_ADD) or B (JACOBI_K) or the shared
// s (SPMM_SCALED), dv dinv at the row
template <typename T, int Mode>
__device__ __forceinline__ T epilogue(T acc, T xv, T bv, T dv, T w) {
  if (Mode == SPMM_SCALED) return acc * bv;
  if (Mode == SPMM_ADD) return acc + bv;
  if (Mode == JACOBI_K) return fma_rn(w, dv * (bv - acc), xv);
  return acc;
}

// row i's sum over the diagonals for the lane at xl; CHECK: leave out the
// terms whose neighbour falls outside [0, n_pad) (a select, no branch)
template <typename T, int ND, bool CHECK, bool CS>
__device__ __forceinline__ T row_sum(const T* __restrict__ data,
                                     const Offsets& offs, int nd, int n_pad,
                                     int i, const T* __restrict__ xl) {
  T acc = T(0);
  const int n_d = ND > 0 ? ND : nd;
#pragma unroll
  for (int d = 0; d < n_d; ++d) {
    const int j = i + offs.o[d];
    const T* ap = data + static_cast<int64_t>(d) * n_pad + i;
    const T a = CS ? __ldcs(ap) : *ap;
    if (CHECK) {
      const bool in = j >= 0 && j < n_pad;
      const T v = fma_rn(a, xl[in ? j : i], acc);
      acc = in ? v : acc;
    } else {
      acc = fma_rn(a, xl[j], acc);
    }
  }
  return acc;
}

// ---- variant 0: one thread per row, the lanes inside ----------------------

template <typename T, int Mode, int ND, bool CHECK>
__device__ __forceinline__ void rows_row(const T* __restrict__ data,
                                         const Offsets& offs, int nd,
                                         int n_pad, int lanes, int i,
                                         const T* __restrict__ x,
                                         const T* __restrict__ b,
                                         const T* __restrict__ dinv, T w,
                                         T* __restrict__ y) {
  T acc[kMaxLanes];
#pragma unroll
  for (int k = 0; k < kMaxLanes; ++k) acc[k] = T(0);
  const int n_d = ND > 0 ? ND : nd;
#pragma unroll
  for (int d = 0; d < n_d; ++d) {
    const int j = i + offs.o[d];
    const bool in = !CHECK || (j >= 0 && j < n_pad);
    const int jc = in ? j : i;
    const T a = __ldcs(data + static_cast<int64_t>(d) * n_pad + i);
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) {
        const T v = fma_rn(a, x[static_cast<int64_t>(k) * n_pad + jc], acc[k]);
        acc[k] = in ? v : acc[k];
      }
    }
  }
  const T s = Mode == SPMM_SCALED ? b[i] : T(0);
  const T di = Mode == JACOBI_K ? dinv[i] : T(0);
#pragma unroll
  for (int k = 0; k < kMaxLanes; ++k) {
    if (k < lanes) {
      const int64_t o = static_cast<int64_t>(k) * n_pad + i;
      const T xv = Mode == JACOBI_K ? x[o] : T(0);
      const T bv = Mode == SPMM_SCALED ? s
                   : (Mode == SPMM_ADD || Mode == JACOBI_K) ? __ldcs(b + o)
                                                            : T(0);
      __stcs(y + o, epilogue<T, Mode>(acc[k], xv, bv, di, w));
    }
  }
}

template <typename T, int Mode, int ND>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ data, Offsets offs, int nd, int n_pad,
            int lanes, int lo_int, int hi_int, const T* __restrict__ x,
            const T* __restrict__ b, const T* __restrict__ dinv, T w,
            T* __restrict__ y) {
  const int rb = blockIdx.x;
  const int i = rb * kThreads + threadIdx.x;
  if (i >= n_pad) return;
  if (rb >= lo_int && rb < hi_int) {
    rows_row<T, Mode, ND, false>(data, offs, nd, n_pad, lanes, i, x, b, dinv,
                                 w, y);
  } else {
    rows_row<T, Mode, ND, true>(data, offs, nd, n_pad, lanes, i, x, b, dinv,
                                w, y);
  }
}

// ---- variant 1: the lane on the grid --------------------------------------

template <typename T, int Mode, int ND, int VEC, bool CHECK>
__device__ __forceinline__ void lane_rows(const T* __restrict__ data,
                                          const Offsets& offs, int nd,
                                          int n_pad, int i0,
                                          const T* __restrict__ xl,
                                          const T* __restrict__ bl,
                                          const T* __restrict__ dinv, T w,
                                          T* __restrict__ yl) {
  if (CHECK && i0 >= n_pad) return;
  T acc[VEC];
#pragma unroll
  for (int t = 0; t < VEC; ++t) acc[t] = T(0);
  const int n_d = ND > 0 ? ND : nd;
#pragma unroll
  for (int d = 0; d < n_d; ++d) {
    const int o = offs.o[d];
    T a[VEC];
    ld_vec<T, VEC, false>(a, data + static_cast<int64_t>(d) * n_pad + i0);
    if (!CHECK && VEC > 1 && (o & (VEC - 1)) == 0) {
      T xv[VEC];
      ld_vec<T, VEC, false>(xv, xl + i0 + o);
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
  T xv[VEC], bv[VEC], dv[VEC], out[VEC];
  if (Mode == JACOBI_K) {
    ld_vec<T, VEC, false>(xv, xl + i0);
    ld_vec<T, VEC, false>(dv, dinv + i0);
  }
  if (Mode == SPMM_SCALED) ld_vec<T, VEC, false>(bv, bl + i0);
  if (Mode == SPMM_ADD || Mode == JACOBI_K) ld_vec<T, VEC, true>(bv, bl + i0);
#pragma unroll
  for (int t = 0; t < VEC; ++t) {
    out[t] = epilogue<T, Mode>(acc[t], Mode == JACOBI_K ? xv[t] : T(0),
                               Mode == SPMM ? T(0) : bv[t],
                               Mode == JACOBI_K ? dv[t] : T(0), w);
  }
  st_vec_cs<T, VEC>(yl + i0, out);
}

template <typename T, int Mode, int ND, int VEC>
__global__ void __launch_bounds__(kThreads)
lane_grid_kernel(const T* __restrict__ data, Offsets offs, int nd, int n_pad,
                 int lanes, int row_blocks, int super, int lo_int, int hi_int,
                 const T* __restrict__ x, const T* __restrict__ b,
                 const T* __restrict__ dinv, T w, T* __restrict__ y) {
  constexpr int kRows = kThreads * VEC;
  const int bid = blockIdx.x;
  const int per = super * lanes;
  const int st = bid / per;
  const int base = st * super;
  const int s_eff = min(super, row_blocks - base);
  const int rem = bid - st * per;
  const int k = rem / s_eff;
  const int rb = base + (rem - k * s_eff);
  const int64_t lo = static_cast<int64_t>(k) * n_pad;
  const T* xl = x + lo;
  const T* bl = Mode == SPMM_SCALED ? b : (b == nullptr ? b : b + lo);
  T* yl = y + lo;
  const int i0 = rb * kRows + static_cast<int>(threadIdx.x) * VEC;
  if (rb >= lo_int && rb < hi_int) {
    lane_rows<T, Mode, ND, VEC, false>(data, offs, nd, n_pad, i0, xl, bl,
                                       dinv, w, yl);
  } else {
    lane_rows<T, Mode, ND, VEC, true>(data, offs, nd, n_pad, i0, xl, bl,
                                      dinv, w, yl);
  }
}

// ---- variant 3: the lane grid, 4 float32 rows a thread, every X load 16
// bytes wide: a neighbour run at an offset that is no multiple of 4 comes
// from the two aligned 16-byte runs around it, picked by the offset's
// remainder (the same for every thread, so the branch does not diverge)

template <int R>
__device__ __forceinline__ void pick4(float (&v)[4], const float4& p,
                                      const float4& q) {
  const float a[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = a[t + R];
}

template <int Mode, int ND, bool CHECK>
__device__ __forceinline__ void pair_rows(const float* __restrict__ data,
                                          const Offsets& offs, int nd,
                                          int n_pad, int i0,
                                          const float* __restrict__ xl,
                                          const float* __restrict__ bl,
                                          const float* __restrict__ dinv,
                                          float w, float* __restrict__ yl) {
  if (CHECK) {
    lane_rows<float, Mode, ND, 4, true>(data, offs, nd, n_pad, i0, xl, bl,
                                        dinv, w, yl);
    return;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int n_d = ND > 0 ? ND : nd;
#pragma unroll
  for (int d = 0; d < n_d; ++d) {
    const int o = offs.o[d];
    float a[4], xv[4];
    ld_vec<float, 4, false>(a, data + static_cast<int64_t>(d) * n_pad + i0);
    const int r = o & 3;
    const float4* q = reinterpret_cast<const float4*>(xl + i0 + (o - r));
    if (r == 0) {
      ld_vec<float, 4, false>(xv, xl + i0 + o);
    } else {
      const float4 p0 = q[0], p1 = q[1];
      if (r == 1) pick4<1>(xv, p0, p1);
      else if (r == 2) pick4<2>(xv, p0, p1);
      else pick4<3>(xv, p0, p1);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = fma_rn(a[t], xv[t], acc[t]);
  }
  float xv[4], bv[4], dv[4], out[4];
  if (Mode == JACOBI_K) {
    ld_vec<float, 4, false>(xv, xl + i0);
    ld_vec<float, 4, false>(dv, dinv + i0);
  }
  if (Mode == SPMM_SCALED) ld_vec<float, 4, false>(bv, bl + i0);
  if (Mode == SPMM_ADD || Mode == JACOBI_K) {
    ld_vec<float, 4, true>(bv, bl + i0);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    out[t] = epilogue<float, Mode>(acc[t], Mode == JACOBI_K ? xv[t] : 0.f,
                                   Mode == SPMM ? 0.f : bv[t],
                                   Mode == JACOBI_K ? dv[t] : 0.f, w);
  }
  st_vec_cs<float, 4>(yl + i0, out);
}

template <int Mode, int ND>
__global__ void __launch_bounds__(kThreads)
pair_grid_kernel(const float* __restrict__ data, Offsets offs, int nd,
                 int n_pad, int lanes, int row_blocks, int super, int lo_int,
                 int hi_int, const float* __restrict__ x,
                 const float* __restrict__ b, const float* __restrict__ dinv,
                 float w, float* __restrict__ y) {
  constexpr int kRows = kThreads * 4;
  const int bid = blockIdx.x;
  const int per = super * lanes;
  const int st = bid / per;
  const int base = st * super;
  const int s_eff = min(super, row_blocks - base);
  const int rem = bid - st * per;
  const int k = rem / s_eff;
  const int rb = base + (rem - k * s_eff);
  const int64_t lo = static_cast<int64_t>(k) * n_pad;
  const float* bl = Mode == SPMM_SCALED ? b : (b == nullptr ? b : b + lo);
  const int i0 = rb * kRows + static_cast<int>(threadIdx.x) * 4;
  if (rb >= lo_int && rb < hi_int) {
    pair_rows<Mode, ND, false>(data, offs, nd, n_pad, i0, x + lo, bl, dinv,
                               w, y + lo);
  } else {
    pair_rows<Mode, ND, true>(data, offs, nd, n_pad, i0, x + lo, bl, dinv, w,
                              y + lo);
  }
}

// ---- variant 2: staged bursts ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

template <typename T, int Mode, int ND>
__global__ void __launch_bounds__(kThreads)
staged_kernel(const T* __restrict__ data, Offsets offs, int nd, int n_pad,
              int lanes, int tile, int lo_int, int hi_int,
              const T* __restrict__ x, const T* __restrict__ b,
              const T* __restrict__ dinv, T w, T* __restrict__ y) {
  constexpr int H = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int n_d = ND > 0 ? ND : nd;
  const int i0 = blockIdx.x * tile;
  const int rows = min(tile, n_pad - i0);
  const bool interior = static_cast<int>(blockIdx.x) >= lo_int &&
                        static_cast<int>(blockIdx.x) < hi_int;
  if (!interior) {
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int i = i0 + r;
      const T s = Mode == SPMM_SCALED ? b[i] : T(0);
      const T di = Mode == JACOBI_K ? dinv[i] : T(0);
      for (int k = 0; k < lanes; ++k) {
        const int64_t lo = static_cast<int64_t>(k) * n_pad;
        const T acc = row_sum<T, ND, true, false>(data, offs, nd, n_pad, i,
                                                  x + lo);
        const T xv = Mode == JACOBI_K ? x[lo + i] : T(0);
        const T bv = Mode == SPMM_SCALED ? s
                     : (Mode == SPMM_ADD || Mode == JACOBI_K) ? b[lo + i]
                                                              : T(0);
        y[lo + i] = epilogue<T, Mode>(acc, xv, bv, di, w);
      }
    }
    return;
  }
  const int xw = tile + 2 * H;
  T* xs = reinterpret_cast<T*>(smem);
  T* ds = xs + static_cast<int64_t>(lanes) * xw;
  if (threadIdx.x == 0) mbar_init(&bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned xb = static_cast<unsigned>(xw * sizeof(T));
    const unsigned db = static_cast<unsigned>(tile * sizeof(T));
    mbar_expect_tx(&bar, lanes * xb + n_d * db);
    for (int k = 0; k < lanes; ++k) {
      bulk_load(xs + k * xw, x + static_cast<int64_t>(k) * n_pad + i0 - H, xb,
                &bar);
    }
    for (int d = 0; d < n_d; ++d) {
      bulk_load(ds + d * tile, data + static_cast<int64_t>(d) * n_pad + i0,
                db, &bar);
    }
  }
  mbar_wait(&bar, 0);
  for (int r = threadIdx.x; r < tile; r += kThreads) {
    const int i = i0 + r;
    const T s = Mode == SPMM_SCALED ? b[i] : T(0);
    const T di = Mode == JACOBI_K ? dinv[i] : T(0);
    for (int k = 0; k < lanes; ++k) {
      const int64_t lo = static_cast<int64_t>(k) * n_pad;
      const T* xr = xs + k * xw + H + r;
      T acc = T(0);
#pragma unroll
      for (int d = 0; d < n_d; ++d) {
        const int o = offs.o[d];
        const T xv = (o >= -H && o <= H) ? xr[o] : x[lo + i + o];
        acc = fma_rn(ds[d * tile + r], xv, acc);
      }
      const bool lane_b = Mode == SPMM_ADD || Mode == JACOBI_K;
      const T bv = Mode == SPMM_SCALED ? s
                   : lane_b ? __ldcs(b + lo + i) : T(0);
      const T xv = Mode == JACOBI_K ? xr[0] : T(0);
      __stcs(y + lo + i, epilogue<T, Mode>(acc, xv, bv, di, w));
    }
  }
}

// ---- host side ------------------------------------------------------------

// [lo, hi): the blocks of `rows` rows none of whose rows reaches outside
// [0, n_pad) at the offsets [omin, omax] (nor, with a halo h, whose
// staged window does)
void interior(long long n_pad, int rows, int omin, int omax, int h, int* lo,
              int* hi) {
  const long long reach_lo = -static_cast<long long>(std::min(omin, -h));
  const long long reach_hi = std::max(omax, h);
  const long long first = (reach_lo + rows - 1) / rows;
  const long long last = (n_pad - reach_hi) / rows;
  *lo = static_cast<int>(first);
  *hi = static_cast<int>(std::max(first, last));
}

template <typename T, int Mode, int ND>
int launch(int variant, int vec, int super, int tile, const T* data,
           const Offsets& offs, int nd, int n_pad, int lanes, int omin,
           int omax, const T* x, const T* b, const T* dinv, T w, T* y,
           cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (variant == 0) {
    if (lanes > kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
    int lo, hi;
    interior(n_pad, kThreads, omin, omax, 0, &lo, &hi);
    const int blocks = (n_pad + kThreads - 1) / kThreads;
    rows_kernel<T, Mode, ND><<<blocks, kThreads, 0, s>>>(
        data, offs, nd, n_pad, lanes, lo, hi, x, b, dinv, w, y);
  } else if (variant == 1) {
    const int rows = kThreads * vec;
    const int rbs = (n_pad + rows - 1) / rows;
    int lo, hi;
    interior(n_pad, rows, omin, omax, 0, &lo, &hi);
    const long long blocks = static_cast<long long>(rbs) * lanes;
    if (vec == 1) {
      lane_grid_kernel<T, Mode, ND, 1><<<static_cast<unsigned>(blocks),
                                         kThreads, 0, s>>>(
          data, offs, nd, n_pad, lanes, rbs, super, lo, hi, x, b, dinv, w, y);
    } else if (vec == V && n_pad % V == 0) {
      lane_grid_kernel<T, Mode, ND, V><<<static_cast<unsigned>(blocks),
                                         kThreads, 0, s>>>(
          data, offs, nd, n_pad, lanes, rbs, super, lo, hi, x, b, dinv, w, y);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (variant == 3) {
    if constexpr (std::is_same<T, float>::value) {
      const int rows = kThreads * 4;
      if (n_pad % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
      const int rbs = (n_pad + rows - 1) / rows;
      int lo, hi;
      // one row past each end: the aligned pair around a neighbour run
      interior(n_pad, rows, std::min(omin, -4) - 4, std::max(omax, 4) + 4, 0,
               &lo, &hi);
      const long long blocks = static_cast<long long>(rbs) * lanes;
      pair_grid_kernel<Mode, ND><<<static_cast<unsigned>(blocks), kThreads,
                                   0, s>>>(
          data, offs, nd, n_pad, lanes, rbs, super, lo, hi, x, b, dinv, w, y);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (variant == 2) {
    constexpr int H = V;
    if (tile % H != 0 || n_pad % H != 0 || lanes > kMaxLanes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int n_d = ND > 0 ? ND : nd;
    const size_t smem = (static_cast<size_t>(lanes) * (tile + 2 * H) +
                         static_cast<size_t>(n_d) * tile) * sizeof(T);
    if (smem > 232448 - 64) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        staged_kernel<T, Mode, ND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int lo, hi;
    interior(n_pad, tile, omin, omax, H, &lo, &hi);
    const int blocks = (n_pad + tile - 1) / tile;
    staged_kernel<T, Mode, ND><<<blocks, kThreads, smem, s>>>(
        data, offs, nd, n_pad, lanes, tile, lo, hi, x, b, dinv, w, y);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Mode>
int by_nd(int variant, int vec, int super, int tile, const T* data,
          const Offsets& offs, int nd, int n_pad, int lanes, int omin,
          int omax, const T* x, const T* b, const T* dinv, T w, T* y,
          cudaStream_t s) {
  if (nd == 5) {
    return launch<T, Mode, 5>(variant, vec, super, tile, data, offs, nd,
                              n_pad, lanes, omin, omax, x, b, dinv, w, y, s);
  }
  if (nd == 9) {
    return launch<T, Mode, 9>(variant, vec, super, tile, data, offs, nd,
                              n_pad, lanes, omin, omax, x, b, dinv, w, y, s);
  }
  return launch<T, Mode, 0>(variant, vec, super, tile, data, offs, nd, n_pad,
                            lanes, omin, omax, x, b, dinv, w, y, s);
}

template <typename T>
int sweep(int variant, int vec, int super, int tile, const void* data,
          const int* offsets, int nd, long long n_pad, int lanes,
          const void* x, const void* b, const void* dinv, T w, void* y,
          int mode, void* stream) {
  if (nd < 1 || nd > kMaxArgDiags || n_pad <= 0 || n_pad >= (1LL << 31) ||
      lanes < 1 || super < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets offs{};
  int omin = 0, omax = 0;
  for (int d = 0; d < nd; ++d) {
    offs.o[d] = offsets[d];
    omin = std::min(omin, offsets[d]);
    omax = std::max(omax, offsets[d]);
  }
  const int n = static_cast<int>(n_pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* dp = static_cast<const T*>(data);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  const T* dv = static_cast<const T*>(dinv);
  T* yp = static_cast<T*>(y);
  switch (mode) {
    case SPMM:
      return by_nd<T, SPMM>(variant, vec, super, tile, dp, offs, nd, n, lanes,
                            omin, omax, xp, bp, dv, w, yp, s);
    case SPMM_SCALED:
      return by_nd<T, SPMM_SCALED>(variant, vec, super, tile, dp, offs, nd, n,
                                   lanes, omin, omax, xp, bp, dv, w, yp, s);
    case SPMM_ADD:
      return by_nd<T, SPMM_ADD>(variant, vec, super, tile, dp, offs, nd, n,
                                lanes, omin, omax, xp, bp, dv, w, yp, s);
    case JACOBI_K:
      return by_nd<T, JACOBI_K>(variant, vec, super, tile, dp, offs, nd, n,
                                lanes, omin, omax, xp, bp, dv, w, yp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// variant (0 rows, 1 lane grid, 2 staged, 3 lane grid pairs, float32
// only), vec (variant 1: rows a
// thread, 1 or 16 bytes' worth), super (variant 1: row blocks a super
// tile), tile (variant 2: rows a CTA), data, offsets (host int array), nd,
// n_pad, lanes, x, b, dinv, omega (by value), y, mode (0 plain, 1 scale,
// 2 add, 3 Jacobi; b as in the package's pyamg_dia_k_*), stream
int sweep_dia_k_f32(int variant, int vec, int super, int tile,
                    const void* data, const int* offsets, int nd,
                    long long n_pad, int lanes, const void* x, const void* b,
                    const void* dinv, float w, void* y, int mode,
                    void* stream) {
  return sweep<float>(variant, vec, super, tile, data, offsets, nd, n_pad,
                      lanes, x, b, dinv, w, y, mode, stream);
}

int sweep_dia_k_f64(int variant, int vec, int super, int tile,
                    const void* data, const int* offsets, int nd,
                    long long n_pad, int lanes, const void* x, const void* b,
                    const void* dinv, double w, void* y, int mode,
                    void* stream) {
  return sweep<double>(variant, vec, super, tile, data, offsets, nd, n_pad,
                       lanes, x, b, dinv, w, y, mode, stream);
}

}  // extern "C"
