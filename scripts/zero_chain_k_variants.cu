// One-off variants of K11's strip march (pyamg_tpu_torch/csrc/dia_k.cu::
// zero_chain_k_ring_kernel) for scripts/measure_k7_k11.py, which builds
// this file with nvcc and times it beside the package's kernel; nothing in
// the package uses it.
//
// They are the strip march's first form: two barriers a step (the step's
// new r rows, then its X and Y rows), a ring of step + hl + hr rows, and
// no L2 hints.  They leave open what the package fixes, so the script can
// show what each alternative costs:
//
// - threads per CTA and CTAs per SM (the package: 1024 and 1);
// - the term loops: a runtime loop that branches around an out-of-range
//   neighbour's term, or (nd = nds = 5 only) unrolled with the branch
//   replaced by a select, so all of a row's loads can issue together;
// - lanes per group (the package: the most that fit, at most 8) and the
//   step (a multiple of the threads; the package: 1024 rows), as runtime
//   arguments.
//
// And two schedules that are no strip march, for 2-D grid operators (St's
// offsets dy * s + dx with small dy, dx): independent 2-D tiles of the
// grid, each forming r once on the rows around it (tile_kernel, plain or
// with the package's L2 hints and unrolled loops).
//
// Every variant sums each value in the package's order with its
// arithmetic, so it gives the package's bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 8;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T, int NT, int MINB, bool UNROLL>
__global__ void __launch_bounds__(NT, MINB)
ring_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
            int nd, const T* __restrict__ sdata,
            const int* __restrict__ soffsets, int nds, int64_t n_pad,
            int lanes, int group, int step, int64_t strip, int hl, int hr,
            const T* __restrict__ b, const T* __restrict__ dinv,
            const T* __restrict__ tv, T w, T* __restrict__ x_out,
            T* __restrict__ y_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int n_e = UNROLL ? 5 : nd;
  const int n_s = UNROLL ? 5 : nds;
  const int cap = step + hl + hr;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * strip;
  if (s0 >= n_pad) return;
  const int64_t s1 = s0 + strip < n_pad ? s0 + strip : n_pad;
  const int k0 = blockIdx.y * group;
  const int gl = min(group, lanes - k0);
  b += static_cast<int64_t>(k0) * n_pad;
  x_out += static_cast<int64_t>(k0) * n_pad;
  y_out += static_cast<int64_t>(k0) * n_pad;
  const int64_t lo = s0 - hl;
  int64_t filled = lo;
  for (int64_t i = s0; i < s1; i += step) {
    const int ti = static_cast<int>(s1 - i < step ? s1 - i : step);
    const int64_t want = i + ti + hr;
    for (int64_t jj = filled + threadIdx.x; jj < want; jj += NT) {
      if (jj < 0 || jj >= n_pad) continue;
      const int64_t j = jj;
      T acc1[kLanes];
#pragma unroll
      for (int k = 0; k < kLanes; ++k) acc1[k] = T(0);
#pragma unroll
      for (int e = 0; e < n_e; ++e) {
        const int64_t m = j + offsets[e];
        const bool in = m >= 0 && m < n_pad;
        if (!UNROLL && !in) continue;
        const int64_t mc = in ? m : j;
        const T a = data[static_cast<int64_t>(e) * n_pad + j];
        const T dm = dinv[mc];
#pragma unroll
        for (int k = 0; k < kLanes; ++k) {
          if (k < gl) {
            const T v = fma_rn(
                a, w * (dm * b[static_cast<int64_t>(k) * n_pad + mc]),
                acc1[k]);
            acc1[k] = in ? v : acc1[k];
          }
        }
      }
      const int slot = static_cast<int>(
          static_cast<unsigned>(j - lo) % static_cast<unsigned>(cap));
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        if (k < gl)
          ring[k * cap + slot] = b[static_cast<int64_t>(k) * n_pad + j]
                                 - acc1[k];
      }
    }
    filled = want;
    __syncthreads();
    const int base0 = static_cast<int>((i - lo) % cap);
    for (int q = threadIdx.x; q < ti; q += NT) {
      const int64_t row = i + q;
      int base = base0 + q;
      if (base >= cap) base -= cap;
      T acc2[kLanes];
#pragma unroll
      for (int k = 0; k < kLanes; ++k) acc2[k] = T(0);
#pragma unroll
      for (int s = 0; s < n_s; ++s) {
        const int so = soffsets[s];
        const int64_t j = row + so;
        const bool in = j >= 0 && j < n_pad;
        if (!UNROLL && !in) continue;
        const T sv = sdata[static_cast<int64_t>(s) * n_pad + row];
        int sl = base + so;
        if (sl < 0) sl += cap;
        else if (sl >= cap) sl -= cap;
#pragma unroll
        for (int k = 0; k < kLanes; ++k) {
          if (k < gl) {
            const T v = fma_rn(sv, ring[k * cap + sl], acc2[k]);
            acc2[k] = in ? v : acc2[k];
          }
        }
      }
      const T di = dinv[row];
      const T t = tv[row];
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        if (k < gl) {
          const int64_t o = static_cast<int64_t>(k) * n_pad + row;
          x_out[o] = w * (di * b[o]);
          y_out[o] = t * acc2[k];
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int NT, int MINB, bool UNROLL>
int launch(const void* data, const void* offsets, int nd, const void* sdata,
           const void* soffsets, int nds, long long n_pad, int lanes,
           int group, int step, long long strip, int hl, int hr,
           const void* b, const void* dinv, const void* tv, T w,
           void* x_out, void* y_out, void* stream) {
  if (group < 1 || group > kLanes || step < NT || step % NT != 0 ||
      (UNROLL && (nd != 5 || nds != 5))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(step + hl + hr) * group * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      ring_kernel<T, NT, MINB, UNROLL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((n_pad + strip - 1) / strip),
                  static_cast<unsigned int>((lanes + group - 1) / group));
  ring_kernel<T, NT, MINB, UNROLL><<<grid, NT, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), nd,
      static_cast<const T*>(sdata), static_cast<const int*>(soffsets), nds,
      n_pad, lanes, group, step, strip, hl, hr, static_cast<const T*>(b),
      static_cast<const T*>(dinv), static_cast<const T*>(tv), w,
      static_cast<T*>(x_out), static_cast<T*>(y_out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int variant, const void* data, const void* offsets, int nd,
             const void* sdata, const void* soffsets, int nds,
             long long n_pad, int lanes, int group, int step, long long strip,
             int hl, int hr, const void* b, const void* dinv, const void* tv,
             T w, void* x_out, void* y_out, void* stream) {
#define PYAMG_K11_VARIANT(ID, NT, MINB, UNROLL)                             \
  case ID:                                                                  \
    return launch<T, NT, MINB, UNROLL>(data, offsets, nd, sdata, soffsets,  \
                                       nds, n_pad, lanes, group, step,      \
                                       strip, hl, hr, b, dinv, tv, w,       \
                                       x_out, y_out, stream);
  switch (variant) {
    PYAMG_K11_VARIANT(0, 1024, 1, false)
    PYAMG_K11_VARIANT(1, 1024, 1, true)
    PYAMG_K11_VARIANT(2, 512, 2, false)
    PYAMG_K11_VARIANT(3, 512, 2, true)
    PYAMG_K11_VARIANT(4, 512, 1, false)
    PYAMG_K11_VARIANT(5, 256, 4, false)
    PYAMG_K11_VARIANT(6, 256, 2, false)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PYAMG_K11_VARIANT
}

// A different schedule: 2-D tiles of a grid operator instead of a strip
// march.  Every offset o of St is dy * s + dx with |dy| <= DY and |dx| <=
// DX for a stride s (a 2-D grid's row length); a CTA owns the rows (y0 +
// ty) * s + x0 + tx, ty < TY, tx < TX (x0 + tx < s), forms r once on the
// (TY + 2 DY) x (TX + 2 DX) rows around them in shared memory (contiguous
// runs of the 1-D index), then Y and X for its rows.  Tiles are
// independent, so several CTAs share an SM and overlap their barriers, and
// the CTAs in flight cover a band of the grid (a small L2 footprint); the
// price is the halo, r computed more than once on (TY + 2 DY)(TX + 2 DX) /
// (TY TX) - 1 of the rows.
template <typename T, int ND, bool HINTS>
__global__ void __launch_bounds__(256, 4)
tile_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
            int nd, const T* __restrict__ sdata,
            const int* __restrict__ soffsets, int nds, int64_t n_pad,
            int lanes, int group, int s, int ny, int ty_n, int tx_n, int dy_r,
            int dx_r, const T* __restrict__ b, const T* __restrict__ dinv,
            const T* __restrict__ tv, T w, T* __restrict__ x_out,
            T* __restrict__ y_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ry = ty_n + 2 * dy_r;
  const int rx = tx_n + 2 * dx_r;
  const int area = ry * rx;
  T* r = reinterpret_cast<T*>(smem);
  int* sdy = reinterpret_cast<int*>(r + static_cast<int64_t>(kLanes) * area);
  int* sdx = sdy + nds;
  const int nbx = (s + tx_n - 1) / tx_n;
  const int by = blockIdx.x / nbx;
  const int bx = blockIdx.x - by * nbx;
  const int y0 = by * ty_n;
  const int x0 = bx * tx_n;
  const int k0 = blockIdx.y * group;
  const int gl = min(group, lanes - k0);
  b += static_cast<int64_t>(k0) * n_pad;
  x_out += static_cast<int64_t>(k0) * n_pad;
  y_out += static_cast<int64_t>(k0) * n_pad;
  for (int q = threadIdx.x; q < nds; q += blockDim.x) {
    const int so = soffsets[q];
    const int dy = so >= 0 ? (so + s / 2) / s : -((-so + s / 2) / s);
    sdy[q] = dy;
    sdx[q] = so - dy * s;
  }
  for (int p = threadIdx.x; p < area; p += blockDim.x) {
    const int py = p / rx;
    const int px = p - py * rx;
    const int64_t i = static_cast<int64_t>(y0 - dy_r + py) * s + x0 - dx_r
                      + px;
    if (i < 0 || i >= n_pad) continue;
    T acc1[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc1[k] = T(0);
    const int n_e = ND > 0 ? ND : nd;
#pragma unroll
    for (int e = 0; e < n_e; ++e) {
      const int64_t m = i + offsets[e];
      if (m < 0 || m >= n_pad) continue;
      const T* ap = data + static_cast<int64_t>(e) * n_pad + i;
      const T a = HINTS ? __ldcs(ap) : *ap;
      const T dm = dinv[m];
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        if (k < gl)
          acc1[k] = fma_rn(
              a, w * (dm * b[static_cast<int64_t>(k) * n_pad + m]), acc1[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      if (k < gl) r[k * area + p] = b[static_cast<int64_t>(k) * n_pad + i]
                                    - acc1[k];
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < ty_n * tx_n; q += blockDim.x) {
    const int ty = q / tx_n;
    const int tx = q - ty * tx_n;
    if (x0 + tx >= s || y0 + ty >= ny) continue;
    const int64_t row = static_cast<int64_t>(y0 + ty) * s + x0 + tx;
    if (row >= n_pad) continue;
    T acc2[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc2[k] = T(0);
    const int n_s = ND > 0 ? ND : nds;
#pragma unroll
    for (int e = 0; e < n_s; ++e) {
      const int64_t j = row + soffsets[e];
      if (j < 0 || j >= n_pad) continue;
      const T* sp = sdata + static_cast<int64_t>(e) * n_pad + row;
      const T sv = HINTS ? __ldcs(sp) : *sp;
      const int pos = (ty + dy_r + sdy[e]) * rx + tx + dx_r + sdx[e];
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        if (k < gl) acc2[k] = fma_rn(sv, r[k * area + pos], acc2[k]);
      }
    }
    const T di = dinv[row];
    const T t = HINTS ? __ldcs(tv + row) : tv[row];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      if (k < gl) {
        const int64_t o = static_cast<int64_t>(k) * n_pad + row;
        if (HINTS) {
          __stcs(x_out + o, w * (di * b[o]));
          __stcs(y_out + o, t * acc2[k]);
        } else {
          x_out[o] = w * (di * b[o]);
          y_out[o] = t * acc2[k];
        }
      }
    }
  }
}

template <typename T, int ND, bool HINTS>
int launch_tile(const void* data, const void* offsets, int nd,
                const void* sdata, const void* soffsets, int nds,
                long long n_pad, int lanes, int group, int s, int ty_n,
                int tx_n, int dy_r, int dx_r, const void* b,
                const void* dinv, const void* tv, T w, void* x_out,
                void* y_out, void* stream) {
  if (group < 1 || group > kLanes || s < 1 || ty_n < 1 || tx_n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ny = static_cast<int>((n_pad + s - 1) / s);
  const size_t smem = static_cast<size_t>(ty_n + 2 * dy_r) *
                      (tx_n + 2 * dx_r) * kLanes * sizeof(T) +
                      2 * nds * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<T, ND, HINTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int tiles =
      static_cast<unsigned int>((ny + ty_n - 1) / ty_n) *
      static_cast<unsigned int>((s + tx_n - 1) / tx_n);
  const dim3 grid(tiles, static_cast<unsigned int>((lanes + group - 1) /
                                                   group));
  tile_kernel<T, ND, HINTS><<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), nd,
      static_cast<const T*>(sdata), static_cast<const int*>(soffsets), nds,
      n_pad, lanes, group, s, ny, ty_n, tx_n, dy_r, dx_r,
      static_cast<const T*>(b), static_cast<const T*>(dinv),
      static_cast<const T*>(tv), w, static_cast<T*>(x_out),
      static_cast<T*>(y_out));
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

extern "C" {

// variant (0-6: threads, CTAs per SM, unrolled as in `dispatch`), data,
// offsets, nd, sdata, soffsets, nds, n_pad, lanes, group, step, strip, hl,
// hr, b, dinv, tv, omega, x_out, y_out, stream
int sweep_zero_chain_k_ring_f32(int variant, const void* data,
                                const void* offsets, int nd,
                                const void* sdata, const void* soffsets,
                                int nds, long long n_pad, int lanes,
                                int group, int step, long long strip, int hl,
                                int hr, const void* b, const void* dinv,
                                const void* tv, float w, void* x_out,
                                void* y_out, void* stream) {
  return dispatch<float>(variant, data, offsets, nd, sdata, soffsets, nds,
                         n_pad, lanes, group, step, strip, hl, hr, b, dinv,
                         tv, w, x_out, y_out, stream);
}

// the 2-D tile schedule: data, offsets, nd, sdata, soffsets, nds, n_pad,
// lanes, group, s, TY, TX, DY, DX, b, dinv, tv, omega, x_out, y_out,
// tuned (the package's L2 hints and, for 5 or 9 diagonals, unrolled
// loops), stream
int sweep_zero_chain_k_tile_f32(const void* data, const void* offsets,
                                int nd, const void* sdata,
                                const void* soffsets, int nds,
                                long long n_pad, int lanes, int group, int s,
                                int ty_n, int tx_n, int dy_r, int dx_r,
                                const void* b, const void* dinv,
                                const void* tv, float w, void* x_out,
                                void* y_out, int tuned, void* stream) {
#define PYAMG_K11_TILE(ND, HINTS)                                           \
  return launch_tile<float, ND, HINTS>(data, offsets, nd, sdata, soffsets,  \
                                       nds, n_pad, lanes, group, s, ty_n,   \
                                       tx_n, dy_r, dx_r, b, dinv, tv, w,    \
                                       x_out, y_out, stream)
  if (!tuned) PYAMG_K11_TILE(0, false);
  if (nd == 5 && nds == 5) PYAMG_K11_TILE(5, true);
  if (nd == 9 && nds == 9) PYAMG_K11_TILE(9, true);
  PYAMG_K11_TILE(0, true);
#undef PYAMG_K11_TILE
}

}  // extern "C"
