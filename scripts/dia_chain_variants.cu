// One-off variants of K5 and K4 (pyamg_tpu_torch/csrc/dia_chain.cu) for
// scripts/measure_k4_k5.py, which builds this file with nvcc and times it
// beside the package's kernels; nothing in the package uses it.
//
// - The package's strip march (chain_ring_kernel) at the rows a thread
//   the package does not build: 2 float32 rows a thread (8-byte loads).
//   Threads per CTA, the strips and the package's rows a thread are
//   arguments of its own entry point, so the script sweeps those through
//   it.
// - K5 on 2-D tiles of the grid (zero_chain_tile_kernel), for 2-D grid
//   operators (offsets dy * s + dx with small dy, dx): a CTA forms r once
//   on its TY x TX tile of grid rows and a halo of DY rows and DX columns
//   in shared memory, then x and y for its rows.  Tiles are independent
//   (no warm-up passes, several CTAs an SM); the price is the halo, r
//   formed again on (TY + 2 DY)(TX + 2 DX) / (TY TX) - 1 of the rows.
//   The K-lane form of this schedule is scripts/zero_chain_k_variants.cu.
//
// Every variant sums each value in the package's order with its
// arithmetic, so it gives the package's bits.

#include "../pyamg_tpu_torch/csrc/dia_chain.cu"

namespace {

template <typename T, int ND>
__global__ void __launch_bounds__(256)
zero_chain_tile_kernel(const T* __restrict__ data,
                       const int* __restrict__ offsets, int nd,
                       const T* __restrict__ sdata,
                       const int* __restrict__ soffsets, int nds, int n_pad,
                       int s, int ny, int ty_n, int tx_n, int dy_r, int dx_r,
                       const T* __restrict__ b, const T* __restrict__ dinv,
                       const T* __restrict__ tv, T w, T* __restrict__ x_out,
                       T* __restrict__ y_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rx = tx_n + 2 * dx_r;
  const int area = (ty_n + 2 * dy_r) * rx;
  T* r = reinterpret_cast<T*>(smem);
  int* sdy = reinterpret_cast<int*>(r + area);
  int* sdx = sdy + nds;
  const int nbx = (s + tx_n - 1) / tx_n;
  const int by = blockIdx.x / nbx;
  const int bx = blockIdx.x - by * nbx;
  const int y0 = by * ty_n;
  const int x0 = bx * tx_n;
  for (int q = threadIdx.x; q < nds; q += blockDim.x) {
    const int so = soffsets[q];
    const int dy = so >= 0 ? (so + s / 2) / s : -((-so + s / 2) / s);
    sdy[q] = dy;
    sdx[q] = so - dy * s;
  }
  const int n_e = ND > 0 ? ND : nd;
  for (int p = threadIdx.x; p < area; p += blockDim.x) {
    const int py = p / rx;
    const int px = p - py * rx;
    const int i = (y0 - dy_r + py) * s + x0 - dx_r + px;
    if (i < 0 || i >= n_pad) continue;
    T acc = T(0);
#pragma unroll
    for (int e = 0; e < n_e; ++e) {
      const int m = i + offsets[e];
      const bool in = m >= 0 && m < n_pad;
      const int mc = in ? m : i;
      const T v = fma_rn(__ldcs(data + static_cast<int64_t>(e) * n_pad + i),
                         w * (dinv[mc] * b[mc]), acc);
      acc = in ? v : acc;
    }
    r[p] = b[i] - acc;
  }
  __syncthreads();
  const int n_s = ND > 0 ? ND : nds;
  for (int q = threadIdx.x; q < ty_n * tx_n; q += blockDim.x) {
    const int ty = q / tx_n;
    const int tx = q - ty * tx_n;
    if (x0 + tx >= s || y0 + ty >= ny) continue;
    const int row = (y0 + ty) * s + x0 + tx;
    if (row >= n_pad) continue;
    T acc = T(0);
#pragma unroll
    for (int e = 0; e < n_s; ++e) {
      const int j = row + soffsets[e];
      const bool in = j >= 0 && j < n_pad;
      const int pos = (ty + dy_r + sdy[e]) * rx + tx + dx_r + sdx[e];
      const T v = fma_rn(
          __ldcs(sdata + static_cast<int64_t>(e) * n_pad + row), r[pos], acc);
      acc = in ? v : acc;
    }
    __stcs(x_out + row, w * (dinv[row] * b[row]));
    __stcs(y_out + row, __ldcs(tv + row) * acc);
  }
}

template <typename T, int ND>
int launch_tile(const void* data, const void* offsets, int nd,
                const void* sdata, const void* soffsets, int nds, int n_pad,
                int s, int ty_n, int tx_n, int dy_r, int dx_r, const void* b,
                const void* dinv, const void* tv, T w, void* x_out,
                void* y_out, cudaStream_t stream) {
  const int ny = (n_pad + s - 1) / s;
  const size_t smem = static_cast<size_t>(ty_n + 2 * dy_r) *
                      (tx_n + 2 * dx_r) * sizeof(T) + 2 * nds * sizeof(int);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      zero_chain_tile_kernel<T, ND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int tiles =
      static_cast<unsigned int>((ny + ty_n - 1) / ty_n) *
      static_cast<unsigned int>((s + tx_n - 1) / tx_n);
  zero_chain_tile_kernel<T, ND><<<tiles, 256, smem, stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), nd,
      static_cast<const T*>(sdata), static_cast<const int*>(soffsets), nds,
      n_pad, s, ny, ty_n, tx_n, dy_r, dx_r, static_cast<const T*>(b),
      static_cast<const T*>(dinv), static_cast<const T*>(tv), w,
      static_cast<T*>(x_out), static_cast<T*>(y_out));
  return static_cast<int>(cudaGetLastError());
}

// the package's strip march at VEC rows a thread, any mode
template <typename T, int VEC>
int sweep_ring(int mode, const void* data, const void* offsets, int nd,
               const void* sdata, const void* soffsets, int nds, int n_pad,
               int threads, int strip, int al, int ar, int hl, int hr,
               const void* x, const void* b, const void* dinv,
               const void* tv, T w, void* out0, void* out1,
               cudaStream_t stream) {
  if (threads < 32 || threads > kRingMaxThreads || n_pad % VEC != 0 ||
      strip % VEC != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == ZERO_CHAIN) {
    return launch_ring_nd<T, ZERO_CHAIN, VEC>(
        data, offsets, nd, sdata, soffsets, nds, n_pad, threads, strip, al,
        ar, hl, hr, x, b, dinv, tv, w, nullptr, out0, out1, stream);
  }
  return launch_ring_nd<T, JACOBI_RES, VEC>(
      data, offsets, nd, data, offsets, nd, n_pad, threads, strip, al, ar,
      al, ar, x, b, dinv, tv, w, nullptr, out0, out1, stream);
}

}  // namespace

extern "C" {

// mode (0 K5, 1 K4), vec (1, 2 or 4), data, offsets, nd, sdata, soffsets,
// nds, n_pad, threads, strip, al, ar, hl, hr, x, b, dinv, tv, omega,
// out0, out1, stream (the package's ring entry point's arguments)
int sweep_chain_ring_f32(int mode, int vec, const void* data,
                         const void* offsets, int nd, const void* sdata,
                         const void* soffsets, int nds, int n_pad,
                         int threads, int strip, int al, int ar, int hl,
                         int hr, const void* x, const void* b,
                         const void* dinv, const void* tv, float w,
                         void* out0, void* out1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PYAMG_SWEEP(VEC)                                                    \
  return sweep_ring<float, VEC>(mode, data, offsets, nd, sdata, soffsets,   \
                                nds, n_pad, threads, strip, al, ar, hl, hr, \
                                x, b, dinv, tv, w, out0, out1, s)
  if (vec == 1) PYAMG_SWEEP(1);
  if (vec == 2) PYAMG_SWEEP(2);
  if (vec == 4) PYAMG_SWEEP(4);
#undef PYAMG_SWEEP
  return static_cast<int>(cudaErrorInvalidValue);
}

int sweep_chain_ring_f64(int mode, int vec, const void* data,
                         const void* offsets, int nd, const void* sdata,
                         const void* soffsets, int nds, int n_pad,
                         int threads, int strip, int al, int ar, int hl,
                         int hr, const void* x, const void* b,
                         const void* dinv, const void* tv, double w,
                         void* out0, void* out1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 1) {
    return sweep_ring<double, 1>(mode, data, offsets, nd, sdata, soffsets,
                                 nds, n_pad, threads, strip, al, ar, hl, hr,
                                 x, b, dinv, tv, w, out0, out1, s);
  }
  if (vec == 2) {
    return sweep_ring<double, 2>(mode, data, offsets, nd, sdata, soffsets,
                                 nds, n_pad, threads, strip, al, ar, hl, hr,
                                 x, b, dinv, tv, w, out0, out1, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5 on 2-D tiles: data, offsets, nd, sdata, soffsets, nds, n_pad, s (the
// grid's row stride), TY, TX, DY, DX, b, dinv, tv, omega, x_out, y_out,
// stream
int sweep_zero_chain_tile_f32(const void* data, const void* offsets, int nd,
                              const void* sdata, const void* soffsets,
                              int nds, int n_pad, int s, int ty_n, int tx_n,
                              int dy_r, int dx_r, const void* b,
                              const void* dinv, const void* tv, float w,
                              void* x_out, void* y_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PYAMG_TILE(ND)                                                      \
  return launch_tile<float, ND>(data, offsets, nd, sdata, soffsets, nds,    \
                                n_pad, s, ty_n, tx_n, dy_r, dx_r, b, dinv,  \
                                tv, w, x_out, y_out, st)
  if (nd == 5 && nds == 5) PYAMG_TILE(5);
  if (nd == 9 && nds == 9) PYAMG_TILE(9);
  PYAMG_TILE(0);
#undef PYAMG_TILE
}

}  // extern "C"
