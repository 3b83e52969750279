// Interleaved lane-stack DIA kernel of pyamg_tpu_torch, for Hopper
// (sm_90a), K15: one template in five modes over (S, K, 128) stacks.
//
//   interleaved_kernel<Mode>  replaces pyamg_tpu/sparse/interleaved.py::_spmv_kernel / _run
//
// With wd = omega * dinv (per row) and A the DIA operator of `data`:
//   ZERO_RES  x = wd * b,  r = b - A x        (int_jacobi_zero_res)
//   SCALED    z = tv * (A r)                  (int_spmv_scaled)
//   PLAIN     y = A t                         (int_spmv)
//   ADD       y = x + A t                     (int_spmv_add)
//   JSTEP     y = x + wd * (b - A x)          (int_jacobi_step)
//
// Layout: a stack holds K lanes of n_pad = S * 128 rows interleaved by
// 128-row tiles: row i of lane k lives at ((i / 128) * K + k) * 128 +
// i % 128, so one tile of all K lanes is one contiguous (K, 128) block.
// Operator data stays (nd, n_pad) row-major, data[d, i] = A[i, i +
// offsets[d]], zero where A has no entry or the column leaves [0, n_pad);
// per-row vectors (wd, tv) are plain (n_pad,).
//
// Design: one thread per (tile, in-tile row), i.e. per row i, looping over
// the lanes inside: data[d, i] and the per-row vectors are read once for
// all lanes, and for a fixed lane and diagonal the 32 threads of a warp
// read 32 neighbouring addresses of one tile row (two segments when the
// shift crosses a tile), so the loads are coalesced.  Each lane's sum runs
// over the diagonals in offset order, then the epilogue, as the plain
// twins do; nvcc contracts to FMAs, so results agree to rounding.  A
// neighbour j = i + offsets[d] outside [0, n_pad) skips its term (the TPU
// kernel reads a clamped halo and multiplies it by the stored zero).  A
// launch covers lanes [k0, k0 + lanes), lanes <= kMaxLanes, in a register
// array indexed only by unrolled constants; the wrapper launches larger K
// in chunks.  float32 only, as the reference's gate.
//
// Bound: device-memory bandwidth.  Per row: nd diagonals plus, per lane,
// the stacks read and written once (2 for PLAIN and SCALED, 3 for
// ZERO_RES, ADD and JSTEP) and the shared vectors (1 for ZERO_RES, SCALED
// and JSTEP), against 2 nd K flops: ~1 flop per byte at K = 8, nd = 5.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxLanes = 16;
constexpr int kThreads = 256;
constexpr int kTile = 128;

enum IntMode : int { ZERO_RES = 0, SCALED = 1, PLAIN = 2, ADD = 3, JSTEP = 4 };

__device__ __forceinline__ int64_t tile_addr(int64_t i, int K) {
  return (i / kTile) * static_cast<int64_t>(K) * kTile + i % kTile;
}

// in: the haloed stack (b for ZERO_RES, r for SCALED, t for PLAIN and ADD,
// x for JSTEP); aux: the centre-only stack (x for ADD, b for JSTEP); vec:
// wd (ZERO_RES, JSTEP) or tv (SCALED); out0, out1: outputs (out1 is r for
// ZERO_RES only).
template <int Mode>
__global__ void __launch_bounds__(kThreads)
interleaved_kernel(const float* __restrict__ data,
                   const int* __restrict__ offsets, int nd, int64_t n_pad,
                   int K, int k0, int lanes, const float* __restrict__ in,
                   const float* __restrict__ aux,
                   const float* __restrict__ vec, float* __restrict__ out0,
                   float* __restrict__ out1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const int64_t ci = tile_addr(i, K) + static_cast<int64_t>(k0) * kTile;
  float acc[kMaxLanes];
#pragma unroll
  for (int k = 0; k < kMaxLanes; ++k) acc[k] = 0.0f;
  for (int d = 0; d < nd; ++d) {
    const int64_t j = i + offsets[d];
    if (j < 0 || j >= n_pad) continue;
    const float a = data[static_cast<int64_t>(d) * n_pad + i];
    const int64_t cj = tile_addr(j, K) + static_cast<int64_t>(k0) * kTile;
    if (Mode == ZERO_RES) {
      const float wj = vec[j];
#pragma unroll
      for (int k = 0; k < kMaxLanes; ++k) {
        if (k < lanes) acc[k] += a * (wj * in[cj + k * kTile]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kMaxLanes; ++k) {
        if (k < lanes) acc[k] += a * in[cj + k * kTile];
      }
    }
  }
  if (Mode == ZERO_RES) {
    const float wi = vec[i];
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) {
        const int64_t o = ci + k * kTile;
        out0[o] = wi * in[o];
        out1[o] = in[o] - acc[k];
      }
    }
  } else if (Mode == SCALED) {
    const float t = vec[i];
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) out0[ci + k * kTile] = t * acc[k];
    }
  } else if (Mode == PLAIN) {
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) out0[ci + k * kTile] = acc[k];
    }
  } else if (Mode == ADD) {
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) {
        const int64_t o = ci + k * kTile;
        out0[o] = aux[o] + acc[k];
      }
    }
  } else {  // JSTEP
    const float wi = vec[i];
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k < lanes) {
        const int64_t o = ci + k * kTile;
        out0[o] = in[o] + wi * (aux[o] - acc[k]);
      }
    }
  }
}

template <int Mode>
void launch_mode(long long n_pad, cudaStream_t s, const void* data,
                 const void* offsets, int nd, int K, int k0, int lanes,
                 const void* in, const void* aux, const void* vec,
                 void* out0, void* out1) {
  const unsigned int blocks =
      static_cast<unsigned int>((n_pad + kThreads - 1) / kThreads);
  interleaved_kernel<Mode><<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(data), static_cast<const int*>(offsets), nd,
      n_pad, K, k0, lanes, static_cast<const float*>(in),
      static_cast<const float*>(aux), static_cast<const float*>(vec),
      static_cast<float*>(out0), static_cast<float*>(out1));
}

}  // namespace

extern "C" {

// data, offsets, nd, n_pad, K, k0, lanes, in, aux, vec, out0, out1, mode,
// stream.  Stacks are (n_pad / 128, K, 128) float32; the launch covers
// lanes [k0, k0 + lanes).
int pyamg_interleaved_f32(const void* data, const void* offsets, int nd,
                          long long n_pad, int K, int k0, int lanes,
                          const void* in, const void* aux, const void* vec,
                          void* out0, void* out1, int mode, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || k0 < 0 || k0 + lanes > K ||
      n_pad % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case ZERO_RES:
      launch_mode<ZERO_RES>(n_pad, s, data, offsets, nd, K, k0, lanes, in,
                            aux, vec, out0, out1);
      break;
    case SCALED:
      launch_mode<SCALED>(n_pad, s, data, offsets, nd, K, k0, lanes, in, aux,
                          vec, out0, out1);
      break;
    case PLAIN:
      launch_mode<PLAIN>(n_pad, s, data, offsets, nd, K, k0, lanes, in, aux,
                         vec, out0, out1);
      break;
    case ADD:
      launch_mode<ADD>(n_pad, s, data, offsets, nd, K, k0, lanes, in, aux,
                       vec, out0, out1);
      break;
    case JSTEP:
      launch_mode<JSTEP>(n_pad, s, data, offsets, nd, K, k0, lanes, in, aux,
                         vec, out0, out1);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
