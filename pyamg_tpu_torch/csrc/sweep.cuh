// What the one-launch multicolour sweeps share (csrc/mcgs.cu, the scalar
// DIA sweep; csrc/block_dia.cu, the block sweep): the colours of a
// launch's phases, the barrier between phases and the launch of both
// barrier routes.
//
// A sweep kernel walks `order`, one phase a colour; between phases every
// thread of the launch waits at a barrier.  Two routes:
//   - GRID: a cooperative launch, the barrier cooperative_groups'
//     this_grid().sync(); the grid is at most the blocks that stay
//     resident (occupancy x SMs) and no more than the largest colour's
//     work items need;
//   - one CTA, the barrier __syncthreads(), no grid-wide synchronisation;
//     the iterate is copied into the CTA's shared memory at the start, the
//     phases update it there, and it is written out at the end, so a
//     phase's reads of x are shared-memory reads and no phase runs over
//     every row.
// A kernel instance is __launch_bounds__(kGridThreads) on the grid route
// (up to 256 threads a CTA, registers enough for a node's batched loads)
// and __launch_bounds__(kMaxThreads) on the one-CTA route (up to 1024).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPhases = 256;
constexpr int kMaxThreads = 1024;
constexpr int kGridThreads = 256;
// the shared memory a CTA may hold (an H100's 227 KB)
constexpr size_t kMaxSmem = 232448;

// the colours of a launch's phases, passed by value
struct Order {
  int n;
  int c[kMaxPhases];
};

template <bool GRID>
__device__ __forceinline__ void phase_barrier() {
  if constexpr (GRID) {
    cooperative_groups::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// `order` (host ints) as an Order; false when it is empty or too long
inline bool make_order(const int* order, int norder, Order& o) {
  if (norder <= 0 || norder > kMaxPhases) return false;
  o.n = norder;
  for (int p = 0; p < norder; ++p) o.c[p] = order[p];
  return true;
}

inline bool sweep_threads_ok(int threads, int grid_route) {
  return threads >= 32 && threads % 32 == 0 &&
         threads <= (grid_route ? kGridThreads : kMaxThreads);
}

// The dynamic shared memory of a sweep CTA: the colour offsets
// (ncolours + 1) and the operator's diagonal offsets (nd), read once at
// the start instead of once a phase, rounded up to 16 bytes; then, on
// the one-CTA route, the iterate (x_bytes).
__host__ __device__ inline size_t offsets_smem(int ncolours, int nd) {
  return (static_cast<size_t>(ncolours + 1 + nd) * sizeof(int) + 15) / 16 *
         16;
}

inline size_t sweep_smem(int ncolours, int nd, size_t x_bytes) {
  return offsets_smem(ncolours, nd) + x_bytes;
}

// the iterate's copy in a one-CTA sweep's shared memory
template <typename T>
__device__ __forceinline__ T* shared_x(int* smem, int ncolours, int nd) {
  return reinterpret_cast<T*>(reinterpret_cast<char*>(smem) +
                              offsets_smem(ncolours, nd));
}

// Copies the colour offsets and the diagonal offsets into the CTA's
// shared memory; returns the diagonal offsets' copy (the colour offsets
// start the block).
__device__ __forceinline__ const int* stage_offsets(int* smem,
                                                    const int* coff,
                                                    int ncolours,
                                                    const int* offsets,
                                                    int nd) {
  for (int t = threadIdx.x; t <= ncolours; t += blockDim.x) {
    smem[t] = __ldg(coff + t);
  }
  for (int t = threadIdx.x; t < nd; t += blockDim.x) {
    smem[ncolours + 1 + t] = __ldg(offsets + t);
  }
  __syncthreads();
  return smem + ncolours + 1;
}

// Launch grid_kernel cooperatively over min(resident, ceil(max_items /
// threads)) CTAs (at least one) with the offsets' shared memory, or
// cta_kernel as one CTA with the offsets' and the iterate's (x_bytes);
// either of `threads` threads.
template <typename A>
cudaError_t launch_sweep_route(void (*grid_kernel)(A, Order),
                               void (*cta_kernel)(A, Order), const A& a,
                               const Order& order, int threads,
                               long long max_items, int grid_route,
                               int ncolours, int nd, size_t x_bytes,
                               cudaStream_t s) {
  if (!grid_route) {
    const size_t smem = sweep_smem(ncolours, nd, x_bytes);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    cta_kernel<<<1, threads, smem, s>>>(a, order);
    return cudaGetLastError();
  }
  const size_t smem = offsets_smem(ncolours, nd);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long needed = (max_items + threads - 1) / threads;
  const long long blocks =
      needed < 1 ? 1 : (needed < resident ? needed : resident);
  void* args[] = {const_cast<A*>(&a), const_cast<Order*>(&order)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(grid_kernel),
                                     dim3(static_cast<unsigned int>(blocks)),
                                     dim3(threads), args, smem, s);
}

}  // namespace
