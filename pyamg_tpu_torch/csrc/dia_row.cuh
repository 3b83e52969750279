// The DIA row sum and the Jacobi update, shared by K2 (csrc/dia.cu,
// dia_kernel's JACOBI mode, and the other modes' sums) and the one-launch
// multicolour Gauss-Seidel sweep (csrc/mcgs.cu): one source, so nvcc
// contracts both to the same FMAs and the sweep keeps K2's bits.
//
// The sum runs over the diagonals in stored (ascending offset) order and
// skips a neighbour outside [0, n_pad), as K1 does; `load(j)` gives the
// neighbour's value (x[j], or K3's recomputed w dinv_j b_j).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// CH: diagonals whose loads a thread issues before it sums their terms.
// 1 (K1-K3, whose warps are many enough to hide a load's latency) sums as
// it loads; the sweep, whose colour phases leave a few rows a thread and
// few warps an SM, takes CH > 1 so a row costs one round trip to L2, not
// one a diagonal.  The terms are summed in the same order either way.
template <int CH = 1, typename T, typename Load>
__device__ __forceinline__ T dia_row_sum(const T* __restrict__ data,
                                         const int* __restrict__ offsets,
                                         int nd, int64_t n_pad, int64_t i,
                                         const Load& load) {
  T acc = T(0);
  if constexpr (CH == 1) {
    for (int d = 0; d < nd; ++d) {
      const int64_t j = i + offsets[d];
      if (j < 0 || j >= n_pad) continue;
      acc += data[static_cast<int64_t>(d) * n_pad + i] * load(j);
    }
  } else {
    for (int d0 = 0; d0 < nd; d0 += CH) {
      T a[CH], v[CH];
      bool ok[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int d = d0 + c;
        const int64_t j = i + (d < nd ? offsets[d] : 0);
        ok[c] = d < nd && j >= 0 && j < n_pad;
        a[c] = ok[c] ? data[static_cast<int64_t>(d) * n_pad + i] : T(0);
        v[c] = ok[c] ? load(j) : T(0);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (ok[c]) acc += a[c] * v[c];
      }
    }
  }
  return acc;
}

// x_i + w (dinv_i (b_i - acc)).  w is a run-time value in every caller (a
// multicolour step passes 1): a constant 1 would let the compiler drop the
// product and contract x + dinv r into one FMA, another rounding than K2's.
template <typename T>
__device__ __forceinline__ T jacobi_update(T xi, T w, T di, T bi, T acc) {
  return xi + w * (di * (bi - acc));
}

}  // namespace
