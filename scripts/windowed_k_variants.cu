// One-off variants of K12 and K13 (pyamg_tpu_torch/csrc/window.cu) for
// scripts/measure_windowed_k.py, which builds this file with nvcc and
// times it beside the package's kernels; nothing in the package uses it.
//
// The package fixes two choices that these variants leave open at run
// time, so the script can show what each alternative costs:
//
// - K12's lanes per thread `lt` (the package: kK12Lanes = 4);
// - K13's in-warp mapping `group`: `group` lane groups of one column are
//   consecutive threads, then the next column (the package: group 1,
//   consecutive columns of one lane group).
//
// Every variant sums each output in the package's order with the
// package's arithmetic, so it gives the package's bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLaneTile = 64;
constexpr int kThreads = 256;

// a * b + c with the product and the sum each rounded (no FMA), the
// plain version's arithmetic
__device__ __forceinline__ float mul_add_rn(float a, float b, float c) {
  return __fadd_rn(c, __fmul_rn(a, b));
}
__device__ __forceinline__ double mul_add_rn(double a, double b, double c) {
  return __dadd_rn(c, __dmul_rn(a, b));
}

// a * b + c rounded once (an explicit FMA)
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// the row of entry e of the slot-major (n_blocks, k, block) layout
__device__ __forceinline__ int64_t entry_row(int64_t e, int64_t per_block,
                                             int block) {
  return (e / per_block) * block + e % block;
}

// K12: CTA (blockIdx.x, blockIdx.y) = `rows` consecutive rows of one row
// block x lanes [64 * blockIdx.y, +64); shared memory holds the rows' k
// slots, data then idx, slot-major (k * rows each).
template <typename T, int LT>
__global__ void windowed_matmat_k_kernel(const T* __restrict__ data,
                                         const int* __restrict__ idx,
                                         const int* __restrict__ starts,
                                         int k, int block, int w2,
                                         int64_t n_rows, int64_t m,
                                         int lanes, int rows,
                                         const T* __restrict__ x,
                                         T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sdata = reinterpret_cast<T*>(smem);
  int* sidx = reinterpret_cast<int*>(sdata + k * rows);
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t blk = g0 / block;
  const int64_t e0 = blk * k * block + (g0 - blk * block);
  for (int i = threadIdx.x; i < k * rows; i += blockDim.x) {
    const int s = i / rows;
    const int64_t e = e0 + static_cast<int64_t>(s) * block + (i - s * rows);
    sdata[i] = data[e];
    sidx[i] = idx[e];
  }
  __syncthreads();
  const int l0 = blockIdx.y * kLaneTile;
  const int kl = min(kLaneTile, lanes - l0);
  const int n_pairs = rows * ((kl + LT - 1) / LT);
  const int64_t base = static_cast<int64_t>(starts[blk]) * w2;
  // pair p: row p % rows (rows fastest in a warp) and LT lanes from
  // l0 + LT * (p / rows); the LT gathers of a slot are in flight together
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int rr = p % rows;
    const int la = LT * (p / rows);
    const int nl = kl - la;
    const T* xl = x + static_cast<int64_t>(l0 + la) * m + base;
    T acc[LT];
#pragma unroll
    for (int j = 0; j < LT; ++j) acc[j] = T(0);
    for (int i = rr; i < k * rows; i += rows) {
      const T a = sdata[i];
      const int col = sidx[i];
#pragma unroll
      for (int j = 0; j < LT; ++j) {
        if (j < nl) acc[j] = fma_rn(a, xl[j * m + col], acc[j]);
      }
    }
    T* yl = y + static_cast<int64_t>(l0 + la) * n_rows + g0 + rr;
#pragma unroll
    for (int j = 0; j < LT; ++j) {
      if (j < nl) yl[j * n_rows] = acc[j];
    }
  }
}

// K13: CTA (blockIdx.x, blockIdx.y) = tile blockIdx.x of the tile table
// (columns [tiles[t], tiles[t + 1]); an empty tile's CTA exits at once) x
// lanes [64 * blockIdx.y, +64); shared memory holds the tile's live
// entries' values and rows (at most `budget` each) and its column
// pointers (at most max_cols + 1).
template <typename T, int LT>
__global__ void windowed_rmatmat_k_kernel(const T* __restrict__ data,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ colptr,
                                          const int* __restrict__ tiles,
                                          int budget, int k, int block,
                                          int64_t n_rows, int64_t m,
                                          int lanes, int group,
                                          const T* __restrict__ r,
                                          T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sdata = reinterpret_cast<T*>(smem);
  int* srow = reinterpret_cast<int*>(sdata + budget);
  int* sptr = srow + budget;
  const int c0 = tiles[blockIdx.x];
  const int n_cols = tiles[blockIdx.x + 1] - c0;
  if (n_cols == 0) return;
  const int j0 = colptr[c0];
  const int n_ent = colptr[c0 + n_cols] - j0;
  const int l0 = blockIdx.y * kLaneTile;
  const int kl = min(kLaneTile, lanes - l0);
  const int64_t per_block = static_cast<int64_t>(k) * block;
  r += static_cast<int64_t>(l0) * n_rows;
  y += static_cast<int64_t>(l0) * m + c0;
  if (n_ent > budget) {
    // a single column longer than the budget: its lanes over the threads,
    // its entries read from device memory in plan order
    for (int l = threadIdx.x; l < kl; l += blockDim.x) {
      const T* rl = r + l * n_rows;
      T acc = T(0);
      for (int j = j0; j < j0 + n_ent; ++j) {
        const int64_t e = perm[j];
        acc = mul_add_rn(data[e], rl[entry_row(e, per_block, block)], acc);
      }
      y[l * m] = acc;
    }
    return;
  }
  // four entries per thread and pass: their perm loads, then their data
  // loads, in flight together
  for (int i0 = threadIdx.x; i0 < n_ent; i0 += 4 * blockDim.x) {
    int64_t e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      e[u] = i < n_ent ? perm[j0 + i] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n_ent) {
        sdata[i] = data[e[u]];
        srow[i] = static_cast<int>(entry_row(e[u], per_block, block));
      }
    }
  }
  for (int c = threadIdx.x; c <= n_cols; c += blockDim.x) {
    sptr[c] = colptr[c0 + c] - j0;
  }
  __syncthreads();
  // pair p: a column and LT lanes; `group` lane groups of one column are
  // consecutive threads, then the next column, then the next lane groups
  const int n_lg = (kl + LT - 1) / LT;
  const int n_pairs = n_cols * group * ((n_lg + group - 1) / group);
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int q = p / group;
    const int c = q % n_cols;
    const int lg = (q / n_cols) * group + (p - q * group);
    if (lg >= n_lg) continue;
    const int nl = kl - LT * lg;
    const T* rl = r + static_cast<int64_t>(LT * lg) * n_rows;
    T acc[LT];
#pragma unroll
    for (int jj = 0; jj < LT; ++jj) acc[jj] = T(0);
    // the column's entries in plan order; the LT gathers of an entry (and
    // of the next, unrolled) are in flight together
#pragma unroll 2
    for (int j = sptr[c], j1 = sptr[c + 1]; j < j1; ++j) {
      const T d = sdata[j];
      const int g = srow[j];
#pragma unroll
      for (int jj = 0; jj < LT; ++jj) {
        if (jj < nl) acc[jj] = mul_add_rn(d, rl[jj * n_rows + g], acc[jj]);
      }
    }
    T* yl = y + static_cast<int64_t>(LT * lg) * m + c;
#pragma unroll
    for (int jj = 0; jj < LT; ++jj) {
      if (jj < nl) yl[jj * m] = acc[jj];
    }
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's
// attribute raised first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline unsigned int lane_tiles(int lanes) {
  return static_cast<unsigned int>((lanes + kLaneTile - 1) / kLaneTile);
}

// The K-lane launches, one per call: x (lanes, m) in, y (lanes, n_rows)
// out for the forward form, `rows` rows per CTA (a divisor of block);
// r (lanes, n_rows) in, y (lanes, m) out for the transpose, one CTA per
// tile of the n_tiles + 1 boundaries in `tiles`.  `lt` lanes per thread:
// 1, 2, 4, 8 or 16.
template <typename T, int LT>
int launch_matmat_k_lt(const void* data, const void* idx, const void* starts,
                       int k, int block, int w2, long long n_rows,
                       long long m, int lanes, int rows, const void* x,
                       void* y, void* stream) {
  const size_t smem = static_cast<size_t>(k) * rows * (sizeof(T) + sizeof(int));
  cudaError_t err = allow_smem(windowed_matmat_k_kernel<T, LT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(n_rows / rows), lane_tiles(lanes));
  windowed_matmat_k_kernel<T, LT><<<grid, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(starts), k, block, w2, n_rows, m, lanes, rows,
      static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_matmat_k(const void* data, const void* idx, const void* starts,
                    int k, int block, int w2, long long n_rows, long long m,
                    int lanes, int rows, int lt, const void* x, void* y,
                    void* stream) {
  if (lanes < 1 || rows < 1 || block % rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  switch (lt) {
#define PYAMG_K12_LT(L)                                                     \
    case L:                                                                 \
      return launch_matmat_k_lt<T, L>(data, idx, starts, k, block, w2,      \
                                      n_rows, m, lanes, rows, x, y, stream);
    PYAMG_K12_LT(1) PYAMG_K12_LT(2) PYAMG_K12_LT(4) PYAMG_K12_LT(8)
    PYAMG_K12_LT(16)
#undef PYAMG_K12_LT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int LT>
int launch_rmatmat_k_lt(const void* data, const void* perm,
                        const void* colptr, const void* tiles, int n_tiles,
                        int budget, int max_cols, int k, int block,
                        long long n_rows, long long m, int lanes, int group,
                        const void* r, void* y, void* stream) {
  const size_t smem = static_cast<size_t>(budget) * (sizeof(T) + sizeof(int))
                      + static_cast<size_t>(max_cols + 1) * sizeof(int);
  cudaError_t err = allow_smem(windowed_rmatmat_k_kernel<T, LT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(n_tiles), lane_tiles(lanes));
  windowed_rmatmat_k_kernel<T, LT><<<grid, kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(perm),
      static_cast<const int*>(colptr), static_cast<const int*>(tiles),
      budget, k, block, n_rows, m, lanes, group,
      static_cast<const T*>(r), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rmatmat_k(const void* data, const void* perm, const void* colptr,
                     const void* tiles, int n_tiles, int budget, int max_cols,
                     int k, int block, long long n_rows, long long m,
                     int lanes, int group, int lt, const void* r, void* y,
                     void* stream) {
  if (lanes < 1 || group < 1 || budget < 1 || max_cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  switch (lt) {
#define PYAMG_K13_LT(L)                                                     \
    case L:                                                                 \
      return launch_rmatmat_k_lt<T, L>(data, perm, colptr, tiles, n_tiles,  \
                                       budget, max_cols, k, block, n_rows,  \
                                       m, lanes, group, r, y, stream);
    PYAMG_K13_LT(1) PYAMG_K13_LT(2) PYAMG_K13_LT(4) PYAMG_K13_LT(8)
    PYAMG_K13_LT(16)
#undef PYAMG_K13_LT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// data, idx, starts, k, block, w2, n_rows, m, lanes, rows, lt, x, y,
// stream
int sweep_windowed_matmat_k_f32(const void* data, const void* idx,
                                const void* starts, int k, int block, int w2,
                                long long n_rows, long long m, int lanes,
                                int rows, int lt, const void* x, void* y,
                                void* stream) {
  return launch_matmat_k<float>(data, idx, starts, k, block, w2, n_rows, m,
                                lanes, rows, lt, x, y, stream);
}

int sweep_windowed_matmat_k_f64(const void* data, const void* idx,
                                const void* starts, int k, int block, int w2,
                                long long n_rows, long long m, int lanes,
                                int rows, int lt, const void* x, void* y,
                                void* stream) {
  return launch_matmat_k<double>(data, idx, starts, k, block, w2, n_rows, m,
                                 lanes, rows, lt, x, y, stream);
}

// data, perm, colptr, tiles, n_tiles, budget, max_cols, k, block, n_rows,
// m, lanes, group, lt, r, y, stream
int sweep_windowed_rmatmat_k_f32(const void* data, const void* perm,
                                 const void* colptr, const void* tiles,
                                 int n_tiles, int budget, int max_cols, int k,
                                 int block, long long n_rows, long long m,
                                 int lanes, int group, int lt, const void* r,
                                 void* y, void* stream) {
  return launch_rmatmat_k<float>(data, perm, colptr, tiles, n_tiles, budget,
                                 max_cols, k, block, n_rows, m, lanes, group,
                                 lt, r, y, stream);
}

int sweep_windowed_rmatmat_k_f64(const void* data, const void* perm,
                                 const void* colptr, const void* tiles,
                                 int n_tiles, int budget, int max_cols, int k,
                                 int block, long long n_rows, long long m,
                                 int lanes, int group, int lt, const void* r,
                                 void* y, void* stream) {
  return launch_rmatmat_k<double>(data, perm, colptr, tiles, n_tiles, budget,
                                  max_cols, k, block, n_rows, m, lanes, group,
                                  lt, r, y, stream);
}

}  // extern "C"
