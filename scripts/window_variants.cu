// One-off variant of K6 and K14 (pyamg_tpu_torch/csrc/window.cu) for
// scripts/measure_k6_k14.py, which builds this file with nvcc and times it
// beside the package's kernels; nothing in the package uses it.
//
// - The package's gather kernel with each row block's window of x (2 * w2
//   values) staged in shared memory first (windowed_gather_staged_kernel):
//   a CTA copies the window in 16-byte pieces, waits at one barrier, and
//   gathers from shared memory instead of through L1.  The launch takes
//   the package's plan (vec, threads, CTAs and items a row block) and
//   2 * w2 * sizeof(T) bytes of shared memory.
//
// The variant sums each row's slots in the package's order with its
// arithmetic, so it gives the package's bits.

#include "../pyamg_tpu_torch/csrc/window.cu"

namespace {

template <typename T, int V, int MODE>
__global__ void windowed_gather_staged_kernel(
    const T* __restrict__ data, const int* __restrict__ idx,
    const int* __restrict__ starts, int k, int block, int w2,
    int ctas_per_block, int items_per_cta, const T* __restrict__ x,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem);
  const int b = blockIdx.x / ctas_per_block;
  const int i0 = (blockIdx.x - b * ctas_per_block) * items_per_cta;
  const int i1 = min(i0 + items_per_cta,
                     (MODE == kGatherSum ? block : k * block) / V);
  const T* xw = x + static_cast<int64_t>(starts[b]) * w2;
  for (int j = threadIdx.x * V; j < 2 * w2; j += blockDim.x * V) {
    store_pack<V>(sx + j, load_pack<V>(xw + j));
  }
  __syncthreads();
  const int eb = b * k * block;
  if constexpr (MODE == kGatherSum) {
    for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
      const int r = i * V;
      T acc[V];
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = T(0);
#pragma unroll 4
      for (int s = 0; s < k; ++s) {
        const int e = eb + s * block + r;
        const Pack<T, V> d = load_pack<V>(data + e);
        const Pack<int, V> c = load_pack<V>(idx + e);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          acc[u] = fma_rn(d.v[u], sx[c.v[u]], acc[u]);
        }
      }
      Pack<T, V> y;
#pragma unroll
      for (int u = 0; u < V; ++u) y.v[u] = acc[u];
      store_pack<V>(out + b * block + r, y);
    }
  } else {
    for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
      const int e = eb + i * V;
      const Pack<int, V> c = load_pack<V>(idx + e);
      Pack<T, V> o;
#pragma unroll
      for (int u = 0; u < V; ++u) o.v[u] = sx[c.v[u]];
      store_pack<V>(out + e, o);
    }
  }
}

template <typename T, int V, int MODE>
int launch_staged(const void* data, const void* idx, const void* starts,
                  int k, int block, int w2, int n_blocks, int threads,
                  int ctas_per_block, int items_per_cta, const void* x,
                  void* out, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(w2) * sizeof(T);
  cudaError_t err = allow_smem(windowed_gather_staged_kernel<T, V, MODE>,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  windowed_gather_staged_kernel<T, V, MODE><<<
      static_cast<unsigned int>(n_blocks) * ctas_per_block, threads, smem,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(starts), k, block, w2, ctas_per_block,
      items_per_cta, static_cast<const T*>(x), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int staged(int mode, const void* data, const void* idx, const void* starts,
           int k, int block, int w2, int n_blocks, int vec, int threads,
           int ctas_per_block, int items_per_cta, const void* x, void* out,
           void* stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if ((vec != 1 && vec != kVec) || (2 * w2) % vec != 0
      || 2 * static_cast<size_t>(w2) * sizeof(T) > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define PYAMG_STAGED(V, M)                                                 \
  return launch_staged<T, V, M>(data, idx, starts, k, block, w2, n_blocks, \
                                threads, ctas_per_block, items_per_cta, x, \
                                out, stream)
  if (mode == kGatherSum) {
    if (vec == 1) PYAMG_STAGED(1, kGatherSum);
    PYAMG_STAGED(kVec, kGatherSum);
  }
  if (vec == 1) PYAMG_STAGED(1, kGatherSelect);
  PYAMG_STAGED(kVec, kGatherSelect);
#undef PYAMG_STAGED
}

}  // namespace

extern "C" {

// the package's gather arguments: mode, data, idx, starts, k, block, w2,
// n_blocks, vec, threads, ctas_per_block, items_per_cta, x, out, stream
int variant_gather_staged_f32(int mode, const void* data, const void* idx,
                              const void* starts, int k, int block, int w2,
                              int n_blocks, int vec, int threads,
                              int ctas_per_block, int items_per_cta,
                              const void* x, void* out, void* stream) {
  return staged<float>(mode, data, idx, starts, k, block, w2, n_blocks, vec,
                       threads, ctas_per_block, items_per_cta, x, out,
                       stream);
}

int variant_gather_staged_f64(int mode, const void* data, const void* idx,
                              const void* starts, int k, int block, int w2,
                              int n_blocks, int vec, int threads,
                              int ctas_per_block, int items_per_cta,
                              const void* x, void* out, void* stream) {
  return staged<double>(mode, data, idx, starts, k, block, w2, n_blocks, vec,
                        threads, ctas_per_block, items_per_cta, x, out,
                        stream);
}

}  // extern "C"
