// Row-run loads and stores shared by the lane-on-the-grid DIA kernels of
// pyamg_tpu_torch (csrc/dia_k.cu, K8-K10, and csrc/halo.cu, K16): a
// thread owns VEC consecutive rows, 4 float32 rows in one 16-byte access
// or 1 row, and reads a neighbour run at a row offset that need not be a
// multiple of 4 from the two aligned 16-byte runs around it.

#pragma once

#include <cuda_runtime.h>
#include <type_traits>

namespace {

// a * b + c rounded once (an explicit FMA)
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// VEC values at p (VEC * sizeof(T) bytes aligned); CS: evict-first
template <typename T, int VEC, bool CS>
__device__ __forceinline__ void ld_vec(T (&v)[VEC], const T* p) {
  if constexpr (VEC == 1) {
    v[0] = CS ? __ldcs(p) : *p;
  } else {
    static_assert(std::is_same<T, float>::value && VEC == 4,
                  "4 float32 values a load");
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 u = CS ? __ldcs(q) : *q;
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
}

// VEC values to p; CS: evict-first
template <typename T, int VEC, bool CS = true>
__device__ __forceinline__ void st_vec(T* p, const T (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (CS) __stcs(p, v[0]);
    else *p = v[0];
  } else {
    const float4 u = make_float4(v[0], v[1], v[2], v[3]);
    if constexpr (CS) __stcs(reinterpret_cast<float4*>(p), u);
    else *reinterpret_cast<float4*>(p) = u;
  }
}

// rows [j, j + VEC) at p, j = i0 + o (i0 a multiple of VEC): with 4 rows
// a thread, one 16-byte load where o is a multiple of 4, else the two
// aligned 16-byte runs around the rows (up to 3 rows past them on either
// side), picked by o's remainder, the same for every thread
template <int R>
__device__ __forceinline__ void pick4(float (&v)[4], const float4& p,
                                      const float4& q) {
  const float a[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = a[t + R];
}

template <typename T, int VEC>
__device__ __forceinline__ void ld_x(T (&v)[VEC], const T* p, int o) {
  if constexpr (VEC == 1) {
    v[0] = *p;
  } else {
    const int r = o & 3;
    if (r == 0) {
      ld_vec<T, VEC, false>(v, p);
      return;
    }
    const float4* q = reinterpret_cast<const float4*>(p - r);
    const float4 lo = q[0], hi = q[1];
    if (r == 1) pick4<1>(v, lo, hi);
    else if (r == 2) pick4<2>(v, lo, hi);
    else pick4<3>(v, lo, hi);
  }
}

}  // namespace
