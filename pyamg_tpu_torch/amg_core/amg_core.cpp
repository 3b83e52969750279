// Native setup-phase routines of pyamg_tpu_torch's host SA setup.
//
// A copy of the five routines of pyamg_tpu/amg_core/amg_core.cpp that the
// smoothed-aggregation setup of BASELINE config 1 calls: the parallel
// SpGEMM (Galerkin product), the fused prolongation-smoothing step, the
// symmetric strength of connection, standard aggregation and the
// sequential Gauss-Seidel sweep (candidate improvement).  The port keeps
// its own copy so that it imports nothing of the JAX package; the
// arithmetic is the reference's, line for line, so the two setups give
// the same hierarchy.
//
// Flat extern "C" ABI over raw CSR arrays, bound with ctypes
// (pyamg_tpu_torch/amg_core/_loader.py).  Index type int32 or int64;
// values are double.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Parallel SpGEMM (Gustavson two-pass, OpenMP over rows), row-sorted
// output.
template <typename I>
void spgemm_nnz_t(I n_row, I n_col,
                  const I* Ap, const I* Aj,
                  const I* Bp, const I* Bj, I* Cnnz) {
#pragma omp parallel
  {
    std::vector<I> mark(n_col, -1);
#pragma omp for schedule(dynamic, 1024)
    for (int64_t i = 0; i < (int64_t)n_row; ++i) {
      I count = 0;
      for (I ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
        const I j = Aj[ka];
        for (I kb = Bp[j]; kb < Bp[j + 1]; ++kb) {
          const I c = Bj[kb];
          if (mark[c] != (I)i) { mark[c] = (I)i; ++count; }
        }
      }
      Cnnz[i] = count;
    }
  }
}

template <typename I>
void spgemm_fill_t(I n_row, I n_col,
                   const I* Ap, const I* Aj, const double* Ax,
                   const I* Bp, const I* Bj, const double* Bx,
                   const I* Cp, I* Cj, double* Cx) {
#pragma omp parallel
  {
    std::vector<I> mark(n_col, -1);
    std::vector<double> acc(n_col, 0.0);
#pragma omp for schedule(dynamic, 1024)
    for (int64_t i = 0; i < (int64_t)n_row; ++i) {
      I len = 0;
      I* cols = Cj + Cp[i];
      for (I ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
        const I j = Aj[ka];
        const double a = Ax[ka];
        for (I kb = Bp[j]; kb < Bp[j + 1]; ++kb) {
          const I c = Bj[kb];
          if (mark[c] != (I)i) {
            mark[c] = (I)i;
            acc[c] = a * Bx[kb];
            cols[len++] = c;
          } else {
            acc[c] += a * Bx[kb];
          }
        }
      }
      std::sort(cols, cols + len);
      double* vals = Cx + Cp[i];
      for (I k = 0; k < len; ++k) vals[k] = acc[cols[k]];
    }
  }
}

// Fused prolongation-smoothing step OUT = P - w * diag(dinv) @ (A @ P);
// the pattern is the union of P's and (A @ P)'s rows.
template <typename I>
void jacobi_smooth_nnz_t(I n_row, I n_col,
                         const I* Ap, const I* Aj,
                         const I* Pp, const I* Pj, I* Cnnz) {
#pragma omp parallel
  {
    std::vector<I> mark(n_col, -1);
#pragma omp for schedule(dynamic, 1024)
    for (int64_t i = 0; i < (int64_t)n_row; ++i) {
      I count = 0;
      for (I kp = Pp[i]; kp < Pp[i + 1]; ++kp) {
        const I c = Pj[kp];
        if (mark[c] != (I)i) { mark[c] = (I)i; ++count; }
      }
      for (I ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
        const I j = Aj[ka];
        for (I kb = Pp[j]; kb < Pp[j + 1]; ++kb) {
          const I c = Pj[kb];
          if (mark[c] != (I)i) { mark[c] = (I)i; ++count; }
        }
      }
      Cnnz[i] = count;
    }
  }
}

template <typename I>
void jacobi_smooth_fill_t(I n_row, I n_col,
                          const I* Ap, const I* Aj, const double* Ax,
                          const I* Pp, const I* Pj, const double* Px,
                          const double* dinv, double omega,
                          const I* Cp, I* Cj, double* Cx) {
#pragma omp parallel
  {
    std::vector<I> mark(n_col, -1);
    std::vector<double> acc(n_col, 0.0);
#pragma omp for schedule(dynamic, 1024)
    for (int64_t i = 0; i < (int64_t)n_row; ++i) {
      I len = 0;
      I* cols = Cj + Cp[i];
      for (I kp = Pp[i]; kp < Pp[i + 1]; ++kp) {
        const I c = Pj[kp];
        mark[c] = (I)i;
        acc[c] = Px[kp];
        cols[len++] = c;
      }
      const double s = -omega * (dinv ? dinv[i] : 1.0);
      for (I ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
        const I j = Aj[ka];
        const double a = s * Ax[ka];
        for (I kb = Pp[j]; kb < Pp[j + 1]; ++kb) {
          const I c = Pj[kb];
          if (mark[c] != (I)i) {
            mark[c] = (I)i;
            acc[c] = a * Px[kb];
            cols[len++] = c;
          } else {
            acc[c] += a * Px[kb];
          }
        }
      }
      std::sort(cols, cols + len);
      double* vals = Cx + Cp[i];
      for (I k = 0; k < len; ++k) vals[k] = acc[cols[k]];
    }
  }
}

// Symmetric strength |A_ij| >= theta * sqrt(|A_ii| |A_jj|), one pass
// (OpenMP over rows).  Writes |A_ij| row-scaled by the largest kept
// off-diagonal magnitude (theta > 0) or by the largest overall magnitude
// (theta == 0, where the full pattern survives) into data_out, sets
// stored diagonal entries to 1, and marks surviving entries in keep.
// Returns the number of rows with a stored diagonal entry.
template <typename I>
int64_t symmetric_strength_t(I n, const I* indptr, const I* indices,
                             const double* data, double theta,
                             double* data_out, int8_t* keep) {
  std::vector<double> d(n, 0.0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < (int64_t)n; ++i)
    for (I k = indptr[i]; k < indptr[i + 1]; ++k)
      if (indices[k] == (I)i) d[i] = std::fabs(data[k]);
  int64_t n_diag = 0;
#pragma omp parallel for schedule(static) reduction(+ : n_diag)
  for (int64_t i = 0; i < (int64_t)n; ++i) {
    const I k0 = indptr[i], k1 = indptr[i + 1];
    double rowmax = 0.0;
    bool has_diag = false;
    if (theta == 0.0) {
      for (I k = k0; k < k1; ++k) {
        const double a = std::fabs(data[k]);
        keep[k] = 1;
        data_out[k] = a;
        if (a > rowmax) rowmax = a;
        if (indices[k] == (I)i) has_diag = true;
      }
    } else {
      for (I k = k0; k < k1; ++k) {
        const I j = indices[k];
        if (j == (I)i) {
          keep[k] = 1;
          data_out[k] = 0.0;
          has_diag = true;
        } else {
          const double a = std::fabs(data[k]);
          const bool kp = a >= theta * std::sqrt(d[i] * d[j]);
          keep[k] = kp ? 1 : 0;
          data_out[k] = kp ? a : 0.0;
          if (kp && a > rowmax) rowmax = a;
        }
      }
    }
    const double s = rowmax != 0.0 ? 1.0 / rowmax : 0.0;
    for (I k = k0; k < k1; ++k)
      if (keep[k]) data_out[k] = indices[k] == (I)i ? 1.0 : data_out[k] * s;
    if (has_diag) ++n_diag;
  }
  return n_diag;
}

}  // namespace

extern "C" {

void spgemm_nnz_i32(int32_t n_row, int32_t n_col, const int32_t* Ap,
                    const int32_t* Aj, const int32_t* Bp,
                    const int32_t* Bj, int32_t* Cnnz) {
  spgemm_nnz_t<int32_t>(n_row, n_col, Ap, Aj, Bp, Bj, Cnnz);
}
void spgemm_nnz_i64(int64_t n_row, int64_t n_col, const int64_t* Ap,
                    const int64_t* Aj, const int64_t* Bp,
                    const int64_t* Bj, int64_t* Cnnz) {
  spgemm_nnz_t<int64_t>(n_row, n_col, Ap, Aj, Bp, Bj, Cnnz);
}
void spgemm_fill_i32(int32_t n_row, int32_t n_col, const int32_t* Ap,
                     const int32_t* Aj, const double* Ax,
                     const int32_t* Bp, const int32_t* Bj,
                     const double* Bx, const int32_t* Cp, int32_t* Cj,
                     double* Cx) {
  spgemm_fill_t<int32_t>(n_row, n_col, Ap, Aj, Ax, Bp, Bj, Bx, Cp, Cj, Cx);
}
void spgemm_fill_i64(int64_t n_row, int64_t n_col, const int64_t* Ap,
                     const int64_t* Aj, const double* Ax,
                     const int64_t* Bp, const int64_t* Bj,
                     const double* Bx, const int64_t* Cp, int64_t* Cj,
                     double* Cx) {
  spgemm_fill_t<int64_t>(n_row, n_col, Ap, Aj, Ax, Bp, Bj, Bx, Cp, Cj, Cx);
}
void jacobi_smooth_nnz_i32(int32_t n_row, int32_t n_col, const int32_t* Ap,
                           const int32_t* Aj, const int32_t* Pp,
                           const int32_t* Pj, int32_t* Cnnz) {
  jacobi_smooth_nnz_t<int32_t>(n_row, n_col, Ap, Aj, Pp, Pj, Cnnz);
}
void jacobi_smooth_nnz_i64(int64_t n_row, int64_t n_col, const int64_t* Ap,
                           const int64_t* Aj, const int64_t* Pp,
                           const int64_t* Pj, int64_t* Cnnz) {
  jacobi_smooth_nnz_t<int64_t>(n_row, n_col, Ap, Aj, Pp, Pj, Cnnz);
}
void jacobi_smooth_fill_i32(int32_t n_row, int32_t n_col,
                            const int32_t* Ap, const int32_t* Aj,
                            const double* Ax, const int32_t* Pp,
                            const int32_t* Pj, const double* Px,
                            const double* dinv, double omega,
                            const int32_t* Cp, int32_t* Cj, double* Cx) {
  jacobi_smooth_fill_t<int32_t>(n_row, n_col, Ap, Aj, Ax, Pp, Pj, Px,
                                dinv, omega, Cp, Cj, Cx);
}
void jacobi_smooth_fill_i64(int64_t n_row, int64_t n_col,
                            const int64_t* Ap, const int64_t* Aj,
                            const double* Ax, const int64_t* Pp,
                            const int64_t* Pj, const double* Px,
                            const double* dinv, double omega,
                            const int64_t* Cp, int64_t* Cj, double* Cx) {
  jacobi_smooth_fill_t<int64_t>(n_row, n_col, Ap, Aj, Ax, Pp, Pj, Px,
                                dinv, omega, Cp, Cj, Cx);
}

int64_t symmetric_strength(int64_t n, const int64_t* indptr,
                           const int64_t* indices, const double* data,
                           double theta, double* data_out, int8_t* keep) {
  return symmetric_strength_t<int64_t>(n, indptr, indices, data, theta,
                                       data_out, keep);
}

int64_t symmetric_strength_i32(int32_t n, const int32_t* indptr,
                               const int32_t* indices, const double* data,
                               double theta, double* data_out,
                               int8_t* keep) {
  return symmetric_strength_t<int32_t>(n, indptr, indices, data, theta,
                                       data_out, keep);
}

// Standard (VMB) two-pass greedy aggregation plus leftovers.
// x[i] (out, -1 on entry): aggregate id; roots (out): root node per
// aggregate.  Returns the number of aggregates.
int64_t standard_aggregation(int64_t n, const int64_t* indptr,
                             const int64_t* indices, int64_t* x,
                             int64_t* roots) {
  std::vector<int8_t> from_pass1(n, 0);
  int64_t n_agg = 0;
  // pass 1: node i and all strong neighbours unaggregated -> new aggregate
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != -1) continue;
    bool free_nbhd = true;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j != i && x[j] != -1) { free_nbhd = false; break; }
    }
    if (!free_nbhd) continue;
    roots[n_agg] = i;
    x[i] = n_agg;
    from_pass1[i] = 1;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j != i) { x[j] = n_agg; from_pass1[j] = 1; }
    }
    ++n_agg;
  }
  // pass 2: join a neighbouring pass-1 aggregate (no cascading)
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != -1) continue;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j != i && x[j] != -1 && from_pass1[j]) {
        x[i] = -x[j] - 2;  // mark as pass-2 (decoded below)
        break;
      }
    }
  }
  for (int64_t i = 0; i < n; ++i)
    if (x[i] < -1) x[i] = -x[i] - 2;
  // pass 3: leftovers seed new aggregates with unaggregated neighbours
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != -1) continue;
    roots[n_agg] = i;
    x[i] = n_agg;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j != i && x[j] == -1) x[j] = n_agg;
    }
    ++n_agg;
  }
  return n_agg;
}

// Plain Gauss-Seidel sweep over [row_start, row_stop) with step
// row_step (+1 forward, -1 backward).
void gauss_seidel(int64_t n, const int64_t* indptr, const int64_t* indices,
                  const double* data, double* x, const double* b,
                  int64_t row_start, int64_t row_stop, int64_t row_step) {
  (void)n;
  for (int64_t i = row_start; i != row_stop; i += row_step) {
    double diag = 0.0, rsum = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j == i) diag += data[k];
      else rsum += data[k] * x[j];
    }
    if (diag != 0.0) x[i] = (b[i] - rsum) / diag;
  }
}

}  // extern "C"
