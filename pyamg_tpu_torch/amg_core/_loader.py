"""Build and bind the port's native setup routines (``amg_core.cpp``).

The source is compiled with ``g++`` at the first call of any routine,
never at import, into ``pyamg_tpu_torch/_build/`` (git-ignored), named by
a hash of the source, the flags and the host (``-march=native`` code
runs only on the machine that built it), so an unchanged tree builds once
per machine.  The flags are the JAX package's own (``pyamg_tpu/amg_core/_loader.py``), so
the two builds do the same arithmetic.  A failed build raises: the
port's host setup has no NumPy fallback, and its tests pin the native
hierarchy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np
import scipy.sparse as sp

__all__ = ["native"]

_SRC = Path(__file__).resolve().parent / "amg_core.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
          "-fopenmp")

_lock = threading.Lock()
_native = None


def _build() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    h.update(_SRC.read_bytes())
    out = _BUILD_DIR / f"libamg_core_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"amg_core build failed: {' '.join(cmd)}: "
                           f"{exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"amg_core build failed (exit {proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


class _Native:
    """Typed wrappers over the raw ctypes symbols."""

    def __init__(self, lib):
        self._lib = lib
        i64 = ctypes.POINTER(ctypes.c_int64)
        i32 = ctypes.POINTER(ctypes.c_int32)
        i8 = ctypes.POINTER(ctypes.c_int8)
        f64 = ctypes.POINTER(ctypes.c_double)
        lib.standard_aggregation.restype = ctypes.c_int64
        lib.standard_aggregation.argtypes = [ctypes.c_int64, i64, i64, i64,
                                             i64]
        lib.symmetric_strength.restype = ctypes.c_int64
        lib.symmetric_strength.argtypes = [
            ctypes.c_int64, i64, i64, f64, ctypes.c_double, f64, i8]
        lib.symmetric_strength_i32.restype = ctypes.c_int64
        lib.symmetric_strength_i32.argtypes = [
            ctypes.c_int32, i32, i32, f64, ctypes.c_double, f64, i8]
        for suf, ci, pi in (("i32", ctypes.c_int32, i32),
                            ("i64", ctypes.c_int64, i64)):
            f = getattr(lib, f"spgemm_nnz_{suf}")
            f.restype = None
            f.argtypes = [ci, ci, pi, pi, pi, pi, pi]
            f = getattr(lib, f"spgemm_fill_{suf}")
            f.restype = None
            f.argtypes = [ci, ci, pi, pi, f64, pi, pi, f64, pi, pi, f64]
            f = getattr(lib, f"jacobi_smooth_nnz_{suf}")
            f.restype = None
            f.argtypes = [ci, ci, pi, pi, pi, pi, pi]
            f = getattr(lib, f"jacobi_smooth_fill_{suf}")
            f.restype = None
            f.argtypes = [ci, ci, pi, pi, f64, pi, pi, f64, f64,
                          ctypes.c_double, pi, pi, f64]
        lib.gauss_seidel.restype = None
        lib.gauss_seidel.argtypes = [
            ctypes.c_int64, i64, i64, f64, f64, f64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.rs_cf_splitting.restype = None
        lib.rs_cf_splitting.argtypes = [ctypes.c_int64, i64, i64, i64, i64,
                                        ctypes.c_int64, i64]
        lib.rs_classical_interpolation_pass1.restype = None
        lib.rs_classical_interpolation_pass1.argtypes = [
            ctypes.c_int64, i64, i64, i8, i64, i64]
        lib.rs_classical_interpolation_pass2.restype = None
        lib.rs_classical_interpolation_pass2.argtypes = [
            ctypes.c_int64, i64, i64, f64, i8, i64, i64, ctypes.c_int64,
            i64, i64, f64]

    @staticmethod
    def _i64(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    @staticmethod
    def _ptr_f(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    @staticmethod
    def _ptr(a):
        return a.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32 if a.dtype == np.int32
                           else ctypes.c_int64))

    @staticmethod
    def _csr_idx(A, B=None):
        """Common index dtype and contiguous views for one or two CSRs."""
        idx = np.promote_types(A.indptr.dtype,
                               B.indptr.dtype if B is not None else np.int32)
        if idx not in (np.dtype(np.int32), np.dtype(np.int64)):
            idx = np.dtype(np.int64)

        def cvt(M):
            return (np.ascontiguousarray(M.indptr, dtype=idx),
                    np.ascontiguousarray(M.indices, dtype=idx),
                    np.ascontiguousarray(M.data, dtype=np.float64))
        return idx, cvt

    def _two_pass(self, name, A, B, extra=()):
        idx, cvt = self._csr_idx(A, B)
        suf = "i32" if idx == np.int32 else "i64"
        Ap, Aj, Ax = cvt(A)
        Bp, Bj, Bx = cvt(B)
        n_row, n_col = A.shape[0], B.shape[1]
        cnnz = np.zeros(n_row, dtype=idx)
        getattr(self._lib, f"{name}_nnz_{suf}")(
            n_row, n_col, self._ptr(Ap), self._ptr(Aj), self._ptr(Bp),
            self._ptr(Bj), self._ptr(cnnz))
        Cp = np.zeros(n_row + 1, dtype=np.int64)
        np.cumsum(cnnz, out=Cp[1:])
        nnz = int(Cp[-1])
        if idx == np.int32 and nnz >= np.iinfo(np.int32).max:
            return None
        Cp = Cp.astype(idx, copy=False)
        Cj = np.empty(nnz, dtype=idx)
        Cx = np.empty(nnz, dtype=np.float64)
        getattr(self._lib, f"{name}_fill_{suf}")(
            n_row, n_col, self._ptr(Ap), self._ptr(Aj), self._ptr_f(Ax),
            self._ptr(Bp), self._ptr(Bj), self._ptr_f(Bx), *extra,
            self._ptr(Cp), self._ptr(Cj), self._ptr_f(Cx))
        return sp.csr_matrix((Cx, Cj, Cp), shape=(n_row, n_col))

    def spgemm(self, A, B):
        """C = A @ B (parallel Gustavson, row-sorted output), or None when
        the int32 output nnz could overflow."""
        return self._two_pass("spgemm", A, B)

    def jacobi_smooth(self, A, P, dinv, omega):
        """OUT = P - omega * diag(dinv) @ (A @ P) fused (dinv=None ->
        identity scaling), or None on int32 overflow."""
        dinv_arr = (np.ascontiguousarray(dinv, dtype=np.float64)
                    if dinv is not None else None)   # keep ref alive
        dptr = self._ptr_f(dinv_arr) if dinv_arr is not None else None
        return self._two_pass("jacobi_smooth", A, P,
                              (dptr, ctypes.c_double(float(omega))))

    def symmetric_strength(self, indptr, indices, data, theta):
        """(data_out, keep, n_diag): row-scaled strength values aligned
        with the input nnz, survivor mask, stored-diagonal count."""
        n = len(indptr) - 1
        data = np.ascontiguousarray(data, dtype=np.float64)
        data_out = np.empty(len(data), dtype=np.float64)
        keep = np.zeros(len(data), dtype=np.int8)
        kptr = keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        if (np.asarray(indptr).dtype == np.int32
                and np.asarray(indices).dtype == np.int32):
            indptr = np.ascontiguousarray(indptr, dtype=np.int32)
            indices = np.ascontiguousarray(indices, dtype=np.int32)
            fn = self._lib.symmetric_strength_i32
        else:
            indptr, indices = self._i64(indptr), self._i64(indices)
            fn = self._lib.symmetric_strength
        n_diag = fn(n, self._ptr(indptr), self._ptr(indices),
                    self._ptr_f(data), ctypes.c_double(float(theta)),
                    self._ptr_f(data_out), kptr)
        return data_out, keep, int(n_diag)

    def standard_aggregation(self, indptr, indices):
        n = len(indptr) - 1
        indptr, indices = self._i64(indptr), self._i64(indices)
        x = np.full(n, -1, dtype=np.int64)
        roots = np.empty(n, dtype=np.int64)
        n_agg = self._lib.standard_aggregation(
            n, self._ptr(indptr), self._ptr(indices), self._ptr(x),
            self._ptr(roots))
        return x, roots[:n_agg].copy()

    def gauss_seidel(self, indptr, indices, data, x, b, row_start,
                     row_stop, row_step):
        """One sweep in place on a contiguous float64 x; ``indptr`` and
        ``indices`` int64."""
        n = len(indptr) - 1
        data = np.ascontiguousarray(data, dtype=np.float64)
        if x.dtype != np.float64 or not x.flags.c_contiguous:
            raise TypeError("x must be contiguous float64 for native GS")
        b = np.ascontiguousarray(b, dtype=np.float64)
        self._lib.gauss_seidel(
            n, self._ptr(self._i64(indptr)), self._ptr(self._i64(indices)),
            self._ptr_f(data), self._ptr_f(x), self._ptr_f(b),
            int(row_start), int(row_stop), int(row_step))


    def rs_cf_splitting(self, Sp, Sj, Tp, Tj, second_pass=False):
        """The Ruge-Stuben C/F splitting (int64: 0 F, 1 C) of the strength
        pattern S (row i: the points i strongly depends on) and T = S^T."""
        n = len(Sp) - 1
        Sp, Sj, Tp, Tj = (self._i64(a) for a in (Sp, Sj, Tp, Tj))
        splitting = np.full(n, 2, dtype=np.int64)   # U_NODE
        self._lib.rs_cf_splitting(
            n, self._ptr(Sp), self._ptr(Sj), self._ptr(Tp), self._ptr(Tj),
            1 if second_pass else 0, self._ptr(splitting))
        return splitting

    def rs_classical_interpolation(self, indptr, indices, data, strong,
                                   splitting, cmap, nc, modified=True):
        """Classical interpolation P (n, nc) as CSR, by the two passes
        (row lengths, then values)."""
        n = len(indptr) - 1
        indptr, indices = self._i64(indptr), self._i64(indices)
        data = np.ascontiguousarray(data, dtype=np.float64)
        strong = np.ascontiguousarray(strong, dtype=np.int8)
        splitting, cmap = self._i64(splitting), self._i64(cmap)
        sptr = strong.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        counts = np.zeros(n, dtype=np.int64)
        self._lib.rs_classical_interpolation_pass1(
            n, self._ptr(indptr), self._ptr(indices), sptr,
            self._ptr(splitting), self._ptr(counts))
        Pp = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=Pp[1:])
        Pj = np.zeros(int(Pp[-1]), dtype=np.int64)
        Px = np.zeros(int(Pp[-1]), dtype=np.float64)
        self._lib.rs_classical_interpolation_pass2(
            n, self._ptr(indptr), self._ptr(indices), self._ptr_f(data), sptr,
            self._ptr(splitting), self._ptr(cmap), 1 if modified else 0,
            self._ptr(Pp), self._ptr(Pj), self._ptr_f(Px))
        P = sp.csr_matrix((Px, Pj, Pp), shape=(n, int(nc)))
        P.eliminate_zeros()
        P.sort_indices()
        return P


def native() -> _Native:
    """The native routines, built on first use; raises when the build
    fails."""
    global _native
    with _lock:
        if _native is None:
            _native = _Native(ctypes.CDLL(str(_build())))
        return _native
