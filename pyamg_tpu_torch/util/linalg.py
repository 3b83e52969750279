"""Host linear-algebra helpers of the port's SA setup (a copy of
``pyamg_tpu/util/linalg.py::norm``, ``approximate_spectral_radius`` and
``pinv_array``)."""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator

__all__ = ["norm", "approximate_spectral_radius", "pinv_array"]


def norm(x):
    """2-norm of the flattened input, by an inner product."""
    x = np.ravel(x)
    return np.sqrt(np.inner(x.conj(), x).real)


def _as_operator(A):
    if sp.issparse(A) or isinstance(A, LinearOperator):
        return A
    return np.asarray(A)


def approximate_spectral_radius(A, tol=0.01, maxiter=15, restart=5):
    """Spectral radius of the real ``A`` (sparse, dense or a
    LinearOperator) by restarted Arnoldi from a seeded start vector (seed
    3571), with the in-loop Ritz convergence test; cached on a sparse
    ``A`` as ``A._rho``."""
    if not hasattr(A, "shape") or A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    cached = getattr(A, "_rho", None)
    if cached is not None:
        return cached

    n = A.shape[0]
    dtype = np.promote_types(getattr(A, "dtype", np.float64), np.float32)
    if dtype.kind in "iu":
        dtype = np.float64
    Aop = _as_operator(A)

    if n <= 2:
        Ad = Aop.toarray() if sp.issparse(Aop) else np.asarray(Aop)
        ev = scipy.linalg.eigvals(Ad)
        rho = float(np.max(np.abs(ev))) if ev.size else 0.0
        if sp.issparse(A):
            try:
                A._rho = rho
            except AttributeError:
                pass
        return rho

    rng = np.random.default_rng(3571)
    v0 = rng.standard_normal(n).astype(dtype, copy=False)
    rho_old = 0.0
    rho = 0.0
    for _restart in range(max(restart, 1)):
        m = int(min(n, maxiter))
        V = np.zeros((m + 1, n), dtype=dtype)
        H = np.zeros((m + 1, m), dtype=dtype)
        beta = norm(v0)
        if beta == 0:
            v0 = rng.standard_normal(n).astype(dtype, copy=False)
            beta = norm(v0)
        V[0] = v0 / beta
        k_eff = m
        breakdown = False
        converged_inner = False
        for j in range(m):
            w = Aop @ V[j]
            w = np.asarray(w).ravel().astype(dtype, copy=False)
            # modified Gram-Schmidt, blocked, with a second pass
            h = V[: j + 1].conj() @ w
            H[: j + 1, j] = h
            w -= h @ V[: j + 1]
            h2 = V[: j + 1].conj() @ w
            H[: j + 1, j] += h2
            w -= h2 @ V[: j + 1]
            hn = norm(w)
            H[j + 1, j] = hn
            if hn < 1e-12 * max(abs(H).max(), 1.0):
                k_eff = j + 1
                breakdown = True
                break
            V[j + 1] = w / hn
            if j >= 2:
                Hj = H[: j + 1, : j + 1]
                evj, evecj = scipy.linalg.eig(Hj)
                ij = int(np.argmax(np.abs(evj)))
                resid = abs(hn * evecj[-1, ij])
                rho_j = float(np.abs(evj[ij]))
                if rho_j > 0 and resid <= tol * rho_j:
                    k_eff = j + 1
                    converged_inner = True
                    break
        Hk = H[:k_eff, :k_eff]
        evals, evecs = scipy.linalg.eig(Hk)
        idx = int(np.argmax(np.abs(evals)))
        rho = float(np.abs(evals[idx]))
        y = evecs[:, idx]
        v0 = np.real(np.ascontiguousarray((V[:k_eff].T @ y).ravel())
                     ).astype(dtype, copy=False)
        if breakdown or converged_inner or (
                rho_old > 0 and abs(rho - rho_old) <= tol * rho):
            break
        rho_old = rho

    if sp.issparse(A):
        try:
            A._rho = rho
        except AttributeError:
            pass
    return rho


def pinv_array(a, tol=None):
    """Overwrite each matrix of the (n, m, m) stack ``a`` with its
    pseudo-inverse (1 / d, or 0 for d = 0, when m = 1)."""
    a = np.asarray(a)
    if a.ndim != 3:
        raise ValueError("expected (n, m, m) array")
    if a.shape[1] == 1:
        d = a[:, 0, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            a[:, 0, 0] = np.where(d != 0, 1.0 / d, 0.0)
        return a
    try:
        inv = np.linalg.pinv(a, rcond=1e-12 if tol is None else tol)
    except np.linalg.LinAlgError:
        inv = np.stack([np.linalg.pinv(ai) for ai in a])
    a[...] = inv
    return a
