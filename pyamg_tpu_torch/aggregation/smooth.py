"""Prolongation smoothing for the port's host setups (a copy of
``pyamg_tpu/aggregation/smooth.py``): ``jacobi_prolongation_smoother``
with 'diagonal' weighting on a CSR operator (SA), and
``energy_prolongation_smoother`` with ``krylov='cg'`` and 'local' or
'diagonal' weighting (rootnode), with ``satisfy_constraints``.  The other
weightings and Krylov methods, the filters and Richardson smoothing are
ROADMAP.md Queue 1 item 16."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator

from ..amg_core import native
from ..util.linalg import approximate_spectral_radius
from ..util.utils import (compute_BtBinv, get_diagonal, scale_rows,
                          unamal)

__all__ = ["jacobi_prolongation_smoother", "energy_prolongation_smoother",
           "satisfy_constraints"]


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported to pyamg_tpu_torch "
                               "yet (ROADMAP.md Queue 1 item 16)")


def _dinv_scaled(S, omega):
    """(omega / rho(D^-1 S), dinv) for weighted-Jacobi smoothing of S.
    rho is cached on S as ``_rho_D_inv``, where the smoother setup
    (:func:`~pyamg_tpu_torch.relaxation.smoothing.rho_D_inv_A`) finds it;
    it is only needed to ~1 % (tol 0.01), so the Arnoldi runs in f32."""
    S_csr = sp.csr_matrix(S)
    dinv = get_diagonal(S_csr, inv=True)
    rho = getattr(S, "_rho_D_inv", None)
    if rho is None:
        S32 = S_csr.astype(np.float32)
        dinv32 = dinv.astype(np.float32)
        op = LinearOperator(S_csr.shape, matvec=lambda v: dinv32 * (S32 @ v),
                            dtype=np.float32)
        rho = float(approximate_spectral_radius(op))
        try:
            S._rho_D_inv = rho
        except AttributeError:
            pass
    return omega / max(rho, 1e-300), dinv


def _jacobi_smooth_step(S_csr, P, dinv, omega_eff):
    """One P <- P - omega * diag(dinv) @ (S @ P) step: the fused native
    kernel, or scipy when int32 indices would overflow."""
    out = native().jacobi_smooth(S_csr, P, dinv, omega_eff)
    if out is not None:
        return out
    SP = scale_rows(sp.csr_matrix(S_csr @ P), dinv, copy=False)
    return sp.csr_matrix(P - omega_eff * SP)


def jacobi_prolongation_smoother(S, T, C, B, omega=4.0 / 3.0, degree=1):
    """P = (I - omega / rho(D^-1 S) * D^-1 S)^degree @ T, with the
    reference's 'diagonal' weighting.

    Records on P the recipe ``_sa_factor`` = {dinv, omega (scaled), T,
    degree}: the device compile (``engine/hierarchy.py``) applies P as
    the factors S_sm^degree T instead of the materialized P.  ``C`` and
    ``B`` are accepted for the reference's signature and unused."""
    del C, B
    omega_eff, dinv = _dinv_scaled(S, omega)
    S_csr = sp.csr_matrix(S)
    P = sp.csr_matrix(T)
    for _ in range(int(degree)):
        P = _jacobi_smooth_step(S_csr, P, dinv, omega_eff)
    P.eliminate_zeros()
    P._sa_factor = {"dinv": dinv, "omega": omega_eff,
                    "T": sp.csr_matrix(T), "degree": int(degree)}
    return P


def satisfy_constraints(U, B, BtBinv):
    """U with each row's component along span(B[J]) removed (J the row's
    pattern, BtBinv its (B_J^H B_J)^+), so that U B = 0 row by row: the
    energy update keeps P B_c = B."""
    U = sp.csr_matrix(U)
    U.sort_indices()
    n = U.shape[0]
    lens = np.diff(U.indptr)
    if U.nnz == 0:
        return U
    maxlen = int(lens.max())
    mask = np.arange(maxlen)[None, :] < lens[:, None]
    pad_idx = np.zeros((n, maxlen), dtype=np.int64)
    pad_val = np.zeros((n, maxlen), dtype=U.dtype)
    pad_idx[mask] = U.indices
    pad_val[mask] = U.data
    Bn = np.where(mask[:, :, None], B[pad_idx], 0)
    UB = np.einsum("nm,nmk->nk", pad_val, Bn)
    coef = np.einsum("nk,nkl->nl", UB, BtBinv)
    corr = np.einsum("nl,nml->nm", coef, Bn.conj())
    pad_val = pad_val - np.where(mask, corr, 0)
    U.data = pad_val[mask]
    return U


def _masked_spgemm(A, Bmat, pattern):
    """(A @ Bmat) on the pattern of ``pattern``, every slot of the pattern
    stored (explicit zeros kept, so P's pattern, and with it its compiled
    form, is the reference's)."""
    full = sp.csr_matrix(A @ Bmat)
    mask = pattern.copy()
    mask.data = np.ones_like(mask.data)
    out = sp.csr_matrix(full.multiply(mask))
    out = out + 0.0 * mask
    out = sp.csr_matrix(out)
    out.sort_indices()
    return out


def _fro_inner(X, Y):
    """Frobenius inner product of two sparse matrices."""
    Xc = sp.csr_matrix(X)
    Yc = sp.csr_matrix(Y)
    return float(np.real(Xc.multiply(Yc.conjugate()).sum()))


def energy_prolongation_smoother(A, T, Atilde, B, Bf, Cpt_params,
                                 krylov="cg", maxiter=4, tol=1e-8, degree=1,
                                 weighting="local", prefilter=None,
                                 postfilter=None):
    """P minimising the A-energy of its columns on the pattern Atilde^degree
    T (a node-level Atilde expanded to A's dofs) under P B = Bf, by
    ``maxiter`` steps of diagonally preconditioned CG on all columns at
    once; with rootnode's ``Cpt_params`` = (True, params) the root rows
    stay the identity."""
    if krylov != "cg":
        raise _not_ported(f"energy smoothing with krylov={krylov!r}")
    if weighting not in ("local", "diagonal"):
        raise _not_ported(f"energy smoothing with weighting={weighting!r}")
    if prefilter or postfilter:
        raise _not_ported("energy smoothing with a pre- or postfilter")
    del Bf   # only the postfilters read it
    A = sp.csr_matrix(A) if A.format != "bsr" else A
    Acsr = sp.csr_matrix(A)
    T = sp.csr_matrix(T)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B.reshape(-1, 1)

    pattern = sp.csr_matrix(T)
    Ap = sp.csr_matrix(Atilde)
    if Ap.shape[0] != Acsr.shape[0]:
        bs = Acsr.shape[0] // Ap.shape[0]
        Ap = sp.csr_matrix(unamal(Ap, bs, bs))
    for _ in range(int(degree)):
        pattern = sp.csr_matrix(Ap @ pattern)
    pattern.data = np.ones_like(pattern.data)
    pattern.sort_indices()

    rootnode = Cpt_params is not None and Cpt_params[0]
    if rootnode:
        I_F = Cpt_params[1]["I_F"]
        P_I = Cpt_params[1]["P_I"]

    if weighting == "diagonal":
        dinv = get_diagonal(Acsr, inv=True)
    else:
        d = np.asarray(np.abs(Acsr).sum(axis=1)).ravel()
        with np.errstate(divide="ignore", invalid="ignore"):
            dinv = np.where(d != 0, 1.0 / d, 0.0)

    BtBinv = compute_BtBinv(B, pattern)
    P = T.copy()

    def project(U):
        U = satisfy_constraints(U, B, BtBinv)
        if rootnode:
            U = sp.csr_matrix(I_F @ U)
        return U

    R = _masked_spgemm(Acsr, P, pattern)
    R = sp.csr_matrix(-R)
    R = project(R)
    oldsum = 0.0
    Pk = None
    for it in range(int(maxiter)):
        Z = scale_rows(R, dinv, copy=True)
        newsum = _fro_inner(R, Z)
        if newsum <= tol * tol or abs(newsum) < 1e-300:
            break
        if it == 0:
            Pk = Z
        else:
            Pk = sp.csr_matrix(Z + (newsum / oldsum) * Pk)
        oldsum = newsum
        APk = _masked_spgemm(Acsr, Pk, pattern)
        APk = project(APk)
        denom = _fro_inner(Pk, APk)
        if abs(denom) < 1e-300:
            break
        alpha = newsum / denom
        P = sp.csr_matrix(P + alpha * Pk)
        R = sp.csr_matrix(R - alpha * APk)
    P = sp.csr_matrix(P)

    if rootnode:
        P = sp.csr_matrix(I_F @ P + P_I)
    P.eliminate_zeros()
    P.sort_indices()
    return P
