"""Prolongation smoothing for the port's host SA setup (a copy of
``pyamg_tpu/aggregation/smooth.py::jacobi_prolongation_smoother`` with
'diagonal' weighting, on a CSR operator).  The other weightings, BSR
operators, Richardson and energy smoothing are ROADMAP.md Queue 1 item
16."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator

from ..amg_core import native
from ..util.linalg import approximate_spectral_radius
from ..util.utils import get_diagonal, scale_rows

__all__ = ["jacobi_prolongation_smoother"]


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
