"""Ruge-Stuben setup on the host (a copy of
``pyamg_tpu/classical/classical.py::ruge_stuben_solver`` for the options
BASELINE config 3 runs).

Per level: classical strength (theta 0.25), the RS C/F splitting (native,
with the reference's guard against a degenerate splitting), classical
interpolation (native), R = P^T and the native Galerkin product: the
reference's arithmetic step for step, so the port's hierarchy equals the
JAX package's level for level.  Each level but the coarsest records its
``splitting``.  Other splittings and interpolations raise
``NotImplementedError`` (ROADMAP.md Queue 1 item 16), as do a complex
operator and the reference's extra keyword options.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from ..aggregation.aggregation import _not_ported, _strength_measure
from ..multilevel import MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..util.utils import (asfptype, galerkin_product,
                          levelize_strength_or_aggregation)
from .interpolate import classical_interpolation
from .split import C_NODE, F_NODE, RS

__all__ = ["ruge_stuben_solver"]

DEFAULT_SMOOTHER = ("gauss_seidel", {"sweep": "symmetric"})


def ruge_stuben_solver(A, strength=("classical", {"theta": 0.25}),
                       CF=("RS", {"second_pass": False}),
                       interpolation="classical",
                       presmoother=DEFAULT_SMOOTHER,
                       postsmoother=DEFAULT_SMOOTHER, max_levels=30,
                       max_coarse=20, keep=False, **kwargs):
    """A classical Ruge-Stuben hierarchy (:class:`MultilevelSolver`) of
    the real operator ``A`` with the reference's signature and defaults
    (a BSR operator is converted to CSR, as there).  The smoothers default
    to symmetric Gauss-Seidel, which the device compile makes multicolour
    Gauss-Seidel (Chebyshev on a level with more than 16 colours)."""
    if kwargs:
        raise _not_ported(f"the setup options {sorted(kwargs)}")
    if not sp.issparse(A) or A.format not in ("csr", "bsr"):
        try:
            A = sp.csr_matrix(A)
            warnings.warn("implicit conversion of A to CSR",
                          sp.SparseEfficiencyWarning)
        except Exception as exc:
            raise TypeError("argument A must be convertible to "
                            "csr_matrix") from exc
    if A.format == "bsr":
        A = A.tocsr()
        warnings.warn("converting BSR to CSR for classical AMG")
    A = asfptype(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    if np.iscomplexobj(A.data):
        raise _not_ported("the setup of a complex operator")

    cf_name, cf_kwargs = CF if isinstance(CF, tuple) else (CF, {})
    if cf_name != "RS":
        raise _not_ported(f"the C/F splitting {cf_name!r}")
    interp_name, interp_kwargs = ((interpolation, {})
                                  if isinstance(interpolation, str)
                                  else interpolation)
    if interp_name != "classical":
        raise _not_ported(f"the interpolation {interp_name!r}")

    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)

    levels = [MultilevelSolver.Level()]
    levels[-1].A = A
    while len(levels) < max_levels and levels[-1].A.shape[0] > max_coarse:
        n_before = levels[-1].A.shape[0]
        _extend_hierarchy(levels, strength, dict(cf_kwargs),
                          dict(interp_kwargs), keep)
        if levels[-1].A.shape[0] >= n_before:
            levels.pop()
            break

    ml = MultilevelSolver(levels)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels, strength, cf_kwargs, interp_kwargs, keep):
    """One coarsening step: strength, splitting, interpolation, R = P^T,
    the Galerkin product."""
    A = levels[-1].A
    lvl_i = len(levels) - 1

    S = _strength_measure(A, strength[min(lvl_i, len(strength) - 1)],
                          ("classical",))
    splitting = RS(S, **cf_kwargs)
    if (splitting == C_NODE).all() or (splitting == F_NODE).all():
        # a degenerate splitting: every other point becomes C
        splitting = np.zeros(A.shape[0], dtype=np.int32)
        splitting[::2] = C_NODE

    P = classical_interpolation(A, S, splitting, **interp_kwargs)
    levels[-1].R_is_PT = True
    levels[-1].P = P
    levels[-1].R = P.T.tocsr()
    levels[-1].splitting = splitting
    if keep:
        levels[-1].C = S

    lvl = MultilevelSolver.Level()
    lvl.A = galerkin_product(levels[-1].R, A, P)
    levels.append(lvl)
