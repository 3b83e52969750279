"""Smoothed-aggregation setup on the host (a copy of
``pyamg_tpu/aggregation/aggregation.py::smoothed_aggregation_solver`` for
the options BASELINE config 1 runs).

Symmetric strength, standard aggregation, candidate improvement by
symmetric block Gauss-Seidel (4 sweeps, level 0), the tentative fit of one
scalar candidate, Jacobi prolongation smoothing (omega 4/3) with its
``_sa_factor`` recipe, R = P^T and the native Galerkin product: the
reference's arithmetic step for step, so the port's hierarchy equals the
JAX package's level for level.  The reference's other setup options take
only their default value here; any other value raises
``NotImplementedError`` (ROADMAP.md Queue 1 item 16), as does a
nonsymmetric or BSR operator.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..multilevel import MultilevelSolver
from ..relaxation.relaxation import block_gauss_seidel
from ..relaxation.smoothing import change_smoothers
from ..strength import symmetric_strength_of_connection
from ..util.utils import asfptype, galerkin_product, upcast
from .aggregate import standard_aggregation
from .smooth import jacobi_prolongation_smoother
from .tentative import fit_candidates

__all__ = ["smoothed_aggregation_solver"]

CONFIG1_SMOOTHER = ("jacobi", {"omega": 4.0 / 3.0})
# the reference's default pre/post smoother (multicolor Gauss-Seidel on the
# device, or Chebyshev on a level with more than 16 colours)
DEFAULT_SMOOTHER = ("block_gauss_seidel", {"sweep": "symmetric"})

# the reference's setup options the copy runs, each with the values it
# takes (the reference's defaults)
_OPTIONS = {
    "symmetry": ("hermitian", "symmetric"),
    "BH": (None,),
    "strength": ("symmetric",),
    "aggregate": ("standard",),
    "smooth": (("jacobi", {"omega": 4.0 / 3.0}),),
    "improve_candidates": (
        (("block_gauss_seidel", {"sweep": "symmetric", "iterations": 4}),
         None),),
    "diagonal_dominance": (False,),
    "keep": (False,),
}


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported to pyamg_tpu_torch "
                               "yet (ROADMAP.md Queue 1 item 16)")


def _check_options(options):
    for key, value in options.items():
        if isinstance(value, list):
            value = tuple(value)
        allowed = _OPTIONS.get(key, ())
        if not any(type(value) is type(a) and value == a for a in allowed):
            raise _not_ported(f"the setup option {key}={value!r}")


def smoothed_aggregation_solver(A, B=None, presmoother=DEFAULT_SMOOTHER,
                                postsmoother=DEFAULT_SMOOTHER, max_levels=10,
                                max_coarse=10, **options):
    """A smoothed-aggregation hierarchy (:class:`MultilevelSolver`) of the
    real symmetric operator ``A`` with the reference's setup.  The pre/post
    smoothers default to the reference's, symmetric block Gauss-Seidel
    (scalar here: the device compile's multicolor Gauss-Seidel); config 1
    passes ``CONFIG1_SMOOTHER``, Jacobi with omega 4/3.  ``options`` are
    the reference's other setup options (``symmetry``, ``BH``,
    ``strength``, ``aggregate``, ``smooth``, ``improve_candidates``,
    ``diagonal_dominance``, ``keep``), accepted at their default value
    only."""
    if sp.issparse(A) and A.format == "bsr":
        raise _not_ported("the setup of a BSR operator")
    A = asfptype(sp.csr_matrix(A))
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    if np.iscomplexobj(A.data):
        raise _not_ported("the setup of a complex operator")
    _check_options(options)

    n = A.shape[0]
    if B is None:
        B = np.ones((n, 1), dtype=A.dtype)
    else:
        B = np.asarray(B, dtype=upcast(A.dtype, np.asarray(B).dtype))
        if B.ndim == 1:
            B = B.reshape(-1, 1)
        if B.shape[0] != n:
            raise ValueError("invalid candidate dimensions")
    B = B.copy()

    levels = [MultilevelSolver.Level()]
    levels[-1].A = A
    levels[-1].B = B
    while len(levels) < max_levels and levels[-1].A.shape[0] > max_coarse:
        sizes_before = levels[-1].A.shape[0]
        _extend_hierarchy(levels)
        if levels[-2].P.shape[1] == 0 or levels[-1].A.shape[0] == sizes_before:
            # aggregation failed to coarsen; drop the stalled level
            levels.pop()
            break

    ml = MultilevelSolver(levels)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels):
    """One coarsening step: strength, aggregation, candidate improvement
    (level 0 only, as the reference's default), tentative fit,
    prolongation smoothing, R = P^T, Galerkin product."""
    A = levels[-1].A
    B = levels[-1].B

    C = symmetric_strength_of_connection(A)
    AggOp, _Cpts = standard_aggregation(C)
    if len(levels) == 1:
        # relax A z = 0 from each candidate column, in place
        b = np.zeros(A.shape[0], dtype=B.dtype)
        for c in range(B.shape[1]):
            x = np.ascontiguousarray(B[:, c])
            block_gauss_seidel(A, x, b, iterations=4, sweep="symmetric")
            B[:, c] = x
    levels[-1].B = B
    T, B_coarse = fit_candidates(AggOp, B)
    P = jacobi_prolongation_smoother(A, T, C, B, omega=4.0 / 3.0)

    # real symmetric A ('hermitian' or 'symmetric'): R = P^T, and the
    # device compile may share P's arrays without a numeric comparison
    R = P.T.tocsr()
    levels[-1].R_is_PT = True
    levels[-1].P = P
    levels[-1].R = R

    lvl = MultilevelSolver.Level()
    lvl.A = galerkin_product(R, A, P)
    lvl.B = B_coarse
    levels.append(lvl)
