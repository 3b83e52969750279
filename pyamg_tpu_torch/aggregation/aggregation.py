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
``NotImplementedError`` (ROADMAP.md Queue 1 item 16), as do a
nonsymmetric or BSR operator and several candidates.

The spec resolvers ``_strength_measure``, ``_do_aggregate`` and
``_improve_candidates`` are the reference's, for the names the rootnode
and Ruge-Stuben setups run (symmetric and classical strength, standard
aggregation, block Gauss-Seidel candidate improvement).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..multilevel import MultilevelSolver
from .. import strength as strength_module
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


# the strength names the resolver below knows; each solver passes the
# ones it ports (rootnode: symmetric, Ruge-Stuben: classical)
_STRENGTH = {
    "symmetric": strength_module.symmetric_strength_of_connection,
    "classical": strength_module.classical_strength_of_connection,
}


def _spec(spec):
    name, kwargs = spec if isinstance(spec, tuple) else (spec, {})
    return name, dict(kwargs or {})


def _strength_measure(A, spec, ported):
    """The strength matrix C of a spec ('name' or ('name', kwargs)) whose
    name is one of the caller's ``ported`` names."""
    name, kwargs = _spec(spec)
    if name not in ported:
        raise _not_ported(f"the strength of connection {name!r}")
    return _STRENGTH[name](A, **kwargs)


def _do_aggregate(C, spec, A=None):
    """(AggOp, Cnodes) of an aggregate spec: the aggregation and each
    aggregate's root node.  ``A`` is accepted for the reference's
    signature (pairwise aggregation reads it)."""
    del A
    name, kwargs = _spec(spec)
    if name != "standard" or kwargs:
        raise _not_ported(f"the aggregation {spec!r}")
    return standard_aggregation(C)


def _improve_candidates(A, B, spec):
    """Relax A z = 0 from each candidate column of B, in place."""
    if spec is None:
        return B
    name, kwargs = _spec(spec)
    if name is None:
        return B
    if name != "block_gauss_seidel":
        raise _not_ported(f"the candidate improvement {name!r}")
    b = np.zeros(A.shape[0], dtype=B.dtype)
    for c in range(B.shape[1]):
        x = np.ascontiguousarray(B[:, c])
        block_gauss_seidel(A, x, b, **kwargs)
        B[:, c] = x
    return B


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
        if B.shape[1] != 1:
            raise _not_ported("the SA setup of several candidates")
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
        B = _improve_candidates(A, B, ("block_gauss_seidel",
                                       {"sweep": "symmetric",
                                        "iterations": 4}))
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
