"""Rootnode smoothed-aggregation setup on the host (a copy of
``pyamg_tpu/aggregation/rootnode.py::rootnode_solver`` for the options
BASELINE config 4 runs).

Each aggregate's root node carries an identity block, so the coarse dofs
are fine dofs at the roots; the tentative prolongator is scaled to that
identity (``scale_T``) and smoothed by energy minimisation.  Symmetric
strength (a BSR operator amalgamated to its block norms), standard
aggregation, block Gauss-Seidel candidate improvement on level 0, the
batched QR fit, energy smoothing by CG, R = P^T and the native Galerkin
product: the reference's arithmetic step for step.  As in the reference,
at most blocksize candidates are used (extra ones are truncated with a
warning) and each coarse operator is BSR with k x k blocks for k
candidates.  Any other option (the reference's default 'evolution'
strength, ``symmetry='nonsymmetric'``, Jacobi smoothing, the other
energy Krylov methods) raises ``NotImplementedError`` (ROADMAP.md Queue 1
item 16).
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from ..multilevel import MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..util.utils import (asfptype, blocksize, conj_transpose_csr,
                          galerkin_product, get_Cpt_params,
                          levelize_smooth_or_improve_candidates,
                          levelize_strength_or_aggregation, scale_T, upcast)
from .aggregation import (DEFAULT_SMOOTHER, _do_aggregate,
                          _improve_candidates, _not_ported, _strength_measure)
from .smooth import energy_prolongation_smoother
from .tentative import fit_candidates

__all__ = ["rootnode_solver"]


def rootnode_solver(A, B=None, BH=None, symmetry="hermitian",
                    strength="evolution", aggregate="standard",
                    smooth=("energy", {"krylov": "cg", "maxiter": 3,
                                       "degree": 1, "weighting": "local"}),
                    presmoother=DEFAULT_SMOOTHER,
                    postsmoother=DEFAULT_SMOOTHER,
                    improve_candidates=(("block_gauss_seidel",
                                         {"sweep": "symmetric",
                                          "iterations": 4}), None),
                    max_levels=10, max_coarse=10, keep=False, **kwargs):
    """A rootnode hierarchy (:class:`MultilevelSolver`) of the real
    symmetric CSR or BSR operator ``A`` with the reference's signature and
    defaults.  Config 4 passes ``strength='symmetric'``; the default
    'evolution' strength raises until it is ported.  Each level but the
    coarsest records ``Cnodes`` (the roots), ``Cpts`` / ``Fpts`` (their
    dofs and the others), ``P``, ``R`` (= P^T) and ``B``."""
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
    A = asfptype(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    if symmetry not in ("symmetric", "hermitian", "nonsymmetric"):
        raise ValueError("expected symmetric, hermitian or nonsymmetric")
    if symmetry == "nonsymmetric" or BH is not None:
        raise _not_ported("the nonsymmetric rootnode setup")
    if np.iscomplexobj(A.data):
        raise _not_ported("the setup of a complex operator")
    A.symmetry = symmetry

    n = A.shape[0]
    bs = blocksize(A)
    if B is None:
        B = np.ones((n, 1), dtype=A.dtype)
    else:
        B = np.asarray(B, dtype=upcast(A.dtype, np.asarray(B).dtype))
        if B.ndim == 1:
            B = B.reshape(-1, 1)
    if B.shape[1] > bs:
        warnings.warn(
            f"rootnode uses at most blocksize={bs} candidates; truncating "
            f"B from {B.shape[1]}")
        B = B[:, :bs]
    B = B.copy()

    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)
    max_levels, max_coarse, aggregate = levelize_strength_or_aggregation(
        aggregate, max_levels, max_coarse)
    improve_candidates = levelize_smooth_or_improve_candidates(
        improve_candidates, max_levels)
    smooth = levelize_smooth_or_improve_candidates(smooth, max_levels)

    levels = [MultilevelSolver.Level()]
    levels[-1].A = A
    levels[-1].B = B
    while (len(levels) < max_levels
           and levels[-1].A.shape[0] // max(blocksize(levels[-1].A), 1)
           > max_coarse):
        n_before = levels[-1].A.shape[0]
        _extend_hierarchy(levels, strength, aggregate, smooth,
                          improve_candidates, keep)
        if levels[-1].A.shape[0] >= n_before:
            levels.pop()
            break

    ml = MultilevelSolver(levels)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels, strength, aggregate, smooth,
                      improve_candidates, keep):
    """One coarsening step: strength, aggregation (with its roots),
    candidate improvement, the tentative fit scaled to the roots' identity,
    energy smoothing, R = P^T, the Galerkin product (BSR k x k)."""
    A = levels[-1].A
    B = levels[-1].B
    lvl_i = len(levels) - 1
    symmetry = getattr(A, "symmetry", "hermitian")

    C = _strength_measure(A, strength[min(lvl_i, len(strength) - 1)],
                          ("symmetric",))
    AggOp, Cnodes = _do_aggregate(
        C, aggregate[min(lvl_i, len(aggregate) - 1)], A=A)

    B = _improve_candidates(
        A, B, improve_candidates[min(lvl_i, len(improve_candidates) - 1)])
    levels[-1].B = B

    T, _ = fit_candidates(AggOp, B)
    Cpt_params = get_Cpt_params(A, Cnodes, AggOp, T)
    T = scale_T(T, Cpt_params["P_I"], Cpt_params["I_F"])
    # the coarse candidates are the fine ones at the root dofs
    B_coarse = B[Cpt_params["Cpts"], :]

    smooth_spec = smooth[min(lvl_i, len(smooth) - 1)]
    name, skw = (smooth_spec if isinstance(smooth_spec, tuple)
                 else (smooth_spec, {}))
    skw = dict(skw or {})
    if name != "energy":
        raise _not_ported(f"the rootnode prolongation smoother {name!r}")
    P = energy_prolongation_smoother(
        A, T, C, B_coarse, B, Cpt_params=(True, Cpt_params), **skw)

    # real data ('hermitian' or 'symmetric'): R = P^H = P^T
    R = conj_transpose_csr(P)
    levels[-1].R_is_PT = True

    if keep:
        levels[-1].C = C
        levels[-1].AggOp = AggOp
        levels[-1].T = T
    levels[-1].Cnodes = np.asarray(Cnodes)
    levels[-1].Fpts = Cpt_params["Fpts"]
    levels[-1].Cpts = Cpt_params["Cpts"]
    levels[-1].P = P
    levels[-1].R = R

    A_coarse = galerkin_product(R, A, P)
    A_coarse.symmetry = symmetry
    k = B_coarse.shape[1]
    if k > 1 and A_coarse.shape[0] % k == 0:
        A_coarse = A_coarse.tobsr(blocksize=(k, k))
        A_coarse.symmetry = symmetry

    lvl = MultilevelSolver.Level()
    lvl.A = A_coarse
    lvl.B = B_coarse
    levels.append(lvl)
