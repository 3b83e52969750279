"""Tentative prolongator for the port's host SA setup (a copy of
``pyamg_tpu/aggregation/tentative.py::fit_candidates`` for one scalar
candidate, where the per-aggregate QR is a norm and a scale).  Several
candidates or block operators are ROADMAP.md Queue 1 item 16."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["fit_candidates"]


def fit_candidates(AggOp, B, tol=1e-10):
    """(T, coarse_B): T (n, n_agg) with unit-norm columns per aggregate,
    T[i, agg(i)] = B[i] / ||B||_agg(i), and coarse_B (n_agg, 1) the
    per-aggregate norms; a zero-norm aggregate gets a zero column.
    ``tol`` is accepted for API parity (a single candidate drops no
    dependent column)."""
    AggOp = sp.csr_matrix(AggOp)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B.reshape(-1, 1)
    n_nodes, n_agg = AggOp.shape
    n_dof, k = B.shape
    if n_dof % n_nodes != 0:
        raise ValueError("B row count must be a multiple of AggOp row count")
    if k != 1 or n_dof != n_nodes or np.iscomplexobj(B):
        raise NotImplementedError(
            "fit_candidates for several, block or complex candidates is not "
            "ported to pyamg_tpu_torch yet (ROADMAP.md Queue 1 item 16)")
    dtype = np.promote_types(B.dtype, np.float32)
    has = np.diff(AggOp.indptr) > 0
    agg_of_row = np.zeros(n_nodes, dtype=np.int64)
    agg_of_row[has] = AggOp.indices
    b = B[:, 0]
    w = (np.abs(b) ** 2) * has
    norms = np.sqrt(np.bincount(agg_of_row[has], weights=w[has],
                                minlength=n_agg))
    coarse_B = norms.reshape(-1, 1).astype(dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(norms > 0, 1.0 / np.where(norms > 0, norms, 1), 0.0)
    data = b.astype(dtype)[has] * inv[AggOp.indices].astype(dtype)
    T = sp.csr_matrix((data, AggOp.indices.copy(), AggOp.indptr.copy()),
                      shape=(n_dof, n_agg))
    T.eliminate_zeros()
    T.sort_indices()
    return T, coarse_B
