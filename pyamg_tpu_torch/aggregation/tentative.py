"""Tentative prolongator for the port's host setups (a copy of
``pyamg_tpu/aggregation/tentative.py::fit_candidates``): one scalar
candidate by a norm and a scale per aggregate; several candidates or
block dofs by the reference's batched QR, aggregates bucketed by size.
Complex candidates are ROADMAP.md Queue 1 item 16."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["fit_candidates"]


def fit_candidates(AggOp, B, tol=1e-10):
    """(T, coarse_B): T (n_dof, n_agg k) with orthonormal columns per
    aggregate and coarse_B (n_agg k, k) the R factors.  With one scalar
    candidate, T[i, agg(i)] = B[i] / ||B||_agg(i) and coarse_B the norms
    (a zero-norm aggregate gets a zero column); otherwise the batched QR,
    where a local candidate whose R diagonal falls below ``tol`` times
    its column's norm is dropped."""
    AggOp = sp.csr_matrix(AggOp)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B.reshape(-1, 1)
    n_nodes, n_agg = AggOp.shape
    n_dof, k = B.shape
    if n_dof % n_nodes != 0:
        raise ValueError("B row count must be a multiple of AggOp row count")
    if np.iscomplexobj(B):
        raise NotImplementedError(
            "fit_candidates for complex candidates is not ported to "
            "pyamg_tpu_torch yet (ROADMAP.md Queue 1 item 16)")
    bs = n_dof // n_nodes
    dtype = np.promote_types(B.dtype, np.float32)
    if k != 1 or bs != 1:
        return _fit_batched(AggOp, B, bs, k, n_dof, n_agg, dtype, tol)
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


def _fit_batched(AggOp, B, bs, k, n_dof, n_agg, dtype, tol):
    """The batched QR of ``fit_candidates``: aggregates of m nodes form
    one (n_b, m bs, k) batch; Q signed so that diag(R) >= 0."""
    Agg_csc = AggOp.tocsc()
    indptr, indices = Agg_csc.indptr, Agg_csc.indices
    sizes = np.diff(indptr)
    coarse_B = np.zeros((n_agg * k, k), dtype=dtype)
    out_rows, out_cols, out_vals = [], [], []
    for m in np.unique(sizes):
        if m == 0:
            continue
        aggs = np.flatnonzero(sizes == m)
        node_idx = indices[
            (indptr[aggs][:, None] + np.arange(m)[None, :]).ravel()
        ].reshape(len(aggs), m)
        dof_idx = (node_idx[:, :, None] * bs
                   + np.arange(bs)[None, None, :]).reshape(len(aggs), m * bs)
        Blocal = B[dof_idx].astype(dtype)
        p = m * bs
        mn = min(p, k)
        q, r = np.linalg.qr(Blocal, mode="reduced")
        diag = np.einsum("bii->bi", r[:, :mn, :mn]).copy()
        signs = np.where(diag >= 0, 1.0, -1.0)
        q = q * signs[:, None, :]
        r = r * signs[:, :, None]
        col_scale = np.sqrt((np.abs(Blocal) ** 2).sum(axis=1))
        dep = np.abs(np.einsum("bii->bi", r[:, :mn, :mn])) < tol * np.maximum(
            col_scale[:, :mn], 1e-300)
        if dep.any():
            qmask = ~dep
            q = q * qmask[:, None, :]
            r = r * qmask[:, :, None]
        Qfull = np.zeros((len(aggs), p, k), dtype=dtype)
        Qfull[:, :, :mn] = q
        Rfull = np.zeros((len(aggs), k, k), dtype=dtype)
        Rfull[:, :mn, :] = r
        coarse_rows = aggs[:, None] * k + np.arange(k)[None, :]
        coarse_B[coarse_rows.ravel()] = Rfull.reshape(-1, k)
        rows = np.broadcast_to(dof_idx[:, :, None], (len(aggs), p, k))
        cols = np.broadcast_to(
            aggs[:, None, None] * k + np.arange(k)[None, None, :],
            (len(aggs), p, k))
        out_rows.append(rows.ravel())
        out_cols.append(cols.ravel())
        out_vals.append(Qfull.ravel())
    if out_rows:
        rows = np.concatenate(out_rows)
        cols = np.concatenate(out_cols)
        vals = np.concatenate(out_vals)
    else:
        rows = cols = np.array([], dtype=np.int64)
        vals = np.array([], dtype=dtype)
    T = sp.csr_matrix((vals, (rows, cols)), shape=(n_dof, n_agg * k))
    T.eliminate_zeros()
    T.sort_indices()
    return T, coarse_B
