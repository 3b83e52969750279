"""Strength of connection for the port's host setups (a copy of
``pyamg_tpu/strength.py``): ``symmetric_strength_of_connection`` in its
native single-pass form for theta = 0 (the SA and rootnode default, which
keeps the whole pattern), a BSR operator amalgamated to the Frobenius
norms of its blocks first; and ``classical_strength_of_connection``, the
Ruge-Stuben measure.  Symmetric strength with theta > 0, the other
measures and operators with rows that store no diagonal entry are
ROADMAP.md Queue 1 item 16."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .amg_core import native
from .util.utils import scale_rows_by_largest_entry

__all__ = ["symmetric_strength_of_connection",
           "classical_strength_of_connection"]


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported to pyamg_tpu_torch "
                               "yet (ROADMAP.md Queue 1 item 16)")


def _block_amalgamate(A, norm="fro"):
    """A BSR matrix collapsed to the scalar CSR of its block norms."""
    A = A.tobsr() if A.format != "bsr" else A
    bs_r, bs_c = A.blocksize
    n = A.shape[0] // bs_r
    m = A.shape[1] // bs_c
    if norm == "abs":
        vals = np.abs(A.data).max(axis=(1, 2))
    elif norm == "min":
        vals = A.data.min(axis=(1, 2))
    else:
        vals = np.sqrt((np.abs(A.data) ** 2).sum(axis=(1, 2)))
    return sp.csr_matrix((vals, A.indices.copy(), A.indptr.copy()),
                         shape=(n, m))


def _row_reduce(data, indptr, nrows, op, empty=0.0):
    """Per-row reduction of CSR data by ``op.reduceat``."""
    out = np.full(nrows, empty, dtype=data.dtype if data.size else np.float64)
    nz = np.diff(indptr) > 0
    if data.size:
        out[nz] = op.reduceat(data, indptr[:-1][nz])
    return out


def _recount_indptr(keep, indptr, n):
    """The row pointer of the entries ``keep`` marks (reduceat only at
    nonempty rows: an empty trailing row's offset would be out of range)."""
    nz = np.diff(indptr) > 0
    counts = np.zeros(n, np.int64)
    if keep.size and nz.any():
        counts[nz] = np.add.reduceat(keep.astype(np.int64), indptr[:-1][nz])
    new_indptr = np.zeros(n + 1, dtype=indptr.dtype)
    np.cumsum(counts, out=new_indptr[1:])
    return new_indptr


def _set_diagonal_to(S, value):
    S = S.tocsr()
    n = S.shape[0]
    rows = np.repeat(np.arange(n), np.diff(S.indptr))
    diag_mask = S.indices == rows
    if np.count_nonzero(diag_mask) == n:
        S.data[diag_mask] = value
        return S
    d = S.diagonal()
    S = S + sp.dia_matrix(((value - d).reshape(1, -1), [0]), shape=S.shape)
    S = S.tocsr()
    S.sort_indices()
    return S


def classical_strength_of_connection(A, theta=0.25, block=True, norm="abs"):
    """Classical Ruge-Stuben strength: j is strong for i where |A_ij| >=
    theta max_{k != i} |A_ik| (norm 'abs'), or -A_ij >= theta max_{k != i}
    (-A_ik) (norm 'min'); rows scaled to a largest entry of 1, with a unit
    diagonal.  A BSR operator is amalgamated to its block norms."""
    if sp.issparse(A) and A.format == "bsr" and block:
        if A.blocksize == (1, 1):
            return classical_strength_of_connection(A.tocsr(), theta,
                                                    block=False, norm=norm)
        Asc = _block_amalgamate(A, norm="fro" if norm == "fro" else "abs")
        return classical_strength_of_connection(Asc, theta, block=False,
                                                norm="abs")

    A = sp.csr_matrix(A)
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    offdiag = A.indices != rows

    if norm == "min":
        measure = np.where(offdiag, -np.real(A.data), 0.0)
        measure = np.maximum(measure, 0.0)
    else:
        measure = np.where(offdiag, np.abs(A.data), 0.0)

    rowmax = _row_reduce(measure, A.indptr, n, np.maximum)
    strong = (measure >= theta * rowmax[rows]) & (measure > 0) & offdiag
    keep = strong | ~offdiag
    data = np.where(offdiag, measure, 0.0)

    S = sp.csr_matrix(
        (data[keep], A.indices[keep], _recount_indptr(keep, A.indptr, n)),
        shape=A.shape)
    S = scale_rows_by_largest_entry(S)
    return _set_diagonal_to(S, 1.0)


def symmetric_strength_of_connection(A, theta=0):
    """Symmetric strength with theta = 0: the whole pattern of A, |A_ij|
    row-scaled to a largest entry of 1, with a unit diagonal; a BSR
    operator first collapses to the Frobenius norms of its blocks."""
    if theta != 0:
        raise _not_ported(f"symmetric strength with theta={theta}")
    if sp.issparse(A) and A.format == "bsr" and A.blocksize != (1, 1):
        return symmetric_strength_of_connection(
            _block_amalgamate(A, norm="fro"), theta)
    A = sp.csr_matrix(A)
    if np.iscomplexobj(A.data):
        raise _not_ported("the strength of a complex operator")
    n = A.shape[0]
    data_out, _keep, n_diag = native().symmetric_strength(
        A.indptr, A.indices, A.data, theta)
    if n_diag != n:
        raise _not_ported("the strength of an operator with rows that "
                          "store no diagonal entry")
    # copy the structure arrays: S aliasing A's indices would let a later
    # sort_indices() on S reorder A's indices under its data
    return sp.csr_matrix((data_out, A.indices.copy(), A.indptr.copy()),
                         shape=A.shape)
