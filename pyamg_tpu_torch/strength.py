"""Strength of connection for the port's host SA setup (a copy of
``pyamg_tpu/strength.py::symmetric_strength_of_connection``, its native
single-pass form, for theta = 0: the SA default, which keeps the whole
pattern).  theta > 0, the other measures, BSR amalgamation and operators
with rows that store no diagonal entry are ROADMAP.md Queue 1 item 16."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .amg_core import native

__all__ = ["symmetric_strength_of_connection"]


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported to pyamg_tpu_torch "
                               "yet (ROADMAP.md Queue 1 item 16)")


def symmetric_strength_of_connection(A, theta=0):
    """Symmetric strength with theta = 0: the whole pattern of A, |A_ij|
    row-scaled to a largest entry of 1, with a unit diagonal."""
    if theta != 0:
        raise _not_ported(f"symmetric strength with theta={theta}")
    if sp.issparse(A) and A.format == "bsr" and A.blocksize != (1, 1):
        raise _not_ported("the strength of a BSR operator")
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
