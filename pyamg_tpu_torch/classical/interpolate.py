"""Classical interpolation for the port's Ruge-Stuben host setup (a copy
of ``pyamg_tpu/classical/interpolate.py::classical_interpolation``, its
native two-pass form).  The other interpolations are ROADMAP.md Queue 1
item 16."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..amg_core import native
from .split import C_NODE

__all__ = ["classical_interpolation"]


def _coarse_index_map(splitting):
    """(cmap, cpts): each C point's coarse index (-1 elsewhere), and the
    C points."""
    splitting = np.asarray(splitting)
    cmap = -np.ones(len(splitting), dtype=np.int64)
    cpts = np.flatnonzero(splitting == C_NODE)
    cmap[cpts] = np.arange(len(cpts))
    return cmap, cpts


def _strong_pattern(C):
    C = sp.csr_matrix(C)
    C = C.copy()
    C.setdiag(0)
    C.eliminate_zeros()
    C.sort_indices()
    return C


def _pattern_membership(A, S):
    """Mask over A.data: the entry is also in S's pattern (by flattened
    (row, col) keys)."""
    A = sp.csr_matrix(A)
    S = sp.csr_matrix(S)
    n = A.shape[1]
    rowsA = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                      np.diff(A.indptr))
    rowsS = np.repeat(np.arange(S.shape[0], dtype=np.int64),
                      np.diff(S.indptr))
    keysA = rowsA * n + A.indices
    keysS = rowsS * n + S.indices
    return np.isin(keysA, keysS, assume_unique=False)


def classical_interpolation(A, C, splitting, modified=True):
    """Classical (Ruge-Stuben) interpolation: for an F point i with strong
    C neighbours C_i, w_ij = -(a_ij + sum_{m in Fs_i} a_im a_mj / d_m) /
    d_i, d_m the sum of m's couplings into C_i, d_i the diagonal with the
    weak couplings lumped; with ``modified`` a strong F-F coupling with
    no common C point lumps into the diagonal.  C rows are the
    identity."""
    A = sp.csr_matrix(A)
    if np.iscomplexobj(A.data):
        raise NotImplementedError(
            "classical interpolation of a complex operator is not ported "
            "to pyamg_tpu_torch yet (ROADMAP.md Queue 1 item 16)")
    A.sort_indices()
    S = _strong_pattern(C)
    splitting = np.asarray(splitting)
    cmap, cpts = _coarse_index_map(splitting)
    strong = _pattern_membership(A, S)
    return native().rs_classical_interpolation(
        A.indptr, A.indices, A.data, strong, splitting, cmap, len(cpts),
        modified=modified)
