"""C/F splitting for the port's Ruge-Stuben host setup (a copy of
``pyamg_tpu/classical/split.py::RS``, its native form).  The other
splittings are ROADMAP.md Queue 1 item 16."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..amg_core import native

__all__ = ["RS", "F_NODE", "C_NODE", "U_NODE"]

F_NODE = 0
C_NODE = 1
U_NODE = 2


def _strength_pattern(S):
    """The CSR pattern of S without its diagonal, indices sorted."""
    S = sp.csr_matrix(S)
    S = S.copy()
    S.setdiag(0)
    S.eliminate_zeros()
    S.sort_indices()
    return S


def RS(S, second_pass=False):
    """The serial Ruge-Stuben splitting (int32, F_NODE / C_NODE) of the
    strength matrix S: C points by a bucket priority queue on the count
    of undecided points depending on them; the optional second pass
    enforces the strong F-F common-C condition."""
    S = _strength_pattern(S)
    T = S.T.tocsr()
    T.sort_indices()
    return native().rs_cf_splitting(S.indptr, S.indices, T.indptr,
                                    T.indices,
                                    second_pass=second_pass).astype(np.int32)
