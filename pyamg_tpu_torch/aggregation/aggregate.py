"""Standard aggregation for the port's host SA setup (a copy of
``pyamg_tpu/aggregation/aggregate.py::standard_aggregation``, its native
form)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..amg_core import native

__all__ = ["standard_aggregation"]


def _aggop_from_assignment(assignment, n_agg, dtype=np.float64):
    """The (n, n_agg) 0/1 CSR AggOp of a node -> aggregate map."""
    n = len(assignment)
    assigned = assignment >= 0
    rows = np.flatnonzero(assigned)
    cols = assignment[assigned]
    data = np.ones(len(rows), dtype=dtype)
    return sp.csr_matrix((data, (rows, cols)), shape=(n, max(n_agg, 1)))


def standard_aggregation(C):
    """Standard (VMB) greedy aggregation: pass 1 makes an aggregate of
    every node whose strong neighbours are all free, pass 2 joins the
    remaining nodes to a neighbouring pass-1 aggregate, pass 3 seeds new
    aggregates from the leftovers.  Returns (AggOp, Cpts)."""
    C = sp.csr_matrix(C)
    C.sort_indices()
    assignment, roots = native().standard_aggregation(C.indptr, C.indices)
    return _aggop_from_assignment(assignment, len(roots)), np.asarray(roots)
