"""Device-side setup helpers (counterpart of
``pyamg_tpu/engine/device_setup.py``).  Only :func:`dia_transpose` is
ported: the host-built restriction R = T^T (S^T)^d needs it.  The device
SA setup is ROADMAP.md Queue 1 item 6."""

from __future__ import annotations

import torch

from ..sparse.dia import DIAMatrix

__all__ = ["dia_transpose"]


def dia_transpose(A: DIAMatrix) -> DIAMatrix:
    """Transpose of a DIAMatrix, by rolls only.

    B = A^T has B[j, j+p] = A[j+p, j] = A_data[d(-p)][j+p], so
    B_data[p] = roll(A_data[d(-p)], -p).  Wrapped entries land on
    positions whose source entries are stored as zero."""
    lookup = {o: d for d, o in enumerate(A.offsets)}
    offsets = tuple(sorted(-o for o in A.offsets))
    data = torch.stack([torch.roll(A.data[lookup[-p]], -p) for p in offsets])
    return DIAMatrix(data=data, offsets=offsets,
                     shape=(A.shape[1], A.shape[0]), nnz=A.nnz)
