"""Composed operator: a product of device operators applied factor by
factor (counterpart of ``pyamg_tpu/sparse/composed.py``).

Smoothed-aggregation transfers are compiled as factors: P = S^d T with S
a DIA smoothing factor and T the k=1 windowed tentative operator, and
R = T^T (S^T)^d sharing T's arrays.  A K-major (K, n) lane stack goes
through the same factors, each fitted along its last axis."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .formats import fit as _fit

__all__ = ["ComposedOperator"]


def _expected_in(op):
    """matvec input length an operator requires, or None (self-pads)."""
    name = type(op).__name__
    if name == "DIAMatrix":
        return op.n_pad
    if name == "DenseOperator":
        return op.data.shape[1]
    return None  # WindowedELL / TransposedWindowed pad internally


def _expected_in_t(op):
    """rmatvec input length (the operator's padded ROW dimension)."""
    name = type(op).__name__
    if name == "DIAMatrix":
        return op.n_pad
    if name == "DenseOperator":
        return op.data.shape[0]
    if name == "WindowedELL":
        return op.n_pad
    if name == "TransposedWindowed":
        return op.base.m_chunks * op.base.w2
    return None


@dataclass(frozen=True)
class ComposedOperator:
    """Product ops[0] @ ops[1] @ ... @ ops[-1], applied right to left."""

    ops: Tuple
    shape: Tuple[int, int]
    nnz: int                     # nnz of the materialized product

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def n_pad(self):
        return getattr(self.ops[0], "n_pad", self.shape[0])

    def matvec(self, x):
        """The product applied to a vector, or lane by lane to a K-major
        (K, n) stack."""
        for op in reversed(self.ops):
            need = _expected_in(op)
            if need is not None:
                x = _fit(x, need)
            x = op @ x
        return x

    def rmatvec(self, x):
        for op in self.ops:
            need = _expected_in_t(op)
            x = op.rmatvec(_fit(x, need) if need is not None else x)
        return x

    def __matmul__(self, x):
        if x.ndim not in (1, 2):
            raise ValueError(f"ComposedOperator applies to a vector or a "
                             f"(K, n) stack, got shape {tuple(x.shape)}")
        return self.matvec(x)
