"""Device smoothers (counterpart of ``pyamg_tpu/engine/relaxation.py``).

Ported so far: ``identity`` and weighted ``jacobi``.  On a DIA operator a
Jacobi sweep is one :func:`~pyamg_tpu_torch.sparse.dia.dia_jacobi`
kernel pass, and the zero-guess sweep plus its residual one
:func:`~pyamg_tpu_torch.sparse.dia.dia_jacobi_zero_res` pass.  The other
smoothers are ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..sparse.dia import DIAMatrix, dia_jacobi, dia_jacobi_zero_res

__all__ = ["DeviceSmoother", "identity", "jacobi"]


@dataclass(frozen=True)
class DeviceSmoother:
    """kind + static scalars (``config``) and device tensors (``arrays``)."""

    config: Tuple
    arrays: Tuple

    def __call__(self, A, x, b):
        kind = self.config[0]
        if kind == "identity":
            return x
        _, omega, iterations = self.config
        (dinv,) = self.arrays
        for _ in range(iterations):
            x = _jacobi_step(A, x, b, dinv, omega)
        return x

    def zero_call(self, A, b):
        """Apply with a known-zero initial guess: the first Jacobi sweep
        collapses to omega * dinv * b."""
        kind = self.config[0]
        if kind == "identity":
            return torch.zeros_like(b)
        _, omega, iterations = self.config
        (dinv,) = self.arrays
        x = omega * (dinv * b)
        for _ in range(iterations - 1):
            x = _jacobi_step(A, x, b, dinv, omega)
        return x

    def zero_call_residual(self, A, b):
        """(x, r) = (zero_call(A, b), b - A @ x) in one kernel pass when
        the smoother is a single Jacobi sweep on a DIA operator; None
        otherwise (the caller composes)."""
        if not isinstance(A, DIAMatrix) or self.config[0] != "jacobi":
            return None
        _, omega, iterations = self.config
        (dinv,) = self.arrays
        if iterations != 1 or dinv.shape != b.shape:
            return None
        return dia_jacobi_zero_res(A, b, dinv, omega)

    def call_residual(self, A, x, b):
        """The fused sweep-then-residual of a nonzero guess is TPU kernel
        K4, not ported yet (ROADMAP.md Queue 2): None makes the caller
        compose the step, as the reference does when its gate refuses."""
        return None


def identity():
    return DeviceSmoother(config=("identity",), arrays=())


def jacobi(dinv, omega, iterations=1):
    return DeviceSmoother(config=("jacobi", float(omega), int(iterations)),
                          arrays=(dinv,))


def _jacobi_step(A, x, b, dinv, omega):
    if isinstance(A, DIAMatrix):
        return dia_jacobi(A, x, b, dinv, omega)
    return x + omega * (dinv * (b - (A @ x)))
