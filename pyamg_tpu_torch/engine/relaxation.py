"""Device smoothers (counterpart of ``pyamg_tpu/engine/relaxation.py``).

Ported so far: ``identity``, weighted ``jacobi`` and ``jacobi_dyn`` (the
same sweep with its weight held as a 0-d tensor on the device, as the
device-built hierarchy stores it).  On a DIA operator a Jacobi sweep is
one :func:`~pyamg_tpu_torch.sparse.dia.dia_jacobi` kernel pass, the
zero-guess sweep plus its residual one
:func:`~pyamg_tpu_torch.sparse.dia.dia_jacobi_zero_res` pass, and a sweep
from a nonzero guess plus the residual of its result one
:func:`~pyamg_tpu_torch.sparse.dia.dia_jacobi_res` pass.

Every entry form also takes K-major (K, n_pad) lane stacks for x and b
(the batched solve): a sweep is one K9 pass
(:func:`~pyamg_tpu_torch.sparse.dia.dia_jacobi_k`), a sweep plus the
residual of its result is K9 then the residual through K8
(:func:`~pyamg_tpu_torch.sparse.dia.dia_jacobi_res_k`, the reference's
batch rule), and the zero-guess sweep plus residual one K10 pass
(:func:`~pyamg_tpu_torch.sparse.dia.dia_jacobi_zero_res_k`).  On an
operator that is not DIA the sweep composes through ``A @ X``.  The
other smoothers are ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..sparse.dia import (DIAMatrix, dia_jacobi, dia_jacobi_k,
                          dia_jacobi_res, dia_jacobi_res_k,
                          dia_jacobi_zero_res, dia_jacobi_zero_res_k)

__all__ = ["DeviceSmoother", "identity", "jacobi", "jacobi_dyn"]


@dataclass(frozen=True)
class DeviceSmoother:
    """kind + static scalars (``config``) and device tensors (``arrays``)."""

    config: Tuple
    arrays: Tuple

    def _jacobi(self):
        """(dinv, omega, iterations) of a Jacobi smoother, else None."""
        kind = self.config[0]
        if kind == "jacobi":
            _, omega, iterations = self.config
            (dinv,) = self.arrays
        elif kind == "jacobi_dyn":
            _, iterations = self.config
            dinv, omega = self.arrays
        else:
            return None
        return dinv, omega, iterations

    def __call__(self, A, x, b):
        if self.config[0] == "identity":
            return x
        dinv, omega, iterations = self._jacobi()
        for _ in range(iterations):
            x = _jacobi_step(A, x, b, dinv, omega)
        return x

    def zero_call(self, A, b):
        """Apply with a known-zero initial guess: the first Jacobi sweep
        collapses to omega * dinv * b."""
        if self.config[0] == "identity":
            return torch.zeros_like(b)
        dinv, omega, iterations = self._jacobi()
        x = omega * (dinv * b)
        for _ in range(iterations - 1):
            x = _jacobi_step(A, x, b, dinv, omega)
        return x

    def zero_call_residual(self, A, b):
        """(x, r) = (zero_call(A, b), b - A @ x) in one kernel pass when
        the smoother is a single Jacobi sweep on a DIA operator (K3, or
        K10 for a K-major lane stack b); None otherwise (the caller
        composes)."""
        jac = self._jacobi()
        if not isinstance(A, DIAMatrix) or jac is None:
            return None
        dinv, omega, iterations = jac
        if iterations != 1 or dinv.shape[0] != b.shape[-1]:
            return None
        if b.ndim == 2:
            return dia_jacobi_zero_res_k(A, b, dinv, omega)
        return dia_jacobi_zero_res(A, b, dinv, omega)

    def call_residual(self, A, x, b):
        """(y, r) = (self(A, x, b), b - A @ y) in one kernel pass when the
        smoother is a single Jacobi sweep on a DIA operator (for lane
        stacks, K9 then K8); None otherwise (the caller composes)."""
        jac = self._jacobi()
        if not isinstance(A, DIAMatrix) or jac is None:
            return None
        dinv, omega, iterations = jac
        if (iterations != 1 or dinv.shape[0] != b.shape[-1]
                or x.shape != b.shape):
            return None
        if b.ndim == 2:
            return dia_jacobi_res_k(A, x, b, dinv, omega)
        return dia_jacobi_res(A, x, b, dinv, omega)


def identity():
    return DeviceSmoother(config=("identity",), arrays=())


def jacobi(dinv, omega, iterations=1):
    return DeviceSmoother(config=("jacobi", float(omega), int(iterations)),
                          arrays=(dinv,))


def jacobi_dyn(dinv, omega, iterations=1):
    """Weighted Jacobi whose ``omega`` is a 0-d tensor on the device (the
    device-built setup computes it there from a spectral-radius estimate;
    the kernels read it by pointer, so no sweep syncs the host)."""
    return DeviceSmoother(config=("jacobi_dyn", int(iterations)),
                          arrays=(dinv, omega))


def _jacobi_step(A, x, b, dinv, omega):
    if isinstance(A, DIAMatrix):
        if x.ndim == 2:
            return dia_jacobi_k(A, x, b, dinv, omega)
        return dia_jacobi(A, x, b, dinv, omega)
    return x + omega * (dinv * (b - (A @ x)))
