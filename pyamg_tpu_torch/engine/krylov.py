"""Device Krylov methods (counterpart of ``pyamg_tpu/engine/krylov.py``).

Ported so far: preconditioned CG.  The iteration is a Python loop bounded
by ``maxiter``; the residual history is a NaN-padded ``(maxiter + 1,)``
device tensor, as in the reference.  The convergence test reads one
scalar per iteration back to the host (a CUDA graph of the iteration is
later work).  The other methods are ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

import torch

__all__ = ["device_cg"]


def _vdot(a, b):
    """Inner product as elementwise multiply + sum, as the reference forms
    it (real vectors)."""
    return torch.sum(a * b)


def _norm(a):
    return torch.sqrt(torch.sum(a * a))


def _rtol_of(b, tol):
    normb = _norm(b)
    return tol * torch.where(normb == 0, torch.ones_like(normb), normb)


def _safe_div(num, den):
    """num / den, and 0 where den == 0 (the reference's where-guards)."""
    zero = den == 0
    return torch.where(zero, torch.zeros_like(num),
                       num / torch.where(zero, torch.ones_like(den), den))


def device_cg(matvec, b, x0, tol=1e-8, maxiter=100, M=None):
    """Preconditioned CG; returns ``(x, history, iterations)``."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)

    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = _vdot(r, z)
    normr = _norm(r)
    rtol = _rtol_of(b, tol)
    history = torch.full((maxiter + 1,), float("nan"), dtype=b.dtype,
                         device=b.device)
    history[0] = normr
    it = 0
    active = bool(normr >= rtol)        # one host read per iteration
    while active and it < maxiter:
        Ap = matvec(p)
        alpha = _safe_div(rz, _vdot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        normr = _norm(r)
        history[it + 1] = normr
        it += 1
        active = bool(normr >= rtol)
        if not active or it >= maxiter:
            # the reference's last body also forms z and p, which nothing
            # returned depends on: skip that preconditioner application
            break
        z = precond(r)
        rz2 = _vdot(r, z)
        p = z + _safe_div(rz2, rz) * p
        rz = rz2
    return x, history, it
