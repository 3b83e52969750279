"""Device Krylov methods (counterpart of ``pyamg_tpu/engine/krylov.py``).

Ported so far: preconditioned CG.  The iteration is a Python loop bounded
by ``maxiter``; the residual history is a NaN-padded ``(maxiter + 1,)``
device tensor, as in the reference.  The convergence test reads one
scalar per iteration back to the host (a CUDA graph of the iteration is
later work).  The other methods are ROADMAP.md Queue 1 item 7.

A K-major (K, n) stack of right-hand sides runs K CGs in lock-step, as
the reference's solve vmapped over lanes does: the scalars are (K,)
tensors, the history is (maxiter + 1, K), and a lane that has converged
keeps its state (``_freeze``, the reference's per-lane freeze) while the
others iterate; the loop still reads one scalar per iteration
(``active.any()``).
"""

from __future__ import annotations

import torch

__all__ = ["device_cg"]


def _vdot(a, b):
    """Inner product as elementwise multiply + sum, as the reference forms
    it (real vectors); per lane for a (K, n) stack."""
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def _rtol_of(b, tol):
    normb = _norm(b)
    return tol * torch.where(normb == 0, torch.ones_like(normb), normb)


def _safe_div(num, den):
    """num / den, and 0 where den == 0 (the reference's where-guards)."""
    zero = den == 0
    return torch.where(zero, torch.zeros_like(num),
                       num / torch.where(zero, torch.ones_like(den), den))


def _lane(s):
    """A per-lane scalar (K,) as a column (K, 1) against (K, n) stacks; a
    0-d scalar as it is."""
    return s[:, None] if s.ndim == 1 else s


def _freeze(lanes, active, new, old):
    """``new`` where the lane is active, else ``old`` (the reference's
    ``_freeze`` under vmap).  With one right-hand side the loop only runs
    while it is active, so ``new`` is taken as it is."""
    if not lanes:
        return new
    return torch.where(_lane(active) if new.ndim == 2 else active, new, old)


def device_cg(matvec, b, x0, tol=1e-8, maxiter=100, M=None):
    """Preconditioned CG on a vector or a K-major (K, n) stack; returns
    ``(x, history, iterations)`` (per-lane iterations for a stack)."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)
    lanes = b.ndim == 2

    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = _vdot(r, z)
    normr = _norm(r)
    rtol = _rtol_of(b, tol)
    history = torch.full((maxiter + 1,) + tuple(normr.shape), float("nan"),
                         dtype=b.dtype, device=b.device)
    history[0] = normr
    its = torch.zeros(normr.shape, dtype=torch.int64, device=b.device)
    it = 0
    active = normr >= rtol
    go = bool(active.any())             # one host read per iteration
    while go and it < maxiter:
        Ap = matvec(p)
        alpha = _lane(_safe_div(rz, _vdot(p, Ap)))
        x = _freeze(lanes, active, x + alpha * p, x)
        r2 = r - alpha * Ap
        normr2 = _norm(r2)
        r = _freeze(lanes, active, r2, r)
        normr = _freeze(lanes, active, normr2, normr)
        history[it + 1] = _freeze(lanes, active, normr2, history[it + 1])
        if lanes:
            its += active
        it += 1
        active_next = normr >= rtol
        go = bool(active_next.any())
        if not go or it >= maxiter:
            # the reference's last body also forms z and p, which nothing
            # returned depends on: skip that preconditioner application
            break
        z = precond(r)
        rz2 = _vdot(r, z)
        p = _freeze(lanes, active, z + _lane(_safe_div(rz2, rz)) * p, p)
        rz = _freeze(lanes, active, rz2, rz)
        active = active_next
    return x, history, (its if lanes else it)
