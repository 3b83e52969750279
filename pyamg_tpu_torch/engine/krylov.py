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

On a row-sharded hierarchy every rank runs the same loop on its block of
the vectors; ``reduce`` sums each local partial dot over the shards (an
``all_reduce``), so every rank sees the same scalars and takes the same
branches.  Without it (``reduce=None``) the arithmetic is unchanged.
"""

from __future__ import annotations

import torch

__all__ = ["device_cg"]


def _vdot(a, b, reduce=None):
    """Inner product as elementwise multiply + sum, as the reference forms
    it (real vectors); per lane for a (K, n) stack.  ``reduce`` sums the
    local partial over the shards of a row-sharded vector."""
    s = torch.sum(a * b, dim=-1)
    return s if reduce is None else reduce(s)


def _norm(a, reduce=None):
    return torch.sqrt(_vdot(a, a, reduce))


def _rtol_of(b, tol, reduce=None):
    normb = _norm(b, reduce)
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


def device_cg(matvec, b, x0, tol=1e-8, maxiter=100, M=None, reduce=None):
    """Preconditioned CG on a vector or a K-major (K, n) stack; returns
    ``(x, history, iterations)`` (per-lane iterations for a stack).
    ``reduce``: the shard sum of the dots' local partials, for a
    row-sharded ``b`` (None: b is held whole)."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)
    lanes = b.ndim == 2

    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = _vdot(r, z, reduce)
    normr = _norm(r, reduce)
    rtol = _rtol_of(b, tol, reduce)
    history = torch.full((maxiter + 1,) + tuple(normr.shape), float("nan"),
                         dtype=b.dtype, device=b.device)
    history[0] = normr
    its = torch.zeros(normr.shape, dtype=torch.int64, device=b.device)
    it = 0
    active = normr >= rtol
    go = bool(active.any())             # one host read per iteration
    while go and it < maxiter:
        Ap = matvec(p)
        alpha = _lane(_safe_div(rz, _vdot(p, Ap, reduce)))
        x = _freeze(lanes, active, x + alpha * p, x)
        r2 = r - alpha * Ap
        normr2 = _norm(r2, reduce)
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
        rz2 = _vdot(r, z, reduce)
        p = _freeze(lanes, active, z + _lane(_safe_div(rz2, rz)) * p, p)
        rz = _freeze(lanes, active, rz2, rz)
        active = active_next
    return x, history, (its if lanes else it)
