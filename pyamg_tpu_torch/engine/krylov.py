"""Device Krylov methods (counterpart of ``pyamg_tpu/engine/krylov.py``).

Every method of the reference: CG, BiCGStab, restarted GMRES (left
preconditioned) and flexible GMRES (right preconditioned), CGNR, CGNE,
conjugate residual, minimal residual and steepest descent.  Each takes
``matvec`` / ``M`` closures over padded vectors (CGNR and CGNE also
``rmatvec``, A^T) and returns ``(x, history, iterations)``.  The
iteration is a Python loop bounded by ``maxiter``; the residual history
is a NaN-padded ``(maxiter + 1,)`` device tensor, as in the reference.
The convergence test reads one scalar per iteration back to the host
(per restart in GMRES and FGMRES, whose inner steps read none; a CUDA
graph of the iteration is later work).  Breakdown guards are the
reference's ``where`` selects on device scalars, never a host branch.

A K-major (K, n) stack of right-hand sides runs K solves in lock-step,
as the reference's solve vmapped over lanes does: the scalars are (K,)
tensors, the history is (maxiter + 1, K), and a lane that has converged
(or broken down) keeps its state (``_freeze``, the reference's per-lane
freeze) while the others iterate; the loop still reads one scalar per
iteration (``active.any()``).

On a row-sharded hierarchy every rank runs the same loop on its block of
the vectors; ``reduce`` sums each local partial dot over the shards (an
``all_reduce``), so every rank sees the same scalars and takes the same
branches.  Without it (``reduce=None``) the arithmetic is unchanged.
"""

from __future__ import annotations

import torch

__all__ = ["device_cg", "device_bicgstab", "device_fgmres", "device_gmres",
           "device_cgnr", "device_cgne", "device_cr",
           "device_minimal_residual", "device_steepest_descent"]


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
    return torch.where(den == 0, torch.zeros_like(num), num / _nonzero(den))


def _nonzero(den):
    """den, with 1 where it is 0 (the reference's ``where(den == 0, 1.0,
    den)`` guard of a division)."""
    return torch.where(den == 0, torch.ones_like(den), den)


def _lane(s):
    """A per-lane scalar (K,) as a column (K, 1) against (K, n) stacks; a
    0-d scalar as it is."""
    return s[:, None] if s.ndim == 1 else s


def _history(normr, maxiter, b):
    """The NaN-padded ``(maxiter + 1,)`` (or ``(maxiter + 1, K)``) history
    with ``normr`` at 0."""
    history = torch.full((maxiter + 1,) + tuple(normr.shape), float("nan"),
                         dtype=b.dtype, device=b.device)
    history[0] = normr
    return history


def _freeze(lanes, active, new, old):
    """``new`` where the lane is active, else ``old`` (the reference's
    ``_freeze`` under vmap).  With one right-hand side the loop only runs
    while it is active, so ``new`` is taken as it is."""
    if not lanes:
        return new
    return torch.where(_lane(active) if new.ndim == 2 else active, new, old)


def _begin(matvec, b, x0, tol, maxiter, reduce):
    """The common entry: (r, ||r||, rtol, history, per-lane counts)."""
    r = b - matvec(x0)
    normr = _norm(r, reduce)
    its = torch.zeros(normr.shape, dtype=torch.int64, device=b.device)
    return (r, normr, _rtol_of(b, tol, reduce), _history(normr, maxiter, b),
            its)


def _step(lanes, active, new, old):
    """Each of ``new`` where its lane is active, else the one of ``old``."""
    return tuple(_freeze(lanes, active, n, o) for n, o in zip(new, old))


def device_cg(matvec, b, x0, tol=1e-8, maxiter=100, M=None, reduce=None):
    """Preconditioned CG on a vector or a K-major (K, n) stack; returns
    ``(x, history, iterations)`` (per-lane iterations for a stack).
    ``reduce``: the shard sum of the dots' local partials, for a
    row-sharded ``b`` (None: b is held whole)."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)
    lanes = b.ndim == 2

    x = x0
    r, normr, rtol, history, its = _begin(matvec, b, x0, tol, maxiter,
                                          reduce)
    p = z = precond(r)
    rz = _vdot(r, z, reduce)
    it = 0
    active = normr >= rtol
    go = bool(active.any())             # one host read per iteration
    while go and it < maxiter:
        Ap = matvec(p)
        alpha = _lane(_safe_div(rz, _vdot(p, Ap, reduce)))
        r2 = r - alpha * Ap
        normr2 = _norm(r2, reduce)
        x, r, normr, history[it + 1] = _step(
            lanes, active, (x + alpha * p, r2, normr2, normr2),
            (x, r, normr, history[it + 1]))
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
        p, rz = _step(lanes, active,
                      (z + _lane(_safe_div(rz2, rz)) * p, rz2), (p, rz))
        active = active_next
    return x, history, (its if lanes else it)


def device_bicgstab(matvec, b, x0, tol=1e-8, maxiter=100, M=None,
                    reduce=None):
    """Preconditioned BiCGStab on a vector or a K-major (K, n) stack (the
    reference's ``device_bicgstab``).  A lane stops at convergence or at a
    breakdown (a zero denominator, the reference's ``bad1 | bad2 |
    bad3``); the step that breaks down leaves x and r as they were."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)
    lanes = b.ndim == 2

    x = x0
    r, normr, rtol, history, its = _begin(matvec, b, x0, tol, maxiter,
                                          reduce)
    rstar = p = r
    rrstar = _vdot(rstar, r, reduce)
    breakdown = torch.zeros_like(normr, dtype=torch.bool)
    it = 0
    active = normr >= rtol
    while it < maxiter and bool(active.any()):  # one host read an iteration
        Mp = precond(p)
        AMp = matvec(Mp)
        denom = _vdot(rstar, AMp, reduce)
        bad1 = denom == 0
        alpha = rrstar / _nonzero(denom)
        s = r - _lane(alpha) * AMp
        Ms = precond(s)
        AMs = matvec(Ms)
        denom2 = _vdot(AMs, AMs, reduce)
        bad2 = denom2 == 0
        omega = _vdot(AMs, s, reduce) / _nonzero(denom2)
        bad = bad1 | bad2
        x2 = x + _lane((~bad).to(x.dtype)) * (_lane(alpha) * Mp
                                              + _lane(omega) * Ms)
        r2 = torch.where(_lane(bad), r, s - _lane(omega) * AMs)
        normr2 = _norm(r2, reduce)
        rrstar2 = _vdot(rstar, r2, reduce)
        bad3 = (rrstar == 0) | (omega == 0)
        beta = (rrstar2 / _nonzero(rrstar)) * (alpha / _nonzero(omega))
        beta = torch.where(bad3, torch.zeros_like(beta), beta)
        p2 = r2 + _lane(beta) * (p - _lane(omega) * AMp)
        x, r, p, rrstar, normr, history[it + 1], breakdown = _step(
            lanes, active,
            (x2, r2, p2, rrstar2, normr2, normr2, bad | bad3),
            (x, r, p, rrstar, normr, history[it + 1], breakdown))
        if lanes:
            its += active
        it += 1
        active = (normr >= rtol) & ~breakdown
    return x, history, (its if lanes else it)


def _proj(V, w, reduce):
    """The basis rows' dots with w: (..., j, n) x (..., n) -> (..., j)."""
    h = torch.matmul(V, w.unsqueeze(-1)).squeeze(-1)
    return h if reduce is None else reduce(h)


def _comb(c, V):
    """sum_i c_i V_i: (..., j) x (..., j, n) -> (..., n)."""
    return torch.matmul(c.unsqueeze(-2), V).squeeze(-2)


def _restart(matvec, precond, z, beta, x, m, flexible, rtol, history, it,
             active, reduce):
    """One restart cycle of GMRES (``flexible``: FGMRES) from the residual
    ``z`` (preconditioned for GMRES) of norm ``beta``: all ``m`` inner
    steps run, as the reference's fori_loop does; the history entries
    ``it + 1 ..`` take the Givens estimates of the lanes that are
    ``active`` and not yet below ``rtol`` (written in place).  Returns the
    new x and the last estimate (frozen once below ``rtol``)."""
    lead, n, dtype = z.shape[:-1], z.shape[-1], z.dtype
    maxiter = history.shape[0] - 1
    V = torch.zeros(lead + (m + 1, n), dtype=dtype, device=z.device)
    V[..., 0, :] = z / _lane(_nonzero(beta))
    Z = (torch.zeros(lead + (m, n), dtype=dtype, device=z.device)
         if flexible else None)
    H = torch.zeros(lead + (m + 1, m), dtype=dtype, device=z.device)
    cs = torch.zeros(lead + (m,), dtype=dtype, device=z.device)
    sn = torch.zeros_like(cs)
    g = torch.zeros(lead + (m + 1,), dtype=dtype, device=z.device)
    g[..., 0] = beta
    normr = beta
    for j in range(m):
        vj = V[..., j, :].contiguous()     # a lane stack's rows are strided
        if flexible:
            zj = precond(vj)
            Z[..., j, :] = zj
            w = matvec(zj)
        else:
            w = precond(matvec(vj))
        # CGS2 against the j + 1 basis vectors so far (the rows past them
        # are zero, which the reference masks)
        Vj = V[..., :j + 1, :]
        h1 = _proj(Vj, w, reduce)
        w = w - _comb(h1, Vj)
        h2 = _proj(Vj, w, reduce)
        w = w - _comb(h2, Vj)
        wnorm = _norm(w, reduce)
        hcol = torch.zeros(lead + (m + 1,), dtype=dtype, device=z.device)
        hcol[..., :j + 1] = h1 + h2
        hcol[..., j + 1] = wnorm
        for i in range(j):                 # the earlier Givens rotations
            a, c = hcol[..., i], hcol[..., i + 1]
            t = cs[..., i] * a + sn[..., i] * c
            hcol[..., i + 1] = -sn[..., i] * a + cs[..., i] * c
            hcol[..., i] = t
        hj, hj1 = hcol[..., j].clone(), hcol[..., j + 1].clone()
        denom = torch.sqrt(hj ** 2 + hj1 ** 2)
        safe = denom > 0
        ds = torch.where(safe, denom, torch.ones_like(denom))
        c = torch.where(safe, hj / ds, torch.ones_like(hj))
        s = torch.where(safe, hj1 / ds, torch.zeros_like(hj1))
        cs[..., j] = c
        sn[..., j] = s
        hcol[..., j] = c * hj + s * hj1
        hcol[..., j + 1] = 0
        H[..., :, j] = hcol
        gj1 = -s * g[..., j]
        g[..., j + 1] = gj1
        g[..., j] = c * g[..., j]
        normr_new = torch.abs(gj1)
        below = normr >= rtol
        if it + j + 1 <= maxiter:
            history[it + j + 1] = torch.where(below & active, normr_new,
                                              history[it + j + 1])
        normr = torch.where(below, normr_new, normr)
        nz = wnorm > 0
        V[..., j + 1, :] = torch.where(
            _lane(nz), w / _lane(torch.where(nz, wnorm,
                                             torch.ones_like(wnorm))), 0)
    # back substitution on the triangular H (a zero diagonal entry, the
    # tail after a breakdown, solves as 1 against a zero right side)
    Hm = H[..., :m, :m]
    nzd = torch.diagonal(Hm, dim1=-2, dim2=-1).abs() > 0
    Hm = Hm + torch.diag_embed((~nzd).to(dtype))
    g_eff = torch.where(nzd, g[..., :m], torch.zeros_like(g[..., :m]))
    y = torch.linalg.solve_triangular(Hm, g_eff.unsqueeze(-1),
                                      upper=True).squeeze(-1)
    return x + _comb(y, Z if flexible else V[..., :m, :]), normr


def _gmres(matvec, b, x0, tol, maxiter, M, restart, flexible, reduce):
    maxiter = int(maxiter)
    m = int(min(restart, maxiter))
    max_outer = -(-maxiter // m)
    precond = M if M is not None else (lambda v: v)
    lanes = b.ndim == 2

    if flexible:
        rtol = _rtol_of(b, tol, reduce)
        residual = lambda x: b - matvec(x)             # noqa: E731
    else:
        rtol = _rtol_of(precond(b), tol, reduce)
        residual = lambda x: precond(b - matvec(x))    # noqa: E731
    x = x0
    z = residual(x0)
    normr = _norm(z, reduce)
    history = _history(normr, maxiter, b)
    its = torch.zeros(normr.shape, dtype=torch.int64, device=b.device)
    it = outer = 0
    active = normr >= rtol
    while outer < max_outer and bool(active.any()):  # one read a restart
        if outer:
            z = residual(x)
        beta = _norm(z, reduce)
        x2, normr2 = _restart(matvec, precond, z, beta, x, m, flexible,
                              rtol, history, it, active, reduce)
        x, normr = _step(lanes, active, (x2, normr2), (x, normr))
        if lanes:
            its += m * active
        it += m
        outer += 1
        active = normr >= rtol
    return x, history, (its.clamp(max=maxiter) if lanes
                        else min(it, maxiter))


def device_fgmres(matvec, b, x0, tol=1e-8, maxiter=100, M=None, restart=30,
                  reduce=None):
    """Right-preconditioned flexible GMRES(restart) on a vector or a
    K-major (K, n) stack (the reference's ``device_fgmres``):
    orthogonalisation by CGS2 (two projections on the basis per step,
    dense products), Givens rotations held on the device per lane.  Every
    restart runs all its inner steps; the history holds the Givens
    estimates of the true residual, frozen once below ``tol * ||b||``;
    the count grows by the restart length per restart and is capped at
    ``maxiter``.  The (m + 1, n) basis (and the (m, n) preconditioned
    one) live on the device: 31 float64 vectors of n."""
    return _gmres(matvec, b, x0, tol, maxiter, M, restart, True, reduce)


def device_gmres(matvec, b, x0, tol=1e-8, maxiter=100, M=None, restart=30,
                 reduce=None):
    """Left-preconditioned restarted GMRES (the reference's
    ``device_gmres``, the host ``gmres_mgs`` semantics): the Krylov space
    is built on M A, the history holds the Givens estimates of the
    preconditioned residual norm, and rtol is ``tol * ||M b||``.
    Otherwise as :func:`device_fgmres`."""
    return _gmres(matvec, b, x0, tol, maxiter, M, restart, False, reduce)


def device_cgnr(matvec, rmatvec, b, x0, tol=1e-8, maxiter=100, M=None,
                reduce=None):
    """CG on the normal equations A^T A x = A^T b (the reference's
    ``device_cgnr``); ``rmatvec`` applies A^T."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)
    lanes = b.ndim == 2

    x = x0
    r, normr, rtol, history, its = _begin(matvec, b, x0, tol, maxiter,
                                          reduce)
    p = z = rmatvec(precond(r))
    zz = _vdot(z, z, reduce)
    it = 0
    active = normr >= rtol
    go = bool(active.any())             # one host read per iteration
    while go and it < maxiter:
        Ap = matvec(p)
        alpha = _lane(_safe_div(zz, _vdot(Ap, Ap, reduce)))
        r2 = r - alpha * Ap
        normr2 = _norm(r2, reduce)
        x, r, normr, history[it + 1] = _step(
            lanes, active, (x + alpha * p, r2, normr2, normr2),
            (x, r, normr, history[it + 1]))
        if lanes:
            its += active
        it += 1
        active_next = normr >= rtol
        go = bool(active_next.any())
        if not go or it >= maxiter:
            break   # the last body's p and zz: nothing returned needs them
        z = rmatvec(precond(r))
        zz2 = _vdot(z, z, reduce)
        p, zz = _step(lanes, active,
                      (z + _lane(_safe_div(zz2, zz)) * p, zz2), (p, zz))
        active = active_next
    return x, history, (its if lanes else it)


def device_cgne(matvec, rmatvec, b, x0, tol=1e-8, maxiter=100, M=None,
                reduce=None):
    """CG on A A^T y = b, x = A^T y (the reference's ``device_cgne``);
    ``rmatvec`` applies A^T."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)
    lanes = b.ndim == 2

    x = x0
    r, normr, rtol, history, its = _begin(matvec, b, x0, tol, maxiter,
                                          reduce)
    z = precond(r)
    p = rmatvec(z)
    rz = _vdot(r, z, reduce)
    it = 0
    active = normr >= rtol
    go = bool(active.any())             # one host read per iteration
    while go and it < maxiter:
        alpha = _lane(_safe_div(rz, _vdot(p, p, reduce)))
        r2 = r - alpha * matvec(p)
        normr2 = _norm(r2, reduce)
        x, r, normr, history[it + 1] = _step(
            lanes, active, (x + alpha * p, r2, normr2, normr2),
            (x, r, normr, history[it + 1]))
        if lanes:
            its += active
        it += 1
        active_next = normr >= rtol
        go = bool(active_next.any())
        if not go or it >= maxiter:
            break   # the last body's p and rz: nothing returned needs them
        z = precond(r)
        rz2 = _vdot(r, z, reduce)
        p, rz = _step(lanes, active,
                      (rmatvec(z) + _lane(_safe_div(rz2, rz)) * p, rz2),
                      (p, rz))
        active = active_next
    return x, history, (its if lanes else it)


def device_cr(matvec, b, x0, tol=1e-8, maxiter=100, M=None, reduce=None):
    """Conjugate residual for symmetric (possibly indefinite) systems (the
    reference's ``device_cr``)."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)
    lanes = b.ndim == 2

    x = x0
    r, normr, rtol, history, its = _begin(matvec, b, x0, tol, maxiter,
                                          reduce)
    p = z = precond(r)
    Ap = Az = matvec(z)
    rAz = _vdot(z, Az, reduce)
    it = 0
    active = normr >= rtol
    go = bool(active.any())             # one host read per iteration
    while go and it < maxiter:
        MAp = precond(Ap)
        alpha = _lane(_safe_div(rAz, _vdot(Ap, MAp, reduce)))
        r2 = r - alpha * Ap
        normr2 = _norm(r2, reduce)
        x, r, normr, history[it + 1] = _step(
            lanes, active, (x + alpha * p, r2, normr2, normr2),
            (x, r, normr, history[it + 1]))
        if lanes:
            its += active
        it += 1
        active_next = normr >= rtol
        go = bool(active_next.any())
        if not go or it >= maxiter:
            break   # the last body's z, p, Ap: nothing returned needs them
        z = precond(r)
        Az = matvec(z)
        rAz2 = _vdot(z, Az, reduce)
        beta = _lane(_safe_div(rAz2, rAz))
        p, Ap, rAz = _step(lanes, active,
                           (z + beta * p, Az + beta * Ap, rAz2),
                           (p, Ap, rAz))
        active = active_next
    return x, history, (its if lanes else it)


def _one_dimensional(matvec, b, x0, tol, maxiter, M, reduce, steepest):
    """Minimal residual (``steepest`` False) or steepest descent: one
    search direction z = M r a step, the step length minimising the
    residual norm, or the energy norm of the error."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)
    lanes = b.ndim == 2

    x = x0
    r, normr, rtol, history, its = _begin(matvec, b, x0, tol, maxiter,
                                          reduce)
    it = 0
    active = normr >= rtol
    while it < maxiter and bool(active.any()):  # one host read an iteration
        z = precond(r)
        Az = matvec(z)
        if steepest:
            num, den = _vdot(r, z, reduce), _vdot(z, Az, reduce)
        else:
            num, den = _vdot(Az, r, reduce), _vdot(Az, Az, reduce)
        alpha = _lane(_safe_div(num, den))
        r2 = r - alpha * Az
        normr2 = _norm(r2, reduce)
        x, r, normr, history[it + 1] = _step(
            lanes, active, (x + alpha * z, r2, normr2, normr2),
            (x, r, normr, history[it + 1]))
        if lanes:
            its += active
        it += 1
        active = normr >= rtol
    return x, history, (its if lanes else it)


def device_minimal_residual(matvec, b, x0, tol=1e-8, maxiter=100, M=None,
                            reduce=None):
    """The one-dimensional residual-minimising iteration (the reference's
    ``device_minimal_residual``)."""
    return _one_dimensional(matvec, b, x0, tol, maxiter, M, reduce, False)


def device_steepest_descent(matvec, b, x0, tol=1e-8, maxiter=100, M=None,
                            reduce=None):
    """Energy-minimising steepest descent for SPD systems (the reference's
    ``device_steepest_descent``)."""
    return _one_dimensional(matvec, b, x0, tol, maxiter, M, reduce, True)
