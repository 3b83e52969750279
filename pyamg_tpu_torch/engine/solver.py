"""Multilevel solve engine (counterpart of ``pyamg_tpu/engine/solver.py``).

The cycle recursion (V, W, F, AMLI) runs over the static level count;
the Krylov methods run as Python loops bounded by ``maxiter``.
``precision="mixed"`` runs the outer loop in float64 (matvec with the
hierarchy's ``A64``) and the cycle in the hierarchy's float32.

Over both the host-built and the device-built hierarchy: every cycle of
the reference, with its fused level front-ends and correction add, and
every ``accel`` of ``_get_compiled`` (``pyamg_tpu/engine/solver.py:256-298``),
``precision in ("native", "mixed")``.  A 2-D ``b`` of shape (n, K) solves
K right-hand sides at once on either hierarchy: the lanes ride K-major
(K, n_pad) stacks through the K-lane kernels (K8-K13), each lane stops at
its own convergence and stays frozen after (the reference vmaps its
whole solve over the lanes, ``pyamg_tpu/engine/solver.py:289-296``).  A
batched native float32 V-cycle CG from x0 = 0 on a hierarchy that
:func:`~pyamg_tpu_torch.engine.batched_cycle.supports_interleaved` admits
(a lane-aligned device-built one) takes the reference's interleaved route
instead (:func:`~pyamg_tpu_torch.engine.batched_cycle.interleaved_batched_cg`,
K15; ``pyamg_tpu/engine/solver.py:355-385``).

A row-sharded hierarchy (:func:`~pyamg_tpu_torch.parallel.shard_hierarchy`),
host-built, unstructured or device-built, solves on every rank at once:
each rank stages its block of ``b`` (of every column of an (n, K) ``b``,
as a K-major (K, n_local) lane stack), the cycle runs on the blocks (each
sharded operator communicates, one message a side for all lanes; the
transfers apply factor by factor, the Jacobi sweeps compose through ``A @
x``, a block level's residual is one B1 halo ``RESID`` pass), and the
Krylov dots sum over the shards (AMLI's coarse dots over the level's
shards), so every rank takes the same per-lane branches.  CGNR / CGNE
apply A^T through the sharded operator's ``rmatvec``.  A sharded batched
solve takes the K-major lane route, never the interleaved one (the
reference's rule).  Mixed precision on a sharded hierarchy raises: it
carries no ``A64``, as the reference's does not.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..backend import resolve_device
from ..sparse.dia import DIAMatrix, dia_zero_chain, dia_zero_chain_k
from ..sparse.formats import fit as _fitv
from ..sparse.formats import pad_vector
from .hierarchy import DeviceHierarchy, compile_hierarchy
from .relaxation import residual
from .krylov import (_freeze, _lane, _norm, _rtol_of, _safe_div, _vdot,
                     device_bicgstab, device_cg, device_cgne, device_cgnr,
                     device_cr, device_fgmres, device_gmres,
                     device_minimal_residual, device_steepest_descent)

__all__ = ["DeviceMultilevelSolver", "as_device_solver"]

# accel -> the Krylov method taking (matvec, b, x0, tol, maxiter, M)
_KRYLOV = {"cg": device_cg, "bicgstab": device_bicgstab, "cr": device_cr,
           "minimal_residual": device_minimal_residual,
           "steepest_descent": device_steepest_descent}
ACCELS = (None, *_KRYLOV, "gmres", "fgmres", "cgnr", "cgne")


def _stage_lanes(b, n_pad, dtype, device):
    """An (n, K) column stack (numpy or tensor) as the K-major (K, n_pad)
    lane stack of the batched solve, zero-padded, on ``device``."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b), dtype=dtype, device=device)
    b = b.to(dtype=dtype, device=device)
    return F.pad(b.T, (0, n_pad - b.shape[0])).contiguous()


def _fused_zero_entry_chain(lvl, b):
    """The zero-entry level front-end in one kernel pass (K5,
    :func:`~pyamg_tpu_torch.sparse.dia.dia_zero_chain`, or K11,
    :func:`~pyamg_tpu_torch.sparse.dia.dia_zero_chain_k`, for a K-major
    lane stack b):

        x = pre.zero_call(A, b);  y = tv * (St @ (b - A @ x))

    then the restrictor's block sum.  Returns (x, unpadded rc), or None
    when the level has no factored StructuredRestrictor with a
    solve-padded tv, or its pre-smoother is not a single Jacobi sweep on
    a DIA operator (the caller composes)."""
    R = lvl.R
    St = getattr(R, "St", None)
    tv = getattr(R, "tv", None)
    finish = getattr(R, "_finish", None)
    if St is None or tv is None or finish is None:
        return None
    if not isinstance(St, DIAMatrix) or not isinstance(lvl.A, DIAMatrix):
        return None
    jac = lvl.pre._jacobi()
    if jac is None:
        return None
    dinv, omega, iters = jac
    if (iters != 1 or dinv.shape[0] != b.shape[-1]
            or tv.shape[0] != St.n_pad or St.n_pad != b.shape[-1]):
        return None
    chain = dia_zero_chain_k if b.ndim == 2 else dia_zero_chain
    x, y = chain(lvl.A, St, b, dinv, tv, omega)
    return x, finish(y)


CYCLES = ("V", "W", "F", "AMLI")


def _level_reduce(h, i):
    """The shard sum of level ``i``'s local partial dots on a row-sharded
    hierarchy; None for one held whole."""
    red = getattr(h, "reduce_level", None)
    return None if red is None else (lambda s: red(s, i))


def _make_cycle(nlev, cycle, amli_depth=2):
    """The cycle recursion over ``nlev`` levels; ``cycle.zero(h, b)`` is
    the cycle from x = 0 (the preconditioner application).  ``cycle``:
    "V"; "W" (two visits to each coarser level, the second from the
    first's result); "F" (an F visit from zero, then a V visit); "AMLI"
    (``amli_depth`` A_c-orthogonalised coarse corrections a visit).  The
    pair of coarsest levels calls the coarse solve directly for every
    kind, so W, F and AMLI are V on a hierarchy of two levels.  An unknown
    kind raises ValueError here, whatever the depth."""
    if cycle not in CYCLES:
        raise ValueError(f"unsupported device cycle {cycle!r} (one of "
                         f"{', '.join(CYCLES)})")

    if nlev == 1:
        # single-level hierarchy: the cycle is the direct coarse solve
        def direct(h, x, b):
            return _fitv(h.coarse_solve(_fitv(b, h.nc_pad)), b.shape[-1])

        direct.zero = lambda h, b: direct(h, None, b)
        return direct

    def amli(h, i, rc):
        """AMLI's coarse correction at level ``i + 1``: ``amli_depth``
        cycles from zero on the running residual, each A_c-orthogonalised
        against the one before (the reference's ``denom == 0`` guards as
        selects, per lane on a stack; no host read)."""
        Ac = h.levels[i + 1].A
        reduce = _level_reduce(h, i + 1)
        xc = torch.zeros_like(rc)
        p_prev = Ap_prev = None
        for _ in range(max(int(amli_depth), 1)):
            p = visit(h, i + 1, None, rc, "AMLI", xz=True)
            if p_prev is not None:
                beta = _safe_div(_vdot(p_prev, Ac @ p, reduce),
                                 _vdot(p_prev, Ap_prev, reduce))
                p = p - _lane(beta) * p_prev
            Ap = Ac @ p
            alpha = _lane(_safe_div(_vdot(p, rc, reduce),
                                    _vdot(p, Ap, reduce)))
            xc = xc + alpha * p
            rc = rc - alpha * Ap
            p_prev, Ap_prev = p, Ap
        return xc

    def visit(h, i, x, b, kind, xz=False):
        """One level visit on a vector, or on a K-major (K, n_pad) lane
        stack (every operator and smoother applies lane by lane).
        ``xz``: x is known zero, so the entry smoother takes its
        zero-guess form.  The entry front-end is the deepest fused form
        that applies: sweep + residual + scaled restrict (K5), else sweep
        + residual (K3 from zero, K4 from a nonzero x: a W or F visit's
        second; B2 ``ZERO_RES`` from zero on a block-DIA level), else
        composed (the residual one B1 ``RESID`` pass on a block-DIA
        level)."""
        lvl = h.levels[i]
        chain = _fused_zero_entry_chain(lvl, b) if xz else None
        if chain is not None:
            x, rc_raw = chain
            rc = _fitv(rc_raw, h.levels[i + 1].n_pad)
        else:
            fused = (lvl.pre.zero_call_residual(lvl.A, b) if xz
                     else lvl.pre.call_residual(lvl.A, x, b))
            if fused is not None:
                x, r = fused
            else:
                x = lvl.pre.zero_call(lvl.A, b) if xz else lvl.pre(lvl.A, x, b)
                r = residual(lvl.A, x, b)
            rc = _fitv(lvl.R @ r, h.levels[i + 1].n_pad)
        if i == nlev - 2:
            xc = h.coarse_solve(rc)
        elif kind == "AMLI":
            xc = amli(h, i, rc)
        else:
            xc = visit(h, i + 1, None, rc, kind, xz=True)
            if kind != "V":
                # W: the same kind again, F: a V visit, from xc
                xc = visit(h, i + 1, xc, rc, "W" if kind == "W" else "V")
        if hasattr(lvl.P, "apply_correction"):
            # the correction add in the SpMV's epilogue (K1 SPMV_ADD)
            x = lvl.P.apply_correction(xc, x)
        else:
            x = x + _fitv(lvl.P @ xc, x.shape[-1])
        return lvl.post(lvl.A, x, b)

    def one_cycle(h, x, b):
        return visit(h, 0, x, b, cycle)

    one_cycle.zero = lambda h, b: visit(h, 0, None, b, cycle, xz=True)
    return one_cycle


class DeviceMultilevelSolver:
    """Solve engine over a compiled DeviceHierarchy."""

    def __init__(self, hierarchy: DeviceHierarchy):
        self.hierarchy = hierarchy

    def _ops(self, cycle, mixed, amli_depth=2):
        """(cycle, matvec, rmatvec, preconditioner) of the outer loop;
        in the mixed loop the applies of A and A^T run in float64 through
        ``A64``."""
        h = self.hierarchy
        one_cycle = _make_cycle(len(h.levels), str(cycle).upper(),
                                amli_depth)
        if mixed:
            # A64's row padding may differ from the level's
            n_pad = h.levels[0].n_pad
            a64_pad = getattr(h.A64, "n_pad", n_pad)
            matvec = lambda v: _fitv(h.A64 @ _fitv(v, a64_pad), n_pad)
            rmatvec = lambda v: _fitv(h.A64.rmatvec(_fitv(v, a64_pad)),
                                      n_pad)
            precond = lambda r: one_cycle.zero(h, r.to(h.dtype)).to(r.dtype)
        else:
            A = h.levels[0].A
            matvec = lambda v: A @ v
            rmatvec = lambda v: _fitv(A.rmatvec(v), v.shape[-1])
            precond = lambda r: one_cycle.zero(h, r)
        return one_cycle, matvec, rmatvec, precond

    def solve(self, b, x0=None, tol=1e-8, maxiter=100, cycle="V",
              accel=None, residuals=None, return_info=False, restart=30,
              precision="native", amli_depth=2):
        """Solve A x = b.  ``b`` (and ``x0``) may be numpy arrays or
        tensors; x comes back as a numpy array for a numpy ``b`` and as a
        tensor on the hierarchy's device for a tensor ``b``.

        ``cycle``: "V", "W", "F" or "AMLI" (``amli_depth`` coarse
        corrections a visit).  ``accel``: None (repeated cycles), "cg",
        "bicgstab", "cr", "minimal_residual", "steepest_descent", "gmres"
        (left preconditioned) or "fgmres" (flexible, right preconditioned),
        both restarted every ``restart`` steps, or "cgnr" / "cgne" (the
        normal equations, through A^T).

        On a row-sharded hierarchy every rank calls this with the full
        ``b`` (and ``x0``) and stages its own block: a numpy ``b`` gives
        the full x, gathered, on every rank ((n, K) for an (n, K) ``b``);
        a tensor ``b`` gives this rank's padded block of x (``hierarchy.
        gather`` assembles it), (n_local, K) for lanes.

        precision='native' runs entirely in the hierarchy dtype; 'mixed'
        runs the outer loop in float64 with the cycle as preconditioner
        (requires compile_hierarchy(mixed_precision=True)).

        A ``b`` of shape (n, K) solves K systems at once: x has shape
        (n, K), ``residuals`` receives K per-lane history arrays, each lane
        stops at its own convergence, and ``return_info`` gives 0 only if
        every lane converged.  A native float32 V-cycle CG from x0 = 0 on
        a hierarchy that ``supports_interleaved`` runs the interleaved
        route (the reference's semantics: convergence checked every 4
        iterations, info ``maxiter`` when a lane did not converge)."""
        h = self.hierarchy
        if accel not in ACCELS:
            raise ValueError(f"unsupported device accelerator {accel!r}")
        if precision not in ("native", "mixed"):
            raise ValueError(f"unknown precision {precision!r}")
        mixed = precision == "mixed"
        sharded = getattr(h, "mesh", None) is not None
        if mixed and sharded:
            raise ValueError(
                "a row-sharded hierarchy carries no A64 (as the reference's, "
                "which cannot run it either), so mixed precision on it is "
                "not ported (ROADMAP.md Queue 1 item 14)")
        if mixed and h.A64 is None:
            raise ValueError("mixed precision requires a hierarchy compiled "
                             "with mixed_precision=True")
        lanes = np.ndim(b) == 2
        if np.ndim(b) not in (1, 2):
            raise ValueError(f"b must be a vector or an (n, K) stack, got "
                             f"{np.ndim(b)} dimensions")
        n = h.levels[0].n
        n_pad = h.levels[0].n_pad
        dtype = torch.float64 if mixed else h.dtype
        tensor_out = isinstance(b, torch.Tensor)

        def stage(v):
            if sharded:
                return h.stage(v, dtype)
            return (_stage_lanes if lanes else pad_vector)(
                v, n_pad, dtype=dtype, device=h.device)

        b_dev = stage(b)
        if (lanes and accel == "cg" and not mixed and x0 is None
                and str(cycle).upper() == "V" and dtype == torch.float32):
            # imported here: batched_cycle builds on this module
            from .batched_cycle import (interleaved_batched_cg,
                                        supports_interleaved)
            if supports_interleaved(h):
                x, history = interleaved_batched_cg(h, b_dev, tol=tol,
                                                    maxiter=int(maxiter))
                return self._finish(x, history, b_dev, n, tol, tensor_out,
                                    True, residuals, return_info,
                                    int(maxiter))
        x0_dev = torch.zeros_like(b_dev) if x0 is None else stage(x0)
        one_cycle, matvec, rmatvec, precond = self._ops(cycle, mixed,
                                                        amli_depth)
        reduce = h.reduce if sharded else None
        kw = dict(tol=tol, maxiter=int(maxiter), M=precond, reduce=reduce)

        if accel is None:
            x, history, it = self._stationary(one_cycle, matvec, b_dev,
                                              x0_dev, tol, int(maxiter),
                                              mixed, reduce)
        elif accel in ("gmres", "fgmres"):
            fn = device_gmres if accel == "gmres" else device_fgmres
            x, history, it = fn(matvec, b_dev, x0_dev, restart=int(restart),
                                **kw)
        elif accel in ("cgnr", "cgne"):
            fn = device_cgnr if accel == "cgnr" else device_cgne
            x, history, it = fn(matvec, rmatvec, b_dev, x0_dev, **kw)
        else:
            x, history, it = _KRYLOV[accel](matvec, b_dev, x0_dev, **kw)
        if sharded and not tensor_out:
            x = h.gather(x)
        return self._finish(x, history, b_dev, n, tol, tensor_out, lanes,
                            residuals, return_info,
                            int(torch.as_tensor(it).max()), reduce,
                            sharded and tensor_out)

    @staticmethod
    def _finish(x, history, b_dev, n, tol, tensor_out, lanes, residuals,
                return_info, it, reduce=None, block=False):
        """Unpad x (and turn a (K, n_pad) stack into (n, K) columns), fill
        ``residuals`` with the NaN-free history (one array per lane), and
        give the info: 0 when every lane's last residual is below
        tol * ||b||, else ``it``.  ``block``: x is a rank's block of a
        sharded solution, returned padded as it is; ``reduce`` sums the
        norm of such a block's ``b`` over the shards."""
        if not block:
            x = x[..., :n]
        if lanes:
            x = x.T
        if not tensor_out:
            x = x.cpu().numpy()
        hist = history.cpu().numpy()
        hists = ([hl[~np.isnan(hl)] for hl in hist.T] if lanes
                 else [hist[~np.isnan(hist)]])
        if residuals is not None:
            residuals[:] = hists if lanes else list(hists[0])
        if return_info:
            normb = (torch.linalg.vector_norm(b_dev, dim=-1) if reduce is None
                     else _norm(b_dev, reduce)).reshape(-1)
            converged = all(
                len(hl) >= 1 and hl[-1] < tol * max(float(nb), 1e-300)
                for hl, nb in zip(hists, normb.cpu().numpy()))
            return x, (0 if converged else it)
        return x

    def _stationary(self, one_cycle, matvec, b, x0, tol, maxiter, mixed,
                    reduce=None):
        """accel=None: repeated cycles until the residual drops below
        tol * ||b||.  On a (K, n_pad) stack every lane runs the cycle in
        lock-step and a converged lane keeps its iterate, residual and
        history (the reference's freeze under vmap); one host read per
        cycle.  Returns (x, history, iterations) with per-lane counts for
        a stack.  ``reduce``: the shard sum of a sharded solve's norms."""
        h = self.hierarchy
        lanes = b.ndim == 2
        rtol = _rtol_of(b, tol, reduce)
        x = x0
        normr = _norm(b - matvec(x), reduce)
        history = torch.full((maxiter + 1,) + tuple(normr.shape),
                             float("nan"), dtype=b.dtype, device=b.device)
        history[0] = normr
        its = torch.zeros(normr.shape, dtype=torch.int64, device=b.device)
        active = normr >= rtol
        it = 0
        while it < maxiter and bool(active.any()):
            if mixed:
                corr = one_cycle.zero(h, (b - matvec(x)).to(h.dtype))
                x2 = x + corr.to(x.dtype)
            else:
                x2 = one_cycle(h, x, b)
            normr2 = _norm(b - matvec(x2), reduce)
            history[it + 1] = _freeze(lanes, active, normr2, history[it + 1])
            x = _freeze(lanes, active, x2, x)
            normr = _freeze(lanes, active, normr2, normr)
            if lanes:
                its += active
            it += 1
            active = normr >= rtol
        return x, history, (its if lanes else it)

    def cycle_operator(self, cycle="V", amli_depth=2):
        """One cycle from x = 0: r (padded) -> M r (padded)."""
        one_cycle = _make_cycle(len(self.hierarchy.levels),
                                str(cycle).upper(), amli_depth)
        return lambda r: one_cycle.zero(self.hierarchy, r)

    def aspreconditioner(self, cycle="V"):
        """A scipy ``LinearOperator`` (float64 on the host side) that
        applies one cycle from zero on the hierarchy's device, in its
        dtype: the bridge to a host Krylov loop.  On a row-sharded
        hierarchy every rank applies it to the full vector together."""
        from scipy.sparse.linalg import LinearOperator

        h = self.hierarchy
        n = h.levels[0].n
        cyc = self.cycle_operator(cycle)
        sharded = getattr(h, "mesh", None) is not None

        def matvec(r):
            r = np.asarray(r)
            if sharded:
                y = h.gather(cyc(h.stage(r.ravel(), h.dtype)))
            else:
                y = cyc(pad_vector(r.ravel(), h.levels[0].n_pad,
                                   dtype=h.dtype, device=h.device))
            return y[:n].cpu().numpy().astype(r.dtype)

        return LinearOperator((n, n), matvec=matvec, dtype=np.float64)


def as_device_solver(ml, dtype=torch.float32, device=None, row_pad=None,
                     mixed_precision=False, coarse_cutoff=None):
    """Compile a host MultilevelSolver into a DeviceMultilevelSolver on
    ``device``."""
    kwargs = {} if row_pad is None else {"row_pad": row_pad}
    return DeviceMultilevelSolver(
        compile_hierarchy(ml, dtype=dtype, device=resolve_device(device),
                          mixed_precision=mixed_precision,
                          coarse_cutoff=coarse_cutoff, **kwargs))
