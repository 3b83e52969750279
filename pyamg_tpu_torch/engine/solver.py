"""Multilevel solve engine (counterpart of ``pyamg_tpu/engine/solver.py``).

The V-cycle recursion runs over the static level count; CG runs as a
Python loop bounded by ``maxiter``.  ``precision="mixed"`` runs the outer
loop in float64 (matvec with the hierarchy's ``A64``) and the cycle in
the hierarchy's float32.

Ported so far: the V-cycle (and the single-level direct solve) over both
the host-built and the device-built hierarchy, with the reference's fused
level front-ends and correction add, ``accel in (None, "cg")``,
``precision in ("native", "mixed")``.  A 2-D ``b`` of shape (n, K) solves
K right-hand sides at once on a device-built hierarchy: the lanes ride
K-major (K, n_pad) stacks through the K-lane kernels, each lane stops at
its own convergence and stays frozen after (the reference vmaps its
whole solve over the lanes, ``pyamg_tpu/engine/solver.py:289-296``).
W/F/AMLI cycles and the other Krylov methods are ROADMAP.md Queue 1 item
7; batched solves on a host-built hierarchy (K10, K12, K13) and the
interleaved lane-aligned route (K15) item 12.
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
from .krylov import _freeze, _norm, _rtol_of, device_cg

__all__ = ["DeviceMultilevelSolver", "as_device_solver"]


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


def _make_cycle(nlev, cycle):
    """The cycle recursion over ``nlev`` levels; ``cycle.zero(h, b)`` is
    the cycle from x = 0 (the preconditioner application)."""
    if cycle != "V":
        raise NotImplementedError(
            f"cycle {cycle!r} is not ported yet (ROADMAP.md Queue 1 item 7)")

    if nlev == 1:
        # single-level hierarchy: the cycle is the direct coarse solve
        def direct(h, x, b):
            return _fitv(h.coarse_solve(_fitv(b, h.nc_pad)), b.shape[-1])

        direct.zero = lambda h, b: direct(h, None, b)
        return direct

    def visit(h, i, x, b, xz=False):
        """One level visit on a vector, or on a K-major (K, n_pad) lane
        stack (every operator and smoother applies lane by lane).
        ``xz``: x is known zero, so the entry smoother takes its
        zero-guess form.  The entry front-end is the deepest fused form
        that applies: sweep + residual + scaled restrict (K5), else sweep
        + residual (K3 from zero, K4 from a nonzero x), else composed."""
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
                r = b - (lvl.A @ x)
            rc = _fitv(lvl.R @ r, h.levels[i + 1].n_pad)
        if i == nlev - 2:
            xc = h.coarse_solve(rc)
        else:
            xc = visit(h, i + 1, None, rc, xz=True)
        if hasattr(lvl.P, "apply_correction"):
            # the correction add in the SpMV's epilogue (K1 SPMV_ADD)
            x = lvl.P.apply_correction(xc, x)
        else:
            x = x + _fitv(lvl.P @ xc, x.shape[-1])
        return lvl.post(lvl.A, x, b)

    def one_cycle(h, x, b):
        return visit(h, 0, x, b)

    one_cycle.zero = lambda h, b: visit(h, 0, None, b, xz=True)
    return one_cycle


class DeviceMultilevelSolver:
    """Solve engine over a compiled DeviceHierarchy."""

    # whether ``solve`` takes an (n, K) right-hand side.  The batched
    # solve is this engine's code, but only the device-built hierarchy's
    # cycle has a K-lane kernel for every apply (the host-built one lacks
    # K10, K12 and K13), so StructuredDeviceSolver alone turns it on.
    lane_solves = False

    def __init__(self, hierarchy: DeviceHierarchy):
        self.hierarchy = hierarchy

    def _ops(self, cycle, mixed):
        """(cycle, matvec, preconditioner) of the outer loop."""
        h = self.hierarchy
        one_cycle = _make_cycle(len(h.levels), str(cycle).upper())
        if mixed:
            # A64's row padding may differ from the level's
            n_pad = h.levels[0].n_pad
            a64_pad = getattr(h.A64, "n_pad", n_pad)
            matvec = lambda v: _fitv(h.A64 @ _fitv(v, a64_pad), n_pad)
            precond = lambda r: one_cycle.zero(h, r.to(h.dtype)).to(r.dtype)
        else:
            matvec = lambda v: h.levels[0].A @ v
            precond = lambda r: one_cycle.zero(h, r)
        return one_cycle, matvec, precond

    def solve(self, b, x0=None, tol=1e-8, maxiter=100, cycle="V",
              accel=None, residuals=None, return_info=False,
              precision="native"):
        """Solve A x = b.  ``b`` (and ``x0``) may be numpy arrays or
        tensors; x comes back as a numpy array for a numpy ``b`` and as a
        tensor on the hierarchy's device for a tensor ``b``.

        precision='native' runs entirely in the hierarchy dtype; 'mixed'
        runs the outer loop in float64 with the cycle as preconditioner
        (requires compile_hierarchy(mixed_precision=True)).

        A ``b`` of shape (n, K) solves K systems at once (where
        ``lane_solves``): x has shape (n, K), ``residuals`` receives K
        per-lane history arrays, each lane stops at its own convergence,
        and ``return_info`` gives 0 only if every lane converged."""
        h = self.hierarchy
        if accel not in (None, "cg"):
            raise NotImplementedError(
                f"accel {accel!r} is not ported yet (ROADMAP.md Queue 1 "
                "item 7)")
        if precision not in ("native", "mixed"):
            raise ValueError(f"unknown precision {precision!r}")
        mixed = precision == "mixed"
        if mixed and h.A64 is None:
            raise ValueError("mixed precision requires a hierarchy compiled "
                             "with mixed_precision=True")
        lanes = np.ndim(b) == 2
        if lanes and not self.lane_solves:
            raise NotImplementedError(
                "batched (n, K) right-hand sides on a host-built hierarchy "
                "need the K-lane windowed and zero-guess kernels (K10, K12, "
                "K13), not ported yet (ROADMAP.md Queue 1 item 12)")
        if np.ndim(b) not in (1, 2):
            raise ValueError(f"b must be a vector or an (n, K) stack, got "
                             f"{np.ndim(b)} dimensions")
        n = h.levels[0].n
        n_pad = h.levels[0].n_pad
        dtype = torch.float64 if mixed else h.dtype
        tensor_out = isinstance(b, torch.Tensor)
        stage = _stage_lanes if lanes else pad_vector
        b_dev = stage(b, n_pad, dtype=dtype, device=h.device)
        x0_dev = (torch.zeros_like(b_dev) if x0 is None
                  else stage(x0, n_pad, dtype=dtype, device=h.device))
        one_cycle, matvec, precond = self._ops(cycle, mixed)

        if accel is None:
            x, history, it = self._stationary(one_cycle, matvec, b_dev,
                                              x0_dev, tol, int(maxiter),
                                              mixed)
        else:
            x, history, it = device_cg(matvec, b_dev, x0_dev, tol=tol,
                                       maxiter=int(maxiter), M=precond)
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
            normb = torch.linalg.vector_norm(b_dev, dim=-1).reshape(-1)
            converged = all(
                len(hl) >= 1 and hl[-1] < tol * max(float(nb), 1e-300)
                for hl, nb in zip(hists, normb.cpu().numpy()))
            return x, (0 if converged else int(torch.as_tensor(it).max()))
        return x

    def _stationary(self, one_cycle, matvec, b, x0, tol, maxiter, mixed):
        """accel=None: repeated cycles until the residual drops below
        tol * ||b||.  On a (K, n_pad) stack every lane runs the cycle in
        lock-step and a converged lane keeps its iterate, residual and
        history (the reference's freeze under vmap); one host read per
        cycle.  Returns (x, history, iterations) with per-lane counts for
        a stack."""
        h = self.hierarchy
        lanes = b.ndim == 2
        rtol = _rtol_of(b, tol)
        x = x0
        normr = _norm(b - matvec(x))
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
            normr2 = _norm(b - matvec(x2))
            history[it + 1] = _freeze(lanes, active, normr2, history[it + 1])
            x = _freeze(lanes, active, x2, x)
            normr = _freeze(lanes, active, normr2, normr)
            if lanes:
                its += active
            it += 1
            active = normr >= rtol
        return x, history, (its if lanes else it)

    def cycle_operator(self, cycle="V"):
        """One cycle from x = 0: r (padded) -> M r (padded)."""
        one_cycle = _make_cycle(len(self.hierarchy.levels),
                                str(cycle).upper())
        return lambda r: one_cycle.zero(self.hierarchy, r)


def as_device_solver(ml, dtype=torch.float32, device=None, row_pad=None,
                     mixed_precision=False, coarse_cutoff=None):
    """Compile a host MultilevelSolver into a DeviceMultilevelSolver on
    ``device``."""
    kwargs = {} if row_pad is None else {"row_pad": row_pad}
    return DeviceMultilevelSolver(
        compile_hierarchy(ml, dtype=dtype, device=resolve_device(device),
                          mixed_precision=mixed_precision,
                          coarse_cutoff=coarse_cutoff, **kwargs))
