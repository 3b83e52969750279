"""Multilevel solve engine (counterpart of ``pyamg_tpu/engine/solver.py``).

The V-cycle recursion runs over the static level count; CG runs as a
Python loop bounded by ``maxiter``.  ``precision="mixed"`` runs the outer
loop in float64 (matvec with the hierarchy's ``A64``) and the cycle in
the hierarchy's float32.

Ported so far: the V-cycle (and the single-level direct solve) over both
the host-built and the device-built hierarchy, with the reference's fused
level front-ends and correction add, ``accel in (None, "cg")``,
``precision in ("native", "mixed")``, 1-D right-hand sides.  W/F/AMLI
cycles and the other Krylov methods are ROADMAP.md Queue 1 item 7;
batched right-hand sides item 12.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device
from ..sparse.dia import DIAMatrix, dia_zero_chain
from ..sparse.formats import fit as _fitv
from ..sparse.formats import pad_vector
from .hierarchy import DeviceHierarchy, compile_hierarchy
from .krylov import _norm, _rtol_of, device_cg

__all__ = ["DeviceMultilevelSolver", "as_device_solver"]


def _fused_zero_entry_chain(lvl, b):
    """The zero-entry level front-end in one kernel pass (K5,
    :func:`~pyamg_tpu_torch.sparse.dia.dia_zero_chain`):

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
    if (iters != 1 or dinv.shape != b.shape
            or tv.shape[0] != St.n_pad or St.n_pad != b.shape[0]):
        return None
    x, y = dia_zero_chain(lvl.A, St, b, dinv, tv, omega)
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
            return _fitv(h.coarse_solve(_fitv(b, h.nc_pad)), b.shape[0])

        direct.zero = lambda h, b: direct(h, None, b)
        return direct

    def visit(h, i, x, b, xz=False):
        """``xz``: x is known zero, so the entry smoother takes its
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
            x = x + _fitv(lvl.P @ xc, x.shape[0])
        return lvl.post(lvl.A, x, b)

    def one_cycle(h, x, b):
        return visit(h, 0, x, b)

    one_cycle.zero = lambda h, b: visit(h, 0, None, b, xz=True)
    return one_cycle


class DeviceMultilevelSolver:
    """Solve engine over a compiled DeviceHierarchy."""

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
        (requires compile_hierarchy(mixed_precision=True))."""
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
        if np.ndim(b) != 1:
            raise NotImplementedError(
                "batched (2-D) right-hand sides are not ported yet "
                "(ROADMAP.md Queue 1 item 12)")
        n = h.levels[0].n
        n_pad = h.levels[0].n_pad
        dtype = torch.float64 if mixed else h.dtype
        tensor_out = isinstance(b, torch.Tensor)
        b_dev = pad_vector(b, n_pad, dtype=dtype, device=h.device)
        x0_dev = (torch.zeros(n_pad, dtype=dtype, device=h.device)
                  if x0 is None
                  else pad_vector(x0, n_pad, dtype=dtype, device=h.device))
        one_cycle, matvec, precond = self._ops(cycle, mixed)

        if accel is None:
            x, history, it = self._stationary(one_cycle, matvec, b_dev,
                                              x0_dev, tol, int(maxiter),
                                              mixed)
        else:
            x, history, it = device_cg(matvec, b_dev, x0_dev, tol=tol,
                                       maxiter=int(maxiter), M=precond)
        x = x[:n] if tensor_out else x[:n].cpu().numpy()
        hist = history.cpu().numpy()
        hist = hist[~np.isnan(hist)]
        if residuals is not None:
            residuals[:] = list(hist)
        if return_info:
            normb = float(torch.linalg.vector_norm(b_dev))
            converged = len(hist) >= 1 and hist[-1] < tol * max(normb,
                                                                 1e-300)
            return x, (0 if converged else int(it))
        return x

    def _stationary(self, one_cycle, matvec, b, x0, tol, maxiter, mixed):
        """accel=None: repeated cycles until the residual drops below
        tol * ||b||."""
        h = self.hierarchy
        rtol = _rtol_of(b, tol)
        x = x0
        normr = _norm(b - matvec(x))
        history = torch.full((maxiter + 1,), float("nan"), dtype=b.dtype,
                             device=b.device)
        history[0] = normr
        it = 0
        while it < maxiter and bool(normr >= rtol):
            if mixed:
                corr = one_cycle.zero(h, (b - matvec(x)).to(h.dtype))
                x = x + corr.to(x.dtype)
            else:
                x = one_cycle(h, x, b)
            normr = _norm(b - matvec(x))
            history[it + 1] = normr
            it += 1
        return x, history, it

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
