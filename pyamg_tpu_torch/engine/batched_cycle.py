"""The interleaved batched V-cycle and CG, the reference's multi-RHS route
(counterpart of ``pyamg_tpu/engine/batched_cycle.py``).

The finest level runs on interleaved (S, K, 128) lane stacks through the
K15 kernels (``sparse/interleaved.py``); the coarse recursion runs the
port's K-major (K, n_pad) cycle on ``levels[1:]``:

    x  = wd b ; r = b - A x          int_jacobi_zero_res (fused)
    z  = tv (S^T r)                  int_spmv_scaled
    rc = blocksum(z) -> (K, n1_pad)  reshape-sums; the K axis moves to
                                     the front at coarse size
    ec = K-major zero V-cycle on levels[1:]
    t  = tv spread(ec), interleaved  an index on the aggregate map, then
                                     one fine-sized product with tv
    x  = x + S t                     int_spmv_add (fused add)
    x  = x + wd (b - A x)            int_jacobi_step

The reference's one-hot einsums for the x-direction block sum and spread
(an MXU idiom) are an exact reshape-sum and an index here, on the same
aggregate map (fine x // 3), as ``device_setup._block_sum`` and
``_broadcast_coarse`` are, so R stays P^T to rounding.  The y-direction
sum runs first (a 3-row reshape-sum), so the one relayout that crosses
the K axis of the fine side works on a third of the fine size.

Scope, as the reference's: 2-D stride-3 hierarchies built with
``device_sa_setup(..., lane_align=True)``, a DIA finest operator, the
factored structured transfers and single-sweep Jacobi smoothers
(:func:`supports_interleaved`); anything else raises ``ValueError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sparse.dia import DIAMatrix
from ..sparse.formats import fit
from ..sparse.interleaved import (from_interleaved, int_jacobi_step,
                                  int_jacobi_zero_res, int_spmv,
                                  int_spmv_add, int_spmv_scaled,
                                  to_interleaved)
from .device_setup import StructuredProlongator, StructuredRestrictor
from .hierarchy import DeviceHierarchy
from .solver import _make_cycle

__all__ = ["interleaved_batched_cg", "interleaved_zero_vcycle",
           "supports_interleaved"]

_LANES = 128
# CG iterations between convergence checks (one host read each): the
# reference's CHUNK; masked lanes make the overshoot steps no-ops
_CHUNK = 4


def _jacobi_wd(sm):
    """omega * dinv of a single-sweep Jacobi DeviceSmoother (omega a
    Python float or a 0-d device tensor), or None."""
    cfg = sm.config
    if cfg[0] == "jacobi" and cfg[2] == 1:
        (dinv,) = sm.arrays
        return cfg[1] * dinv
    if cfg[0] == "jacobi_dyn" and cfg[1] == 1:
        dinv, omega = sm.arrays
        return omega * dinv
    return None


def supports_interleaved(h: DeviceHierarchy):
    """True when the finest level fits the interleaved route; never on a
    row-sharded hierarchy, which takes the K-major lane route (the
    reference sends a sharded hierarchy to its vmapped path,
    ``pyamg_tpu/engine/batched_cycle.py:87-92``)."""
    if len(h.levels) < 2 or getattr(h, "mesh", None) is not None:
        return False
    lvl = h.levels[0]
    if not isinstance(lvl.A, DIAMatrix):
        return False
    P, R = lvl.P, lvl.R
    if not (isinstance(P, StructuredProlongator)
            and isinstance(R, StructuredRestrictor)):
        return False
    stride = P.stride if isinstance(P.stride, tuple) else (
        (P.stride,) * len(P.fine_grid_p))
    if len(P.fine_grid_p) != 2 or tuple(stride) != (3, 3):
        return False
    ny, nx = P.fine_grid_p
    if nx % (3 * _LANES) != 0 or ny % 3 != 0:
        return False        # needs a lane_align build
    if lvl.A.n_pad % _LANES != 0 or R.tv.shape[0] != lvl.A.n_pad:
        return False
    return _jacobi_wd(lvl.pre) is not None and _jacobi_wd(lvl.post) is not None


def _restrict_tail(Z, R: StructuredRestrictor, n1_pad):
    """blocksum(z) of an interleaved (S, K, 128) stack, with the coarse
    grid and solve padding, as a K-major (K, n1_pad) stack."""
    ny, nx = R.fine_grid_p
    nyc, nxc = R.coarse_grid
    cx, cxc = nx // _LANES, nxc // _LANES
    K = Z.shape[1]
    # y: triples of grid rows (each row is cx whole tiles)
    zy = Z[: ny * cx].reshape(nyc, 3, cx, K, _LANES).sum(dim=1)
    # x: fine x = (c * 3 + t) * 128 + l sums into coarse x = c * 128 +
    # (t * 128 + l) // 3
    zx = zy.reshape(nyc, cxc, 3, K, _LANES).transpose(2, 3).reshape(
        nyc, cxc, K, _LANES, 3).sum(dim=-1)
    rc = zx.permute(2, 0, 1, 3).reshape(K, nyc, nxc)
    cgp = R.coarse_grid_p
    rc = F.pad(rc, (0, cgp[1] - nxc, 0, cgp[0] - nyc)).reshape(K, -1)
    return fit(rc, n1_pad)


def _prolong_front(ec, P: StructuredProlongator, S_tiles):
    """tv * spread(unpad(ec)) of a K-major (K, n1) coarse stack, written
    as an interleaved fine stack (S_tiles, K, 128)."""
    ny, nx = P.fine_grid_p
    nyc, nxc = P.coarse_grid
    cgp = P.coarse_grid_p
    cx, cxc = nx // _LANES, nxc // _LANES
    K = ec.shape[0]
    v = ec[:, : cgp[0] * cgp[1]].reshape(K, cgp[0], cgp[1])[:, :nyc, :nxc]
    v = v.reshape(K, nyc, cxc, _LANES).permute(1, 2, 0, 3)  # coarse size
    # x: fine sub-tile t, lane l of coarse tile c reads coarse lane
    # (t * 128 + l) // 3; the index writes (nyc, cxc, 3, K, 128) directly
    lanes = (torch.arange(3 * _LANES, device=ec.device) // 3).reshape(
        3, 1, _LANES)
    ks = torch.arange(K, device=ec.device).reshape(1, K, 1)
    w = v[:, :, ks, lanes].reshape(nyc, 1, cx, K, _LANES)
    # y: each coarse row feeds 3 fine rows; one product with tv
    out = torch.empty(S_tiles, K, _LANES, dtype=ec.dtype, device=ec.device)
    out[ny * cx:].zero_()
    tv = P.tv[: ny * nx].reshape(nyc, 3, cx, 1, _LANES)
    torch.mul(w, tv, out=out[: ny * cx].view(nyc, 3, cx, K, _LANES))
    return out


def _zero_vcycle(h, h_sub, sub, wd0, wd1, Bi):
    lvl = h.levels[0]
    A, P, R = lvl.A, lvl.P, lvl.R
    X, Rr = int_jacobi_zero_res(A, wd0, Bi)
    Z = int_spmv_scaled(R.St, Rr, R.tv)
    rc = _restrict_tail(Z, R, h.levels[1].n_pad)
    ec = sub.zero(h_sub, rc)
    Ti = _prolong_front(ec, P, Bi.shape[0])
    X = int_spmv_add(P.S, Ti, X)
    return int_jacobi_step(A, wd1, Bi, X)


def _cycle_parts(h):
    if not supports_interleaved(h):
        raise ValueError(
            "hierarchy does not fit the interleaved route (needs a 2-D "
            "stride-3 lane_align device_sa_setup hierarchy with a DIA "
            "finest level and 1-sweep Jacobi smoothers)")
    h_sub = DeviceHierarchy(levels=h.levels[1:], coarse_inv=h.coarse_inv,
                            nc=h.nc, nc_pad=h.nc_pad, dtype=h.dtype)
    sub = _make_cycle(len(h.levels) - 1, "V")
    lvl = h.levels[0]
    return h_sub, sub, _jacobi_wd(lvl.pre), _jacobi_wd(lvl.post)


def interleaved_zero_vcycle(h: DeviceHierarchy, Bi):
    """One zero-initial-guess V-cycle on an interleaved right-hand side
    stack (S, K, 128) -> the interleaved correction (S, K, 128).  Raises
    ValueError unless :func:`supports_interleaved`."""
    return _zero_vcycle(h, *_cycle_parts(h), Bi)


def interleaved_batched_cg(h: DeviceHierarchy, Bk, tol=1e-5, maxiter=100):
    """Preconditioned CG on K right-hand sides at once, the interleaved
    V-cycle as preconditioner and every vector on interleaved stacks.

    The reference's semantics exactly: per-lane scalars; a lane is active
    while its residual norm exceeds tol * max(||b||, 1e-30); alpha and
    beta are zeroed on inactive lanes (they freeze), the history is
    written for active lanes only, and convergence is checked (one host
    read) every 4 masked iterations.  ``Bk`` is a (K, n_pad) stack in the
    level-0 padded-grid layout (``StructuredDeviceSolver.solve`` lays it
    out).  Returns ``(X (K, n_pad), history (maxiter + 1, K))``, the
    history NaN after each lane's convergence."""
    parts = _cycle_parts(h)
    A = h.levels[0].A
    Bi = to_interleaved(Bk)
    K = Bi.shape[1]

    def dots(U, V):
        return torch.sum(U * V, dim=(0, 2))

    def lane(s):
        return s[None, :, None]

    b_norm = torch.sqrt(dots(Bi, Bi))
    thresh = tol * torch.clamp_min(b_norm, 1e-30)
    X = torch.zeros_like(Bi)
    Ri = Bi
    Pi = _zero_vcycle(h, *parts, Bi)
    rz = dots(Bi, Pi)
    rn = b_norm
    hist = torch.full((maxiter + 1, K), float("nan"), dtype=Bi.dtype,
                      device=Bi.device)
    hist[0] = b_norm
    it = 0
    while it < maxiter and bool((rn > thresh).any()):
        for step in range(it, it + _CHUNK):
            active = rn > thresh
            Qi = int_spmv(A, Pi)
            pq = dots(Pi, Qi)
            alpha = torch.where(active & (pq != 0),
                                rz / torch.where(pq != 0, pq, 1.0), 0.0)
            X = X + lane(alpha) * Pi
            Ri = Ri - lane(alpha) * Qi
            rn_new = torch.where(active, torch.sqrt(dots(Ri, Ri)), rn)
            if step + 1 <= maxiter:
                hist[step + 1] = torch.where(active, rn_new, hist[step + 1])
            Zi = _zero_vcycle(h, *parts, Ri)
            rz_new = dots(Ri, Zi)
            beta = torch.where(active & (rz != 0),
                               rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
            Pi = Zi + lane(beta) * Pi
            rz, rn = rz_new, rn_new
        it += _CHUNK
    return from_interleaved(X), hist
