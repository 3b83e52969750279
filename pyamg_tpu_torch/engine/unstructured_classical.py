"""Device classical (Ruge-Stüben and AIR) setups for unstructured operators
(counterpart of ``pyamg_tpu/engine/unstructured_classical.py``).

The classical family on any windowable operator (a FEM stiffness matrix,
upwind advection on an unstructured mesh; others are RCM-reordered first),
built on the device in the reference's stages and with its decisions, so
that the hierarchy is the reference's level for level:

- **C/F splitting by PMIS** on the windowed strength graph (classical
  strength, ``norm="abs"`` or ``"min"``): weights lambda_j + hash, where
  lambda_j, the number of rows that strongly depend on j, is one transpose
  apply (K7) of the strength indicator; each round a node wins when its
  weight is at least every undecided strong out-neighbour's (K14 selects
  and a masked max), and its undecided strong in-neighbours turn F.  The
  rounds stop when none is undecided or at ``_MAX_ROUNDS``, the leftovers
  promoted to C; one host read a round.
- **Interpolation**: direct (alpha / beta row-sum ratios over the strong
  C out-neighbours, positives lumped into the diagonal when none is a
  target), modified (P = M P_direct, a :class:`ComposedWindowed`; M
  redistributes each F row over all its strong neighbours) or, for AIR,
  one-point (the strongest strong C neighbour).  Coarse column indices
  ride float32 payloads through K14, exact below 2^24 rows.
- **AIR restriction** (:class:`NeumannAIRRestriction`): R r = inject_C(r -
  A z), z = ``degree`` F-masked Jacobi sweeps on A_ff z = r_F, nothing but
  windowed applies and masks.
- **Galerkin product by banded chain probing** (the SA setup's
  :func:`~pyamg_tpu_torch.engine.unstructured_setup._probe_rap`): the
  chain P, then A (K12), then R (K13 through P^T's factors, or the
  Neumann restriction's K12 and K13), each 64-lane chunk placed into the
  coarse band by one scatter; the next level's operator comes from the
  band's top-k extraction, the coarsest one densified.

Host reads per level: one per PMIS round, the C mask, the band's row-nnz
bound and its column bounds.  The span plans come from |A| + |A^T|, so a
nonsymmetric (upwind) pattern is covered.  ``mixed_precision=True``
raises, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import resolve_device
from ..sparse.dia import DenseOperator
from ..sparse.formats import fit, pad_to
from ..sparse.window import TransposedWindowed, WindowedELL, _global_index
from . import relaxation as device_relaxation
from .device_setup import (_check_dtype, _check_smoother, _ns_pinv,
                           _power_rho, _smoother_device_arrays,
                           _smoother_wrap, _spec_key)
from .hierarchy import DeviceHierarchy, DeviceLevel
from .setup import _hash_weights
from .solver import DeviceMultilevelSolver
from .unstructured_setup import (_PROBE_K, ComposedWindowed, ReorderedSolver,
                                 _SpanPlan, _flat, _make_windowed,
                                 _next_from_band, _pick_geometry,
                                 _plan_windows, _probe_rap, _sym_abs,
                                 _unflat, _windowed_or_reordered)

__all__ = ["device_unstructured_rs_setup", "device_unstructured_air_setup",
           "NeumannAIRRestriction"]

# PMIS rounds cap (the reference's: leftovers are promoted to C)
_MAX_ROUNDS = 64
_MIXED = ("mixed precision (a float64 outer Krylov loop) is not offered by "
          "the unstructured classical setups, as in the reference: the "
          "finest apply would need float64 windowed kernels there; use the "
          "float32 device solve or dtype=torch.float64")


# ---------------------------------------------------------------------------
# classical strength over window slots
# ---------------------------------------------------------------------------

def _slot_fields(W: WindowedELL):
    """(data, col, row, offd): slot-wise (k, n_pad) values, global
    columns, rows, and the live off-diagonal slots."""
    data = _flat(W.data, W.n_pad)
    col = _flat(_global_index(W), W.n_pad)
    row = torch.arange(W.n_pad, device=W.device)[None, :]
    return data, col, row, (col != row) & (data != 0)


def _cls_strength_mask(W: WindowedELL, theta, norm):
    """Classical strength over the slots (the reference's
    classical_strength_of_connection_abs / _min):

    norm='abs':  |a_ij| >= theta * max_{k != i} |a_ik|
    norm='min':  -a_ij  >= theta * max_{k != i} (-a_ik)

    Returns (mask, data, col, row), each (k, n_pad)."""
    data, col, row, offd = _slot_fields(W)
    if norm == "min":
        meas = torch.where(offd, torch.clamp_min(-data, 0.0), 0.0)
    else:
        meas = torch.where(offd, torch.abs(data), 0.0)
    rowmax = torch.amax(meas, dim=0)
    mask = offd & (meas >= theta * rowmax[None, :]) & (meas > 0)
    return mask, data, col, row


def _with_data(W: WindowedELL, vals_kn):
    """W's structure holding other slot values (k, n_pad), whose live
    entries lie among W's: it shares W's column plan and tile tables (an
    entry live in W and zero here adds 0 to its column)."""
    V = dataclasses.replace(W, data=_unflat(vals_kn.to(W.dtype),
                                            W.data.shape[0], W.block,
                                            W.n_pad))
    V.__dict__.update(column_plan=W.column_plan,
                      _tile_tables=W._tile_tables)
    return V


# ---------------------------------------------------------------------------
# stage A: PMIS C/F splitting
# ---------------------------------------------------------------------------

def _stage_pmis(W: WindowedELL, theta=0.25, seed=0, norm="abs"):
    """PMIS on the windowed strength graph (module docstring).  Returns
    the C mask as an (n_pad,) float32 0/1 vector."""
    n_pad = W.n_pad
    valid = W.diagonal() != 0
    mask, _, _, _ = _cls_strength_mask(W, theta, norm)
    # lambda_j = #rows depending strongly on j: one transpose apply (K7)
    # of the strength indicator on W's column plan
    ones = torch.ones(n_pad, dtype=W.dtype, device=W.device)
    lam = _with_data(W, mask).rmatvec(ones)[:n_pad]
    w = torch.where(valid, lam.to(torch.float32)
                    + _hash_weights(n_pad, seed, device=W.device), 0.0)

    def nbr_max(x):
        sel = _flat(W.select(x), n_pad)
        return torch.amax(torch.where(mask, sel, float("-inf")), dim=0)

    state = torch.where(valid, -1, 0).to(torch.int8)
    it = 0
    while it < _MAX_ROUNDS and bool(torch.any(state == -1)):
        und = state == -1
        wv = torch.where(und, w, -1.0)
        # >= : tied neighbours both win, so every round decides someone
        winners = und & (wv >= torch.clamp_min(nbr_max(wv), 0.0))
        state = state.masked_fill(winners, 1)
        covered = nbr_max(winners.to(torch.float32)) > 0.5
        state = state.masked_fill((state == -1) & covered, 0)
        it += 1
    # leftovers at the cap promote to C (never strands an F point without
    # a strong C out-neighbour)
    return (((state == 1) | (state == -1)) & valid).to(torch.float32)


# ---------------------------------------------------------------------------
# stage B: interpolation operators
# ---------------------------------------------------------------------------

def _coarse_index(W, c_f):
    """(is_c, cval, selC, selcv): the C mask, each C point's coarse index
    (float32, exact below 2^24), and the C indicator and coarse index at
    each slot's column (K14)."""
    is_c = c_f > 0.5
    cval = torch.where(is_c, torch.cumsum(c_f, 0) - c_f, 0.0)
    return (is_c, cval, _flat(W.select(c_f), W.n_pad),
            _flat(W.select(cval), W.n_pad))


def _split_sums(data, sel):
    """Per row, the sums of the negative and of the positive values of
    the slots in ``sel``."""
    return (torch.sum(torch.where(sel, torch.clamp_max(data, 0.0), 0.0), 0),
            torch.sum(torch.where(sel, torch.clamp_min(data, 0.0), 0.0), 0))


def _distribution_weights(diag, data, offd, sel, f_row):
    """-(alpha_i | beta_i) a_ij / a~_ii on the F rows' ``sel`` slots, with
    alpha / beta the negative / positive row-sum ratios of all
    off-diagonals over the ``sel`` ones, and a~_ii the diagonal plus the
    signs that have no ``sel`` slot (lumped)."""
    neg_all, pos_all = _split_sums(data, offd)
    neg_t, pos_t = _split_sums(data, sel)
    alpha = torch.where(neg_t != 0,
                        neg_all / torch.where(neg_t != 0, neg_t, 1), 0.0)
    beta = torch.where(pos_t != 0,
                       pos_all / torch.where(pos_t != 0, pos_t, 1), 0.0)
    diag_eff = (diag + torch.where(pos_t == 0, pos_all, 0)
                + torch.where(neg_t == 0, neg_all, 0))
    diag_eff = torch.where(diag_eff != 0, diag_eff, 1.0)
    scale = torch.where(data < 0, alpha[None, :], beta[None, :])
    return torch.where(sel & f_row[None, :],
                       -(scale * data) / diag_eff[None, :], 0.0)


def _dinv(diag, valid):
    return torch.where(valid, 1.0 / torch.where(valid, diag, 1), 0)


def _stage_build_p_rs(W: WindowedELL, c_f, *, theta, norm, dtype, p_geom):
    """Direct interpolation from the PMIS splitting (the reference's
    rs_direct_interpolation_pass2 weights; targets are the strong C
    out-neighbours).  Returns (P, dinv, rho, cval)."""
    n = W.shape[0]
    diag = W.diagonal()
    valid = diag != 0
    mask, data, col, row = _cls_strength_mask(W, theta, norm)
    is_c, cval, selC, selcv = _coarse_index(W, c_f)
    offd = (col != row) & (data != 0)
    target = mask & (selC > 0.5)
    w_slots = _distribution_weights(diag, data, offd, target,
                                    valid & ~is_c)
    own = torch.where(is_c, 1.0, 0.0).to(data.dtype)
    pvals = torch.cat([own[None, :], w_slots], dim=0)
    pcols = torch.cat([cval[None, :], torch.where(target, selcv, 0.0)],
                      dim=0)
    P = _make_windowed(pvals, pcols, n, p_geom, dtype, nnz=int(W.nnz + n))
    dinv = _dinv(diag, valid)
    return P, dinv.to(dtype), _power_rho(W, dinv), cval


def _stage_build_p_onepoint(W: WindowedELL, c_f, *, theta, norm, dtype,
                            p_geom):
    """One-point prolongation (the reference's one_point_interpolation):
    each F row a single 1 at its strongest strong C out-neighbour (the
    first slot among ties), C rows inject; and the injection Tinj (C rows
    only), the Neumann restriction's front-end.  Returns (P, Tinj, dinv,
    fmask, cval)."""
    n = W.shape[0]
    diag = W.diagonal()
    valid = diag != 0
    mask, data, _, _ = _cls_strength_mask(W, theta, norm)
    is_c, cval, selC, selcv = _coarse_index(W, c_f)
    target = mask & (selC > 0.5)
    cand = torch.where(target, torch.abs(data), float("-inf"))
    best = torch.amax(cand, dim=0)
    first = torch.argmax((cand == best[None, :]).to(torch.int32), dim=0)
    hit = ((torch.arange(cand.shape[0], device=W.device)[:, None]
            == first[None, :]) & torch.isfinite(cand))
    chosen = torch.sum(torch.where(hit, selcv, 0.0), dim=0)
    f_row = valid & ~is_c
    f_t = f_row & torch.isfinite(best)
    pval = torch.where(is_c | f_t, 1.0, 0.0)
    pcol = torch.where(is_c, cval, torch.where(f_t, chosen, 0.0))
    P = _make_windowed(pval[None, :], pcol[None, :], n, p_geom, dtype, nnz=n)
    Tinj = _make_windowed(torch.where(is_c, 1.0, 0.0)[None, :],
                          cval[None, :], n, p_geom, dtype, nnz=n)
    return P, Tinj, _dinv(diag, valid).to(dtype), f_row, cval


def _stage_build_m_mod(W: WindowedELL, c_f, *, theta, norm, dtype, p_geom):
    """Modified classical interpolation as P = M P_direct (the reference's
    rs_classical_interpolation_pass2 in factored form): M redistributes
    each F row over all its strong neighbours, C and F, with the direct
    weight formula, on A's structure; C rows get 1 at every slot whose
    column is the row, a padding slot at the block's window start too (the
    reference's, kept for parity: ROADMAP.md Queue 3).  P_direct then maps
    every row's mass to coarse indices.  Returns (M, P_direct, dinv,
    rho)."""
    Pd, dinv, rho, _ = _stage_build_p_rs(W, c_f, theta=theta, norm=norm,
                                         dtype=dtype, p_geom=p_geom)
    diag = W.diagonal()
    valid = diag != 0
    mask, data, col, row = _cls_strength_mask(W, theta, norm)
    is_c = c_f > 0.5
    offd = (col != row) & (data != 0)
    mvals = _distribution_weights(diag, data, offd, mask, valid & ~is_c)
    mvals = torch.where((col == row) & is_c[None, :], 1.0, mvals)
    M = dataclasses.replace(W, data=_unflat(mvals.to(W.dtype),
                                            W.data.shape[0], W.block,
                                            W.n_pad))
    return M, Pd, dinv, rho


# ---------------------------------------------------------------------------
# the Neumann AIR restriction
# ---------------------------------------------------------------------------

def neumann_residual(r, dinv_f, degree, apply_A):
    """r - A z, z ``degree`` F-masked Jacobi sweeps on A_ff z = r_F (none
    for degree 0: r itself), A applied by ``apply_A``: the Neumann AIR
    restriction's front end, on a whole level or (row-sharded) on a
    rank's rows."""
    if degree <= 0:
        return r
    rf = torch.where(dinv_f != 0, r, 0.0)
    z = dinv_f * rf
    for _ in range(degree - 1):
        z = z + dinv_f * (rf - apply_A(z))
    return r - apply_A(z)


@dataclass(frozen=True)
class NeumannAIRRestriction:
    """R r = inject_C(r - A z), z = ``degree`` F-masked Jacobi sweeps on
    A_ff z = r_F (the reference's nAIR restriction).  ``r`` is a vector or
    a K-major (K, n) lane stack: A applies through K6 (K12 on a stack),
    the injection's transpose through K7 (K13)."""

    A: WindowedELL
    Tinj: WindowedELL       # 1-slot injection (C rows -> coarse index)
    dinv_f: torch.Tensor    # (n_pad,) 1 / a_ii on F rows, 0 elsewhere
    shape: tuple
    nnz: int
    degree: int

    @property
    def dtype(self):
        return self.A.dtype

    def matvec(self, r):
        r = neumann_residual(fit(r, self.A.n_pad), self.dinv_f, self.degree,
                             self.A.__matmul__)
        return self.Tinj.rmatvec(r)

    def __matmul__(self, r):
        return self.matvec(r)


# ---------------------------------------------------------------------------
# the shared driver
# ---------------------------------------------------------------------------

def _prep(A, dtype, device, reorder, retry):
    """(A, its WindowedELL, the span plan of |A| + |A^T|, which covers the
    transpose direction's reach on a nonsymmetric pattern and equals A's
    own on a symmetric one); or the reordered setup (module docstring)."""
    prep = _windowed_or_reordered(A, dtype, device, reorder, retry)
    if isinstance(prep, ReorderedSolver):
        return prep
    A, W = prep
    S = _sym_abs(A)
    S.sort_indices()
    return A, W, _SpanPlan.from_csr(S)


def _classical_levels(W, spans, n, *, family, build, theta, norm, seed,
                      max_coarse, max_levels, c_reach, dtype, profile):
    """The level loop of both setups: PMIS, host window planning, the
    family's transfers and smoothers (``build(cur, c_f, p_geom, nc_pad) ->
    (P, R, pre, post)``), the banded RAP probe through R, and the next level's
    extraction; then the dense coarsest level.  A_c = R A P reaches the C
    points within ``c_reach`` fine hops."""
    device = W.device

    def mark(label, lev, t0, sync=False):
        if profile is None:
            return time.perf_counter()
        if sync and device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        profile[f"L{lev}.{label}"] = t1 - t0
        return t1

    levels, infos = [], []
    cur, cur_n = W, n
    for lev in range(max_levels - 1):
        if cur_n <= max_coarse:
            break
        _t = time.perf_counter()
        c_f = _stage_pmis(cur, theta=float(theta), seed=seed + lev,
                          norm=norm)
        c_host = c_f.cpu().numpy() > 0.5
        _t = mark("pmis", lev, _t)
        nc = int(c_host[:cur_n].sum())
        if nc == 0 or nc >= cur_n:
            break
        cum = np.zeros(cur_n + 1, dtype=np.int64)
        np.cumsum(c_host[:cur_n], out=cum[1:])

        # P columns: the C points within distance 1 of the block's rows
        blo = np.arange(cur.data.shape[0], dtype=np.int64) * cur.block
        bhi = np.maximum(np.minimum(blo + cur.block, cur_n), blo + 1)
        plo, phi = _plan_windows(cum, *spans.hull(blo, bhi, 1))
        p_w2, p_starts, p_mch = _pick_geometry(plo, phi, cur.block, nc)
        p_geom = (cur.block, p_w2, p_starts, p_mch)
        # coarse blocks and their A_c windows
        bc = 256
        nc_pad = pad_to(nc, bc)
        roots_pos = np.flatnonzero(c_host[:cur_n])
        cb_lo = roots_pos[np.arange(0, nc, bc)]
        cb_hi = roots_pos[np.minimum(np.arange(0, nc, bc) + bc - 1,
                                     nc - 1)] + 1
        ac_lo, ac_hi = _plan_windows(cum, *spans.hull(
            cb_lo.astype(np.int64), cb_hi.astype(np.int64), c_reach))
        period = max(pad_to(int((ac_hi - ac_lo).max()), 16), 32)
        _t = mark("plan", lev, _t)

        P, R, pre, post = build(cur, c_f, p_geom, nc_pad)
        _t = mark("build_p", lev, _t, sync=True)

        cstarts = torch.as_tensor(ac_lo, dtype=torch.int64, device=device)
        A_band = _probe_rap(cur, P, cstarts, period=period, K=_PROBE_K,
                            nc_pad=nc_pad, bc=bc, dtype=dtype, R=R)
        A_band.view(nc_pad, period)[nc:] = 0       # padded coarse rows
        _t = mark("probe_rap", lev, _t, sync=True)

        levels.append(DeviceLevel(A=cur, P=P, R=R, pre=pre, post=post,
                                  n=cur_n, n_pad=cur.n_pad))
        infos.append({"level": lev, "n": cur_n, "nc": nc, "period": period,
                      "k": cur.k, "A_w2": cur.w2, "P_w2": p_w2,
                      "family": family})
        cur, spans = _next_from_band(A_band, cstarts, nc, nc_pad, bc, dtype)
        del A_band
        _t = mark("extract", lev, _t, sync=True)
        cur_n = nc
    return _finish_dense(levels, infos, cur, cur_n, dtype)


def _finish_dense(levels, infos, cur, cur_n, dtype):
    """The coarsest level, the windowed ``cur`` densified (its K-lane
    apply to the identity gives the lanes A e_j, i.e. A^T as rows, hence
    the transpose), its pseudo-inverse, and the solver."""
    nc_pad = cur.n_pad
    eye = torch.eye(nc_pad, dtype=dtype, device=cur.device)
    Ac_dense = (cur @ eye).T.contiguous()
    ident = device_relaxation.identity()
    levels.append(DeviceLevel(
        A=DenseOperator(data=Ac_dense, shape=(cur_n, cur_n),
                        nnz=cur_n * cur_n),
        P=None, R=None, pre=ident, post=ident, n=cur_n, n_pad=nc_pad))
    dml = DeviceMultilevelSolver(DeviceHierarchy(
        levels=tuple(levels), coarse_inv=_ns_pinv(Ac_dense), nc=cur_n,
        nc_pad=nc_pad, dtype=dtype))
    dml.setup_info = {"levels": infos}
    return dml


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def device_unstructured_rs_setup(A, dtype=torch.float32, device=None,
                                 theta=0.25, norm="abs",
                                 interpolation="modified", max_coarse=1500,
                                 max_levels=12,
                                 presmoother=("jacobi",
                                              {"omega": 4.0 / 3.0,
                                               "iterations": 2}),
                                 postsmoother=("jacobi",
                                               {"omega": 4.0 / 3.0,
                                                "iterations": 2}),
                                 mixed_precision=False, seed=0,
                                 reorder="auto", profile=None):
    """Build a classical (Ruge-Stüben) hierarchy on ``device`` for an
    unstructured operator: PMIS splitting, direct or modified
    interpolation, R = P^T and the chain-probed Galerkin product.  Returns
    a DeviceMultilevelSolver (or a :class:`ReorderedSolver` around one).

    ``interpolation``: ``"modified"`` (P = M P_direct, two windowed
    factors; the distance-two family that restores classical rates under
    PMIS) or ``"direct"`` (one factor).  Smoothers: ``jacobi``,
    ``richardson`` or ``chebyshev`` specs.  ``A`` need not be windowable
    under its ordering with ``reorder="auto"`` (RCM first).  ``profile={}``
    receives the seconds of each stage per level (``"L<lev>.<stage>"``),
    synchronised with the card."""
    if interpolation not in ("modified", "direct"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if mixed_precision:
        raise NotImplementedError(_MIXED)
    _check_dtype(dtype)
    pre_key, post_key = _spec_key(presmoother), _spec_key(postsmoother)
    _check_smoother(pre_key)
    _check_smoother(post_key)
    device = resolve_device(device)

    def retry(Ap, perm):
        return device_unstructured_rs_setup(
            Ap, dtype=dtype, device=device, theta=theta, norm=norm,
            interpolation=interpolation, max_coarse=max_coarse,
            max_levels=max_levels, presmoother=presmoother,
            postsmoother=postsmoother, seed=seed, reorder=False,
            profile=profile)

    prep = _prep(A, dtype, device, reorder, retry)
    if isinstance(prep, ReorderedSolver):
        return prep
    A, W, spans = prep
    kw = dict(theta=float(theta), norm=norm, dtype=dtype)

    def build(cur, c_f, p_geom, nc_pad):
        if interpolation == "modified":
            M, Pd, dinv, rho = _stage_build_m_mod(cur, c_f, p_geom=p_geom,
                                                  **kw)
            P = ComposedWindowed(factors=(M, Pd))
        else:
            P, dinv, rho, _ = _stage_build_p_rs(cur, c_f, p_geom=p_geom,
                                                **kw)
        pre = _smoother_device_arrays(pre_key, cur, dinv, rho, dtype)
        post = _smoother_device_arrays(post_key, cur, dinv, rho, dtype)
        return (P, TransposedWindowed(P), _smoother_wrap(pre_key, pre),
                _smoother_wrap(post_key, post))

    # A_c = P^T A P reaches the C points within 2 * reach + 1 fine hops
    reach = 2 if interpolation == "modified" else 1
    return _classical_levels(W, spans, A.shape[0], family="rs", build=build,
                             theta=theta, norm=norm, seed=seed,
                             max_coarse=max_coarse, max_levels=max_levels,
                             c_reach=2 * reach + 1, dtype=dtype,
                             profile=profile)


def device_unstructured_air_setup(A, dtype=torch.float32, device=None,
                                  theta=0.25, norm="min", degree=2,
                                  max_coarse=1500, max_levels=6,
                                  f_iterations=2, c_iterations=1, omega=1.0,
                                  mixed_precision=False, seed=0,
                                  reorder="auto", profile=None):
    """Build an AIR hierarchy on ``device`` for an unstructured operator,
    its pattern possibly nonsymmetric (upwind advection): PMIS on ``norm``
    strength, one-point P, the degree-``degree`` Neumann restriction
    (:class:`NeumannAIRRestriction`), no pre-smoother and the masked
    F-then-C Jacobi after (``f_iterations`` sweeps on the F points, then
    ``c_iterations`` on the C points, weight ``omega``), and the
    chain-probed R A P.  Solve with ``accel="fgmres"`` or ``"bicgstab"``.
    Returns a DeviceMultilevelSolver (or a :class:`ReorderedSolver` around
    one); ``profile`` as in :func:`device_unstructured_rs_setup`."""
    if mixed_precision:
        raise NotImplementedError(_MIXED)
    _check_dtype(dtype)
    device = resolve_device(device)
    degree = int(degree)

    def retry(Ap, perm):
        return device_unstructured_air_setup(
            Ap, dtype=dtype, device=device, theta=theta, norm=norm,
            degree=degree, max_coarse=max_coarse, max_levels=max_levels,
            f_iterations=f_iterations, c_iterations=c_iterations,
            omega=omega, seed=seed, reorder=False, profile=profile)

    prep = _prep(A, dtype, device, reorder, retry)
    if isinstance(prep, ReorderedSolver):
        return prep
    A, W, spans = prep

    def build(cur, c_f, p_geom, nc_pad):
        P, Tinj, dinv, fmask, _ = _stage_build_p_onepoint(
            cur, c_f, theta=float(theta), norm=norm, dtype=dtype,
            p_geom=p_geom)
        R = NeumannAIRRestriction(
            A=cur, Tinj=Tinj, dinv_f=torch.where(fmask, dinv, 0),
            shape=(nc_pad, cur.n_pad),
            nnz=int(cur.nnz * max(degree, 1)), degree=degree)
        post = device_relaxation.masked_jacobi(
            dinv, (fmask, ~fmask & (dinv != 0)),
            iters_per_mask=(int(f_iterations), int(c_iterations)),
            omega=float(omega))
        return P, R, device_relaxation.identity(), post

    # A_c = R A P reaches the C points within degree + 2 fine hops
    return _classical_levels(W, spans, A.shape[0], family="air", build=build,
                             theta=theta, norm=norm, seed=seed,
                             max_coarse=max_coarse, max_levels=max_levels,
                             c_reach=degree + 2, dtype=dtype,
                             profile=profile)
