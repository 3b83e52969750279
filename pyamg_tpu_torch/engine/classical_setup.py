"""Device-built classical setups for grid-stencil operators (counterpart of
``pyamg_tpu/engine/classical_setup.py``): Ruge-Stüben
(:func:`device_rs_setup`) and AIR (:func:`device_air_setup`).

The hierarchy is built on the device from the operator's diagonals, as
the smoothed-aggregation one is (``engine/device_setup.py``), and shares
its layout: the padded grid, the static coarsening plan, the solve
padding, the filtered DIA SpGEMM and the strided compaction.

- **C/F splitting**: the C points are the stride-2 sublattice of the
  coarsened dims (per-dim strides: a weakly coupled dim keeps stride 1,
  ``stride='auto'`` reads the couplings off the stencil); the F points of
  pass m are those off the sublattice in m coarsened dims.
- **Ruge-Stüben interpolation**: each pass is an embedded fine-grid DIA
  operator S_m (identity on finished rows, direct-interpolation weights
  toward the C and earlier-pass points on pass-m rows, the positive and
  negative couplings scaled apart), and P = S_n ... S_1 D_C is their
  product, stored as the embedded DIA ``P_emb``; R = P^T by rolls.
- **AIR**: one-point interpolation (each pass row takes its strongest
  target neighbour), and the local approximate ideal restriction: for
  every C point, the degree-2 neighbourhood's dense system A_ff^T r =
  -A_cf^T solved by Gaussian elimination without pivoting (guarded
  pivots), batched over the rows; the post-smoother is the masked
  F-then-C Jacobi.
- **Galerkin product**: R (A P) through the span-filtered SpGEMM, then
  compaction to the coarse grid.

Every step runs eagerly in plain PyTorch (rolls, elementwise products,
reshapes); the spectral-radius estimates are the power iteration whose
SpMV is K1, the coarsest solve the Newton-Schulz pseudo-inverse.  Nothing
is read back to the host but the ``stride='auto'`` couplings.  In the
solve, the embedded transfers apply through K1 (``SPMV_ADD`` for the
correction) or, on a K-major (K, n) lane stack, K8; the Jacobi smoothers
through K3 and K2 (K10 and K9 on lanes), and AIR's masked sweeps each
through one K2 (K9) pass.

An operator that is not a grid stencil (``detect_grid`` finds no grid)
goes to the unstructured classical setups
(``engine/unstructured_classical.py``), with the reference's arguments.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..backend import resolve_device
from ..sparse.dia import DIAMatrix, dia_spmm_add, dia_spmv_add
from ..sparse.formats import fit
from ..sparse.window import TransposedWindowed
from . import relaxation as device_relaxation
from .device_setup import (_WholeProducts, _check_dtype, _check_smoother,
                           _coarse_index, _coarsening_plan, _compact_fine,
                           _shared_factor, _windowed_rows,
                           _dia_to_dense, _dinv_of, _embed_coarse,
                           _grid_operator, _grid_pad_vec, _grid_unpad_vec,
                           _not_ported, _ns_pinv, _offset_sums,
                           _offset_to_coords, _pad_smoother_arrays,
                           _pad_solve_items, _power_rho, _relayout_dia,
                           _smoother_device_arrays, _smoother_wrap,
                           _spec_key, _structured_solver, _tup, detect_grid)
from .hierarchy import DeviceLevel
from .unstructured_classical import (device_unstructured_air_setup,
                                     device_unstructured_rs_setup)

__all__ = ["device_rs_setup", "device_air_setup", "EmbeddedProlongator",
           "EmbeddedRestrictor"]


# ---------------------------------------------------------------------------
# solve-phase transfers (the embedded P and R)
# ---------------------------------------------------------------------------

def _embedding_factor(n_rows, coarse_grid, coarse_grid_p, stride, center,
                      dtype, device, block):
    """E: coarse padded grid -> fine rows, 1 where a fine point is a coarse
    point's centre (``embed(unpad(xc))``), as a one-slot WindowedELL; its
    transpose is the compaction (one entry a column, an exact copy)."""
    cols = _embed_coarse(_coarse_index(coarse_grid, coarse_grid_p,
                                       device) + 1,
                         coarse_grid, stride, center) - 1
    return _windowed_rows(cols[:, None],
                          torch.ones(cols.shape[0], 1, dtype=dtype,
                                     device=device),
                          (n_rows, int(np.prod(coarse_grid_p))), block,
                          dtype)


def _shared_embedding(t, M, block):
    """The embedding factor of the embedded transfer ``t`` (its DIA factor
    ``M``), built once for the level's P and R."""
    return _shared_factor(t.remaps, block, lambda b: _embedding_factor(
        M.n_pad, t.coarse_grid, t.coarse_grid_p, t.stride, t.center,
        M.dtype, M.device, b))


@dataclass(frozen=True)
class EmbeddedProlongator:
    """P stored as an embedded fine-grid DIA whose columns live on the C
    points: P xc = P_emb embed(xc), a vector or each lane of a K-major
    (K, nc) stack."""

    P_emb: DIAMatrix
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: Tuple[int, ...]
    center: Tuple[int, ...]
    # the embedding E by block, shared with the level's restrictor
    remaps: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.P_emb.ndiags

    @property
    def shape(self):
        return (int(np.prod(self.fine_grid_p)),
                int(np.prod(self.coarse_grid_p)))

    def _embed(self, xc):
        # xc may carry solve padding beyond the coarse padded grid; the
        # grid lives in its leading prod(coarse_grid_p) entries
        xc = xc[..., : int(np.prod(self.coarse_grid_p))]
        xc = _grid_unpad_vec(xc, self.coarse_grid, self.coarse_grid_p)
        e = _embed_coarse(xc, self.coarse_grid, self.stride, self.center)
        nf = int(np.prod(self.fine_grid_p))
        if self.P_emb.n_pad != nf:
            e = F.pad(e, (0, self.P_emb.n_pad - nf))
        return e

    def __matmul__(self, xc):
        return self.P_emb @ self._embed(xc)

    def apply_correction(self, xc, x):
        """x + P @ xc, the add in the SpMV's epilogue when x has P_emb's
        length: K1 ``SPMV_ADD`` for a vector, K8 ``add`` for a lane
        stack."""
        e = self._embed(xc)
        if x.shape[-1] == self.P_emb.n_pad:
            add = dia_spmm_add if x.ndim == 2 else dia_spmv_add
            return add(self.P_emb, e, x)
        return x + fit(self.P_emb @ e, x.shape[-1])

    def shard_factors(self, block):
        """(P_emb, E), P as factors applied right to left (E the embedding
        as a one-slot WindowedELL of ``block`` rows a block): the form a
        row-sharded hierarchy applies."""
        return (self.P_emb, _shared_embedding(self, self.P_emb, block))


@dataclass(frozen=True)
class EmbeddedRestrictor:
    """R applied as R_emb @ r, then compaction to the C points and the
    coarse level's padded grid (lane by lane for a K-major stack)."""

    R_emb: DIAMatrix
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: Tuple[int, ...]
    center: Tuple[int, ...]
    # the embedding E by block, shared with the level's prolongator
    remaps: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.R_emb.ndiags

    @property
    def shape(self):
        return (int(np.prod(self.coarse_grid_p)),
                int(np.prod(self.fine_grid_p)))

    @property
    def n_pad(self):
        return int(np.prod(self.coarse_grid_p))

    def __matmul__(self, r):
        y = (self.R_emb @ r)[..., : int(np.prod(self.fine_grid_p))]
        yc = _compact_fine(y, self.coarse_grid, self.stride, self.center)
        return _grid_pad_vec(yc, self.coarse_grid, self.coarse_grid_p)

    def shard_factors(self, block):
        """(E^T, R_emb), R as factors applied right to left: the
        compaction is the embedding's transpose (K7)."""
        return (TransposedWindowed(_shared_embedding(self, self.R_emb,
                                                     block)), self.R_emb)


# ---------------------------------------------------------------------------
# splitting and interpolation
# ---------------------------------------------------------------------------

class _GridMarks:
    """The C/F marks of a level's rows: each point's count of coarsened
    dims whose coord != center (mod stride), read off its flat index on
    the padded grid ``grid_p`` (0 on the C sublattice, m on the pass-m
    points).  ``rows`` is the range of flat indices the level's operands
    hold: the whole grid (None), or a slab of whole grid rows (the
    partitioned setup's), whose marks and shifted marks are those of the
    whole grid's rolls: the marks of the slab extended by ``halo`` rows
    each side, read off the global indices modulo the grid's points."""

    def __init__(self, grid_p, stride, center, device, rows=None, halo=0):
        dim = len(grid_p)
        self.grid_p = tuple(grid_p)
        self.ss, self.cc = _tup(stride, dim), _tup(center, dim)
        n = int(np.prod(grid_p))
        self.n_passes = sum(1 for s in self.ss if s > 1)
        self.slab = rows is not None
        r0, r1 = rows if self.slab else (0, n)
        self.halo = halo if self.slab else 0
        self.length = r1 - r0
        self.ext = self._oddness(torch.arange(
            r0 - self.halo, r1 + self.halo, device=device) % n)
        self.odd = self.ext[self.halo:self.halo + self.length]

    def _oddness(self, index):
        odd = torch.zeros(index.shape, dtype=torch.int32,
                          device=index.device)
        step = 1
        for g, s, c in reversed(list(zip(self.grid_p, self.ss, self.cc))):
            if s > 1:
                odd += ((index // step) % g % s != c).to(torch.int32)
            step *= g
        return odd

    def mask(self, m):
        """The pass-m points (m = 0: the C points)."""
        return self.odd == m

    def targets(self, m, o):
        """Whether row i's entry at offset ``o`` lands on a target of pass
        m (a C point or an earlier pass's), the column taken modulo the
        grid's points as the whole grid's roll wraps it."""
        if not self.slab:
            return torch.roll(self.odd < m, -o)
        lo = self.halo + o
        return self.ext[lo:lo + self.length] < m


def _sorted_dia(rows, offsets, n):
    """A DIAMatrix from per-offset rows, sorted by offset."""
    order = np.argsort(offsets)
    return DIAMatrix(data=torch.stack([rows[i] for i in order]),
                     offsets=tuple(int(offsets[i]) for i in order),
                     shape=(n, n), nnz=n * len(offsets))


def _injection(cmask, dtype):
    """D_C: the identity on the C points, as a one-diagonal DIA."""
    n = cmask.shape[0]
    return DIAMatrix(data=torch.where(cmask, 1.0, 0.0).to(dtype)[None, :],
                     offsets=(0,), shape=(n, n), nnz=n)


def _pass_interp(A_p: DIAMatrix, fmask, targets, dtype):
    """One interpolation pass as an embedded DIA operator S: pass rows
    (``fmask``) hold direct-interpolation weights toward the targets (the
    C and earlier-pass points; ``targets(o)`` whether row i's entry at
    offset o lands on one), every other row is the identity.  The weights
    are rs_direct_interpolation_pass2's with the targets as the strong C
    neighbours:

        alpha_i = sum_{j != i} a_ij^- / sum_{j target} a_ij^-
        beta_i  = sum_{j != i} a_ij^+ / sum_{j target} a_ij^+
        w_ij = -(alpha_i | beta_i) a_ij / a~_ii,

    couplings of a sign with no target lumped into the diagonal
    (a~_ii)."""
    diag = A_p.diagonal()
    neg_all = torch.zeros_like(diag)
    pos_all = torch.zeros_like(diag)
    neg_t = torch.zeros_like(diag)
    pos_t = torch.zeros_like(diag)
    t_ind = []
    for d, o in enumerate(A_p.offsets):
        if o == 0:
            t_ind.append(None)
            continue
        a = A_p.data[d]
        neg_all = neg_all + torch.clamp_max(a, 0)
        pos_all = pos_all + torch.clamp_min(a, 0)
        ind = targets(o)                     # entry (i, i+o) lands on a target
        t_ind.append(ind)
        at = torch.where(ind, a, 0)
        neg_t = neg_t + torch.clamp_max(at, 0)
        pos_t = pos_t + torch.clamp_min(at, 0)

    alpha = torch.where(neg_t != 0,
                        neg_all / torch.where(neg_t != 0, neg_t, 1), 0.0)
    beta = torch.where(pos_t != 0,
                       pos_all / torch.where(pos_t != 0, pos_t, 1), 0.0)
    diag_eff = (diag + torch.where(pos_t == 0, pos_all, 0)
                + torch.where(neg_t == 0, neg_all, 0))
    diag_eff = torch.where(diag_eff != 0, diag_eff, 1.0)

    rows = []
    offsets = []
    for d, o in enumerate(A_p.offsets):
        if o == 0:
            continue
        a = A_p.data[d]
        scale = torch.where(a < 0, alpha, beta)
        w = torch.where(fmask & t_ind[d], -(scale * a) / diag_eff, 0.0)
        offsets.append(o)
        rows.append(w.to(dtype))
    offsets.append(0)
    rows.append(torch.where(fmask, 0.0, 1.0).to(dtype))
    return _sorted_dia(rows, offsets, A_p.n_pad)


def _span_filter(A: DIAMatrix, B: DIAMatrix, grid_p, bound):
    """The offset sums of A B whose per-dim deltas stay within ``bound``
    (offsets that do not decompose on the grid are dropped): the
    structurally nonzero diagonals of the interpolation and Galerkin
    products."""
    return _offset_sums(A.offsets, B.offsets, grid_p, lambda coords: all(
        abs(c) <= b for c, b in zip(coords, bound)))


def _spans(offsets, grid_p, stride):
    """(per-dim stencil span of A's ``offsets``, the interpolation
    bound)."""
    ss = _tup(stride, len(grid_p))
    a_span = [0] * len(grid_p)
    for o in offsets:
        for d, c in enumerate(_offset_to_coords(o, grid_p)):
            a_span[d] = max(a_span[d], abs(c))
    return a_span, tuple(a if s > 1 else 0 for a, s in zip(a_span, ss))


def _interpolation(A_p, marks, grid_p, p_bound, pass_fn, dtype,
                   products=_WholeProducts):
    """P_emb = S_n ... S_1 D_C, S_m = ``pass_fn`` on the pass-m rows of
    ``marks`` (a :class:`_GridMarks`), each product through
    ``products``."""
    P_emb = _injection(marks.mask(0), dtype)
    for m in range(1, marks.n_passes + 1):
        S_m = pass_fn(A_p, marks.mask(m), functools.partial(marks.targets, m),
                      dtype)
        P_emb = products.spgemm_filtered(
            S_m, P_emb, _span_filter(S_m, P_emb, grid_p, p_bound))
    return P_emb


def _galerkin(A_p, P_emb, R_emb, grid_p, stride, center, rap_bound,
              products=_WholeProducts):
    """A_c = compaction of R_emb (A_p P_emb), both products span-filtered
    and the second kept to the C-to-C offsets."""
    ss = _tup(stride, len(grid_p))
    AP = products.spgemm_filtered(
        A_p, P_emb, _span_filter(A_p, P_emb, grid_p, rap_bound))
    cand = _offset_sums(R_emb.offsets, AP.offsets, grid_p, lambda coords: all(
        c % s == 0 and abs(c) <= b for c, s, b in zip(coords, ss, rap_bound)))
    Ac_emb = products.spgemm_filtered(R_emb, AP, cand)
    return products.compact(Ac_emb, grid_p, stride, center)


def _rs_coarsen_level(A_p: DIAMatrix, grid_p, stride, center, dtype,
                      products=_WholeProducts, marks=None):
    """One classical coarsening step: masks, multi-pass P, R = P^T, the
    filtered Galerkin product and its compaction.  (P_emb, R_emb, A_c).
    ``products`` forms the DIA products (the whole grid's rolls, or a
    slab's, with the slab's ``marks``)."""
    if marks is None:
        marks = _GridMarks(grid_p, stride, center, A_p.device)
    ss = _tup(stride, len(grid_p))
    a_span, p_bound = _spans(A_p.offsets, grid_p, stride)
    P_emb = _interpolation(A_p, marks, grid_p, p_bound, _pass_interp, dtype,
                           products)
    R_emb = products.transpose(P_emb)
    rap_bound = tuple(max(s, a) for s, a in zip(ss, a_span))
    A_c = _galerkin(A_p, P_emb, R_emb, grid_p, stride, center, rap_bound,
                    products)
    return P_emb, R_emb, A_c


def _rs_setup_pipeline(A_in, *, plan, dtype, pre_key, post_key):
    """The multi-level classical setup, one eager loop over the static
    plan: per level the padded operator, P_emb, R_emb, the rho(D^-1 A)
    estimate and the smoother tensors (solve-padded), then the dense
    coarsest operator and its pseudo-inverse."""
    cur = A_in
    out_levels = []
    for (grid, grid_p, strides) in plan:
        center = tuple(0 for _ in strides)
        A_p = _relayout_dia(cur, grid, grid_p)
        P_emb, R_emb, A_c = _rs_coarsen_level(A_p, grid_p, strides, center,
                                              dtype)
        dinv = _dinv_of(A_p.diagonal())
        rho = _power_rho(A_p, dinv)
        pre_arr = _smoother_device_arrays(pre_key, A_p, dinv, rho, dtype)
        post_arr = _smoother_device_arrays(post_key, A_p, dinv, rho, dtype)
        out_levels.append(
            _pad_solve_items(A_p.n_pad, (A_p, P_emb, R_emb, rho))
            + (_pad_smoother_arrays(pre_key, pre_arr, A_p.n_pad),
               _pad_smoother_arrays(post_key, post_arr, A_p.n_pad)))
        cur = A_c
    Ac_dense = _dia_to_dense(cur)
    return tuple(out_levels), Ac_dense, _ns_pinv(Ac_dense)


# ---------------------------------------------------------------------------
# AIR: one-point prolongation and local approximate ideal restriction
# ---------------------------------------------------------------------------

def _pass_onepoint(A_p: DIAMatrix, fmask, targets, dtype):
    """One one-point interpolation pass as an embedded DIA operator: each
    pass row puts a single 1 at its strongest target neighbour (largest
    |a_ij|, the first such offset on a tie); other rows are the
    identity."""
    offs = [o for o in A_p.offsets if o != 0]
    scores = []
    for o in offs:
        d = A_p.offsets.index(o)
        ind = targets(o)
        scores.append(torch.where(ind, torch.abs(A_p.data[d]), 0.0))
    smax = scores[0]
    for s in scores[1:]:
        smax = torch.maximum(smax, s)
    rows = []
    offsets = []
    taken = torch.zeros_like(fmask)
    for o, s in zip(offs, scores):
        win = fmask & (~taken) & (s > 0) & (s == smax)
        taken = taken | win
        offsets.append(o)
        rows.append(torch.where(win, 1.0, 0.0).to(dtype))
    offsets.append(0)
    rows.append(torch.where(fmask, 0.0, 1.0).to(dtype))
    return _sorted_dia(rows, offsets, A_p.n_pad)


def _unrolled_solve(M, b, eps=1e-30):
    """Batched k x k solves M x = b, M (n, k, k), b (n, k): Gaussian
    elimination without pivoting, a missing pivot (|p| <= eps) turning
    its row into an identity row with a zero right-hand side (the
    reference's unrolled elimination).  Each pivot's trailing update runs
    over the whole (n, k-p-1, k-p-1) block at once, every entry formed as
    the reference forms it, ``m_ij - f_i * m_pj`` with ``f_i = m_ip *
    (1 / pivot)``; the back substitution sums in the reference's order."""
    n, k = b.shape
    W = M.clone()
    rhs = b.clone()
    pivs = torch.empty_like(b)
    for p in range(k):
        piv = W[:, p, p]
        ok = torch.abs(piv) > eps
        piv = torch.where(ok, piv, 1.0)
        pivs[:, p] = piv
        rhs[:, p] = torch.where(ok, rhs[:, p], 0.0)
        W[:, p, p + 1:] = torch.where(ok[:, None], W[:, p, p + 1:], 0.0)
        inv = 1.0 / piv
        f = W[:, p + 1:, p] * inv[:, None]
        W[:, p + 1:, p + 1:] -= f[:, :, None] * W[:, p, None, p + 1:]
        rhs[:, p + 1:] -= f * rhs[:, p, None]
    x = torch.empty_like(b)
    for p in range(k - 1, -1, -1):
        acc = rhs[:, p]
        for j in range(p + 1, k):
            acc = acc - W[:, p, j] * x[:, j]
        x[:, p] = acc / pivs[:, p]
    return x


def _air_slots(A_p: DIAMatrix, grid_p, degree, span_cap=2):
    """The local AIR neighbourhood's slot offsets: the stencil's
    off-diagonal offsets, and at degree 2 their pairwise sums (the F
    points one F-F connection further), each sum's per-dim span capped at
    ``span_cap``, in the reference's order."""
    offs1 = [o for o in A_p.offsets if o != 0]
    if degree < 2:
        return offs1
    sums = _offset_sums(offs1, offs1, grid_p, lambda coords: all(
        abs(c) <= span_cap for c in coords))
    return offs1 + [o for o in sums if o != 0 and o not in offs1]


def _local_air_restriction(A_p: DIAMatrix, cmask, grid_p, dtype,
                           degree=2):
    """Local AIR as an embedded DIA operator: for every C point c with F
    neighbours {c + o_p} in its slots, the solution of

        A_ff(N, N)^T r = -A_cf(c, N)^T,   R[c, c] = 1,  R[c, c + o_p] = r_p.

    A[c + o_p, c + o_q] is diagonal (o_q - o_p) rolled by -o_p; a slot
    that is not an F point with a nonzero diagonal gets an identity row
    and a zero right-hand side."""
    offs = _air_slots(A_p, grid_p, degree)
    k = len(offs)
    dlook = {o: d for d, o in enumerate(A_p.offsets)}
    diag = A_p.diagonal()
    zero = torch.zeros_like(diag)
    valid = [torch.roll((~cmask) & (diag != 0), -o) for o in offs]
    # M[:, p, q] = A[x + o_p, x + o_q] for rows x (only C rows used)
    M = []
    for p, op in enumerate(offs):
        row = []
        for q, oq in enumerate(offs):
            rel = oq - op
            if p == q:
                a = torch.roll(diag, -op)
            elif rel in dlook:
                a = torch.roll(A_p.data[dlook[rel]], -op)
            else:
                a = zero
            a = torch.where(valid[p] & valid[q], a, 0.0)
            if p == q:
                a = torch.where(valid[p], a, 1.0)
            row.append(a)
        M.append(torch.stack(row, dim=1))
    Mt = torch.stack(M, dim=1).transpose(1, 2)       # (n, k, k), M^T
    rhs = torch.stack(
        [torch.where(valid[p], -A_p.data[dlook[op]] if op in dlook else zero,
                     0.0) for p, op in enumerate(offs)], dim=1)
    r = _unrolled_solve(Mt, rhs)
    del M, Mt
    crow = cmask & (diag != 0)
    rows = [torch.where(crow, r[:, p], 0.0).to(dtype) for p in range(k)]
    rows.append(torch.where(crow, 1.0, 0.0).to(dtype))
    return _sorted_dia(rows, list(offs) + [0], A_p.n_pad)


def _air_coarsen_level(A_p: DIAMatrix, grid_p, stride, center, dtype,
                       degree=2):
    """One AIR coarsening step: one-point P, local AIR R, the
    nonsymmetric Galerkin product with its span capped at 2 coarse cells
    per coarsened dim.  (P_emb, R_emb, A_c, cmask)."""
    marks = _GridMarks(grid_p, stride, center, A_p.device)
    ss = _tup(stride, len(grid_p))
    a_span, p_bound = _spans(A_p.offsets, grid_p, stride)
    P_emb = _interpolation(A_p, marks, grid_p, p_bound, _pass_onepoint,
                           dtype)
    cmask = marks.mask(0)
    R_emb = _local_air_restriction(A_p, cmask, grid_p, dtype, degree=degree)
    rap_bound = tuple(2 * s if s > 1 else a for s, a in zip(ss, a_span))
    A_c = _galerkin(A_p, P_emb, R_emb, grid_p, stride, center, rap_bound)
    return P_emb, R_emb, A_c, cmask


def _air_level_stage(cur, *, grid, grid_p, strides, dtype, degree):
    """One level of the AIR setup: the solve-padded (A_p, P_emb, R_emb,
    dinv, F mask, C mask) and the coarse operator.  The masks leave out
    the rows with a zero diagonal (the padding)."""
    center = tuple(0 for _ in strides)
    A_p = _relayout_dia(cur, grid, grid_p)
    P_emb, R_emb, A_c, cmask = _air_coarsen_level(
        A_p, grid_p, strides, center, dtype, degree=degree)
    diag = A_p.diagonal()
    fmask = (~cmask) & (diag != 0)
    cmask_r = cmask & (diag != 0)
    return _pad_solve_items(
        A_p.n_pad, (A_p, P_emb, R_emb, _dinv_of(diag), fmask, cmask_r)), A_c


def _air_setup_pipeline(A_in, *, plan, dtype, degree):
    """The multi-level AIR setup, one eager stage per level, then the
    dense coarsest operator and its pseudo-inverse."""
    cur = A_in
    out_levels = []
    for (grid, grid_p, strides) in plan:
        lvl, cur = _air_level_stage(cur, grid=grid, grid_p=grid_p,
                                    strides=strides, dtype=dtype,
                                    degree=degree)
        out_levels.append(lvl)
    Ac_dense = _dia_to_dense(cur)
    return tuple(out_levels), Ac_dense, _ns_pinv(Ac_dense)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _stencil_grid_of(A, grid):
    """The grid of ``A``: ``grid``, or the one :func:`detect_grid` infers;
    None for an operator that is not a grid stencil (the caller routes it
    to the unstructured classical setups)."""
    if grid is not None:
        return grid
    if not (sp.issparse(A) or isinstance(A, np.ndarray)):
        raise ValueError("grid= is required for DIAMatrix inputs")
    try:
        return detect_grid(A)
    except ValueError:
        return None


def _embedded_transfers(plan, i, P_emb, R_emb):
    """Level ``i``'s EmbeddedProlongator and EmbeddedRestrictor."""
    grid_p, strides = plan[i][1], plan[i][2]
    coarse_grid = tuple(g // s for g, s in zip(grid_p, strides))
    geom = dict(fine_grid_p=grid_p, coarse_grid=coarse_grid,
                coarse_grid_p=(plan[i + 1][1] if i + 1 < len(plan)
                               else coarse_grid),
                stride=strides, center=tuple(0 for _ in strides),
                remaps={})
    return EmbeddedProlongator(P_emb=P_emb, **geom), EmbeddedRestrictor(
        R_emb=R_emb, **geom)


def _rs_levels(plan, out_levels, pre_key, post_key, first=0):
    """The DeviceLevels and setup_info entries of the RS pipeline's levels
    ``plan[first:]`` (``out_levels`` theirs)."""
    dev_levels = []
    infos = []
    for i, (A_p, P_emb, R_emb, rho, pre_arr, post_arr) in enumerate(
            out_levels, start=first):
        grid_p, strides = plan[i][1], plan[i][2]
        P, R = _embedded_transfers(plan, i, P_emb, R_emb)
        npad_lvl = int(np.prod(grid_p))
        dev_levels.append(DeviceLevel(
            A=A_p, P=P, R=R, pre=_smoother_wrap(pre_key, pre_arr),
            post=_smoother_wrap(post_key, post_arr), n=npad_lvl,
            n_pad=int(A_p.n_pad)))
        # rho stays a device scalar
        infos.append({"level": i, "n": npad_lvl, "strides": strides,
                      "ndiags": A_p.ndiags, "rho_D_inv_A": rho})
    return dev_levels, infos


def device_rs_setup(A, grid=None, dtype=torch.float32, device=None,
                    stride="auto", max_coarse=400, max_levels=12,
                    presmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    postsmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    mixed_precision=False, mesh=None):
    """Build a classical (Ruge-Stüben) hierarchy on ``device`` for a
    grid-stencil operator and return its :class:`StructuredDeviceSolver`.

    The C points are the stride-2 sublattice of the coarsened dims, the
    interpolation is multi-pass direct interpolation, R = P^T, and the
    coarse operators are Galerkin products.  ``A`` is scipy sparse (or
    dense numpy) or a :class:`DIAMatrix` (then ``grid`` is required);
    ``grid`` is inferred by :func:`detect_grid` when None.  ``stride`` is
    2, a per-dim tuple of 1 and 2 (semicoarsening) or ``'auto'``: the dims
    whose coupling is within 4x of the strongest coarsen, the couplings
    rescaled by 1/s^2 per level.  Smoothers: ``jacobi``, ``richardson``
    or ``chebyshev`` specs, their spectral radii estimated on the device.
    ``mixed_precision=True`` also stores the finest operator in float64
    for the mixed-precision outer loop.

    An operator that is not a grid stencil goes to
    :func:`device_unstructured_rs_setup` with ``dtype``, ``device``,
    ``max_coarse``, ``max_levels``, ``mixed_precision`` and the smoothers
    the caller changed from ``("jacobi", {"omega": 4/3})`` (the
    reference's routing; the unstructured setup's defaults sweep twice).

    With a ``mesh`` (:func:`~pyamg_tpu_torch.parallel.make_solver_mesh`,
    every rank calling with the same arguments) the setup is partitioned
    (:func:`~pyamg_tpu_torch.parallel.partitioned_classical.
    partitioned_rs_setup`): ``A`` stays on the host, each rank builds its
    rows of every large level on its device (the mesh's), and the solver
    runs over a :class:`~pyamg_tpu_torch.parallel.ShardedHierarchy` equal
    to ``shard_hierarchy`` of the whole setup's.  An operator that is not
    a grid stencil raises there (the unstructured route is not
    partitioned), and so does ``mixed_precision=True``."""
    device = resolve_device(device if mesh is None or device is not None
                            else mesh.device)
    if mesh is not None and device != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    _check_dtype(dtype)
    grid = _stencil_grid_of(A, grid)
    if grid is None:
        if mesh is not None:
            raise _not_ported("the partitioned RS setup of an operator that "
                              "is not a grid stencil (the unstructured RS "
                              "route)", 14)
        default = ("jacobi", {"omega": 4.0 / 3.0})
        kw = {name: spec for name, spec in (("presmoother", presmoother),
                                            ("postsmoother", postsmoother))
              if spec != default}
        return device_unstructured_rs_setup(
            A, dtype=dtype, device=device, max_coarse=max_coarse,
            max_levels=max_levels, mixed_precision=mixed_precision, **kw)
    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)
    _check_smoother(pre_key)
    _check_smoother(post_key)
    if mesh is not None:
        from ..parallel.partitioned_classical import partitioned_rs_setup
        return partitioned_rs_setup(
            A, grid, mesh, dtype=dtype, stride=stride, max_coarse=max_coarse,
            max_levels=max_levels, pre_key=pre_key, post_key=post_key,
            mixed_precision=mixed_precision)
    grid, A_dia = _grid_operator(A, grid, dtype, device)
    plan, cur_grid = _coarsening_plan(A_dia, grid, stride, 2, max_coarse,
                                      max_levels)
    out_levels, Ac_dense, coarse_inv = _rs_setup_pipeline(
        A_dia, plan=tuple(plan), dtype=dtype, pre_key=pre_key,
        post_key=post_key)
    dev_levels, infos = _rs_levels(plan, out_levels, pre_key, post_key)
    return _structured_solver(A, grid, plan, cur_grid, dev_levels, infos,
                              Ac_dense, coarse_inv, dtype, device,
                              mixed_precision, "classical")


def device_air_setup(A, grid=None, dtype=torch.float32, device=None,
                     stride=2, max_coarse=400, max_levels=4, degree=2,
                     f_iterations=2, c_iterations=1, omega=1.0,
                     mixed_precision=False, mesh=None):
    """Build an AIR (approximate ideal restriction) hierarchy on
    ``device`` for a grid-stencil operator and return its
    :class:`StructuredDeviceSolver`: one-point prolongation, the local
    AIR restriction of ``degree`` (batched dense neighbourhood solves),
    the nonsymmetric Galerkin product, no pre-smoother and the masked
    F-then-C Jacobi after (``f_iterations`` sweeps on the F points, then
    ``c_iterations`` on the C points, weight ``omega``).

    ``stride`` is 2 or a per-dim tuple.  ``max_levels=4`` by default: the
    fixed C/F lattice keeps the degree-2 restriction near-exact for at
    most three coarsenings.  Solve a nonsymmetric problem with
    ``accel='fgmres'`` or ``'bicgstab'``, or stationary cycles.

    An operator that is not a grid stencil goes to
    :func:`device_unstructured_air_setup` with ``dtype``, ``device``,
    ``degree``, ``max_coarse``, ``max_levels``, ``f_iterations``,
    ``c_iterations``, ``omega`` and ``mixed_precision`` (the reference's
    routing).  A ``mesh`` raises: the partitioned AIR setup is not
    ported (its neighbourhood solves read a degree-2 halo), so build the
    hierarchy whole and shard it with ``shard_hierarchy``."""
    if mesh is not None:
        raise _not_ported("the partitioned AIR setup (device_air_setup(..., "
                          "mesh=mesh))", 14)
    device = resolve_device(device)
    _check_dtype(dtype)
    grid = _stencil_grid_of(A, grid)
    if grid is None:
        return device_unstructured_air_setup(
            A, dtype=dtype, device=device, degree=degree,
            max_coarse=max_coarse, max_levels=max_levels,
            f_iterations=f_iterations, c_iterations=c_iterations,
            omega=omega, mixed_precision=mixed_precision)
    grid, A_dia = _grid_operator(A, grid, dtype, device)
    _tup(stride, len(grid))                  # 'auto' is the RS setup's
    plan, cur_grid = _coarsening_plan(A_dia, grid, stride, 2, max_coarse,
                                      max_levels)
    out_levels, Ac_dense, coarse_inv = _air_setup_pipeline(
        A_dia, plan=tuple(plan), dtype=dtype, degree=int(degree))

    dev_levels = []
    infos = []
    for i, ((_, grid_p, strides), (A_p, P_emb, R_emb, dinv, fmask,
                                   cmask_r)) in enumerate(
            zip(plan, out_levels)):
        P, R = _embedded_transfers(plan, i, P_emb, R_emb)
        post = device_relaxation.masked_jacobi(
            dinv, (fmask, cmask_r),
            iters_per_mask=(int(f_iterations), int(c_iterations)),
            omega=float(omega))
        npad_lvl = int(np.prod(grid_p))
        dev_levels.append(DeviceLevel(
            A=A_p, P=P, R=R, pre=device_relaxation.identity(), post=post,
            n=npad_lvl, n_pad=int(A_p.n_pad)))
        infos.append({"level": i, "n": npad_lvl, "strides": strides,
                      "ndiags": A_p.ndiags})
    return _structured_solver(A, grid, plan, cur_grid, dev_levels, infos,
                              Ac_dense, coarse_inv, dtype, device,
                              mixed_precision, "air")
