"""Device smoothed-aggregation setup for unstructured (non-grid) operators
(counterpart of ``pyamg_tpu/engine/unstructured_setup.py``).

Any operator with bounded column windows under its ordering (a naturally
ordered FEM mesh, a graph Laplacian; others are RCM-reordered first, see
:class:`ReorderedSolver`) gets its SA hierarchy built on the device, in
the reference's stages and with the reference's decisions, so the port's
hierarchy is the reference's level for level:

- **graph passes** (strength, the distance-2 Luby MIS of the aggregate
  roots and its densify pass, aggregate assignment) are elementwise
  functions of :meth:`~pyamg_tpu_torch.sparse.window.WindowedELL.select`
  outputs (K14) reduced over the slot axis;
- **tentative and smoothed P** are built column index by column index:
  the aggregate's coarse index rides float32 payloads through the select,
  the norms are one transpose apply (K7), and P = (I - w D^-1 A) T holds
  k_A + 1 slots per row (duplicate columns merged afterwards when that
  shrinks the slot count);
- **RAP by banded chain probing**: A_c = P^T A P is recovered exactly from
  64-lane probe chains (P's residue stage in plain PyTorch, then A through
  K12 and P^T through K13), each chunk placed into the coarse band by one
  index assignment; the next level's windowed operator comes from a top-k
  extraction of the band.

The reference's TPU-shaped decisions that decide the hierarchy are kept:
``windowed_from_scipy(A, block=1024)``, ``_pick_geometry``'s w2 >= 1024,
the c_block cost model of :func:`_next_from_band`, ``_PROBE_K = 64``, the
hash weights per level and the float32 cast of each probe chain's output.
The reference's one-hot MXU idioms become indexing (the probe placement,
:func:`_band_to_dense`) and its ``lax.while_loop`` rounds Python loops
that read one flag per round, with the reference's caps.  Host reads per
level: one per MIS round and assignment round, the root mask, the
distinct-column count, the band's row-nnz bound and the column bounds.

Smoothers: ``jacobi``, ``richardson`` and ``chebyshev`` specs, as the
reference's (their spectral radii estimated on the device by power
iteration through K6).  ``mixed_precision=True`` raises, as in the
reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..backend import resolve_device
from ..sparse.dia import DenseOperator
from ..sparse.formats import fit, pad_to
from ..sparse.window import (TransposedWindowed, WindowedELL, _global_index,
                             windowed_from_scipy)
from . import relaxation as device_relaxation
from .device_setup import (_check_smoother, _not_ported, _ns_pinv,
                           _power_rho, _smoother_device_arrays,
                           _smoother_wrap, _spec_key)
from .hierarchy import DeviceHierarchy, DeviceLevel
from .setup import _hash_weights
from .solver import DeviceMultilevelSolver

__all__ = ["ComposedWindowed", "ReorderedSolver",
           "device_unstructured_sa_setup"]

# RAP probe chunk width, the reference's (its per-chunk fixed costs
# amortise over 64 lanes; here K12/K13 take them in four launches of 16)
_PROBE_K = 64
# Luby rounds cap (the reference's: a payload bug degrades the
# aggregation instead of looping forever)
_MAX_ROUNDS = 64
# band entries per pass of the extraction (a 512 MB float32 temporary; the
# level-0 band of the 640k mesh is 3.4 GB)
_PASS_ENTRIES = 2**27


# ---------------------------------------------------------------------------
# host-side structural planning (numpy interval arithmetic)
# ---------------------------------------------------------------------------

_SPAN_GR = 64   # rows per span group (host planning granularity)


class _SpanPlan:
    """Per group of ``gr`` consecutive rows, the min/max column the
    operator's pattern touches, with exact O(1) range min/max by sparse
    tables.  Level 0 builds it from the host CSR, coarser levels from the
    measured support of the extracted coarse operator."""

    def __init__(self, n, gr, lo, hi):
        self.n = n
        self.gr = gr
        self.lo = lo        # (ngroups,) int64 min col (n if empty row)
        self.hi = hi        # (ngroups,) int64 max col + 1 (0 if empty)
        ng = len(lo)
        levels = max(int(np.log2(max(ng, 1))) + 1, 1)
        self._tmin = [lo]
        self._tmax = [hi]
        for j in range(1, levels):
            h = 1 << (j - 1)
            prev_min, prev_max = self._tmin[-1], self._tmax[-1]
            if h >= len(prev_min):
                break
            self._tmin.append(np.minimum(prev_min[:-h], prev_min[h:]))
            self._tmax.append(np.maximum(prev_max[:-h], prev_max[h:]))

    def _range_minmax(self, g0, g1):
        """Elementwise exact min(lo[g0..g1]), max(hi[g0..g1])."""
        length = g1 - g0 + 1
        j = np.clip(np.int64(np.log2(np.maximum(length, 1))), 0,
                    len(self._tmin) - 1)
        # 2^j must not exceed length (a float log2 can overshoot)
        j = np.where((np.int64(1) << j) > length, j - 1, j)
        tm = self._tmin
        tM = self._tmax
        sz = np.array([len(t) for t in tm])
        g0b = np.minimum(g0, sz[j] - 1)
        g1b = np.clip(g1 - (np.int64(1) << j) + 1, 0, None)
        g1b = np.minimum(g1b, sz[j] - 1)
        out_lo = np.empty(len(g0), dtype=np.int64)
        out_hi = np.empty(len(g0), dtype=np.int64)
        for jj in np.unique(j):
            m = j == jj
            out_lo[m] = np.minimum(tm[jj][g0b[m]], tm[jj][g1b[m]])
            out_hi[m] = np.maximum(tM[jj][g0b[m]], tM[jj][g1b[m]])
        return out_lo, out_hi

    @classmethod
    def from_csr(cls, A, gr=_SPAN_GR):
        n = A.shape[0]
        ng = -(-max(n, 1) // gr)
        lo = np.full(ng * gr, np.int64(A.shape[1]))
        hi = np.zeros(ng * gr, dtype=np.int64)
        lens = np.diff(A.indptr)
        nz = lens > 0
        if A.nnz:
            lo[:n][nz] = A.indices[A.indptr[:-1][nz]]
            hi[:n][nz] = A.indices[A.indptr[1:][nz] - 1] + 1
        return cls(n, gr, lo.reshape(ng, gr).min(axis=1),
                   hi.reshape(ng, gr).max(axis=1))

    def _expand_once(self, lo, hi):
        ng = len(self.lo)
        g0 = np.clip(lo // self.gr, 0, ng - 1)
        g1 = np.clip((hi - 1) // self.gr, 0, ng - 1)
        out_lo, out_hi = self._range_minmax(g0.astype(np.int64),
                                            g1.astype(np.int64))
        return np.minimum(out_lo, lo), np.maximum(out_hi, hi)

    def hull(self, lo, hi, dist):
        for _ in range(dist):
            lo, hi = self._expand_once(lo, hi)
        return np.clip(lo, 0, self.n), np.clip(hi, 0, self.n)


def _plan_windows(cum, lo, hi):
    """Map fine-index intervals [lo, hi) to coarse-index intervals via
    the host cumsum of the root mask (cum[p] = #roots in [0, p))."""
    clo = cum[lo]
    chi = cum[hi]
    return clo, np.maximum(chi, clo + 1)


def _pick_geometry(col_lo, col_hi, block_rows, m_cols):
    """(w2, starts, m_chunks) of a WindowedELL whose row block b must see
    columns [col_lo[b], col_hi[b]): w2 = pow2 >= max width and >= 1024
    (the TPU's minimum, kept so the layout is the reference's),
    starts[b] = floor(col_lo / w2) clipped."""
    width = int((col_hi - col_lo).max()) if len(col_lo) else 1
    w2 = 1024
    while w2 < width:
        w2 *= 2
    starts = np.minimum(col_lo // w2,
                        np.maximum((col_hi - 1) // w2 - 1, 0))
    starts = np.maximum(starts, 0).astype(np.int32)
    m_chunks = max(pad_to(max(m_cols, 1), w2) // w2,
                   int(starts.max()) + 2)
    return int(w2), starts, int(m_chunks)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def _flat(v3, n_pad):
    """(nb, k, block) -> slot-wise (k, n_pad); rows block-major."""
    nb, k, B = v3.shape
    return v3.permute(1, 0, 2).reshape(k, nb * B)[:, :n_pad]


def _unflat(v_kn, nb, block, n_pad):
    """Slot-wise (k, n) -> (nb, k, block), the inverse of :func:`_flat`."""
    k = v_kn.shape[0]
    pad = nb * block - v_kn.shape[1]
    if pad:
        v_kn = F.pad(v_kn, (0, pad))
    return v_kn.reshape(k, nb, block).permute(1, 0, 2).contiguous()


def _make_windowed(vals_kn, cols_kn, n, geometry, dtype, nnz):
    """A WindowedELL from slot-wise (k, n) values and float32 columns on
    the device and the host geometry (block, w2, starts, m_chunks)."""
    block, w2, starts, m_chunks = geometry
    n_pad = pad_to(n, block)
    k = vals_kn.shape[0]
    padw = n_pad - vals_kn.shape[1]
    if padw:
        vals_kn = F.pad(vals_kn, (0, padw))
        cols_kn = F.pad(cols_kn, (0, padw))
    nb = n_pad // block
    dev = vals_kn.device
    starts_dev = (starts.to(device=dev, dtype=torch.int32)
                  if isinstance(starts, torch.Tensor)
                  else torch.as_tensor(np.asarray(starts), dtype=torch.int32,
                                       device=dev))
    base = (starts_dev.to(torch.float32) * w2)[:, None, None]
    v3 = vals_kn.reshape(k, nb, block).permute(1, 0, 2)
    c3 = cols_kn.reshape(k, nb, block).permute(1, 0, 2)
    # zero slots may carry garbage columns: clamp them in range
    local = torch.clamp(torch.where(v3 != 0, c3 - base, 0.0), 0, 2 * w2 - 1)
    return WindowedELL(data=v3.to(dtype).contiguous(),
                       idx=torch.round(local).to(torch.int32).contiguous(),
                       starts=starts_dev.contiguous(),
                       shape=(n, m_chunks * w2),
                       block=block, w2=w2, m_chunks=m_chunks, nnz=nnz)


# ---------------------------------------------------------------------------
# stage A: strength + Luby MIS roots
# ---------------------------------------------------------------------------

def _strength_mask(W: WindowedELL, theta):
    """Symmetric SA strength over the window slots:
    |a_ij| >= theta * sqrt(|a_ii a_jj|), off-diagonal, nonzero.
    Returns ((k, n) bool mask, (k, n) |a_ij|, (k, n) column)."""
    n_pad = W.n_pad
    diag = W.diagonal()
    seld = W.select(diag)                                # a_jj per slot
    data = _flat(W.data, n_pad)
    col = _flat(_global_index(W), n_pad)
    row = torch.arange(n_pad, device=W.device)[None, :]
    ajj = _flat(seld, n_pad)
    offd = (col != row) & (data != 0)
    thr = theta * torch.sqrt(torch.abs(diag)[None, :] * torch.abs(ajj))
    mask = offd & (torch.abs(data) >= thr) & (torch.abs(data) > 0)
    return mask, torch.abs(data), col


def _indicator(b):
    """A bool vector as the float32 0/1 payload of a select."""
    return b.to(torch.float32)


def _stage_roots(W: WindowedELL, theta=0.0, seed=0, densify=True):
    """Strength + distance-2 Luby MIS over the windowed adjacency, then
    (``densify``) a distance-1 Luby MIS of the uncovered shell promoted to
    secondary roots.  Returns the root mask (n_pad,) float32.  Payloads
    are finite: "absent" is the sentinel -1.0 (weights lie in [0, 1)),
    indicators are 0/1."""
    n_pad = W.n_pad
    valid = W.diagonal() != 0
    mask, _, _ = _strength_mask(W, theta)
    w = _hash_weights(n_pad, seed, device=W.device)

    def nbr_max(x):
        sel = _flat(W.select(x), n_pad)                  # (k, n)
        return torch.amax(torch.where(mask, sel, float("-inf")), dim=0)

    def luby(state, body):
        it = 0
        while it < _MAX_ROUNDS and bool(torch.any(state == -1)):
            state = body(state)
            it += 1
        return state

    def mis2_round(state):
        und = state == -1
        wv = torch.where(und, w, -1.0)
        # the distance<=2 undecided max is self-inclusive (the round trip
        # through a neighbour), so winners compare with >=
        m2 = nbr_max(torch.maximum(wv, torch.clamp_min(nbr_max(wv), -1.0)))
        winners = und & (wv >= m2)
        state = state.masked_fill(winners, 1)
        e1 = nbr_max(_indicator(winners)) > 0.5
        e2 = nbr_max(_indicator(e1)) > 0.5
        return state.masked_fill((state == -1) & (e1 | e2), 0)

    state = luby(torch.where(valid, -1, 0).to(torch.int8), mis2_round)
    root = state == 1
    if not densify:
        return _indicator(root)

    # densify: promote a maximal independent subset of the shell (valid,
    # non-root, no root neighbour) to secondary roots
    adj_root = nbr_max(_indicator(root)) > 0.5
    shell = valid & ~root & ~adj_root

    def mis1_round(s):
        und = s == -1
        wv = torch.where(und, w, -1.0)
        winners = und & (wv >= torch.clamp_min(nbr_max(wv), -1.0))
        s = s.masked_fill(winners, 1)
        e1 = nbr_max(_indicator(winners)) > 0.5
        return s.masked_fill((s == -1) & e1, 0)

    state2 = luby(torch.where(shell, -1, 0).to(torch.int8), mis1_round)
    return _indicator(root | (state2 == 1))


# ---------------------------------------------------------------------------
# stage B: assignment, tentative, smoothed P
# ---------------------------------------------------------------------------

def _assign_cval(W, mask, root_f, maxrounds=2):
    """Aggregate coarse index per node, propagated through selects: roots
    take their cumsum index; round 1 joins the strongest adjacent root,
    round 2 the strongest assigned neighbour's aggregate (the first slot
    attaining the max wins a tie).  Returns (cval float32 (n,), assigned
    bool (n,)); stragglers park on index 0 with zero tentative weight."""
    n_pad = W.n_pad
    valid = W.diagonal() != 0
    cum = torch.cumsum(root_f, 0) - root_f          # exact below 2^24
    cval = torch.where(root_f > 0.5, cum, -1.0)
    absd = _flat(torch.abs(W.data), n_pad)

    def round_(cval):
        selc = _flat(W.select(cval), n_pad)              # neighbour cval
        cand = torch.where(mask & (selc >= 0), absd, float("-inf"))
        best = torch.amax(cand, dim=0)
        is_best = (cand == best[None, :]) & torch.isfinite(cand)
        first = torch.argmax(is_best.to(torch.int32), dim=0)
        sel_best = selc.gather(0, first[None, :])[0]
        newly = (cval < 0) & valid & torch.isfinite(best)
        return torch.where(newly, sel_best, cval)

    it = 0
    while it < maxrounds and bool(torch.any((cval < 0) & valid)):
        cval = round_(cval)
        it += 1
    assigned = cval >= 0
    cval = torch.where(assigned, cval, 0.0)
    return cval, assigned & valid


def _stage_build_p(W, root_f, B_in, *, theta, omega, dtype, t_geom,
                   p_geom, improve_iters=0, s_geom=None):
    """Assignment + tentative + smoothed prolongator.  With ``s_geom`` (A's
    own geometry) also the second smoothing factor S = I - omega D^-1 A,
    its identity in a dedicated slot, for P2 = S P (ComposedWindowed).
    Returns (T, P, dinv, rho, norms, cval, S or None)."""
    n = W.shape[0]
    n_pad = W.n_pad
    diag = W.diagonal()
    valid = diag != 0
    dinv = torch.where(valid, 1.0 / torch.where(valid, diag, 1), 0)
    mask, _, _ = _strength_mask(W, theta)
    cval, assigned = _assign_cval(W, mask, root_f)

    # the candidate, ones or the given one, in float32: the reference's
    # ones are weakly typed, so tv = tvals / seln below is float32 unless
    # the candidate improvement promoted it to the operator's dtype
    Bv = (valid.to(torch.float32) if B_in is None
          else torch.where(valid, B_in, 0.0))
    rho = _power_rho(W, dinv)
    if improve_iters:
        om_i = 1.0 / torch.clamp_min(rho, 1e-30)
        Bv = Bv.to(W.dtype)
        for _ in range(improve_iters):
            Bv = Bv - om_i * (dinv * (W @ Bv))
        Bv = Bv / torch.clamp_min(torch.max(torch.abs(Bv)), 1e-30)

    tvals = torch.where(assigned, Bv, 0.0)
    # unnormalized tentative T0: row i -> column cval(i), value B_i
    T0 = _make_windowed(tvals[None, :], cval[None, :], n, t_geom, dtype,
                        nnz=n)
    # fit_candidates for one column: norms^2 = T0^T B, coarse B = norms
    norms2 = T0.rmatvec(fit(tvals.to(dtype), T0.n_pad))
    norms = torch.sqrt(torch.clamp_min(norms2, 0.0))
    seln = _flat(T0.select(norms.to(torch.float32)), n_pad)[0]
    tv = torch.where(seln > 0, tvals / torch.where(seln > 0, seln, 1), 0.0)
    T = _make_windowed(tv[None, :], cval[None, :], n, t_geom, dtype, nnz=n)

    # P = (I - omega D^-1 A) T: k_A slots (columns cval(j), values
    # -omega dinv_i a_ij tv_j) + 1 slot (cval(i), tv_i); duplicates unmerged
    om = omega / torch.clamp_min(rho, 1e-30)
    sel_cval = _flat(W.select(cval), n_pad)
    sel_tv = _flat(W.select(tv.to(torch.float32)), n_pad)
    data = _flat(W.data, n_pad)
    pvals = -(om * dinv)[None, :] * data * sel_tv
    pcols = torch.where(data != 0, sel_cval, 0.0)
    pvals = torch.where(data != 0, pvals, 0.0)
    pvals_all = torch.cat([tv[None, :], pvals], dim=0)
    pcols_all = torch.cat([cval[None, :], pcols], dim=0)
    P = _make_windowed(pvals_all, pcols_all, n, p_geom, dtype,
                       nnz=int(W.nnz + n))
    S = None
    if s_geom is not None:
        colf = _flat(_global_index(W), n_pad).to(torch.float32)
        rowf = torch.arange(n_pad, device=W.device,
                            dtype=torch.float32)[None, :]
        ident = torch.where(valid, 1.0 - om * dinv * diag, 1.0)
        offv = torch.where((colf != rowf) & (data != 0),
                           -(om * dinv)[None, :] * data, 0.0)
        s_vals = torch.cat([ident[None, :], offv], dim=0)
        s_cols = torch.cat([rowf, colf], dim=0)
        S = _make_windowed(s_vals, s_cols, n, s_geom, dtype,
                           nnz=int(W.nnz + n))
    return T, P, dinv.to(dtype), rho, norms, cval, S


# ---------------------------------------------------------------------------
# duplicate-column slot merging
# ---------------------------------------------------------------------------

def _first_and_merged(vals, cols):
    """Per slot (k, n): whether it is the first live slot of its column in
    its row, and the sum of the live values of its column (slot order)."""
    k = vals.shape[0]
    live = vals != 0
    slot = torch.arange(k, device=vals.device)[:, None]
    dup = torch.zeros_like(live)
    merged = torch.zeros_like(vals)
    for j in range(k):
        same_j = (cols == cols[j][None, :]) & live & live[j][None, :]
        dup |= same_j & (slot > j)
        merged = merged + torch.where(same_j, vals[j][None, :], 0.0)
    return live & ~dup, merged


def _max_distinct(P: WindowedELL):
    """Max over rows of the number of distinct live columns (0-d device
    tensor; one read decides whether merging pays)."""
    first, _ = _first_and_merged(_flat(P.data, P.n_pad),
                                 _flat(_global_index(P), P.n_pad))
    return torch.max(torch.sum(first.to(torch.int32), dim=0))


def _merge_slots(P: WindowedELL, *, k_new, geometry, dtype):
    """Merge duplicate-column slots and compact to ``k_new`` slots by
    top-|value| rounds (the first slot wins a tie).  With k_new = the
    max distinct count nothing is dropped."""
    n = P.shape[0]
    n_pad = P.n_pad
    vals = _flat(P.data, n_pad)
    cols = _flat(_global_index(P), n_pad)
    first, merged = _first_and_merged(vals, cols)
    cur = torch.where(first, merged, 0.0)
    out_v, out_c = [], []
    for _ in range(k_new):
        a = torch.abs(cur)
        m = torch.amax(a, dim=0)
        pick = torch.argmax((a == m[None, :]).to(torch.int32), dim=0)[None]
        live = m > 0
        out_v.append(torch.where(live, cur.gather(0, pick)[0], 0.0))
        out_c.append(torch.where(live, cols.gather(0, pick)[0], 0))
        cur = cur.scatter(0, pick, 0.0)
    return _make_windowed(torch.stack(out_v),
                          torch.stack(out_c).to(torch.float32), n,
                          geometry, dtype, nnz=int(n * k_new))


# ---------------------------------------------------------------------------
# composed transfer operators
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ComposedWindowed:
    """Product of windowed factors applied right to left: P = F0 F1
    (P @ x = F0 @ (F1 @ x)), the ``smooth_passes=2`` prolongator S P.  A
    vector or a K-major (K, n) stack goes through every factor."""

    factors: tuple          # (F0, F1, ...) applied right-to-left

    @property
    def shape(self):
        return (self.factors[0].shape[0], self.factors[-1].shape[1])

    @property
    def nnz(self):
        # structural estimate: product of the factors' row supports
        k = 1
        for f in self.factors:
            k *= max(f.nnz // max(f.shape[0], 1), 1)
        return int(self.shape[0] * k)

    @property
    def n_pad(self):
        return self.factors[0].n_pad

    @property
    def m_chunks(self):
        return self.factors[-1].m_chunks

    @property
    def w2(self):
        return self.factors[-1].w2

    @property
    def dtype(self):
        return self.factors[0].dtype

    def matvec(self, x):
        for f in reversed(self.factors):
            x = f.matvec(x)
        return x

    def rmatvec(self, x):
        for f in self.factors:
            x = f.rmatvec(fit(x, f.n_pad))
        return x

    def __matmul__(self, x):
        return self.matvec(x)


# ---------------------------------------------------------------------------
# RAP by banded chain probing
# ---------------------------------------------------------------------------

def _p_residue_matmat(P, d0, K, period, nc_pad, n_pad):
    """P @ V for the residue probes V[c, j] = 1[c = d0 + j (mod period)],
    c < nc_pad, as a K-major (K, n_pad) stack, from P's own slots (no
    windowed kernel): Y[j, i] = sum of P's live values in row i whose
    column is d0 + j modulo the period.  One scatter per slot (a row's
    slot lands once), so the sum runs in slot order."""
    if isinstance(P, ComposedWindowed):
        last = P.factors[-1]
        Y = _p_residue_matmat(last, d0, K, period, nc_pad, last.n_pad)
        for f in reversed(P.factors[:-1]):
            Y = f @ Y
        return Y[:, :n_pad]
    pcol = _global_index(P)                               # (nb, k, block)
    lane = pcol % period - d0
    hit = (lane >= 0) & (lane < K) & (pcol < nc_pad) & (P.data != 0)
    m = P.n_pad
    rows = torch.arange(m, device=P.device).reshape(-1, 1, P.block)
    flat = torch.where(hit, lane, 0) * m + rows
    vals = torch.where(hit, P.data, 0.0)
    Y = torch.zeros(K * m, dtype=P.dtype, device=P.device)
    for s in range(P.k):
        Y.index_add_(0, flat[:, s].reshape(-1), vals[:, s].reshape(-1))
    return Y.reshape(K, m)[:, :n_pad]


def _probe_rap(A_w, P, cstarts, *, period, K, nc_pad, bc, dtype, R=None):
    """A_c = R A P recovered exactly by banded probing, R = P^T unless
    given (the AIR setup's Neumann restriction: the chain P, then A, then
    R).  ``cstarts`` (nb_c,) int64 = per-coarse-block window starts;
    returns the band (nb_c, bc, period): residue d lands for coarse block
    b at position (d - cstart_b) mod period, a bijection, so each chunk is
    placed by one index assignment of its float32-cast values."""
    if R is None:
        R = TransposedWindowed(P)
    n_pad = A_w.n_pad
    nchunks = -(-period // K)
    nb_c = nc_pad // bc
    A_band = torch.zeros((nb_c, bc, period), dtype=dtype,
                         device=A_w.device)
    for c in range(nchunks):
        d0 = c * K
        Y1 = _p_residue_matmat(P, d0, K, period, nc_pad, n_pad)
        Y2 = A_w @ Y1                                     # K12
        Y3 = R @ Y2                                       # K13
        kv = min(K, period - d0)                          # lanes < period
        Yc = Y3[:kv, :nc_pad].to(torch.float32)
        d = d0 + torch.arange(kv, device=A_w.device)
        w = torch.remainder(d[None, :] - cstarts[:, None], period)
        A_band.scatter_(2, w[:, None, :].expand(nb_c, bc, kv),
                        Yc.T.reshape(nb_c, bc, kv).to(dtype))
    return A_band


def _row_passes(n_rows, width):
    """Row ranges of the band taken in one pass, ~_PASS_ENTRIES entries
    each, so that no full-band temporary is formed."""
    step = max(1, _PASS_ENTRIES // max(width, 1))
    return [(r0, min(n_rows, r0 + step)) for r0 in range(0, n_rows, step)]


def _extract_topk(A_band, kc):
    """The kc largest-|value| entries of each band row, in the reference's
    order (descending |value|, the first position among ties), by
    ``torch.topk`` over row chunks.  Zero picks carry position 0.
    Returns (vals (kc, nb_c * bc), ws (kc, nb_c * bc) float32 band
    positions)."""
    nb_c, bc, W = A_band.shape
    flat = A_band.reshape(nb_c * bc, W)
    n = flat.shape[0]
    vals = torch.empty((kc, n), dtype=A_band.dtype, device=A_band.device)
    ws = torch.empty((kc, n), dtype=torch.float32, device=A_band.device)
    for r0, r1 in _row_passes(n, W):
        blk = flat[r0:r1]
        a, pos = torch.topk(torch.abs(blk), kc, dim=1)
        pos, order = torch.sort(pos, dim=1)
        a = a.gather(1, order)
        a, order = torch.sort(a, dim=1, descending=True, stable=True)
        pos = pos.gather(1, order)
        live = a > 0
        vals[:, r0:r1] = torch.where(live, blk.gather(1, pos), 0.0).T
        ws[:, r0:r1] = torch.where(live, pos, 0).T.to(torch.float32)
    return vals, ws


def _band_nnz_max(A_band):
    """Max stored nonzeros over the band's rows (0-d device tensor)."""
    flat = A_band.reshape(-1, A_band.shape[-1])
    return torch.stack([torch.max(torch.count_nonzero(flat[r0:r1], dim=-1))
                        for r0, r1 in _row_passes(*flat.shape)]).max()


def _col_bounds(vals, cols, *, gr):
    """Per ``gr``-row group [min, max] column of the extracted coarse
    operator's live entries; empty groups give (+inf, -inf)."""
    kc, n = vals.shape
    ng = -(-n // gr)
    pad = ng * gr - n
    if pad:
        vals = F.pad(vals, (0, pad))
        cols = F.pad(cols, (0, pad))
    live = vals != 0
    cm = torch.where(live, cols, float("inf")).reshape(kc, ng, gr)
    cM = torch.where(live, cols, float("-inf")).reshape(kc, ng, gr)
    return torch.amin(cm, dim=(0, 2)), torch.amax(cM, dim=(0, 2))


def _band_to_dense(A_band, cstarts, *, nc, nc_pad):
    """The (small) coarsest banded operator as a dense (nc_pad, nc_pad)
    tensor: dense[b * bc + r, cstart_b + w] = A_band[b, r, w]."""
    nb_c, bc, W = A_band.shape
    cols = cstarts[:, None] + torch.arange(W, device=A_band.device)[None, :]
    wide = torch.zeros((nb_c, bc, nc_pad + W), dtype=A_band.dtype,
                       device=A_band.device)
    wide.scatter_(2, cols[:, None, :].expand(nb_c, bc, W), A_band)
    return wide[:, :, :nc_pad].reshape(nb_c * bc, nc_pad)[:nc_pad]


def _next_from_band(A_band, cstarts, nc, nc_pad, bc, dtype):
    """Banded coarse operator -> next-level WindowedELL + its span plan:
    top-k extraction, then the windowed geometry from the measured
    support, its row block chosen by the reference's cost model."""
    kc = max(int(_band_nnz_max(A_band)), 1)
    vals, ws = _extract_topk(A_band, kc)                 # (kc, nc_pad)
    cs_rows = torch.repeat_interleave(cstarts.to(torch.float32), bc)[:nc_pad]
    cols = ws + cs_rows[None, :]

    def bounds(gr):
        lo, hi = _col_bounds(vals, cols, gr=gr)
        return torch.stack([lo, hi]).cpu().numpy()       # one host read

    best = None
    for c_block in ((1024, 512, 256) if nc >= 4096 else (256,)):
        nb2 = pad_to(nc, c_block) // c_block
        blo_h, bhi_h = bounds(c_block)[:, :nb2]
        ok_b = np.isfinite(blo_h)
        g_lo = np.where(ok_b, blo_h, 0).astype(np.int64)
        g_hi = np.maximum(np.where(ok_b, bhi_h, 0).astype(np.int64) + 1,
                          g_lo + 1)
        c_w2, c_starts, c_mch = _pick_geometry(g_lo, g_hi, c_block, nc)
        cost = nb2 * 0.15e-6 + kc * nc * (2 * c_w2 / 128) * 8e-12
        if best is None or cost < best[0]:
            best = (cost, c_block, c_w2, c_starts, c_mch)
    _, c_block, c_w2, c_starts, c_mch = best
    slo_h, shi_h = bounds(bc)
    cur = _make_windowed(vals[:, :nc], cols[:, :nc], nc,
                         (c_block, c_w2, c_starts, c_mch), dtype,
                         nnz=int(kc * nc))
    ok_s = np.isfinite(slo_h)
    spans = _SpanPlan(
        nc, bc,
        np.where(ok_s, slo_h, nc).astype(np.int64),
        np.where(ok_s, shi_h + 1, 0).astype(np.int64))
    return cur, spans


# ---------------------------------------------------------------------------
# reordering
# ---------------------------------------------------------------------------

def _sym_abs(A):
    """|A| + |A^T| as CSR: the symmetrized structure of a CSR ``A``."""
    Aa = sp.csr_matrix((np.abs(A.data), A.indices, A.indptr),
                       shape=A.shape)
    return (Aa + Aa.T).tocsr()


def _rcm_perm(A):
    """RCM permutation over the symmetrized structure |A| + |A^T|."""
    from scipy.sparse import csgraph
    return np.asarray(csgraph.reverse_cuthill_mckee(
        _sym_abs(A), symmetric_mode=True)).astype(np.int64)


def _windowed_or_reordered(A, dtype, device, reorder, retry):
    """(A as sorted CSR, its WindowedELL on ``device``); or, for an
    operator that is not windowable under its ordering and ``reorder=
    "auto"``, ``retry(A_perm, perm)`` on its RCM reordering (the caller's
    setup there, in a :class:`ReorderedSolver`)."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    if A.shape[0] >= 2 ** 24:
        raise ValueError("unstructured device setup requires n < 2^24 "
                         "(float32-exact index payloads)")
    W = windowed_from_scipy(A, dtype=dtype, device=device, block=1024)
    if W is None:
        if reorder == "auto":
            perm = _rcm_perm(A)
            Ap = A[perm][:, perm].tocsr()
            if windowed_from_scipy(Ap, dtype=dtype, device=device,
                                   block=1024) is not None:
                return ReorderedSolver(retry(Ap, perm), perm)
        raise ValueError(
            "operator is not windowable under its ordering (even after "
            "RCM reordering); use the host setup path")
    return A, W


class ReorderedSolver:
    """Solve wrapper for a hierarchy built in RCM-permuted space: permutes
    b (and x0) and un-permutes x around each solve.  A tensor is indexed
    on its own device; a numpy array gives a numpy array.  The residual
    history is ordering-invariant."""

    def __init__(self, inner, perm):
        self._inner = inner
        self._perm = np.asarray(perm)
        self._iperm = np.argsort(self._perm)
        self.hierarchy = inner.hierarchy
        self.setup_info = dict(getattr(inner, "setup_info", {}))
        self.setup_info["reordered"] = "rcm"

    @staticmethod
    def _take(v, order):
        if not isinstance(v, torch.Tensor):
            return np.asarray(v)[order]
        return v[torch.as_tensor(order, device=v.device)]

    def solve(self, b, x0=None, **kw):
        bp = self._take(b, self._perm)
        if x0 is not None:
            x0 = self._take(x0, self._perm)
        out = self._inner.solve(bp, x0=x0, **kw)
        if isinstance(out, tuple):          # return_info=True
            x, info = out
            return self._take(x, self._iperm), info
        return self._take(out, self._iperm)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def device_unstructured_sa_setup(A, B=None, dtype=torch.float32, device=None,
                                 theta=0.0, omega=4.0 / 3.0, max_coarse=1500,
                                 max_levels=10,
                                 presmoother=("jacobi",
                                              {"omega": 4.0 / 3.0}),
                                 postsmoother=("jacobi",
                                               {"omega": 4.0 / 3.0}),
                                 improve_candidates_iters=0,
                                 mixed_precision=False, seed=0,
                                 aggregate="standard", reorder="auto",
                                 smooth_passes=None, profile=None):
    """Build an SA hierarchy on ``device`` for an unstructured operator
    and return its DeviceMultilevelSolver (or a :class:`ReorderedSolver`
    around one).

    ``A``: scipy sparse, structurally symmetric pattern, windowable under
    its ordering; with ``reorder="auto"`` an operator that is not is
    RCM-reordered, else ValueError.  ``aggregate``: ``"standard"``
    (densified MIS-2 roots) or ``"aggressive"`` (radius-2 aggregates).
    ``smooth_passes=2`` adds a second prolongation-smoothing factor
    (:class:`ComposedWindowed`).  ``profile={}`` receives the seconds of
    each stage per level (``"L<lev>.<stage>"``), synchronised with the
    card."""
    if aggregate not in ("standard", "aggressive"):
        raise ValueError(f"unknown aggregate mode {aggregate!r}")
    if smooth_passes is None:
        smooth_passes = 1
    if smooth_passes not in (1, 2):
        raise ValueError("smooth_passes must be 1 or 2")
    if mixed_precision:
        raise NotImplementedError(
            "mixed precision (a float64 outer Krylov loop) is not offered "
            "by the unstructured device setup, as in the reference: use "
            "the float32 device solve (true-residual floor ~1e-6 "
            "relative) or dtype=torch.float64")
    if dtype not in (torch.float32, torch.float64):
        raise _not_ported(f"dtype {dtype}", 4)
    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)
    _check_smoother(pre_key)
    _check_smoother(post_key)
    device = resolve_device(device)

    def retry(Ap, perm):
        return device_unstructured_sa_setup(
            Ap, B=None if B is None else np.asarray(B).ravel()[perm],
            dtype=dtype, device=device, theta=theta, omega=omega,
            max_coarse=max_coarse, max_levels=max_levels,
            presmoother=presmoother, postsmoother=postsmoother,
            improve_candidates_iters=improve_candidates_iters, seed=seed,
            aggregate=aggregate, smooth_passes=smooth_passes, reorder=False,
            profile=profile)

    prep = _windowed_or_reordered(A, dtype, device, reorder, retry)
    if isinstance(prep, ReorderedSolver):
        return prep
    A, W = prep
    n = A.shape[0]
    spans = _SpanPlan.from_csr(A)
    B_dev = None
    if B is not None:
        B_dev = torch.as_tensor(np.asarray(B).ravel()[:n],
                                dtype=torch.float32, device=device)

    def _mark(label, lev, t0, sync=False):
        if profile is None:
            return time.perf_counter()
        if sync and device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        profile[f"L{lev}.{label}"] = t1 - t0
        return t1

    def _solver(levels, Ac_dense, nc, nc_pad):
        hier = DeviceHierarchy(levels=tuple(levels),
                               coarse_inv=_ns_pinv(Ac_dense), nc=nc,
                               nc_pad=nc_pad, dtype=dtype)
        dml = DeviceMultilevelSolver(hier)
        dml.setup_info = {"levels": infos}
        return dml

    ident = device_relaxation.identity()
    levels = []
    infos = []
    cur = W
    cur_n = n
    Bv = B_dev
    for lev in range(max_levels - 1):
        if cur_n <= max_coarse:
            break
        _t = time.perf_counter()
        # ---- stage A: roots on the device; one host read of the mask ---
        root_f = _stage_roots(cur, theta=float(theta), seed=seed + lev,
                              densify=(aggregate == "standard"))
        root_host = root_f.cpu().numpy() > 0.5
        _t = _mark("roots", lev, _t)
        nc = int(root_host.sum())
        if nc == 0 or nc >= cur_n:
            break
        cum = np.zeros(cur_n + 1, dtype=np.int64)
        np.cumsum(root_host[:cur_n], out=cum[1:])

        # ---- host window planning (structural span hulls) --------------
        nb = cur.data.shape[0]
        blo = np.arange(nb, dtype=np.int64) * cur.block
        bhi = np.maximum(np.minimum(blo + cur.block, cur_n), blo + 1)
        # T columns: roots within distance 2 of the block's rows; P:
        # distance 3 (tentative 2 + one smoothing hop)
        tlo, thi = _plan_windows(cum, *spans.hull(blo, bhi, 2))
        plo, phi = _plan_windows(cum, *spans.hull(blo, bhi, 3))
        t_w2, t_starts, t_mch = _pick_geometry(tlo, thi, cur.block, nc)
        p_w2, p_starts, p_mch = _pick_geometry(plo, phi, cur.block, nc)
        t_geom = (cur.block, t_w2, t_starts, t_mch)
        p_geom = (cur.block, p_w2, p_starts, p_mch)

        # coarse blocks and A_c windows: A_c = P^T A P reaches
        # 2 * (2 + passes) + 1 fine hops
        bc = 256
        nc_pad = pad_to(nc, bc)
        roots_pos = np.flatnonzero(root_host[:cur_n])
        cb_lo_fine = roots_pos[np.arange(0, nc, bc)]
        cb_hi_fine = roots_pos[np.minimum(np.arange(0, nc, bc) + bc - 1,
                                          nc - 1)] + 1
        ac_lo, ac_hi = _plan_windows(cum, *spans.hull(
            cb_lo_fine.astype(np.int64), cb_hi_fine.astype(np.int64),
            2 * (2 + smooth_passes) + 1))
        period = max(pad_to(int((ac_hi - ac_lo).max()), 16), 32)
        _t = _mark("plan", lev, _t)

        # ---- stage B: T/P/smoother arrays on the device ----------------
        Bt = None if Bv is None else fit(Bv, cur.n_pad)
        s_geom = None
        if smooth_passes == 2:
            s_geom = (cur.block, cur.w2, cur.starts, cur.m_chunks)
        T, P, dinv, rho, norms, cval, S2 = _stage_build_p(
            cur, root_f, Bt, theta=float(theta), omega=float(omega),
            dtype=dtype, t_geom=t_geom, p_geom=p_geom,
            improve_iters=int(improve_candidates_iters), s_geom=s_geom)
        # merge duplicate-column P slots (same-aggregate neighbours): the
        # slot count multiplies every windowed apply
        if P.k > 3:
            kd = int(_max_distinct(P))
            if kd < P.k - 1:
                P = _merge_slots(P, k_new=kd, geometry=p_geom, dtype=dtype)
        if S2 is not None:
            P = ComposedWindowed(factors=(S2, P))
        _t = _mark("build_p", lev, _t, sync=True)

        # ---- RAP probing -----------------------------------------------
        cstarts = torch.as_tensor(ac_lo, dtype=torch.int64, device=device)
        A_band = _probe_rap(cur, P, cstarts, period=period, K=_PROBE_K,
                            nc_pad=nc_pad, bc=bc, dtype=dtype)
        A_band.view(nc_pad, period)[nc:] = 0       # padded coarse rows
        _t = _mark("probe_rap", lev, _t, sync=True)

        # ---- smoothers + level assembly --------------------------------
        pre_arr = _smoother_device_arrays(pre_key, cur, dinv, rho, dtype)
        post_arr = _smoother_device_arrays(post_key, cur, dinv, rho, dtype)
        levels.append(DeviceLevel(
            A=cur, P=P, R=TransposedWindowed(P),
            pre=_smoother_wrap(pre_key, pre_arr),
            post=_smoother_wrap(post_key, post_arr),
            n=cur_n, n_pad=cur.n_pad))
        infos.append({"level": lev, "n": cur_n, "nc": nc,
                      "period": period, "k": cur.k,
                      "A_w2": cur.w2, "P_w2": p_w2, "T_w2": t_w2})

        # ---- next-level operator ---------------------------------------
        if nc <= max_coarse:
            Ac_dense = _band_to_dense(A_band, cstarts, nc=nc, nc_pad=nc_pad)
            levels.append(DeviceLevel(
                A=DenseOperator(data=Ac_dense, shape=(nc, nc), nnz=nc * nc),
                P=None, R=None, pre=ident, post=ident, n=nc, n_pad=nc_pad))
            return _solver(levels, Ac_dense, nc, nc_pad)

        cur, spans = _next_from_band(A_band, cstarts, nc, nc_pad, bc,
                                     dtype)
        del A_band
        _t = _mark("extract", lev, _t, sync=True)
        cur_n = nc
        # coarse candidate = per-aggregate norms (fit_candidates)
        Bv = norms[:nc].to(torch.float32)

    # loop exit: the coarsest level is the windowed cur, densified.  Its
    # K-lane apply to the identity gives the lanes A e_j, i.e. A^T as
    # rows, hence the transpose
    nc = cur_n
    nc_pad = cur.n_pad
    eye = torch.eye(nc_pad, dtype=dtype, device=device)
    Ac_dense = (cur @ eye).T.contiguous()
    levels.append(DeviceLevel(
        A=DenseOperator(data=Ac_dense, shape=(nc, nc), nnz=nc * nc),
        P=None, R=None, pre=ident, post=ident, n=nc, n_pad=nc_pad))
    return _solver(levels, Ac_dense, nc, nc_pad)
