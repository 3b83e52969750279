"""Device-built smoothed-aggregation setup for grid-stencil operators
(counterpart of ``pyamg_tpu/engine/device_setup.py``).

The hierarchy is built on the device from the operator's diagonals, with
no graph algorithm: aggregates are stride^d grid blocks, the transfer
operators are stored factored (P = S T as a smoothing DIA factor S and
per-point tentative values tv, R = P^T as S^T and tv), the Galerkin
product R A P is a DIA SpGEMM filtered to the offsets that survive
compaction, and each coarse operator is a strided slice of its fine-grid
embedding.  Every step runs eagerly in plain PyTorch (rolls, elementwise
products, reshape-sums, a 40-step power iteration whose SpMV is the K1
kernel, and a Newton-Schulz pseudo-inverse of the dense coarsest
operator by ``torch.matmul`` with TF32 off).  Nothing is read back to the
host: the smoother weights stay 0-d device tensors (``jacobi_dyn``).

The level loop, the padded-grid layout and the solve padding
(``_solve_pad``) are the reference's, so the port's hierarchy equals the
reference's level for level and n_pad for n_pad.  The reference's
one-hot contractions for the aggregate sum and spread (an MXU idiom) are
an exact reshape-and-sum and an expand here; both use the aggregate map
``f // stride`` per dimension, so R stays P^T to rounding.

The transfers and the grid transforms take K-major (K, n) lane stacks as
well as vectors, so :class:`StructuredDeviceSolver` solves an (n, K)
right-hand side lane by lane on the K-lane kernels (K8, K9, K11).
``lane_align=True`` pads each level's last grid dim to a multiple of
lcm(stride, 128) and the one before to lcm(stride, 8) (the reference's
layout for its batched route): a batched native float32 CG on such a
hierarchy runs the interleaved route (``engine/batched_cycle.py``, K15).

Not ported (each raises ``NotImplementedError``): operators that are not
grid stencils (the unstructured device setup, ROADMAP.md Queue 1 item 13)
and the ``richardson`` and ``chebyshev`` smoothers (item 8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..backend import resolve_device
from ..sparse.dia import (DenseOperator, DIAMatrix, dia_from_scipy,
                          dia_spgemm, dia_spmm_add, dia_spmm_scaled,
                          dia_spmv_add, dia_spmv_scaled, dia_transpose)
from ..sparse.formats import fit, pad_to
from . import relaxation as device_relaxation
from .hierarchy import DeviceHierarchy, DeviceLevel
from .krylov import _norm
from .setup import _hash_weights
from .solver import DeviceMultilevelSolver

__all__ = ["detect_grid", "device_sa_setup", "StructuredProlongator",
           "StructuredRestrictor", "StructuredDeviceSolver", "dia_transpose"]


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to pyamg_tpu_torch yet "
        f"(ROADMAP.md Queue 1 item {item})")


def detect_grid(A):
    """Infer the row-major grid shape of a stencil operator from its
    sparsity offsets (a copy of the reference's host function).

    The distinct structural offsets of a grid stencil are sums of per-dim
    unit steps: +-1 for the fastest dim, +-nx (+- 1) for the next (9-point
    stencils add the diagonals nx+-1), +-nx*ny (+- ...) for 3-D.  Recovery:
    the fastest-dim extent is the smallest offset > 2 present as
    {o-1, o, o+1} (FE) or bare o (FD); recurse on offsets/extent.  Raises
    ValueError when no consistent grid exists (more than 49 distinct
    offsets, as a permuted operator has, is never taken for a grid)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    coo = A.tocoo()
    signed = np.unique(coo.col - coo.row)
    if len(signed) > 49:
        raise ValueError(
            f"{len(signed)} distinct structural offsets — not a grid "
            "stencil; pass grid= explicitly or use the unstructured "
            "path")
    offs = np.unique(np.abs(signed))
    offs = offs[offs > 0]

    def next_extent(offs, limit):
        """Smallest plausible extent from offsets in (2, limit]."""
        big = offs[offs > 2]
        if len(big) == 0:
            return None
        o = int(big[0])
        s = set(offs.tolist())
        if o + 2 in s and o + 1 in s:
            return o + 1          # {nx-1, nx, nx+1} diagonals (FE)
        if o + 2 in s:
            return o + 1          # {nx-1, nx+1} without nx
        return o                  # bare nx (FD)

    dims = []
    cur = 1
    while True:
        rel = np.unique(offs[offs % cur == 0] // cur)
        rel = rel[rel > 0]
        ext = next_extent(rel, n)
        if ext is None:
            break
        cur *= ext
        dims.append(ext)
        if cur >= n:
            break
    if cur == 0 or n % max(cur, 1) != 0:
        raise ValueError(
            f"could not infer a grid from offsets {offs[:8].tolist()}…; "
            "pass grid= explicitly")
    lead = n // cur
    grid = (lead,) + tuple(reversed(dims)) if lead > 1 else tuple(
        reversed(dims))
    if int(np.prod(grid)) != n or len(grid) == 0:
        raise ValueError(
            f"inferred grid {grid} does not match n={n}; pass grid= "
            "explicitly")
    return grid


# ---------------------------------------------------------------------------
# offset <-> grid-coordinate bookkeeping (host, static)
# ---------------------------------------------------------------------------

def _offset_to_coords(o, grid):
    """Decompose a row-major linear offset into per-dim deltas; valid for
    stencil offsets whose per-dim delta magnitude is < dim/2."""
    coords = []
    for d in range(len(grid) - 1, -1, -1):
        size = grid[d]
        delta = ((o + size // 2) % size) - size // 2
        coords.append(int(delta))
        o = (o - delta) // size
    if o != 0:
        raise ValueError("offset does not decompose on this grid")
    return tuple(reversed(coords))


def _coords_to_offset(coords, grid):
    o = 0
    stride = 1
    for d in range(len(grid) - 1, -1, -1):
        o += coords[d] * stride
        stride *= grid[d]
    return int(o)


def _tup(v, dim):
    """A per-dim parameter: int -> (v,) * dim, tuple -> tuple."""
    if isinstance(v, (tuple, list)):
        if len(v) != dim:
            raise ValueError(f"expected {dim} per-dim values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * dim


def _padded_grid(grid, stride, lane_align=False):
    """The grid padded up to a multiple of the stride in each dim; with
    ``lane_align`` the last dim (when >= 512) pads to a multiple of
    lcm(stride, 128) and the second-to-last (when >= 64) to lcm(stride,
    8), the reference's lane-aligned layout (its grid rows are whole
    128-row tiles of the interleaved stacks)."""
    ss = _tup(stride, len(grid))
    nd = len(grid)
    out = []
    for d, (g, s) in enumerate(zip(grid, ss)):
        q = s
        if lane_align and d == nd - 1 and g >= 512:
            q = math.lcm(s, 128)
        elif lane_align and d == nd - 2 and g >= 64:
            q = math.lcm(s, 8)
        out.append(int(q * -(-g // q)))
    return tuple(out)


# ---------------------------------------------------------------------------
# grid transforms (pure data movement)
# ---------------------------------------------------------------------------

def _grid_pads(grid, grid_p):
    """F.pad's argument that pads a ``grid``-shaped tensor to ``grid_p``."""
    pads = []
    for g, gp in reversed(list(zip(grid, grid_p))):
        pads += [0, gp - g]
    return pads


def _grid_pad_vec(v, grid, grid_p):
    """Zero-pad a grid vector (row-major), or each lane of a (K, n) stack,
    to the padded grid layout."""
    lead = tuple(v.shape[:-1])
    v = v[..., : int(np.prod(grid))].reshape(lead + tuple(grid))
    return F.pad(v, _grid_pads(grid, grid_p)).reshape(lead + (-1,))


def _grid_unpad_vec(v, grid, grid_p):
    lead = tuple(v.shape[:-1])
    v = v.reshape(lead + tuple(grid_p))
    return v[(Ellipsis,) + tuple(slice(0, g) for g in grid)].reshape(
        lead + (-1,))


def _compact_fine(v, coarse_grid, stride, center):
    """Fine padded-grid vector -> its values at the aggregate centres."""
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    cc = _tup(center, dim)
    v = v.reshape(tuple(g * s for g, s in zip(coarse_grid, ss)))
    return v[tuple(slice(c, None, s) for s, c in zip(ss, cc))].reshape(-1)


def _blocked(coarse_grid, ss):
    """The (c0, s0, c1, s1, ...) view of a fine padded grid."""
    return tuple(x for c, s in zip(coarse_grid, ss) for x in (c, s))


def _block_sum(v, coarse_grid, stride):
    """Per-aggregate sum of a fine padded-grid vector, or of each lane of
    a (K, n) stack: the transpose of :func:`_broadcast_coarse` (both use
    the aggregate map f // stride)."""
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    lead = tuple(v.shape[:-1])
    return v.reshape(lead + _blocked(coarse_grid, ss)).sum(
        dim=tuple(len(lead) + d for d in range(1, 2 * dim, 2))).reshape(
            lead + (-1,))


def _broadcast_coarse(vc, coarse_grid, stride, center):
    """Replicate each coarse value over its stride^d fine block
    (out[f] = vc[f // stride] per dim), an exact copy, lane by lane for a
    (K, nc) stack.  ``center`` is immaterial (kept for signature
    parity)."""
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    lead = tuple(vc.shape[:-1])
    ones = tuple(x for c in coarse_grid for x in (c, 1))
    return vc.reshape(lead + ones).expand(
        lead + _blocked(coarse_grid, ss)).reshape(lead + (-1,))


def _block_norms(B, coarse_grid, stride):
    """Per-aggregate 2-norm of the candidate (fit_candidates' QR for a
    single column)."""
    return torch.sqrt(_block_sum(B * B, coarse_grid, stride))


def _relayout_dia(dia: DIAMatrix, grid, grid_p) -> DIAMatrix:
    """Re-lay a DIA operator from grid layout onto the padded grid."""
    if tuple(grid) == tuple(grid_p) and dia.n_pad == int(np.prod(grid)):
        return dia
    n = int(np.prod(grid))
    rows = []
    offsets = []
    for d, o in enumerate(dia.offsets):
        coords = _offset_to_coords(o, grid)
        offsets.append(_coords_to_offset(coords, grid_p))
        rows.append(_grid_pad_vec(dia.data[d][:n], grid, grid_p))
    order = np.argsort(offsets)
    return DIAMatrix(
        data=torch.stack([rows[i] for i in order]),
        offsets=tuple(int(offsets[i]) for i in order),
        shape=(int(np.prod(grid_p)),) * 2,
        nnz=dia.nnz)


def _dia_spgemm_filtered(A: DIAMatrix, B: DIAMatrix, keep_offsets):
    """C = A @ B keeping only the static ``keep_offsets`` (the R (A P)
    product: offsets that are not multiples of the stride per grid dim
    are structurally zero after compaction)."""
    keep = set(int(o) for o in keep_offsets)
    acc = {}
    for da, oa in enumerate(A.offsets):
        a = A.data[da]
        for db, ob in enumerate(B.offsets):
            oc = oa + ob
            if oc not in keep:
                continue
            term = a * torch.roll(B.data[db], -oa)
            acc[oc] = acc[oc] + term if oc in acc else term
    offsets = tuple(sorted(acc))
    return DIAMatrix(data=torch.stack([acc[o] for o in offsets]),
                     offsets=offsets, shape=(A.shape[0], B.shape[1]),
                     nnz=len(offsets) * A.shape[0])


def _compact_dia(A_emb: DIAMatrix, grid_p, stride, center) -> DIAMatrix:
    """The coarse operator from its fine-grid embedding: rows at the
    centre positions, each offset's per-dim deltas divided by the
    stride."""
    dim = len(grid_p)
    ss = _tup(stride, dim)
    coarse_grid = tuple(g // s for g, s in zip(grid_p, ss))
    out_offsets = []
    rows = []
    for d, o in enumerate(A_emb.offsets):
        coords = _offset_to_coords(o, grid_p)
        assert all(c % s == 0 for c, s in zip(coords, ss)), (o, coords)
        cc = tuple(c // s for c, s in zip(coords, ss))
        out_offsets.append(_coords_to_offset(cc, coarse_grid))
        rows.append(_compact_fine(A_emb.data[d], coarse_grid, stride,
                                  center))
    order = np.argsort(out_offsets)
    nc = int(np.prod(coarse_grid))
    return DIAMatrix(data=torch.stack([rows[i] for i in order]),
                     offsets=tuple(int(out_offsets[i]) for i in order),
                     shape=(nc, nc), nnz=len(out_offsets) * nc)


def _dia_to_dense(A: DIAMatrix):
    """A @ I as a dense (n_pad, n_pad) tensor, by the reference's rolled
    matmat (one nonzero term per entry, so exact)."""
    eye = torch.eye(A.n_pad, dtype=A.dtype, device=A.device)
    Y = A.data[0][:, None] * torch.roll(eye, -A.offsets[0], dims=0)
    for d in range(1, A.ndiags):
        Y = Y + A.data[d][:, None] * torch.roll(eye, -A.offsets[d], dims=0)
    return Y


# ---------------------------------------------------------------------------
# structured transfer operators
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StructuredProlongator:
    """P = S T applied factored, coarse padded-grid vector -> fine
    padded-grid vector: P xc = S (tv * spread(unpad(xc))).  The coarse
    side uses the coarse level's padded grid.  A K-major (K, nc) stack
    is prolongated lane by lane."""

    S: DIAMatrix                     # smoothing factor I - w D^-1 A
    tv: torch.Tensor                 # (prod(fine_grid_p),) tentative values
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]     # fine_grid_p // stride
    coarse_grid_p: Tuple[int, ...]   # the next level's padded grid
    stride: Any
    center: Any

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.S.ndiags

    @property
    def shape(self):
        return (int(np.prod(self.fine_grid_p)),
                int(np.prod(self.coarse_grid_p)))

    def _smooth_input(self, xc):
        # xc may carry solve padding beyond the coarse padded grid; the
        # grid lives in its leading prod(coarse_grid_p) entries
        xc = xc[..., : int(np.prod(self.coarse_grid_p))]
        xc = _grid_unpad_vec(xc, self.coarse_grid, self.coarse_grid_p)
        t = self.tv * _broadcast_coarse(xc, self.coarse_grid, self.stride,
                                        self.center)
        nf = int(np.prod(self.fine_grid_p))
        if self.S.n_pad != nf:
            t = F.pad(t, (0, self.S.n_pad - nf))
        return t

    def __matmul__(self, xc):
        return self.S @ self._smooth_input(xc)

    def apply_correction(self, xc, x):
        """x + P @ xc, the add in the SpMV's epilogue when x has the
        smoothing factor's length: K1 ``SPMV_ADD`` for a vector, K8
        ``add`` for a lane stack."""
        t = self._smooth_input(xc)
        if isinstance(self.S, DIAMatrix) and x.shape[-1] == self.S.n_pad:
            add = dia_spmm_add if x.ndim == 2 else dia_spmv_add
            return add(self.S, t, x)
        return x + fit(self.S @ t, x.shape[-1])


@dataclass(frozen=True)
class StructuredRestrictor:
    """R = P^T = T^T S^T applied factored:
    R r = pad(block_sum(tv * (S^T r))), lane by lane for a K-major
    stack."""

    St: DIAMatrix                    # S^T
    tv: torch.Tensor                 # padded to St.n_pad
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: Any
    center: Any

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.St.ndiags

    @property
    def shape(self):
        return (int(np.prod(self.coarse_grid_p)),
                int(np.prod(self.fine_grid_p)))

    @property
    def n_pad(self):
        return int(np.prod(self.coarse_grid_p))

    def __matmul__(self, r):
        # r arrives at the level's solve-padded length St.n_pad; the grid
        # lives in its leading prod(fine_grid_p) entries
        nf = int(np.prod(self.fine_grid_p))
        if isinstance(self.St, DIAMatrix) and self.tv.shape[0] == self.St.n_pad:
            # the tv scale in the SpMV's epilogue: K1 SPMV_SCALED, or K8
            # scale for a lane stack
            scaled = dia_spmm_scaled if r.ndim == 2 else dia_spmv_scaled
            y = scaled(self.St, r, self.tv)[..., :nf]
        else:
            y = (self.St @ r)[..., :nf] * self.tv[:nf]
        return self._finish(y)

    def _finish(self, y):
        """Per-aggregate block sum and coarse-grid pad: the back half of
        the restriction, shared with the fused zero-entry chain (K5)."""
        nf = int(np.prod(self.fine_grid_p))
        yc = _block_sum(y[..., :nf], self.coarse_grid, self.stride)
        return _grid_pad_vec(yc, self.coarse_grid, self.coarse_grid_p)


# ---------------------------------------------------------------------------
# one coarsening step
# ---------------------------------------------------------------------------

def _dinv_of(diag):
    return torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, 1), 0)


def _tentative_emb(B, grid_p, stride, center, dtype):
    """Embedded tentative prolongator T, the coarse candidate B_c and the
    per-point tentative values tv: T[i, r(i)] = B[i] / ||B||_agg(i)
    (fit_candidates for one column), stored as a DIA on the fine padded
    grid whose diagonals are selected by per-dim position masks."""
    dim = len(grid_p)
    ss = _tup(stride, dim)
    cc = _tup(center, dim)
    coarse_grid = tuple(g // s for g, s in zip(grid_p, ss))
    norms = _block_norms(B, coarse_grid, stride)
    norms_f = _broadcast_coarse(norms, coarse_grid, stride, center)
    tv = torch.where(norms_f > 0, B / torch.where(norms_f > 0, norms_f, 1),
                     0)
    pos = [torch.arange(g, device=B.device) % s for g, s in zip(grid_p, ss)]

    offsets = []
    rows = []
    for combo in np.ndindex(*[2 * s - 1 for s in ss]):
        coords = tuple(int(c) - (s - 1) for c, s in zip(combo, ss))
        # a fine point at in-block position p has root offset center - p,
        # so diagonal `coords` selects the points with p == center - coords
        masks = []
        ok = True
        for d in range(dim):
            want = cc[d] - coords[d]
            if not (0 <= want < ss[d]):
                ok = False
                break
            masks.append(pos[d] == want)
        if not ok:
            continue
        shape = [1] * dim
        shape[0] = grid_p[0]
        m = masks[0].reshape(shape)
        for d in range(1, dim):
            shape = [1] * dim
            shape[d] = grid_p[d]
            m = m & masks[d].reshape(shape)
        offsets.append(_coords_to_offset(coords, grid_p))
        rows.append(torch.where(m.reshape(-1), tv, 0).to(dtype))
    order = np.argsort(offsets)
    T = DIAMatrix(data=torch.stack([rows[i] for i in order]),
                  offsets=tuple(int(offsets[i]) for i in order),
                  shape=(int(np.prod(grid_p)),) * 2,
                  nnz=int(np.prod(grid_p)))
    return T, norms, tv.to(dtype)


def _power_rho(A: DIAMatrix, dinv=None, iters=40):
    """Spectral-radius estimate of D^-1 A by power iteration from the
    reference's hashed start vector; the SpMV is the K1 kernel on the
    card.  Returns a 0-d device tensor (never read to the host)."""
    v = _hash_weights(A.n_pad, 12345, device=A.device).to(A.dtype) - 0.5
    v = torch.where(A.diagonal() != 0, v, 0)
    v = v / _norm(v)
    for _ in range(iters):
        w = A @ v
        if dinv is not None:
            w = dinv * w
        nrm = _norm(w)
        v = w / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    w = A @ v
    if dinv is not None:
        w = dinv * w
    return _norm(w)


def _coarsen_level(A_p: DIAMatrix, B, grid_p, stride, center, omega, dtype,
                   rho=None):
    """One SA coarsening step on the padded grid.  Returns
    (S, S^T, tv, A_c on the coarse grid, B_c, rho)."""
    diag = A_p.diagonal()
    dinv = _dinv_of(diag)
    T, Bc, tv = _tentative_emb(B, grid_p, stride, center, dtype)
    if rho is None:
        rho = _power_rho(A_p, dinv)
    # S = I - (omega / rho) D^-1 A_dir: A_dir drops offsets that move
    # along uncoarsened (stride-1) dims; isotropic strides keep them all
    ss_dir = _tup(stride, len(grid_p))
    s_keep = [d for d, o in enumerate(A_p.offsets)
              if all(c == 0 or s > 1 for c, s in
                     zip(_offset_to_coords(o, grid_p), ss_dir))]
    s_offsets = tuple(A_p.offsets[d] for d in s_keep)
    scale = -(omega / torch.where(rho == 0, torch.ones_like(rho), rho))
    s_data = (torch.stack([A_p.data[d] for d in s_keep])
              * (scale * dinv)[None, :]) if s_keep else None
    bump = (diag != 0).to(dtype)
    if 0 in s_offsets:
        d0 = s_offsets.index(0)
        s_data[d0] = s_data[d0] + bump
        S = DIAMatrix(data=s_data, offsets=s_offsets, shape=A_p.shape,
                      nnz=A_p.nnz)
    else:
        s_data = (torch.cat([s_data, bump[None, :]]) if s_data is not None
                  else bump[None, :])
        S = DIAMatrix(data=s_data, offsets=s_offsets + (0,),
                      shape=A_p.shape, nnz=A_p.nnz)
    P_emb = dia_spgemm(S, T)
    R_emb = dia_transpose(P_emb)
    St = dia_transpose(S)
    AP = dia_spgemm(A_p, P_emb)
    # only centre-to-centre offsets (every per-dim delta a multiple of
    # the stride) survive compaction
    ss = _tup(stride, len(grid_p))
    cand = set()
    for oa in R_emb.offsets:
        for ob in AP.offsets:
            oc = oa + ob
            try:
                coords = _offset_to_coords(oc, grid_p)
            except ValueError:
                continue
            if all(c % s == 0 for c, s in zip(coords, ss)):
                cand.add(oc)
    Ac_emb = _dia_spgemm_filtered(R_emb, AP, cand)
    A_c = _compact_dia(Ac_emb, grid_p, stride, center)
    return S, St, tv, A_c, Bc, rho


# ---------------------------------------------------------------------------
# smoothers, solve padding, the pipeline
# ---------------------------------------------------------------------------

def _spec_key(spec):
    """Normalize a ('name', kwargs) smoother spec to a hashable key."""
    if spec is None:
        return None
    name, kwargs = spec if isinstance(spec, tuple) else (spec, {})
    if name is None:
        return None
    return (str(name), tuple(sorted((k, _hashable(v))
                                    for k, v in dict(kwargs or {}).items())))


def _hashable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, (list, np.ndarray)):
        return tuple(np.asarray(v).ravel().tolist())
    return v


def _check_smoother(key):
    """Admit Jacobi specs only; the other device smoothers raise."""
    if key is not None and key[0] != "jacobi":
        if key[0] in ("richardson", "chebyshev"):
            raise _not_ported(f"the device-built {key[0]!r} smoother", 8)
        raise ValueError(f"device setup supports jacobi, got {key[0]!r}")


def _smoother_device_arrays(key, A_p, dinv, rho_dinv, dtype):
    """The smoother's device tensors: (dinv, omega) for Jacobi (the only
    spec :func:`device_sa_setup` admits), with omega a 0-d tensor scaled by
    the device estimate of rho(D^-1 A)."""
    if key is None:
        return ()
    kw = dict(key[1])
    omega = torch.tensor(float(kw.get("omega", 1.0)), dtype=dtype,
                         device=dinv.device)
    if kw.get("withrho", True):
        omega = omega / torch.clamp_min(rho_dinv, 1e-30)
    return (dinv, omega)


def _smoother_wrap(key, arrays):
    """Bind the device tensors into a DeviceSmoother."""
    if key is None:
        return device_relaxation.identity()
    iterations = int(dict(key[1]).get("iterations", 1))
    return device_relaxation.jacobi_dyn(arrays[0], arrays[1], iterations)


def _solve_pad(n):
    """Solve-phase row padding of the reference (its fused TPU kernels'
    block gate): 32768 at >= 2M rows, 8192 at >= 262k, 4096 at >= 65536,
    none below.  Kept so that the port's n_pad equals the reference's;
    the padded rows are structurally zero."""
    if n >= 2**21:
        return pad_to(n, 32768)
    if n >= 2**18:
        return pad_to(n, 8192)
    if n >= 65536:
        return pad_to(n, 4096)
    return n


def _pad_solve_items(n_old, items):
    """Zero-pad fine-grid DIA operators and 1-D vectors of length
    ``n_old`` to the solve padding; the grid stays in the leading
    ``n_old`` entries.  Every per-row array that reaches here must have
    zero as its pad identity; smoother arrays go through
    :func:`_pad_smoother_arrays` instead."""
    padw = _solve_pad(n_old) - n_old
    if padw == 0:
        return tuple(items)

    def p(x):
        if isinstance(x, DIAMatrix) and x.n_pad == n_old:
            return DIAMatrix(data=F.pad(x.data, (0, padw)), offsets=x.offsets,
                             shape=x.shape, nnz=x.nnz)
        if isinstance(x, (tuple, list)):
            return tuple(p(e) for e in x)
        if isinstance(x, torch.Tensor) and x.ndim == 1 and x.shape[0] == n_old:
            return F.pad(x, (0, padw))
        return x

    return tuple(p(i) for i in items)


def _smoother_pad_mask(key):
    """Per-entry roles of the smoother arrays: True = per-row vector
    (zero-padded), False = left as is (the 0-d omega)."""
    if key is None:
        return ()
    return (True, False)           # (dinv per-row, omega scalar)


def _pad_smoother_arrays(key, arrays, n_old):
    mask = _smoother_pad_mask(key)
    if len(mask) != len(arrays):
        raise ValueError(f"smoother {key!r}: expected {len(mask)} arrays, "
                         f"got {len(arrays)}")
    padw = _solve_pad(n_old) - n_old
    if padw == 0:
        return tuple(arrays)
    return tuple(F.pad(a, (0, padw)) if m else a
                 for m, a in zip(mask, arrays))


def _pad_level_solve(A_p, S_op, St_op, pre_arr, post_arr, pre_key,
                     post_key):
    """A level's solve-phase operators and smoother arrays, padded."""
    A_sv, S_sv, St_sv = _pad_solve_items(A_p.n_pad, (A_p, S_op, St_op))
    return (A_sv, S_sv, St_sv,
            _pad_smoother_arrays(pre_key, pre_arr, A_p.n_pad),
            _pad_smoother_arrays(post_key, post_arr, A_p.n_pad))


def _setup_pipeline(A_in, B_in=None, *, plan, omega, dtype, pre_key,
                    post_key, improve_iters=0):
    """The multi-level setup as one eager loop over the static plan of
    (grid, grid_p, strides) per level.  Returns the per-level operators,
    rho estimates and smoother arrays, the dense coarsest operator and
    its Newton-Schulz pseudo-inverse; nothing is read to the host."""
    cur = A_in
    B = None
    out_levels = []
    for (grid, grid_p, strides) in plan:
        center = tuple(s // 2 for s in strides)
        A_p = _relayout_dia(cur, grid, grid_p)
        diag = A_p.diagonal()
        if B is None:
            if B_in is not None:
                Bv = _grid_pad_vec(B_in.to(dtype)[: int(np.prod(grid))],
                                   grid, grid_p)
                Bv = torch.where(diag != 0, Bv, 0)
            else:
                Bv = (diag != 0).to(dtype)
        else:
            Bv = _grid_pad_vec(B[: int(np.prod(grid))], grid, grid_p)
        dinv = _dinv_of(diag)
        rho = _power_rho(A_p, dinv)
        # improve_candidates: relax A z = 0 on the candidate before
        # fitting the tentative
        omega_imp = 1.0 / torch.clamp_min(rho, 1e-30)
        for _ in range(improve_iters):
            Bv = Bv - omega_imp * (dinv * (A_p @ Bv))
        if improve_iters:
            Bv = Bv / torch.clamp_min(torch.max(torch.abs(Bv)), 1e-30)
        S_op, St_op, tv, A_c, Bc, rho = _coarsen_level(
            A_p, Bv, grid_p, strides, center, omega, dtype, rho=rho)
        pre_arr = _smoother_device_arrays(pre_key, A_p, dinv, rho, dtype)
        post_arr = _smoother_device_arrays(post_key, A_p, dinv, rho, dtype)
        # the solve phase takes padded copies; the loop continues on the
        # exact-grid operators
        A_sv, S_sv, St_sv, pre_sv, post_sv = _pad_level_solve(
            A_p, S_op, St_op, pre_arr, post_arr, pre_key, post_key)
        out_levels.append((A_sv, S_sv, St_sv, tv, rho, pre_sv, post_sv))
        cur = A_c
        B = Bc
    Ac_dense = _dia_to_dense(cur)
    return tuple(out_levels), Ac_dense, _ns_pinv(Ac_dense)


def _ns_pinv(A, iters=60):
    """Newton-Schulz pseudo-inverse, X <- X (2I - A X) from
    X0 = A^T / (||A||_1 ||A||_inf), by ``torch.matmul`` in full precision
    (``backend`` turns TF32 off).  Zero padding rows/cols stay zero."""
    n = A.shape[0]
    norm1 = torch.max(torch.sum(torch.abs(A), dim=0))
    norminf = torch.max(torch.sum(torch.abs(A), dim=1))
    alpha = 1.0 / torch.clamp_min(norm1 * norminf, 1e-30)
    X = alpha * A.T
    eye2 = 2.0 * torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        X = torch.matmul(X, eye2 - torch.matmul(A, X))
    return X


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

class StructuredDeviceSolver(DeviceMultilevelSolver):
    """DeviceMultilevelSolver whose level-0 vector space is a padded grid:
    ``solve`` encodes b and decodes x by reshape-pad, for one right-hand
    side or an (n, K) column stack (the batched solve, whose lanes this
    hierarchy's kernels take).  A tensor is re-laid on its own device,
    never taken through the host."""

    lane_solves = True

    def __init__(self, hierarchy, grid, grid_p, setup_info=None):
        super().__init__(hierarchy)
        self.grid = tuple(grid)
        self.grid_p = tuple(grid_p)
        self.setup_info = setup_info or {}

    def _encode(self, v):
        """Grid-pad a vector, or each column of an (n, K) stack (the
        reference's ``engine/device_setup.py::_encode``)."""
        if np.ndim(v) not in (1, 2):
            raise ValueError(f"expected a vector or an (n, K) column "
                             f"stack, got {np.ndim(v)} dimensions")
        tail = tuple(v.shape[1:]) if np.ndim(v) == 2 else ()
        if isinstance(v, torch.Tensor):
            pads = [0, 0] * len(tail) + _grid_pads(self.grid, self.grid_p)
            return F.pad(v.reshape(self.grid + tail), pads).reshape(
                (-1,) + tail)
        pads = [(0, gp - g) for g, gp in zip(self.grid, self.grid_p)]
        pads += [(0, 0)] * len(tail)
        return np.pad(np.asarray(v).reshape(self.grid + tail),
                      pads).reshape((-1,) + tail)

    def _decode(self, v):
        tail = tuple(v.shape[1:])
        sl = tuple(slice(0, g) for g in self.grid)
        return v.reshape(self.grid_p + tail)[sl].reshape((-1,) + tail)

    def solve(self, b, x0=None, **kw):
        b = self._encode(b)
        if x0 is not None:
            x0 = self._encode(x0)
        x = super().solve(b, x0=x0, **kw)
        if isinstance(x, tuple):
            return (self._decode(x[0]),) + x[1:]
        return self._decode(x)


def device_sa_setup(A, grid=None, B=None, dtype=torch.float32, device=None,
                    omega=4.0 / 3.0, stride=3, max_coarse=400, max_levels=12,
                    presmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    postsmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    improve_candidates_iters=0, mixed_precision=False,
                    lane_align=False):
    """Build a smoothed-aggregation hierarchy on ``device`` for a
    grid-stencil operator and return its :class:`StructuredDeviceSolver`.

    ``A`` is scipy sparse (or dense numpy) or a :class:`DIAMatrix` (then
    ``grid`` is required); ``grid`` is the row-major grid of the unknowns
    (inferred by :func:`detect_grid` when None).  ``stride`` is an int, a
    per-dim tuple (semicoarsening) or ``'auto'`` (coarsen only dims whose
    coupling is within 9x of the strongest, rescaled by 1/stride^2 per
    level).  ``B`` is an optional length-n near-nullspace candidate
    (default ones); ``improve_candidates_iters`` relaxes A z = 0 on it
    before each level's tentative fit.  ``mixed_precision=True`` also
    stores the finest operator in float64 on the padded grid for the
    mixed-precision outer loop.  ``lane_align=True`` lays each level on
    the lane-aligned padded grid (:func:`_padded_grid`), so that batched
    native float32 CG solves take the interleaved route.  Smoothers:
    ``jacobi`` specs."""
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.float64):
        raise _not_ported(f"dtype {dtype}", 4)
    if grid is None:
        if not (sp.issparse(A) or isinstance(A, np.ndarray)):
            raise ValueError("grid= is required for DIAMatrix inputs")
        try:
            grid = detect_grid(A)
        except ValueError as exc:
            raise _not_ported(
                f"the device setup of an operator that is not a grid "
                f"stencil ({exc}); the unstructured device setup", 13) \
                from exc
    grid = tuple(int(g) for g in grid)
    dim = len(grid)
    n = int(np.prod(grid))
    if sp.issparse(A) or isinstance(A, np.ndarray):
        if A.shape[0] != n:
            raise ValueError(f"grid {grid} does not match A {A.shape}")
        A_dia = dia_from_scipy(sp.csr_matrix(A), dtype=dtype, device=device,
                               row_pad=1)
    elif isinstance(A, DIAMatrix):
        A_dia = DIAMatrix(data=A.data.to(dtype=dtype, device=device),
                          offsets=A.offsets, shape=A.shape, nnz=A.nnz)
    else:
        raise TypeError("A must be scipy sparse or DIAMatrix")
    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)
    _check_smoother(pre_key)
    _check_smoother(post_key)

    # per-dim coupling strengths for stride='auto': mean |A[i, i +- e_d]|
    couple = None
    if stride == "auto":
        couple = []
        offs = dict(zip(A_dia.offsets, range(len(A_dia.offsets))))
        for d in range(dim):
            delta = int(np.prod(grid[d + 1:]))
            s_d = 0.0
            for o in (delta, -delta):
                if o in offs:
                    s_d = max(s_d, float(torch.mean(torch.abs(
                        A_dia.data[offs[o]]))))
            couple.append(s_d)
        if max(couple) == 0:
            couple = None

    def _level_strides(cpl):
        if cpl is None:
            return _tup(3 if stride == "auto" else stride, dim)
        smax = max(cpl)
        return tuple(3 if c * 9.0 >= smax else 1 for c in cpl)

    # the static coarsening plan: offset decomposition is unambiguous only
    # while every coarsened padded dim is >= 3 * stride
    plan = []
    cur_grid = grid
    cur_couple = couple
    while int(np.prod(cur_grid)) > max_coarse and len(plan) < max_levels - 1:
        strides = _level_strides(cur_couple)
        grid_p = _padded_grid(cur_grid, strides, lane_align=lane_align)
        if not all(gp >= 3 * s for gp, s in zip(grid_p, strides) if s > 1):
            break
        plan.append((cur_grid, grid_p, strides))
        cur_grid = tuple(g // s for g, s in zip(grid_p, strides))
        if cur_couple is not None:
            cur_couple = [c / (s * s) for c, s in zip(cur_couple, strides)]
    nlev = len(plan)
    if nlev == 0:
        raise ValueError(
            f"grid {grid} is below the coarsening threshold "
            f"(max_coarse={max_coarse}); use the host setup path")

    B_dev = None
    if B is not None:
        B_dev = (B.to(device=device) if isinstance(B, torch.Tensor)
                 else torch.as_tensor(np.asarray(B).ravel(), dtype=dtype,
                                      device=device))
        if B_dev.ndim != 1 or B_dev.shape[0] < n:
            raise ValueError("B must be a length-n near-nullspace "
                             "candidate (multi-candidate is ROADMAP.md "
                             "Queue 1 item 9)")
    out_levels, Ac_dense, coarse_inv = _setup_pipeline(
        A_dia, B_dev, plan=tuple(plan), omega=omega, dtype=dtype,
        pre_key=pre_key, post_key=post_key,
        improve_iters=int(improve_candidates_iters))

    dev_levels = []
    infos = []
    for i, ((lv_grid, grid_p, strides), (A_p, S_op, St_op, tv, rho,
                                         pre_arr, post_arr)) in enumerate(
            zip(plan, out_levels)):
        centers = tuple(s // 2 for s in strides)
        coarse_grid = tuple(g // s for g, s in zip(grid_p, strides))
        coarse_grid_p = plan[i + 1][1] if i + 1 < nlev else coarse_grid
        P = StructuredProlongator(
            S=S_op, tv=tv, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers)
        # R's tv rides the solve-padded St (zero pad: those rows are
        # structurally absent), so the scale-epilogue gate passes
        tv_r = (tv if St_op.n_pad == tv.shape[0]
                else F.pad(tv, (0, St_op.n_pad - tv.shape[0])))
        R = StructuredRestrictor(
            St=St_op, tv=tv_r, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers)
        npad_lvl = int(np.prod(grid_p))
        dev_levels.append(DeviceLevel(
            A=A_p, P=P, R=R, pre=_smoother_wrap(pre_key, pre_arr),
            post=_smoother_wrap(post_key, post_arr), n=npad_lvl,
            n_pad=int(A_p.n_pad)))
        # rho stays a device scalar
        infos.append({"level": i, "n": npad_lvl, "strides": strides,
                      "ndiags": A_p.ndiags, "rho_D_inv_A": rho})

    nc = int(np.prod(cur_grid))
    ident = device_relaxation.identity()
    Ac_op = DenseOperator(data=Ac_dense, shape=(nc, nc), nnz=nc * nc)
    dev_levels.append(DeviceLevel(A=Ac_op, P=None, R=None, pre=ident,
                                  post=ident, n=nc, n_pad=nc))

    A64 = None
    if mixed_precision:
        if isinstance(A, DIAMatrix):
            A64_dia = DIAMatrix(data=A.data.to(dtype=torch.float64,
                                               device=device),
                                offsets=A.offsets, shape=A.shape, nnz=A.nnz)
        else:
            A64_dia = dia_from_scipy(sp.csr_matrix(A), dtype=torch.float64,
                                     device=device, row_pad=1)
        M = _relayout_dia(A64_dia, grid, plan[0][1])
        # the f32 hierarchy's solve padding, so _fitv never cuts rows
        (A64,) = _pad_solve_items(M.n_pad, (M,))

    hier = DeviceHierarchy(levels=tuple(dev_levels), coarse_inv=coarse_inv,
                           nc=nc, nc_pad=nc, dtype=dtype, A64=A64)
    return StructuredDeviceSolver(
        hier, grid, plan[0][1],
        setup_info={"levels": infos, "nlevels": nlev + 1})
