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
host: the smoother weights stay 0-d device tensors (``jacobi_dyn``,
``richardson_dyn``) and the Chebyshev coefficients a 1-d one
(``poly_dyn``), each scaled by a power-iteration estimate on the device.

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

An operator that is not a grid stencil (``detect_grid`` finds no grid)
goes to the unstructured device setup
(:func:`~pyamg_tpu_torch.engine.unstructured_setup.device_unstructured_sa_setup`)
with the arguments the reference passes.  Smoothers: ``jacobi``,
``richardson`` and ``chebyshev`` specs, as the reference's.  Several
candidates, or a BSR operator, take the block setup
(:func:`~pyamg_tpu_torch.engine.block_setup.device_sa_setup_block`);
:func:`device_adaptive_sa_setup` grows the candidates it builds with.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..backend import resolve_device
from ..relaxation.chebyshev import chebyshev_polynomial_coefficients
from ..sparse.dia import (DenseOperator, DIAMatrix, dia_from_scipy,
                          dia_spgemm, dia_spmm_add, dia_spmm_scaled,
                          dia_spmv_add, dia_spmv_scaled, dia_transpose)
from ..sparse.formats import fit, pad_to
from ..sparse.window import TransposedWindowed, WindowedELL
from . import relaxation as device_relaxation
from .hierarchy import DeviceHierarchy, DeviceLevel
from .krylov import _norm
from .setup import _hash_weights
from .solver import DeviceMultilevelSolver

__all__ = ["detect_grid", "device_adaptive_sa_setup", "device_sa_setup",
           "StructuredProlongator", "StructuredRestrictor",
           "StructuredDeviceSolver", "dia_transpose"]


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
    """Fine padded-grid vector -> its values at the aggregate centres (a
    strided slice), lane by lane for a (K, n) stack."""
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    cc = _tup(center, dim)
    lead = tuple(v.shape[:-1])
    v = v.reshape(lead + tuple(g * s for g, s in zip(coarse_grid, ss)))
    return v[(Ellipsis,) + tuple(slice(c, None, s) for s, c in zip(
        ss, cc))].reshape(lead + (-1,))


def _embed_coarse(xc, coarse_grid, stride, center):
    """Coarse grid vector -> the fine padded grid with its values at the
    centres and zeros elsewhere (the reference's interior-padding
    ``lax.pad``): zeros and one strided assignment, an exact copy, lane by
    lane for a (K, nc) stack.  The inverse of :func:`_compact_fine`."""
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    cc = _tup(center, dim)
    lead = tuple(xc.shape[:-1])
    out = xc.new_zeros(lead + tuple(g * s for g, s in zip(coarse_grid, ss)))
    out[(Ellipsis,) + tuple(slice(c, None, s) for s, c in zip(ss, cc))] = (
        xc.reshape(lead + tuple(coarse_grid)))
    return out.reshape(lead + (-1,))


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


def _offset_sums(a_offs, b_offs, grid_p, keep):
    """The pairwise sums oa + ob that decompose on ``grid_p`` and whose
    per-dim coordinates pass ``keep``, each once, in the order first met
    (a sum that does not decompose is dropped)."""
    out = {}
    for oa in a_offs:
        for ob in b_offs:
            oc = oa + ob
            if oc in out:
                continue
            try:
                coords = _offset_to_coords(oc, grid_p)
            except ValueError:
                out[oc] = False
                continue
            out[oc] = bool(keep(coords))
    return [o for o, kept in out.items() if kept]


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


def _compact_dia(A_emb: DIAMatrix, grid_p, stride, center,
                 data_grid=None) -> DIAMatrix:
    """The coarse operator from its fine-grid embedding: rows at the
    centre positions, each offset's per-dim deltas divided by the
    stride.  ``data_grid`` is the grid A_emb's rows lie on when they are
    a slab of whole aggregate rows of ``grid_p`` (the offsets are
    ``grid_p``'s; shape and nnz stay the whole coarse operator's)."""
    dim = len(grid_p)
    ss = _tup(stride, dim)
    coarse_grid = tuple(g // s for g, s in zip(grid_p, ss))
    rows_grid = tuple(g // s for g, s in zip(data_grid or grid_p, ss))
    out_offsets = []
    rows = []
    for d, o in enumerate(A_emb.offsets):
        coords = _offset_to_coords(o, grid_p)
        assert all(c % s == 0 for c, s in zip(coords, ss)), (o, coords)
        cc = tuple(c // s for c, s in zip(coords, ss))
        out_offsets.append(_coords_to_offset(cc, coarse_grid))
        rows.append(_compact_fine(A_emb.data[d], rows_grid, stride,
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

def _transfer_block(rows):
    """Rows a block of a transfer's windowed factor over ``rows`` fine
    rows (a row-sharded level's rows on one rank, or the whole level):
    the largest divisor of ``rows`` up to 8192 (the largest block the JAX
    package's layout takes), a multiple of 4 (K6's 16-byte rows) where
    one of at least 256 divides, so that the rows are whole blocks."""
    divisors = [d for d in range(1, min(rows, 8192) + 1) if rows % d == 0]
    by4 = [d for d in divisors if d % 4 == 0 and d >= 256]
    return (by4 or divisors)[-1]


def _windowed_rows(cols, vals, shape, block, dtype, global_max=None):
    """The operator whose row i holds ``vals[i, s]`` at column ``cols[i,
    s]`` (an (n, k) pair of tensors on one device, a column < 0 no entry;
    rows past n empty up to ``shape[0]``) as a WindowedELL in row blocks
    of ``block``, built on that device with a few host reads:
    :func:`~pyamg_tpu_torch.sparse.window.windowed_from_scipy`'s layout
    (slots in the given order, which is each row's column order here; the
    smallest power-of-two w2 >= 1024 whose two-chunk window spans every
    block's columns, however wide the grid).  The grid remaps of the
    transfers, in the form a row-sharded hierarchy applies (K6, K7).

    For a row block of a row-sharded operator (``shape[0]`` its local
    rows, whole blocks), ``global_max`` maps a local int64 tensor to its
    maximum over the ranks, so that w2 and the chunk count are the whole
    operator's; nnz is then the local entries'."""
    n, k = cols.shape
    n_pad = pad_to(max(shape[0], 1), block)
    nb = n_pad // block
    has = torch.zeros((n_pad, k), dtype=torch.bool, device=cols.device)
    has[:n] = cols >= 0
    c = torch.zeros((n_pad, k), dtype=torch.int64, device=cols.device)
    c[:n] = cols
    v = torch.zeros((n_pad, k), dtype=dtype, device=cols.device)
    v[:n] = vals.to(dtype)
    lo = torch.where(has, c, torch.iinfo(torch.int64).max).reshape(
        nb, block, k).amin((1, 2))
    hi = torch.where(has, c, -1).reshape(nb, block, k).amax((1, 2))
    lo = torch.where(hi < 0, 0, lo)                  # an empty block
    hi = torch.clamp_min(hi, 0)
    w2 = 1024
    while not bool((hi < (lo // w2 + 2) * w2).all()):
        w2 *= 2
    if global_max is not None:
        w2 = int(global_max(torch.tensor(w2, device=cols.device)))
    starts = lo // w2
    top = starts.max() if global_max is None else global_max(starts.max())
    m_chunks = max(pad_to(max(shape[1], 1), w2) // w2,
                   int(top) + 2)                     # starts + 1 addressable
    local = torch.where(has, c - starts.repeat_interleave(block)[:, None]
                        * w2, 0)
    return WindowedELL(
        data=torch.where(has, v, 0).reshape(nb, block, k).transpose(
            1, 2).contiguous(),
        idx=local.to(torch.int32).reshape(nb, block, k).transpose(
            1, 2).contiguous(),
        starts=starts.to(torch.int32), shape=tuple(shape), block=int(block),
        w2=w2, m_chunks=int(m_chunks), nnz=int(has.sum()))


def _shared_factor(remaps, block, build):
    """``build(block)``, built once and kept in ``remaps`` (the dict a
    level's prolongator and restrictor share, so that the remap both
    shard into is built once a level)."""
    if block not in remaps:
        remaps[block] = build(block)
    return remaps[block]


def _coarse_index(coarse_grid, coarse_grid_p, device=None):
    """Each coarse grid point's index on the coarse padded grid, in grid
    order (an int64 tensor)."""
    return _grid_unpad_vec(torch.arange(int(np.prod(coarse_grid_p)),
                                        device=device),
                           coarse_grid, coarse_grid_p)


def _remap_factor(tv, n_rows, coarse_grid, coarse_grid_p, stride, center,
                  block):
    """T xc = tv * broadcast(unpad(xc)), coarse padded grid -> fine rows
    (the first prod(fine grid) of ``n_rows``), as a one-slot
    WindowedELL."""
    cols = _broadcast_coarse(_coarse_index(coarse_grid, coarse_grid_p,
                                           tv.device),
                             coarse_grid, stride, center)
    return _windowed_rows(
        cols[:, None], tv[: cols.shape[0], None],
        (n_rows, int(np.prod(coarse_grid_p))), block, tv.dtype)


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
    # the remap T by block, shared with the level's restrictor
    remaps: dict = field(default_factory=dict, compare=False, repr=False)

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

    def remap(self, block):
        """T = ``tv * broadcast(unpad(xc))`` as a one-slot WindowedELL of
        ``block`` rows a block (the solve padding's rows and columns
        structural zeros), built once for the level's P and R."""
        return _shared_factor(self.remaps, block, lambda b: _remap_factor(
            self.tv, self.S.n_pad, self.coarse_grid, self.coarse_grid_p,
            self.stride, self.center, b))

    def shard_factors(self, block):
        """(S, T), P as factors applied right to left: the form a
        row-sharded hierarchy applies."""
        return (self.S, self.remap(block))


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
    # the remap T by block, shared with the level's prolongator
    remaps: dict = field(default_factory=dict, compare=False, repr=False)

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

    def shard_factors(self, block):
        """(T^T, S^T), R as factors applied right to left: T^T the
        transpose of :meth:`StructuredProlongator.remap` (K7 sums each
        aggregate's members by its column plan)."""
        T = _shared_factor(self.remaps, block, lambda b: _remap_factor(
            self.tv, self.St.n_pad, self.coarse_grid, self.coarse_grid_p,
            self.stride, self.center, b))
        return (TransposedWindowed(T), self.St)


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


def _power_rho(A, dinv=None, iters=40, norm=_norm, start=0):
    """Spectral-radius estimate of D^-1 A by power iteration from the
    reference's hashed start vector.  ``A`` is any operator with
    ``diagonal()``, ``n_pad``, ``dtype``, ``device`` and ``@``: the SpMV
    is K1 for a DIAMatrix and K6 for a WindowedELL on the card.  Returns
    a 0-d device tensor (never read to the host).  On a row block of a
    row-sharded level, ``start`` is the block's first row (its slice of
    the start vector) and ``norm`` the global 2-norm of a block."""
    v = (_hash_weights(A.n_pad, 12345, device=A.device, start=start)
         .to(A.dtype) - 0.5)
    v = torch.where(A.diagonal() != 0, v, 0)
    v = v / norm(v)
    for _ in range(iters):
        w = A @ v
        if dinv is not None:
            w = dinv * w
        nrm = norm(w)
        v = w / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    w = A @ v
    if dinv is not None:
        w = dinv * w
    return norm(w)


class _WholeProducts:
    """The products of one coarsening step over the whole padded grid:
    rolls (the reference's).  The partitioned setup's slab products
    (``parallel/partitioned_setup.py``) take their place on a slab of
    whole aggregate rows."""

    @staticmethod
    def grid(grid_p):
        """The grid the operands' rows lie on."""
        return grid_p

    spgemm = staticmethod(dia_spgemm)
    transpose = staticmethod(dia_transpose)
    spgemm_filtered = staticmethod(_dia_spgemm_filtered)
    compact = staticmethod(_compact_dia)


def _coarsen_level(A_p: DIAMatrix, B, grid_p, stride, center, omega, dtype,
                   rho=None, products=_WholeProducts):
    """One SA coarsening step on the padded grid.  Returns
    (S, S^T, tv, A_c on the coarse grid, B_c, rho).  ``products`` forms
    the DIA products (the whole grid's rolls, or a slab's)."""
    diag = A_p.diagonal()
    dinv = _dinv_of(diag)
    T, Bc, tv = _tentative_emb(B, products.grid(grid_p), stride, center,
                               dtype)
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
    P_emb = products.spgemm(S, T)
    R_emb = products.transpose(P_emb)
    St = products.transpose(S)
    AP = products.spgemm(A_p, P_emb)
    # only centre-to-centre offsets (every per-dim delta a multiple of
    # the stride) survive compaction
    ss = _tup(stride, len(grid_p))
    cand = _offset_sums(R_emb.offsets, AP.offsets, grid_p, lambda coords: all(
        c % s == 0 for c, s in zip(coords, ss)))
    Ac_emb = products.spgemm_filtered(R_emb, AP, cand)
    A_c = products.compact(Ac_emb, grid_p, stride, center)
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


_DEVICE_SMOOTHERS = ("jacobi", "richardson", "chebyshev")


def _check_smoother(key):
    """Admit the specs the device-built setups take (the reference's)."""
    if key is not None and key[0] not in _DEVICE_SMOOTHERS:
        raise ValueError("device setup supports jacobi/richardson/chebyshev,"
                         f" got {key[0]!r}")


def _smoother_device_arrays(key, A_p, dinv, rho_dinv, dtype,
                            power_rho=_power_rho):
    """The smoother's device tensors, every scalar a device tensor (no host
    read): (dinv, omega) for Jacobi, omega scaled by the estimate of
    rho(D^-1 A); (omega,) for Richardson, scaled by a power-iteration
    estimate of rho(A) (``power_rho(A_p)``); (coefficients,) for
    Chebyshev, the unit interval's coefficients scaled by that
    estimate."""
    if key is None:
        return ()
    name, kw = key
    kw = dict(kw)
    dev = A_p.device
    if name == "jacobi":
        omega = torch.tensor(float(kw.get("omega", 1.0)), dtype=dtype,
                             device=dev)
        if kw.get("withrho", True):
            omega = omega / torch.clamp_min(rho_dinv, 1e-30)
        return (dinv, omega)
    if name == "richardson":
        rho_A = power_rho(A_p)
        omega = torch.tensor(float(kw.get("omega", 1.0)), dtype=dtype,
                             device=dev) / torch.clamp_min(rho_A, 1e-30)
        return (omega,)
    if name == "chebyshev":
        lower = float(kw.get("lower_bound", 1.0 / 30.0))
        upper = float(kw.get("upper_bound", 1.1))
        degree = int(kw.get("degree", 3))
        # coefficients on the unit interval [lower, upper]; scaling the
        # interval by rho scales the coefficient of t^(degree-1-j) by
        # rho^-(degree-j) (p_rho(t) = p_unit(t / rho) / rho)
        c_unit = np.asarray(chebyshev_polynomial_coefficients(lower, upper,
                                                              degree))
        rho_A = power_rho(A_p)
        exps = degree - np.arange(degree)
        return (torch.as_tensor(c_unit, dtype=dtype, device=dev)
                * torch.clamp_min(rho_A, 1e-30) ** torch.as_tensor(
                    -exps, dtype=dtype, device=dev),)
    raise ValueError(
        f"device setup supports jacobi/richardson/chebyshev, got {name!r}")


def _smoother_wrap(key, arrays):
    """Bind the device tensors into a DeviceSmoother."""
    if key is None:
        return device_relaxation.identity()
    name, kw = key
    iterations = int(dict(kw).get("iterations", 1))
    if name == "jacobi":
        return device_relaxation.jacobi_dyn(arrays[0], arrays[1], iterations)
    if name == "richardson":
        return device_relaxation.richardson_dyn(arrays[0], iterations)
    if name == "chebyshev":
        return device_relaxation.polynomial_dyn(arrays[0], iterations)
    raise ValueError(name)


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
    (zero-padded), False = left as is (a 0-d omega, the coefficient stack
    of length degree).  Keyed by name, so a smoother with no entry here
    raises rather than be padded by the length of its arrays."""
    if key is None:
        return ()
    name = key[0]
    if name == "jacobi":
        return (True, False)       # (dinv per row, omega)
    if name == "richardson":
        return (False,)            # (omega,)
    if name == "chebyshev":
        return (False,)            # (coefficients,)
    raise ValueError(f"no pad-role entry for smoother {name!r}")


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


def _improve_candidate(A, Bv, dinv, rho, iters, amax=None):
    """improve_candidates: ``iters`` weighted-Jacobi sweeps on A z = 0
    from the candidate (omega = 1 / rho(D^-1 A)), then scaled to max |z|
    = 1 (``amax``: the max of |z| over a row-sharded level's blocks)."""
    omega_imp = 1.0 / torch.clamp_min(rho, 1e-30)
    for _ in range(iters):
        Bv = Bv - omega_imp * (dinv * (A @ Bv))
    if iters:
        top = torch.max(torch.abs(Bv))
        Bv = Bv / torch.clamp_min(top if amax is None else amax(top), 1e-30)
    return Bv


def _setup_pipeline(A_in, B_in=None, *, plan, omega, dtype, pre_key,
                    post_key, improve_iters=0, B_coarse=None):
    """The multi-level setup as one eager loop over the static plan of
    (grid, grid_p, strides) per level.  Returns the per-level operators,
    rho estimates and smoother arrays, the dense coarsest operator and
    its Newton-Schulz pseudo-inverse; nothing is read to the host.
    ``B_coarse`` (with ``A_in`` a coarse operator, the partitioned
    setup's gathered level) is the candidate a coarser level takes from
    the one above it."""
    cur = A_in
    B = B_coarse
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
        Bv = _improve_candidate(A_p, Bv, dinv, rho, improve_iters)
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


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise _not_ported(f"dtype {dtype}", 4)


def _grid_operator(A, grid, dtype, device):
    """(grid as a tuple, A as a DIAMatrix in ``dtype`` on ``device``) for
    the device-built setups: ``A`` scipy sparse or dense numpy (then its
    rows must match the grid) or a DIAMatrix."""
    grid = tuple(int(g) for g in grid)
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
    return grid, A_dia


def _relayout_a64(A, grid, grid_p, device):
    """The finest operator in float64 on the padded grid, at the float32
    hierarchy's solve padding (so the mixed loop's fits never cut rows):
    the A64 of the mixed-precision outer loop (the reference's
    ``_relayout_jit``), shared by the SA, classical and AIR setups."""
    if isinstance(A, DIAMatrix):
        A64 = DIAMatrix(data=A.data.to(dtype=torch.float64, device=device),
                        offsets=A.offsets, shape=A.shape, nnz=A.nnz)
    else:
        A64 = dia_from_scipy(sp.csr_matrix(A), dtype=torch.float64,
                             device=device, row_pad=1)
    M = _relayout_dia(A64, grid, grid_p)
    (M,) = _pad_solve_items(M.n_pad, (M,))
    return M


def _stride_coupling(A_dia, grid):
    """Per-dim coupling strengths for ``stride='auto'``: the larger of
    mean |A[i, i + e_d]| and mean |A[i, i - e_d]| over the stored rows,
    read to the host once per dim (None when every one is zero)."""
    offs = dict(zip(A_dia.offsets, range(len(A_dia.offsets))))
    couple = []
    for d in range(len(grid)):
        delta = int(np.prod(grid[d + 1:]))
        s_d = 0.0
        for o in (delta, -delta):
            if o in offs:
                s_d = max(s_d, float(torch.mean(torch.abs(
                    A_dia.data[offs[o]]))))
        couple.append(s_d)
    return couple if max(couple) > 0 else None


def _coarsening_plan(A_dia, grid, stride, base, max_coarse, max_levels,
                     lane_align=False, coupling=_stride_coupling):
    """The static coarsening plan [(grid, grid_p, strides)] per level and
    the coarsest grid.  ``stride`` is an int, a per-dim tuple or
    ``'auto'``: then a dim coarsens by ``base`` where its coupling is
    within base^2 of the strongest, each coupling rescaled by 1/s^2 per
    level (the 1/h^2 law; SA takes base 3, classical base 2; the
    couplings are ``coupling(A_dia, grid)``).  Offset decomposition is
    unambiguous only while every coarsened padded dim is >= 3 * stride,
    so the plan stops there too."""
    dim = len(grid)
    couple = coupling(A_dia, grid) if stride == "auto" else None

    def level_strides(cpl):
        if cpl is None:
            return _tup(base if stride == "auto" else stride, dim)
        smax = max(cpl)
        return tuple(base if c * float(base * base) >= smax else 1
                     for c in cpl)

    plan = []
    cur_grid = grid
    while int(np.prod(cur_grid)) > max_coarse and len(plan) < max_levels - 1:
        strides = level_strides(couple)
        grid_p = _padded_grid(cur_grid, strides, lane_align=lane_align)
        if not all(gp >= 3 * s for gp, s in zip(grid_p, strides) if s > 1):
            break
        plan.append((cur_grid, grid_p, strides))
        cur_grid = tuple(g // s for g, s in zip(grid_p, strides))
        if couple is not None:
            couple = [c / (s * s) for c, s in zip(couple, strides)]
    if not plan:
        raise ValueError(
            f"grid {grid} is below the coarsening threshold "
            f"(max_coarse={max_coarse}); use the host setup path")
    return plan, cur_grid


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
    bs = 1                       # unknowns per grid node

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
        """:meth:`DeviceMultilevelSolver.solve` on the grid's vectors.  On
        a row-sharded hierarchy (``shard_hierarchy``) every rank passes the
        full numpy ``b`` and gets the full decoded x; a tensor ``b`` raises
        there, since the solve would give this rank's block of the padded
        grid (to have that block, solve with ``DeviceMultilevelSolver(
        hierarchy)`` on ``_encode(b)``; ``_decode(hierarchy.gather(x))`` is
        then the full x)."""
        if (getattr(self.hierarchy, "mesh", None) is not None
                and isinstance(b, torch.Tensor)):
            raise TypeError("a grid solver over a row-sharded hierarchy "
                            "takes a numpy b (a tensor b would give this "
                            "rank's block of the padded grid)")
        b = self._encode(b)
        if x0 is not None:
            x0 = self._encode(x0)
        x = super().solve(b, x0=x0, **kw)
        if isinstance(x, tuple):
            return (self._decode(x[0]),) + x[1:]
        return self._decode(x)

    def aspreconditioner(self, cycle="V"):
        """The cycle as a scipy ``LinearOperator`` on the unpadded grid's
        vectors (the reference's ``StructuredDeviceSolver.
        aspreconditioner``)."""
        from scipy.sparse.linalg import LinearOperator

        inner = super().aspreconditioner(cycle)
        n = int(np.prod(self.grid)) * self.bs

        def matvec(r):
            return self._decode(inner @ self._encode(np.asarray(r).ravel()))

        return LinearOperator((n, n), matvec=matvec, dtype=np.float64)


def _dense_level(Ac_dense, nc):
    """The dense coarsest level of a device-built hierarchy."""
    ident = device_relaxation.identity()
    return DeviceLevel(
        A=DenseOperator(data=Ac_dense, shape=(nc, nc), nnz=nc * nc), P=None,
        R=None, pre=ident, post=ident, n=nc, n_pad=nc)


def _structured_solver(A, grid, plan, cur_grid, dev_levels, infos,
                       Ac_dense, coarse_inv, dtype, device, mixed_precision,
                       family=None):
    """The StructuredDeviceSolver over a device-built setup's levels, with
    the dense coarsest level appended (and the float64 A64 for the mixed
    loop); ``family`` ("classical", "air") goes into its setup_info."""
    nc = int(np.prod(cur_grid))
    dev_levels.append(_dense_level(Ac_dense, nc))
    A64 = (_relayout_a64(A, grid, plan[0][1], device) if mixed_precision
           else None)
    hier = DeviceHierarchy(levels=tuple(dev_levels), coarse_inv=coarse_inv,
                           nc=nc, nc_pad=nc, dtype=dtype, A64=A64)
    info = {"levels": infos, "nlevels": len(plan) + 1}
    if family is not None:
        info["family"] = family
    return StructuredDeviceSolver(hier, grid, plan[0][1], setup_info=info)


def device_sa_setup(A, grid=None, B=None, dtype=torch.float32, device=None,
                    omega=4.0 / 3.0, stride=3, max_coarse=400, max_levels=12,
                    presmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    postsmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    improve_candidates_iters=0, mixed_precision=False,
                    lane_align=False, mesh=None):
    """Build a smoothed-aggregation hierarchy on ``device`` for a
    grid-stencil operator and return its :class:`StructuredDeviceSolver`
    (an operator that is not one, with ``grid=None``, goes to the
    unstructured device setup instead).

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
    ``jacobi``, ``richardson`` or ``chebyshev`` specs (their spectral
    radii estimated on the device by power iteration).

    With a ``mesh`` (:func:`~pyamg_tpu_torch.parallel.make_solver_mesh`,
    every rank calling with the same arguments) the setup is partitioned
    (:func:`~pyamg_tpu_torch.parallel.partitioned_setup.
    partitioned_sa_setup`): ``A`` stays on the host, each rank builds its
    rows of every large level on its device (the mesh's), and the solver
    runs over a :class:`~pyamg_tpu_torch.parallel.ShardedHierarchy` equal
    to ``shard_hierarchy`` of the whole setup's."""
    device = resolve_device(device if mesh is None or device is not None
                            else mesh.device)
    if mesh is not None and device != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    _check_dtype(dtype)
    if grid is None:
        if not (sp.issparse(A) or isinstance(A, np.ndarray)):
            raise ValueError("grid= is required for DIAMatrix inputs")
        try:
            grid = detect_grid(A)
        except ValueError:
            # not a grid stencil: the unstructured device setup, which
            # raises ValueError itself when A is not windowable either
            from .unstructured_setup import device_unstructured_sa_setup
            return device_unstructured_sa_setup(
                A, B=B, dtype=dtype, device=device, omega=omega,
                max_coarse=max_coarse, max_levels=max_levels,
                presmoother=presmoother, postsmoother=postsmoother,
                improve_candidates_iters=improve_candidates_iters)
    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)
    _check_smoother(pre_key)
    _check_smoother(post_key)
    if mesh is not None:
        from ..parallel.partitioned_setup import partitioned_sa_setup
        return partitioned_sa_setup(
            A, grid, mesh, B=B, dtype=dtype, omega=omega, stride=stride,
            max_coarse=max_coarse, max_levels=max_levels, pre_key=pre_key,
            post_key=post_key,
            improve_candidates_iters=improve_candidates_iters,
            mixed_precision=mixed_precision, lane_align=lane_align)
    grid, A_dia = _grid_operator(A, grid, dtype, device)
    n = int(np.prod(grid))

    plan, cur_grid = _coarsening_plan(A_dia, grid, stride, 3, max_coarse,
                                      max_levels, lane_align=lane_align)

    B_dev = None
    if B is not None:
        B_dev = (B.to(device=device) if isinstance(B, torch.Tensor)
                 else torch.as_tensor(np.asarray(B).ravel(), dtype=dtype,
                                      device=device))
        if B_dev.ndim != 1 or B_dev.shape[0] < n:
            raise ValueError("B must be a length-n near-nullspace "
                             "candidate (multi-candidate: use "
                             "device_sa_setup_block)")
    out_levels, Ac_dense, coarse_inv = _setup_pipeline(
        A_dia, B_dev, plan=tuple(plan), omega=omega, dtype=dtype,
        pre_key=pre_key, post_key=post_key,
        improve_iters=int(improve_candidates_iters))

    dev_levels, infos = _structured_levels(plan, out_levels, pre_key,
                                           post_key)
    return _structured_solver(A, grid, plan, cur_grid, dev_levels, infos,
                              Ac_dense, coarse_inv, dtype, device,
                              mixed_precision)


def _structured_levels(plan, out_levels, pre_key, post_key, first=0):
    """The DeviceLevels and setup_info entries of the structured SA
    pipeline's levels ``plan[first:]`` (``out_levels`` theirs)."""
    nlev = len(plan)
    dev_levels = []
    infos = []
    for i, (A_p, S_op, St_op, tv, rho, pre_arr, post_arr) in enumerate(
            out_levels, start=first):
        grid_p, strides = plan[i][1], plan[i][2]
        centers = tuple(s // 2 for s in strides)
        coarse_grid = tuple(g // s for g, s in zip(grid_p, strides))
        coarse_grid_p = plan[i + 1][1] if i + 1 < nlev else coarse_grid
        remaps = {}
        P = StructuredProlongator(
            S=S_op, tv=tv, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers,
            remaps=remaps)
        # R's tv rides the solve-padded St (zero pad: those rows are
        # structurally absent), so the scale-epilogue gate passes
        tv_r = (tv if St_op.n_pad == tv.shape[0]
                else F.pad(tv, (0, St_op.n_pad - tv.shape[0])))
        R = StructuredRestrictor(
            St=St_op, tv=tv_r, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers,
            remaps=remaps)
        npad_lvl = int(np.prod(grid_p))
        dev_levels.append(DeviceLevel(
            A=A_p, P=P, R=R, pre=_smoother_wrap(pre_key, pre_arr),
            post=_smoother_wrap(post_key, post_arr), n=npad_lvl,
            n_pad=int(A_p.n_pad)))
        # rho stays a device scalar
        infos.append({"level": i, "n": npad_lvl, "strides": strides,
                      "ndiags": A_p.ndiags, "rho_D_inv_A": rho})
    return dev_levels, infos


def device_adaptive_sa_setup(A, grid=None, stages=2, candidate_iters=8,
                             cycle_iters=6, seed=0, dtype=torch.float32,
                             device=None, **kwargs):
    """Adaptive SA built on ``device`` (the reference's staged alpha-SA):

    - stage 0: relax the candidate (ones, or ``B``) on A z = 0 by
      ``candidate_iters`` weighted-Jacobi sweeps (omega = 1 / rho(D^-1 A),
      the power-iteration estimate) and build the single-candidate
      hierarchy from it (:func:`device_sa_setup`, which relaxes it per
      level as well, ``improve_candidates_iters`` sweeps,
      ``candidate_iters`` unless given);
    - each further stage: ``cycle_iters`` cycles of the current hierarchy
      on A z = 0 from a hashed start leave the error it cannot remove;
      that z, orthogonalised against the candidates so far and scaled to
      max |z| = 1, joins them, and the hierarchy is rebuilt from the
      grown block (:func:`~pyamg_tpu_torch.engine.block_setup.
      device_sa_setup_block`).  A z that vanishes (max |z| < 1e-10)
      would make the tentative fit rank-deficient: the stages stop there
      and the previous hierarchy stands.

    ``stages`` is 1..4 (the block setup's candidate cap); ``kwargs`` go to
    the setups.  The candidates stay on the device; one float a stage is
    read to the host (the guard's max |z|)."""
    from .block_setup import device_sa_setup_block

    if not 1 <= int(stages) <= 4:
        raise ValueError("stages must be in 1..4 (block candidate cap)")
    device = resolve_device(device)
    improve = int(kwargs.pop("improve_candidates_iters", candidate_iters))
    B0 = kwargs.pop("B", None)
    A_csr = sp.csr_matrix(A)
    if grid is None:
        grid = detect_grid(A_csr)
    n = A_csr.shape[0]
    A_dia = dia_from_scipy(A_csr, dtype=dtype, device=device, row_pad=1)
    diag = A_dia.diagonal()
    dinv = _dinv_of(diag)
    rho = _power_rho(A_dia, dinv)

    z = (torch.ones(n, dtype=dtype, device=device) if B0 is None
         else torch.as_tensor(np.asarray(B0).ravel()[:n], dtype=dtype,
                              device=device))
    z = torch.where(diag != 0, z, 0)
    om = 1.0 / torch.clamp_min(rho, 1e-30)
    for _ in range(int(candidate_iters)):
        z = z - om * (dinv * (A_dia @ z))
    cands = [z / torch.clamp_min(torch.max(torch.abs(z)), 1e-30)]
    dsa = device_sa_setup(A_csr, grid=grid, B=cands[0], dtype=dtype,
                          device=device, improve_candidates_iters=improve,
                          **kwargs)
    block_kw = {k: v for k, v in kwargs.items()
                if k in ("stride", "max_coarse", "max_levels", "omega",
                         "presmoother", "postsmoother", "mixed_precision")}
    for s in range(1, int(stages)):
        z0 = (_hash_weights(n, 9876 + int(seed) + s, device=device).to(dtype)
              - 0.5)
        z = dsa.solve(torch.zeros(n, dtype=dtype, device=device), x0=z0,
                      tol=0.0, maxiter=int(cycle_iters), accel=None)
        for c in cands:
            denom = torch.clamp_min(torch.sum(c * c), 1e-30)
            z = z - (torch.sum(c * z) / denom) * c
        zmax = float(torch.max(torch.abs(z)))
        if zmax < 1e-10:
            break
        cands.append(z / zmax)
        dsa = device_sa_setup_block(A_csr, grid=grid,
                                    B=torch.stack(cands, dim=1), dtype=dtype,
                                    device=device, **block_kw)
    return dsa
