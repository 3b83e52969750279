"""The partitioned device SA setup (counterpart of the JAX package's
``engine/device_setup.py::_setup_pipeline`` on a row-sharded operator,
which GSPMD partitions: ``tests/test_parallel.py::
test_distributed_device_setup_gspmd``).

``device_sa_setup(A, grid, mesh=mesh)`` comes here.  Every rank calls it
with the same arguments; ``A`` stays on the host, where the caller holds
it, and each rank moves only its rows to its device.  The result is this
rank's block of the hierarchy that ``shard_hierarchy`` makes of the whole
setup's, built without any rank holding a whole large level.

A level lies on the group count its solve layout gets (``_level_groups``
of its solve-padded n_pad, as ``shard_hierarchy``'s; the ranks of a group
compute the same rows), in two layouts of its rows:

- **setup slabs**: contiguous rows of the padded grid cut only at whole
  aggregate rows of dim 0 (uneven where the groups do not divide them),
  so the tentative's block norms, the block sums and the compaction are
  local and exact, and a slab's coarse rows are one contiguous range of
  the coarse grid;
- **the solve layout**: ``shard_hierarchy``'s even split of the
  solve-padded n_pad (the padding rows the last block's).

:func:`_move` (one ``all_to_all_single`` with split sizes) takes a
level's pieces from one layout to the other, and its coarse rows onto the
next level's slabs.  On a level:

1. A goes to the solve layout; rho(D^-1 A) by power iteration through K16
   (``halo_spmv``, one ring apply a step) from this rank's slice of the
   hashed start vector, each norm a local sum of squares and one
   all_reduce; improve_candidates' sweeps the same way;
2. ``device_setup._coarsen_level`` with :class:`_SlabProducts`: each roll
   of the whole grid's products is a slice of the slab extended by its
   ring neighbours' rows, which one exchange a product operand brings
   (``start_halo_exchange``; it wraps, as the rolls wrap onto stored
   zeros);
3. the smoother arrays (Jacobi's dinv, Richardson's and Chebyshev's
   rho(A) through K16);
4. the sharded operators from this rank's pieces: A, S and S^T for K16,
   and the remap T built from the local tv rows with global coarse
   columns (K6, and K7 for T^T).

A level that is not large (``_level_groups`` puts it on one group in the
world, or in a world of one would in a world of two), or whose slabs are
narrower than its products' reach, is gathered once: it and every level
below it run the whole setup's code on every rank and are sharded by
``shard_hierarchy``'s rule, as are the dense coarsest level and its
pseudo-inverse (replicated).

In a world of one a large level is a ring of one: its halos are the
slab's own tail and head (the rolls' values) and K16 gives K1's bits, so
the setup gives the whole setup's bits.  Across P ranks the norms and
coupling sums add by rank, so levels agree to rounding.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..engine.device_setup import (StructuredDeviceSolver, _check_dtype,
                                   _coarsen_level, _coarsening_plan,
                                   _compact_dia, _coords_to_offset,
                                   _dense_level, _dinv_of, _grid_operator,
                                   _grid_pad_vec, _improve_candidate,
                                   _offset_to_coords, _power_rho,
                                   _setup_pipeline, _smoother_device_arrays,
                                   _smoother_wrap, _solve_pad,
                                   _structured_levels, _transfer_block,
                                   _windowed_rows)
from ..sparse.dia import DIAMatrix
from ..sparse.formats import fit
from .dist_spmv import halo_width, start_halo_exchange
from .partition import (ShardedHierarchy, ShardedOperator, _level_groups,
                        _shard_level, _ShardedDIA, _ShardedTransposed,
                        _ShardedWindowed)

__all__ = ["partitioned_sa_setup"]

# shard_hierarchy's default: a level splits while each group keeps as many
# rows
_MIN_LOCAL_ROWS = 256


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    """A level's rows over ``groups`` shard groups: group g holds the rows
    ``ranges[g]`` (contiguous, ascending, the first from row 0)."""

    groups: int
    ranges: tuple

    def mine(self, mesh):
        return self.ranges[mesh.shard(self.groups)]


def _even(groups, n):
    """``n`` rows split evenly over ``groups`` (the solve layout)."""
    m = n // groups
    return _Layout(groups, tuple((g * m, (g + 1) * m) for g in range(groups)))


def _parts(items, groups):
    """The starts of ``groups`` contiguous parts of ``items`` (the first
    ``items % groups`` one larger), and the end."""
    q, r = divmod(items, groups)
    starts = [0]
    for g in range(groups):
        starts.append(starts[-1] + q + (g < r))
    return tuple(starts)


@dataclasses.dataclass(frozen=True)
class _Level:
    """One planned level: its grids, strides and group count, and the
    aggregate rows of dim 0 each group's slab holds (``agg[g]`` to
    ``agg[g + 1]``).  Its rows are the padded grid's points (a block
    level's: its nodes).  ``centered``: the aggregates' roots are their
    centres (SA; the classical C points are at offset 0); ``padded``: the
    solve layout takes the solve padding (a block level takes none)."""

    grid: tuple
    grid_p: tuple
    strides: tuple
    groups: int
    centered: bool = True
    padded: bool = True

    @property
    def center(self):
        return tuple(s // 2 if self.centered else 0 for s in self.strides)

    @property
    def n(self):
        return int(np.prod(self.grid_p))

    @property
    def n_pad(self):
        return _solve_pad(self.n) if self.padded else self.n

    @property
    def row(self):
        """Rows of the padded grid a dim-0 index spans."""
        return int(np.prod(self.grid_p[1:]))

    @property
    def coarse_grid(self):
        return tuple(g // s for g, s in zip(self.grid_p, self.strides))

    @property
    def agg(self):
        return _parts(self.coarse_grid[0], self.groups)

    @property
    def slabs(self):
        span = self.strides[0] * self.row
        a = self.agg
        return _Layout(self.groups, tuple((a[g] * span, a[g + 1] * span)
                                          for g in range(self.groups)))

    @property
    def solve(self):
        return _even(self.groups, self.n_pad)

    def coarse_rows(self, row):
        """The layout of each slab's coarse rows, ``row`` entries a coarse
        dim-0 index."""
        a = self.agg
        return _Layout(self.groups, tuple((a[g] * row, a[g + 1] * row)
                                          for g in range(self.groups)))

    def slab_grid(self, mesh):
        """The grid of this rank's slab."""
        g = mesh.shard(self.groups)
        a = self.agg
        return ((a[g + 1] - a[g]) * self.strides[0],) + tuple(self.grid_p[1:])

    def reach(self, offsets):
        """An upper bound of the products' halo: A's reach plus its
        transfer's (P_emb, the widest operand a product reads: SA's S T,
        the tentative reaching an aggregate's root; the classical
        interpolation, A's span in each coarsened dim)."""
        if not self.centered:
            coords = [_offset_to_coords(o, self.grid_p) for o in offsets]
        t = 0
        step = 1
        for d in reversed(range(len(self.grid_p))):
            s, c = self.strides[d], self.center[d]
            if self.centered:
                t += max(c, s - 1 - c) * step
            elif s > 1:
                t += max(abs(c[d]) for c in coords) * step
            step *= self.grid_p[d]
        return max(abs(o) for o in offsets) + t


def _partitioned(lv, offsets, mesh, groups=None):
    """Whether level ``lv`` (its A's ``offsets`` on its padded grid) is
    built on slabs: large (a world of two or more puts it on several
    groups; a world of one takes what a world of two would split;
    ``groups(world)`` its group count, by default ``_level_groups`` of
    its n_pad), every slab at least the products' reach, and A's halo
    within a solve block (else ``shard_hierarchy`` would replicate A)."""
    world = mesh.world if mesh.world > 1 else 2
    if groups is None:
        def groups(w):
            return _level_groups(lv.n_pad, w, _MIN_LOCAL_ROWS)
    if groups(world) < 2:
        return False
    a = lv.agg
    span = lv.strides[0] * lv.row
    narrowest = min(a[g + 1] - a[g] for g in range(lv.groups)) * span
    return (narrowest >= lv.reach(offsets)
            and max(abs(o) for o in offsets) <= lv.n_pad // lv.groups)


def _move(mesh, t, src, dst, axis=-1):
    """This rank's rows of ``t`` (its ``axis``, by default the last, the
    rows ``src`` gives the rank) as the rows ``dst`` gives it, zeros where
    no source holds a row (padding past the sources' last row): one
    ``all_to_all_single`` with split sizes, a destination rank served by
    the replica of its own index within each source group.  In a world of
    one, a cut or a zero pad."""
    d0, d1 = dst.mine(mesh)
    if axis % t.ndim != t.ndim - 1:
        if mesh.world == 1 and t.shape[axis] == d1 - d0:
            return t
        return _move(mesh, t.movedim(axis, -1), src, dst).movedim(
            -1, axis).contiguous()
    if mesh.world == 1:
        return fit(t, d1 - d0)
    ss, ds = mesh.stride(src.groups), mesh.stride(dst.groups)

    def server(r, g):
        return g * ss + r % ss

    mine = mesh.shard(src.groups)
    s0, s1 = src.ranges[mine]
    lead = tuple(t.shape[:-1])
    rows = t.reshape(-1, t.shape[-1]).T
    sends, pieces = [], []
    for r in range(mesh.world):
        a, b = dst.ranges[r // ds]
        lo, hi = max(a, s0), min(b, s1)
        serve = hi > lo and server(r, mine) == mesh.rank
        sends.append(hi - lo if serve else 0)
        if serve:
            pieces.append(rows[lo - s0:hi - s0])
    recvs = []
    for r in range(mesh.world):
        a, b = src.ranges[r // ss]
        lo, hi = max(a, d0), min(b, d1)
        recvs.append(hi - lo if hi > lo and server(mesh.rank, r // ss) == r
                     else 0)
    inp = (torch.cat(pieces) if pieces
           else rows.new_empty((0, rows.shape[1]))).contiguous()
    out = rows.new_empty((sum(recvs), rows.shape[1]))
    dist.all_to_all_single(out, inp, recvs, sends)
    return fit(out.T.reshape(lead + (-1,)).contiguous(), d1 - d0)


def _all_max(t, mesh):
    """The maximum of a 0-d tensor over the ranks."""
    if mesh.world == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


# ---------------------------------------------------------------------------
# the host operator
# ---------------------------------------------------------------------------

class _HostOperator:
    """The caller's A where it holds it (scipy sparse, dense numpy, or a
    DIAMatrix): the grid, the offsets on the grid, nnz, and the DIA rows
    of a range of grid rows, read from A alone (each stored entry's row
    and diagonal found once, so a range costs its own entries)."""

    def __init__(self, A, grid):
        self.grid = tuple(int(g) for g in grid)
        n = int(np.prod(self.grid))
        if sp.issparse(A) or isinstance(A, np.ndarray):
            if A.shape[0] != n:
                raise ValueError(f"grid {self.grid} does not match A "
                                 f"{A.shape}")
            self.csr = sp.csr_matrix(A)
            self.index = np.int32 if n < 2**30 else np.int64
            offs = self.csr.indices.astype(self.index) - self._row_of(0, n)
            self.lo = int(offs.min()) if offs.size else 0
            present = np.bincount(offs - self.lo) > 0
            self.offsets = tuple(int(o) + self.lo
                                 for o in np.flatnonzero(present))
            # an offset's diagonal, from offset - lo
            self.lut = (np.cumsum(present) - 1).astype(np.int32)
            self.nnz = int(self.csr.nnz)
            self.dia = None
            self._last = (None, None)
        elif isinstance(A, DIAMatrix):
            self.csr, self.dia = None, A
            self.offsets, self.nnz = tuple(A.offsets), A.nnz
        else:
            raise TypeError("A must be scipy sparse or DIAMatrix")

    def _row_of(self, r0, r1):
        """The row of each stored entry of rows [r0, r1), less r0."""
        return np.repeat(np.arange(r1 - r0, dtype=self.index),
                         np.diff(self.csr.indptr[r0:r1 + 1]))

    def rows(self, r0, r1):
        """(nd, r1 - r0) host array: row i's entry at each offset (as
        ``dia_from_scipy`` stores it), from those rows' entries alone.
        The last range read is kept (the couplings' rows are level 0's
        slab in a world of one)."""
        if self.dia is not None:
            return self.dia.data[:, r0:r1].cpu().numpy()
        if self._last[0] == (r0, r1):
            return self._last[1]
        data = np.zeros((len(self.offsets), r1 - r0))
        e0, e1 = self.csr.indptr[r0], self.csr.indptr[r1]
        row = self._row_of(r0, r1)
        diag = self.lut[self.csr.indices[e0:e1] - row - (r0 + self.lo)]
        data[diag, row] = self.csr.data[e0:e1]
        self._last = ((r0, r1), data)
        return data

    def padded_rows(self, grid_p, g0, g1, dtype, device):
        """The dim-0 rows [g0, g1) of the padded grid as a DIA block on
        ``device``: (offsets on ``grid_p``, ascending, and their (nd, (g1
        - g0) * prod(grid_p[1:])) rows), the grid's padding zeros, as
        ``_relayout_dia`` lays the whole operator (the rows read on the
        host, padded and ordered on the device)."""
        grid = self.grid
        h0, h1 = min(g0, grid[0]), min(g1, grid[0])
        row = int(np.prod(grid[1:]))
        data = torch.as_tensor(self.rows(h0 * row, h1 * row), dtype=dtype,
                               device=device)
        offsets, order = _relaid_offsets(self.offsets, grid, grid_p)
        return offsets, _ordered(_grid_pad_vec(
            data, (h1 - h0,) + grid[1:], (g1 - g0,) + tuple(grid_p[1:])),
            order)


def _ordered(data, order):
    """The diagonals ``data`` in the order ``order`` (as they are when it
    is the identity)."""
    if np.array_equal(order, np.arange(len(order))):
        return data
    return data[torch.as_tensor(order, device=data.device)]


def _relaid_offsets(offsets, grid, grid_p):
    """Offsets on ``grid`` as offsets on ``grid_p``, ascending, and the
    order that sorts them (``_relayout_dia``'s)."""
    new = [_coords_to_offset(_offset_to_coords(o, grid), grid_p)
           for o in offsets]
    order = np.argsort(new)
    return tuple(int(new[i]) for i in order), order


def _coupling(src, mesh, dtype):
    """``_stride_coupling``'s per-dim couplings from every rank's share
    of A's grid rows (the sums of |A| one all_reduce; in a world of one
    ``torch.mean`` of the whole, as the whole setup takes them)."""
    grid = src.grid
    n = int(np.prod(grid))
    starts = _parts(grid[0], mesh.world)
    g0, g1 = starts[mesh.rank], starts[mesh.rank + 1]
    offs, data = src.padded_rows(grid, g0, g1, dtype, mesh.device)
    index = dict(zip(offs, range(len(offs))))
    wanted = []
    for d in range(len(grid)):
        delta = int(np.prod(grid[d + 1:]))
        wanted.append([o for o in (delta, -delta) if o in index])
    flat = [o for w in wanted for o in w]
    if mesh.world == 1:
        means = {o: float(torch.mean(torch.abs(data[index[o]])))
                 for o in flat}
    else:
        sums = torch.stack([torch.sum(torch.abs(data[index[o]]))
                            for o in flat]) if flat else data.new_zeros(0)
        dist.all_reduce(sums)
        means = {o: float(s) / n for o, s in zip(flat, sums.tolist())}
    couple = [max([0.0] + [means[o] for o in w]) for w in wanted]
    return couple if max(couple) > 0 else None


# ---------------------------------------------------------------------------
# slab products
# ---------------------------------------------------------------------------

def _shift_pieces(length, o, hw):
    """x_ext[hw + o : hw + o + length] for x_ext = [left, x, right] (``hw``
    entries of each halo, |o| <= hw <= length) as (destination slice,
    source, source slice) pieces."""
    if o >= 0:
        return ((slice(0, length - o), 1, slice(o, length)),
                (slice(length - o, length), 2, slice(0, o)))
    m = -o
    return ((slice(0, m), 0, slice(hw - m, hw)),
            (slice(m, length), 1, slice(0, length - m)))


class _SlabProducts:
    """The products of one coarsening step on this rank's slab of a level
    (``device_setup._coarsen_level``'s ``products``): the whole grid's
    ``torch.roll(B, -o)`` is the slab's rows of B extended by the ring
    neighbours' ``hw`` rows on either side, read at an offset of ``o``.
    One exchange brings an operand's halos for all of its diagonals (kept
    for its later products); each product term is formed from the slab
    and halo pieces straight into its output row, and summed in the
    rolls' order, so every entry has the whole grid's bits."""

    def __init__(self, mesh, groups, slab_grid):
        self.mesh, self.groups = mesh, groups
        self.slab_grid = tuple(slab_grid)
        self._halos = {}

    def grid(self, grid_p):
        return self.slab_grid

    def _halo(self, M, hw):
        """The left neighbour's last and the right one's first ``hw`` rows
        of every diagonal of M ((nd, hw) each)."""
        hw = max(hw, 1)
        got = self._halos.get(id(M.data))
        if got is None or got[0] < hw:
            left, right, reqs = start_halo_exchange(M.data, hw, self.mesh,
                                                    self.groups)
            for req in reqs:
                req.wait()
            got = (hw, left, right, M.data)
            self._halos[id(M.data)] = got
        h, left, right, _ = got
        return hw, left[:, h - hw:], right[:, :hw]

    def spgemm(self, A, B, keep=None):
        """C = A @ B on the slab (``dia_spgemm``; ``keep``: only those
        offsets, ``_dia_spgemm_filtered``)."""
        length = B.data.shape[1]
        hw, left, right = self._halo(B, max(abs(o) for o in A.offsets))
        terms = [(da, db, oa + ob) for da, oa in enumerate(A.offsets)
                 for db, ob in enumerate(B.offsets)
                 if keep is None or oa + ob in keep]
        offsets = tuple(sorted({oc for _, _, oc in terms}))
        index = {o: i for i, o in enumerate(offsets)}
        data = torch.empty((len(offsets), length),
                           dtype=torch.result_type(A.data, B.data),
                           device=B.data.device)
        started = set()
        term = None
        for da, db, oc in terms:
            a = A.data[da]
            srcs = (left[db], B.data[db], right[db])
            if oc in started:
                term = torch.empty_like(a) if term is None else term
                out = term
            else:
                out = data[index[oc]]
            for dst, s, sl in _shift_pieces(length, A.offsets[da], hw):
                torch.mul(a[dst], srcs[s][sl], out=out[dst])
            if oc in started:
                data[index[oc]] += term
            started.add(oc)
        return DIAMatrix(data=data, offsets=offsets,
                         shape=(A.shape[0], B.shape[1]),
                         nnz=len(offsets) * length)

    def spgemm_filtered(self, A, B, keep_offsets):
        return self.spgemm(A, B, keep=set(int(o) for o in keep_offsets))

    def transpose(self, A):
        """A^T on the slab (``dia_transpose``)."""
        length = A.data.shape[1]
        hw, left, right = self._halo(A, max(abs(o) for o in A.offsets))
        lookup = {o: d for d, o in enumerate(A.offsets)}
        offsets = tuple(sorted(-o for o in A.offsets))
        data = torch.empty_like(A.data)
        for i, p in enumerate(offsets):
            d = lookup[-p]
            srcs = (left[d], A.data[d], right[d])
            for dst, s, sl in _shift_pieces(length, p, hw):
                data[i, dst] = srcs[s][sl]
        return DIAMatrix(data=data, offsets=offsets,
                         shape=(A.shape[1], A.shape[0]), nnz=A.nnz)

    def compact(self, A_emb, grid_p, stride, center):
        return _compact_dia(A_emb, grid_p, stride, center,
                            data_grid=self.slab_grid)


# ---------------------------------------------------------------------------
# one partitioned level
# ---------------------------------------------------------------------------

class _BlockRows:
    """This rank's block of a level's A in the solve layout, as
    ``_power_rho`` and ``_improve_candidate`` take an operator: its
    diagonal, local length, dtype and device, and ``@`` through K16 (one
    ring apply)."""

    def __init__(self, factor, diag):
        self.factor, self.diag = factor, diag

    def diagonal(self):
        return self.diag

    @property
    def n_pad(self):
        return self.diag.shape[0]

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def __matmul__(self, x):
        return self.factor.apply(x)


def _coarse_columns(f, lv, coarse_grid_p):
    """For the level's points ``f`` (global indices on its padded grid):
    their aggregate's index on the coarse padded grid, and whether each is
    its aggregate's root (the C point of a classical level)."""
    col = torch.zeros_like(f)
    root = torch.ones(f.shape, dtype=torch.bool, device=f.device)
    step = 1
    for g, s, c, cg in reversed(list(zip(lv.grid_p, lv.strides, lv.center,
                                         coarse_grid_p))):
        x = f % g
        root &= x % s == c
        col += x // s * step
        f = f // g
        step *= cg
    return col, root


def _local_windowed_rows(cols, vals, shape, block, nnz, mesh):
    """This rank's row blocks of a grid remap (``_windowed_rows`` of its
    own rows, global columns) with the whole operator's w2 and chunk
    count (maxima over the ranks) and ``nnz``, its share of the whole
    operator's (the row blocks ``shard_hierarchy`` cuts)."""
    W = _windowed_rows(cols, vals, shape, block, vals.dtype,
                       global_max=lambda t: _all_max(t, mesh))
    return dataclasses.replace(W, nnz=nnz)


def _local_remap(tv, r0, lv, coarse_grid_p, block, mesh):
    """This rank's row blocks of the remap T (``_remap_factor``: fine row
    f's one entry tv[f] at its aggregate's index on the coarse padded
    grid) from its tv rows [r0, r0 + len(tv)) of the solve layout."""
    length = tv.shape[0]
    col, _ = _coarse_columns(torch.arange(r0, r0 + length, device=tv.device),
                             lv, coarse_grid_p)
    have = max(0, min(lv.n - r0, length))
    return _local_windowed_rows(
        col[:have, None], tv[:have, None],
        (length, int(np.prod(coarse_grid_p))), block, lv.n // lv.groups,
        mesh)


def _solve_rows(mesh, lv, A):
    """Level ``lv``'s A (this rank's slab) in the solve layout: its K16
    factor, the operator ``_power_rho`` takes, and the power iteration on
    it (from this rank's slice of the hashed start vector, each norm one
    all_reduce over the groups)."""
    k = lv.groups
    r0, r1 = lv.solve.mine(mesh)
    valid = max(0, min(lv.n - r0, r1 - r0))

    def norm(v):
        part = v[..., :valid]
        return torch.sqrt(mesh.sum_groups(torch.sum(part * part, dim=-1),
                                          k))

    A_f = _sharded_dia(mesh, lv, A)
    d0 = A.offsets.index(0) if 0 in A.offsets else None
    rows = _BlockRows(A_f, A_f.data[d0] if d0 is not None
                      else A_f.data.new_zeros(A_f.data.shape[1]))
    return A_f, rows, functools.partial(_power_rho, norm=norm, start=r0)


def _sharded_dia(mesh, lv, M):
    """This rank's K16 factor of a level's DIA operator from its slab
    rows."""
    return _ShardedDIA(_move(mesh, M.data, lv.slabs, lv.solve), M.offsets,
                       halo_width(M), mesh, lv.groups, lv.n_pad)


class _Setup:
    """What every partitioned level of one setup shares (``m``: the
    candidates an aggregate; ``layout``: ``_Level``'s ``centered`` and
    ``padded``)."""

    def __init__(self, mesh, plan, ks, n_pads, dtype, omega, pre_key,
                 post_key, improve_iters=0, m=1, **layout):
        self.mesh, self.plan, self.ks, self.n_pads = mesh, plan, ks, n_pads
        self.dtype, self.omega = dtype, omega
        self.pre_key, self.post_key = pre_key, post_key
        self.improve_iters, self.m = improve_iters, m
        self.layout = layout

    def level(self, i):
        grid, grid_p, strides = self.plan[i]
        return _Level(tuple(grid), tuple(grid_p), tuple(strides),
                      self.ks[i], **self.layout)

    def coarse_grid_p(self, i):
        lv = self.level(i)
        return (tuple(self.plan[i + 1][1]) if i + 1 < len(self.plan)
                else lv.coarse_grid)


def _partition_level(st, i, A, Bv):
    """Level ``i`` from this rank's slab of its A (a DIAMatrix of the
    slab's rows, the whole operator's offsets, shape and nnz) and of its
    candidate: returns (the sharded DeviceLevel, its setup_info entry,
    the coarse A's and candidate's slab rows on the coarse grid)."""
    from ..engine.hierarchy import DeviceLevel

    mesh, lv = st.mesh, st.level(i)
    k = lv.groups
    r0, _ = lv.solve.mine(mesh)
    A_f, rows, power = _solve_rows(mesh, lv, A)
    dinv = _dinv_of(rows.diagonal())
    rho = power(rows, dinv)
    if st.improve_iters:
        Bs = _improve_candidate(rows, _move(mesh, Bv, lv.slabs, lv.solve),
                                dinv, rho, st.improve_iters,
                                amax=lambda t: _all_max(t, mesh))
        Bv = _move(mesh, Bs, lv.solve, lv.slabs)
    S, St, tv, A_c, Bc, rho = _coarsen_level(
        A, Bv, lv.grid_p, lv.strides, lv.center, st.omega, st.dtype,
        rho=rho, products=_SlabProducts(mesh, k, lv.slab_grid(mesh)))
    pre = _smoother_device_arrays(st.pre_key, rows, dinv, rho, st.dtype,
                                  power_rho=power)
    post = _smoother_device_arrays(st.post_key, rows, dinv, rho, st.dtype,
                                   power_rho=power)

    cgp = st.coarse_grid_p(i)
    nc_p = int(np.prod(cgp))
    fine = (k, lv.n_pad)
    coarse = (st.ks[i + 1], st.n_pads[i + 1])
    T = _local_remap(_move(mesh, tv, lv.slabs, lv.solve), r0, lv, cgp,
                     _transfer_block(lv.n_pad // k), mesh)
    S_f, St_f = _sharded_dia(mesh, lv, S), _sharded_dia(mesh, lv, St)
    level = DeviceLevel(
        A=ShardedOperator.of_factors([A_f], mesh, fine, fine, A.shape,
                                     A.nnz, A.dtype),
        P=ShardedOperator.of_factors(
            [S_f, _ShardedWindowed.of_local(T, mesh, k)], mesh, coarse,
            fine, (lv.n, nc_p), lv.n * S.ndiags, S.dtype),
        R=ShardedOperator.of_factors(
            [_ShardedTransposed.of_local(T, mesh, k), St_f], mesh, fine,
            coarse, (nc_p, lv.n), lv.n * St.ndiags, T.dtype),
        pre=_smoother_wrap(st.pre_key, pre),
        post=_smoother_wrap(st.post_key, post), n=lv.n,
        n_pad=lv.n_pad // k)
    info = {"level": i, "n": lv.n, "strides": lv.strides,
            "ndiags": A.ndiags, "rho_D_inv_A": rho}
    return level, info, A_c, Bc


def _next_slabs(st, i, A_c, Bc=None):
    """Level ``i``'s coarse rows (each slab's, on the coarse grid) as
    level ``i + 1``'s slabs, re-laid on its padded grid: every dim but
    the first padded on the rank, the first dim's padding rows the
    move's zeros.  ``Bc``: the coarse candidate (none for a classical
    level)."""
    lv, nxt = st.level(i), st.level(i + 1)
    rows0 = A_c.data.shape[-1] // int(np.prod(lv.coarse_grid[1:]))
    here = (rows0,) + lv.coarse_grid[1:]
    there = (rows0,) + nxt.grid_p[1:]
    offsets, order = _relaid_offsets(A_c.offsets, lv.coarse_grid,
                                     nxt.grid_p)
    held = lv.coarse_rows(nxt.row)
    data = _ordered(_grid_pad_vec(A_c.data, here, there), order)
    A = DIAMatrix(data=_move(st.mesh, data, held, nxt.slabs),
                  offsets=offsets, shape=(nxt.n, nxt.n), nnz=A_c.nnz)
    if Bc is None:
        return A, None
    return A, _move(st.mesh, _grid_pad_vec(Bc, here, there), held,
                    nxt.slabs)


def _first_slab(st, src, B_host):
    """Level 0's slab on this rank: its A's rows read from the host A, and
    its candidate (the caller's B's rows, or ones), zero where A's
    diagonal is."""
    lv, mesh = st.level(0), st.mesh
    g0, g1 = (r // lv.row for r in lv.slabs.mine(mesh))
    offsets, data = src.padded_rows(lv.grid_p, g0, g1, st.dtype, mesh.device)
    A = DIAMatrix(data=data, offsets=offsets, shape=(lv.n, lv.n),
                  nnz=src.nnz)
    diag = A.diagonal()
    if B_host is None:
        return A, (diag != 0).to(st.dtype)
    grid = src.grid
    h0, h1 = min(g0, grid[0]), min(g1, grid[0])
    row = int(np.prod(grid[1:]))
    B = torch.as_tensor(B_host[h0 * row:h1 * row], dtype=st.dtype,
                        device=mesh.device)
    return A, torch.where(diag != 0, _grid_pad_vec(
        B, (h1 - h0,) + grid[1:], (g1 - g0,) + lv.grid_p[1:]), 0)


def _gathered(st, i, A_c, Bc=None):
    """Level ``i``'s coarse A and candidate (if any) whole on every
    rank."""
    lv = st.level(i)
    held = lv.coarse_rows(int(np.prod(lv.coarse_grid[1:])))
    nc = int(np.prod(lv.coarse_grid))
    whole = _Layout(1, ((0, nc),))
    return (DIAMatrix(data=_move(st.mesh, A_c.data, held, whole),
                      offsets=A_c.offsets, shape=A_c.shape, nnz=A_c.nnz),
            None if Bc is None else _move(st.mesh, Bc, held, whole))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _host_candidate(B, n):
    """The caller's candidate as a host array of at least n entries."""
    if isinstance(B, torch.Tensor):
        B = B.detach().cpu().numpy()
    B = np.asarray(B)
    if B.ndim != 1 or B.shape[0] < n:
        raise ValueError("B must be a length-n near-nullspace candidate "
                         "(multi-candidate: use device_sa_setup_block)")
    return B


def partitioned_sa_setup(A, grid, mesh, *, B=None, dtype=torch.float32,
                         omega=4.0 / 3.0, stride=3, max_coarse=400,
                         max_levels=12, pre_key, post_key,
                         improve_candidates_iters=0, mixed_precision=False,
                         lane_align=False):
    """The structured SA setup partitioned over ``mesh``'s ranks (see the
    module docstring); ``device_sa_setup(A, grid, mesh=mesh, ...)`` calls
    it with its arguments and normalised smoother specs.  Returns a
    :class:`StructuredDeviceSolver` over this rank's
    :class:`~pyamg_tpu_torch.parallel.ShardedHierarchy`: per rank, every
    level's arrays those of ``shard_hierarchy(device_sa_setup(A, grid,
    ...).hierarchy, mesh)`` (its default ``min_local_rows``).  Raises
    ValueError for ``lane_align`` and ``mixed_precision``: a sharded
    hierarchy never takes the interleaved route and holds no float64
    A64."""
    if lane_align or mixed_precision:
        raise ValueError(
            "the partitioned setup builds a row-sharded hierarchy, which "
            "runs neither lane_align=True (no interleaved route) nor "
            "mixed_precision=True (no float64 A64); ROADMAP.md Queue 1 "
            "item 14")
    _check_dtype(dtype)
    device = mesh.device
    src = _HostOperator(A, grid)
    grid = src.grid
    n = int(np.prod(grid))
    B_host = None if B is None else _host_candidate(B, n)
    plan, cur_grid = _coarsening_plan(
        None, grid, stride, 3, max_coarse, max_levels,
        coupling=lambda _A, _grid: _coupling(src, mesh, dtype))
    plan = tuple((tuple(g), tuple(gp), tuple(s)) for g, gp, s in plan)
    nc = int(np.prod(cur_grid))
    n_pads = tuple(_solve_pad(int(np.prod(gp))) for _, gp, _ in plan) + (nc,)
    ks = tuple(_level_groups(m, mesh.world, _MIN_LOCAL_ROWS)
               for m in n_pads)
    st = _Setup(mesh, plan, ks, n_pads, dtype, omega, pre_key, post_key,
                int(improve_candidates_iters))

    levels, infos = [], []
    i, whole = 0, None
    lv = st.level(0)
    if _partitioned(lv, _relaid_offsets(src.offsets, grid, lv.grid_p)[0],
                    mesh):
        A_s, Bv = _first_slab(st, src, B_host)
        while True:
            level, info, A_c, Bc = _partition_level(st, i, A_s, Bv)
            levels.append(level)
            infos.append(info)
            i += 1
            if i == len(plan) or not _partitioned(st.level(i), _relaid_offsets(
                    A_c.offsets, plan[i][0], plan[i][1])[0], mesh):
                break
            A_s, Bv = _next_slabs(st, i - 1, A_c, Bc)
        whole = _gathered(st, i - 1, A_c, Bc)

    # the gathered levels: the whole setup's code on every rank
    if whole is None:
        _, A_w = _grid_operator(A, grid, dtype, device)
        B0 = (None if B_host is None
              else torch.as_tensor(B_host.ravel(), dtype=dtype, device=device))
        out, Ac_dense, coarse_inv = _setup_pipeline(
            A_w, B0, plan=plan, omega=omega, dtype=dtype, pre_key=pre_key,
            post_key=post_key, improve_iters=st.improve_iters)
    else:
        out, Ac_dense, coarse_inv = _setup_pipeline(
            whole[0], None, plan=plan[i:], omega=omega, dtype=dtype,
            pre_key=pre_key, post_key=post_key,
            improve_iters=st.improve_iters, B_coarse=whole[1])
    tail, tail_infos = _structured_levels(plan, out, pre_key, post_key,
                                          first=i)
    tail.append(_dense_level(Ac_dense, nc))
    for j, lvl in enumerate(tail, start=i):
        levels.append(_shard_level(
            lvl, mesh, (ks[j], n_pads[j]),
            (ks[j + 1], n_pads[j + 1]) if j + 1 < len(n_pads) else None))
    infos += tail_infos
    hier = ShardedHierarchy(
        levels=tuple(levels), coarse_inv=coarse_inv, nc=nc,
        nc_pad=n_pads[-1] // ks[-1], dtype=dtype, A64=None, mesh=mesh,
        groups=ks, n_pads=n_pads)
    return StructuredDeviceSolver(hier, grid, plan[0][1], setup_info={
        "levels": infos, "nlevels": len(plan) + 1})
