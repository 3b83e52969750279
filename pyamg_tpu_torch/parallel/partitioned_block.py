"""The partitioned block / multi-candidate device SA setup (counterpart of
the JAX package's ``engine/block_setup.py::_setup_pipeline_block`` on a
row-sharded operator, which GSPMD partitions: ``tests/test_parallel.py::
test_distributed_block_setup_gspmd``).

``device_sa_setup_block(A, grid, B, mesh=mesh)`` comes here.  Every rank
calls it with the same arguments; ``A`` (BSR of bs x bs node blocks) and
the (n, m) candidates ``B`` stay on the host and each rank moves only its
node rows to its device (no rank converts the whole BSR).  The result is
this rank's block of the hierarchy that ``shard_hierarchy`` makes of the
whole setup's, built without any rank holding a whole large level.  The
layouts are the structured SA setup's (:mod:`.partitioned_setup`) on the
node grid: a level's setup slabs are whole aggregate rows (``stride``
node rows) of dim 0, its solve layout ``shard_hierarchy``'s even split of
its node rows (a block level takes no solve padding).  On a large level:

1. A goes to the solve layout; rho(D^-1 A) by power iteration through
   B1's halo mode (one ring apply a step) and the block D^-1, from this
   rank's slice of the hashed start vector, each norm one all_reduce;
2. ``block_setup._coarsen_level_block`` with :class:`_BlockSlabProducts`:
   the Gram fit and the tentative are local per aggregate, and each
   shifted read of the whole grid's products (``_bspgemm``'s rows i +
   oa, ``_btranspose``'s rolls) is a slice of the slab extended by its
   ring neighbours' node rows, which one exchange of an operand brings
   (wrapping where the rolls wrap); the coarse candidates L^T move with
   the coarse rows onto the next level's slabs;
3. the smoother arrays (the block D^-1; Richardson's and Chebyshev's
   rho(A) through B1's halo mode);
4. the sharded operators from this rank's pieces: A, S and S^T for B1's
   halo mode, and the candidates' remap Q (an m-slot WindowedELL) built
   from the local rows with global coarse columns (K6, and K7 for Q^T).

A level that is not large, or whose slabs are narrower than its
products' reach, is gathered once and it and every level below run the
whole setup's code, sharded by ``shard_hierarchy``'s rule.  In a world of
one every large level is a ring of one and the setup gives the whole
setup's bits; across P ranks the norms add by rank, so levels agree to
rounding.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..engine.block_setup import (BlockStructuredDeviceSolver, _BDia,
                                  _block_levels, _block_plan,
                                  _block_power_rho, _block_smoother_arrays,
                                  _block_smoother_wrap, _bmm_small,
                                  _coarsen_level_block, _compact_bdia,
                                  _pad_blocks, _setup_pipeline_block,
                                  _spd_inv_small)
from ..engine.device_setup import _check_dtype, _dense_level, _transfer_block
from ..engine.hierarchy import DeviceLevel
from ..sparse.block_dia import BlockDIAMatrix, _distinct
from .dist_spmv import start_halo_exchange
from .partition import (ShardedHierarchy, ShardedOperator, _level_groups,
                        _node_groups, _shard_level, _ShardedBlockDIA,
                        _ShardedTransposed, _ShardedWindowed)
from .partitioned_setup import (_MIN_LOCAL_ROWS, _coarse_columns, _Layout,
                                _local_windowed_rows, _move, _ordered,
                                _partitioned, _relaid_offsets, _Setup,
                                _shift_pieces)

__all__ = ["partitioned_block_setup"]

# block_dia_from_scipy's bound: more block diagonals are no banded operator
_MAX_DIAGS = 600


class _HostBlockOperator:
    """The caller's block operator where it holds it (scipy BSR, or CSR
    in scipy's block-size estimate, or a BlockDIAMatrix): the grid, the
    block size, the block offsets on the grid, nnz, and the blocks of a
    range of node rows, read from those rows' entries alone (each stored
    block's diagonal found once on the host, as ``block_dia_from_scipy``
    finds it)."""

    def __init__(self, A, grid):
        self.grid = tuple(int(g) for g in grid)
        nb = int(np.prod(self.grid))
        if sp.issparse(A):
            bsr = A.tobsr() if A.format != "bsr" else A
            bs, bs2 = bsr.blocksize
            if bs != bs2:
                raise ValueError("square blocks required")
            if bsr.shape[0] != nb * bs:
                raise ValueError(f"grid {self.grid} (x bs) does not match A "
                                 f"{bsr.shape}")
            rows_b = np.repeat(np.arange(nb), np.diff(bsr.indptr))
            offsets, self.d_index = _distinct(bsr.indices - rows_b, nb)
            if len(offsets) > _MAX_DIAGS:
                raise ValueError("operator is not block-banded on this grid")
            self.bsr, self.bdia = bsr, None
            self.offsets = tuple(int(o) for o in offsets)
            self.bs, self.nnz = int(bs), int(bsr.nnz)
        elif isinstance(A, BlockDIAMatrix):
            self.bsr, self.bdia = None, A
            self.offsets, self.bs, self.nnz = tuple(A.offsets), A.bs, A.nnz
        else:
            raise TypeError("A must be scipy sparse or BlockDIAMatrix")

    def rows(self, r0, r1, dtype, device):
        """(nd, r1 - r0, bs, bs) blocks of the node rows [r0, r1) on
        ``device`` (as ``block_dia_from_scipy`` stores them: the blocks
        and their places go to the device, which scatters them)."""
        if self.bdia is not None:
            return self.bdia.data[:, r0:r1].to(dtype=dtype, device=device)
        bs, nd, length = self.bs, len(self.offsets), r1 - r0
        indptr = self.bsr.indptr
        e0, e1 = indptr[r0], indptr[r1]
        rows_b = np.repeat(np.arange(length), np.diff(indptr[r0:r1 + 1]))
        data = torch.zeros((nd * length, bs * bs), dtype=dtype, device=device)
        data.index_copy_(0, torch.as_tensor(
            self.d_index[e0:e1] * length + rows_b, device=device),
            torch.as_tensor(self.bsr.data[e0:e1].reshape(-1, bs * bs),
                            device=device).to(dtype))
        return data.reshape(nd, length, bs, bs)

    def padded_rows(self, grid_p, g0, g1, dtype, device):
        """The dim-0 node rows [g0, g1) of the padded node grid as block
        diagonals on ``device``: (offsets on ``grid_p``, ascending, and
        their (nd, (g1 - g0) * prod(grid_p[1:]), bs, bs) blocks), the
        grid's padding zeros, as ``_relayout_block`` lays the whole
        operator."""
        grid = self.grid
        h0, h1 = min(g0, grid[0]), min(g1, grid[0])
        row = int(np.prod(grid[1:]))
        data = self.rows(h0 * row, h1 * row, dtype, device)
        offsets, order = _relaid_offsets(self.offsets, grid, grid_p)
        here, there = (h1 - h0,) + grid[1:], (g1 - g0,) + tuple(grid_p[1:])
        return offsets, _ordered(torch.stack(
            [_pad_blocks(d, here, there) for d in data]), order)


class _BlockSlabProducts:
    """The block products of one coarsening step on this rank's slab of a
    level (``block_setup._coarsen_level_block``'s ``products``): node rows
    [first, first + slab) of the whole padded node grid's ``nb``.  A row's
    read at a shift past the slab is its ring neighbours' node rows, which
    one exchange of an operand brings for all of its diagonals (kept for
    its later products).  ``spgemm`` skips the rows whose target leaves
    the whole grid, as ``_bspgemm`` does, and forms each term in its
    order; ``transpose`` reads the rolls' wrapped rows from the ring, which
    wraps where they do; so every entry has the whole grid's bits."""

    def __init__(self, mesh, groups, slab_grid, first, nb):
        self.mesh, self.groups = mesh, groups
        self.slab_grid = tuple(slab_grid)
        self.first, self.nb = first, nb
        self._halos = {}

    def grid(self, grid_p):
        return self.slab_grid

    def _halo(self, M, hw):
        """The left neighbour's last and the right one's first ``hw`` node
        rows of every diagonal of M ((nd, hw, r, c) each)."""
        hw = max(hw, 1)
        got = self._halos.get(id(M.data))
        if got is None or got[0] < hw:
            left, right, reqs = start_halo_exchange(M.data, hw, self.mesh,
                                                    self.groups, axis=1)
            for req in reqs:
                req.wait()
            got = (hw, left, right, M.data)
            self._halos[id(M.data)] = got
        h, left, right, _ = got
        return hw, left[:, h - hw:], right[:, :hw]

    def spgemm(self, A: _BDia, B: _BDia, keep=None) -> _BDia:
        """C = A @ B on the slab (``_bspgemm``): per diagonal of A one
        batched product against the B diagonals it meets and one
        ``index_add_``, each over the slab's pieces (its own rows, or a
        halo's) that a shift of oa reads."""
        length = B.data.shape[1]
        hw, left, right = self._halo(B, max(abs(o) for o in A.offsets))
        out_offs = sorted({oa + ob for oa in A.offsets for ob in B.offsets
                           if keep is None or oa + ob in keep})
        pos = {o: i for i, o in enumerate(out_offs)}
        out = A.data.new_zeros((len(out_offs), length, A.data.shape[2],
                                B.data.shape[3]))
        srcs = (left, B.data, right)
        # per A diagonal: the B diagonals it meets and their outputs'
        # places, sent to the device in one copy (``_bspgemm``'s plan)
        plan = []
        for da, oa in enumerate(A.offsets):
            sel = [db for db, ob in enumerate(B.offsets)
                   if keep is None or oa + ob in keep]
            # the rows whose target row lies in the whole grid
            lo = max(0, -oa - self.first)
            hi = min(length, self.nb - oa - self.first)
            if sel and lo < hi:
                plan.append((da, oa, lo, hi, sel,
                             [pos[oa + B.offsets[db]] for db in sel]))
        meta = torch.tensor([v for *_, sel, idx in plan for v in sel + idx],
                            dtype=torch.int64, device=out.device)
        at = 0
        for da, oa, lo, hi, sel, _ in plan:
            k = len(sel)
            pick, idx = meta[at:at + k], meta[at + k:at + 2 * k]
            at += 2 * k
            for dst, s, sl in _shift_pieces(length, oa, hw):
                a0, a1 = max(dst.start, lo), min(dst.stop, hi)
                if a0 >= a1:
                    continue
                b0 = sl.start + a0 - dst.start
                b = srcs[s][:, b0:b0 + a1 - a0]
                if k < len(B.offsets):
                    b = torch.index_select(b, 0, pick)
                out[:, a0:a1].index_add_(
                    0, idx, _bmm_small(A.data[da, a0:a1], b))
        return _BDia(data=out, offsets=tuple(out_offs))

    def transpose(self, A: _BDia) -> _BDia:
        """A^T on the slab (``_btranspose``): offsets negated, blocks
        transposed, the node row i of offset p A's row i + p of offset -p
        (from a halo past the slab)."""
        length = A.data.shape[1]
        hw, left, right = self._halo(A, max(abs(o) for o in A.offsets))
        lookup = {o: d for d, o in enumerate(A.offsets)}
        offsets = tuple(sorted(-o for o in A.offsets))
        r, c = A.data.shape[2:]
        data = A.data.new_empty((len(offsets), length, c, r))
        for i, p in enumerate(offsets):
            d = lookup[-p]
            srcs = (left[d], A.data[d], right[d])
            for dst, s, sl in _shift_pieces(length, p, hw):
                data[i, dst] = srcs[s][sl].transpose(-1, -2)
        return _BDia(data=data, offsets=offsets)

    def compact(self, C, grid_p, stride, center, m, nnz):
        return _compact_bdia(C, grid_p, stride, center, m, nnz,
                             data_grid=self.slab_grid)


class _BlockRows:
    """This rank's node rows of a block level's A in the solve layout, as
    ``_block_power_rho`` and the block smoothers take an operator: its
    scalar diagonal, block size, local lengths, dtype and device, and
    ``@`` through B1's halo mode (one ring apply)."""

    def __init__(self, factor, local):
        self.factor, self.local = factor, local

    def diagonal(self):
        return self.local.diagonal()

    def block_diagonal(self):
        return self.local.block_diagonal()

    def __getattr__(self, name):
        if name in ("bs", "nb_pad", "n_pad", "dtype", "device"):
            return getattr(self.local, name)
        raise AttributeError(name)

    def __matmul__(self, x):
        return self.factor.apply(x)


def _local_candidates(Qv, n0, lv, coarse_grid_p, block, m, mesh):
    """This rank's row blocks of the candidates' remap Q (``block_setup.
    _candidate_factor``: node f's component c holds Qv[f, c, j] at its
    aggregate's coarse unknown j) from its node rows [n0, n0 + len(Qv))
    of the solve layout."""
    nodes, bs, _ = Qv.shape
    agg, _ = _coarse_columns(torch.arange(n0, n0 + nodes, device=Qv.device),
                             lv, coarse_grid_p)
    cols = (agg[:, None, None] * m
            + torch.arange(m, device=Qv.device)).expand(nodes, bs, m)
    return _local_windowed_rows(
        cols.reshape(nodes * bs, m), Qv.reshape(nodes * bs, m),
        (nodes * bs, int(np.prod(coarse_grid_p)) * m), block,
        lv.n * bs * m // lv.groups, mesh)


def _block_level(st, i, A, Bp):
    """Level ``i`` from this rank's slab of its A (a BlockDIAMatrix of the
    slab's node rows, the whole operator's offsets, shape and nnz) and of
    its candidates (nodes, bs, m): returns (the sharded DeviceLevel, its
    setup_info entry, the coarse A's and candidates' slab rows on the
    coarse grid)."""
    mesh, lv = st.mesh, st.level(i)
    k, bs, m = lv.groups, A.bs, st.m
    n0, _ = lv.solve.mine(mesh)
    s0, _ = lv.slabs.mine(mesh)

    def sharded(M):
        return _ShardedBlockDIA(_move(mesh, M.data, lv.slabs, lv.solve,
                                      axis=1), M.offsets, max(M.halo, 1),
                                mesh, k, lv.n * M.bs)

    def norm(v):
        if k == 1:
            return torch.linalg.vector_norm(v)
        return torch.sqrt(mesh.sum_groups(torch.sum(v * v), k))

    A_f = sharded(A)
    rows = _BlockRows(A_f, BlockDIAMatrix(data=A_f.data, offsets=A.offsets,
                                          shape=A.shape, bs=bs, nnz=A.nnz))
    Dinv = _spd_inv_small(rows.block_diagonal())

    def power(op, D):
        return _block_power_rho(op, D, norm=norm, start=n0 * bs)

    rho = power(rows, Dinv)
    S, St, Qv, _, A_c, Bc, rho = _coarsen_level_block(
        A, Bp, lv.grid_p, lv.strides[0], lv.center[0], st.omega, m,
        st.dtype, rho=rho, products=_BlockSlabProducts(
            mesh, k, lv.slab_grid(mesh), s0, lv.n))
    pre = _block_smoother_arrays(st.pre_key, rows, Dinv, rho, st.dtype,
                                 power_rho=power)
    post = _block_smoother_arrays(st.post_key, rows, Dinv, rho, st.dtype,
                                  power_rho=power)

    cgp = st.coarse_grid_p(i)
    nc_p = int(np.prod(cgp)) * m
    n = lv.n * bs
    fine = (k, n)
    coarse = (st.ks[i + 1], st.n_pads[i + 1])
    Q = _local_candidates(_move(mesh, Qv, lv.slabs, lv.solve, axis=0), n0,
                          lv, cgp, _transfer_block(n // k), m, mesh)
    level = DeviceLevel(
        A=ShardedOperator.of_factors([A_f], mesh, fine, fine, A.shape,
                                     A.nnz, A.dtype),
        P=ShardedOperator.of_factors(
            [sharded(S), _ShardedWindowed.of_local(Q, mesh, k)], mesh,
            coarse, fine, (n, nc_p), n * S.ndiags * m, S.dtype),
        R=ShardedOperator.of_factors(
            [_ShardedTransposed.of_local(Q, mesh, k), sharded(St)], mesh,
            fine, coarse, (nc_p, n), n * St.ndiags * m, Q.dtype),
        pre=_block_smoother_wrap(st.pre_key, pre),
        post=_block_smoother_wrap(st.post_key, post), n=n, n_pad=n // k)
    info = {"level": i, "n": n, "bs": bs, "ndiags": A.ndiags, "rho": rho}
    return level, info, A_c, Bc


def _first_block_slab(st, src, B_host):
    """Level 0's slab on this rank: its A's node rows read from the host
    operator and its candidates' rows (nodes, bs, m) from the host B."""
    lv, mesh = st.level(0), st.mesh
    g0, g1 = (r // lv.row for r in lv.slabs.mine(mesh))
    offsets, data = src.padded_rows(lv.grid_p, g0, g1, st.dtype, mesh.device)
    bs, n = src.bs, lv.n * src.bs
    A = BlockDIAMatrix(data=data, offsets=offsets, shape=(n, n), bs=bs,
                       nnz=src.nnz)
    grid = src.grid
    h0, h1 = min(g0, grid[0]), min(g1, grid[0])
    row = int(np.prod(grid[1:])) * bs
    B = torch.as_tensor(B_host[h0 * row:h1 * row], dtype=st.dtype,
                        device=mesh.device).reshape(-1, bs, st.m)
    return A, _pad_blocks(B, (h1 - h0,) + grid[1:],
                          (g1 - g0,) + lv.grid_p[1:])


def _next_block_slabs(st, i, A_c, Bc):
    """Level ``i``'s coarse node rows (each slab's, on the coarse grid)
    as level ``i + 1``'s slabs, re-laid on its padded grid: every dim but
    the first padded on the rank, the first dim's padding rows the move's
    zeros."""
    lv, nxt = st.level(i), st.level(i + 1)
    rows0 = Bc.shape[0] // int(np.prod(lv.coarse_grid[1:]))
    here = (rows0,) + lv.coarse_grid[1:]
    there = (rows0,) + nxt.grid_p[1:]
    offsets, order = _relaid_offsets(A_c.offsets, lv.coarse_grid,
                                     nxt.grid_p)
    held = lv.coarse_rows(nxt.row)
    data = _ordered(torch.stack([_pad_blocks(d, here, there)
                                 for d in A_c.data]), order)
    n = nxt.n * st.m
    A = BlockDIAMatrix(data=_move(st.mesh, data, held, nxt.slabs, axis=1),
                       offsets=offsets, shape=(n, n), bs=st.m, nnz=A_c.nnz)
    return A, _move(st.mesh, _pad_blocks(Bc, here, there), held, nxt.slabs,
                    axis=0)


def _gathered_block(st, i, A_c, Bc):
    """Level ``i``'s coarse A and candidates whole on every rank."""
    lv = st.level(i)
    held = lv.coarse_rows(int(np.prod(lv.coarse_grid[1:])))
    whole = _Layout(1, ((0, int(np.prod(lv.coarse_grid))),))
    return (BlockDIAMatrix(data=_move(st.mesh, A_c.data, held, whole,
                                      axis=1), offsets=A_c.offsets,
                           shape=A_c.shape, bs=A_c.bs, nnz=A_c.nnz),
            _move(st.mesh, Bc, held, whole, axis=0))


def _host_candidates(B, n):
    """The caller's (n, m) candidate block as a float64 host array (a
    vector as one column), checked: m <= 4, n rows."""
    if isinstance(B, torch.Tensor):
        B = B.detach().cpu().numpy()
    B = np.asarray(B, dtype=np.float64)
    if B.ndim == 1:
        B = B[:, None]
    if B.shape[1] > 4:
        raise ValueError("block device setup supports m <= 4 candidates")
    if B.shape[0] != n:
        raise ValueError("B rows must equal n")
    return B


def _groups(nodes, bs, world):
    """The group count ``shard_hierarchy`` gives a block level of
    ``nodes`` node rows of ``bs`` unknowns in a world of ``world``."""
    return _node_groups(_level_groups(nodes * bs, world, _MIN_LOCAL_ROWS),
                        nodes)


def _large(lv, offsets, bs, mesh):
    """Whether block level ``lv`` is built on slabs (``_partitioned`` by
    its node rows, with ``shard_hierarchy``'s block group count)."""
    return _partitioned(lv, offsets, mesh,
                        groups=lambda w: _groups(lv.n, bs, w))


def partitioned_block_setup(A, grid, B, mesh, *, dtype=torch.float32,
                            omega=4.0 / 3.0, stride=3, max_coarse=400,
                            max_levels=12, pre_key, post_key,
                            mixed_precision=False):
    """The block SA setup partitioned over ``mesh``'s ranks (see the
    module docstring); ``device_sa_setup_block(A, grid, B, mesh=mesh,
    ...)`` calls it with its arguments and normalised smoother specs.
    Returns a :class:`BlockStructuredDeviceSolver` over this rank's
    :class:`~pyamg_tpu_torch.parallel.ShardedHierarchy`: per rank, every
    level's arrays those of ``shard_hierarchy(device_sa_setup_block(A,
    grid, B, ...).hierarchy, mesh)`` (its default ``min_local_rows``).
    Raises ValueError for ``mixed_precision``: a sharded hierarchy holds
    no float64 A64."""
    if mixed_precision:
        raise ValueError(
            "the partitioned block setup builds a row-sharded hierarchy, "
            "which runs no mixed_precision=True (no float64 A64); "
            "ROADMAP.md Queue 1 item 14")
    _check_dtype(dtype)
    src = _HostBlockOperator(A, grid)
    grid, bs = src.grid, src.bs
    B_host = _host_candidates(B, int(np.prod(grid)) * bs)
    m = B_host.shape[1]
    plan, cur_grid = _block_plan(grid, bs, m, stride, max_coarse, max_levels)
    dim = len(grid)
    splan = tuple((tuple(g), tuple(gp), (stride,) * dim) for g, gp in plan)
    sizes = [(int(np.prod(gp)), bs if j == 0 else m)
             for j, (_, gp) in enumerate(plan)]
    nc = int(np.prod(cur_grid)) * m
    n_pads = tuple(nodes * b for nodes, b in sizes) + (nc,)
    ks = tuple(_groups(nodes, b, mesh.world) for nodes, b in sizes) + (
        _groups(nc, 1, mesh.world),)
    st = _Setup(mesh, splan, ks, n_pads, dtype, omega, pre_key, post_key,
                m=m, padded=False)

    levels, infos = [], []
    i, whole = 0, None
    lv = st.level(0)
    if _large(lv, _relaid_offsets(src.offsets, grid, lv.grid_p)[0], bs,
              mesh):
        A_s, Bp = _first_block_slab(st, src, B_host)
        while True:
            level, info, A_c, Bc = _block_level(st, i, A_s, Bp)
            levels.append(level)
            infos.append(info)
            i += 1
            if i == len(plan) or not _large(st.level(i), _relaid_offsets(
                    A_c.offsets, plan[i][0], plan[i][1])[0], m, mesh):
                break
            A_s, Bp = _next_block_slabs(st, i - 1, A_c, Bc)
        whole = _gathered_block(st, i - 1, A_c, Bc)

    # the gathered levels: the whole setup's code on every rank
    if whole is None:
        device = mesh.device
        A_w = BlockDIAMatrix(
            data=src.rows(0, int(np.prod(grid)), dtype, device),
            offsets=src.offsets, shape=(int(np.prod(grid)) * bs,) * 2, bs=bs,
            nnz=src.nnz)
        whole = (A_w, torch.as_tensor(B_host, dtype=dtype, device=device
                                      ).reshape(-1, bs, m))
    out, Ac_dense, coarse_inv = _setup_pipeline_block(
        whole[0], whole[1], plan=tuple(plan[i:]), stride=stride, omega=omega,
        m=m, dtype=dtype, pre_key=pre_key, post_key=post_key)
    tail, tail_infos = _block_levels(plan, out, stride, pre_key, post_key,
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
    return BlockStructuredDeviceSolver(
        hier, grid, plan[0][1], bs,
        setup_info={"levels": infos, "m": m, "stride": stride,
                    "nlevels": len(plan) + 1})
