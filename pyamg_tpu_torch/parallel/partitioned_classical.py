"""The partitioned classical (Ruge-Stüben) device setup (counterpart of
the JAX package's ``engine/classical_setup.py::_rs_setup_pipeline`` on a
row-sharded operator, which GSPMD partitions: ``tests/test_parallel.py::
test_distributed_classical_setup_gspmd``).

``device_rs_setup(A, grid, mesh=mesh)`` comes here.  Every rank calls it
with the same arguments; ``A`` stays on the host and each rank moves only
its rows to its device.  The result is this rank's block of the hierarchy
that ``shard_hierarchy`` makes of the whole setup's, built without any
rank holding a whole large level.  It runs on the structured SA setup's
layouts and slab products (:mod:`.partitioned_setup`): a level's setup
slabs are whole rows of dim 0 of its C sublattice (``strides[0]`` grid
rows a coarse row; one grid row where dim 0 is not coarsened, as
``stride="auto"`` plans for an anisotropic stencil), its solve layout
``shard_hierarchy``'s even split.  On a large level:

1. A goes to the solve layout; rho(D^-1 A) by power iteration through K16
   from this rank's slice of the hashed start vector, each norm one
   all_reduce;
2. ``classical_setup._rs_coarsen_level`` with the slab products and the
   slab's C/F marks (``_GridMarks`` of the slab's global rows and A's
   reach past them: each mark and each shifted mark of the whole grid's
   rolls read off the global flat index modulo the grid's points, so no
   exchange): P_emb = S_n ... S_1 D_C, each pass through the filtered
   slab SpGEMM, R_emb its slab transpose, R_emb (A P_emb) and its
   compaction onto the coarse rows the slab holds;
3. the smoother arrays (Jacobi's dinv; Richardson's and Chebyshev's
   rho(A) through K16);
4. the sharded operators from this rank's pieces: A, P_emb and R_emb for
   K16, and the embedding E (the C points' coarse columns) built from the
   local rows with global coarse columns (K6, and K7 for E^T).

A level that is not large, or whose slabs are narrower than its
products' reach, is gathered once and it and every level below run the
whole setup's code, sharded by ``shard_hierarchy``'s rule.  In a world of
one every large level is a ring of one and the setup gives the whole
setup's bits; across P ranks the norms and couplings add by rank, so
levels agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.classical_setup import (_GridMarks, _rs_coarsen_level,
                                      _rs_levels, _rs_setup_pipeline)
from ..engine.device_setup import (StructuredDeviceSolver, _check_dtype,
                                   _coarsening_plan, _dense_level, _dinv_of,
                                   _grid_operator, _smoother_device_arrays,
                                   _smoother_wrap, _solve_pad,
                                   _transfer_block)
from ..engine.hierarchy import DeviceLevel
from .partition import (ShardedHierarchy, ShardedOperator, _level_groups,
                        _shard_level, _ShardedTransposed, _ShardedWindowed)
from .partitioned_setup import (_MIN_LOCAL_ROWS, _coarse_columns,
                                _coupling, _first_slab, _gathered,
                                _HostOperator, _local_windowed_rows,
                                _next_slabs, _partitioned, _relaid_offsets,
                                _Setup, _sharded_dia, _SlabProducts,
                                _solve_rows)

__all__ = ["partitioned_rs_setup"]


def _local_embedding(r0, length, lv, coarse_grid_p, block, dtype, mesh):
    """This rank's row blocks of the embedding E (``classical_setup.
    _embedding_factor``: a C point's one entry 1 at its coarse index on
    the coarse padded grid) for its rows [r0, r0 + length) of the solve
    layout."""
    col, root = _coarse_columns(
        torch.arange(r0, r0 + length, device=mesh.device), lv, coarse_grid_p)
    have = max(0, min(lv.n - r0, length))
    cols = torch.where(root, col, -1)[:have, None]
    return _local_windowed_rows(
        cols, torch.ones((have, 1), dtype=dtype, device=mesh.device),
        (length, int(np.prod(coarse_grid_p))), block,
        int(np.prod(lv.coarse_grid)) // lv.groups, mesh)


def _rs_level(st, i, A):
    """Level ``i`` from this rank's slab of its A (a DIAMatrix of the
    slab's rows, the whole operator's offsets, shape and nnz): returns
    (the sharded DeviceLevel, its setup_info entry, the coarse A's slab
    rows on the coarse grid)."""
    mesh, lv = st.mesh, st.level(i)
    k = lv.groups
    r0, r1 = lv.solve.mine(mesh)
    A_f, rows, power = _solve_rows(mesh, lv, A)
    dinv = _dinv_of(rows.diagonal())
    rho = power(rows, dinv)
    marks = _GridMarks(lv.grid_p, lv.strides, lv.center, A.device,
                       rows=lv.slabs.mine(mesh),
                       halo=max(abs(o) for o in A.offsets))
    P_emb, R_emb, A_c = _rs_coarsen_level(
        A, lv.grid_p, lv.strides, lv.center, st.dtype,
        products=_SlabProducts(mesh, k, lv.slab_grid(mesh)), marks=marks)
    pre = _smoother_device_arrays(st.pre_key, rows, dinv, rho, st.dtype,
                                  power_rho=power)
    post = _smoother_device_arrays(st.post_key, rows, dinv, rho, st.dtype,
                                   power_rho=power)

    cgp = st.coarse_grid_p(i)
    nc_p = int(np.prod(cgp))
    fine = (k, lv.n_pad)
    coarse = (st.ks[i + 1], st.n_pads[i + 1])
    E = _local_embedding(r0, r1 - r0, lv, cgp, _transfer_block(lv.n_pad // k),
                         st.dtype, mesh)
    level = DeviceLevel(
        A=ShardedOperator.of_factors([A_f], mesh, fine, fine, A.shape,
                                     A.nnz, A.dtype),
        P=ShardedOperator.of_factors(
            [_sharded_dia(mesh, lv, P_emb),
             _ShardedWindowed.of_local(E, mesh, k)], mesh, coarse, fine,
            (lv.n, nc_p), lv.n * P_emb.ndiags, P_emb.dtype),
        R=ShardedOperator.of_factors(
            [_ShardedTransposed.of_local(E, mesh, k),
             _sharded_dia(mesh, lv, R_emb)], mesh, fine, coarse,
            (nc_p, lv.n), lv.n * R_emb.ndiags, E.dtype),
        pre=_smoother_wrap(st.pre_key, pre),
        post=_smoother_wrap(st.post_key, post), n=lv.n,
        n_pad=lv.n_pad // k)
    info = {"level": i, "n": lv.n, "strides": lv.strides,
            "ndiags": A.ndiags, "rho_D_inv_A": rho}
    return level, info, A_c


def partitioned_rs_setup(A, grid, mesh, *, dtype=torch.float32,
                         stride="auto", max_coarse=400, max_levels=12,
                         pre_key, post_key, mixed_precision=False):
    """The structured Ruge-Stüben setup partitioned over ``mesh``'s ranks
    (see the module docstring); ``device_rs_setup(A, grid, mesh=mesh,
    ...)`` calls it with its arguments and normalised smoother specs.
    Returns a :class:`StructuredDeviceSolver` over this rank's
    :class:`~pyamg_tpu_torch.parallel.ShardedHierarchy`: per rank, every
    level's arrays those of ``shard_hierarchy(device_rs_setup(A, grid,
    ...).hierarchy, mesh)`` (its default ``min_local_rows``).  Raises
    ValueError for ``mixed_precision``: a sharded hierarchy holds no
    float64 A64."""
    if mixed_precision:
        raise ValueError(
            "the partitioned RS setup builds a row-sharded hierarchy, which "
            "runs no mixed_precision=True (no float64 A64); ROADMAP.md "
            "Queue 1 item 14")
    _check_dtype(dtype)
    device = mesh.device
    src = _HostOperator(A, grid)
    grid = src.grid
    plan, cur_grid = _coarsening_plan(
        None, grid, stride, 2, max_coarse, max_levels,
        coupling=lambda _A, _grid: _coupling(src, mesh, dtype))
    plan = tuple((tuple(g), tuple(gp), tuple(s)) for g, gp, s in plan)
    nc = int(np.prod(cur_grid))
    n_pads = tuple(_solve_pad(int(np.prod(gp))) for _, gp, _ in plan) + (nc,)
    ks = tuple(_level_groups(m, mesh.world, _MIN_LOCAL_ROWS)
               for m in n_pads)
    st = _Setup(mesh, plan, ks, n_pads, dtype, None, pre_key, post_key,
                centered=False)

    levels, infos = [], []
    i, whole = 0, None
    lv = st.level(0)
    if _partitioned(lv, _relaid_offsets(src.offsets, grid, lv.grid_p)[0],
                    mesh):
        A_s, _ = _first_slab(st, src, None)
        while True:
            level, info, A_c = _rs_level(st, i, A_s)
            levels.append(level)
            infos.append(info)
            i += 1
            if i == len(plan) or not _partitioned(st.level(i), _relaid_offsets(
                    A_c.offsets, plan[i][0], plan[i][1])[0], mesh):
                break
            A_s, _ = _next_slabs(st, i - 1, A_c)
        whole, _ = _gathered(st, i - 1, A_c)

    # the gathered levels: the whole setup's code on every rank
    if whole is None:
        _, whole = _grid_operator(A, grid, dtype, device)
    out, Ac_dense, coarse_inv = _rs_setup_pipeline(
        whole, plan=plan[i:], dtype=dtype, pre_key=pre_key,
        post_key=post_key)
    tail, tail_infos = _rs_levels(plan, out, pre_key, post_key, first=i)
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
        "levels": infos, "nlevels": len(plan) + 1, "family": "classical"})
