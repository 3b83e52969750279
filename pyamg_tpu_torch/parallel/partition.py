"""Row partitioning of device hierarchies over ranks (counterpart of
``pyamg_tpu/parallel/partition.py``).

JAX places each level's arrays row-sharded on a mesh and lets GSPMD
insert the collectives.  PyTorch has no partitioner, so here every rank
(SPMD, one process per rank) holds its own row block of each level's
operators and vectors, and the sharded operators carry their own
communication:

- a DIA operator applies through K16 (``halo_spmv.py``): ring halo
  exchange, interior rows while it runs, then the boundary rows;
- a block-DIA operator (node rows of a BlockDIAMatrix) applies through
  B1's halo mode (``halo_spmv.py::block_halo_spmv``), the halo in whole
  nodes, in K16's order; its residual b - A x is one pass of that mode;
- a dense or windowed operator gathers its input (``all_gather``) and
  applies its local rows (K6 for windowed);
- a windowed transpose (restriction stored as windowed(R^T)) applies its
  local fine rows into a full coarse partial through K7 and sums the
  partials over one replica per group (``all_reduce``);
- composed operators shard factor by factor, re-laying the vector out
  between factors whose row blocks differ;
- a transfer of the device-built setups gives its factors
  (``shard_factors``): the structured SA P = S T, R = T^T S^T and the
  block one P = S Q, R = Q^T S^T (S and S^T DIA or block DIA, T and Q
  the grid remaps as windowed operators of one slot or m slots a row),
  the embedded classical P = P_emb E, R = E^T R_emb (E the embedding of
  the coarse grid in the fine one); each remap is built on the device
  once a level and block, and shared by the level's P and R;
- the Neumann AIR restriction R r = Tinj^T (r - A z) keeps its local
  rows of A, Tinj and dinv_f: A through K6 on the gathered z, Tinj^T
  through K7 into a coarse partial summed over the groups;
- the Krylov dots sum their local partials (``all_reduce``).

Power-of-two agglomeration, as the reference's: a level on k < world
groups shards over ``rank // (world // k)`` and is replicated within a
group; its halo partners are ``rank -+ world // k``.  The JAX package
leaves a level on one group as it is; here every level is wrapped, and a
level on one group is a ring of one on each rank (halos are local
pointers, gathers and sums are no-ops), so a world of one applies its DIA
levels through K16 too, with the unsharded numerics.  A layout is
``(groups, global length)``; a rank's block of a vector in it has
``length / groups`` entries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..engine.device_setup import _transfer_block
from ..engine.hierarchy import DeviceHierarchy, DeviceLevel
from ..engine.relaxation import DeviceSmoother
from ..engine.unstructured_classical import (NeumannAIRRestriction,
                                            neumann_residual)
from ..engine.unstructured_setup import ComposedWindowed
from ..sparse import (ComposedOperator, DenseOperator, DIAMatrix,
                      TransposedWindowed, WindowedELL)
from ..sparse.block_dia import BlockDIAMatrix
from ..sparse.formats import fit, pad_vector
from ..sparse.window import windowed_rmatvec
from .dist_spmv import halo_width
from .halo_spmv import block_halo_spmv, halo_spmv
from .multihost import initialize_distributed, rank_device

__all__ = ["SolverMesh", "ShardedHierarchy", "ShardedOperator",
           "make_solver_mesh", "shard_hierarchy", "shard_vector"]


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to pyamg_tpu_torch yet "
                               f"(ROADMAP.md Queue 1 item {item})")


@dataclass(frozen=True)
class SolverMesh:
    """This rank's place in a 1-D ring of ranks, one device each (the
    port's counterpart of a 1-D ``jax.sharding.Mesh``)."""

    rank: int
    world: int
    device: torch.device
    axis: str = "x"

    # the reference's (k, ndev/k) submesh of a level on k groups is this
    # rank's (shard, rank % stride) pair: rows shard over the first
    # coordinate, replicate over the second

    def stride(self, groups):
        """Ranks per shard group on a layout of ``groups`` groups."""
        return self.world // groups

    def shard(self, groups):
        """This rank's shard index on a layout of ``groups`` groups."""
        return self.rank // self.stride(groups)

    def partners(self, groups):
        """(left, right) halo partners: the same replica of the
        neighbouring shards (this rank itself on a ring of one)."""
        s = self.stride(groups)
        return (self.rank - s) % self.world, (self.rank + s) % self.world

    def local(self, v, groups):
        """This rank's block of a global vector (last axis)."""
        n = v.shape[-1] // groups
        s = self.shard(groups)
        return v[..., s * n:(s + 1) * n]

    def gather(self, v, groups):
        """The global vector from every group's block (one all_gather over
        the world, one replica per group kept)."""
        if groups == 1 or self.world == 1:
            return v
        parts = [torch.empty_like(v) for _ in range(self.world)]
        dist.all_gather(parts, v.contiguous())
        return torch.cat(parts[::self.stride(groups)], dim=-1)

    def sum_groups(self, t, groups):
        """The sum of per-rank partials over one replica of each group
        (one all_reduce); every rank gets it."""
        if groups == 1 or self.world == 1:
            return t
        t = t.clone() if self.rank % self.stride(groups) == 0 \
            else torch.zeros_like(t)
        dist.all_reduce(t)
        return t

    def relayout(self, v, src, dst):
        """Block ``v`` of layout ``src`` as its block of layout ``dst``
        (the global vector fitted to dst's length: padding appended or
        cut, as ``fit`` does for unsharded vectors)."""
        if src == dst:
            return v
        full = self.gather(v, src[0])
        return self.local(fit(full, dst[1]), dst[0]).contiguous()


def make_solver_mesh(n_devices=None, axis="x", device=None):
    """The mesh over every rank of the process group, initialising a world
    of one first if ``torch.distributed`` is not initialised.  ``device``
    is this rank's (default: its CUDA card, which raises without a GPU
    unless ``device="cpu"``); CUDA meshes need the NCCL backend, CPU ones
    gloo.  ``n_devices`` must be the world size (sub-meshes of a world
    are not ported)."""
    if not dist.is_initialized():
        initialize_distributed(device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices {n_devices} != world size {world}: "
                         "a mesh spans every rank of the process group")
    dev = rank_device(device, rank)
    backend = dist.get_backend()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"a {dev.type} mesh needs the {want} backend, the "
                         f"process group has {backend}")
    return SolverMesh(rank=rank, world=world, device=dev, axis=axis)


def shard_vector(mesh, v, axis="x"):
    """This rank's block of a global vector (numpy or tensor) sharded over
    every rank, on the mesh's device."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has no axis {axis!r}")
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v))
    return mesh.local(v.to(mesh.device), mesh.world).contiguous()


def _level_groups(n_pad, ndev, min_local_rows):
    """Pick the number of shard groups for a level: the largest
    power-of-two divisor k of ndev keeping >= min_local_rows rows per
    shard.  k == ndev: full sharding; 1 < k < ndev: the level is
    redistributed onto k device groups (each group's shard replicated
    across the ndev/k devices within it); k == 1: fully replicated
    (agglomerated)."""
    k = 1
    cand = 2
    while cand <= ndev and ndev % cand == 0 and n_pad % cand == 0 \
            and n_pad // cand >= max(min_local_rows, 1):
        k = cand
        cand *= 2
    return k


def _rows(t, mesh, groups):
    """This rank's block of rows (dim 0)."""
    n = t.shape[0] // groups
    s = mesh.shard(groups)
    return t[s * n:(s + 1) * n].contiguous()


class _ShardedDIA:
    """A square DIA factor row-sharded over ``groups`` (K16)."""

    def __init__(self, A, mesh, groups):
        self.halo = halo_width(A)
        if A.n_pad % groups or self.halo > A.n_pad // groups:
            groups = 1                     # too few rows: replicate
        self.mesh, self.groups = mesh, groups
        self.data = mesh.local(A.data, groups).contiguous()
        self.offsets = A.offsets
        self.offsets_t = A.offsets_t
        self.in_layout = self.out_layout = (groups, A.n_pad)

    def apply(self, x):
        return halo_spmv(self.data, self.offsets, self.offsets_t, x,
                         self.halo, self.mesh, self.groups)


class _ShardedBlockDIA:
    """A square block-DIA factor row-sharded by node rows over ``groups``
    (B1's halo mode, the halo in whole nodes)."""

    def __init__(self, A, mesh, groups):
        self.halo = max(A.halo, 1)
        nb = A.nb_pad
        if nb % groups or self.halo > nb // groups:
            groups = 1                     # too few nodes: replicate
        self.mesh, self.groups = mesh, groups
        nl, sh = nb // groups, mesh.shard(groups)
        self.data = A.data[:, sh * nl:(sh + 1) * nl].contiguous()
        self.offsets = A.offsets
        self.offsets_t = A.offsets_t
        self.in_layout = self.out_layout = (groups, A.n_pad)

    def apply(self, x):
        return block_halo_spmv(self.data, self.offsets, self.offsets_t, x,
                               self.halo, self.mesh, self.groups)

    def residual(self, x, b):
        """b - A x in one pass (B1's halo mode ``RESID``)."""
        return block_halo_spmv(self.data, self.offsets, self.offsets_t, x,
                               self.halo, self.mesh, self.groups, b=b)


class _ShardedDense:
    """A dense factor: input gathered, local rows applied."""

    def __init__(self, D, mesh, groups):
        rows = D.data.shape[0]
        groups = groups if rows % groups == 0 else 1
        self.data = _rows(D.data, mesh, groups)
        self.in_layout = (1, D.data.shape[1])
        self.out_layout = (groups, rows)

    def apply(self, x):
        return torch.matmul(self.data, x)


def _local_windowed(W, mesh, groups):
    """This rank's row blocks of a WindowedELL (the whole operator when
    its block count does not divide: replicated, as the reference
    leaves it); returns (operator, groups)."""
    nb = W.data.shape[0]
    if nb % groups:
        return W, 1
    return WindowedELL(
        data=_rows(W.data, mesh, groups), idx=_rows(W.idx, mesh, groups),
        starts=_rows(W.starts, mesh, groups),
        shape=(nb // groups * W.block, W.shape[1]), block=W.block, w2=W.w2,
        m_chunks=W.m_chunks, nnz=W.nnz // groups), groups


class _ShardedWindowed:
    """A windowed forward factor: input gathered, local row blocks (K6)."""

    def __init__(self, W, mesh, groups):
        self.local, groups = _local_windowed(W, mesh, groups)
        self.in_layout = (1, W.m_chunks * W.w2)
        self.out_layout = (groups, W.n_pad)

    def apply(self, x):
        return self.local.matvec(x)


class _ShardedTransposed:
    """A windowed transpose: the local fine rows into a full coarse
    partial (K7), summed over one replica per group."""

    def __init__(self, W, mesh, groups):
        self.local, groups = _local_windowed(W, mesh, groups)
        self.mesh, self.groups = mesh, groups
        self.in_layout = (groups, W.n_pad)
        self.out_layout = (1, W.m_chunks * W.w2)

    def apply(self, r):
        return self.mesh.sum_groups(windowed_rmatvec(self.local, r),
                                    self.groups)


class _ShardedNeumannAIR:
    """The Neumann AIR restriction R r = Tinj^T (r - A z), z ``degree``
    F-masked Jacobi sweeps on A_ff z = r_F, on this rank's fine rows: A's
    and Tinj's row blocks and dinv_f's rows kept, each A z through K6 on
    the gathered z, Tinj^T through K7 into a coarse partial summed over
    the groups (the reference's branch, ``pyamg_tpu/parallel/
    partition.py:87-93``, shards the same three by rows)."""

    def __init__(self, R, mesh, groups):
        A, T = R.A, R.Tinj
        if not (A.n_pad == T.n_pad and A.block == T.block
                and A.data.shape[0] % groups == 0):
            groups = 1                     # rows that do not align: whole
        self.A, _ = _local_windowed(A, mesh, groups)
        self.Tinj, _ = _local_windowed(T, mesh, groups)
        self.dinv_f = mesh.local(fit(R.dinv_f, A.n_pad), groups).contiguous()
        self.degree, self.mesh, self.groups = R.degree, mesh, groups
        self.in_layout = (groups, A.n_pad)
        self.out_layout = (1, T.m_chunks * T.w2)

    def _apply_A(self, z):
        return self.A.matvec(self.mesh.gather(z, self.groups))

    def apply(self, r):
        r = neumann_residual(r, self.dinv_f, self.degree, self._apply_A)
        return self.mesh.sum_groups(windowed_rmatvec(self.Tinj, r),
                                    self.groups)


def _factors(op, block):
    """An operator as its factors, applied right to left; a device-built
    transfer gives its own (``shard_factors``), its windowed factors in
    row blocks of ``block``."""
    if isinstance(op, ComposedOperator):
        return [f for o in op.ops for f in _factors(o, block)]
    if isinstance(op, ComposedWindowed):
        return [f for o in op.factors for f in _factors(o, block)]
    if isinstance(op, TransposedWindowed):
        # (F0 F1 ...)^T = ... F1^T F0^T
        return [TransposedWindowed(f) if isinstance(f, WindowedELL) else f
                for f in reversed(_factors(op.base, block))]
    own = getattr(op, "shard_factors", None)
    if own is not None:
        return [f for o in own(block) for f in _factors(o, block)]
    name = type(op).__name__
    if name == "ELLMatrix":
        raise _not_ported("sharding a gather-ELL operator", 1)
    if not isinstance(op, (DIAMatrix, DenseOperator, WindowedELL,
                           BlockDIAMatrix, NeumannAIRRestriction)):
        raise TypeError(f"no sharded form of a {name}")
    return [op]


def _shard_factor(f, mesh, k_in, k_out):
    """One factor mapping a space on ``k_in`` groups to one on ``k_out``:
    a forward factor shards its rows (the output side), a transpose and
    the Neumann restriction their fine rows (the input side)."""
    if isinstance(f, TransposedWindowed):
        if not isinstance(f.base, WindowedELL):
            raise TypeError(f"no sharded form of the transpose of a "
                            f"{type(f.base).__name__}")
        return _ShardedTransposed(f.base, mesh, k_in)
    if isinstance(f, NeumannAIRRestriction):
        return _ShardedNeumannAIR(f, mesh, k_in)
    if isinstance(f, DIAMatrix):
        return _ShardedDIA(f, mesh, k_out)
    if isinstance(f, BlockDIAMatrix):
        return _ShardedBlockDIA(f, mesh, k_out)
    if isinstance(f, DenseOperator):
        return _ShardedDense(f, mesh, k_out)
    return _ShardedWindowed(f, mesh, k_out)


class ShardedOperator:
    """A level operator row-sharded over the mesh: takes this rank's block
    of a vector in ``in_layout`` and returns its block in ``out_layout``,
    applying its factors right to left (re-laid out between factors whose
    layouts differ)."""

    def __init__(self, op, mesh, in_layout, out_layout, k_mid):
        # the fine side is the longer one; a transfer's windowed factors
        # take row blocks that tile a rank's k_mid block of it
        fine = max(in_layout[1], out_layout[1])
        fs = _factors(op, _transfer_block(fine // k_mid))
        last = len(fs) - 1
        self.factors = tuple(
            _shard_factor(f, mesh, in_layout[0] if i == last else k_mid,
                          out_layout[0] if i == 0 else k_mid)
            for i, f in enumerate(fs))
        self.mesh = mesh
        self.in_layout, self.out_layout = in_layout, out_layout
        self.shape, self.nnz, self.dtype = op.shape, op.nnz, fs[0].dtype

    @property
    def n_pad(self):
        """The local length of an output block."""
        return self.out_layout[1] // self.out_layout[0]

    def matvec(self, x):
        if x.ndim != 1:
            raise _not_ported("a batched (n, K) apply of a sharded operator",
                              14)
        cur = self.in_layout
        for f in reversed(self.factors):
            x = f.apply(self.mesh.relayout(x, cur, f.in_layout))
            cur = f.out_layout
        return self.mesh.relayout(x, cur, self.out_layout)

    def residual(self, x, b):
        """b - A x on this rank's blocks: one pass where the operator is a
        single factor with a residual form on the operator's own layout
        (a block-DIA level: B1's halo mode ``RESID``), else composed."""
        (f, *rest) = self.factors
        if (not rest and hasattr(f, "residual") and x.ndim == 1
                and f.in_layout == self.in_layout
                and f.out_layout == self.out_layout):
            return f.residual(x, b)
        return b - self.matvec(x)

    def __matmul__(self, x):
        return self.matvec(x)


@dataclass(frozen=True)
class ShardedHierarchy(DeviceHierarchy):
    """A DeviceHierarchy whose levels hold this rank's blocks: each level's
    ``n_pad`` is the local block length, ``groups`` and ``n_pads`` give
    each level's layout, the coarse inverse is replicated."""

    mesh: Any = None
    groups: Tuple[int, ...] = ()
    n_pads: Tuple[int, ...] = ()

    def coarse_solve(self, bc):
        if bc.ndim != 1:
            raise _not_ported("a batched (n, K) sharded solve", 14)
        k = self.groups[-1]
        xc = torch.matmul(self.coarse_inv, self.mesh.gather(bc, k))
        return self.mesh.local(xc, k).contiguous()

    def stage(self, v, dtype):
        """This rank's level-0 block of a global vector (numpy or tensor,
        length n or n_pad)."""
        full = pad_vector(v, self.n_pads[0], dtype=dtype,
                          device=self.device)
        return self.mesh.local(full, self.groups[0]).contiguous()

    def gather(self, x):
        """The global level-0 vector (padded) from this rank's block."""
        return self.mesh.gather(x, self.groups[0])

    def reduce(self, s):
        """Per-rank partial sums of level-0 blocks summed over the shards
        (the Krylov dots' all_reduce)."""
        return self.reduce_level(s, 0)

    def reduce_level(self, s, i):
        """Per-rank partial sums of level ``i``'s blocks summed over that
        level's shards (AMLI's coarse dots)."""
        return self.mesh.sum_groups(s, self.groups[i])


# the roles of a smoother's arrays: one entry per row (a rank keeps its
# row block, the last axis), one entry per node (a block level's (nb_pad,
# ...) array: its node-row block, the first axis), or whole on every rank
# (a 0-d weight, a polynomial's coefficient stack)
_ROW, _NODE, _WHOLE = "row", "node", "whole"
# per smoother kind, the role of each array
_SMOOTHER_ROLES = {
    "identity": (),
    "jacobi": (_ROW,),
    "jacobi_dyn": (_ROW, _WHOLE),
    "richardson": (),
    "richardson_dyn": (_WHOLE,),
    "mcgs": (_ROW, _ROW),            # (dinv, colors)
    "poly": (),
    "poly_dyn": (_WHOLE,),
    "block_jacobi": (_NODE,),        # (Dinv,)
    "block_jacobi_dyn": (_NODE, _WHOLE),
    "block_mcgs": (_NODE, _NODE),    # (Dinv, colours per node)
}
# kinds whose sweep needs A^T of the sharded operator, or rolls vectors
# across shards
_SMOOTHER_UNSHARDED = {
    "jacobi_ne": "the Cimmino smoother 'jacobi_ne' (A^T of a sharded "
                 "operator)",
    "jacobi_nr": "the Cimmino smoother 'jacobi_nr' (A^T of a sharded "
                 "operator)",
    "win_schwarz": "windowed Schwarz (its windows roll across shards)",
}


def _shard_smoother(sm, mesh, groups):
    """This rank's copy of a smoother: its per-row and per-node arrays cut
    to the rank's block, by each kind's explicit roles.  The copy is a new
    smoother, so what it derives from its arrays (the per-colour and
    per-mask inverse diagonals) is built from the rank's blocks."""
    kind = sm.config[0]
    if kind in _SMOOTHER_UNSHARDED:
        raise _not_ported(f"a sharded {_SMOOTHER_UNSHARDED[kind]}", 14)
    if kind == "masked_jacobi":
        # dinv and one (n_pad,) mask a pass, as many as it has passes
        roles = (_ROW,) * len(sm.arrays)
    elif kind in _SMOOTHER_ROLES:
        roles = _SMOOTHER_ROLES[kind]
    else:
        raise ValueError(f"no sharding roles for smoother {kind!r}")

    def cut(role, a):
        if role == _ROW:
            return mesh.local(a, groups).contiguous()
        if role == _NODE:
            return _rows(a, mesh, groups)
        return a

    return DeviceSmoother(config=sm.config, arrays=tuple(
        cut(role, a) for role, a in zip(roles, sm.arrays, strict=True)))


def shard_hierarchy(hierarchy, mesh, axis="x", min_local_rows=256):
    """This rank's row blocks of a DeviceHierarchy, with POWER-OF-TWO
    COARSE-LEVEL AGGLOMERATION (the reference's): each level is sharded
    over the largest power-of-two group count that keeps >=
    ``min_local_rows`` rows per shard (``_level_groups``; a block level's
    count also divides its node rows), replicated within a group; only
    tiny levels replicate everywhere.  The coarse dense inverse is
    replicated.  Every level is wrapped (a level on one group is a ring of
    one on each rank), and the result carries no ``A64``, as the
    reference's, so ``precision="mixed"`` raises.

    Every hierarchy the port builds shards: host-built
    (``compile_hierarchy``; give it ``row_pad`` a multiple of 8 * world so
    level paddings divide evenly), unstructured (SA, RS, AIR with its
    Neumann restriction), and device-built (``device_sa_setup``,
    ``device_rs_setup``, ``device_air_setup``, ``device_sa_setup_block``,
    adaptive SA): their levels' DIA and block-DIA operators through K16
    and B1's halo mode, their transfers factor by factor, the masked and
    block smoothers by their rows and nodes.  The setup itself is not
    partitioned: it runs whole, then this shards its result.  To solve
    with a device-built hierarchy, keep its solver's grid encoding::

        ds = device_sa_setup(A, grid)
        StructuredDeviceSolver(shard_hierarchy(ds.hierarchy, mesh),
                               ds.grid, ds.grid_p, ds.setup_info)

    (``BlockStructuredDeviceSolver`` also takes ``ds.bs``).  What raises
    (ROADMAP.md Queue 1 item 14): a batched (n, K) solve, CGNR / CGNE (A^T
    of a sharded operator), the Cimmino smoothers and windowed Schwarz,
    and ``precision="mixed"`` (no ``A64``)."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has no axis {axis!r}")
    levels = hierarchy.levels
    n_pads = tuple(int(lvl.n_pad) for lvl in levels)
    if n_pads[-1] != hierarchy.nc_pad:
        raise ValueError("the coarsest level's n_pad must be nc_pad")
    ks = tuple(_node_groups(
        _level_groups(n, mesh.world, min_local_rows),
        n // lvl.A.bs if isinstance(lvl.A, BlockDIAMatrix) else n)
        for n, lvl in zip(n_pads, levels))
    new_levels = []
    for i, lvl in enumerate(levels):
        k = ks[i]
        fine = (k, n_pads[i])
        P = R = None
        if lvl.P is not None:
            coarse = (ks[i + 1], n_pads[i + 1])
            P = ShardedOperator(lvl.P, mesh, coarse, fine, k)
            R = ShardedOperator(lvl.R, mesh, fine, coarse, k)
        new_levels.append(DeviceLevel(
            A=ShardedOperator(lvl.A, mesh, fine, fine, k), P=P, R=R,
            pre=_shard_smoother(lvl.pre, mesh, k),
            post=_shard_smoother(lvl.post, mesh, k),
            n=lvl.n, n_pad=n_pads[i] // k))
    return ShardedHierarchy(
        levels=tuple(new_levels), coarse_inv=hierarchy.coarse_inv,
        nc=hierarchy.nc, nc_pad=n_pads[-1] // ks[-1], dtype=hierarchy.dtype,
        A64=None, mesh=mesh, groups=ks, n_pads=n_pads)


def _node_groups(k, nodes):
    """The largest power-of-two group count up to ``k`` that divides a
    level's ``nodes`` (its rows on a scalar level), so that no node's
    components straddle two ranks."""
    while k > 1 and nodes % k:
        k //= 2
    return k
