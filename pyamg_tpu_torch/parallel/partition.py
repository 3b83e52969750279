"""Row partitioning of device hierarchies over ranks (counterpart of
``pyamg_tpu/parallel/partition.py``).

JAX places each level's arrays row-sharded on a mesh and lets GSPMD
insert the collectives.  PyTorch has no partitioner, so here every rank
(SPMD, one process per rank) holds its own row block of each level's
operators and vectors, and the sharded operators carry their own
communication:

- a DIA operator applies through K16 (``halo_spmv.py``): ring halo
  exchange, interior rows while it runs, then the boundary rows;
- a dense or windowed operator gathers its input (``all_gather``) and
  applies its local rows (K6 for windowed);
- a windowed transpose (restriction stored as windowed(R^T)) applies its
  local fine rows into a full coarse partial through K7 and sums the
  partials over one replica per group (``all_reduce``);
- composed operators shard factor by factor, re-laying the vector out
  between factors whose row blocks differ;
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

from ..engine.hierarchy import DeviceHierarchy, DeviceLevel
from ..engine.relaxation import DeviceSmoother
from ..engine.unstructured_setup import ComposedWindowed
from ..sparse import (ComposedOperator, DenseOperator, DIAMatrix,
                      TransposedWindowed, WindowedELL)
from ..sparse.formats import fit, pad_vector
from ..sparse.window import windowed_rmatvec
from .dist_spmv import halo_width
from .halo_spmv import halo_spmv
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


def _factors(op):
    """An operator as its factors, applied right to left."""
    if isinstance(op, ComposedOperator):
        return [f for o in op.ops for f in _factors(o)]
    if isinstance(op, ComposedWindowed):
        return [f for o in op.factors for f in _factors(o)]
    if isinstance(op, TransposedWindowed):
        # (F0 F1 ...)^T = ... F1^T F0^T
        return [TransposedWindowed(f) if isinstance(f, WindowedELL) else f
                for f in reversed(_factors(op.base))]
    name = type(op).__name__
    if name == "NeumannAIRRestriction":
        raise _not_ported("sharding the AIR restriction", 13)
    if name == "ELLMatrix":
        raise _not_ported("sharding a gather-ELL operator", 1)
    if not isinstance(op, (DIAMatrix, DenseOperator, WindowedELL)):
        raise _not_ported(f"sharding a {name}", 14)
    return [op]


def _shard_factor(f, mesh, k_in, k_out):
    """One factor mapping a space on ``k_in`` groups to one on ``k_out``:
    a forward factor shards its rows (the output side), a transpose its
    base's rows (the input side)."""
    if isinstance(f, TransposedWindowed):
        if not isinstance(f.base, WindowedELL):
            raise _not_ported(f"sharding the transpose of a "
                              f"{type(f.base).__name__}", 14)
        return _ShardedTransposed(f.base, mesh, k_in)
    if isinstance(f, DIAMatrix):
        return _ShardedDIA(f, mesh, k_out)
    if isinstance(f, DenseOperator):
        return _ShardedDense(f, mesh, k_out)
    return _ShardedWindowed(f, mesh, k_out)


class ShardedOperator:
    """A level operator row-sharded over the mesh: takes this rank's block
    of a vector in ``in_layout`` and returns its block in ``out_layout``,
    applying its factors right to left (re-laid out between factors whose
    layouts differ)."""

    def __init__(self, op, mesh, in_layout, out_layout, k_mid):
        fs = _factors(op)
        last = len(fs) - 1
        self.factors = tuple(
            _shard_factor(f, mesh, in_layout[0] if i == last else k_mid,
                          out_layout[0] if i == 0 else k_mid)
            for i, f in enumerate(fs))
        self.mesh = mesh
        self.in_layout, self.out_layout = in_layout, out_layout
        self.shape, self.nnz, self.dtype = op.shape, op.nnz, op.dtype

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
        return self.mesh.sum_groups(s, self.groups[0])


def _shard_smoother(sm, mesh, groups):
    return DeviceSmoother(config=sm.config, arrays=tuple(
        mesh.local(a, groups).contiguous() if a.ndim == 1 else a
        for a in sm.arrays))


def shard_hierarchy(hierarchy, mesh, axis="x", min_local_rows=256):
    """This rank's row blocks of a DeviceHierarchy, with POWER-OF-TWO
    COARSE-LEVEL AGGLOMERATION (the reference's): each level is sharded
    over the largest power-of-two group count that keeps >=
    ``min_local_rows`` rows per shard (``_level_groups``), replicated
    within a group; only tiny levels replicate everywhere.  The coarse
    dense inverse is replicated.  Every level is wrapped (a level on one
    group is a ring of one on each rank), and the result carries no
    ``A64``, as the reference's, so ``precision="mixed"`` raises.

    Compile the hierarchy with ``row_pad`` a multiple of 8 * world so
    level paddings divide evenly.  Host-built (``compile_hierarchy``) and
    unstructured hierarchies shard; the device-built grid hierarchy's
    structured transfers raise (ROADMAP.md Queue 1 item 14)."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has no axis {axis!r}")
    levels = hierarchy.levels
    n_pads = tuple(int(lvl.n_pad) for lvl in levels)
    if n_pads[-1] != hierarchy.nc_pad:
        raise ValueError("the coarsest level's n_pad must be nc_pad")
    ks = tuple(_level_groups(n, mesh.world, min_local_rows) for n in n_pads)
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
