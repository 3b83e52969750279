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

Every operator applies to a rank's block of one vector or of a K-major
(K, n_local) lane stack (a batched solve): K16's and B1's halo modes take
every lane in one launch and one exchange a side, the windowed factors
K12 / K13, the dense ones a matmul.  A^T (``ShardedOperator.rmatvec``,
CGNR / CGNE and the Cimmino sweeps) applies each factor's transpose: a
DIA or block-DIA factor's transposed diagonals, built on the device at
its first transpose from its own and its neighbours' diagonals (one
exchange), through K16 / B1's halo mode; a windowed factor's through K7 /
K13 into a partial summed over the groups; a windowed transpose's through
K6 / K12 on the local rows.  Windowed Schwarz keeps the windows that
start in a rank's rows and passes a right halo of the residual in and
each window chunk's spill out through the ring (:func:`_schwarz_update`).

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
from functools import cached_property
from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..engine.device_setup import _transfer_block
from ..engine.hierarchy import DeviceHierarchy, DeviceLevel
from ..engine.relaxation import DeviceSmoother, schwarz_corrections
from ..engine.unstructured_classical import (NeumannAIRRestriction,
                                            neumann_residual)
from ..engine.unstructured_setup import ComposedWindowed
from ..sparse import (ComposedOperator, DenseOperator, DIAMatrix,
                      TransposedWindowed, WindowedELL)
from ..sparse.block_dia import BlockDIAMatrix
from ..sparse.formats import fit, pad_vector
from .dist_spmv import halo_width, ring_send, start_halo_exchange
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


class _HaloFactor:
    """A square factor row-sharded over ``groups`` whose applies exchange
    halos: this rank's diagonals (``data``, its last axes the rank's rows
    or node rows), their offsets, the halo width and the layout.  Its
    transpose (``rapply``) applies the transposed diagonals, built once
    on the device at the first transpose (``transposed``)."""

    def __init__(self, data, offsets, halo, mesh, groups, n_pad,
                 offsets_t=None):
        self.data, self.offsets = data, offsets
        self.offsets_t = offsets_t if offsets_t is not None else torch.tensor(
            offsets, dtype=torch.int32, device=data.device)
        self.halo, self.mesh, self.groups = halo, mesh, groups
        self.in_layout = self.out_layout = (groups, n_pad)

    def _extended(self, hw):
        """The diagonals with their neighbours' ``hw`` values of each on
        either side, (nd, hw + local + hw) as a flat row a diagonal: one
        ring exchange of every diagonal at once (a ring of one wraps onto
        its own block)."""
        nd = self.data.shape[0]
        left, right, reqs = start_halo_exchange(
            self.data.reshape(nd, -1), hw, self.mesh, self.groups)
        for req in reqs:
            req.wait()
        return torch.cat([left, self.data.reshape(nd, -1), right], dim=-1)

    def rapply(self, y):
        return self.transposed.apply(y)


class _ShardedDIA(_HaloFactor):
    """A square DIA factor row-sharded over ``groups`` (K16)."""

    @classmethod
    def of(cls, A, mesh, groups):
        halo = halo_width(A)
        if A.n_pad % groups or halo > A.n_pad // groups:
            groups = 1                     # too few rows: replicate
        return cls(mesh.local(A.data, groups).contiguous(), A.offsets, halo,
                   mesh, groups, A.n_pad, A.offsets_t)

    def apply(self, x):
        return halo_spmv(self.data, self.offsets, self.offsets_t, x,
                         self.halo, self.mesh, self.groups)

    @cached_property
    def transposed(self):
        """A^T's rows on this rank, sharded as A: the diagonal of offset -o
        holds data[o] shifted by o (row i of A^T at offset -o is A's entry
        (i - o, i)), its first and last o entries from the neighbours'
        blocks.  The diagonals keep A's order, so a row's products are
        summed in the order of ``DIAMatrix.rmatvec``'s rolls; a wrapped
        entry is a stored zero, as the rolls' are."""
        h, nl = self.halo, self.data.shape[-1]
        ext = self._extended(h)
        return _ShardedDIA(torch.stack([ext[d, h - o:h - o + nl]
                                        for d, o in enumerate(self.offsets)]),
                           tuple(-o for o in self.offsets), h, self.mesh,
                           self.groups, self.in_layout[1])


class _ShardedBlockDIA(_HaloFactor):
    """A square block-DIA factor row-sharded by node rows over ``groups``
    (B1's halo mode, the halo in whole nodes)."""

    @classmethod
    def of(cls, A, mesh, groups):
        halo = max(A.halo, 1)
        nb = A.nb_pad
        if nb % groups or halo > nb // groups:
            groups = 1                     # too few nodes: replicate
        nl, sh = nb // groups, mesh.shard(groups)
        return cls(A.data[:, sh * nl:(sh + 1) * nl].contiguous(), A.offsets,
                   halo, mesh, groups, A.n_pad, A.offsets_t)

    def apply(self, x):
        return block_halo_spmv(self.data, self.offsets, self.offsets_t, x,
                               self.halo, self.mesh, self.groups)

    def residual(self, x, b):
        """b - A x in one pass (B1's halo mode ``RESID``)."""
        return block_halo_spmv(self.data, self.offsets, self.offsets_t, x,
                               self.halo, self.mesh, self.groups, b=b)

    @cached_property
    def transposed(self):
        """A^T's node rows on this rank, sharded as A and built as
        ``BlockDIAMatrix.T`` is on the whole operator: offsets negated and
        ascending, blocks transposed, block row i at offset p A's block (i
        + p, i), the rows past either end from the neighbours' blocks."""
        nd, nl, bs, _ = self.data.shape
        h = self.halo
        ext = self._extended(h * bs * bs).reshape(nd, nl + 2 * h, bs, bs)
        lookup = {o: d for d, o in enumerate(self.offsets)}
        offsets = tuple(sorted(-o for o in self.offsets))
        data_t = torch.stack([ext[lookup[-p], h + p:h + p + nl]
                              for p in offsets]).transpose(-1, -2)
        return _ShardedBlockDIA(data_t.contiguous(), offsets, h, self.mesh,
                                self.groups, self.in_layout[1])


class _ShardedDense:
    """A dense factor: input gathered, local rows applied; its transpose
    the local rows' partial over the columns, summed over the groups."""

    def __init__(self, D, mesh, groups):
        rows = D.data.shape[0]
        groups = groups if rows % groups == 0 else 1
        self.data = _rows(D.data, mesh, groups)
        self.mesh, self.groups = mesh, groups
        self.in_layout = (1, D.data.shape[1])
        self.out_layout = (groups, rows)

    def apply(self, x):
        # DenseOperator.matvec's products, on the local rows
        if x.ndim == 2:
            return torch.matmul(x, self.data.T)
        return torch.matmul(self.data, x)

    def rapply(self, y):
        return self.mesh.sum_groups(torch.matmul(y, self.data), self.groups)


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
    """A windowed forward factor: input gathered, local row blocks (K6,
    K12 on lanes); its transpose the local rows into a full partial (K7,
    K13 on lanes) summed over the groups."""

    def __init__(self, W, mesh, groups):
        self._init(*_local_windowed(W, mesh, groups), mesh)

    @classmethod
    def of_local(cls, local, mesh, groups):
        """The factor from this rank's row blocks (``local``, a
        WindowedELL of the whole operator's w2 and chunk count)."""
        self = cls.__new__(cls)
        self._init(local, groups, mesh)
        return self

    def _init(self, local, groups, mesh):
        self.local, self.mesh, self.groups = local, mesh, groups
        self.in_layout = (1, local.m_chunks * local.w2)
        self.out_layout = (groups, local.n_pad * groups)

    def apply(self, x):
        return self.local.matvec(x)

    def rapply(self, y):
        return self.mesh.sum_groups(self.local.rmatvec(y), self.groups)


class _ShardedTransposed:
    """A windowed transpose: the local fine rows into a full coarse
    partial (K7, K13 on lanes), summed over one replica per group; its
    transpose the local rows of the base operator (K6, K12)."""

    def __init__(self, W, mesh, groups):
        self._init(*_local_windowed(W, mesh, groups), mesh)

    @classmethod
    def of_local(cls, local, mesh, groups):
        """The factor from this rank's row blocks of the base operator."""
        self = cls.__new__(cls)
        self._init(local, groups, mesh)
        return self

    def _init(self, local, groups, mesh):
        self.local, self.mesh, self.groups = local, mesh, groups
        self.in_layout = (groups, local.n_pad * groups)
        self.out_layout = (1, local.m_chunks * local.w2)

    def apply(self, r):
        return self.mesh.sum_groups(self.local.rmatvec(r), self.groups)

    def rapply(self, y):
        return self.local.matvec(y)


class _ShardedNeumannAIR:
    """The Neumann AIR restriction R r = Tinj^T (r - A z), z ``degree``
    F-masked Jacobi sweeps on A_ff z = r_F, on this rank's fine rows: A's
    and Tinj's row blocks and dinv_f's rows kept, each A z through K6
    (K12 on lanes) on the gathered z, Tinj^T through K7 (K13) into a
    coarse partial summed over the groups (the reference's branch,
    ``pyamg_tpu/parallel/partition.py:87-93``, shards the same three by
    rows)."""

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
        return self.mesh.sum_groups(self.Tinj.rmatvec(r), self.groups)

    def rapply(self, y):
        raise TypeError("no sharded transpose of the Neumann AIR "
                        "restriction (nothing applies R^T)")


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
        return _ShardedDIA.of(f, mesh, k_out)
    if isinstance(f, BlockDIAMatrix):
        return _ShardedBlockDIA.of(f, mesh, k_out)
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
        self._init([_shard_factor(f, mesh, in_layout[0] if i == last
                                  else k_mid,
                                  out_layout[0] if i == 0 else k_mid)
                    for i, f in enumerate(fs)], mesh, in_layout, out_layout,
                   op.shape, op.nnz, fs[0].dtype)

    @classmethod
    def of_factors(cls, factors, mesh, in_layout, out_layout, shape, nnz,
                   dtype):
        """The operator from this rank's sharded factors (applied right to
        left), built from its own rows (the partitioned setup's)."""
        self = cls.__new__(cls)
        self._init(factors, mesh, in_layout, out_layout, shape, nnz, dtype)
        return self

    def _init(self, factors, mesh, in_layout, out_layout, shape, nnz, dtype):
        self.factors = tuple(factors)
        self.mesh = mesh
        self.in_layout, self.out_layout = in_layout, out_layout
        self.shape, self.nnz, self.dtype = shape, nnz, dtype

    @property
    def n_pad(self):
        """The local length of an output block."""
        return self.out_layout[1] // self.out_layout[0]

    def matvec(self, x):
        """This rank's block of A x from its block of x: a vector, or a
        K-major (K, n_local) lane stack (every factor applies lane by
        lane, its communication one message for all lanes)."""
        cur = self.in_layout
        for f in reversed(self.factors):
            x = f.apply(self.mesh.relayout(x, cur, f.in_layout))
            cur = f.out_layout
        return self.mesh.relayout(x, cur, self.out_layout)

    def rmatvec(self, y):
        """This rank's block of A^T y from its block of y (in
        ``out_layout``; the result in ``in_layout``), a vector or a lane
        stack: each factor's transpose, left to right.  A DIA or block-DIA
        factor builds its transposed diagonals at its first transpose; an
        operator never transposed builds nothing."""
        cur = self.out_layout
        for f in self.factors:
            y = f.rapply(self.mesh.relayout(y, cur, f.out_layout))
            cur = f.in_layout
        return self.mesh.relayout(y, cur, self.in_layout)

    def residual(self, x, b):
        """b - A x on this rank's blocks: one pass where the operator is a
        single factor with a residual form on the operator's own layout
        (a block-DIA level: B1's halo mode ``RESID``), else composed."""
        (f, *rest) = self.factors
        if (not rest and hasattr(f, "residual")
                and f.in_layout == self.in_layout
                and f.out_layout == self.out_layout):
            return f.residual(x, b)
        return b - self.matvec(x)

    def schwarz_update(self, inv_blocks, r, window, stride):
        """Windowed Schwarz's summed window corrections on this rank's
        block of the residual r (a vector or a lane stack), the windows
        being those that start in the block (:func:`_schwarz_update`)."""
        return _schwarz_update(r, inv_blocks, window, stride, self.mesh,
                               self.in_layout[0])

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
        """The replicated coarse inverse on the gathered coarse vector (or
        lane stack), this rank's block kept."""
        k = self.groups[-1]
        xc = super().coarse_solve(self.mesh.gather(bc, k))
        return self.mesh.local(xc, k).contiguous()

    def stage(self, v, dtype):
        """This rank's level-0 block of a global vector (numpy or tensor,
        length n or n_pad), or of an (n, K) column stack as a K-major (K,
        n_local) lane stack."""
        if np.ndim(v) == 2:
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            full = fit(v.to(dtype=dtype, device=self.device).T,
                       self.n_pads[0])
        else:
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
# ...) array: its node-row block, the first axis), one entry per window
# (windowed Schwarz's (n_pad / stride, w, w) blocks: the windows that
# start in the rank's rows), or whole on every rank (a 0-d weight, a
# polynomial's coefficient stack)
_ROW, _NODE, _WINDOW, _WHOLE = "row", "node", "window", "whole"
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
    "jacobi_ne": (_ROW,),            # 1 / ||A_i,:||^2
    "jacobi_nr": (_ROW,),            # 1 / ||A_:,j||^2 (A square)
    "win_schwarz": (_WINDOW,),       # (inv_blocks,)
    "block_jacobi": (_NODE,),        # (Dinv,)
    "block_jacobi_dyn": (_NODE, _WHOLE),
    "block_mcgs": (_NODE, _NODE),    # (Dinv, colours per node)
}


def _shard_smoother(sm, mesh, groups):
    """This rank's copy of a smoother: its per-row, per-node and
    per-window arrays cut to the rank's block, by each kind's explicit
    roles.  The copy is a new smoother, so what it derives from its arrays
    (the per-colour and per-mask inverse diagonals) is built from the
    rank's blocks."""
    kind = sm.config[0]
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
        if role == _WINDOW:
            _check_windows(a.shape[0], sm.config[1], sm.config[2], groups)
            return _rows(a, mesh, groups)
        return a

    return DeviceSmoother(config=sm.config, arrays=tuple(
        cut(role, a) for role, a in zip(roles, sm.arrays, strict=True)))


def _check_windows(nwin, window, stride, groups):
    """Raise unless windowed Schwarz's ``nwin`` windows (one every
    ``stride`` rows) split over ``groups`` blocks, each block holding
    whole windows' starts and, on more than one block, at least the
    ``window - stride`` rows a window reaches into the next block (a
    ring of one wraps its windows onto its rows as often as they reach
    past them)."""
    n_pad = nwin * stride
    if nwin % groups:
        raise ValueError(f"windowed Schwarz: {n_pad} rows in {groups} "
                         f"blocks of {n_pad / groups:g}, not a multiple of "
                         f"the stride {stride}")
    n_local = n_pad // groups
    if groups > 1 and window - stride > n_local:
        raise ValueError(f"windowed Schwarz: window {window} (stride "
                         f"{stride}) overruns a block of {n_local} rows")


def _schwarz_update(r, inv_blocks, window, stride, mesh, groups):
    """Windowed Schwarz's update on this rank's block of r (a vector or a
    K-major lane stack), on a layout of ``groups`` shard groups:
    :func:`~pyamg_tpu_torch.engine.relaxation.schwarz_corrections` over
    the windows that start in the block, the right halo of r and the
    chunks' spills crossing the ring (``ring_send``), which wraps where
    the unsharded windows wrap.  A block that a window overruns raises
    ValueError naming the sizes, before any exchange."""
    if groups > 1 and (inv_blocks.shape[0] * stride != r.shape[-1]
                       or window - stride > r.shape[-1]):
        _check_windows(inv_blocks.shape[0] * groups, window, stride, groups)
    return schwarz_corrections(
        inv_blocks, r, window, stride,
        lambda t, to_right: ring_send(t, mesh, groups, to_right))


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
    block smoothers by their rows and nodes.  This shards a hierarchy
    built whole; the structured SA, classical RS and block setups also
    run partitioned (``device_sa_setup(..., mesh=mesh)``,
    ``device_rs_setup(..., mesh=mesh)``, ``device_sa_setup_block(...,
    mesh=mesh)``: each rank builds only its rows of every large level,
    and gets what this gives).  To solve with a
    device-built hierarchy, keep its solver's grid encoding::

        ds = device_sa_setup(A, grid)
        StructuredDeviceSolver(shard_hierarchy(ds.hierarchy, mesh),
                               ds.grid, ds.grid_p, ds.setup_info)

    (``BlockStructuredDeviceSolver`` also takes ``ds.bs``).  A sharded
    hierarchy runs batched (n, K) solves (K-major lane stacks; never the
    interleaved route, as the reference), CGNR / CGNE (A^T of each
    sharded level), the Cimmino smoothers (``jacobi_ne``, ``jacobi_nr``)
    and windowed Schwarz (a level whose blocks cannot hold whole windows
    raises ValueError naming the sizes).  What raises: ``precision=
    "mixed"`` (no ``A64``; the reference cannot run it either), and, on a
    grid solver, a tensor ``b``."""
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
    new_levels = [_shard_level(lvl, mesh, (ks[i], n_pads[i]),
                               (ks[i + 1], n_pads[i + 1])
                               if i + 1 < len(levels) else None)
                  for i, lvl in enumerate(levels)]
    return ShardedHierarchy(
        levels=tuple(new_levels), coarse_inv=hierarchy.coarse_inv,
        nc=hierarchy.nc, nc_pad=n_pads[-1] // ks[-1], dtype=hierarchy.dtype,
        A64=None, mesh=mesh, groups=ks, n_pads=n_pads)


def _shard_level(lvl, mesh, fine, coarse):
    """This rank's copy of one level whose rows lie on the layout
    ``fine`` (its transfers' coarse side on ``coarse``)."""
    k = fine[0]
    P = R = None
    if lvl.P is not None:
        P = ShardedOperator(lvl.P, mesh, coarse, fine, k)
        R = ShardedOperator(lvl.R, mesh, fine, coarse, k)
    return DeviceLevel(
        A=ShardedOperator(lvl.A, mesh, fine, fine, k), P=P, R=R,
        pre=_shard_smoother(lvl.pre, mesh, k),
        post=_shard_smoother(lvl.post, mesh, k), n=lvl.n,
        n_pad=fine[1] // k)


def _node_groups(k, nodes):
    """The largest power-of-two group count up to ``k`` that divides a
    level's ``nodes`` (its rows on a scalar level), so that no node's
    components straddle two ranks."""
    while k > 1 and nodes % k:
        k //= 2
    return k
