"""K16: the row-sharded DIA SpMV with the interior computed while the halos
travel (counterpart of ``pyamg_tpu/parallel/pallas_halo.py::
make_pallas_halo_spmv``; kernel ``csrc/halo.cu``).

The TPU kernel copies x into an extended VMEM buffer, starts remote DMAs
of both boundary slices to the ring neighbours' halo slots, computes the
interior rows while they fly and the boundary rows after.  Here the
remote DMA is a ``torch.distributed`` send/receive pair per direction
(:func:`~pyamg_tpu_torch.parallel.dist_spmv.start_halo_exchange`: NCCL on
the card, gloo on the CPU), and one CUDA kernel reads its three sources
(left halo, local x, right halo) in place instead of an extended copy.
Its rows go in row blocks, planned on the host by :func:`halo_plan`: the
interior blocks read x only, the boundary blocks pick the source per
term.  With an exchange:

1. start the halo exchange;
2. launch the interior blocks on the current stream while it runs;
3. wait for it (for NCCL, the current stream waits on the exchange);
4. launch the boundary blocks of both ends in one launch.

A ring of one exchanges nothing (its halos are x's own tail and head) and
takes one launch over every block.

A K-major (K, n_local) lane stack (a batched solve) takes K16's lane
mode: one exchange a side sends every lane's halo as one contiguous (K,
halo) buffer, and each launch covers every lane, the CTAs walking K8's
super tiles of row blocks with the lanes of a tile one after another; in
a ring of one it gives K8's bits.

Entry points:

- :func:`dia_halo_rows`: one launch over a part of the plan's blocks
  (``"all"``, ``"interior"`` or ``"boundary"``), the kernel wrapper
  (counted as ``dia_halo_spmv.<dtype>``, on lanes as
  ``dia_halo_spmm.<dtype>``);
- :func:`halo_spmv`: one rank's block, what the sharded hierarchy's DIA
  operators apply; a ring of one (a world of one, or a level on one group)
  takes its halos from x itself, as the reference's single-device ring
  does, and gives K1's result;
- :func:`halo_spmv_shards`: P row blocks of one operator in one process,
  each halo copied from its neighbouring block on a side stream under
  events while the main stream runs every interior, then every boundary;
  for the card check, and for multi-shard use in one process (not
  exported: no solver path calls it).

On CPU tensors :func:`dia_halo_rows` runs its plain twin
(:func:`~pyamg_tpu_torch.parallel.dist_spmv.dia_halo_rows_ref`, the
rolled sum over the extended vector, on the plan's rows) and the exchange
is gloo's; on CUDA tensors it launches the kernel or raises.
The TPU kernel is float32 only; this one takes float32 and float64.

B1's halo mode (``csrc/block_dia.cu::block_dia_halo_kernel``) is the same
scheme for a row-sharded :class:`~pyamg_tpu_torch.sparse.block_dia.
BlockDIAMatrix`, the halo in whole nodes (``bs`` entries each), rows in
blocks of 256 nodes (:func:`block_halo_plan`):

- :func:`block_dia_halo_rows`: one launch over a part of the plan's
  blocks, ``PLAIN`` (y = A x) or ``RESID`` (y = b - A x), counted as
  ``block_dia_halo.<dtype>`` (on lanes, at most 16 a launch in B1's lane
  tiles, as ``block_dia_halo_spmm.<dtype>``); its twin on CPU tensors is
  :func:`~pyamg_tpu_torch.parallel.dist_spmv.block_dia_halo_rows_ref`;
- :func:`block_halo_spmv`: one rank's block, in K16's order;
- :func:`block_halo_spmv_shards`: P node-row blocks in one process, as
  :func:`halo_spmv_shards` (the card check's and the tests' form).

The reference has no kernel here: its sharded block levels are plain
``jnp`` that GSPMD partitions.
"""

from __future__ import annotations

import ctypes
import functools
from contextlib import nullcontext
from dataclasses import dataclass

import torch

from .. import _build
from ..sparse.block_dia import _PLAIN, _RESID, BlockDIAMatrix
from ..sparse.dia import DIAMatrix, _aligned
from .dist_spmv import (block_dia_halo_rows_ref, dia_halo_rows_ref,
                        halo_width, start_halo_exchange)

__all__ = ["HaloPlan", "halo_plan", "dia_halo_rows", "halo_spmv",
           "block_halo_plan", "block_dia_halo_rows", "block_halo_spmv"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# threads per CTA of csrc/halo.cu::halo_spmv_kernel (kThreads)
_THREADS = 256
_PARTS = ("all", "interior", "boundary")


@dataclass(frozen=True)
class HaloPlan:
    """K16's row blocks on a block of ``n_local`` rows: ``row_blocks``
    blocks of ``rows`` rows (``vec`` a thread); the blocks [lo, hi) are
    interior: every neighbour of their rows lies in [0, n_local), with vec
    - 1 rows to spare on either side (the aligned 16-byte runs a thread of
    4 rows loads around a neighbour run)."""

    vec: int
    rows: int
    row_blocks: int
    lo: int
    hi: int
    n_local: int

    def blocks(self, part):
        """The block ranges of ``part``: every block ("all", a ring of
        one's single launch), the interior, or the boundary blocks of both
        ends (one launch after the exchange)."""
        if part == "all":
            return ((0, self.row_blocks),)
        if part == "interior":
            return ((self.lo, self.hi),)
        if part == "boundary":
            return ((0, self.lo), (self.hi, self.row_blocks))
        raise ValueError(f"part: expected one of {_PARTS}, got {part!r}")

    def row_ranges(self, part):
        """The row ranges of ``part``'s blocks."""
        return tuple((b0 * self.rows, min(b1 * self.rows, self.n_local))
                     for b0, b1 in self.blocks(part))


@functools.lru_cache(maxsize=256)
def halo_plan(offsets, n_local, dtype, aligned=True):
    """K16's row blocks for ``offsets`` on a block of ``n_local`` rows of
    ``dtype`` (``aligned``: data, its row stride, x and y 16-byte
    aligned).  A thread takes 4 float32 rows in 16-byte loads where
    n_local is a multiple of 4 and the operands are aligned, else 1 row."""
    vec = 4 if dtype == torch.float32 and aligned and n_local % 4 == 0 \
        else 1
    return _row_block_plan(offsets, n_local, vec)


@functools.lru_cache(maxsize=256)
def block_halo_plan(offsets, nb_local):
    """B1's halo mode's row blocks for block ``offsets`` on a block of
    ``nb_local`` node rows: 256 nodes a block (one thread a node), the
    interior those whose every neighbour lies in the block."""
    return _row_block_plan(offsets, nb_local, 1)


def _row_block_plan(offsets, n_local, vec):
    rows = _THREADS * vec
    row_blocks = -(-n_local // rows)
    below = max(0, -min(offsets)) + vec - 1
    above = max(0, max(offsets)) + vec - 1
    lo = min(-(-below // rows), row_blocks)
    hi = min(max(lo, (n_local - above) // rows), row_blocks)
    return HaloPlan(vec=vec, rows=rows, row_blocks=row_blocks, lo=lo, hi=hi,
                    n_local=n_local)


@functools.lru_cache(maxsize=256)
def _offsets_c(offsets):
    return (ctypes.c_int * len(offsets))(*offsets)


def _plan_for(data, offsets, x, y):
    aligned = (data.stride(0) % 4 == 0 and _aligned(data, x, y)
               and (x.ndim == 1 or x.stride(0) % 4 == 0))
    return halo_plan(tuple(offsets), x.shape[-1], data.dtype, aligned)


def _check_operands(dtype, n, lanes, halo_n, **operands):
    """Raise unless x, y (and b) are ``dtype`` vectors of length ``n`` or,
    for ``lanes``, K-major (lanes, n) stacks whose lanes are contiguous and
    lie the same distance apart (a row block of a wider stack is fine),
    and the halos ``left`` / ``right`` are ``halo_n`` entries a lane with
    contiguous lanes."""
    strides = set()
    for name, v in operands.items():
        m = halo_n if name in ("left", "right") else n
        want = (m,) if lanes is None else (lanes, m)
        if tuple(v.shape) != want or v.stride(-1) != 1:
            raise ValueError(f"{name}: expected shape {want} with contiguous "
                             f"lanes, got {tuple(v.shape)}")
        if v.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {v.dtype}")
        if lanes is not None and m == n and name not in ("left", "right"):
            strides.add(v.stride(0))
    if len(strides) > 1:
        raise ValueError("x, y and b: their lanes must lie the same "
                         "distance apart")


def _lane_stride(v):
    """Values between a stack's lanes (unused for one vector)."""
    return v.stride(0) if v.ndim == 2 else v.shape[0]


def dia_halo_rows(data, offsets, offsets_t, left, x, right, halo, part, y):
    """One K16 launch over ``part`` (``"all"``, ``"interior"`` or
    ``"boundary"``) of the row blocks of :func:`halo_plan` on a block:
    ``data`` (nd, n_local), rows contiguous (a column slice of a wider
    array is fine), ``offsets`` (ascending, |offset| <= halo) and
    ``offsets_t`` their int32 tensor beside data, ``left`` / ``right`` the
    halos (``halo`` entries each), ``x`` and ``y`` (n_local,).  K-major
    (K, n_local) stacks ``x`` and ``y`` with (K, halo) halos take the
    K-lane mode, every lane in the one launch (counted as
    ``dia_halo_spmm.<dtype>``; one vector as ``dia_halo_spmv.<dtype>``).
    Writes y's rows in place; raises on operands the kernel does not
    take."""
    plan = _plan_for(data, offsets, x, y)
    if _build.on_cpu(data, left, x, right, y):
        return dia_halo_rows_ref(data, offsets, left, x, right, halo,
                                 plan.row_ranges(part), y)
    blocks = [r for r in plan.blocks(part) if r[1] > r[0]]
    if not blocks:
        return y
    (a0, a1), (b0, b1) = blocks[0], blocks[-1]
    if len(blocks) == 1:
        b0 = b1 = a1
    n_local = x.shape[-1]
    lanes = x.shape[0] if x.ndim == 2 else None
    dtype = data.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"K16 takes float32 or float64, not {dtype}")
    if max(abs(o) for o in offsets) > halo:
        raise ValueError(f"an offset exceeds the halo {halo}")
    if data.ndim != 2 or data.shape[1] != n_local or data.stride(1) != 1:
        raise ValueError("data: expected (nd, n_local) with contiguous rows")
    if offsets_t.dtype != torch.int32 or offsets_t.numel() != len(offsets):
        raise ValueError("offsets_t: expected the int32 offsets")
    _check_operands(dtype, n_local, lanes, halo, x=x, y=y, left=left,
                    right=right)
    fn_name = f"pyamg_halo_spmv_{_SUFFIX[dtype]}"
    err = getattr(_build.library(), fn_name)(
        data.data_ptr(), data.stride(0), _offsets_c(tuple(offsets)),
        offsets_t.data_ptr(), len(offsets), n_local, halo, left.data_ptr(),
        _lane_stride(left), x.data_ptr(), _lane_stride(x), right.data_ptr(),
        _lane_stride(right), lanes or 1, plan.vec, plan.lo, plan.hi, a0, a1,
        b0, b1, y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(fn_name, err)
    kernel = "dia_halo_spmv" if lanes is None else "dia_halo_spmm"
    _build.count_launch(f"{kernel}.{_build.dtype_name(dtype)}")
    return y


def _ring_apply(x, hw, mesh, groups, rows):
    """This rank's block of an operator row-sharded over ``groups`` shard
    groups of ``mesh``, in K16's order: the exchange of ``hw`` entries a
    side started, ``rows(left, right, "interior", y)`` launched while it
    runs, then ``rows(left, right, "boundary", y)``; a ring of one
    exchanges nothing, reads its halos from x and takes one launch
    (``"all"``)."""
    y = torch.empty_like(x)
    left, right, reqs = start_halo_exchange(x, hw, mesh, groups)
    if not reqs:
        return rows(left, right, "all", y)
    rows(left, right, "interior", y)
    for req in reqs:
        req.wait()
    return rows(left, right, "boundary", y)


def halo_spmv(data, offsets, offsets_t, x, halo, mesh, groups):
    """This rank's block of A @ x for a DIA A row-sharded over ``groups``
    shard groups of ``mesh`` (:func:`_ring_apply`'s order); ``x`` a vector
    or a K-major (K, n_local) lane stack (one exchange a side for every
    lane, one launch a part)."""
    return _ring_apply(x, halo, mesh, groups, lambda left, right, part, y:
                       dia_halo_rows(data, offsets, offsets_t, left, x,
                                     right, halo, part, y))


def block_dia_halo_rows(data, offsets, offsets_t, left, x, right, halo,
                        part, y, b=None):
    """One launch of B1's halo mode over ``part`` (``"all"``,
    ``"interior"`` or ``"boundary"``) of :func:`block_halo_plan`'s row
    blocks: ``data`` (nd, nb_local, bs, bs), each diagonal's blocks
    contiguous (a node-column slice of a wider operator's data is fine),
    ``offsets`` (ascending, in nodes, |offset| <= halo) and ``offsets_t``
    their int32 tensor beside data, ``left`` / ``right`` the halos
    (``halo`` nodes, ``halo * bs`` entries each), ``x`` and ``y``
    (nb_local * bs,); ``b`` given: y = b - A x (``RESID``), else y = A x
    (``PLAIN``).  K-major (K, nb_local * bs) stacks x, y and b with (K,
    halo * bs) halos take B1's lane order (a thread serves every lane of
    its node, each block read once for a lane tile), at most MAX_LANES
    lanes a launch as B1 (counted as ``block_dia_halo_spmm.<dtype>``; one
    vector as ``block_dia_halo.<dtype>``).  Writes y's rows in place;
    raises on operands the kernel does not take."""
    nd, nb, bs = data.shape[0], data.shape[1], data.shape[-1]
    plan = block_halo_plan(tuple(offsets), nb)
    others = (b,) if b is not None else ()
    if _build.on_cpu(data, left, x, right, y, *others):
        return block_dia_halo_rows_ref(data, offsets, left, x, right, halo,
                                       plan.row_ranges(part), y, b)
    blocks = [r for r in plan.blocks(part) if r[1] > r[0]]
    if not blocks:
        return y
    (a0, a1), (b0, b1) = blocks[0], blocks[-1]
    if len(blocks) == 1:
        b0 = b1 = a1
    dtype = data.dtype
    lanes = x.shape[0] if x.ndim == 2 else None
    if dtype not in _SUFFIX:
        raise TypeError(f"B1 takes float32 or float64, not {dtype}")
    if max(abs(o) for o in offsets) > halo or halo > nb:
        raise ValueError(f"halo {halo}: must cover every offset and fit "
                         f"the block of {nb} nodes")
    if (data.ndim != 4 or data.shape[2] != bs or data.stride(3) != 1
            or data.stride(2) != bs or data.stride(1) != bs * bs):
        raise ValueError("data: expected (nd, nb, bs, bs) with contiguous "
                         "node blocks")
    if offsets_t.dtype != torch.int32 or offsets_t.numel() != nd:
        raise ValueError("offsets_t: expected the int32 offsets")
    _check_operands(dtype, nb * bs, lanes, halo * bs, x=x, y=y, left=left,
                    right=right, **({} if b is None else {"b": b}))
    fn_name = f"pyamg_block_dia_halo_{_SUFFIX[dtype]}"
    fn = getattr(_build.library(), fn_name)
    kernel = "block_dia_halo" if lanes is None else "block_dia_halo_spmm"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for k0, k1 in _build.lane_chunks(lanes or 1):
        def lane(v):
            return v if lanes is None else v[k0:k1]
        err = fn(data.data_ptr(), data.stride(0), offsets_t.data_ptr(), nd,
                 nb, bs, halo, lane(left).data_ptr(), _lane_stride(left),
                 lane(x).data_ptr(), _lane_stride(x), lane(right).data_ptr(),
                 _lane_stride(right),
                 None if b is None else lane(b).data_ptr(),
                 lane(y).data_ptr(), k1 - k0, plan.lo, plan.hi, a0, a1, b0,
                 b1, _PLAIN if b is None else _RESID, stream)
        _build.check(fn_name, err)
        _build.count_launch(f"{kernel}.{_build.dtype_name(dtype)}")
    return y


def block_halo_spmv(data, offsets, offsets_t, x, halo, mesh, groups, b=None):
    """This rank's block of A @ x (or b - A @ x) for a BlockDIAMatrix A
    row-sharded by node rows over ``groups`` shard groups of ``mesh``,
    ``halo`` nodes each side, with B1's halo mode in :func:`_ring_apply`'s
    order."""
    return _ring_apply(x, halo * data.shape[-1], mesh, groups,
                       lambda left, right, part, y: block_dia_halo_rows(
                           data, offsets, offsets_t, left, x, right, halo,
                           part, y, b))


def _shards_apply(x, cuts, hw, side_stream, phases, rows):
    """One operator split at the entries ``cuts`` into row blocks in one
    process: each block's halos (``hw`` entries a side, from its ring
    neighbours' blocks of x; of every lane of a K-major (K, n) stack x)
    copied on a side stream under an event while the current stream runs
    ``rows(p, left, right, "interior", block)`` for every block p, then,
    after the event, ``rows(p, left, right, "boundary", block)``.
    ``phases`` picks what runs (for timing the interior alone, the halo
    copies alone, or all three).  On CPU tensors the copies are plain.
    Returns the (n,) (or (K, n)) result."""
    n_shards = len(cuts) - 1
    y = torch.empty_like(x)
    rows_of = [slice(a, b) for a, b in zip(cuts, cuts[1:])]
    halos = torch.empty((n_shards, 2) + tuple(x.shape[:-1]) + (hw,),
                        dtype=x.dtype, device=x.device)
    on_card = x.device.type == "cuda"
    main = torch.cuda.current_stream(x.device) if on_card else None
    side = (side_stream or torch.cuda.Stream(x.device)) if on_card else None
    done = torch.cuda.Event() if on_card else None
    if "halos" in phases:
        if on_card:
            side.wait_stream(main)
        with torch.cuda.stream(side) if on_card else nullcontext():
            for p in range(n_shards):
                left = cuts[(p - 1) % n_shards + 1]
                right = cuts[(p + 1) % n_shards]
                halos[p, 0].copy_(x[..., left - hw:left], non_blocking=True)
                halos[p, 1].copy_(x[..., right:right + hw],
                                  non_blocking=True)
            if on_card:
                done.record(side)
    for part in ("interior", "boundary"):
        if part == "boundary" and on_card and "halos" in phases:
            main.wait_event(done)     # the boundary and halos' reuse wait
        if part not in phases:
            continue
        for p, blk in enumerate(rows_of):
            rows(p, halos[p, 0], halos[p, 1], part, blk, y[..., blk])
    return y


def block_halo_spmv_shards(A: BlockDIAMatrix, x, n_shards, side_stream=None,
                           phases=("interior", "halos", "boundary"), b=None):
    """A @ x (or b - A @ x) with A split into ``n_shards`` node-row blocks
    in one process (block p the nodes [p nb / P, (p + 1) nb / P), each at
    least A.halo nodes, the halo at least 1), in :func:`_shards_apply`'s
    order, as :func:`halo_spmv_shards` does for K16."""
    nb, bs = A.nb_pad, A.bs
    cuts = [p * nb // n_shards for p in range(n_shards + 1)]
    halo = max(A.halo, 1)
    if min(b - a for a, b in zip(cuts, cuts[1:])) < halo:
        raise ValueError(f"halo {halo} exceeds a block of {nb} nodes in "
                         f"{n_shards}")
    offsets_t = A.offsets_t

    def rows(p, left, right, part, blk, y):
        block_dia_halo_rows(A.data[:, cuts[p]:cuts[p + 1]], A.offsets,
                            offsets_t, left, x[..., blk], right, halo, part,
                            y, None if b is None else b[..., blk])

    return _shards_apply(x, [c * bs for c in cuts], halo * bs, side_stream,
                         phases, rows)


def halo_spmv_shards(A: DIAMatrix, x, n_shards, side_stream=None,
                     phases=("interior", "halos", "boundary")):
    """A @ x with A and x split into ``n_shards`` row blocks in one
    process (n_pad % n_shards == 0, halo <= n_pad / n_shards), in
    :func:`_shards_apply`'s order; x a vector or a K-major (K, n_pad)
    lane stack (K16's lane mode on each block's columns of it); on CPU
    tensors the launches run their twin.  Returns the (n_pad,) (or (K,
    n_pad)) result."""
    n_pad = A.n_pad
    if n_pad % n_shards:
        raise ValueError(f"n_pad {n_pad} not divisible by {n_shards} shards")
    nl = n_pad // n_shards
    halo = halo_width(A)
    if halo > nl:
        raise ValueError(f"halo {halo} exceeds the block {nl}")
    offsets_t = A.offsets_t

    def rows(p, left, right, part, blk, y):
        dia_halo_rows(A.data[:, blk], A.offsets, offsets_t, left,
                      x[..., blk], right, halo, part, y)

    return _shards_apply(x, [p * nl for p in range(n_shards + 1)], halo,
                         side_stream, phases, rows)
