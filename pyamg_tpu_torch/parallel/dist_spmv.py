"""Explicit halo-exchange distributed SpMV (counterpart of
``pyamg_tpu/parallel/dist_spmv.py``).

Each rank owns a contiguous block of rows of a DIA operator and of the
vectors; row i needs x at i + offsets[d], so a block needs ``halo`` ghost
entries from each ring neighbour.  The JAX function is a ``shard_map``
kernel that ``lax.ppermute``s the boundary slices; here every rank runs
the same code on its own block (SPMD) and one ``dist.batch_isend_irecv``
holds both sends and both receives, so the ring cannot deadlock:

1. send the block's tail to the right neighbour and its head to the left
   one, receive the left neighbour's tail and the right one's head;
2. wait for the exchange;
3. run the rolled-DIA sum over [left halo, block, right halo], in offset
   order (:func:`dia_halo_rows_ref`).

The ring wraps around, which is harmless for the reason plain DIA rolls
are: a slot whose column leaves the matrix stores zero.  A ring of one
(a world of one rank, or a level on one group) exchanges nothing: its
halos are the block's own tail and head, views into x, since NCCL cannot
send to its own rank.

This is the plain twin of K16 (:mod:`pyamg_tpu_torch.parallel.halo_spmv`),
the overlapped kernel form the sharded hierarchy applies;
:func:`dia_halo_rows_ref` is also the K16 wrapper's form on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..sparse import DIAMatrix

__all__ = ["make_halo_dia_spmv", "halo_width", "start_halo_exchange",
           "dia_halo_rows_ref"]

# P2P tags of the two directions (gloo matches messages by tag; NCCL
# matches them in order)
_TO_RIGHT, _TO_LEFT = 0, 1


def halo_width(dia: DIAMatrix):
    """Maximum ghost width needed by a DIA operator's offsets."""
    return max(max(abs(o) for o in dia.offsets), 1)


def start_halo_exchange(x, halo, mesh, groups):
    """Start the ring exchange of a rank's block ``x`` on a layout of
    ``groups`` shard groups; returns ``(from_left, from_right, requests)``:
    the left neighbour's last and the right neighbour's first ``halo``
    entries once every request has been waited on.  A ring of one returns
    views of x's own tail and head and no request."""
    n = x.shape[0]
    left, right = mesh.partners(groups)
    if left == mesh.rank:
        return x[n - halo:], x[:halo], []
    from_left = torch.empty(halo, dtype=x.dtype, device=x.device)
    from_right = torch.empty(halo, dtype=x.dtype, device=x.device)
    ops = [dist.P2POp(dist.isend, x[n - halo:], right, tag=_TO_RIGHT),
           dist.P2POp(dist.irecv, from_left, left, tag=_TO_RIGHT),
           dist.P2POp(dist.isend, x[:halo], left, tag=_TO_LEFT),
           dist.P2POp(dist.irecv, from_right, right, tag=_TO_LEFT)]
    return from_left, from_right, dist.batch_isend_irecv(ops)


def dia_halo_rows_ref(data, offsets, left, x, right, halo, ranges, y):
    """The rolled-DIA sum over a block and its halos: for each (r0, r1) of
    ``ranges``, y[r0:r1] = sum_d data[d, r0:r1] * x_ext[halo + r0 + off_d
    : ...] with x_ext = [left, x, right], in offset order (the JAX
    function's).  ``data`` is the block's (nd, n_local) diagonals (a view
    is fine); writes ``y`` in place and returns it."""
    x_ext = torch.cat([left, x, right])
    for r0, r1 in ranges:
        if r1 <= r0:
            continue
        acc = data[0, r0:r1] * x_ext[halo + r0 + offsets[0]:
                                     halo + r1 + offsets[0]]
        for d in range(1, len(offsets)):
            off = offsets[d]
            acc = acc + data[d, r0:r1] * x_ext[halo + r0 + off:
                                               halo + r1 + off]
        y[r0:r1] = acc
    return y


def make_halo_dia_spmv(dia: DIAMatrix, mesh, axis="x"):
    """Build the distributed SpMV y = A @ x for a row-sharded DIA A.

    Returns ``(spmv, place)`` as the JAX function does: ``place(x)`` gives
    this rank's block of a global vector (numpy or tensor) on the mesh's
    device, and ``spmv(data, x_block)`` this rank's block of A @ x, after
    a blocking halo exchange with the ring neighbours.  ``data`` is the
    DIA data, whole (nd, n_pad) or this rank's (nd, n_pad / world)
    block.

    Requires n_pad divisible by the mesh size and halo <= local size
    (``ValueError`` otherwise)."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has no axis {axis!r}")
    groups = mesh.world
    n_pad = dia.n_pad
    if n_pad % groups != 0:
        raise ValueError(f"n_pad {n_pad} not divisible by mesh size {groups}")
    n_local = n_pad // groups
    halo = halo_width(dia)
    if halo > n_local:
        raise ValueError(f"halo {halo} exceeds local block {n_local}; "
                         "use fewer devices or the replicated path")
    offsets = dia.offsets

    def spmv(data, x_loc):
        if data.shape[1] == n_pad:
            data = mesh.local(data, groups)
        from_left, from_right, reqs = start_halo_exchange(x_loc, halo, mesh,
                                                          groups)
        for req in reqs:
            req.wait()
        return dia_halo_rows_ref(data, offsets, from_left, x_loc, from_right,
                                 halo, ((0, n_local),), torch.empty_like(x_loc))

    def place(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        x = x.to(dtype=dia.dtype, device=mesh.device)
        return mesh.local(x, groups).contiguous()

    return spmv, place
