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
           "ring_send", "dia_halo_rows_ref", "block_dia_halo_rows_ref"]

# P2P tags of the two directions (gloo matches messages by tag; NCCL
# matches them in order)
_TO_RIGHT, _TO_LEFT = 0, 1


def halo_width(dia: DIAMatrix):
    """Maximum ghost width needed by a DIA operator's offsets."""
    return max(max(abs(o) for o in dia.offsets), 1)


def start_halo_exchange(x, halo, mesh, groups, axis=-1):
    """Start the ring exchange of a rank's block ``x`` (a vector, or a
    K-major (K, n) lane stack) on a layout of ``groups`` shard groups;
    returns ``(from_left, from_right, requests)``: the left neighbour's
    last and the right neighbour's first ``halo`` entries (of every lane:
    (K, halo) stacks) once every request has been waited on.  Each side
    goes as one contiguous buffer, all lanes in one message.  A ring of
    one returns views of x's own tail and head and no request.  ``axis``
    is the axis of the rows (the node rows of a block operator's (nd, nb,
    r, c) blocks: its halos then (nd, halo, r, c))."""
    n = x.shape[axis]
    left, right = mesh.partners(groups)
    if left == mesh.rank:
        return x.narrow(axis, n - halo, halo), x.narrow(axis, 0, halo), []
    tail = x.narrow(axis, n - halo, halo).contiguous()
    from_left = torch.empty_like(tail)
    from_right = torch.empty_like(tail)
    ops = [dist.P2POp(dist.isend, tail, right, tag=_TO_RIGHT),
           dist.P2POp(dist.irecv, from_left, left, tag=_TO_RIGHT),
           dist.P2POp(dist.isend, x.narrow(axis, 0, halo).contiguous(), left,
                      tag=_TO_LEFT),
           dist.P2POp(dist.irecv, from_right, right, tag=_TO_LEFT)]
    return from_left, from_right, dist.batch_isend_irecv(ops)


def ring_send(t, mesh, groups, to_right):
    """Send ``t`` to the ring neighbour on one side (``to_right``: the
    right one) on a layout of ``groups`` shard groups, and receive a
    tensor of its shape from the neighbour on the other side; returns it
    once received.  A ring of one returns ``t`` itself."""
    left, right = mesh.partners(groups)
    if left == mesh.rank:
        return t
    got = torch.empty_like(t)
    dst, src = (right, left) if to_right else (left, right)
    tag = _TO_RIGHT if to_right else _TO_LEFT
    for req in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t.contiguous(), dst, tag=tag),
             dist.P2POp(dist.irecv, got, src, tag=tag)]):
        req.wait()
    return got


def dia_halo_rows_ref(data, offsets, left, x, right, halo, ranges, y):
    """The rolled-DIA sum over a block and its halos: for each (r0, r1) of
    ``ranges``, y[r0:r1] = sum_d data[d, r0:r1] * x_ext[halo + r0 + off_d
    : ...] with x_ext = [left, x, right], in offset order (the JAX
    function's); lane by lane for K-major (K, n_local) stacks x and y with
    (K, halo) halos (K8's twin's products and sums, ``dia_spmm_ref``).
    ``data`` is the block's (nd, n_local) diagonals (a view is fine);
    writes ``y`` in place and returns it."""
    x_ext = torch.cat([left, x, right], dim=-1)
    for r0, r1 in ranges:
        if r1 <= r0:
            continue
        acc = data[0, r0:r1] * x_ext[..., halo + r0 + offsets[0]:
                                     halo + r1 + offsets[0]]
        for d in range(1, len(offsets)):
            off = offsets[d]
            acc = acc + data[d, r0:r1] * x_ext[..., halo + r0 + off:
                                               halo + r1 + off]
        y[..., r0:r1] = acc
    return y


def block_dia_halo_rows_ref(data, offsets, left, x, right, halo, ranges,
                            y, b=None):
    """The block form of :func:`dia_halo_rows_ref`, the plain twin of B1's
    halo mode: for each node range (n0, n1) of ``ranges``, the node rows
    of ``data`` (nd, n_local, bs, bs) applied to the extended vector x_ext
    = [left, x, right] (``halo`` nodes on either side) as
    :func:`~pyamg_tpu_torch.sparse.block_dia.block_dia_spmv_ref` applies
    a whole operator: each run of consecutive offsets one strided view of
    overlapping windows, the runs side by side, one product and one sum
    over each row's strip; lane by lane for K-major stacks x, y and b
    with (K, halo * bs) halos; ``b - A x`` when ``b`` is given
    (``RESID``).  Writes ``y`` in place and returns it."""
    from ..sparse.block_dia import _offset_runs

    nd, bs = data.shape[0], data.shape[-1]
    x_ext = torch.cat([left, x, right], dim=-1)
    lead = tuple(x_ext.shape[:-1])
    lead_strides = tuple(x_ext.stride()[:-1])
    for n0, n1 in ranges:
        if n1 <= n0:
            continue
        nb = n1 - n0
        strips = data[:, n0:n1].permute(1, 2, 0, 3).reshape(
            nb, bs, nd * bs).contiguous()       # the B1 twin's layout
        views = [x_ext.as_strided(lead + (nb, length * bs),
                                  lead_strides + (bs, 1),
                                  x_ext.storage_offset()
                                  + (halo + n0 + first) * bs)
                 for first, length in _offset_runs(offsets)]
        xg = views[0] if len(views) == 1 else torch.cat(views, dim=-1)
        acc = torch.sum(strips * xg.unsqueeze(-2), dim=-1).reshape(
            lead + (-1,))
        rows = slice(n0 * bs, n1 * bs)
        y[..., rows] = acc if b is None else b[..., rows] - acc
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
