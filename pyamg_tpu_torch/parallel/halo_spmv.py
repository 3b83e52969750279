"""K16: the row-sharded DIA SpMV with the interior computed while the halos
travel (counterpart of ``pyamg_tpu/parallel/pallas_halo.py::
make_pallas_halo_spmv``; kernel ``csrc/halo.cu``).

The TPU kernel copies x into an extended VMEM buffer, starts remote DMAs
of both boundary slices to the ring neighbours' halo slots, computes the
interior rows while they fly and the boundary rows after.  Here the
remote DMA is a ``torch.distributed`` send/receive pair per direction
(:func:`~pyamg_tpu_torch.parallel.dist_spmv.start_halo_exchange`: NCCL on
the card, gloo on the CPU), and one CUDA kernel reads its three sources
(left halo, local x, right halo) by index instead of an extended copy:

1. start the halo exchange;
2. launch the interior rows [halo, n_local - halo) on the current stream
   while it runs;
3. wait for it (for NCCL, the current stream waits on the exchange);
4. launch the two boundary row ranges.

Entry points:

- :func:`dia_halo_rows`: one launch over one or two row ranges, the
  kernel wrapper (counted as ``dia_halo_spmv.<dtype>``);
- :func:`halo_spmv`: steps 1-4 on one rank's block, what the sharded
  hierarchy's DIA operators apply; a ring of one (a world of one, or a
  level on one group) takes its halos from x itself, as the reference's
  single-device ring does, and gives K1's result;
- :func:`halo_spmv_shards`: P row blocks of one operator in one process,
  each halo copied from its neighbouring block on a side stream under
  events while the main stream runs every interior, then every boundary;
  for the card check, and for multi-shard use in one process (not
  exported: no solver path calls it).

On CPU tensors :func:`dia_halo_rows` runs its plain twin
(:func:`~pyamg_tpu_torch.parallel.dist_spmv.dia_halo_rows_ref`, the
rolled sum over the extended vector) and the exchange is gloo's; on CUDA
tensors it launches the kernel or raises.
The TPU kernel is float32 only; this one takes float32 and float64.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from .. import _build
from ..sparse.dia import DIAMatrix
from .dist_spmv import dia_halo_rows_ref, halo_width, start_halo_exchange

__all__ = ["dia_halo_rows", "halo_spmv", "split_rows"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def split_rows(n_local, halo):
    """(interior, boundary) row ranges of a block: the interior
    [halo, n_local - halo) reads only the block, the boundary is the
    first and last ``halo`` rows (each clipped to the block)."""
    lo = min(halo, n_local)
    hi = max(n_local - halo, lo)
    return ((lo, hi),), ((0, lo), (hi, n_local))


def dia_halo_rows(data, offsets, offsets_t, left, x, right, halo, ranges,
                  y):
    """One K16 launch over at most two row ranges of a block: ``data``
    (nd, n_local), rows contiguous (a column slice of a wider array is
    fine), ``offsets`` (ascending, |offset| <= halo) and ``offsets_t``
    their int32 tensor beside data, ``left`` / ``right`` the halos
    (``halo`` entries each), ``x`` and ``y`` (n_local,).  Writes y's rows
    in place; raises on operands the kernel does not take."""
    if _build.on_cpu(data, left, x, right, y):
        return dia_halo_rows_ref(data, offsets, left, x, right, halo, ranges,
                                 y)
    ranges = [r for r in ranges if r[1] > r[0]]
    if not ranges:
        return y
    if len(ranges) > 2:
        raise ValueError("a K16 launch covers at most two row ranges")
    (a0, a1), (b0, b1) = ranges[0], ranges[-1]
    if len(ranges) == 1:
        b0 = b1 = a1
    n_local = x.shape[0]
    dtype = data.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"K16 takes float32 or float64, not {dtype}")
    if max(abs(o) for o in offsets) > halo:
        raise ValueError(f"an offset exceeds the halo {halo}")
    if data.ndim != 2 or data.shape[1] != n_local or data.stride(1) != 1:
        raise ValueError("data: expected (nd, n_local) with contiguous rows")
    if offsets_t.dtype != torch.int32 or offsets_t.numel() != len(offsets):
        raise ValueError("offsets_t: expected the int32 offsets")
    _build.check_vector("x", x, n_local, dtype)
    _build.check_vector("y", y, n_local, dtype)
    for name, h in (("left", left), ("right", right)):
        _build.check_vector(name, h, halo, dtype)
    fn_name = f"pyamg_halo_spmv_{_SUFFIX[dtype]}"
    err = getattr(_build.library(), fn_name)(
        data.data_ptr(), data.stride(0), offsets_t.data_ptr(), len(offsets),
        n_local, halo, left.data_ptr(), x.data_ptr(), right.data_ptr(), a0,
        a1, b0, b1, y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(fn_name, err)
    _build.count_launch(f"dia_halo_spmv.{_build.dtype_name(dtype)}")
    return y


def halo_spmv(data, offsets, offsets_t, x, halo, mesh, groups):
    """This rank's block of A @ x for a DIA A row-sharded over ``groups``
    shard groups of ``mesh``: the exchange started, the interior launched
    while it runs, then the boundary (K16's order).  A ring of one
    exchanges nothing and reads its halos from x."""
    y = torch.empty_like(x)
    interior, boundary = split_rows(x.shape[0], halo)
    left, right, reqs = start_halo_exchange(x, halo, mesh, groups)
    dia_halo_rows(data, offsets, offsets_t, left, x, right, halo, interior,
                  y)
    for req in reqs:
        req.wait()
    return dia_halo_rows(data, offsets, offsets_t, left, x, right, halo,
                         boundary, y)


def halo_spmv_shards(A: DIAMatrix, x, n_shards, side_stream=None,
                     phases=("interior", "halos", "boundary")):
    """A @ x with A and x split into ``n_shards`` row blocks in one
    process (n_pad % n_shards == 0, halo <= n_pad / n_shards): each
    block's halos are copied from its neighbouring blocks of x on a side
    stream (recorded by an event), every block's interior runs on the
    current stream meanwhile, then, after the event, every boundary.
    ``phases`` picks what runs (for timing the interior alone, the halo
    copies alone, or all three).  On CPU tensors the copies are plain
    and the launches run their twin.  Returns the (n_pad,) result."""
    n_pad = A.n_pad
    if n_pad % n_shards:
        raise ValueError(f"n_pad {n_pad} not divisible by {n_shards} shards")
    nl = n_pad // n_shards
    halo = halo_width(A)
    if halo > nl:
        raise ValueError(f"halo {halo} exceeds the block {nl}")
    y = torch.empty_like(x)
    blocks = [slice(p * nl, (p + 1) * nl) for p in range(n_shards)]
    halos = torch.empty((n_shards, 2, halo), dtype=x.dtype, device=x.device)
    on_card = x.device.type == "cuda"
    main = torch.cuda.current_stream(x.device) if on_card else None
    side = (side_stream or torch.cuda.Stream(x.device)) if on_card else None
    done = torch.cuda.Event() if on_card else None
    if "halos" in phases:
        if on_card:
            side.wait_stream(main)
        with torch.cuda.stream(side) if on_card else nullcontext():
            for p in range(n_shards):
                left = blocks[(p - 1) % n_shards]
                right = blocks[(p + 1) % n_shards]
                halos[p, 0].copy_(x[left][nl - halo:], non_blocking=True)
                halos[p, 1].copy_(x[right][:halo], non_blocking=True)
            if on_card:
                done.record(side)
    interior, boundary = split_rows(nl, halo)
    offsets_t = A.offsets_t
    if "interior" in phases:
        for p, blk in enumerate(blocks):
            dia_halo_rows(A.data[:, blk], A.offsets, offsets_t, halos[p, 0],
                          x[blk], halos[p, 1], halo, interior, y[blk])
    if on_card and "halos" in phases:
        main.wait_event(done)     # the boundary and halos' reuse wait
    if "boundary" in phases:
        for p, blk in enumerate(blocks):
            dia_halo_rows(A.data[:, blk], A.offsets, offsets_t, halos[p, 0],
                          x[blk], halos[p, 1], halo, boundary, y[blk])
    return y
