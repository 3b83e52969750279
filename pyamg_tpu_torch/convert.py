"""Carry a compiled JAX hierarchy across to the port.

:func:`hierarchy_from_jax` reads the leaves of a
``pyamg_tpu.engine.DeviceHierarchy`` with ``np.asarray`` (no ``jax``
import) and builds the port's hierarchy from exactly those arrays: the
counterpart of loading weights.  Operators shared inside the JAX
hierarchy (R's transposed tentative operator is P's) stay shared.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import resolve_device
from .engine.hierarchy import DeviceHierarchy, DeviceLevel
from .engine.relaxation import DeviceSmoother
from .sparse import (ComposedOperator, DenseOperator, DIAMatrix,
                     TransposedWindowed, WindowedELL)

__all__ = ["hierarchy_from_jax"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _dtype(jax_dtype):
    name = np.dtype(jax_dtype).name
    if name not in _DTYPES:
        raise NotImplementedError(f"dtype {name} is not ported yet")
    return _DTYPES[name]


def hierarchy_from_jax(dh, device) -> DeviceHierarchy:
    """The port's DeviceHierarchy holding the arrays of the JAX one."""
    device = resolve_device(device)
    memo = {}

    def tensor(a, dtype=None):
        arr = np.array(a)       # a writable host copy of the leaf
        return torch.as_tensor(arr, dtype=dtype or _dtype(arr.dtype),
                               device=device)

    def op(o):
        if o is None:
            return None
        key = id(o)
        if key not in memo:
            memo[key] = _convert(o)
        return memo[key]

    def _convert(o):
        name = type(o).__name__
        if name == "DIAMatrix":
            return DIAMatrix(data=tensor(o.data), offsets=tuple(o.offsets),
                             shape=tuple(o.shape), nnz=int(o.nnz))
        if name == "DenseOperator":
            return DenseOperator(data=tensor(o.data), shape=tuple(o.shape),
                                 nnz=int(o.nnz))
        if name == "WindowedELL":
            return WindowedELL(data=tensor(o.data),
                               idx=tensor(o.idx, torch.int32),
                               starts=tensor(o.starts, torch.int32),
                               shape=tuple(o.shape), block=int(o.block),
                               w2=int(o.w2), m_chunks=int(o.m_chunks),
                               nnz=int(o.nnz))
        if name == "TransposedWindowed":
            return TransposedWindowed(base=op(o.base))
        if name == "ComposedOperator":
            return ComposedOperator(ops=tuple(op(f) for f in o.ops),
                                    shape=tuple(o.shape), nnz=int(o.nnz))
        raise NotImplementedError(
            f"{name} has no counterpart in pyamg_tpu_torch yet "
            "(ROADMAP.md Queue 1)")

    def smoother(s):
        kind = s.config[0]
        if kind not in ("identity", "jacobi"):
            raise NotImplementedError(
                f"smoother {kind!r} is not ported yet (ROADMAP.md Queue 1 "
                "item 8)")
        return DeviceSmoother(config=tuple(s.config),
                              arrays=tuple(tensor(a) for a in s.arrays))

    levels = tuple(DeviceLevel(A=op(lvl.A), P=op(lvl.P), R=op(lvl.R),
                               pre=smoother(lvl.pre),
                               post=smoother(lvl.post), n=int(lvl.n),
                               n_pad=int(lvl.n_pad))
                   for lvl in dh.levels)
    return DeviceHierarchy(levels=levels, coarse_inv=tensor(dh.coarse_inv),
                           nc=int(dh.nc), nc_pad=int(dh.nc_pad),
                           dtype=_dtype(dh.dtype), A64=op(dh.A64))
