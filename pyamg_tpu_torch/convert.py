"""Carry a compiled JAX hierarchy across to the port.

:func:`hierarchy_from_jax` reads the leaves of a
``pyamg_tpu.engine.DeviceHierarchy`` with ``np.asarray`` (no ``jax``
import) and builds the port's hierarchy from exactly those arrays: the
counterpart of loading weights.  Operators shared inside the JAX
hierarchy (R's transposed tentative operator is P's) stay shared.  Every
scalar smoother kind carries across (Jacobi, Richardson, multicolour
Gauss-Seidel, polynomial, Cimmino, windowed Schwarz, with static or
device weights), and so does the masked C/F Jacobi (its masks kept
bool), and the block smoothers (block Jacobi with a static or device
weight, block multicolour Gauss-Seidel); so do the device-built
hierarchies' structured transfers (SA's factored ones, the block setup's
block ones, the classical setups' embedded ones) and the block-DIA
operators; :func:`structured_solver_from_jax` wraps such a hierarchy with
the JAX solver's grid layout, and :func:`block_solver_from_jax` a block
setup's with its node grid and block size.  The unstructured setup's
composed prolongators carry across as well, and so does the unstructured
AIR setup's Neumann restriction; :func:`unstructured_solver_from_jax`
wraps an unstructured SA, RS or AIR hierarchy (in the JAX
``ReorderedSolver``'s permutation when it has one).
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import resolve_device
from .engine.block_setup import (BlockStructuredDeviceSolver,
                                 BlockStructuredProlongator,
                                 BlockStructuredRestrictor)
from .engine.classical_setup import EmbeddedProlongator, EmbeddedRestrictor
from .engine.device_setup import (StructuredDeviceSolver,
                                  StructuredProlongator,
                                  StructuredRestrictor)
from .engine.hierarchy import DeviceHierarchy, DeviceLevel
from .engine.relaxation import DeviceSmoother
from .engine.solver import DeviceMultilevelSolver
from .engine.unstructured_classical import NeumannAIRRestriction
from .engine.unstructured_setup import ComposedWindowed, ReorderedSolver
from .sparse import (BlockDIAMatrix, ComposedOperator, DenseOperator,
                     DIAMatrix, TransposedWindowed, WindowedELL)

__all__ = ["block_solver_from_jax", "hierarchy_from_jax",
           "structured_solver_from_jax", "unstructured_solver_from_jax"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bool": torch.bool}
# JAX transfer class name -> (the port's class, its DIA factor's field)
_GRID_TRANSFERS = {
    "StructuredProlongator": (StructuredProlongator, "S"),
    "StructuredRestrictor": (StructuredRestrictor, "St"),
    "EmbeddedProlongator": (EmbeddedProlongator, "P_emb"),
    "EmbeddedRestrictor": (EmbeddedRestrictor, "R_emb"),
    "BlockStructuredProlongator": (BlockStructuredProlongator, "S"),
    "BlockStructuredRestrictor": (BlockStructuredRestrictor, "St"),
}


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
        if name == "BlockDIAMatrix":
            return BlockDIAMatrix(data=tensor(o.data),
                                  offsets=tuple(o.offsets),
                                  shape=tuple(o.shape), bs=int(o.bs),
                                  nnz=int(o.nnz))
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
        if name == "ComposedWindowed":
            return ComposedWindowed(factors=tuple(op(f) for f in o.factors))
        if name == "NeumannAIRRestriction":
            return NeumannAIRRestriction(
                A=op(o.A), Tinj=op(o.Tinj), dinv_f=tensor(o.dinv_f),
                shape=tuple(o.shape), nnz=int(o.nnz), degree=int(o.degree))
        if name == "ComposedOperator":
            return ComposedOperator(ops=tuple(op(f) for f in o.ops),
                                    shape=tuple(o.shape), nnz=int(o.nnz))
        if name in _GRID_TRANSFERS:
            # the grid setups' transfers: a DIA or block-DIA factor, SA's
            # tentative values (a block setup's per-node blocks), and the
            # static grid geometry
            cls, factor = _GRID_TRANSFERS[name]
            kw = {v: tensor(getattr(o, v)) for v in ("tv", "Qv")
                  if hasattr(o, v)}
            return cls(**{factor: op(getattr(o, factor))}, **kw,
                       fine_grid_p=o.fine_grid_p, coarse_grid=o.coarse_grid,
                       coarse_grid_p=o.coarse_grid_p, stride=o.stride,
                       center=o.center)
        raise NotImplementedError(
            f"{name} has no counterpart in pyamg_tpu_torch yet "
            "(ROADMAP.md Queue 1)")

    def smoother(s):
        # int32 colours stay int32 and masks bool; every
        # float leaf (0-d weights, 1-d coefficient stacks, per-row
        # vectors, Schwarz blocks) keeps its dtype; a static coefficient
        # tuple rides in the config
        return DeviceSmoother(config=tuple(s.config), arrays=tuple(
            tensor(a, torch.int32 if np.dtype(a.dtype).kind in "iu"
                   else None) for a in s.arrays))

    levels = tuple(DeviceLevel(A=op(lvl.A), P=op(lvl.P), R=op(lvl.R),
                               pre=smoother(lvl.pre),
                               post=smoother(lvl.post), n=int(lvl.n),
                               n_pad=int(lvl.n_pad))
                   for lvl in dh.levels)
    return DeviceHierarchy(levels=levels, coarse_inv=tensor(dh.coarse_inv),
                           nc=int(dh.nc), nc_pad=int(dh.nc_pad),
                           dtype=_dtype(dh.dtype), A64=op(dh.A64))


def structured_solver_from_jax(dsa, device) -> StructuredDeviceSolver:
    """The port's StructuredDeviceSolver over the arrays of a JAX
    ``device_sa_setup``, ``device_rs_setup`` or ``device_air_setup``
    result, with its grid and padded grid (and its setup family)."""
    info = {k: v for k, v in getattr(dsa, "setup_info", {}).items()
            if k in ("family", "nlevels")}
    return StructuredDeviceSolver(hierarchy_from_jax(dsa.hierarchy, device),
                                  dsa.grid, dsa.grid_p, setup_info=info)


def block_solver_from_jax(dsa, device) -> BlockStructuredDeviceSolver:
    """The port's BlockStructuredDeviceSolver over the arrays of a JAX
    ``device_sa_setup_block`` (or ``device_adaptive_sa_setup`` with more
    than one candidate) result, with its node grid, padded grid and block
    size."""
    info = {k: v for k, v in getattr(dsa, "setup_info", {}).items()
            if k in ("m", "stride")}
    return BlockStructuredDeviceSolver(
        hierarchy_from_jax(dsa.hierarchy, device), dsa.grid, dsa.grid_p,
        dsa.bs, setup_info=info)


def unstructured_solver_from_jax(dsa, device):
    """The port's solver over the arrays of a JAX
    ``device_unstructured_sa_setup``, ``device_unstructured_rs_setup`` or
    ``device_unstructured_air_setup`` result: a DeviceMultilevelSolver, in
    a :class:`ReorderedSolver` with the JAX one's permutation when the
    JAX setup reordered."""
    inner = getattr(dsa, "_inner", None)
    dml = DeviceMultilevelSolver(hierarchy_from_jax(dsa.hierarchy, device))
    dml.setup_info = dict(getattr(inner or dsa, "setup_info", {}))
    if inner is None:
        return dml
    return ReorderedSolver(dml, np.asarray(dsa._perm))
