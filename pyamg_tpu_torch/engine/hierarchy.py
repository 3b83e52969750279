"""Compile a host MultilevelSolver into a device hierarchy of tensors
(counterpart of ``pyamg_tpu/engine/hierarchy.py``).

The host setup (``pyamg_tpu.aggregation`` and friends, NumPy/SciPy) is
shared with the JAX package, not ported.  This module converts its
operators once into padded DIA / dense / windowed / composed operators on
``device`` and resolves the smoother specs.  Every decision follows the
JAX package's rules (row padding 1024, the 2048 dense threshold, the
factored transfers, the windowed block/w2 choice, the transpose gate), so
the port's hierarchy is the reference's, level by level.

Not ported yet (each raises ``NotImplementedError``): smoothers other
than Jacobi (ROADMAP.md Queue 1 item 8), BSR block-DIA levels (item 8),
complex hierarchies, and bf16 DIA storage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from pyamg_tpu.relaxation.smoothing import rho_D_inv_A

from ..backend import resolve_device
from ..sparse import (ComposedOperator, DIAMatrix, TransposedWindowed,
                      WindowedELL, dense_from_scipy, dia_from_scipy, pad_to,
                      select_operator, windowed_from_scipy)
from . import relaxation as device_relaxation
from .device_setup import dia_transpose

__all__ = ["DeviceLevel", "DeviceHierarchy", "compile_hierarchy"]

_ROW_PAD = 1024


@dataclass(frozen=True)
class DeviceLevel:
    """Device operators + smoothers for one level."""

    A: Any
    P: Optional[Any]
    R: Optional[Any]
    pre: device_relaxation.DeviceSmoother
    post: device_relaxation.DeviceSmoother
    n: int                   # logical size
    n_pad: int               # padded size


@dataclass(frozen=True)
class DeviceHierarchy:
    """DeviceLevels + the padded dense coarse pseudo-inverse.

    ``A64`` (optional) holds the finest operator in float64 for the
    mixed-precision outer Krylov loop."""

    levels: Tuple[DeviceLevel, ...]
    coarse_inv: torch.Tensor     # (nc_pad, nc_pad)
    nc: int
    nc_pad: int
    dtype: torch.dtype
    A64: Optional[Any] = None

    @property
    def device(self):
        return self.coarse_inv.device

    def coarse_solve(self, bc):
        # padded with zero rows/cols beyond nc: the padded product is exact
        return torch.matmul(self.coarse_inv, bc)


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to pyamg_tpu_torch yet "
        f"(ROADMAP.md Queue 1 item {item})")


def _device_dinv(A_scipy, n_pad, dtype, device):
    d = A_scipy.diagonal()
    with np.errstate(divide="ignore", invalid="ignore"):
        dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0.0)
    out = np.zeros(n_pad, dtype=dinv.dtype)
    out[: len(dinv)] = dinv
    return torch.as_tensor(out, dtype=dtype, device=device)


def _compile_smoother(lvl, spec, dtype, n_pad, device):
    """Map a resolved host smoother spec onto its device form."""
    A = lvl.A
    # keep the SAME object when already CSR so the spectral-radius cache
    # computed during host setup is reused
    Acsr = A if (sp.issparse(A) and A.format == "csr") else sp.csr_matrix(A)
    name, kwargs = spec if spec is not None else (None, {})
    kwargs = dict(kwargs or {})

    if name is None or name == "none":
        return device_relaxation.identity()
    if name != "jacobi":
        raise _not_ported(f"smoother {name!r}", 8)
    iterations = int(kwargs.get("iterations", 1))
    omega = float(kwargs.get("omega", 1.0))
    if kwargs.get("withrho", True):
        omega = omega / rho_D_inv_A(Acsr)
    dinv = _device_dinv(Acsr, n_pad, dtype, device)
    return device_relaxation.jacobi(dinv, omega, iterations)


def _smoothing_factor_dia(A_dev, A_host, fac, dtype):
    """DIA form of S = I - omega * diag(dinv) @ A, by scaling the already
    converted DIA of A; None when A's device form is not a same-dtype
    DIA (the caller then materializes S on the host)."""
    if not isinstance(A_dev, DIAMatrix) or A_dev.dtype != dtype:
        return None
    n = A_host.shape[0]
    n_pad = A_dev.n_pad
    dev = A_dev.device
    dinv = fac["dinv"]
    if dinv is None:                      # richardson: identity scaling
        scale = np.full(n_pad, -fac["omega"])
    else:
        scale = np.zeros(n_pad)
        scale[:n] = -fac["omega"] * dinv
    data = A_dev.data * torch.as_tensor(scale, dtype=dtype, device=dev)[None, :]
    bump = torch.as_tensor((np.arange(n_pad) < n).astype(np.float64),
                           dtype=dtype, device=dev)
    if 0 in A_dev.offsets:
        d0 = A_dev.offsets.index(0)
        data[d0] += bump
        offsets = A_dev.offsets
    else:
        data = torch.cat([data, bump[None, :]])
        offsets = A_dev.offsets + (0,)
    return DIAMatrix(data=data, offsets=offsets, shape=A_host.shape,
                     nnz=A_host.nnz + n)


def _smoothing_factor_host(A_host, fac):
    """Materialized host CSR of S = I - omega * diag(dinv) @ A."""
    from pyamg_tpu.util.utils import scale_rows

    A_csr = sp.csr_matrix(A_host)
    dinv = fac["dinv"]
    scaled = (A_csr * (-fac["omega"]) if dinv is None
              else scale_rows(A_csr, -fac["omega"] * dinv, copy=True))
    return (scaled + sp.identity(A_csr.shape[0], dtype=scaled.dtype,
                                 format="csr")).tocsr()


def _factored_transfer(M, fac, A_dev, A_host, dtype, row_pad, device):
    """P = S^degree @ T from the recipe the host smoother recorded
    (aggregation/smooth.py); None when the factors have no cheap device
    form."""
    if fac is None or A_host is None:
        return None
    degree = fac["degree"]
    if degree < 1 or degree > 3:
        return None
    S_dev = _smoothing_factor_dia(A_dev, A_host, fac, dtype)
    if S_dev is None:
        S_dev = dia_from_scipy(_smoothing_factor_host(A_host, fac),
                               dtype=dtype, device=device, row_pad=row_pad,
                               max_diags=64)
    if S_dev is None:
        return None
    T_dev = windowed_from_scipy(sp.csr_matrix(fac["T"]), dtype=dtype,
                                device=device)
    if T_dev is None:
        return None
    return ComposedOperator(ops=(S_dev,) * degree + (T_dev,),
                            shape=M.shape, nnz=int(M.nnz))


def _transfer_operator(M, dtype, row_pad, device, fac=None, A_dev=None,
                       A_host=None):
    """Device form of a prolongator: dense when small, else factored
    S^d T, else windowed, else select_operator."""
    if max(M.shape) <= 2048:
        return dense_from_scipy(M, dtype=dtype, device=device,
                                row_pad=row_pad)
    F = _factored_transfer(M, fac, A_dev, A_host, dtype, row_pad, device)
    if F is not None:
        return F
    W = windowed_from_scipy(M, dtype=dtype, device=device)
    if W is not None:
        return W
    return select_operator(M, dtype=dtype, device=device, row_pad=row_pad)


def _is_transpose_of(R, P):
    """R == P^T to rounding (the plain transpose)."""
    if P is None or R.shape != sp.csr_matrix(P).shape[::-1]:
        return False
    D = (R - sp.csr_matrix(P).T).tocsr()
    scale = max(np.abs(R.data).max() if R.nnz else 0.0, 1e-300)
    return D.nnz == 0 or np.abs(D.data).max() <= 1e-14 * scale


def _restriction_operator(R, P, P_dev, dtype, row_pad, device, fac=None,
                          r_is_pt=False):
    """Device form of a restriction operator.  When R == P^T and P is
    factored, R = T^T (S^T)^d applies T's own arrays backwards through
    the transpose kernel: the exact transpose CG needs."""
    if max(R.shape) <= 2048:
        return dense_from_scipy(R, dtype=dtype, device=device,
                                row_pad=row_pad)
    if (isinstance(P_dev, ComposedOperator)
            and (r_is_pt or _is_transpose_of(R, P))):
        T_dev = P_dev.ops[-1]
        St_dev = dia_transpose(P_dev.ops[0])
        if (isinstance(T_dev, WindowedELL)
                and T_dev._can_transpose_pallas()):
            return ComposedOperator(
                ops=(TransposedWindowed(T_dev),) + (St_dev,) * fac["degree"],
                shape=R.shape, nnz=int(R.nnz))
    if (isinstance(P_dev, WindowedELL) and P_dev._can_transpose_pallas()
            and (r_is_pt or _is_transpose_of(R, P))):
        return TransposedWindowed(P_dev)
    Rt = sp.csr_matrix(R).T.tocsr()
    Wt = windowed_from_scipy(Rt, dtype=dtype, device=device)
    if Wt is not None and Wt._can_transpose_pallas():
        return TransposedWindowed(Wt)
    W = windowed_from_scipy(R, dtype=dtype, device=device)
    if W is not None:
        return W
    return select_operator(R, dtype=dtype, device=device, row_pad=row_pad)


def compile_hierarchy(ml, dtype=torch.float32, device=None,
                      row_pad=_ROW_PAD, mixed_precision=False,
                      coarse_cutoff=None):
    """Convert a host MultilevelSolver into a DeviceHierarchy on ``device``.

    ``coarse_cutoff=n`` truncates the hierarchy at the first level with
    <= n unknowns and solves there with the dense pseudo-inverse.
    ``mixed_precision=True`` also stores the finest operator in float64
    for the mixed-precision outer Krylov loop."""
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.float64):
        raise _not_ported(f"dtype {dtype}", 4)
    host_levels = ml.levels
    if coarse_cutoff is not None:
        for cut, lvl in enumerate(host_levels):
            if lvl.A.shape[0] <= int(coarse_cutoff):
                host_levels = host_levels[: cut + 1]
                break
    levels = []
    for lvl in host_levels[:-1]:
        A = sp.csr_matrix(lvl.A)
        if np.iscomplexobj(A.data):
            raise _not_ported("a complex hierarchy", 2)
        n = A.shape[0]
        n_pad = pad_to(n, row_pad)
        if (sp.issparse(lvl.A) and lvl.A.format == "bsr"
                and lvl.A.blocksize[0] == lvl.A.blocksize[1]
                and lvl.A.blocksize[0] > 1 and n > 2048
                and n_pad % lvl.A.blocksize[0] == 0):
            raise _not_ported("the block-DIA form of a BSR level", 8)
        A_dev = select_operator(A, dtype=dtype, device=device,
                                row_pad=row_pad)
        # the level's vector length follows the compiled operator's row
        # padding (the adaptive windowed row block may exceed row_pad)
        n_pad = int(getattr(A_dev, "n_pad", n_pad))
        fac = getattr(lvl.P, "_sa_factor", None)
        r_is_pt = bool(getattr(lvl, "R_is_PT", False))
        P_dev = _transfer_operator(sp.csr_matrix(lvl.P), dtype, row_pad,
                                   device, fac=fac, A_dev=A_dev,
                                   A_host=lvl.A)
        R_dev = _restriction_operator(sp.csr_matrix(lvl.R), lvl.P, P_dev,
                                      dtype, row_pad, device, fac=fac,
                                      r_is_pt=r_is_pt)
        pre = _compile_smoother(lvl, getattr(lvl, "presmoother_spec", None),
                                dtype, n_pad, device)
        post = _compile_smoother(lvl, getattr(lvl, "postsmoother_spec",
                                              None), dtype, n_pad, device)
        levels.append(DeviceLevel(A=A_dev, P=P_dev, R=R_dev, pre=pre,
                                  post=post, n=n, n_pad=n_pad))

    Ac = sp.csr_matrix(host_levels[-1].A)
    nc = Ac.shape[0]
    nc_pad = pad_to(nc, row_pad)
    pinv_c = np.linalg.pinv(Ac.toarray())
    coarse_inv = np.zeros((nc_pad, nc_pad), dtype=pinv_c.dtype)
    coarse_inv[:nc, :nc] = pinv_c
    Ac_dev = select_operator(Ac, dtype=dtype, device=device, row_pad=row_pad)
    ident = device_relaxation.identity()
    levels.append(DeviceLevel(A=Ac_dev, P=None, R=None, pre=ident,
                              post=ident, n=nc, n_pad=nc_pad))
    A64 = None
    if mixed_precision:
        A64 = select_operator(sp.csr_matrix(host_levels[0].A),
                              dtype=torch.float64, device=device,
                              row_pad=row_pad)
    return DeviceHierarchy(
        levels=tuple(levels),
        coarse_inv=torch.as_tensor(coarse_inv, dtype=dtype, device=device),
        nc=nc, nc_pad=nc_pad, dtype=dtype, A64=A64)
