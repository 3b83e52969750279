"""Compile a host MultilevelSolver into a device hierarchy of tensors
(counterpart of ``pyamg_tpu/engine/hierarchy.py``).

The host setup is the port's own copy of the JAX package's
(``pyamg_tpu_torch.aggregation`` and friends, NumPy/SciPy plus a native
C++ subset); a ``pyamg_tpu`` MultilevelSolver, which has the same
attributes, compiles too.  This module converts the host operators once into padded DIA /
block-DIA / dense / windowed / composed operators on ``device`` and
resolves the smoother specs: a square-block BSR level of more than 2048
rows becomes a :class:`~pyamg_tpu_torch.sparse.block_dia.BlockDIAMatrix`,
as the reference's.  Every decision follows the
JAX package's rules (row padding 1024, the 2048 dense threshold, the
factored transfers, the windowed block/w2 choice, the transpose gate), so
the port's hierarchy is the reference's, level by level.

The smoother specs compile as the reference's: Gauss-Seidel and SOR to
multicolour Gauss-Seidel on a Jones-Plassmann colouring (Chebyshev of
degree 4 where a level needs more than 16 colours), the Kaczmarz forms to
the Cimmino sweeps, Schwarz to windowed Schwarz, and an unknown name to
multicolour Gauss-Seidel, each substitution announced by the reference's
warning; block Jacobi and block Gauss-Seidel with a blocksize above 1
to their block forms (the inverse diagonal blocks, block multicolour
Gauss-Seidel on a JP colouring of the node graph); the C/F smoothers
(``cf_jacobi``, ``fc_jacobi``, and ``cf_block_jacobi`` /
``fc_block_jacobi`` at any blocksize, a node's mask covering its bs rows)
to the masked point Jacobi on the level's splitting.  Not ported yet
(each raises ``NotImplementedError``): complex hierarchies, and bf16 DIA
storage.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..backend import resolve_device
from ..graph import vertex_coloring
from ..relaxation.chebyshev import chebyshev_polynomial_coefficients
from ..relaxation.smoothing import (_blocksize, rho_block_D_inv_A,
                                    rho_D_inv_A)
from ..sparse import (ComposedOperator, DIAMatrix, TransposedWindowed,
                      WindowedELL, block_dia_from_scipy, dense_from_scipy,
                      dia_from_scipy, pad_to, select_operator,
                      windowed_from_scipy)
from ..sparse.dia import dia_transpose
from ..util.linalg import approximate_spectral_radius
from ..util.utils import amalgamate, get_block_diag, scale_rows
from . import relaxation as device_relaxation

__all__ = ["DeviceLevel", "DeviceHierarchy", "compile_hierarchy"]

_ROW_PAD = 1024
_MAX_GS_COLORS = 16


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
        """The dense pseudo-inverse applied to a vector, or lane by lane to
        a K-major (K, nc_pad) stack; zero rows/cols beyond nc keep the
        padded product exact."""
        if bc.ndim == 2:
            return torch.matmul(bc, self.coarse_inv.T)
        return torch.matmul(self.coarse_inv, bc)


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to pyamg_tpu_torch yet "
        f"(ROADMAP.md Queue 1 item {item})")


def _device_vector(values, n_pad, dtype, device):
    out = np.zeros(n_pad, dtype=np.float64)
    out[: len(values)] = values
    return torch.as_tensor(out, dtype=dtype, device=device)


def _device_dinv(A_scipy, n_pad, dtype, device):
    d = A_scipy.diagonal()
    with np.errstate(divide="ignore", invalid="ignore"):
        dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0.0)
    return _device_vector(dinv, n_pad, dtype, device)


def _device_block_dinv(A_scipy, bs, nb_pad, dtype, device):
    """The inverse diagonal blocks, zero-padded to (nb_pad, bs, bs)."""
    Dinv = get_block_diag(A_scipy, bs, inv_flag=True)
    out = np.zeros((nb_pad, bs, bs), dtype=np.float64)
    out[: Dinv.shape[0]] = Dinv
    return torch.as_tensor(out, dtype=dtype, device=device)


def _colors_for(A_scipy, n_pad, device):
    """JP colouring of the scalar connectivity graph, padded with -1:
    (int32 colours on ``device``, the colour count)."""
    colors = vertex_coloring(sp.csr_matrix(A_scipy), method="JP")
    out = np.full(n_pad, -1, dtype=np.int64)
    out[: len(colors)] = colors
    return (torch.as_tensor(out, dtype=torch.int32, device=device),
            int(colors.max()) + 1)


def _block_colors_for(A_scipy, bs, nb_pad, device):
    """JP colouring of the amalgamated node graph (one vertex per bs x bs
    block row), padded with -1 to nb_pad."""
    node_graph = (amalgamate(sp.csr_matrix(A_scipy), bs) if bs > 1
                  else sp.csr_matrix(A_scipy))
    return _colors_for(node_graph, nb_pad, device)


def _compile_smoother(lvl, spec, dtype, n_pad, device):
    """Map a resolved host smoother spec onto its device form (the
    reference's rules; sequential smoothers become their multicolour or
    Cimmino counterparts)."""
    A = lvl.A
    # keep the SAME object when already CSR so the spectral-radius caches
    # (_rho, _rho_D_inv) computed during host setup are reused
    Acsr = A if (sp.issparse(A) and A.format == "csr") else sp.csr_matrix(A)
    name, kwargs = spec if spec is not None else (None, {})
    kwargs = dict(kwargs or {})

    if name is None or name == "none":
        return device_relaxation.identity()

    iterations = int(kwargs.get("iterations", 1))

    def jacobi():
        omega = float(kwargs.get("omega", 1.0))
        if kwargs.get("withrho", True):
            omega = omega / rho_D_inv_A(Acsr)
        dinv = _device_dinv(Acsr, n_pad, dtype, device)
        return device_relaxation.jacobi(dinv, omega, iterations)

    def mcgs_or_chebyshev(sweep):
        """Multicolour GS, unless the level needs more than
        ``_MAX_GS_COLORS`` colours (each costs one SpMV): then Chebyshev
        of degree 4 on [rho / 30, 1.1 rho]."""
        colors, ncolors = _colors_for(Acsr, n_pad, device)
        if ncolors <= _MAX_GS_COLORS:
            dinv = _device_dinv(Acsr, n_pad, dtype, device)
            return device_relaxation.multicolor_gs(
                dinv, colors, ncolors, sweep=sweep, iterations=iterations)
        rho = approximate_spectral_radius(Acsr)
        coefficients = chebyshev_polynomial_coefficients(
            rho / 30.0, 1.1 * rho, 4)
        return device_relaxation.polynomial(coefficients, iterations)

    if name == "jacobi":
        return jacobi()

    if name in ("jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr"):
        # the Cimmino form: x += omega * A^T Dinv (b - A x) targets the
        # normal equations of the reference's sequential Kaczmarz sweeps
        if name != "jacobi_ne":
            warnings.warn(
                f"smoother '{name}' (sequential Kaczmarz) has no device "
                "form; substituting the parallel Jacobi normal-equation "
                "sweep (Cimmino) targeting the same normal equations")
        omega = float(kwargs.get("omega", 1.0))
        sq = Acsr.copy()
        sq.data = np.abs(sq.data) ** 2
        axis = 0 if name == "gauss_seidel_nr" else 1
        norm2 = np.asarray(sq.sum(axis=axis)).ravel()
        with np.errstate(divide="ignore", invalid="ignore"):
            dvals = np.where(norm2 != 0, 1.0 / norm2, 0.0)
        if name != "jacobi_ne":
            # Cimmino needs omega < 2 / rho(A^H D^-1 A): scale as withrho
            # Jacobi does, rho(A^H D^-1 A) = ||D^-1/2 A||_2^2
            scale = np.sqrt(np.where(dvals > 0, dvals, 0.0))
            B = (sp.diags(scale) @ Acsr if name == "gauss_seidel_ne"
                 else Acsr @ sp.diags(scale))
            rho_ne = approximate_spectral_radius((B.conj().T @ B).tocsr())
            omega = omega / max(rho_ne, 1e-300)
            if kwargs.get("sweep", "forward") == "symmetric":
                # a symmetric Kaczmarz sweep updates 2n rows, one Cimmino
                # pass n: doubling keeps the row-update budget
                iterations *= 2
        dinv = _device_vector(dvals, n_pad, dtype, device)
        if name == "gauss_seidel_nr":
            return device_relaxation.jacobi_nr(dinv, omega, iterations)
        return device_relaxation.jacobi_ne(dinv, omega, iterations)

    if name == "richardson":
        omega = float(kwargs.get("omega", 1.0))
        omega = omega / max(approximate_spectral_radius(Acsr), 1e-300)
        return device_relaxation.richardson(omega, iterations)

    if name in ("gauss_seidel", "sor"):
        return mcgs_or_chebyshev(kwargs.get("sweep", "forward"))

    if name in ("block_gauss_seidel", "block_jacobi"):
        bs = _blocksize(A, kwargs.get("blocksize"))
        sweep = kwargs.get("sweep", "forward")
        if bs == 1 or n_pad % bs != 0:
            return jacobi() if name == "block_jacobi" else mcgs_or_chebyshev(
                sweep)
        nb_pad = n_pad // bs
        if name == "block_gauss_seidel":
            colors, ncolors = _block_colors_for(A, bs, nb_pad, device)
            if ncolors > _MAX_GS_COLORS:
                return mcgs_or_chebyshev(sweep)
            return device_relaxation.block_multicolor_gs(
                _device_block_dinv(A, bs, nb_pad, dtype, device), colors,
                ncolors, sweep=sweep, iterations=iterations)
        omega = float(kwargs.get("omega", 1.0))
        if kwargs.get("withrho", True):
            omega = omega / rho_block_D_inv_A(
                Acsr, get_block_diag(A, bs, inv_flag=True))
        return device_relaxation.block_jacobi(
            _device_block_dinv(A, bs, nb_pad, dtype, device), omega,
            iterations)

    if name == "chebyshev":
        rho = approximate_spectral_radius(Acsr)
        lower = kwargs.get("lower_bound", 1.0 / 30.0)
        upper = kwargs.get("upper_bound", 1.1)
        degree = int(kwargs.get("degree", 3))
        coefficients = chebyshev_polynomial_coefficients(
            rho * lower, rho * upper, degree)
        return device_relaxation.polynomial(coefficients, iterations)

    if name == "polynomial":
        return device_relaxation.polynomial(kwargs["coefficients"],
                                            iterations)

    if name in ("cf_jacobi", "fc_jacobi", "cf_block_jacobi",
                "fc_block_jacobi"):
        splitting = getattr(lvl, "splitting", None)
        if splitting is None:
            raise ValueError(f"{name} requires lvl.splitting")
        splitting = np.asarray(splitting)
        bs = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
        # a node's mask covers its bs rows (the block forms too: the
        # reference compiles them to this masked point Jacobi)
        cmask = np.zeros(n_pad, dtype=bool)
        fmask = np.zeros(n_pad, dtype=bool)
        for mask, nodes in ((cmask, np.flatnonzero(splitting == 1)),
                            (fmask, np.flatnonzero(splitting == 0))):
            mask[(nodes[:, None] * bs + np.arange(bs)[None, :]).ravel()] = True
        cmask_t, fmask_t = (torch.as_tensor(m, device=device)
                            for m in (cmask, fmask))
        f_it = int(kwargs.get("f_iterations", 1))
        c_it = int(kwargs.get("c_iterations", 1))
        masks, iters = (((cmask_t, fmask_t), (c_it, f_it))
                        if name.startswith("cf")
                        else ((fmask_t, cmask_t), (f_it, c_it)))
        return device_relaxation.masked_jacobi(
            _device_dinv(Acsr, n_pad, dtype, device), masks, iters,
            omega=float(kwargs.get("omega", 1.0)), iterations=iterations)

    if name in ("schwarz", "strength_based_schwarz"):
        # contiguous sliding windows instead of the reference's
        # strength-based per-node subdomains (gather-free)
        warnings.warn(
            f"'{name}': substituting windowed overlapping Schwarz "
            "(contiguous sliding subdomains — the gather-free TPU form)")
        w = int(kwargs.get("window", 16))
        s = int(kwargs.get("stride", 8))
        if w % s != 0:
            raise ValueError("schwarz window must be a multiple of stride")
        if n_pad % s != 0:
            return mcgs_or_chebyshev(kwargs.get("sweep", "symmetric"))
        inv_blocks = _windowed_schwarz_blocks(Acsr, n_pad, w, s)
        return device_relaxation.windowed_schwarz(
            torch.as_tensor(inv_blocks, dtype=dtype, device=device), w, s,
            omega=float(kwargs.get("omega", 1.0)), iterations=iterations)

    warnings.warn(
        f"smoother '{name}' has no device form; substituting hybrid "
        "multicolor Gauss-Seidel (convergence-equivalent TPU smoother)")
    return mcgs_or_chebyshev(kwargs.get("sweep", "symmetric"))


def _windowed_schwarz_blocks(Acsr, n_pad, w, s):
    """Batched pseudo-inverses of the circular sliding-window subblocks
    A[i*s : i*s+w, i*s : i*s+w], built from the matrix diagonals."""
    n = Acsr.shape[0]
    nwin = n_pad // s
    blocks = np.zeros((nwin, w, w))
    for k in range(-(w - 1), w):
        dk = np.asarray(Acsr.diagonal(k)).ravel()
        if dk.size == 0:
            continue
        val = np.zeros(n_pad)
        if k >= 0:
            val[: n - k] = dk          # val[r] = A[r, r+k]
        else:
            val[-k: n] = dk            # val[r] = A[r, r+k], r >= |k|
        ext = np.concatenate([val, val[: w]])   # circular windows
        V = np.lib.stride_tricks.sliding_window_view(ext, w)[::s][:nwin]
        ps = np.arange(max(0, -k), min(w, w - k))
        blocks[:, ps, ps + k] = V[:, ps]
    return np.linalg.pinv(blocks)


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
        A_dev = None
        if (sp.issparse(lvl.A) and lvl.A.format == "bsr"
                and lvl.A.blocksize[0] == lvl.A.blocksize[1]
                and lvl.A.blocksize[0] > 1 and n > 2048
                and n_pad % lvl.A.blocksize[0] == 0):
            # the block smoothers then run on node blocks
            A_dev = block_dia_from_scipy(lvl.A, dtype=dtype, device=device,
                                         n_pad=n_pad, max_diags=600)
        if A_dev is None:
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
