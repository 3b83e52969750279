"""Smoother specs of the port's host SA setup (a copy of
``pyamg_tpu/relaxation/smoothing.py::rho_D_inv_A``, ``rho_block_D_inv_A``
and the spec half of ``change_smoothers``).  The port's hierarchy has no
host solve: a level keeps its resolved ``('name', kwargs)`` specs for the
device compile, and the setup computes the host caches the reference's
``_setup_*`` compute, so the compile reads the same spectral radii:
rho(D^-1 A) for a ``withrho`` Jacobi (cached on A as ``_rho_D_inv``),
rho(block-D^-1 A) for a ``withrho`` block Jacobi with a blocksize above 1
(``A._rho_block_D_inv``) and rho(A) for Richardson and Chebyshev
(``A._rho``).  Every name of the reference's table resolves; the C/F forms
raise the reference's ValueError on a level with no C/F splitting."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.linalg import approximate_spectral_radius
from ..util.utils import get_block_diag, get_diagonal

__all__ = ["change_smoothers", "rho_D_inv_A", "rho_block_D_inv_A"]


def rho_D_inv_A(A):
    """Spectral radius of D^-1 A, cached on A as ``_rho_D_inv`` (the SA
    prolongation smoother leaves its estimate there)."""
    cached = getattr(A, "_rho_D_inv", None)
    if cached is not None:
        return cached
    dinv = get_diagonal(A, inv=True)
    DinvA = sp.csr_matrix(A).copy()
    DinvA.data = DinvA.data * np.repeat(dinv, np.diff(DinvA.indptr))
    rho = approximate_spectral_radius(DinvA)
    try:
        A._rho_D_inv = rho
    except AttributeError:
        pass
    return rho


def _blockdiag_csr(blocks):
    """(n, bs, bs) stack -> its block-diagonal CSR matrix."""
    n, bs, _ = blocks.shape
    rows = np.arange(n)[:, None, None] * bs + np.arange(bs)[None, :, None]
    cols = np.arange(n)[:, None, None] * bs + np.arange(bs)[None, None, :]
    rows = np.broadcast_to(rows, (n, bs, bs)).ravel()
    cols = np.broadcast_to(cols, (n, bs, bs)).ravel()
    return sp.csr_matrix((blocks.ravel(), (rows, cols)),
                         shape=(n * bs, n * bs))


def rho_block_D_inv_A(A, Dinv):
    """Spectral radius of block-D^-1 A for the (n / bs, bs, bs) inverse
    diagonal blocks ``Dinv``, cached on A as ``_rho_block_D_inv``."""
    cached = getattr(A, "_rho_block_D_inv", None)
    if cached is not None:
        return cached
    DinvA = sp.csr_matrix(_blockdiag_csr(Dinv) @ sp.csr_matrix(A))
    rho = approximate_spectral_radius(DinvA)
    try:
        A._rho_block_D_inv = rho
    except AttributeError:
        pass
    return rho


def _unpack_spec(spec):
    if spec is None:
        return None, {}
    if isinstance(spec, str):
        return spec, {}
    if isinstance(spec, tuple):
        name, kwargs = spec
        return name, dict(kwargs)
    if callable(spec):
        return spec, {}
    raise ValueError(f"invalid smoother spec: {spec!r}")


def _blocksize(A, blocksize):
    if blocksize is None:
        return A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
    return int(blocksize)


def _setup_jacobi(lvl, withrho=True, **_):
    if withrho:
        rho_D_inv_A(lvl.A)


def _setup_rho(lvl, **_):
    approximate_spectral_radius(lvl.A)


def _setup_polynomial(lvl, coefficients=None, **_):
    if coefficients is None:
        raise ValueError("polynomial smoother requires coefficients")


def _setup_block_jacobi(lvl, blocksize=None, withrho=True, Dinv=None, **_):
    bs = _blocksize(lvl.A, blocksize)
    if bs == 1:
        _setup_jacobi(lvl, withrho=withrho)
        return
    if Dinv is None:
        # as the reference's setup: raises where the blocks do not tile A
        Dinv = get_block_diag(lvl.A, bs, inv_flag=True)
    if withrho:
        rho_block_D_inv_A(lvl.A, Dinv)


def _setup_block_gauss_seidel(lvl, blocksize=None, Dinv=None, **_):
    bs = _blocksize(lvl.A, blocksize)
    if bs != 1 and Dinv is None:
        get_block_diag(lvl.A, bs, inv_flag=True)


def _setup_cf(lvl, **_):
    if getattr(lvl, "splitting", None) is None:
        raise ValueError("cf/fc smoothers need lvl.splitting (run a "
                         "classical/AIR setup with keep of splitting)")


def _setup_nothing(lvl, **_):
    pass


# the reference's table of smoother names, each with the host cache its
# setup computes (the host closures themselves have no use here)
_SETUP = {
    "gauss_seidel": _setup_nothing,
    "jacobi": _setup_jacobi,
    "richardson": _setup_rho,
    "sor": _setup_nothing,
    "chebyshev": _setup_rho,
    "polynomial": _setup_polynomial,
    "block_jacobi": _setup_block_jacobi,
    "block_gauss_seidel": _setup_block_gauss_seidel,
    "jacobi_ne": _setup_nothing,
    "gauss_seidel_ne": _setup_nothing,
    "gauss_seidel_nr": _setup_nothing,
    "schwarz": _setup_nothing,
    "strength_based_schwarz": _setup_nothing,
    "cf_jacobi": _setup_cf,
    "fc_jacobi": _setup_cf,
    "cf_block_jacobi": _setup_cf,
    "fc_block_jacobi": _setup_cf,
    "gmres": _setup_nothing,
    "cg": _setup_nothing,
    "cgne": _setup_nothing,
    "cgnr": _setup_nothing,
    "none": _setup_nothing,
}


def _resolve(lvl, spec):
    """The level's ``(name, kwargs)`` record, after the host caches of the
    reference's setup of that smoother (see ``_SETUP``)."""
    name, kwargs = _unpack_spec(spec)
    if name is None:
        return (None, {})
    if callable(name):
        return (name, kwargs)
    if name not in _SETUP:
        raise ValueError(f"unknown smoother '{name}'")
    _SETUP[name](lvl, **kwargs)
    return (name, kwargs)


def change_smoothers(ml, presmoother, postsmoother):
    """Record pre/post smoother specs on every level but the coarsest
    (``presmoother_spec`` / ``postsmoother_spec``).  Accepts one spec or
    a per-level list; the last spec repeats for deeper levels."""
    if not isinstance(presmoother, list):
        presmoother = [presmoother]
    if not isinstance(postsmoother, list):
        postsmoother = [postsmoother]
    nlev = len(ml.levels) - 1
    for i, lvl in enumerate(ml.levels[:-1] if nlev > 0 else ml.levels):
        lvl.presmoother_spec = _resolve(
            lvl, presmoother[min(i, len(presmoother) - 1)])
        lvl.postsmoother_spec = _resolve(
            lvl, postsmoother[min(i, len(postsmoother) - 1)])
    return ml
