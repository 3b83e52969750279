"""Smoother specs of the port's host SA setup (a copy of
``pyamg_tpu/relaxation/smoothing.py::rho_D_inv_A`` and the spec half of
``change_smoothers``).  The port's hierarchy has no host solve: a level
keeps its resolved ``('name', kwargs)`` specs for the device compile,
and a Jacobi spec's spectral radius is computed (and cached on A) here,
as the reference's smoother setup does.  Smoothers other than Jacobi are
ROADMAP.md Queue 1 item 8."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.linalg import approximate_spectral_radius
from ..util.utils import get_diagonal

__all__ = ["change_smoothers", "rho_D_inv_A"]


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


def _unpack_spec(spec):
    if spec is None:
        return None, {}
    if isinstance(spec, str):
        return spec, {}
    if isinstance(spec, tuple):
        name, kwargs = spec
        return name, dict(kwargs)
    raise ValueError(f"invalid smoother spec: {spec!r}")


def _resolve(lvl, spec):
    """The level's ``(name, kwargs)`` record; a Jacobi spec with
    ``withrho`` computes rho(D^-1 A) now, as the reference's setup does."""
    name, kwargs = _unpack_spec(spec)
    if name is None:
        return (None, {})
    if name == "none":
        return (name, kwargs)
    if name != "jacobi":
        raise NotImplementedError(
            f"smoother {name!r} is not ported to pyamg_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 8)")
    if kwargs.get("withrho", True):
        rho_D_inv_A(lvl.A)
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
