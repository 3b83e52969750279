"""Device smoothers (counterpart of ``pyamg_tpu/engine/relaxation.py``).

A :class:`DeviceSmoother` is a kind with its static scalars (``config``)
and its device tensors (``arrays``), applied by :func:`apply_smoother`
and, from a known-zero guess, :func:`apply_smoother_zero`, as the
reference's.  The kinds: ``identity``; weighted ``jacobi`` and
``jacobi_dyn`` (its weight a 0-d tensor on the device, as the
device-built hierarchy stores it); ``richardson`` and ``richardson_dyn``;
multicolour Gauss-Seidel ``mcgs`` (the parallel form of Gauss-Seidel and
SOR: the colours of a Jones-Plassmann colouring swept in order, every row
of one colour updated at once); the polynomial (Chebyshev) smoothers
``poly`` and ``poly_dyn`` (Horner on the residual); the Cimmino
normal-equation sweeps ``jacobi_ne`` and ``jacobi_nr`` (the parallel form
of the Kaczmarz smoothers); ``win_schwarz``, additive overlapping
Schwarz over contiguous sliding windows; and ``masked_jacobi``, Jacobi
sweeps restricted to ordered point sets (the C/F smoothers ``cf_jacobi``
and ``fc_jacobi``, AIR's post-smoother), each with its own sweep count;
and the block forms for operators of bs x bs node blocks: block Jacobi
``block_jacobi`` and ``block_jacobi_dyn`` (the weight a 0-d tensor, as
the device-built block setup stores it) and block multicolour
Gauss-Seidel ``block_mcgs`` (colours per node), each update the
(nb_pad, bs, bs) inverse diagonal blocks applied to the residual's node
blocks (:func:`_block_apply`, a product and a sum).

Every entry form takes one vector or a K-major (K, n_pad) lane stack for
x and b (the batched solve).  The kernels they run on a DIA operator:

- a Jacobi sweep is one K2 pass (:func:`~pyamg_tpu_torch.sparse.dia.
  dia_jacobi`; K9 for lanes), the zero-guess sweep plus its residual one
  K3 pass (K10), a sweep from a nonzero guess plus the residual of its
  result one K4 pass (K9 then K8 for lanes);
- a multicolour Gauss-Seidel call on one vector is one launch of the
  sweep kernel (:func:`~pyamg_tpu_torch.sparse.dia.dia_mcgs_sweep`,
  ``csrc/mcgs.cu``): every colour of each direction of every iteration, a
  colour phase updating only its own rows by ``x + 1 * (dinv * r)``, the
  reference's ``x + dinv * r``.  The smoother builds its colour plan (the
  rows sorted by colour, :func:`~pyamg_tpu_torch.sparse.dia.mcgs_plan`)
  on the device at its first call on a DIA operator, and keeps it.  On a
  lane stack a colour step is one K9 pass with omega 1 and that colour's
  inverse diagonal, ``where(colors == c, dinv, 0)``: inside the colour
  ``x + 1 * (dinv * r)``, outside it ``x + 0`` is ``x``; the smoother
  builds the (ncolors, n_pad) stack of those diagonals likewise;
- a masked Jacobi sweep is one K2 pass (K9) with ``where(mask, dinv,
  0)`` as its inverse diagonal: on the mask ``x + w * (dinv * r)`` is the
  reference's update, off it ``x + w * 0`` is ``x``.  The (nmasks, n_pad)
  stack is built as the colours' is;
- a Horner step ``h = c * r + A @ h`` is one K1 ``SPMV_ADD`` pass (K8
  ``add`` for lanes).

On any other operator (windowed, dense, row-sharded) the steps compose
through ``A @ x`` and a select, as the reference's.  Richardson's and the
Cimmino sweeps' updates compose through ``A @ x`` and ``A.rmatvec`` (the
roll form on a DIA operator, K7 or K13 on a windowed one, the sharded
transposes on a row-sharded one), and windowed Schwarz is slices, one
batched (nwin, w, w) product and the chunks' sums
(:func:`schwarz_corrections`: a right halo of r in, each window chunk's
spill out, through the ring of a row-sharded operator, wrapped onto the
rows of any other).

The block forms on a
:class:`~pyamg_tpu_torch.sparse.block_dia.BlockDIAMatrix` run B2
(``csrc/block_dia.cu``): the zero-guess block Jacobi sweep is one
``ZERO`` pass (on any operator: it reads only Dinv and b), a later sweep
one ``STEP`` pass, the single zero-guess sweep plus its residual one
``ZERO_RES`` pass (:meth:`DeviceSmoother.zero_call_residual`), and a
block multicolour Gauss-Seidel call on one vector one B3 launch
(:func:`~pyamg_tpu_torch.sparse.block_dia.block_mcgs_sweep`, by the
smoother's node colour plan), a colour step on lanes one ``COLOUR`` pass.
On any
other operator a sweep is the operator's residual (:func:`residual`:
one B1 halo ``RESID`` pass on a row-sharded block level, whose STEP and
ZERO_RES would read neighbouring ranks' nodes) and then the local block
update, one B2 ``ZERO`` pass on the residual, with the reference's
arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from ..sparse.block_dia import (BlockDIAMatrix, _block_apply,
                                block_colour_step, block_dia_resid,
                                block_jacobi_step, block_jacobi_zero,
                                block_jacobi_zero_res, block_mcgs_plan,
                                block_mcgs_sweep)
from ..sparse.dia import (DIAMatrix, dia_jacobi, dia_jacobi_k,
                          dia_jacobi_res, dia_jacobi_res_k,
                          dia_jacobi_zero_res, dia_jacobi_zero_res_k,
                          dia_mcgs_sweep, dia_spmm_add, dia_spmv_add,
                          mcgs_plan)
from ..sparse.formats import fit as _fit_len

__all__ = ["DeviceSmoother", "apply_smoother", "apply_smoother_zero",
           "block_jacobi", "block_jacobi_dyn", "block_multicolor_gs",
           "identity", "jacobi", "jacobi_dyn", "jacobi_ne", "jacobi_nr",
           "masked_jacobi", "multicolor_gs", "polynomial", "polynomial_dyn",
           "richardson",
           "richardson_dyn", "windowed_schwarz"]


@dataclass(frozen=True)
class DeviceSmoother:
    """kind + static scalars (``config``) and device tensors (``arrays``).

    A multicolour Gauss-Seidel smoother also holds ``color_dinv``, its
    (ncolors, n_pad) per-colour inverse diagonals, and a masked Jacobi
    smoother ``mask_dinv``, its (nmasks, n_pad) per-mask ones, each built
    from ``arrays`` on the device when first read (its first step on a
    DIA operator's lane stack, or its first sweep); a multicolour
    smoother (scalar or block) its colour plan for the operator of its
    last one-vector call (:meth:`plan`)."""

    config: Tuple
    arrays: Tuple

    @cached_property
    def color_dinv(self):
        """A multicolour smoother's per-colour inverse diagonals, else
        None."""
        if self.config[0] != "mcgs":
            return None
        dinv, colors = self.arrays
        cs = torch.arange(self.config[1], dtype=colors.dtype,
                          device=colors.device)
        return _dinv_stack(dinv, colors[None, :] == cs[:, None])

    @cached_property
    def mask_dinv(self):
        """A masked Jacobi smoother's per-mask inverse diagonals, else
        None."""
        if self.config[0] != "masked_jacobi":
            return None
        return _dinv_stack(self.arrays[0], torch.stack(self.arrays[1:]))

    def plan(self, A):
        """The colour plan of a multicolour smoother on A (a DIA operator
        for ``mcgs``, a block-DIA one for ``block_mcgs``), built on the
        device at the first call on A (one host read) and kept; None for
        any other kind or operator."""
        kind = self.config[0]
        if not ((kind == "mcgs" and isinstance(A, DIAMatrix))
                or (kind == "block_mcgs" and isinstance(A, BlockDIAMatrix))):
            return None
        kept = self.__dict__.get("_plan")
        if kept is None or kept[0] is not A:
            build = mcgs_plan if kind == "mcgs" else block_mcgs_plan
            kept = (A, build(A, self.arrays[1], self.config[1]))
            self.__dict__["_plan"] = kept
        return kept[1]

    def _stack(self, A):
        """The per-colour or per-mask stack where a colour step or a
        masked sweep is one K2 / K9 pass."""
        if not isinstance(A, DIAMatrix):
            return None
        if self.config[0] == "mcgs":
            return self.color_dinv
        return self.mask_dinv

    def _jacobi(self):
        """(dinv, omega, iterations) of a Jacobi smoother, else None."""
        kind = self.config[0]
        if kind == "jacobi":
            _, omega, iterations = self.config
            (dinv,) = self.arrays
        elif kind == "jacobi_dyn":
            _, iterations = self.config
            dinv, omega = self.arrays
        else:
            return None
        return dinv, omega, iterations

    def _forms(self, A, x):
        """apply_smoother's keyword arguments for A and an x of x.ndim
        axes: the colour plan of a one-vector multicolour call, else the
        per-colour or per-mask stack."""
        plan = self.plan(A) if x.ndim == 1 else None
        if plan is not None:
            return dict(plan=plan)
        return dict(dinv_stack=self._stack(A))

    def __call__(self, A, x, b):
        return apply_smoother(self.config, self.arrays, A, x, b,
                              **self._forms(A, x))

    def zero_call(self, A, b):
        """Apply with a known-zero initial guess: the first Jacobi or
        Richardson sweep collapses to a scaling of b, the first polynomial
        residual is b."""
        return apply_smoother_zero(self.config, self.arrays, A, b,
                                   **self._forms(A, b))

    def zero_call_residual(self, A, b):
        """(x, r) = (zero_call(A, b), b - A @ x) in one kernel pass when
        the smoother is a single Jacobi sweep on a DIA operator (K3, or
        K10 for a K-major lane stack b) or a single block Jacobi sweep on
        a block-DIA one (B2 ``ZERO_RES``); None otherwise (the caller
        composes)."""
        if isinstance(A, BlockDIAMatrix):
            if self.config[0] not in ("block_jacobi", "block_jacobi_dyn"):
                return None
            Dinv, omega, iterations = _block_jacobi_parts(self.config,
                                                          self.arrays)
            if (iterations != 1
                    or tuple(Dinv.shape) != (A.nb_pad, A.bs, A.bs)):
                return None
            return block_jacobi_zero_res(A, b, Dinv, omega)
        jac = self._jacobi()
        if not isinstance(A, DIAMatrix) or jac is None:
            return None
        dinv, omega, iterations = jac
        if iterations != 1 or dinv.shape[0] != b.shape[-1]:
            return None
        if b.ndim == 2:
            return dia_jacobi_zero_res_k(A, b, dinv, omega)
        return dia_jacobi_zero_res(A, b, dinv, omega)

    def call_residual(self, A, x, b):
        """(y, r) = (self(A, x, b), b - A @ y) in one kernel pass when the
        smoother is a single Jacobi sweep on a DIA operator (for lanes
        stacks, K9 then K8); None otherwise (the caller composes)."""
        jac = self._jacobi()
        if not isinstance(A, DIAMatrix) or jac is None:
            return None
        dinv, omega, iterations = jac
        if (iterations != 1 or dinv.shape[0] != b.shape[-1]
                or x.shape != b.shape):
            return None
        if b.ndim == 2:
            return dia_jacobi_res_k(A, x, b, dinv, omega)
        return dia_jacobi_res(A, x, b, dinv, omega)


def _dinv_stack(dinv, masks):
    """(len(masks), n_pad): dinv on each mask's rows, zero elsewhere."""
    return torch.where(masks, dinv[None, :],
                       torch.zeros((), dtype=dinv.dtype,
                                   device=dinv.device)).contiguous()


def identity():
    return DeviceSmoother(config=("identity",), arrays=())


def jacobi(dinv, omega, iterations=1):
    return DeviceSmoother(config=("jacobi", float(omega), int(iterations)),
                          arrays=(dinv,))


def richardson(omega, iterations=1):
    return DeviceSmoother(config=("richardson", float(omega),
                                  int(iterations)), arrays=())


def block_jacobi(Dinv, omega, iterations=1):
    return DeviceSmoother(config=("block_jacobi", float(omega),
                                  int(iterations)), arrays=(Dinv,))


def multicolor_gs(dinv, colors, ncolors, sweep="forward", iterations=1):
    """Multicolour Gauss-Seidel: ``colors`` int32 (n_pad,), -1 on padded
    rows, colours 0 .. ncolors - 1 swept forward, backward or both."""
    return DeviceSmoother(
        config=("mcgs", int(ncolors), str(sweep), int(iterations)),
        arrays=(dinv, colors))


def block_multicolor_gs(Dinv, colors, ncolors, sweep="forward",
                        iterations=1):
    """Block multicolour Gauss-Seidel: ``colors`` int32 (nb_pad,) per
    node, -1 on padded nodes; a colour step updates that colour's nodes
    by their inverse diagonal blocks ``Dinv`` (nb_pad, bs, bs)."""
    return DeviceSmoother(
        config=("block_mcgs", int(ncolors), str(sweep), int(iterations)),
        arrays=(Dinv, colors))


def polynomial(coefficients, iterations=1):
    coefficients = tuple(float(c) for c in np.asarray(coefficients))
    return DeviceSmoother(config=("poly", coefficients, int(iterations)),
                          arrays=())


def jacobi_dyn(dinv, omega, iterations=1):
    """Weighted Jacobi whose ``omega`` is a 0-d tensor on the device (the
    device-built setup computes it there from a spectral-radius estimate;
    the kernels read it by pointer, so no sweep syncs the host)."""
    return DeviceSmoother(config=("jacobi_dyn", int(iterations)),
                          arrays=(dinv, omega))


def richardson_dyn(omega, iterations=1):
    """Richardson with its weight a 0-d tensor on the device."""
    return DeviceSmoother(config=("richardson_dyn", int(iterations)),
                          arrays=(omega,))


def block_jacobi_dyn(Dinv, omega, iterations=1):
    """Block Jacobi whose ``omega`` is a 0-d tensor on the device (the
    device-built block setup's form of :func:`block_jacobi`)."""
    return DeviceSmoother(config=("block_jacobi_dyn", int(iterations)),
                          arrays=(Dinv, omega))


def polynomial_dyn(coefficients, iterations=1):
    """Polynomial (Chebyshev) smoother whose coefficients are a 1-d
    tensor on the device (its length, the degree, is static)."""
    return DeviceSmoother(config=("poly_dyn", int(iterations)),
                          arrays=(coefficients,))


def jacobi_ne(dinv_ne, omega, iterations=1):
    """Cimmino form of the NE (Kaczmarz) smoothers, Jacobi on A A^T y = b,
    x = A^T y: ``x += omega * A^T (dinv_ne * (b - A x))``, ``dinv_ne[i] =
    1 / ||A_i,:||^2`` (zero on padded rows)."""
    return DeviceSmoother(config=("jacobi_ne", float(omega),
                                  int(iterations)), arrays=(dinv_ne,))


def jacobi_nr(dinv_nr, omega, iterations=1):
    """Jacobi on the normal residual equations A^T A x = A^T b:
    ``x += omega * dinv_nr * (A^T (b - A x))``, ``dinv_nr[j] = 1 /
    ||A_:,j||^2`` (zero on padded columns)."""
    return DeviceSmoother(config=("jacobi_nr", float(omega),
                                  int(iterations)), arrays=(dinv_nr,))


def windowed_schwarz(inv_blocks, window, stride, omega=1.0, iterations=1):
    """Damped additive overlapping Schwarz over the circular sliding
    windows [i * stride, i * stride + window): ``inv_blocks`` (nwin,
    window, window) holds the windows' pseudo-inverses.  Each point lies
    in window / stride windows, so the update is damped by stride /
    window."""
    return DeviceSmoother(
        config=("win_schwarz", int(window), int(stride), float(omega),
                int(iterations)),
        arrays=(inv_blocks,))


def masked_jacobi(dinv, masks, iters_per_mask, omega=1.0, iterations=1):
    """Ordered masked Jacobi (the device cf/fc_jacobi): ``iterations``
    passes over the bool (n_pad,) ``masks`` in order, ``iters_per_mask``
    sweeps on each, a sweep updating only the rows of its mask."""
    return DeviceSmoother(
        config=("masked_jacobi", tuple(int(i) for i in iters_per_mask),
                float(omega), int(iterations)),
        arrays=(dinv,) + tuple(masks))


def _block_jacobi_parts(config, arrays):
    """(Dinv, omega, iterations) of a block Jacobi smoother."""
    if config[0] == "block_jacobi":
        _, omega, iterations = config
        (Dinv,) = arrays
    else:
        _, iterations = config
        Dinv, omega = arrays
    return Dinv, omega, iterations


def residual(A, x, b):
    """b - A @ x: one B1 ``RESID`` pass on a block-DIA operator, the
    operator's own one-pass form where it has one (a row-sharded block
    level's B1 halo ``RESID``), composed elsewhere."""
    if isinstance(A, BlockDIAMatrix):
        return block_dia_resid(A, x, b)
    own = getattr(A, "residual", None)
    if own is not None:
        return own(x, b)
    return b - (A @ x)


def _block_jacobi_step(A, x, b, Dinv, omega):
    if isinstance(A, BlockDIAMatrix):
        return block_jacobi_step(A, x, b, Dinv, omega)
    return x + block_jacobi_zero(Dinv, residual(A, x, b), omega)


def _jacobi_step(A, x, b, dinv, omega):
    if isinstance(A, DIAMatrix):
        if x.ndim == 2:
            return dia_jacobi_k(A, x, b, dinv, omega)
        return dia_jacobi(A, x, b, dinv, omega)
    return x + omega * (dinv * (b - (A @ x)))


def _horner_step(A, h, r, c):
    """c * r + A @ h (K1 ``SPMV_ADD`` or K8 ``add`` on a DIA operator)."""
    if isinstance(A, DIAMatrix):
        if h.ndim == 2:
            return dia_spmm_add(A, h, c * r)
        return dia_spmv_add(A, h, c * r)
    return c * r + (A @ h)


def _schwarz_update(A, inv_blocks, r, w, s):
    """Windowed Schwarz's summed window corrections for the residual r on
    A's rows: :func:`schwarz_corrections`, through the ring exchange of
    a row-sharded operator (its ``schwarz_update``), else wrapped onto
    r's own rows."""
    own = getattr(A, "schwarz_update", None)
    if own is not None:
        return own(inv_blocks, r, w, s)
    return schwarz_corrections(inv_blocks, r, w, s)


def _wrap(t, to_right):
    """The exchange of a ring of one: what is sent comes back."""
    return t


def schwarz_corrections(inv_blocks, r, w, s, send=_wrap):
    """Windowed Schwarz's summed window corrections for the rows of the
    residual r (a vector or a K-major lane stack) whose windows
    [i s, i s + w) start there: each window reads those rows and the
    first w - s rows to their right; its (w, w) pseudo-inverse's
    correction is summed into place, chunk c of every window at c s past
    its start, c ascending, and the chunks that land past the rows go to
    the right, each chunk's spill in its own row, added after the rows'
    own chunks in c order.  So every entry's chunks are summed in c order,
    as the reference's rolls sum them.  ``send(t, to_right)``: the
    exchange with the ring neighbours (t sent to one side, a tensor of
    its shape received from the other); by default a ring of one, whose
    windows wrap onto r's own rows, as often as they reach past them."""
    q, hw = w // s, w - s
    lead, n = tuple(r.shape[:-1]), r.shape[-1]
    nwin = inv_blocks.shape[0]
    if nwin * s != n:
        raise ValueError(f"windowed Schwarz: {nwin} windows of stride {s} "
                         f"on {n} rows")
    r_ext = r
    if hw:
        head = torch.cat([r] * -(-hw // n), dim=-1)[..., :hw]
        r_ext = torch.cat([r, send(head, False)], dim=-1)
    Wn = torch.cat([r_ext[..., c * s:c * s + n].reshape(lead + (nwin, s))
                    for c in range(q)], dim=-1)
    u = torch.einsum("nij,...nj->...ni", inv_blocks, Wn)
    chunks = [u[..., c * s:(c + 1) * s].reshape(lead + (-1,))
              for c in range(q)]
    upd = torch.zeros_like(r)
    for c in range(q):
        if c * s < n:
            upd[..., c * s:] = upd[..., c * s:] + chunks[c][..., :n - c * s]
    if hw:
        spill = torch.zeros(lead + (q - 1, hw), dtype=r.dtype,
                            device=r.device)
        for c in range(1, q):
            lo = max(n - c * s, 0)
            spill[..., c - 1, lo + c * s - n:c * s] = chunks[c][..., lo:]
        got = send(spill, True)
        for c in range(1, q):
            for k in range(0, hw, n):
                m = min(n, hw - k)
                upd[..., :m] = upd[..., :m] + got[..., c - 1, k:k + m]
    return upd


def _coefficient_list(config, arrays):
    """A polynomial smoother's coefficients: floats, or 0-d tensors."""
    if config[0] == "poly":
        return list(config[1])
    (coefficients,) = arrays
    return [coefficients[c] for c in range(coefficients.shape[0])]


def _sweeps(ncolors, sweep):
    order = []
    if sweep in ("forward", "symmetric"):
        order += list(range(ncolors))
    if sweep in ("backward", "symmetric"):
        order += list(range(ncolors - 1, -1, -1))
    return order


def apply_smoother_zero(config, arrays, A, b, dinv_stack=None, plan=None):
    """apply_smoother with x = 0: the first sweep collapses (a Jacobi or
    Richardson sweep to a scaling of b, the first polynomial residual to
    b); the remaining sweeps run the general form."""
    kind = config[0]

    if kind == "identity":
        return torch.zeros_like(b)

    if kind in ("jacobi", "jacobi_dyn"):
        if kind == "jacobi":
            _, omega, iterations = config
            (dinv,) = arrays
        else:
            _, iterations = config
            dinv, omega = arrays
        x = omega * (dinv * b)
        for _ in range(iterations - 1):
            x = _jacobi_step(A, x, b, dinv, omega)
        return x

    if kind in ("richardson", "richardson_dyn"):
        if kind == "richardson":
            _, omega, iterations = config
        else:
            _, iterations = config
            (omega,) = arrays
        x = omega * b
        for _ in range(iterations - 1):
            x = x + omega * (b - (A @ x))
        return x

    if kind in ("block_jacobi", "block_jacobi_dyn"):
        Dinv, omega, iterations = _block_jacobi_parts(config, arrays)
        x = block_jacobi_zero(Dinv, b, omega)
        for _ in range(iterations - 1):
            x = _block_jacobi_step(A, x, b, Dinv, omega)
        return x

    if kind in ("poly", "poly_dyn"):
        coefficients = _coefficient_list(config, arrays)
        h = coefficients[0] * b
        for c in coefficients[1:]:
            h = _horner_step(A, h, b, c)
        iterations = config[-1]
        if iterations > 1:
            rest = config[:-1] + (iterations - 1,)
            h = apply_smoother(rest, arrays, A, h, b)
        return h

    return apply_smoother(config, arrays, A, torch.zeros_like(b), b,
                          dinv_stack=dinv_stack, plan=plan)


def apply_smoother(config, arrays, A, x, b, dinv_stack=None, plan=None):
    """The smoother ``config``/``arrays`` applied to (A, x, b); x and b
    are vectors or K-major (K, n_pad) lane stacks.  ``dinv_stack``: a
    multicolour smoother's per-colour stack (``DeviceSmoother.color_dinv``)
    or a masked Jacobi smoother's per-mask one (``mask_dinv``) on a DIA
    operator, where each colour step or masked sweep is then one K2 / K9
    pass; ``plan``: a multicolour smoother's colour plan
    (:meth:`DeviceSmoother.plan`) for a one-vector call on a DIA (block-DIA)
    operator, which is then one sweep launch; without either the steps
    compose, as the reference's."""
    kind = config[0]

    if kind == "identity":
        return x

    if kind in ("jacobi", "jacobi_dyn"):
        if kind == "jacobi":
            _, omega, iterations = config
            (dinv,) = arrays
        else:
            _, iterations = config
            dinv, omega = arrays
        for _ in range(iterations):
            x = _jacobi_step(A, x, b, dinv, omega)
        return x

    if kind in ("richardson", "richardson_dyn"):
        if kind == "richardson":
            _, omega, iterations = config
        else:
            _, iterations = config
            (omega,) = arrays
        for _ in range(iterations):
            x = x + omega * (b - (A @ x))
        return x

    if kind == "mcgs":
        _, ncolors, sweep, iterations = config
        dinv, colors = arrays
        if plan is not None:
            return dia_mcgs_sweep(A, x, b, dinv, plan,
                                  _sweeps(ncolors, sweep) * iterations)
        if dinv_stack is not None:
            for _ in range(iterations):
                for c in _sweeps(ncolors, sweep):
                    x = _jacobi_step(A, x, b, dinv_stack[c], 1.0)
            return x
        for _ in range(iterations):
            for c in _sweeps(ncolors, sweep):
                r = b - (A @ x)
                x = torch.where(colors == c, x + dinv * r, x)
        return x

    if kind in ("block_jacobi", "block_jacobi_dyn"):
        Dinv, omega, iterations = _block_jacobi_parts(config, arrays)
        for _ in range(iterations):
            x = _block_jacobi_step(A, x, b, Dinv, omega)
        return x

    if kind == "block_mcgs":
        _, ncolors, sweep, iterations = config
        Dinv, colors = arrays
        if plan is not None:
            return block_mcgs_sweep(A, x, b, Dinv, plan,
                                    _sweeps(ncolors, sweep) * iterations)
        if isinstance(A, BlockDIAMatrix):
            for _ in range(iterations):
                for c in _sweeps(ncolors, sweep):
                    x = block_colour_step(A, x, b, Dinv, colors, c)
            return x
        bs = Dinv.shape[-1]
        nodes = x.shape[:-1] + (-1, bs)
        for _ in range(iterations):
            for c in _sweeps(ncolors, sweep):
                upd = x + block_jacobi_zero(Dinv, residual(A, x, b), 1.0)
                x = torch.where((colors == c)[:, None], upd.reshape(nodes),
                                x.reshape(nodes)).reshape(x.shape)
        return x

    if kind in ("poly", "poly_dyn"):
        coefficients = _coefficient_list(config, arrays)
        for _ in range(config[-1]):
            r = b - (A @ x)
            h = coefficients[0] * r
            for c in coefficients[1:]:
                h = _horner_step(A, h, r, c)
            x = x + h
        return x

    if kind == "jacobi_ne":
        _, omega, iterations = config
        (dinv,) = arrays
        for _ in range(iterations):
            upd = A.rmatvec(dinv * (b - (A @ x)))
            x = x + omega * _fit_len(upd, x.shape[-1])
        return x

    if kind == "jacobi_nr":
        _, omega, iterations = config
        (dinv,) = arrays
        for _ in range(iterations):
            upd = A.rmatvec(b - (A @ x))
            x = x + omega * (dinv * _fit_len(upd, x.shape[-1]))
        return x

    if kind == "win_schwarz":
        _, w, s, omega, iterations = config
        (inv_blocks,) = arrays
        for _ in range(iterations):
            r = b - (A @ x)
            x = x + (omega / (w // s)) * _schwarz_update(A, inv_blocks, r,
                                                         w, s)
        return x

    if kind == "masked_jacobi":
        _, iters_per_mask, omega, iterations = config
        dinv, masks = arrays[0], arrays[1:]
        for _ in range(iterations):
            for m, (mask, k) in enumerate(zip(masks, iters_per_mask)):
                for _ in range(k):
                    if dinv_stack is not None:
                        x = _jacobi_step(A, x, b, dinv_stack[m], omega)
                    else:
                        r = b - (A @ x)
                        x = torch.where(mask, x + omega * dinv * r, x)
        return x

    raise ValueError(f"unknown device smoother kind {kind!r}")
