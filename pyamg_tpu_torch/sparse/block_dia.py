"""Block-DIA device format: BSR operators on a node grid (counterpart of
``pyamg_tpu/sparse/block_dia.py``).

A BSR operator on a lexicographic node grid is block-banded, so it is
stored by block diagonal: ``data[d, i] = A_block[i, i + offsets[d]]``
(bs x bs; a zero block where A has none or the column falls outside the
matrix), offsets in block units, and applied as

    y_blk[i] = sum_d data[d, i] @ x_blk[i + offsets[d]]

The reference applies it with one roll and bs^2 elementwise mul-adds per
diagonal (its TPU vectorizes those).  Here it runs through hand-written
CUDA kernels (``csrc/block_dia.cu``), one pass each, no temporary:

- :func:`block_dia_apply`      y = A x                        (B1 ``PLAIN``)
- :func:`block_dia_resid`      b - A x                        (B1 ``RESID``)
- :func:`block_jacobi_zero`    w Dinv b, node block by node block
                                                              (B2 ``ZERO``)
- :func:`block_jacobi_zero_res` (w Dinv b, b - A (w Dinv b))  (B2 ``ZERO_RES``)
- :func:`block_jacobi_step`    x + w Dinv (b - A x)           (B2 ``STEP``)
- :func:`block_colour_step`    x + Dinv (b - A x) on the nodes of one
                               colour, x elsewhere            (B2 ``COLOUR``)
- :func:`block_mcgs_sweep`     a block multicolour Gauss-Seidel smoother
                               call, every colour step in one launch (B3)

x and b are vectors (n_pad,) or K-major (K, n_pad) lane stacks (B3 takes
one vector); Dinv is the (nb_pad, bs, bs) inverse diagonal blocks,
colours int32 (nb_pad,).  B3 runs by a colour plan of the nodes
(:func:`block_mcgs_plan`, the scalar sweep's
:class:`~pyamg_tpu_torch.sparse.dia.MCGSPlan` over nodes).

No Pallas kernel stands behind this format in the reference (its block
algebra is plain ``jnp``), so these replace none; they exist because the
same algebra composed from PyTorch ops took five launches an apply and
four times the bytes.  Each has a plain PyTorch twin (``*_ref``) in this
module, which a wrapper runs only when its operands lie on the CPU; on
CUDA tensors it launches the kernel or raises.  The apply's twin pads x
by the largest offset on both sides, reads each run of consecutive
offsets (a 9-point node stencil has three) as one strided view of
overlapping windows, lays the runs side by side with one ``cat``, so row
i holds its (ndiags * bs) neighbour values in diagonal order, and takes
one product with ``data`` laid out as (nb_pad, bs, ndiags * bs) row
strips and one sum over the strip.  The padding stands for the
reference's roll: a block that falls outside the matrix is stored as
zero, so the neighbour it meets (a wrapped one there, a padded zero here)
contributes exactly zero; the kernels skip such a neighbour.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .. import _build
from .dia import (_KERNEL_DTYPES, MCGSPlan, _omega_args, _ptr,
                  _same_colour_coupling, _sweep_chunks, _sweep_order,
                  colour_plan)

__all__ = ["BlockDIAMatrix", "block_dia_from_scipy", "block_dia_apply",
           "block_dia_resid", "block_jacobi_zero", "block_jacobi_zero_res",
           "block_jacobi_step", "block_colour_step", "block_dia_spmv_ref",
           "block_dia_resid_ref", "block_jacobi_zero_ref",
           "block_jacobi_zero_res_ref", "block_jacobi_step_ref",
           "block_colour_step_ref", "block_mcgs_plan", "block_mcgs_sweep",
           "block_mcgs_sweep_ref"]

# modes of csrc/block_dia.cu: block_dia_spmv_kernel (B1) and
# block_dia_jacobi_kernel (B2)
_PLAIN, _RESID = 0, 1
_ZERO, _ZERO_RES, _STEP, _COLOUR = 0, 1, 2, 3


@dataclass(frozen=True)
class BlockDIAMatrix:
    """Block-diagonal-stored BSR matrix over padded vectors: a vector of
    length ``n_pad`` is ``nb_pad`` node blocks of ``bs`` components."""

    data: torch.Tensor           # (ndiags, nb_pad, bs, bs)
    offsets: Tuple[int, ...]     # ascending, block units
    shape: Tuple[int, int]       # logical scalar shape
    bs: int
    nnz: int

    @property
    def nb_pad(self):
        return self.data.shape[1]

    @cached_property
    def offsets_t(self) -> torch.Tensor:
        """The offsets as an int32 tensor beside ``data`` (kernel input)."""
        return torch.tensor(self.offsets, dtype=torch.int32,
                            device=self.data.device)

    @property
    def n_pad(self):
        return self.data.shape[1] * self.bs

    @property
    def ndiags(self):
        return len(self.offsets)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @cached_property
    def runs(self) -> Tuple[Tuple[int, int], ...]:
        """The offsets as runs of consecutive values: (first, length)."""
        return _offset_runs(self.offsets)

    @property
    def halo(self):
        """The largest |offset|, in blocks: the zero padding of x."""
        return max((abs(o) for o in self.offsets), default=0)

    @cached_property
    def row_strips(self) -> torch.Tensor:
        """(nb_pad, bs, ndiags * bs): row i's blocks side by side,
        ``[i, p, d * bs + q] = data[d, i, p, q]`` (the CPU twin's layout;
        the kernels read ``data`` as it is)."""
        nd, nb, bs, _ = self.data.shape
        return self.data.permute(1, 2, 0, 3).reshape(nb, bs, nd * bs
                                                     ).contiguous()

    @cached_property
    def T(self) -> "BlockDIAMatrix":
        """A^T as a BlockDIAMatrix: offsets negated, blocks transposed,
        rows rolled (block row i of A^T at offset p holds A's block (i + p,
        i) transposed)."""
        lookup = {o: d for d, o in enumerate(self.offsets)}
        offs = tuple(sorted(-o for o in self.offsets))
        data = torch.stack([torch.roll(
            self.data[lookup[-p]].transpose(-1, -2), -p, dims=0)
            for p in offs]) if offs else self.data
        return BlockDIAMatrix(data=data.contiguous(), offsets=offs,
                              shape=(self.shape[1], self.shape[0]),
                              bs=self.bs, nnz=self.nnz)

    def matvec(self, x):
        return block_dia_apply(self, x)

    def matmat(self, X):
        """Y = A @ X for a column stack X (n_pad, K), the reference's
        layout (the coarse densify's), as a K-major stack."""
        return block_dia_apply(self, X.T.contiguous()).T

    def rmatvec(self, x):
        """A^T @ x (a vector or a K-major lane stack), through :attr:`T`."""
        return block_dia_apply(self.T, x)

    def __matmul__(self, x):
        """A @ x for a vector, or lane by lane for a K-major (K, n_pad)
        stack."""
        if x.ndim not in (1, 2):
            raise ValueError(f"BlockDIAMatrix applies to a vector or a (K, "
                             f"n_pad) stack, got shape {tuple(x.shape)}")
        return block_dia_apply(self, x)

    def diagonal(self):
        """The scalar diagonal as a padded vector."""
        if 0 in self.offsets:
            return torch.diagonal(self.data[self.offsets.index(0)], dim1=1,
                                  dim2=2).reshape(-1)
        return torch.zeros(self.n_pad, dtype=self.dtype, device=self.device)

    def block_diagonal(self):
        """(nb_pad, bs, bs) diagonal blocks (the block smoothers')."""
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros((self.nb_pad, self.bs, self.bs), dtype=self.dtype,
                           device=self.device)


def _offset_runs(offsets):
    """Ascending offsets as runs of consecutive values: (first, length)."""
    out = []
    for o in offsets:
        if out and out[-1][0] + out[-1][1] == o:
            out[-1][1] += 1
        else:
            out.append([o, 1])
    return tuple((o, n) for o, n in out)


# -- the plain PyTorch twins -------------------------------------------------

def block_dia_spmv_ref(A: BlockDIAMatrix, x):
    """A @ x for a vector (n_pad,) or a K-major stack (K, n_pad): pad, the
    runs' windows side by side, one product and one sum over each row's
    strip."""
    nb, bs, nd = A.nb_pad, A.bs, A.ndiags
    if x.shape[-1] != nb * bs:
        raise ValueError(f"BlockDIAMatrix with n_pad {nb * bs} applied to "
                         f"length {x.shape[-1]}")
    if nd == 0:
        return torch.zeros_like(x)
    lead = tuple(x.shape[:-1])
    h = A.halo * bs
    xp = F.pad(x, (h, h))                       # contiguous
    m = xp.shape[-1]
    lead_strides = tuple(int(np.prod(lead[i + 1:])) * m
                         for i in range(len(lead)))
    views = [xp.as_strided(lead + (nb, length * bs),
                           lead_strides + (bs, 1),
                           xp.storage_offset() + h + first * bs)
             for first, length in A.runs]
    xg = views[0] if len(views) == 1 else torch.cat(views, dim=-1)
    y = torch.sum(A.row_strips * xg.unsqueeze(-2), dim=-1)
    return y.reshape(lead + (nb * bs,))


def _block_apply(Dinv, r2):
    """The (nb, bs, bs) blocks applied to the (nb, bs) node blocks of a
    vector, or of each lane of a (K, nb, bs) stack: one elementwise
    product and one sum over the block row (a batched GEMM library call
    splits a million tiny products into many launches)."""
    return torch.sum(Dinv * r2.unsqueeze(-2), dim=-1)


def _block_update(Dinv, r):
    """Dinv applied node block by node block to r (a vector or a K-major
    lane stack), in r's layout."""
    bs = Dinv.shape[-1]
    return _block_apply(Dinv, r.reshape(r.shape[:-1] + (-1, bs))).reshape(
        r.shape)


def block_dia_resid_ref(A: BlockDIAMatrix, x, b):
    return b - block_dia_spmv_ref(A, x)


def block_jacobi_zero_ref(Dinv, b, omega):
    return omega * _block_update(Dinv, b)


def block_jacobi_zero_res_ref(A: BlockDIAMatrix, b, Dinv, omega):
    x = block_jacobi_zero_ref(Dinv, b, omega)
    return x, b - block_dia_spmv_ref(A, x)


def block_jacobi_step_ref(A: BlockDIAMatrix, x, b, Dinv, omega):
    return x + omega * _block_update(Dinv, b - block_dia_spmv_ref(A, x))


def block_colour_step_ref(A: BlockDIAMatrix, x, b, Dinv, colors, colour):
    bs = Dinv.shape[-1]
    nodes = x.shape[:-1] + (-1, bs)
    xb = x.reshape(nodes)
    upd = xb + _block_apply(Dinv, (b - block_dia_spmv_ref(A, x)).reshape(
        nodes))
    return torch.where((colors == colour)[:, None], upd, xb).reshape(
        x.shape)


def block_mcgs_sweep_ref(A: BlockDIAMatrix, x, b, Dinv, plan, order):
    """The colour steps of ``order`` one after another, each B2 COLOUR's
    twin (the parent chain's form)."""
    for c in order:
        x = block_colour_step_ref(A, x, b, Dinv, plan.colors, c)
    return x


def _runtime_block_size(A: BlockDIAMatrix, Dinv):
    """Whether B2 and B3 take the run-time block size instance for A and
    Dinv (csrc/block_dia.cu, dispatch): bs beyond 4, or a block of 16-byte
    words whose storage does not start 16-byte aligned."""
    words = A.bs * A.bs * A.data.element_size() % 16 == 0
    aligned = A.data.data_ptr() % 16 == 0 and Dinv.data_ptr() % 16 == 0
    return A.bs > 4 or (words and not aligned)


def block_mcgs_plan(A: BlockDIAMatrix, colors, ncolors):
    """The node colour plan of a block multicolour smoother (int32
    ``colors`` (nb_pad,), -1 on padded nodes) on A: staged where a stored
    nonzero block of A couples two nodes of one colour (the amalgamated
    node pattern's JP colouring of a symmetric operator never does), or
    where B3 takes the run-time block size, whose threads own a component
    each."""
    if colors.shape != (A.nb_pad,) or colors.dtype != torch.int32:
        raise ValueError(f"colors: expected int32 ({A.nb_pad},), got "
                         f"{colors.dtype} {tuple(colors.shape)}")
    nonzero = (A.data != 0).flatten(2).any(-1)           # (nd, nb_pad)
    coupled = _same_colour_coupling(colors, A.offsets,
                                    lambda d, lo, hi: nonzero[d, lo:hi])
    runtime = A.bs > 4
    return colour_plan(colors, ncolors, coupled | runtime,
                       A.n_pad * A.data.element_size(),
                       A.bs if runtime else 1)


# -- the kernel wrappers ------------------------------------------------------
#
# Each checks its operands on either device (float32 or float64 throughout,
# contiguous, the operator's shapes) and raises on anything else; then it
# runs its twin for CPU tensors, or launches its kernel for CUDA tensors.

def _check_operand(name, v, dtype, shape):
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(v.shape)}")
    if v.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_vectors(n, dtype, x, **others):
    """x a vector (n,) or a K-major (K, n) stack, the others of x's shape,
    every one ``dtype`` and contiguous."""
    if x.ndim not in (1, 2) or x.shape[-1] != n:
        raise ValueError(f"x: expected shape ({n},) or (K, {n}), got "
                         f"{tuple(x.shape)}")
    _check_operand("x", x, dtype, x.shape)
    for name, v in others.items():
        _check_operand(name, v, dtype, x.shape)


def _check_matrix(A: BlockDIAMatrix):
    if not isinstance(A, BlockDIAMatrix):
        raise TypeError(f"expected a BlockDIAMatrix, got {type(A).__name__}")
    if A.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"block-DIA kernel takes float32 or float64, not "
                        f"{A.dtype}")
    _check_operand("A.data", A.data, A.dtype,
                   (A.ndiags, A.nb_pad, A.bs, A.bs))


def _lanes(v, k0, k1):
    """Lanes [k0, k1) of a stack (the whole of a vector), or None."""
    if v is None:
        return None
    return (v if v.ndim == 1 else v[k0:k1]).data_ptr()


def _launch(kernel, mode, dtype, device, nb, bs, A, x, b, outputs,
            shared=()):
    """Launch B1 (``kernel`` "block_dia_spmv") or B2 ("block_dia_jacobi")
    over the lanes of the outputs in chunks of at most MAX_LANES, one
    count a launch (a thread of the kernel serves every lane of a chunk,
    each block read once for a lane tile).  ``shared``: B2's arguments between b and the
    outputs (Dinv, the weight, the colours and the colour)."""
    suffix, _ = _KERNEL_DTYPES[dtype]
    fn_name = f"pyamg_{kernel}_{suffix}"
    fn = getattr(_build.library(), fn_name)
    stream = torch.cuda.current_stream(device).cuda_stream
    data = None if A is None else A.data.data_ptr()
    offsets = None if A is None else A.offsets_t.data_ptr()
    nd = 0 if A is None else A.ndiags
    y = outputs[0]
    for k0, k1 in _build.lane_chunks(1 if y.ndim == 1 else y.shape[0]):
        err = fn(data, offsets, nd, nb, bs, k1 - k0, _lanes(x, k0, k1),
                 _lanes(b, k0, k1), *shared,
                 *(_lanes(v, k0, k1) for v in outputs), mode, stream)
        _build.check(fn_name, err)
        _build.count_launch(f"{kernel}.{_build.dtype_name(dtype)}")


def _jacobi_shared(Dinv, omega, colors=None, colour=0):
    """B2's shared arguments: Dinv, the weight by value or by pointer to
    a 0-d device tensor, the colours and the colour."""
    w, w_dev = _omega_args(omega, Dinv, _KERNEL_DTYPES[Dinv.dtype][1])
    return (Dinv.data_ptr(), w, w_dev,
            None if colors is None else colors.data_ptr(), int(colour))


def block_dia_apply(A: BlockDIAMatrix, x):
    """y = A @ x for a vector (n_pad,) or a K-major stack (K, n_pad): one
    B1 pass (``PLAIN``)."""
    cpu = _build.on_cpu(A.data, x)
    _check_matrix(A)
    _check_vectors(A.n_pad, A.dtype, x)
    if cpu:
        return block_dia_spmv_ref(A, x)
    y = torch.empty_like(x)
    _launch("block_dia_spmv", _PLAIN, A.dtype, A.device, A.nb_pad, A.bs, A,
            x, None, (y,))
    return y


def block_dia_resid(A: BlockDIAMatrix, x, b):
    """b - A @ x in one B1 pass (``RESID``)."""
    cpu = _build.on_cpu(A.data, x, b)
    _check_matrix(A)
    _check_vectors(A.n_pad, A.dtype, x, b=b)
    if cpu:
        return block_dia_resid_ref(A, x, b)
    y = torch.empty_like(x)
    _launch("block_dia_spmv", _RESID, A.dtype, A.device, A.nb_pad, A.bs, A,
            x, b, (y,))
    return y


def block_jacobi_zero(Dinv, b, omega):
    """The zero-guess block Jacobi sweep omega * Dinv b, node block by
    node block, in one B2 pass (``ZERO``; no operator is read)."""
    cpu = _build.on_cpu(Dinv, b)
    if Dinv.ndim != 3:
        raise ValueError(f"Dinv: expected shape (nb, bs, bs), got "
                         f"{tuple(Dinv.shape)}")
    if Dinv.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"block-DIA kernel takes float32 or float64, not "
                        f"{Dinv.dtype}")
    nb, bs = Dinv.shape[0], Dinv.shape[-1]
    _check_operand("Dinv", Dinv, Dinv.dtype, (nb, bs, bs))
    _check_vectors(nb * bs, Dinv.dtype, b)
    if cpu:
        return block_jacobi_zero_ref(Dinv, b, omega)
    y = torch.empty_like(b)
    _launch("block_dia_jacobi", _ZERO, Dinv.dtype, Dinv.device, nb, bs,
            None, None, b, (y, None), _jacobi_shared(Dinv, omega))
    return y


def block_jacobi_zero_res(A: BlockDIAMatrix, b, Dinv, omega):
    """(x, b - A x), x = omega * Dinv b, in one B2 pass (``ZERO_RES``):
    each neighbour's x is recomputed from its Dinv block and b, so x is
    written once and never read back."""
    cpu = _build.on_cpu(A.data, b, Dinv)
    _check_matrix(A)
    _check_operand("Dinv", Dinv, A.dtype, (A.nb_pad, A.bs, A.bs))
    _check_vectors(A.n_pad, A.dtype, b)
    if cpu:
        return block_jacobi_zero_res_ref(A, b, Dinv, omega)
    x, r = torch.empty_like(b), torch.empty_like(b)
    _launch("block_dia_jacobi", _ZERO_RES, A.dtype, A.device, A.nb_pad,
            A.bs, A, None, b, (x, r), _jacobi_shared(Dinv, omega))
    return x, r


def block_jacobi_step(A: BlockDIAMatrix, x, b, Dinv, omega):
    """One block Jacobi sweep x + omega * Dinv (b - A x) in one B2 pass
    (``STEP``)."""
    cpu = _build.on_cpu(A.data, x, b, Dinv)
    _check_matrix(A)
    _check_operand("Dinv", Dinv, A.dtype, (A.nb_pad, A.bs, A.bs))
    _check_vectors(A.n_pad, A.dtype, x, b=b)
    if cpu:
        return block_jacobi_step_ref(A, x, b, Dinv, omega)
    y = torch.empty_like(x)
    _launch("block_dia_jacobi", _STEP, A.dtype, A.device, A.nb_pad, A.bs, A,
            x, b, (y, None), _jacobi_shared(Dinv, omega))
    return y


def block_colour_step(A: BlockDIAMatrix, x, b, Dinv, colors, colour):
    """One block multicolour Gauss-Seidel step: x + Dinv (b - A x) on the
    nodes whose ``colors`` entry is ``colour``, x elsewhere, in one B2
    pass (``COLOUR``; the other nodes read no operator data)."""
    cpu = _build.on_cpu(A.data, x, b, Dinv, colors)
    _check_matrix(A)
    _check_operand("Dinv", Dinv, A.dtype, (A.nb_pad, A.bs, A.bs))
    _check_vectors(A.n_pad, A.dtype, x, b=b)
    _check_operand("colors", colors, torch.int32, (A.nb_pad,))
    if cpu:
        return block_colour_step_ref(A, x, b, Dinv, colors, colour)
    y = torch.empty_like(x)
    _launch("block_dia_jacobi", _COLOUR, A.dtype, A.device, A.nb_pad, A.bs,
            A, x, b, (y, None), _jacobi_shared(Dinv, 1.0, colors, colour))
    return y


def block_mcgs_sweep(A: BlockDIAMatrix, x, b, Dinv, plan: MCGSPlan, order):
    """A block multicolour Gauss-Seidel smoother call on one vector: for
    each colour c of ``order``, x + Dinv (b - A x) on the nodes of colour
    c, in one B3 launch by ``plan`` (:func:`block_mcgs_plan`), each node B2
    ``COLOUR``'s bits.  The caller's x is not changed."""
    cpu = _build.on_cpu(A.data, x, b, Dinv, plan.rows)
    _check_matrix(A)
    _check_operand("Dinv", Dinv, A.dtype, (A.nb_pad, A.bs, A.bs))
    _check_operand("x", x, A.dtype, (A.n_pad,))
    _check_operand("b", b, A.dtype, (A.n_pad,))
    _check_operand("plan.colors", plan.colors, torch.int32, (A.nb_pad,))
    if cpu:
        return block_mcgs_sweep_ref(A, x, b, Dinv, plan, order)
    order = _sweep_order(order, plan.ncolors)
    if not order:
        return x
    suffix, _ = _KERNEL_DTYPES[A.dtype]
    fn_name = f"pyamg_block_mcgs_sweep_{suffix}"
    fn = getattr(_build.library(), fn_name)
    staged = plan.staged or _runtime_block_size(A, Dinv)
    y = torch.empty_like(x)
    scratch = (torch.empty(max(plan.max_rows, 1) * A.bs, dtype=x.dtype,
                           device=x.device) if staged else None)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    x_in = x
    for chunk in _sweep_chunks(order):
        err = fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                 A.nb_pad, A.bs, x_in.data_ptr(), y.data_ptr(), b.data_ptr(),
                 Dinv.data_ptr(), plan.colors.data_ptr(),
                 plan.rows.data_ptr(), plan.offsets.data_ptr(),
                 plan.ncolors, plan.max_rows, _ptr(scratch),
                 (ctypes.c_int * len(chunk))(*chunk), len(chunk),
                 plan.threads, int(plan.route == "grid"), int(staged),
                 stream)
        _build.check(fn_name, err)
        _build.count_launch(f"block_mcgs_sweep.{_build.dtype_name(A.dtype)}")
        x_in = y
    return y


def _distinct(offs, nb):
    """``np.unique(offs, return_inverse=True)`` for block offsets, which
    lie in (-nb, nb): a count over that range takes one pass where the
    sort takes N log N (``scripts/measure_block_dia_offsets.py`` times
    both, alone and inside config 4's setup)."""
    present = np.bincount(offs + nb, minlength=2 * nb) > 0
    place = np.cumsum(present) - 1
    return np.flatnonzero(present) - nb, place[offs + nb]


def block_dia_from_scipy(A, dtype=torch.float32, device=None, n_pad=None,
                         max_diags=600):
    """Convert a square scipy BSR matrix (square blocks) to a
    BlockDIAMatrix on ``device``.  ``n_pad`` is the scalar padding (a
    multiple of the block size); None when the matrix has more distinct
    block diagonals than ``max_diags`` (the caller takes a scalar
    format)."""
    if device is None:
        raise ValueError("pass device= explicitly")
    A = A.tobsr() if not (sp.issparse(A) and A.format == "bsr") else A
    bs, bs2 = A.blocksize
    if bs != bs2:
        raise ValueError("square blocks required")
    n, m = A.shape
    if n != m:
        raise ValueError("block DIA requires a square matrix")
    nb = n // bs
    if n_pad is None:
        n_pad = n
    if n_pad % bs != 0:
        raise ValueError("n_pad must be a multiple of the block size")
    nb_pad = n_pad // bs

    rows_b = np.repeat(np.arange(nb), np.diff(A.indptr))
    offs_all = A.indices - rows_b
    offsets, d_index = _distinct(offs_all, nb)
    if max_diags is not None and len(offsets) > max_diags:
        return None
    # the blocks and their places go to the device, which scatters them
    # (a host scatter of millions of blocks costs more than the copies)
    data = torch.zeros((len(offsets) * nb_pad, bs * bs), dtype=dtype,
                       device=device)
    data.index_copy_(0, torch.as_tensor(d_index * nb_pad + rows_b,
                                        device=device),
                     torch.as_tensor(A.data.reshape(-1, bs * bs),
                                     device=device).to(dtype))
    return BlockDIAMatrix(
        data=data.reshape(len(offsets), nb_pad, bs, bs),
        offsets=tuple(int(o) for o in offsets),
        shape=(n, m), bs=int(bs), nnz=int(A.nnz))
