"""Windowed ELL transfer operators, and the windowed kernel entry points.

Counterpart of ``pyamg_tpu/sparse/window.py``.  Layout, built on the host
exactly as the JAX package builds it (same block, w2, starts, idx):

- rows in blocks of ``block``; block b reads the source window
  ``[starts[b] * w2, starts[b] * w2 + 2 * w2)``;
- ``data`` and ``idx`` are slot-major ``(n_blocks, k, block)``, ``idx``
  window-relative; padding slots hold (0, 0.0).

Kernel entry points (``csrc/window.cu``):

- :func:`windowed_matvec`     y = A x    (TPU: ``WindowedELL._matvec_pallas``)
- :func:`windowed_rmatvec`    y = A^T r  (TPU: ``WindowedELL._rmatvec_pallas``)
- :func:`windowed_matmat_k`   Y = A X    (TPU: ``WindowedELL._matmat_pallas_k``)
- :func:`windowed_rmatmat_k`  Y = A^T R  (TPU: ``WindowedELL._rmatmat_pallas_k``)
- :func:`windowed_select`     out[b, s, r] = x[starts[b] * w2 + idx[b, s, r]]
                              (TPU: ``WindowedELL._select_pallas``)

The K-lane forms take K-major (K, m) lane stacks, the batched solve's
layout; the operators' ``@`` takes a vector or such a stack, padding and
slicing along the last axis.  The TPU forms' lane caps (VMEM budgets) do
not carry over: any K runs, in launches of at most 16 lanes.

Each has a plain PyTorch twin (gather / scatter-add, ``*_ref``).  A
wrapper runs the twin only when its operands lie on the CPU; on CUDA
tensors it launches the kernel or raises.

The transposes sum without atomics: each operator builds a column plan
once, at its first transpose apply on the card
(:attr:`WindowedELL.column_plan`), and K7/K13 sum each output column's
entries in ascending entry order, the order of the twins' ``index_add_``
on the CPU, so a transpose gives the same bits on every launch and run.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import _build
from .formats import fit, pad_to

__all__ = ["WindowedELL", "TransposedWindowed", "windowed_from_scipy",
           "windowed_matvec", "windowed_rmatvec", "windowed_matmat_k",
           "windowed_rmatmat_k", "windowed_select", "windowed_matvec_ref",
           "windowed_rmatvec_ref", "windowed_matmat_k_ref",
           "windowed_rmatmat_k_ref", "windowed_select_ref"]

_LANES = 128

# the dtypes the JAX package's windowed Pallas kernels accept; kept so
# the transpose gate below decides as the reference does
_PALLAS_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_KERNEL_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclass(frozen=True)
class WindowedELL:
    """Window-blocked ELL matrix (see module docstring)."""

    data: torch.Tensor     # (n_blocks, k, block)
    idx: torch.Tensor      # (n_blocks, k, block) int32, window-relative
    starts: torch.Tensor   # (n_blocks,) int32, window start in w2 units
    shape: Tuple[int, int]
    block: int
    w2: int
    m_chunks: int          # padded source length in w2 units
    nnz: int

    @property
    def n_pad(self):
        return self.data.shape[0] * self.block

    @property
    def k(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @cached_property
    def column_plan(self):
        """(perm, colptr), the transpose kernels' column plan, built once
        at the first transpose apply and kept on the operator (as
        ``DIAMatrix.offsets_t`` is): every entry keyed by its global
        column, a dead one (data == 0) by the sentinel column m =
        m_chunks * w2, and sorted stably; ``perm`` (int32, one per entry)
        holds the flat indices into ``data`` in that order, ``colptr``
        (int32, m + 1) each column's range of ``perm``.  The kernels stop
        at ``colptr[m]``, so the dead entries past it are never read.
        4 * (entries + m + 1) bytes on the operator's device; the build
        sorts once and reads nothing back to the host."""
        m = self.m_chunks * self.w2
        keys = torch.where(self.data != 0,
                           self.starts[:, None, None] * self.w2 + self.idx,
                           m)                       # int32: m < 2**31
        keys, perm = torch.sort(keys.reshape(-1), stable=True)
        colptr = torch.searchsorted(
            keys, torch.arange(m + 1, dtype=keys.dtype, device=self.device),
            out_int32=True)
        return perm.to(torch.int32).contiguous(), colptr.contiguous()

    def _x_padded(self, x):
        """x (or each lane of a (K, m) stack) fitted to the source length
        ``m_chunks * w2``."""
        return fit(x, self.m_chunks * self.w2)

    def _can_transpose_pallas(self):
        """The JAX package's gate for its transpose kernel (the output had
        to fit the TPU's VMEM).  Kept as is: compile_hierarchy's choice of
        restriction form follows it, so the port builds the reference's
        hierarchy one for one."""
        return (self.block % 128 == 0 and self.w2 % 1024 == 0
                and self.m_chunks * self.w2 * 4 <= 6 * 2**20
                and self.dtype in _PALLAS_DTYPES)

    def matvec(self, x):
        """A @ x for a vector, or lane by lane for a K-major stack (K12)."""
        if x.ndim == 2:
            return self.matmat_k(x)
        return windowed_matvec(self, self._x_padded(x))

    def rmatvec(self, x):
        """A^T @ x for a vector, or lane by lane for a K-major stack
        (K13)."""
        if x.ndim == 2:
            return self.rmatmat_k(x)
        return windowed_rmatvec(self, x[: self.n_pad])

    def matmat_k(self, Xk):
        """Y = A @ X for a K-major stack (K, m) -> (K, n_pad) (K12)."""
        return windowed_matmat_k(self, self._x_padded(Xk))

    def rmatmat_k(self, Rk):
        """Y = A^T @ R for a K-major stack (K, n_pad) -> (K, m_chunks * w2)
        (K13)."""
        return windowed_rmatmat_k(self, fit(Rk, self.n_pad))

    def select(self, x):
        """Per-slot window selection, (n_blocks, k, block) in x's dtype:
        each entry's slot holds x at the entry's column (K14).  The
        unstructured setup's graph passes are elementwise functions of
        it."""
        return windowed_select(self, self._x_padded(x))

    def diagonal(self):
        """The diagonal as an (n_pad,) vector (duplicate entries summed)."""
        rows = torch.arange(self.n_pad, device=self.device).reshape(
            self.data.shape[0], 1, self.block)
        return torch.sum(torch.where(_global_index(self) == rows, self.data,
                                     0), dim=1).reshape(-1)

    def __matmul__(self, x):
        return self.matvec(x)


@dataclass(frozen=True)
class TransposedWindowed:
    """Lazy transpose of a WindowedELL: ``matvec`` is the base operator's
    transpose apply, on the base operator's own arrays (K7, or K13 lane by
    lane for a K-major stack)."""

    base: WindowedELL

    @property
    def shape(self):
        return (self.base.shape[1], self.base.shape[0])

    @property
    def nnz(self):
        return self.base.nnz

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def n_pad(self):
        return self.base.m_chunks * self.base.w2

    def matvec(self, x):
        return self.base.rmatvec(fit(x, self.base.n_pad))

    def rmatvec(self, x):
        return self.base.matvec(x)

    def __matmul__(self, x):
        return self.matvec(x)


def windowed_from_scipy(A, dtype=torch.float32, device=None, block=None,
                        max_w2=16384):
    """Build a WindowedELL on ``device``, with the JAX package's block and
    w2 choice (its TPU cost model, kept so the layouts agree); None when
    some row block's column span exceeds ``max_w2``."""
    if device is None:
        raise ValueError("pass device= explicitly")
    if np.iscomplexobj(getattr(A, "data", np.zeros(0))) or dtype.is_complex:
        raise NotImplementedError("complex windowed operators are not "
                                  "ported yet")
    candidates = ((8192, 4096, 2048, 1024, 512, 256) if block is None
                  else (int(block),))
    A = sp.csr_matrix(A)
    A.sort_indices()
    n, m = A.shape
    n_pad_max = pad_to(max(n, 1), max(candidates))
    lens = np.diff(A.indptr)
    k = max(int(lens.max()) if n else 0, 1)

    rows = np.repeat(np.arange(n), lens)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], lens)
    cols = np.zeros((n_pad_max, k), dtype=np.int64)
    vals = np.zeros((n_pad_max, k), dtype=np.float64)
    has = np.zeros((n_pad_max, k), dtype=bool)
    if A.nnz:
        cols[rows, slots] = A.indices
        vals[rows, slots] = A.data
        has[rows, slots] = True

    GR = min(candidates)
    g = n_pad_max // GR
    g_min = np.where(has, cols, np.iinfo(np.int64).max).reshape(
        g, -1).min(axis=1)
    g_max = np.where(has, cols, -1).reshape(g, -1).max(axis=1)

    best = None
    best_cost = None
    for blk in candidates:
        n_pad_c = pad_to(max(n, 1), blk)
        nb = n_pad_c // blk
        if k * blk * 8 * 2 > 4 * 2**20:
            continue
        q = blk // GR
        gm = g_min[: n_pad_c // GR].reshape(nb, q).min(axis=1)
        gM = g_max[: n_pad_c // GR].reshape(nb, q).max(axis=1)
        empty = gM < 0
        gm[empty] = 0
        gM[empty] = 0
        w2_c = 1024
        while True:
            if (gM < (gm // w2_c + 2) * w2_c).all():
                break
            w2_c *= 2
            if w2_c > max_w2:
                w2_c = None
                break
        if w2_c is None:
            continue
        cost = nb * 0.15e-6 + k * n_pad_c * (2 * w2_c // _LANES) * 8e-12
        if best_cost is None or cost < best_cost:
            best = (blk, w2_c, n_pad_c, nb, gm)
            best_cost = cost
    if best is None:
        return None
    block, w2, n_pad, n_blocks, mins = best
    cols = cols[:n_pad]
    vals = vals[:n_pad]
    has = has[:n_pad]
    starts = mins // w2

    m_chunks = pad_to(max(m, 1), w2) // w2
    m_chunks = max(m_chunks, int(starts.max()) + 2)   # starts+1 addressable

    local = cols - (starts[:, None] * w2).repeat(block, axis=0).reshape(n_pad, 1)
    local = np.where(has, local, 0)
    idx = local.reshape(n_blocks, block, k).transpose(0, 2, 1)
    data = vals.reshape(n_blocks, block, k).transpose(0, 2, 1)
    return WindowedELL(
        data=torch.as_tensor(np.ascontiguousarray(data), dtype=dtype,
                             device=device),
        idx=torch.as_tensor(np.ascontiguousarray(idx), dtype=torch.int32,
                            device=device),
        starts=torch.as_tensor(starts, dtype=torch.int32, device=device),
        shape=(n, m),
        block=int(block),
        w2=int(w2),
        m_chunks=int(m_chunks),
        nnz=int(A.nnz),
    )


# ---------------------------------------------------------------------------
# plain PyTorch twins (pyamg_tpu/sparse/window.py, _matvec_reference and
# _rmatvec_reference)
# ---------------------------------------------------------------------------

def _global_index(W: WindowedELL):
    return W.starts.long()[:, None, None] * W.w2 + W.idx.long()


def windowed_matvec_ref(W: WindowedELL, x):
    """Gather form; ``x`` has length ``m_chunks * w2``."""
    return torch.sum(W.data * x[_global_index(W)], dim=1).reshape(-1)


def windowed_rmatvec_ref(W: WindowedELL, r):
    """Scatter-add form; ``r`` has length ``n_pad``."""
    y = torch.zeros(W.m_chunks * W.w2, dtype=W.dtype, device=r.device)
    rb = r.reshape(W.data.shape[0], 1, W.block)
    return y.index_add_(0, _global_index(W).reshape(-1),
                        (W.data * rb).reshape(-1))


def windowed_matmat_k_ref(W: WindowedELL, Xk):
    """The gather form lane by lane; ``Xk`` is (K, m_chunks * w2)."""
    return torch.stack([windowed_matvec_ref(W, x) for x in Xk])


def windowed_rmatmat_k_ref(W: WindowedELL, Rk):
    """The scatter-add form lane by lane; ``Rk`` is (K, n_pad)."""
    return torch.stack([windowed_rmatvec_ref(W, r) for r in Rk])


def windowed_select_ref(W: WindowedELL, x):
    """The gather ``x[column]`` per entry; ``x`` has length
    ``m_chunks * w2``."""
    return x[_global_index(W)]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_operator(W):
    if W.dtype not in _KERNEL_SUFFIX:
        raise TypeError(f"windowed kernel takes float32 or float64, not "
                        f"{W.dtype}")
    for name, t, dt in (("data", W.data, W.dtype), ("idx", W.idx, torch.int32),
                        ("starts", W.starts, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"windowed {name}: expected contiguous {dt}")


def _launch_windowed_k(kind, W, V, Y):
    """Launch a K-lane windowed kernel over the stacks V -> Y in lane
    chunks, counting each launch."""
    _check_operator(W)
    fn_name = f"pyamg_windowed_{kind}_{_KERNEL_SUFFIX[W.dtype]}"
    fn = getattr(_build.library(), fn_name)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    m = W.m_chunks * W.w2
    if kind == "rmatmat_k":
        perm, colptr = W.column_plan
        head = (W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(), W.k,
                W.block)
    else:
        head = (W.data.data_ptr(), W.idx.data_ptr(), W.starts.data_ptr(),
                W.k, W.block, W.w2)
    for k0, k1 in _build.lane_chunks(V.shape[0]):
        err = fn(*head, W.n_pad, m, k1 - k0, V[k0:k1].data_ptr(),
                 Y[k0:k1].data_ptr(), stream)
        _build.check(fn_name, err)
        _build.count_launch(f"windowed_{kind}.{_build.dtype_name(W.dtype)}")


def windowed_matvec(W: WindowedELL, x):
    """y = A @ x, with x of length ``m_chunks * w2``; y has ``n_pad``."""
    if _build.on_cpu(W.data, x):
        return windowed_matvec_ref(W, x)
    _build.check_vector("x", x, W.m_chunks * W.w2, W.dtype)
    _check_operator(W)
    y = torch.empty(W.n_pad, dtype=W.dtype, device=x.device)
    fn_name = f"pyamg_windowed_matvec_{_KERNEL_SUFFIX[W.dtype]}"
    err = getattr(_build.library(), fn_name)(
        W.data.data_ptr(), W.idx.data_ptr(), W.starts.data_ptr(), W.k,
        W.block, W.w2, W.n_pad, x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(fn_name, err)
    _build.count_launch(f"windowed_matvec.{_build.dtype_name(W.dtype)}")
    return y


def windowed_rmatvec(W: WindowedELL, r):
    """y = A^T @ r, with r of length ``n_pad``; y has ``m_chunks * w2``.
    On the card each column sums its entries in ascending entry order
    through the operator's column plan (built at the first call), so the
    result is the same on every run and equals the CPU twin's."""
    if _build.on_cpu(W.data, r):
        return windowed_rmatvec_ref(W, r)
    _build.check_vector("r", r, W.n_pad, W.dtype)
    _check_operator(W)
    perm, colptr = W.column_plan
    m = W.m_chunks * W.w2
    y = torch.empty(m, dtype=W.dtype, device=r.device)
    fn_name = f"pyamg_windowed_rmatvec_{_KERNEL_SUFFIX[W.dtype]}"
    err = getattr(_build.library(), fn_name)(
        W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(), W.k, W.block,
        m, r.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(fn_name, err)
    _build.count_launch(f"windowed_rmatvec.{_build.dtype_name(W.dtype)}")
    return y


def windowed_select(W: WindowedELL, x):
    """out[b, s, r] = x[starts[b] * w2 + idx[b, s, r]], (n_blocks, k,
    block) in x's dtype (float32 or float64, whatever W's dtype), with x of
    length ``m_chunks * w2`` (K14: an exact indexed load)."""
    if _build.on_cpu(W.idx, x):
        return windowed_select_ref(W, x)
    if x.dtype not in _KERNEL_SUFFIX:
        raise TypeError(f"windowed select takes float32 or float64 "
                        f"payloads, not {x.dtype}")
    _build.check_vector("x", x, W.m_chunks * W.w2, x.dtype)
    for name, t in (("idx", W.idx), ("starts", W.starts)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"windowed {name}: expected contiguous int32")
    out = torch.empty(W.idx.shape, dtype=x.dtype, device=x.device)
    fn_name = f"pyamg_windowed_select_{_KERNEL_SUFFIX[x.dtype]}"
    err = getattr(_build.library(), fn_name)(
        W.idx.data_ptr(), W.starts.data_ptr(), W.k, W.block, W.w2, W.n_pad,
        x.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(fn_name, err)
    _build.count_launch(f"windowed_select.{_build.dtype_name(x.dtype)}")
    return out


def windowed_matmat_k(W: WindowedELL, Xk):
    """Y = A @ X lane by lane for a K-major stack Xk (K, m_chunks * w2); Y
    is (K, n_pad) (K12: data and idx read once for all lanes)."""
    if _build.on_cpu(W.data, Xk):
        return windowed_matmat_k_ref(W, Xk)
    _build.check_stack("Xk", Xk, W.m_chunks * W.w2, W.dtype)
    Y = torch.empty(Xk.shape[0], W.n_pad, dtype=W.dtype, device=Xk.device)
    _launch_windowed_k("matmat_k", W, Xk, Y)
    return Y


def windowed_rmatmat_k(W: WindowedELL, Rk):
    """Y = A^T @ R lane by lane for a K-major stack Rk (K, n_pad); Y is
    (K, m_chunks * w2) (K13: K7's column plan, every lane of a column
    summed in ascending entry order, so each lane equals K7's result and
    the CPU twin's on every run)."""
    if _build.on_cpu(W.data, Rk):
        return windowed_rmatmat_k_ref(W, Rk)
    _build.check_stack("Rk", Rk, W.n_pad, W.dtype)
    Y = torch.empty(Rk.shape[0], W.m_chunks * W.w2, dtype=W.dtype,
                    device=Rk.device)
    _launch_windowed_k("rmatmat_k", W, Rk, Y)
    return Y
