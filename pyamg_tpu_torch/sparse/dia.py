"""DIA (diagonal) and dense device formats, and the DIA kernel entry points.

Counterpart of ``pyamg_tpu/sparse/dia.py``.  ``data[d, i] = A[i, i +
offsets[d]]``, zero where A has no entry or the column falls outside the
matrix, so padded rows and out-of-range positions contribute exactly
zero and padded vector entries stay zero.

Kernel entry points (``csrc/dia.cu``, one template in three modes):

- :func:`dia_spmv`            y = A x                        (TPU: ``_dia_pallas_matvec``)
- :func:`dia_jacobi`          x + w dinv (b - A x)           (TPU: ``dia_pallas_jacobi``)
- :func:`dia_jacobi_zero_res` (w dinv b, b - A (w dinv b))   (TPU: ``dia_pallas_jacobi_zero_res``)

Each has a plain PyTorch twin (``*_ref``) in this module.  A wrapper runs
the twin only when its operands lie on the CPU; on CUDA tensors it
launches the kernel or raises.
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
from .formats import pad_to

__all__ = ["DIAMatrix", "dia_from_scipy", "DenseOperator",
           "dense_from_scipy", "dia_spmv", "dia_jacobi",
           "dia_jacobi_zero_res", "dia_spmv_ref", "dia_jacobi_ref",
           "dia_jacobi_zero_res_ref"]

_SPMV, _JACOBI, _JACOBI_ZERO_RES = 0, 1, 2


@dataclass(frozen=True)
class DIAMatrix:
    """Diagonal-stored square matrix over padded vectors."""

    data: torch.Tensor           # (ndiags, n_pad)
    offsets: Tuple[int, ...]     # ascending
    shape: Tuple[int, int]       # logical
    nnz: int

    @cached_property
    def offsets_t(self) -> torch.Tensor:
        """The offsets as an int32 tensor beside ``data`` (kernel input)."""
        return torch.tensor(self.offsets, dtype=torch.int32,
                            device=self.data.device)

    @property
    def n_pad(self):
        return self.data.shape[1]

    @property
    def ndiags(self):
        return len(self.offsets)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def matvec(self, x):
        return dia_spmv(self, x)

    def rmatvec(self, x):
        """A.T @ x by rolls (plain PyTorch, as the JAX package leaves it
        to XLA): y = sum_d roll(data[d] * x, +offsets[d]); out-of-range
        slots hold zero, so wrapped terms vanish."""
        y = torch.roll(self.data[0] * x, self.offsets[0])
        for d in range(1, self.ndiags):
            y = y + torch.roll(self.data[d] * x, self.offsets[d])
        return y

    def __matmul__(self, x):
        if x.ndim != 1:
            raise NotImplementedError(
                "DIAMatrix applies to 1-D vectors only; the batched forms "
                "are ROADMAP.md Queue 1 item 12")
        return self.matvec(x)


def dia_from_scipy(A, dtype=torch.float32, device=None, row_pad=8,
                   max_diags=None):
    """Convert a square scipy sparse matrix to a DIAMatrix on ``device``;
    None when it has more than ``max_diags`` distinct diagonals."""
    if device is None:
        raise ValueError("pass device= explicitly")
    A = sp.coo_matrix(A)
    n, m = A.shape
    if n != m:
        raise ValueError("DIA requires a square matrix")
    if np.iscomplexobj(A.data) or dtype.is_complex:
        raise NotImplementedError("complex DIA is not ported yet")
    n_pad = pad_to(max(n, 1), row_pad)
    offs_all = A.col - A.row
    offsets = np.unique(offs_all)
    if max_diags is not None and len(offsets) > max_diags:
        return None
    d_index = np.searchsorted(offsets, offs_all)
    data = np.zeros((len(offsets), n_pad), dtype=np.float64)
    data[d_index, A.row] = A.data if data.size else 0
    return DIAMatrix(
        data=torch.as_tensor(data, dtype=dtype, device=device),
        offsets=tuple(int(o) for o in offsets),
        shape=(n, m),
        nnz=int(A.nnz),
    )


@dataclass(frozen=True)
class DenseOperator:
    """Dense operator for small (coarse) levels; products run in full
    float32 (``backend`` turns TF32 off)."""

    data: torch.Tensor           # (n_pad, m_pad)
    shape: Tuple[int, int]
    nnz: int

    @property
    def n_pad(self):
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x):
        return torch.matmul(self.data, x)

    def rmatvec(self, x):
        return torch.matmul(x, self.data)

    def __matmul__(self, x):
        return torch.matmul(self.data, x)


def dense_from_scipy(A, dtype=torch.float32, device=None, row_pad=8):
    """Convert scipy sparse to a padded DenseOperator on ``device``."""
    if device is None:
        raise ValueError("pass device= explicitly")
    A = sp.csr_matrix(A)
    n, m = A.shape
    n_pad = pad_to(max(n, 1), row_pad)
    m_pad = pad_to(max(m, 1), row_pad)
    data = np.zeros((n_pad, m_pad), dtype=np.float64)
    data[:n, :m] = A.toarray()
    return DenseOperator(data=torch.as_tensor(data, dtype=dtype,
                                              device=device),
                         shape=(n, m), nnz=int(A.nnz))


# ---------------------------------------------------------------------------
# plain PyTorch twins: the padded-slice sum in offset order
# (pyamg_tpu/sparse/dia.py, DIAMatrix._matvec_impl)
# ---------------------------------------------------------------------------

def dia_spmv_ref(A: DIAMatrix, x):
    h = max(max(A.offsets), -min(A.offsets), 0)
    xp = F.pad(x, (h, h))
    n_pad = A.n_pad
    y = A.data[0] * xp[h + A.offsets[0]: h + A.offsets[0] + n_pad]
    for d in range(1, A.ndiags):
        off = A.offsets[d]
        y = y + A.data[d] * xp[h + off: h + off + n_pad]
    return y


def dia_jacobi_ref(A: DIAMatrix, x, b, dinv, omega):
    return x + omega * (dinv * (b - dia_spmv_ref(A, x)))


def dia_jacobi_zero_res_ref(A: DIAMatrix, b, dinv, omega):
    x = omega * (dinv * b)
    return x, b - dia_spmv_ref(A, x)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: ("pyamg_dia_f32", ctypes.c_float),
                  torch.float64: ("pyamg_dia_f64", ctypes.c_double)}


def _launch_dia(mode, A, x, b, dinv, omega, y, r):
    if A.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"DIA kernel takes float32 or float64, not {A.dtype}")
    if not A.data.is_contiguous():
        raise ValueError("DIA data must be contiguous")
    fn_name, c_scalar = _KERNEL_DTYPES[A.dtype]
    lib = _build.library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = getattr(lib, fn_name)(
        A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags, A.n_pad,
        ptr(x), ptr(b), ptr(dinv), c_scalar(float(omega)), y.data_ptr(),
        ptr(r), mode, torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(fn_name, err)


def dia_spmv(A: DIAMatrix, x):
    """y = A @ x for a padded 1-D x of length ``A.n_pad``."""
    if _build.on_cpu(A.data, x):
        return dia_spmv_ref(A, x)
    _build.check_vector("x", x, A.n_pad, A.dtype)
    y = torch.empty_like(x)
    _launch_dia(_SPMV, A, x, None, None, 0.0, y, None)
    _build.count_launch(f"dia_spmv.{_build.dtype_name(A.dtype)}")
    return y


def dia_jacobi(A: DIAMatrix, x, b, dinv, omega):
    """One weighted-Jacobi sweep x + omega * dinv * (b - A @ x)."""
    if _build.on_cpu(A.data, x, b, dinv):
        return dia_jacobi_ref(A, x, b, dinv, omega)
    for name, v in (("x", x), ("b", b), ("dinv", dinv)):
        _build.check_vector(name, v, A.n_pad, A.dtype)
    y = torch.empty_like(x)
    _launch_dia(_JACOBI, A, x, b, dinv, omega, y, None)
    _build.count_launch(f"dia_jacobi.{_build.dtype_name(A.dtype)}")
    return y


def dia_jacobi_zero_res(A: DIAMatrix, b, dinv, omega):
    """Zero-guess Jacobi sweep and its residual in one pass:
    (x, r) = (omega * dinv * b, b - A @ x)."""
    if _build.on_cpu(A.data, b, dinv):
        return dia_jacobi_zero_res_ref(A, b, dinv, omega)
    for name, v in (("b", b), ("dinv", dinv)):
        _build.check_vector(name, v, A.n_pad, A.dtype)
    x = torch.empty_like(b)
    r = torch.empty_like(b)
    _launch_dia(_JACOBI_ZERO_RES, A, None, b, dinv, omega, x, r)
    _build.count_launch(f"dia_jacobi_zero_res.{_build.dtype_name(A.dtype)}")
    return x, r
