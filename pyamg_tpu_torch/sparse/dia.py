"""DIA (diagonal) and dense device formats, and the DIA kernel entry points.

Counterpart of ``pyamg_tpu/sparse/dia.py``.  ``data[d, i] = A[i, i +
offsets[d]]``, zero where A has no entry or the column falls outside the
matrix, so padded rows and out-of-range positions contribute exactly
zero and padded vector entries stay zero.

Kernel entry points (``csrc/dia.cu``, one template in five modes, and
``csrc/dia_chain.cu``, two two-stage kernels):

- :func:`dia_spmv`            y = A x                        (TPU: ``_dia_pallas_matvec``)
- :func:`dia_spmv_scaled`     s (A r)                        (TPU: ``_dia_pallas_matvec``, ``scale=``)
- :func:`dia_spmv_add`        x + A t                        (TPU: ``_dia_pallas_matvec``, ``addv=``)
- :func:`dia_jacobi`          x + w dinv (b - A x)           (TPU: ``dia_pallas_jacobi``)
- :func:`dia_jacobi_zero_res` (w dinv b, b - A (w dinv b))   (TPU: ``dia_pallas_jacobi_zero_res``)
- :func:`dia_jacobi_res`      (y, b - A y), y = x + w dinv (b - A x)
                                                             (TPU: ``dia_pallas_jacobi_res``)
- :func:`dia_zero_chain`      (x, tv (St (b - A x))), x = w dinv b
                                                             (TPU: ``dia_pallas_zero_chain``)

K-lane entry points (``csrc/dia_k.cu``) over K-major (K, n_pad) lane
stacks, the batched solve's layout:

- :func:`dia_spmm`            Y = A X                        (TPU: ``_dia_pallas_matmat_k``)
- :func:`dia_spmm_scaled`     s (A R), s shared by the lanes (TPU: ``_dia_pallas_matmat_k``, ``scale=``)
- :func:`dia_spmm_add`        V + A T, V per lane            (TPU: ``_dia_pallas_matmat_k``, ``addk=``)
- :func:`dia_jacobi_k`        X + w dinv (B - A X)           (TPU: ``dia_pallas_jacobi_km``)
- :func:`dia_jacobi_zero_res_k` (w dinv B, B - A (w dinv B)) (TPU: ``dia_pallas_jacobi_zero_res_km``)
- :func:`dia_zero_chain_k`    (X, tv (St (B - A X))), X = w dinv B
                                                             (TPU: ``dia_pallas_zero_chain_km``)

and :func:`dia_jacobi_res_k`, the batched Jacobi-plus-residual composed
as the reference's batch rule composes it: K9, then B - A Y through K8.

Each has a plain PyTorch twin (``*_ref``) in this module.  A wrapper runs
the twin only when its operands lie on the CPU; on CUDA tensors it
launches the kernel or raises.  The Jacobi weight ``omega`` is a Python
float or a 0-d tensor of the operator's dtype on its device; a tensor
reaches the kernel by pointer, so no launch reads it to the host.

:func:`dia_spgemm`, :func:`dia_transpose` and :func:`dia_from_stencil` are
plain PyTorch (rolls and masks), as the JAX package leaves them to XLA.
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
from ..backend import resolve_device
from .formats import pad_to

__all__ = ["DIAMatrix", "dia_from_scipy", "dia_from_stencil", "dia_spgemm",
           "dia_transpose",
           "DenseOperator", "dense_from_scipy", "dia_spmv",
           "dia_spmv_scaled", "dia_spmv_add", "dia_jacobi",
           "dia_jacobi_zero_res", "dia_jacobi_res", "dia_zero_chain",
           "dia_spmv_ref", "dia_spmv_scaled_ref", "dia_spmv_add_ref",
           "dia_jacobi_ref", "dia_jacobi_zero_res_ref", "dia_jacobi_res_ref",
           "dia_zero_chain_ref", "dia_spmm", "dia_spmm_scaled",
           "dia_spmm_add", "dia_jacobi_k", "dia_zero_chain_k",
           "dia_jacobi_res_k", "dia_jacobi_zero_res_k", "dia_spmm_ref",
           "dia_spmm_scaled_ref", "dia_spmm_add_ref", "dia_jacobi_k_ref",
           "dia_jacobi_zero_res_k_ref", "dia_zero_chain_k_ref"]

# modes of csrc/dia.cu::dia_kernel and csrc/dia_chain.cu
_SPMV, _JACOBI, _JACOBI_ZERO_RES, _SPMV_SCALED, _SPMV_ADD = 0, 1, 2, 3, 4
_ZERO_CHAIN, _JACOBI_RES = 0, 1
# modes of csrc/dia_k.cu::dia_k_kernel
_SPMM, _SPMM_SCALED, _SPMM_ADD, _JACOBI_K, _ZERO_RES_K = 0, 1, 2, 3, 4


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

    def matmat_k(self, Xk):
        """Y = A @ X for a K-major lane stack Xk (K, n_pad) (K8)."""
        return dia_spmm(self, Xk)

    def rmatvec(self, x):
        """A.T @ x by rolls (plain PyTorch, as the JAX package leaves it
        to XLA): y = sum_d roll(data[d] * x, +offsets[d]); out-of-range
        slots hold zero, so wrapped terms vanish.  A K-major (K, n_pad)
        lane stack rolls along its last axis, lane by lane."""
        y = torch.roll(self.data[0] * x, self.offsets[0], dims=-1)
        for d in range(1, self.ndiags):
            y = y + torch.roll(self.data[d] * x, self.offsets[d], dims=-1)
        return y

    def __matmul__(self, x):
        """A @ x for a vector, or A @ X lane by lane for a K-major (K,
        n_pad) stack."""
        if x.ndim == 2:
            return self.matmat_k(x)
        if x.ndim != 1:
            raise ValueError(f"DIAMatrix applies to a vector or a (K, n_pad) "
                             f"stack, got shape {tuple(x.shape)}")
        return self.matvec(x)

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros(self.n_pad, dtype=self.dtype, device=self.device)


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
    float32 (``backend`` turns TF32 off).  A K-major (K, m_pad) lane stack
    is applied lane by lane as ``X @ data.T`` (plain ``torch.matmul``, as
    the reference leaves it to XLA outside any kernel)."""

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
        if x.ndim == 2:
            return torch.matmul(x, self.data.T)
        return torch.matmul(self.data, x)

    def rmatvec(self, x):
        return torch.matmul(x, self.data)

    def __matmul__(self, x):
        return self.matvec(x)


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


def dia_spmv_scaled_ref(A: DIAMatrix, r, s):
    return dia_spmv_ref(A, r) * s


def dia_spmv_add_ref(A: DIAMatrix, t, x):
    return x + dia_spmv_ref(A, t)


def dia_jacobi_res_ref(A: DIAMatrix, x, b, dinv, omega):
    y = dia_jacobi_ref(A, x, b, dinv, omega)
    return y, b - dia_spmv_ref(A, y)


def dia_zero_chain_ref(A: DIAMatrix, St: DIAMatrix, b, dinv, tv, omega):
    x, r = dia_jacobi_zero_res_ref(A, b, dinv, omega)
    return x, tv * dia_spmv_ref(St, r)


def dia_spmm_ref(A: DIAMatrix, Xk):
    """The padded-slice sum of :func:`dia_spmv_ref`, lane by lane over a
    K-major (K, n_pad) stack."""
    h = max(max(A.offsets), -min(A.offsets), 0)
    Xp = F.pad(Xk, (h, h))
    n_pad = A.n_pad
    Y = A.data[0] * Xp[:, h + A.offsets[0]: h + A.offsets[0] + n_pad]
    for d in range(1, A.ndiags):
        off = A.offsets[d]
        Y = Y + A.data[d] * Xp[:, h + off: h + off + n_pad]
    return Y


def dia_spmm_scaled_ref(A: DIAMatrix, Rk, s):
    return dia_spmm_ref(A, Rk) * s


def dia_spmm_add_ref(A: DIAMatrix, Tk, Xk):
    return Xk + dia_spmm_ref(A, Tk)


def dia_jacobi_k_ref(A: DIAMatrix, Xk, Bk, dinv, omega):
    return Xk + omega * (dinv * (Bk - dia_spmm_ref(A, Xk)))


def dia_jacobi_zero_res_k_ref(A: DIAMatrix, Bk, dinv, omega):
    Xk = omega * (dinv * Bk)
    return Xk, Bk - dia_spmm_ref(A, Xk)


def dia_zero_chain_k_ref(A: DIAMatrix, St: DIAMatrix, Bk, dinv, tv, omega):
    Xk = omega * (dinv * Bk)
    return Xk, tv * dia_spmm_ref(St, Bk - dia_spmm_ref(A, Xk))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# dtype -> (C entry-point suffix, by-value scalar type)
_KERNEL_DTYPES = {torch.float32: ("f32", ctypes.c_float),
                  torch.float64: ("f64", ctypes.c_double)}


def _kernel_operand(A, name="A"):
    if A.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"DIA kernel takes float32 or float64, not {A.dtype}")
    if not A.data.is_contiguous():
        raise ValueError(f"{name}: DIA data must be contiguous")


def _omega_args(omega, A, c_scalar):
    """(weight by value, pointer to a 0-d device weight or None)."""
    if isinstance(omega, torch.Tensor):
        if omega.ndim != 0 or omega.device != A.device:
            raise ValueError(f"omega: expected a 0-d tensor on {A.device}, "
                             f"got shape {tuple(omega.shape)} on "
                             f"{omega.device}")
        if omega.dtype != A.dtype:
            raise TypeError(f"omega: expected {A.dtype}, got {omega.dtype}")
        return c_scalar(0.0), omega.data_ptr()
    return c_scalar(float(omega)), None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_dia(mode, A, x, b, dinv, omega, y, r):
    _kernel_operand(A)
    suffix, c_scalar = _KERNEL_DTYPES[A.dtype]
    fn_name = f"pyamg_dia_{suffix}"
    w, w_dev = _omega_args(omega, A, c_scalar)
    err = getattr(_build.library(), fn_name)(
        A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags, A.n_pad,
        _ptr(x), _ptr(b), _ptr(dinv), w, w_dev, y.data_ptr(), _ptr(r), mode,
        torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(fn_name, err)


def _launch_chain(mode, A, St, x, b, dinv, tv, omega, out0, out1):
    _kernel_operand(A)
    suffix, c_scalar = _KERNEL_DTYPES[A.dtype]
    fn_name = f"pyamg_dia_chain_{suffix}"
    w, w_dev = _omega_args(omega, A, c_scalar)
    if St is not None:
        _kernel_operand(St, "St")
        if St.dtype != A.dtype or St.n_pad != A.n_pad:
            raise ValueError(f"St: expected {A.dtype} with n_pad {A.n_pad}, "
                             f"got {St.dtype} with n_pad {St.n_pad}")
        sdata, soffs, nds = St.data.data_ptr(), St.offsets_t.data_ptr(), \
            St.ndiags
    else:
        sdata, soffs, nds = None, None, 0
    err = getattr(_build.library(), fn_name)(
        A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags, sdata, soffs,
        nds, A.n_pad, _ptr(x), _ptr(b), _ptr(dinv), _ptr(tv), w, w_dev,
        out0.data_ptr(), out1.data_ptr(), mode,
        torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(fn_name, err)


def _launch_k(kernel, mode, A, Xk, b, dinv, omega, Yk, Rk=None):
    """Launch csrc/dia_k.cu::dia_k_kernel over (K, n_pad) stacks in lane
    chunks; ``b`` is a shared (n_pad,) vector or a per-lane stack, ``Rk``
    the second output stack (K10's residual)."""
    _kernel_operand(A)
    suffix, c_scalar = _KERNEL_DTYPES[A.dtype]
    fn_name = f"pyamg_dia_k_{suffix}"
    fn = getattr(_build.library(), fn_name)
    w, w_dev = _omega_args(omega, A, c_scalar)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    for k0, k1 in _build.lane_chunks(Yk.shape[0]):
        bk = b if b is None or b.ndim == 1 else b[k0:k1]
        xk = None if Xk is None else Xk[k0:k1]
        rk = None if Rk is None else Rk[k0:k1]
        err = fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                 A.n_pad, k1 - k0, _ptr(xk), _ptr(bk), _ptr(dinv), w, w_dev,
                 Yk[k0:k1].data_ptr(), _ptr(rk), mode, stream)
        _build.check(fn_name, err)
        _count(kernel, A)


def _check_stacks(A, K, **stacks):
    for name, v in stacks.items():
        _build.check_stack(name, v, A.n_pad, A.dtype, K)


def _check_vectors(A, **vectors):
    for name, v in vectors.items():
        _build.check_vector(name, v, A.n_pad, A.dtype)


def _count(kernel, A):
    _build.count_launch(f"{kernel}.{_build.dtype_name(A.dtype)}")


def dia_spmv(A: DIAMatrix, x):
    """y = A @ x for a padded 1-D x of length ``A.n_pad``."""
    if _build.on_cpu(A.data, x):
        return dia_spmv_ref(A, x)
    _check_vectors(A, x=x)
    y = torch.empty_like(x)
    _launch_dia(_SPMV, A, x, None, None, 0.0, y, None)
    _count("dia_spmv", A)
    return y


def dia_spmv_scaled(A: DIAMatrix, r, s):
    """s * (A @ r) with the scale in the SpMV's epilogue (the structured
    restrictor's tv factor)."""
    if _build.on_cpu(A.data, r, s):
        return dia_spmv_scaled_ref(A, r, s)
    _check_vectors(A, r=r, s=s)
    y = torch.empty_like(r)
    _launch_dia(_SPMV_SCALED, A, r, s, None, 0.0, y, None)
    _count("dia_spmv_scaled", A)
    return y


def dia_spmv_add(A: DIAMatrix, t, x):
    """x + A @ t with the add in the SpMV's epilogue (the structured
    prolongator's coarse-grid correction)."""
    if _build.on_cpu(A.data, t, x):
        return dia_spmv_add_ref(A, t, x)
    _check_vectors(A, t=t, x=x)
    y = torch.empty_like(t)
    _launch_dia(_SPMV_ADD, A, t, x, None, 0.0, y, None)
    _count("dia_spmv_add", A)
    return y


def dia_jacobi(A: DIAMatrix, x, b, dinv, omega):
    """One weighted-Jacobi sweep x + omega * dinv * (b - A @ x)."""
    if _build.on_cpu(A.data, x, b, dinv):
        return dia_jacobi_ref(A, x, b, dinv, omega)
    _check_vectors(A, x=x, b=b, dinv=dinv)
    y = torch.empty_like(x)
    _launch_dia(_JACOBI, A, x, b, dinv, omega, y, None)
    _count("dia_jacobi", A)
    return y


def dia_jacobi_zero_res(A: DIAMatrix, b, dinv, omega):
    """Zero-guess Jacobi sweep and its residual in one pass:
    (x, r) = (omega * dinv * b, b - A @ x)."""
    if _build.on_cpu(A.data, b, dinv):
        return dia_jacobi_zero_res_ref(A, b, dinv, omega)
    _check_vectors(A, b=b, dinv=dinv)
    x = torch.empty_like(b)
    r = torch.empty_like(b)
    _launch_dia(_JACOBI_ZERO_RES, A, None, b, dinv, omega, x, r)
    _count("dia_jacobi_zero_res", A)
    return x, r


def dia_jacobi_res(A: DIAMatrix, x, b, dinv, omega):
    """A Jacobi sweep from a nonzero guess and the residual of the updated
    iterate in one pass: (y, r) = (x + omega * dinv * (b - A @ x),
    b - A @ y)."""
    if _build.on_cpu(A.data, x, b, dinv):
        return dia_jacobi_res_ref(A, x, b, dinv, omega)
    _check_vectors(A, x=x, b=b, dinv=dinv)
    y = torch.empty_like(x)
    r = torch.empty_like(x)
    _launch_chain(_JACOBI_RES, A, None, x, b, dinv, None, omega, y, r)
    _count("dia_jacobi_res", A)
    return y, r


def dia_zero_chain(A: DIAMatrix, St: DIAMatrix, b, dinv, tv, omega):
    """The zero-entry level front-end in one pass: (x, y) =
    (omega * dinv * b, tv * (St @ (b - A @ x))); the residual is never
    stored."""
    if _build.on_cpu(A.data, St.data, b, dinv, tv):
        return dia_zero_chain_ref(A, St, b, dinv, tv, omega)
    _check_vectors(A, b=b, dinv=dinv, tv=tv)
    x = torch.empty_like(b)
    y = torch.empty_like(b)
    _launch_chain(_ZERO_CHAIN, A, St, None, b, dinv, tv, omega, x, y)
    _count("dia_zero_chain", A)
    return x, y


def dia_spmm(A: DIAMatrix, Xk):
    """Y = A @ X lane by lane for a K-major stack Xk (K, n_pad) (K8)."""
    if _build.on_cpu(A.data, Xk):
        return dia_spmm_ref(A, Xk)
    _check_stacks(A, None, Xk=Xk)
    Yk = torch.empty_like(Xk)
    _launch_k("dia_spmm", _SPMM, A, Xk, None, None, 0.0, Yk)
    return Yk


def dia_spmm_scaled(A: DIAMatrix, Rk, s):
    """s * (A @ R) lane by lane, with the shared scale s (n_pad,) in the
    epilogue (the structured restrictor's tv factor; K8 ``scale``)."""
    if _build.on_cpu(A.data, Rk, s):
        return dia_spmm_scaled_ref(A, Rk, s)
    _check_stacks(A, None, Rk=Rk)
    _check_vectors(A, s=s)
    Yk = torch.empty_like(Rk)
    _launch_k("dia_spmm_scaled", _SPMM_SCALED, A, Rk, s, None, 0.0, Yk)
    return Yk


def dia_spmm_add(A: DIAMatrix, Tk, Xk):
    """X + A @ T lane by lane, with the per-lane add in the epilogue (the
    structured prolongator's correction add; K8 ``addk``)."""
    if _build.on_cpu(A.data, Tk, Xk):
        return dia_spmm_add_ref(A, Tk, Xk)
    _check_stacks(A, Tk.shape[0], Tk=Tk, Xk=Xk)
    Yk = torch.empty_like(Tk)
    _launch_k("dia_spmm_add", _SPMM_ADD, A, Tk, Xk, None, 0.0, Yk)
    return Yk


def dia_jacobi_k(A: DIAMatrix, Xk, Bk, dinv, omega):
    """One weighted-Jacobi sweep per lane, X + omega * dinv * (B - A @ X)
    (K9)."""
    if _build.on_cpu(A.data, Xk, Bk, dinv):
        return dia_jacobi_k_ref(A, Xk, Bk, dinv, omega)
    _check_stacks(A, Xk.shape[0], Xk=Xk, Bk=Bk)
    _check_vectors(A, dinv=dinv)
    Yk = torch.empty_like(Xk)
    _launch_k("dia_jacobi_k", _JACOBI_K, A, Xk, Bk, dinv, omega, Yk)
    return Yk


def dia_jacobi_zero_res_k(A: DIAMatrix, Bk, dinv, omega):
    """Zero-guess Jacobi sweep and its residual per lane in one pass:
    (X, R) = (omega * dinv * B, B - A @ X) (K10)."""
    if _build.on_cpu(A.data, Bk, dinv):
        return dia_jacobi_zero_res_k_ref(A, Bk, dinv, omega)
    _check_stacks(A, None, Bk=Bk)
    _check_vectors(A, dinv=dinv)
    Xk = torch.empty_like(Bk)
    Rk = torch.empty_like(Bk)
    _launch_k("dia_jacobi_zero_res_k", _ZERO_RES_K, A, None, Bk, dinv, omega,
              Xk, Rk)
    return Xk, Rk


def dia_jacobi_res_k(A: DIAMatrix, Xk, Bk, dinv, omega):
    """(Y, B - A @ Y), Y = X + omega * dinv * (B - A @ X), per lane: the
    reference's batch rule of the Jacobi-plus-residual step, K9 then the
    residual through K8."""
    Yk = dia_jacobi_k(A, Xk, Bk, dinv, omega)
    return Yk, Bk - dia_spmm(A, Yk)


def dia_zero_chain_k(A: DIAMatrix, St: DIAMatrix, Bk, dinv, tv, omega):
    """The zero-entry level front-end per lane in one pass: (X, Y) =
    (omega * dinv * B, tv * (St @ (B - A @ X))); the residual is never
    stored (K11)."""
    if _build.on_cpu(A.data, St.data, Bk, dinv, tv):
        return dia_zero_chain_k_ref(A, St, Bk, dinv, tv, omega)
    _kernel_operand(A)
    _kernel_operand(St, "St")
    if St.dtype != A.dtype or St.n_pad != A.n_pad:
        raise ValueError(f"St: expected {A.dtype} with n_pad {A.n_pad}, "
                         f"got {St.dtype} with n_pad {St.n_pad}")
    _check_stacks(A, None, Bk=Bk)
    _check_vectors(A, dinv=dinv, tv=tv)
    suffix, c_scalar = _KERNEL_DTYPES[A.dtype]
    fn_name = f"pyamg_dia_zero_chain_k_{suffix}"
    fn = getattr(_build.library(), fn_name)
    w, w_dev = _omega_args(omega, A, c_scalar)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    Xk = torch.empty_like(Bk)
    Yk = torch.empty_like(Bk)
    for k0, k1 in _build.lane_chunks(Bk.shape[0]):
        err = fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                 St.data.data_ptr(), St.offsets_t.data_ptr(), St.ndiags,
                 A.n_pad, k1 - k0, Bk[k0:k1].data_ptr(), dinv.data_ptr(),
                 tv.data_ptr(), w, w_dev, Xk[k0:k1].data_ptr(),
                 Yk[k0:k1].data_ptr(), stream)
        _build.check(fn_name, err)
        _count("dia_zero_chain_k", A)
    return Xk, Yk


# ---------------------------------------------------------------------------
# device-built operators (plain PyTorch)
# ---------------------------------------------------------------------------

def dia_from_stencil(S, grid, dtype=torch.float32, device=None):
    """A grid-stencil DIA operator built on ``device`` (the device analog of
    ``gallery.stencil_grid``): each nonzero entry of the centred stencil
    array S becomes one diagonal, its constant value masked by boundary
    validity per grid dimension.  ``device=None`` is the CUDA device."""
    device = resolve_device(device)
    S = np.asarray(S)
    grid = tuple(int(g) for g in grid)
    dim = len(grid)
    if S.ndim != dim:
        raise ValueError("stencil dim must match grid dim")
    if np.iscomplexobj(S) or dtype.is_complex:
        raise NotImplementedError("complex DIA is not ported yet "
                                  "(ROADMAP.md Queue 1 item 2)")
    center = tuple(s // 2 for s in S.shape)
    n = int(np.prod(grid))
    entries = []
    for idx in np.ndindex(*S.shape):
        v = S[idx]
        if v == 0:
            continue
        coords = tuple(int(i) - c for i, c in zip(idx, center))
        off = 0
        stride_acc = 1
        for d in range(dim - 1, -1, -1):
            off += coords[d] * stride_acc
            stride_acc *= grid[d]
        entries.append((int(off), coords, float(v)))
    entries.sort(key=lambda e: e[0])
    nnz = 0
    for _off, coords, _v in entries:
        count = 1
        for d in range(dim):
            count *= grid[d] - abs(coords[d])
        nnz += count
    rows = []
    for _off, coords, v in entries:
        mask = None
        for d in range(dim):
            i = torch.arange(grid[d], device=device)
            ok = (i + coords[d] >= 0) & (i + coords[d] < grid[d])
            shape = [1] * dim
            shape[d] = grid[d]
            ok = ok.reshape(shape)
            mask = ok if mask is None else (mask & ok)
        rows.append(torch.where(mask, torch.tensor(v, dtype=dtype,
                                                   device=device),
                                0).reshape(-1))
    return DIAMatrix(data=torch.stack(rows), offsets=tuple(e[0] for e in entries),
                     shape=(n, n), nnz=int(nnz))


def dia_spgemm(A: DIAMatrix, B: DIAMatrix):
    """C = A @ B for banded operands, by rolls and elementwise products:
    C_data[oa + ob] += A_data[oa] * roll(B_data[ob], -oa), accumulated in
    the reference's order (A's offsets outer, B's inner).  Wrapped terms
    vanish because out-of-range entries store zero."""
    if A.shape[1] != B.shape[0]:
        raise ValueError("dimension mismatch")
    if A.n_pad != B.n_pad:
        raise ValueError("operands must share padding")
    acc = {}
    for da, oa in enumerate(A.offsets):
        a = A.data[da]
        for db, ob in enumerate(B.offsets):
            oc = oa + ob
            term = a * torch.roll(B.data[db], -oa)
            acc[oc] = acc[oc] + term if oc in acc else term
    offsets = tuple(sorted(acc))
    nnz_est = min(A.nnz * max(len(B.offsets), 1), len(offsets) * A.shape[0])
    return DIAMatrix(data=torch.stack([acc[o] for o in offsets]),
                     offsets=offsets, shape=(A.shape[0], B.shape[1]),
                     nnz=int(nnz_est))


def dia_transpose(A: DIAMatrix) -> DIAMatrix:
    """Transpose of a DIAMatrix, by rolls only
    (``pyamg_tpu/engine/device_setup.py::dia_transpose``).

    B = A^T has B[j, j+p] = A[j+p, j] = A_data[d(-p)][j+p], so
    B_data[p] = roll(A_data[d(-p)], -p).  Wrapped entries land on
    positions whose source entries are stored as zero."""
    lookup = {o: d for d, o in enumerate(A.offsets)}
    offsets = tuple(sorted(-o for o in A.offsets))
    data = torch.stack([torch.roll(A.data[lookup[-p]], -p) for p in offsets])
    return DIAMatrix(data=data, offsets=offsets,
                     shape=(A.shape[1], A.shape[0]), nnz=A.nnz)
