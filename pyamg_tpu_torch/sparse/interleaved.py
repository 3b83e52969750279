"""Interleaved (S, K, 128) lane stacks and their DIA kernel, K15
(counterpart of ``pyamg_tpu/sparse/interleaved.py``).

A K-major (K, n_pad) lane stack, n_pad = 128 S, is stored interleaved by
128-row tiles as (S, K, 128): one tile of all K lanes is one contiguous
(K, 128) block, and row i of lane k lives at (i // 128, k, i % 128).  The
operator's DIA data stays (nd, n_pad); only the lane vectors are
interleaved, once per solve (``engine/batched_cycle.py``).

Kernel entry points (``csrc/interleaved.cu``, one template in five
modes; TPU: ``_spmv_kernel``/``_run``), with wd = omega * dinv per row:

- :func:`int_jacobi_zero_res`  (x, r) = (wd b, b - A x)
- :func:`int_spmv_scaled`      z = tv (A r)
- :func:`int_spmv`             y = A t
- :func:`int_spmv_add`         y = x + A t
- :func:`int_jacobi_step`      y = x + wd (b - A x)

Each has a plain PyTorch twin (``*_ref``): the port's K-major DIA twin
through :func:`from_interleaved` / :func:`to_interleaved`.  A wrapper
runs the twin only when its operands lie on the CPU; on CUDA tensors it
launches the kernel, float32 only (the reference's gate), or raises on
an operand the kernel does not take.
"""

from __future__ import annotations

import torch

from .. import _build
from .dia import DIAMatrix, _ptr, dia_spmm_ref

__all__ = ["to_interleaved", "from_interleaved", "int_jacobi_zero_res",
           "int_spmv", "int_spmv_scaled", "int_spmv_add", "int_jacobi_step",
           "int_jacobi_zero_res_ref", "int_spmv_ref", "int_spmv_scaled_ref",
           "int_spmv_add_ref", "int_jacobi_step_ref"]

_LANES = 128
# modes of csrc/interleaved.cu::interleaved_kernel
_ZERO_RES, _SCALED, _PLAIN, _ADD, _JSTEP = 0, 1, 2, 3, 4


def to_interleaved(Xk):
    """(K, n_pad) K-major -> (S, K, 128) interleaved (n_pad % 128 == 0)."""
    K, n_pad = Xk.shape
    return Xk.reshape(K, n_pad // _LANES, _LANES).transpose(0, 1).contiguous()


def from_interleaved(Xi):
    """(S, K, 128) interleaved -> (K, n_pad) K-major."""
    S, K, _ = Xi.shape
    return Xi.transpose(0, 1).reshape(K, S * _LANES)


# ---------------------------------------------------------------------------
# plain PyTorch twins: the K-major DIA twin through the layout change
# ---------------------------------------------------------------------------

def int_jacobi_zero_res_ref(A: DIAMatrix, wd, Bi):
    Xk = wd * from_interleaved(Bi)
    Xi = to_interleaved(Xk)
    return Xi, Bi - to_interleaved(dia_spmm_ref(A, Xk))


def int_spmv_scaled_ref(A: DIAMatrix, Ri, tv):
    return to_interleaved(tv * dia_spmm_ref(A, from_interleaved(Ri)))


def int_spmv_ref(A: DIAMatrix, Ti):
    return to_interleaved(dia_spmm_ref(A, from_interleaved(Ti)))


def int_spmv_add_ref(A: DIAMatrix, Ti, Xi):
    return Xi + int_spmv_ref(A, Ti)


def int_jacobi_step_ref(A: DIAMatrix, wd, Bi, Xi):
    Xk = from_interleaved(Xi)
    return Xi + to_interleaved(
        wd * (from_interleaved(Bi) - dia_spmm_ref(A, Xk)))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(A, stacks, vectors):
    """Raise unless A is a contiguous float32 DIA operator with n_pad a
    multiple of 128, every stack a contiguous float32 (n_pad / 128, K,
    128) tensor with one K, and every vector a contiguous float32
    (n_pad,) vector."""
    if A.dtype != torch.float32 or not A.data.is_contiguous():
        raise TypeError(f"interleaved kernel takes contiguous float32 DIA "
                        f"data, got {A.dtype}")
    if A.n_pad % _LANES:
        raise ValueError(f"interleaved kernel needs n_pad % {_LANES} == 0, "
                         f"got {A.n_pad}")
    K = stacks[0][1].shape[1] if stacks[0][1].ndim == 3 else -1
    for name, v in stacks:
        want = (A.n_pad // _LANES, K, _LANES)
        if tuple(v.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got "
                             f"{tuple(v.shape)}")
        if v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 stack")
    for name, v in vectors:
        _build.check_vector(name, v, A.n_pad, torch.float32)


def _launch(kernel, mode, A, src, aux, vec, out0, out1=None):
    """Launch csrc/interleaved.cu in lane chunks of the (S, K, 128)
    stacks, counting each launch."""
    K = src.shape[1]
    fn = _build.library().pyamg_interleaved_f32
    stream = torch.cuda.current_stream(A.device).cuda_stream
    for k0, k1 in _build.lane_chunks(K):
        err = fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                 A.n_pad, K, k0, k1 - k0, src.data_ptr(), _ptr(aux), _ptr(vec),
                 out0.data_ptr(), _ptr(out1), mode, stream)
        _build.check("pyamg_interleaved_f32", err)
        _build.count_launch(f"{kernel}.float32")


def int_jacobi_zero_res(A: DIAMatrix, wd, Bi):
    """x = wd * b (the zero-guess weighted-Jacobi sweep) and r = b - A x
    in one pass (K15 ``zero_res``)."""
    if _build.on_cpu(A.data, wd, Bi):
        return int_jacobi_zero_res_ref(A, wd, Bi)
    _check(A, [("Bi", Bi)], [("wd", wd)])
    Xi = torch.empty_like(Bi)
    Ri = torch.empty_like(Bi)
    _launch("int_jacobi_zero_res", _ZERO_RES, A, Bi, None, wd, Xi, Ri)
    return Xi, Ri


def int_spmv_scaled(A: DIAMatrix, Ri, tv):
    """z = tv * (A r), the restrictor's tv-scaled S^T apply (K15
    ``scaled``)."""
    if _build.on_cpu(A.data, Ri, tv):
        return int_spmv_scaled_ref(A, Ri, tv)
    _check(A, [("Ri", Ri)], [("tv", tv)])
    Zi = torch.empty_like(Ri)
    _launch("int_spmv_scaled", _SCALED, A, Ri, None, tv, Zi)
    return Zi


def int_spmv(A: DIAMatrix, Ti):
    """y = A t on interleaved stacks (K15 ``plain``)."""
    if _build.on_cpu(A.data, Ti):
        return int_spmv_ref(A, Ti)
    _check(A, [("Ti", Ti)], [])
    Yi = torch.empty_like(Ti)
    _launch("int_spmv", _PLAIN, A, Ti, None, None, Yi)
    return Yi


def int_spmv_add(A: DIAMatrix, Ti, Xi):
    """y = x + A t, the prolongator's smoothing apply with the correction
    add (K15 ``add``)."""
    if _build.on_cpu(A.data, Ti, Xi):
        return int_spmv_add_ref(A, Ti, Xi)
    _check(A, [("Ti", Ti), ("Xi", Xi)], [])
    Yi = torch.empty_like(Ti)
    _launch("int_spmv_add", _ADD, A, Ti, Xi, None, Yi)
    return Yi


def int_jacobi_step(A: DIAMatrix, wd, Bi, Xi):
    """y = x + wd * (b - A x), one weighted-Jacobi sweep (K15
    ``jstep``)."""
    if _build.on_cpu(A.data, wd, Bi, Xi):
        return int_jacobi_step_ref(A, wd, Bi, Xi)
    _check(A, [("Xi", Xi), ("Bi", Bi)], [("wd", wd)])
    Yi = torch.empty_like(Xi)
    _launch("int_jacobi_step", _JSTEP, A, Xi, Bi, wd, Yi)
    return Yi
