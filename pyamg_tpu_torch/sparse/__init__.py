"""Device sparse formats and their kernels (counterpart of
``pyamg_tpu/sparse``)."""

import numpy as np
import torch

from .block_dia import BlockDIAMatrix, block_dia_from_scipy
from .composed import ComposedOperator
from .dia import (DenseOperator, DIAMatrix, dense_from_scipy, dia_from_scipy,
                  dia_from_stencil, dia_jacobi, dia_jacobi_k, dia_jacobi_res,
                  dia_jacobi_res_k, dia_jacobi_zero_res,
                  dia_jacobi_zero_res_k, dia_spgemm,
                  dia_spmm, dia_spmm_add, dia_spmm_scaled, dia_spmv,
                  dia_spmv_add, dia_spmv_scaled, dia_zero_chain,
                  dia_zero_chain_k)
from .formats import pad_to, pad_vector
from .window import (TransposedWindowed, WindowedELL, windowed_from_scipy,
                     windowed_matmat_k, windowed_matvec, windowed_rmatmat_k,
                     windowed_rmatvec, windowed_select)

__all__ = [
    "BlockDIAMatrix",
    "ComposedOperator",
    "DenseOperator",
    "DIAMatrix",
    "TransposedWindowed",
    "WindowedELL",
    "block_dia_from_scipy",
    "dense_from_scipy",
    "dia_from_scipy",
    "dia_from_stencil",
    "dia_jacobi",
    "dia_jacobi_k",
    "dia_jacobi_res",
    "dia_jacobi_res_k",
    "dia_jacobi_zero_res",
    "dia_jacobi_zero_res_k",
    "dia_spgemm",
    "dia_spmm",
    "dia_spmm_add",
    "dia_spmm_scaled",
    "dia_spmv",
    "dia_spmv_add",
    "dia_spmv_scaled",
    "dia_zero_chain",
    "dia_zero_chain_k",
    "pad_to",
    "pad_vector",
    "select_operator",
    "windowed_from_scipy",
    "windowed_matmat_k",
    "windowed_matvec",
    "windowed_rmatmat_k",
    "windowed_rmatvec",
    "windowed_select",
]


def select_operator(A, dtype=torch.float32, device=None, row_pad=8,
                    dense_threshold=2048, max_diags=600):
    """Pick the device format for a scipy operator, by the JAX package's
    rules (``pyamg_tpu/sparse/__init__.py::select_operator``):

    - small (either dim <= dense_threshold): DenseOperator;
    - square with <= max_diags distinct diagonals: DIAMatrix;
    - otherwise WindowedELL.

    The reference's last resort, gather ELL, is not ported yet (ROADMAP.md
    Queue 1 item 1) and raises."""
    if device is None:
        raise ValueError("pass device= explicitly")
    if np.iscomplexobj(getattr(A, "data", np.zeros(0))) or dtype.is_complex:
        raise NotImplementedError("complex operators are not ported yet "
                                  "(ROADMAP.md Queue 1 item 2)")
    n, m = A.shape
    if max(n, m) <= dense_threshold:
        return dense_from_scipy(A, dtype=dtype, device=device,
                                row_pad=row_pad)
    if n == m:
        dia = dia_from_scipy(A, dtype=dtype, device=device, row_pad=row_pad,
                             max_diags=max_diags)
        if dia is not None:
            return dia
    win = windowed_from_scipy(A, dtype=dtype, device=device)
    if win is not None:
        return win
    raise NotImplementedError(
        f"operator {A.shape} is neither DIA nor windowable; its gather-ELL "
        "form is not ported yet (ROADMAP.md Queue 1 item 1)")
