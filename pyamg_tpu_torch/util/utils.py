"""Host sparse helpers of the port's SA setup and its block compile (a
copy of the parts of ``pyamg_tpu/util/utils.py`` that they call)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..amg_core import native
from .linalg import pinv_array

__all__ = ["upcast", "asfptype", "get_diagonal", "get_block_diag",
           "scale_rows", "amalgamate", "galerkin_product"]


def galerkin_product(R, A, P):
    """A_c = R @ A @ P (real CSR) through the native parallel SpGEMM;
    scipy when int32 output indices would overflow."""
    A, R, P = sp.csr_matrix(A), sp.csr_matrix(R), sp.csr_matrix(P)
    AP = native().spgemm(A, P)
    if AP is not None:
        Ac = native().spgemm(R, AP)
        if Ac is not None:
            return Ac
    return sp.csr_matrix(R @ (A @ P))


def upcast(*dtypes):
    """Smallest float/complex type containing all arguments."""
    result = np.dtype(np.float32)
    for t in dtypes:
        result = np.promote_types(result, np.dtype(t))
    if result.kind not in "fc":
        result = np.dtype(np.float64)
    return result


def asfptype(A):
    """Upcast a sparse matrix to a floating-point dtype if needed."""
    if np.dtype(A.dtype).kind in "fc":
        return A
    return A.astype(np.float64)


def get_diagonal(A, inv=False):
    """Diagonal of A, optionally inverted (zero where the diagonal is)."""
    d = A.diagonal()
    if inv:
        with np.errstate(divide="ignore", invalid="ignore"):
            dinv = np.where(d != 0, 1.0 / d, 0.0)
        return dinv.astype(upcast(A.dtype))
    return d


def scale_rows(A, v, copy=True):
    """Scale row i of the sparse matrix A by v[i] (as CSR)."""
    v = np.ravel(np.asarray(v))
    A = A.tocsr(copy=copy) if A.format != "csr" else (A.copy() if copy
                                                     else A)
    if len(v) != A.shape[0]:
        raise ValueError("vector length must match rows of A")
    A.data *= np.repeat(v, np.diff(A.indptr))
    return A


def get_block_diag(A, blocksize, inv_flag=True):
    """The (n / bs, bs, bs) diagonal blocks of A, pseudo-inverted when
    ``inv_flag``."""
    if A.shape[0] % blocksize != 0:
        raise ValueError("matrix dimension must be divisible by blocksize")
    nblocks = A.shape[0] // blocksize
    if (sp.issparse(A) and A.format == "bsr"
            and A.blocksize == (blocksize, blocksize)):
        Ab = A
    else:
        Ab = sp.csr_matrix(A).tobsr(blocksize=(blocksize, blocksize))
    out = np.zeros((nblocks, blocksize, blocksize), dtype=Ab.dtype)
    rows = np.repeat(np.arange(nblocks), np.diff(Ab.indptr))
    mask = Ab.indices == rows
    out[rows[mask]] = Ab.data[mask]
    if inv_flag:
        pinv_array(out)
    return out


def amalgamate(A, bs):
    """The node graph of A: each stored bs x bs block becomes a 1."""
    if bs == 1:
        return A
    Ab = sp.csr_matrix(A).tobsr(blocksize=(bs, bs))
    n = Ab.shape[0] // bs
    data = np.ones(Ab.indices.shape[0], dtype=A.dtype)
    return sp.csr_matrix((data, Ab.indices.copy(), Ab.indptr.copy()),
                         shape=(n, Ab.shape[1] // bs))
