"""Host sparse helpers of the port's host setups (SA, rootnode,
Ruge-Stuben) and its block compile (a copy of the parts of
``pyamg_tpu/util/utils.py`` that they call)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..amg_core import native
from .linalg import pinv_array

__all__ = ["upcast", "asfptype", "blocksize", "get_diagonal",
           "get_block_diag", "scale_rows", "scale_rows_by_largest_entry",
           "amalgamate", "unamal", "galerkin_product",
           "levelize_strength_or_aggregation",
           "levelize_smooth_or_improve_candidates", "get_Cpt_params",
           "scale_T", "compute_BtBinv", "conj_transpose_csr"]


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


def blocksize(A):
    """Row blocksize of A (1 unless BSR)."""
    if sp.issparse(A) and A.format == "bsr":
        return A.blocksize[0]
    return 1


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


def scale_rows_by_largest_entry(A):
    """Scale each row of A by one over its largest-magnitude entry."""
    A = sp.csr_matrix(A)
    nnz_per_row = np.diff(A.indptr)
    absdata = np.abs(A.data)
    rowmax = np.zeros(A.shape[0], dtype=absdata.dtype)
    nz_rows = nnz_per_row > 0
    if A.nnz:
        rowmax[nz_rows] = np.maximum.reduceat(absdata, A.indptr[:-1][nz_rows])
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(rowmax != 0, 1.0 / rowmax, 0.0)
    return scale_rows(A, scale, copy=True)


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


def unamal(A, rows_per_block, cols_per_block):
    """Expand the scalar pattern of A into dense blocks of ones."""
    A = sp.csr_matrix(A)
    data = np.ones((A.nnz, rows_per_block, cols_per_block), dtype=A.dtype)
    return sp.bsr_matrix(
        (data, A.indices, A.indptr),
        shape=(rows_per_block * A.shape[0], cols_per_block * A.shape[1]),
    ).tocsr()


def levelize_strength_or_aggregation(to_levelize, max_levels, max_coarse):
    """A strength or aggregate spec ('name', ('name', kwargs), None or a
    list of those) as a per-level list; 'predefined' pins max_levels.
    Returns (max_levels, max_coarse, levelized list)."""
    if isinstance(to_levelize, tuple):
        if to_levelize[0] == "predefined":
            to_levelize = [to_levelize]
            max_levels = 2
            max_coarse = 0
        else:
            to_levelize = [to_levelize for _ in range(max_levels - 1)]
    elif isinstance(to_levelize, str):
        if to_levelize == "predefined":
            raise ValueError("predefined requires a tuple with the operators")
        to_levelize = [to_levelize for _ in range(max_levels - 1)]
    elif to_levelize is None:
        to_levelize = [(None, {}) for _ in range(max_levels - 1)]
    elif isinstance(to_levelize, list):
        if (isinstance(to_levelize[-1], tuple)
                and to_levelize[-1][0] == "predefined"):
            max_levels = len(to_levelize) + 1
            max_coarse = 0
        elif len(to_levelize) < max_levels - 1:
            mini = to_levelize[-1]
            to_levelize.extend(
                [mini for _ in range(max_levels - 1 - len(to_levelize))])
        to_levelize = [(lvl, {}) if lvl is None else lvl
                       for lvl in to_levelize]
    else:
        raise ValueError(f"invalid spec: {to_levelize}")
    return max_levels, max_coarse, to_levelize


def levelize_smooth_or_improve_candidates(to_levelize, max_levels):
    """A smooth or improve_candidates spec as a per-level list; a tuple
    of specs, such as the default ``(('block_gauss_seidel', {...}),
    None)``, is a per-level list."""
    if isinstance(to_levelize, tuple) and not (
            len(to_levelize) and isinstance(to_levelize[0], str)):
        to_levelize = list(to_levelize)
    if isinstance(to_levelize, (str, tuple)):
        return [to_levelize for _ in range(max_levels)]
    if to_levelize is None:
        return [None for _ in range(max_levels)]
    if isinstance(to_levelize, list):
        if len(to_levelize) < max_levels:
            to_levelize.extend(
                [to_levelize[-1] for _ in range(max_levels - len(to_levelize))])
        return to_levelize
    raise ValueError(f"invalid spec: {to_levelize}")


def get_Cpt_params(A, Cnodes, AggOp, T):
    """Rootnode bookkeeping: the injection ``P_I`` (n, ncoarse) with an
    identity block at each root's first k dofs, the identities ``I_F`` and
    ``I_C`` restricted to the F and C dofs, and the dof lists ``Cpts`` and
    ``Fpts``."""
    bs = blocksize(A)
    Cnodes = np.asarray(Cnodes, dtype=np.int64)
    n = A.shape[0]
    ncoarse = T.shape[1]
    n_agg = AggOp.shape[1]
    if ncoarse % n_agg != 0:
        raise ValueError("T column count must be a multiple of #aggregates")
    k = ncoarse // n_agg
    if k > bs:
        raise ValueError(
            f"rootnode requires #candidates ({k}) <= blocksize ({bs}); "
            "truncate B first")
    Cpts = (bs * Cnodes[:, None] + np.arange(k)[None, :]).ravel()
    mask = np.zeros(n, dtype=bool)
    mask[Cpts] = True
    Fpts = np.flatnonzero(~mask)

    cols = (np.arange(n_agg)[:, None] * k + np.arange(k)[None, :]).ravel()
    rows = (bs * Cnodes[:, None] + np.arange(k)[None, :]).ravel()
    P_I = sp.csr_matrix(
        (np.ones(len(rows), dtype=T.dtype), (rows, cols)), shape=(n, ncoarse))
    I_F = sp.csr_matrix(
        (np.ones(len(Fpts), dtype=T.dtype), (Fpts, Fpts)), shape=(n, n))
    I_C = sp.csr_matrix(
        (np.ones(len(Cpts), dtype=T.dtype), (Cpts, Cpts)), shape=(n, n))
    return {"P_I": P_I, "I_F": I_F, "I_C": I_C, "Cpts": Cpts, "Fpts": Fpts}


def scale_T(T, P_I, I_F):
    """T <- I_F T (P_I^T T)^+ + P_I: the tentative prolongator scaled so
    that its root rows are the identity.  P_I^T T is block diagonal with
    k x k blocks, pseudo-inverted as one batch."""
    T = sp.csr_matrix(T)
    ncoarse = T.shape[1]
    Tc = sp.coo_matrix(P_I.T @ T)
    if Tc.nnz == 0:
        return T
    k = 1
    while k < 8 and not (Tc.row // k == Tc.col // k).all():
        k += 1
    if not (Tc.row // k == Tc.col // k).all():
        Tcinv = sp.csr_matrix(np.linalg.pinv(Tc.toarray()))
        out = ((I_F @ T) @ Tcinv + P_I).tocsr()
        out.eliminate_zeros()
        return out
    nb = ncoarse // k
    blocks = np.zeros((nb, k, k), dtype=T.dtype)
    blocks[Tc.row // k, Tc.row % k, Tc.col % k] = Tc.data
    pinv_array(blocks)
    rows = np.arange(nb)[:, None, None] * k + np.arange(k)[None, :, None]
    cols = np.arange(nb)[:, None, None] * k + np.arange(k)[None, None, :]
    rows = np.broadcast_to(rows, (nb, k, k)).ravel()
    cols = np.broadcast_to(cols, (nb, k, k)).ravel()
    Tcinv = sp.csr_matrix((blocks.ravel(), (rows, cols)),
                          shape=(ncoarse, ncoarse))
    out = ((I_F @ T) @ Tcinv + P_I).tocsr()
    out.eliminate_zeros()
    return out


def compute_BtBinv(B, C):
    """(nrows, k, k): for each row i of the pattern C, the pseudo-inverse
    of B_J^H B_J over the rows J of B that row i's columns index, one
    padded batch (the reference's batching, so the same rounding)."""
    B = np.asarray(B)
    if B.ndim == 1:
        B = B.reshape(-1, 1)
    C = sp.csr_matrix(C)
    nrows = C.shape[0]
    lens = np.diff(C.indptr)
    maxlen = int(lens.max()) if nrows else 0
    pad_idx = np.zeros((nrows, maxlen), dtype=np.int64)
    mask = np.arange(maxlen)[None, :] < lens[:, None]
    if C.nnz:
        pad_idx[mask] = C.indices
    Bn = B[pad_idx]
    Bn = np.where(mask[:, :, None], Bn, 0)
    G = np.einsum("rmk,rml->rkl", Bn.conj(), Bn)
    pinv_array(G)
    return G


def conj_transpose_csr(M):
    """M^H as CSR (no conjugate copy of real data)."""
    M = M if sp.issparse(M) else sp.csr_matrix(M)
    if np.iscomplexobj(M.data):
        return M.conjugate().T.tocsr()
    return M.T.tocsr()
