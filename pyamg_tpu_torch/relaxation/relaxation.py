"""Host Gauss-Seidel for the port's candidate improvement (a copy of
``pyamg_tpu/relaxation/relaxation.py::gauss_seidel``, its native sweep,
and ``block_gauss_seidel``: the pointwise sweep at blocksize 1, the
reference's loop over node blocks above it).  The other host relaxations
are ROADMAP.md Queue 1 item 16."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..amg_core import native
from ..util.utils import get_block_diag, upcast

__all__ = ["make_system", "gauss_seidel", "block_gauss_seidel"]


def make_system(A, x, b, formats=None):
    """Check and canonicalise a relaxation system (A, x, b): A square
    sparse (CSR unless its format is in ``formats``), x and b raveled,
    x's dtype containing A's and b's."""
    if formats is not None and not (sp.issparse(A) and A.format in formats):
        A = sp.csr_matrix(A)
    if not sp.issparse(A):
        A = sp.csr_matrix(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    x = np.ravel(np.asarray(x))
    b = np.ravel(np.asarray(b))
    if x.shape[0] != A.shape[0] or b.shape[0] != A.shape[0]:
        raise ValueError("x and b must match dimensions of A")
    if upcast(A.dtype, x.dtype, b.dtype) != x.dtype:
        raise TypeError("x must have a dtype containing A and b dtypes")
    return A, x, b


def gauss_seidel(A, x, b, iterations=1, sweep="forward"):
    """Gauss-Seidel with exact sequential semantics, in place on a
    contiguous float64 x; sweep in {'forward', 'backward', 'symmetric'}."""
    A, x, b = make_system(A, x, b, formats=["csr"])
    if sweep not in ("forward", "backward", "symmetric"):
        raise ValueError("sweep must be forward/backward/symmetric")
    iters = int(iterations)
    if sweep == "symmetric":
        for _ in range(iters):
            gauss_seidel(A, x, b, iterations=1, sweep="forward")
            gauss_seidel(A, x, b, iterations=1, sweep="backward")
        return x
    if x.dtype != np.float64 or np.iscomplexobj(A.data):
        raise NotImplementedError(
            "host Gauss-Seidel on other than real float64 is not ported to "
            "pyamg_tpu_torch yet (ROADMAP.md Queue 1 item 16)")
    n = A.shape[0]
    # the int64 index views the ctypes ABI takes, cached on the matrix
    cache = getattr(A, "_amgcore_i64", None)
    if cache is None or cache[0] is not A.indptr:
        cache = (A.indptr,
                 np.ascontiguousarray(A.indptr, dtype=np.int64),
                 np.ascontiguousarray(A.indices, dtype=np.int64))
        try:
            A._amgcore_i64 = cache
        except AttributeError:
            pass
    _, ip64, ix64 = cache
    for _ in range(iters):
        if sweep == "forward":
            native().gauss_seidel(ip64, ix64, A.data, x, b, 0, n, 1)
        else:
            native().gauss_seidel(ip64, ix64, A.data, x, b, n - 1, -1, -1)
    return x


def _resolve_blocksize(A, blocksize):
    if blocksize is None:
        return A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
    return int(blocksize)


def block_gauss_seidel(A, x, b, iterations=1, sweep="forward",
                       blocksize=None, Dinv=None):
    """Block Gauss-Seidel in place: with blocksize 1 the pointwise sweep;
    above it, node block by node block, x_i <- Dinv_i (b_i - sum_{j != i}
    A_ij x_j) with the reference's summation (all of the row's block
    products, then the diagonal block's subtracted), so the improved
    candidates have its bits."""
    A, x, b = make_system(A, x, b)
    bs = _resolve_blocksize(A, blocksize)
    if bs == 1:
        return gauss_seidel(A, x, b, iterations=iterations, sweep=sweep)
    if sweep == "symmetric":
        for _ in range(int(iterations)):
            block_gauss_seidel(A, x, b, 1, "forward", bs, Dinv)
            block_gauss_seidel(A, x, b, 1, "backward", bs, Dinv)
        return x
    if sweep not in ("forward", "backward"):
        raise ValueError("sweep must be forward/backward/symmetric")
    if Dinv is None:
        Dinv = get_block_diag(A, bs, inv_flag=True)
    Ab = A if (A.format == "bsr" and A.blocksize == (bs, bs)) else \
        A.tobsr(blocksize=(bs, bs))
    n_blocks = A.shape[0] // bs
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
    xb = x.reshape(n_blocks, bs)
    bb = b.reshape(n_blocks, bs)
    order = (range(n_blocks) if sweep == "forward"
             else range(n_blocks - 1, -1, -1))
    for _ in range(int(iterations)):
        for i in order:
            s, e = indptr[i], indptr[i + 1]
            cols = indices[s:e]
            rsum = np.einsum("kij,kj->i", data[s:e], xb[cols])
            dmask = cols == i
            if dmask.any():
                rsum = rsum - data[s:e][dmask][0] @ xb[i]
            xb[i] = Dinv[i] @ (bb[i] - rsum)
    return x
