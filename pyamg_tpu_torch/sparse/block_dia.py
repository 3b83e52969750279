"""Block-DIA device format: BSR operators on a node grid (counterpart of
``pyamg_tpu/sparse/block_dia.py``).

A BSR operator on a lexicographic node grid is block-banded, so it is
stored by block diagonal: ``data[d, i] = A_block[i, i + offsets[d]]``
(bs x bs; a zero block where A has none or the column falls outside the
matrix), offsets in block units, and applied as

    y_blk[i] = sum_d data[d, i] @ x_blk[i + offsets[d]]

The reference applies it with one roll and bs^2 elementwise mul-adds per
diagonal (its TPU vectorizes those).  Here one apply is five kernels
whatever the diagonal count: x is zero-padded by the largest offset on
both sides (a fill and a copy); each run of consecutive offsets (a 9-point node stencil has
three) reads its neighbours as one strided view of overlapping windows,
and one ``cat`` lays the runs side by side, so row i holds its (ndiags *
bs) neighbour values in diagonal order; one product with ``data`` laid
out once per operator as (nb_pad, bs, ndiags * bs) row strips, and one
sum over the strip, give y.  The padding stands for the reference's
roll: a block that falls outside the matrix is stored as zero, so the
neighbour it meets (a wrapped one there, a padded zero here) contributes
exactly zero.

No Pallas kernel stands behind this format in the reference (its block
algebra is plain ``jnp``), so it is plain PyTorch here too.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

__all__ = ["BlockDIAMatrix", "block_dia_from_scipy"]


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
        out = []
        for o in self.offsets:
            if out and out[-1][0] + out[-1][1] == o:
                out[-1][1] += 1
            else:
                out.append([o, 1])
        return tuple((o, n) for o, n in out)

    @property
    def halo(self):
        """The largest |offset|, in blocks: the zero padding of x."""
        return max((abs(o) for o in self.offsets), default=0)

    @cached_property
    def row_strips(self) -> torch.Tensor:
        """(nb_pad, bs, ndiags * bs): row i's blocks side by side,
        ``[i, p, d * bs + q] = data[d, i, p, q]``."""
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
        layout (the coarse densify's)."""
        return block_dia_apply(self, X.T).T

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


def block_dia_apply(A: BlockDIAMatrix, x):
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
