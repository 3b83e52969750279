"""Block and multi-candidate device SA setup (counterpart of
``pyamg_tpu/engine/block_setup.py``).

The structured device setup (``engine/device_setup.py``) generalised to
block unknowns (a BSR operator of bs x bs node blocks on a node grid) and
to m-column candidate blocks (m <= 4; elasticity's three rigid-body
modes).  Aggregates are stride^d blocks of the node grid, as in the
scalar setup.  The tentative prolongator's per-aggregate QR of the
candidate block is the reference's Gram form: per-aggregate Gram matrices
G = B_agg^T B_agg from block sums, a batched Cholesky unrolled over the
static m, and Q = B_agg L^-T evaluated node by node; the coarse
candidates are L^T (``fit_candidates``' R factor).  The smoothed
prolongator's factors, A and the Galerkin product are rectangular
block-DIA operators on the fine node grid (shifted slices and batched
bs x bs products, ``_bspgemm``), and each coarse operator is the strided slice of
its fine-grid embedding.  The finest level carries the input block size;
every coarser level has m x m blocks (one coarse unknown per candidate
per aggregate).

Every step runs eagerly in plain PyTorch on the device; nothing is read
to the host (the smoother weights and spectral-radius estimates stay 0-d
tensors).  No Pallas kernel stands behind any of it in the reference.
The solve applies the block transfers factored (:class:`
BlockStructuredProlongator`, :class:`BlockStructuredRestrictor`: the
block-DIA S or S^T through B1 and the candidates' remap Q, built on the
device at setup as an m-slot WindowedELL, through K6 or K7), the
block-DIA levels through :class:`~pyamg_tpu_torch.sparse.block_dia.
BlockDIAMatrix`, and the dense coarsest level through its pseudo-inverse.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..backend import resolve_device
from ..relaxation.chebyshev import chebyshev_polynomial_coefficients
from ..sparse.block_dia import BlockDIAMatrix, block_dia_from_scipy
from ..sparse.formats import fit
from ..sparse.window import TransposedWindowed
from . import relaxation as device_relaxation
from .device_setup import (StructuredDeviceSolver, _block_sum,
                           _broadcast_coarse, _check_dtype, _coarse_index,
                           _compact_fine, _coords_to_offset, _dense_level,
                           _grid_pad_vec, _grid_pads, _ns_pinv,
                           _offset_to_coords, _padded_grid,
                           _shared_factor, _spec_key, _transfer_block,
                           _windowed_rows)
from .hierarchy import DeviceHierarchy, DeviceLevel
from .relaxation import _block_apply
from .setup import _hash_weights

__all__ = ["BlockStructuredDeviceSolver", "BlockStructuredProlongator",
           "BlockStructuredRestrictor", "device_sa_setup_block"]


# ---------------------------------------------------------------------------
# rectangular block-DIA (setup-transient): data (ndiags, nb_pad, r, c)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _BDia:
    data: torch.Tensor           # (ndiags, nb_pad, r, c)
    offsets: Tuple[int, ...]


def _bmm_small(a, b):
    """a (n, p, q) @ b (..., n, q, r) block by block, for small q: q
    elementwise multiply-adds (a batched library product splits a million
    tiny products into many slow launches)."""
    out = a[:, :, 0, None] * b[..., 0, None, :]
    for j in range(1, a.shape[-1]):
        out = out.addcmul_(a[:, :, j, None], b[..., j, None, :])
    return out


def _bspgemm(A: _BDia, B: _BDia, keep=None) -> _BDia:
    """C = A @ B for embedded block-DIA operands on one node grid:
    C[oa + ob] += A[oa] @ roll(B[ob], -oa) block by block.  ``keep``
    restricts the output offsets.

    One batched product per diagonal of A (:func:`_bmm_small`), against
    every diagonal of B it meets at once, and one ``index_add_`` into C
    (the outputs of one A diagonal are distinct offsets, so each entry
    takes one add per A diagonal, in the reference's order).  Row i of
    A[oa] is zero where i + oa leaves the grid, so those rows (the
    reference's wrapped terms, exactly zero) are skipped instead of
    rolled."""
    nb = A.data.shape[1]
    out_offs = sorted({oa + ob for oa in A.offsets for ob in B.offsets
                       if keep is None or oa + ob in keep})
    pos = {o: i for i, o in enumerate(out_offs)}
    out = A.data.new_zeros((len(out_offs), nb, A.data.shape[2],
                            B.data.shape[3]))
    # per A diagonal: the B diagonals it meets and their outputs' places,
    # sent to the device in one copy
    plan = []
    for da, oa in enumerate(A.offsets):
        sel = [db for db, ob in enumerate(B.offsets)
               if keep is None or oa + ob in keep]
        if sel and max(0, -oa) < min(nb, nb - oa):
            plan.append((da, oa, sel, [pos[oa + B.offsets[db]]
                                       for db in sel]))
    flat = [v for _, _, sel, idx in plan for v in sel + idx]
    meta = torch.tensor(flat, dtype=torch.int64, device=out.device)
    at = 0
    for da, oa, sel, _ in plan:
        k = len(sel)
        lo, hi = max(0, -oa), min(nb, nb - oa)
        b = B.data[:, lo + oa:hi + oa]
        if k < len(B.offsets):
            b = torch.index_select(b, 0, meta[at:at + k])
        term = _bmm_small(A.data[da, lo:hi], b)
        out[:, lo:hi].index_add_(0, meta[at + k:at + 2 * k], term)
        at += 2 * k
    return _BDia(data=out, offsets=tuple(out_offs))


def _btranspose(A: _BDia) -> _BDia:
    """A^T of an embedded block-DIA: offsets negated, blocks transposed,
    rows rolled."""
    lookup = {o: d for d, o in enumerate(A.offsets)}
    out_offsets = tuple(sorted(-o for o in A.offsets))
    data = torch.stack([
        torch.roll(A.data[lookup[-p]].transpose(-1, -2), -p, dims=0)
        for p in out_offsets])
    return _BDia(data=data, offsets=out_offsets)


# ---------------------------------------------------------------------------
# batched small-matrix algebra, unrolled over the static size (m <= 4)
# ---------------------------------------------------------------------------

def _chol_small(G, eps=0.0):
    """Batched lower Cholesky factor of (N, m, m) symmetric matrices.  A
    pivot <= ``eps`` (a rank-deficient or all-zero padded aggregate) gives
    a zero column, so every product downstream stays finite."""
    m = G.shape[-1]
    zero = torch.zeros_like(G[:, 0, 0])
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = G[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                good = s > eps
                L[i][j] = torch.where(good, torch.sqrt(torch.where(
                    good, s, torch.ones_like(s))), zero)
            else:
                d = L[j][j]
                L[i][j] = torch.where(d > 0, s / torch.where(
                    d > 0, d, torch.ones_like(d)), zero)
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(m)], dim=-1)
                        for i in range(m)], dim=-2)


def _tri_inv_small(L):
    """Batched inverse of (N, m, m) lower-triangular matrices by forward
    substitution; a zero pivot inverts to a zero row."""
    m = L.shape[-1]
    zero = torch.zeros_like(L[:, 0, 0])
    X = [[None] * m for _ in range(m)]
    for i in range(m):
        d = L[:, i, i]
        dinv = torch.where(d != 0, 1.0 / torch.where(
            d != 0, d, torch.ones_like(d)), zero)
        for j in range(i + 1):
            if i == j:
                X[i][j] = dinv
            else:
                s = zero
                for k in range(j, i):
                    s = s + L[:, i, k] * X[k][j]
                X[i][j] = -dinv * s
    return torch.stack([torch.stack([X[i][j] if j <= i else zero
                                     for j in range(m)], dim=-1)
                        for i in range(m)], dim=-2)


def _spd_inv_small(D):
    """Batched inverse of (N, bs, bs) SPD blocks, D^-1 = L^-T L^-1 (a zero
    padding block inverts to zero)."""
    Li = _tri_inv_small(_chol_small(D))
    return _bmm_small(Li.transpose(-1, -2), Li)


# ---------------------------------------------------------------------------
# tentative prolongator (Gram-QR form) on the padded node grid
# ---------------------------------------------------------------------------

def _fit_candidates_gram(B, grid_p, stride, dtype):
    """Per-aggregate orthonormalisation of the candidate block B (nb_pad,
    bs, m): (Qv, Bc), Qv (nb_pad, bs, m) the node-wise values of Q =
    B_agg L^-T and Bc (n_agg, m, m) the coarse candidates L^T.  The grid
    helpers ``_block_sum`` and ``_broadcast_coarse`` take channel stacks,
    so they stand for the reference's ``_block_sum_ch`` / ``_broadcast_ch``."""
    m = B.shape[2]
    coarse_grid = tuple(g // stride for g in grid_p)
    pairs = [(i, j) for i in range(m) for j in range(i + 1)]
    g_fields = torch.stack([torch.sum(B[:, :, i] * B[:, :, j], dim=1)
                            for (i, j) in pairs])
    g_agg = _block_sum(g_fields, coarse_grid, stride)      # (P, n_agg)
    G = torch.zeros((g_agg.shape[1], m, m), dtype=B.dtype, device=B.device)
    for p, (i, j) in enumerate(pairs):
        G[:, i, j] = g_agg[p]
        if i != j:
            G[:, j, i] = g_agg[p]
    L = _chol_small(G)
    Li = _tri_inv_small(L)
    # L^-T[i, j] = Li[j, i], broadcast to the fine nodes
    li_fields = torch.stack([Li[:, j, i] for i in range(m)
                             for j in range(m)])           # (m * m, n_agg)
    li_f = _broadcast_coarse(li_fields, coarse_grid, stride,
                             stride // 2).reshape(m, m, -1)  # [i, j, node]
    Qv = torch.sum(B.unsqueeze(-1) * li_f.permute(2, 0, 1).unsqueeze(1),
                   dim=-2).to(dtype)
    Bc = L.transpose(-1, -2).to(dtype)
    return Qv, Bc


def _tentative_bdia(Qv, grid_p, stride, center, dtype) -> _BDia:
    """The embedded tentative prolongator T as a rectangular block-DIA on
    the fine node grid, T[node, root(node)] = Qv[node] (a bs x m block),
    its diagonals selected by position-in-aggregate masks."""
    dim = len(grid_p)
    pos = [torch.arange(g, device=Qv.device) % stride for g in grid_p]
    offsets = []
    blocks = []
    for combo in np.ndindex(*([2 * stride - 1] * dim)):
        coords = tuple(int(c) - (stride - 1) for c in combo)
        masks = []
        for d in range(dim):
            want = center - coords[d]
            if not 0 <= want < stride:
                break
            masks.append(pos[d] == want)
        else:
            shape = [1] * dim
            shape[0] = grid_p[0]
            msk = masks[0].reshape(shape)
            for d in range(1, dim):
                shape = [1] * dim
                shape[d] = grid_p[d]
                msk = msk & masks[d].reshape(shape)
            offsets.append(_coords_to_offset(coords, grid_p))
            blocks.append(torch.where(msk.reshape(-1)[:, None, None], Qv,
                                      torch.zeros((), dtype=Qv.dtype,
                                                  device=Qv.device)
                                      ).to(dtype))
    order = np.argsort(offsets)
    return _BDia(data=torch.stack([blocks[i] for i in order]),
                 offsets=tuple(int(offsets[i]) for i in order))


# ---------------------------------------------------------------------------
# block operator plumbing
# ---------------------------------------------------------------------------

def _pad_blocks(blk, grid, grid_p):
    """(nb, r, c) node blocks on ``grid`` -> (prod(grid_p), r, c) on the
    padded grid."""
    r, c = blk.shape[1], blk.shape[2]
    lanes = blk.reshape(blk.shape[0], r * c).T
    return _grid_pad_vec(lanes, grid, grid_p).T.reshape(-1, r, c)


def _relayout_block(A: BlockDIAMatrix, grid, grid_p) -> BlockDIAMatrix:
    """Re-lay a block-DIA operator from the node grid onto the padded node
    grid."""
    if tuple(grid) == tuple(grid_p) and A.nb_pad == int(np.prod(grid)):
        return A
    nb = int(np.prod(grid))
    offsets = [_coords_to_offset(_offset_to_coords(o, grid), grid_p)
               for o in A.offsets]
    rows = [_pad_blocks(A.data[d][:nb], grid, grid_p)
            for d in range(A.ndiags)]
    order = np.argsort(offsets)
    nbp = int(np.prod(grid_p))
    return BlockDIAMatrix(
        data=torch.stack([rows[i] for i in order]),
        offsets=tuple(int(offsets[i]) for i in order),
        shape=(nbp * A.bs, nbp * A.bs), bs=A.bs, nnz=A.nnz)


def _compact_bdia(C: _BDia, grid_p, stride, center, m, nnz,
                  data_grid=None) -> BlockDIAMatrix:
    """The coarse block operator from its fine-node embedding: the centre
    rows, each offset's per-dim deltas divided by the stride.
    ``data_grid`` is the grid C's rows lie on when they are a slab of
    whole aggregate rows of ``grid_p`` (the offsets are ``grid_p``'s;
    shape and nnz stay the whole coarse operator's)."""
    coarse_grid = tuple(g // stride for g in grid_p)
    rows_grid = tuple(g // stride for g in (data_grid or grid_p))
    out_offsets = []
    rows = []
    for d, o in enumerate(C.offsets):
        coords = _offset_to_coords(o, grid_p)
        assert all(c % stride == 0 for c in coords), (o, coords)
        out_offsets.append(_coords_to_offset(
            tuple(c // stride for c in coords), coarse_grid))
        lanes = C.data[d].reshape(C.data[d].shape[0], m * m).T
        rows.append(_compact_fine(lanes, rows_grid, stride,
                                  center).T.reshape(-1, m, m))
    order = np.argsort(out_offsets)
    nc = int(np.prod(coarse_grid))
    return BlockDIAMatrix(
        data=torch.stack([rows[i] for i in order]),
        offsets=tuple(int(out_offsets[i]) for i in order),
        shape=(nc * m, nc * m), bs=m, nnz=nnz)


def _block_power_rho(A: BlockDIAMatrix, Dinv, iters=40,
                     norm=torch.linalg.vector_norm, start=0):
    """rho(D^-1 A) by power iteration with the batched block D^-1, from
    the reference's hashed start vector: a 0-d device tensor.  ``A`` is
    any operator with ``diagonal()``, ``n_pad``, ``bs``, ``dtype``,
    ``device`` and ``@``; on the node rows of a row-sharded level,
    ``start`` is the block's first scalar row (its slice of the start
    vector) and ``norm`` the global 2-norm of a block."""
    v = (_hash_weights(A.n_pad, 12345, device=A.device, start=start)
         .to(A.dtype) - 0.5)
    v = torch.where(A.diagonal() != 0, v, 0)
    v = v / torch.clamp_min(norm(v), 1e-30)
    bs = A.bs

    def dapply(w):
        return _block_apply(Dinv, w.reshape(-1, bs)).reshape(-1)

    for _ in range(iters):
        w = dapply(A @ v)
        nrm = norm(w)
        v = w / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return norm(dapply(A @ v))


# ---------------------------------------------------------------------------
# solve-phase factored block transfers
# ---------------------------------------------------------------------------

def _candidate_factor(Qv, coarse_grid, coarse_grid_p, stride, center, block):
    """Q: (Q xc)[node, c] = sum_j Qv[node, c, j] xc[agg(node), j], coarse
    padded grid (m unknowns a node) -> fine scalar rows, as a WindowedELL
    of m slots a row (a scalar row's candidates, in column order)."""
    nb, bs, m = Qv.shape
    agg = _broadcast_coarse(_coarse_index(coarse_grid, coarse_grid_p,
                                          Qv.device),
                            coarse_grid, stride, center)
    cols = (agg[:, None, None] * m
            + torch.arange(m, device=Qv.device)).expand(nb, bs, m)
    return _windowed_rows(
        cols.reshape(nb * bs, m), Qv.reshape(nb * bs, m),
        (nb * bs, int(np.prod(coarse_grid_p)) * m), block, Qv.dtype)


class _CandidateRemap:
    """The candidates' remap Q of a block level's transfers (P = S Q, R =
    Q^T S^T), built on the device once a block size and shared by the
    level's P and R through ``remaps``: the solve applies it at the
    level's own block (K6 forward, K7 by its column plan transposed), a
    row-sharded hierarchy at the block its ranks' rows take."""

    @cached_property
    def Q(self):
        """Q at the whole level's block (:func:`~pyamg_tpu_torch.engine.
        device_setup._transfer_block`), what the unsharded applies take;
        looked up once a transfer."""
        nb, bs, _ = self.Qv.shape
        return self.factor(_transfer_block(nb * bs))

    def factor(self, block):
        """Q in row blocks of ``block`` rows."""
        return _shared_factor(
            self.remaps, block,
            lambda b: _candidate_factor(self.Qv, self.coarse_grid,
                                        self.coarse_grid_p, self.stride,
                                        self.center, b))


@dataclass(frozen=True)
class BlockStructuredProlongator(_CandidateRemap):
    """P = S Q applied factored on the node grids: (Q xc)[node, c] =
    sum_j Qv[node, c, j] xc[agg(node), j] through K6 (K12 for a K-major
    (K, nc) stack, lane by lane), then the block-DIA S through B1."""

    S: BlockDIAMatrix
    Qv: torch.Tensor                 # (nb_fine_pad, bs, m)
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: int
    center: int
    # Q by block, shared with the level's restrictor
    remaps: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def m(self):
        return self.Qv.shape[2]

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.S.ndiags * \
            self.S.bs * self.m

    @property
    def shape(self):
        return (int(np.prod(self.fine_grid_p)) * self.Qv.shape[1],
                int(np.prod(self.coarse_grid_p)) * self.m)

    def __matmul__(self, xc):
        return self.S @ self.Q.matvec(xc)

    def shard_factors(self, block):
        """(S, Q), P as factors applied right to left, Q in row blocks of
        ``block``: the form a row-sharded hierarchy applies."""
        return (self.S, self.factor(block))


@dataclass(frozen=True)
class BlockStructuredRestrictor(_CandidateRemap):
    """R = P^T = Q^T S^T applied factored: z = S^T r through B1, then
    (R r)[(a, j)] = sum over aggregate a's nodes of sum_c Qv[node, c, j]
    z[node, c] through K7 (K13 for a lane stack)."""

    St: BlockDIAMatrix
    Qv: torch.Tensor
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: int
    center: int
    # Q by block, shared with the level's prolongator
    remaps: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def m(self):
        return self.Qv.shape[2]

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.St.ndiags * \
            self.St.bs * self.m

    @property
    def shape(self):
        return (int(np.prod(self.coarse_grid_p)) * self.m,
                int(np.prod(self.fine_grid_p)) * self.Qv.shape[1])

    @property
    def n_pad(self):
        return int(np.prod(self.coarse_grid_p)) * self.m

    def __matmul__(self, r):
        return fit(self.Q.rmatvec(self.St @ r), self.n_pad)

    def shard_factors(self, block):
        """(Q^T, S^T), R as factors applied right to left (K7 sums each
        coarse unknown's entries by Q's column plan)."""
        return (TransposedWindowed(self.factor(block)), self.St)


# ---------------------------------------------------------------------------
# the setup pipeline
# ---------------------------------------------------------------------------

class _WholeBlockProducts:
    """The block products of one coarsening step over the whole padded
    node grid (the partitioned block setup's slab products,
    ``parallel/partitioned_block.py``, take their place on a slab of
    whole aggregate rows)."""

    @staticmethod
    def grid(grid_p):
        """The grid the operands' node rows lie on."""
        return grid_p

    spgemm = staticmethod(_bspgemm)
    transpose = staticmethod(_btranspose)
    compact = staticmethod(_compact_bdia)


def _coarsen_level_block(A_p: BlockDIAMatrix, B, grid_p, stride, center,
                         omega, m, dtype, rho=None,
                         products=_WholeBlockProducts):
    """One block SA coarsening step (B: (nb_pad, bs, m)): (S, S^T, Qv,
    Dinv, A_c, B_c, rho).  ``products`` forms the block products (the
    whole grid's, or a slab's)."""
    bs = A_p.bs
    Dblk = A_p.block_diagonal()
    Dinv = _spd_inv_small(Dblk)
    Qv, Bc_blocks = _fit_candidates_gram(B, products.grid(grid_p), stride,
                                         dtype)
    T = _tentative_bdia(Qv, products.grid(grid_p), stride, center, dtype)
    if rho is None:
        rho = _block_power_rho(A_p, Dinv)
    # S = I - (omega / rho) D^-1 A: A's rows scaled by the blocks, plus
    # the identity on the nodes with a nonzero diagonal block
    scale = -(omega / torch.where(rho == 0, torch.ones_like(rho), rho))
    s_data = scale * _bmm_small(Dinv, A_p.data)
    valid = torch.diagonal(torch.abs(Dblk), dim1=1, dim2=2).sum(-1) > 0
    eye_b = valid[:, None, None].to(s_data.dtype) * torch.eye(
        bs, dtype=s_data.dtype, device=s_data.device)
    if 0 in A_p.offsets:
        d0 = A_p.offsets.index(0)
        s_data[d0] = s_data[d0] + eye_b
        s_offsets = A_p.offsets
    else:
        s_data = torch.cat([s_data, eye_b[None]])
        s_offsets = A_p.offsets + (0,)
    S = BlockDIAMatrix(data=s_data, offsets=s_offsets, shape=A_p.shape,
                       bs=bs, nnz=A_p.nnz)
    S_b = _BDia(data=S.data, offsets=S.offsets)
    P_emb = products.spgemm(S_b, T)
    R_emb = products.transpose(P_emb)
    AP = products.spgemm(_BDia(data=A_p.data, offsets=A_p.offsets), P_emb)
    # only centre-to-centre offsets survive compaction
    cand = set()
    for oa in R_emb.offsets:
        for ob in AP.offsets:
            oc = oa + ob
            try:
                coords = _offset_to_coords(oc, grid_p)
            except ValueError:
                continue
            if all(c % stride == 0 for c in coords):
                cand.add(oc)
    Ac_emb = products.spgemm(R_emb, AP, keep=cand)
    nb_c = int(np.prod(grid_p)) // stride ** len(grid_p)
    A_c = products.compact(Ac_emb, grid_p, stride, center, m,
                           nnz=nb_c * m * m * len(Ac_emb.offsets))
    St_b = products.transpose(S_b)
    St = BlockDIAMatrix(data=St_b.data, offsets=St_b.offsets,
                        shape=A_p.shape, bs=bs, nnz=S.nnz)
    return S, St, Qv, Dinv, A_c, Bc_blocks, rho


def _identity_blocks(A):
    return torch.eye(A.bs, dtype=A.dtype, device=A.device).expand(
        A.nb_pad, A.bs, A.bs)


def _block_smoother_arrays(key, A_p, Dinv, rho, dtype,
                           power_rho=_block_power_rho):
    """The smoother's device tensors: (Dinv, omega) for ``jacobi`` and
    ``block_jacobi`` (the block-diagonal inverse; omega scaled by the
    estimate of rho(D^-1 A)), (omega,) for Richardson and (coefficients,)
    for Chebyshev, scaled by a power-iteration estimate of rho(A)
    (``power_rho(A_p, I)``)."""
    if key is None:
        return ()
    name, kw = key
    kw = dict(kw)
    dev = A_p.device
    if name in ("jacobi", "block_jacobi"):
        omega = torch.tensor(float(kw.get("omega", 1.0)), dtype=dtype,
                             device=dev)
        if kw.get("withrho", True):
            omega = omega / torch.clamp_min(rho, 1e-30)
        return (Dinv, omega)
    if name == "richardson":
        rho_A = power_rho(A_p, _identity_blocks(A_p))
        return (torch.tensor(float(kw.get("omega", 1.0)), dtype=dtype,
                             device=dev) / torch.clamp_min(rho_A, 1e-30),)
    if name == "chebyshev":
        lower = float(kw.get("lower_bound", 1.0 / 30.0))
        upper = float(kw.get("upper_bound", 1.1))
        degree = int(kw.get("degree", 3))
        c_unit = np.asarray(chebyshev_polynomial_coefficients(lower, upper,
                                                              degree))
        rho_A = power_rho(A_p, _identity_blocks(A_p))
        exps = degree - np.arange(degree)
        return (torch.as_tensor(c_unit, dtype=dtype, device=dev)
                * torch.clamp_min(rho_A, 1e-30) ** torch.as_tensor(
                    -exps, dtype=dtype, device=dev),)
    raise ValueError(
        f"block device setup supports jacobi/block_jacobi/richardson/"
        f"chebyshev, got {name!r}")


def _block_smoother_wrap(key, arrays):
    if key is None:
        return device_relaxation.identity()
    name, kw = key
    iterations = int(dict(kw).get("iterations", 1))
    if name in ("jacobi", "block_jacobi"):
        return device_relaxation.block_jacobi_dyn(arrays[0], arrays[1],
                                                  iterations)
    if name == "richardson":
        return device_relaxation.richardson_dyn(arrays[0], iterations)
    if name == "chebyshev":
        return device_relaxation.polynomial_dyn(arrays[0], iterations)
    raise ValueError(name)


def _setup_pipeline_block(A_in, B_in, *, plan, stride, omega, m, dtype,
                          pre_key, post_key):
    """The block multi-level setup as one eager loop over the static plan
    of (grid, grid_p) per level: the per-level operators, transfer values,
    rho estimates and smoother arrays, the dense coarsest operator and its
    Newton-Schulz pseudo-inverse."""
    center = stride // 2
    cur = A_in
    B = B_in                               # (nb, bs, m) on the node grid
    out_levels = []
    for (grid, grid_p) in plan:
        A_p = _relayout_block(cur, grid, grid_p)
        nb = int(np.prod(grid))
        Bp = _pad_blocks(B[:nb], grid, grid_p)
        S, St, Qv, Dinv, A_c, Bc, rho = _coarsen_level_block(
            A_p, Bp, grid_p, stride, center, omega, m, dtype)
        pre_arr = _block_smoother_arrays(pre_key, A_p, Dinv, rho, dtype)
        post_arr = _block_smoother_arrays(post_key, A_p, Dinv, rho, dtype)
        out_levels.append((A_p, S, St, Qv, rho, pre_arr, post_arr))
        cur = A_c
        B = Bc                              # (n_agg, m, m)
    # one nonzero product an entry: exact
    Ac_dense = cur.matmat(torch.eye(cur.n_pad, dtype=dtype,
                                    device=cur.device)).contiguous()
    return tuple(out_levels), Ac_dense, _ns_pinv(Ac_dense)


# ---------------------------------------------------------------------------
# the solver and the entry point
# ---------------------------------------------------------------------------

class BlockStructuredDeviceSolver(StructuredDeviceSolver):
    """StructuredDeviceSolver whose fine vectors carry ``bs`` components
    per node (scipy BSR's scalar layout, node-major).  It solves one
    right-hand side at a time, as the reference's: a 2-D ``b`` raises."""

    lane_solves = False

    def __init__(self, hierarchy, grid, grid_p, bs, setup_info=None):
        super().__init__(hierarchy, grid, grid_p, setup_info)
        self.bs = int(bs)

    def _encode(self, v):
        if np.ndim(v) != 1:
            raise ValueError(
                f"the block device solver takes one right-hand side (a "
                f"vector of length {int(np.prod(self.grid)) * self.bs}), "
                f"got {np.ndim(v)} dimensions; solve the columns of an "
                f"(n, K) stack one at a time")
        if isinstance(v, torch.Tensor):
            return torch.nn.functional.pad(
                v.reshape(self.grid + (self.bs,)),
                [0, 0] + _grid_pads(self.grid, self.grid_p)).reshape(-1)
        pads = [(0, gp - g) for g, gp in zip(self.grid, self.grid_p)]
        return np.pad(np.asarray(v).reshape(self.grid + (self.bs,)),
                      pads + [(0, 0)]).reshape(-1)

    def _decode(self, v):
        sl = tuple(slice(0, g) for g in self.grid)
        return v.reshape(self.grid_p + (self.bs,))[sl].reshape(-1)


def _block_plan(grid, bs, m, stride, max_coarse, max_levels):
    """The static coarsening plan [(grid, grid_p)] on the node grid and
    the coarsest grid."""
    plan = []
    cur_grid = grid
    while (int(np.prod(cur_grid)) * max(bs, m) > max_coarse
           and len(plan) < max_levels - 1
           and min(_padded_grid(cur_grid, stride)) >= 3 * stride):
        grid_p = _padded_grid(cur_grid, stride)
        plan.append((cur_grid, grid_p))
        cur_grid = tuple(g // stride for g in grid_p)
    if not plan:
        raise ValueError(
            f"grid {grid} is below the coarsening threshold "
            f"(max_coarse={max_coarse}); use the host setup path")
    return plan, cur_grid


def _block_levels(plan, out_levels, stride, pre_key, post_key, first=0):
    """The DeviceLevels and setup_info entries of the block pipeline's
    levels ``plan[first:]`` (``out_levels`` theirs); each level's remap Q
    is built once, for its P and R."""
    nlev = len(plan)
    dev_levels = []
    infos = []
    for i, (A_p, S, St, Qv, rho, pre_arr, post_arr) in enumerate(
            out_levels, start=first):
        grid_p = plan[i][1]
        coarse_grid = tuple(g // stride for g in grid_p)
        coarse_grid_p = plan[i + 1][1] if i + 1 < nlev else coarse_grid
        geometry = dict(Qv=Qv, fine_grid_p=grid_p, coarse_grid=coarse_grid,
                        coarse_grid_p=coarse_grid_p, stride=stride,
                        center=stride // 2, remaps={})
        npad_lvl = int(np.prod(grid_p)) * A_p.bs
        P = BlockStructuredProlongator(S=S, **geometry)
        P.Q                          # built here, once for P and R
        dev_levels.append(DeviceLevel(
            A=A_p, P=P, R=BlockStructuredRestrictor(St=St, **geometry),
            pre=_block_smoother_wrap(pre_key, pre_arr),
            post=_block_smoother_wrap(post_key, post_arr), n=npad_lvl,
            n_pad=npad_lvl))
        # rho stays a device scalar
        infos.append({"level": i, "n": npad_lvl, "bs": A_p.bs,
                      "ndiags": A_p.ndiags, "rho": rho})
    return dev_levels, infos


def device_sa_setup_block(A, grid, B, dtype=torch.float32, device=None,
                          omega=4.0 / 3.0, stride=3, max_coarse=400,
                          max_levels=12,
                          presmoother=("block_jacobi", {"omega": 4.0 / 3.0}),
                          postsmoother=("block_jacobi",
                                        {"omega": 4.0 / 3.0}),
                          mixed_precision=False, mesh=None):
    """Build a block / multi-candidate SA hierarchy on ``device`` and
    return its :class:`BlockStructuredDeviceSolver`.

    ``A``: scipy BSR with square blocks, node-major rows on the row-major
    node ``grid`` (a CSR operator takes scipy's block-size estimate, 1 for
    a scalar stencil), or a :class:`BlockDIAMatrix` on the node grid.
    ``B``: the (n, m) candidate block, m <= 4 (numpy or a tensor; the
    rigid-body modes for elasticity).  Smoothers: ``jacobi`` /
    ``block_jacobi`` (sweeps with the inverse diagonal blocks),
    ``richardson``, ``chebyshev``.  Aggregates are stride^d node blocks;
    the finest level has the input's blocks, every coarser one m x m.
    ``mixed_precision=True`` also stores the finest operator in float64
    for the mixed-precision outer loop (needs the scipy operator).

    With a ``mesh`` (:func:`~pyamg_tpu_torch.parallel.make_solver_mesh`,
    every rank calling with the same arguments) the setup is partitioned
    (:func:`~pyamg_tpu_torch.parallel.partitioned_block.
    partitioned_block_setup`): ``A`` and ``B`` stay on the host, each rank
    builds its node rows of every large level on its device (the mesh's),
    and the solver runs over a :class:`~pyamg_tpu_torch.parallel.
    ShardedHierarchy` equal to ``shard_hierarchy`` of the whole setup's;
    ``mixed_precision=True`` raises there."""
    device = resolve_device(device if mesh is None or device is not None
                            else mesh.device)
    if mesh is not None and device != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    _check_dtype(dtype)
    grid = tuple(int(g) for g in grid)
    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)
    if mesh is not None:
        from ..parallel.partitioned_block import partitioned_block_setup
        return partitioned_block_setup(
            A, grid, B, mesh, dtype=dtype, omega=omega, stride=stride,
            max_coarse=max_coarse, max_levels=max_levels, pre_key=pre_key,
            post_key=post_key, mixed_precision=mixed_precision)
    nb = int(np.prod(grid))
    Absr = None
    if sp.issparse(A):
        Absr = A.tobsr() if A.format != "bsr" else A
        bs = Absr.blocksize[0]
        if Absr.blocksize[0] != Absr.blocksize[1]:
            raise ValueError("square blocks required")
        if Absr.shape[0] != nb * bs:
            raise ValueError(f"grid {grid} (x bs) does not match A "
                             f"{Absr.shape}")
        # with mixed precision the float64 conversion comes first, and
        # the hierarchy's copy is cast from it on the device
        A_bd = block_dia_from_scipy(
            Absr, dtype=torch.float64 if mixed_precision else dtype,
            device=device, max_diags=600)
        if A_bd is None:
            raise ValueError("operator is not block-banded on this grid")
    elif isinstance(A, BlockDIAMatrix):
        bs = A.bs
        A_bd = BlockDIAMatrix(data=A.data.to(dtype=dtype, device=device),
                              offsets=A.offsets, shape=A.shape, bs=bs,
                              nnz=A.nnz)
    else:
        raise TypeError("A must be scipy sparse or BlockDIAMatrix")
    if mixed_precision and Absr is None:
        raise ValueError("mixed_precision needs the scipy operator "
                         "(float64 source data)")

    if isinstance(B, torch.Tensor):
        B_dev = B.to(dtype=dtype, device=device)
    else:
        B_dev = torch.as_tensor(np.asarray(B, dtype=np.float64), dtype=dtype,
                                device=device)
    if B_dev.ndim == 1:
        B_dev = B_dev[:, None]
    m = B_dev.shape[1]
    if m > 4:
        raise ValueError("block device setup supports m <= 4 candidates")
    if B_dev.shape[0] != nb * bs:
        raise ValueError("B rows must equal n")

    plan, cur_grid = _block_plan(grid, bs, m, stride, max_coarse, max_levels)
    nlev = len(plan)

    A_in = A_bd
    if A_bd.dtype != dtype:
        A_in = BlockDIAMatrix(data=A_bd.data.to(dtype), offsets=A_bd.offsets,
                              shape=A_bd.shape, bs=bs, nnz=A_bd.nnz)
    out_levels, Ac_dense, coarse_inv = _setup_pipeline_block(
        A_in, B_dev.reshape(nb, bs, m), plan=tuple(plan), stride=stride,
        omega=omega, m=m, dtype=dtype, pre_key=pre_key, post_key=post_key)

    dev_levels, infos = _block_levels(plan, out_levels, stride, pre_key,
                                      post_key)
    nc = int(np.prod(cur_grid)) * m
    dev_levels.append(_dense_level(Ac_dense, nc))

    A64 = (_relayout_block(A_bd, grid, plan[0][1]) if mixed_precision
           else None)
    hierarchy = DeviceHierarchy(
        levels=tuple(dev_levels), coarse_inv=coarse_inv, nc=nc, nc_pad=nc,
        dtype=dtype, A64=A64)
    return BlockStructuredDeviceSolver(
        hierarchy, grid, plan[0][1], bs,
        setup_info={"levels": infos, "m": m, "stride": stride,
                    "nlevels": nlev + 1})
