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
- :func:`dia_mcgs_sweep`      a multicolour Gauss-Seidel smoother call, every
                              colour step in one launch (``csrc/mcgs.cu``;
                              was one ``dia_pallas_jacobi`` a colour step)

K-lane entry points (``csrc/dia_k.cu``) over K-major (K, n_pad) lane
stacks, the batched solve's layout:

- :func:`dia_spmm`            Y = A X                        (TPU: ``_dia_pallas_matmat_k``)
- :func:`dia_spmm_scaled`     s (A R), s shared by the lanes (TPU: ``_dia_pallas_matmat_k``, ``scale=``)
- :func:`dia_spmm_add`        V + A T, V per lane            (TPU: ``_dia_pallas_matmat_k``, ``addk=``)
- :func:`dia_jacobi_k`        X + w dinv (B - A X)           (TPU: ``dia_pallas_jacobi_km``)
- :func:`dia_jacobi_zero_res_k` (w dinv B, B - A (w dinv B)) (TPU: ``dia_pallas_jacobi_zero_res_km``)
- :func:`dia_zero_chain_k`    (X, tv (St (B - A X))), X = w dinv B
                                                             (TPU: ``dia_pallas_zero_chain_km``)

:func:`dia_zero_chain` and :func:`dia_jacobi_res` march strips of rows
through three stages with two rings in shared memory, so each inner value
is computed once, by the plan of :func:`chain_plan`; a shape that plan
refuses takes the per-row kernel, with the same bits.

:func:`dia_mcgs_sweep` runs the colours of a smoother call by the colour
plan of :func:`mcgs_plan` (the rows sorted by colour, built once per
smoother and operator on the device): a phase a colour, each touching
only that colour's rows, a barrier between phases (a cooperative grid,
or one CTA on a small level, :func:`sweep_route`).

:func:`dia_spmm` (all three modes), :func:`dia_jacobi_k` and
:func:`dia_jacobi_zero_res_k` put the lane on the grid, every lane in one
launch, by the plan of :func:`k8_plan`; a shape that plan refuses takes
the thread-per-row kernel in 16-lane chunks, with the same bits.  :func:`dia_zero_chain_k` marches strips of
rows with a ring of the residual in shared memory, every lane in one
launch, by the plan of :func:`k11_plan`; an St whose reach is too large
for the ring takes the per-row kernel.  And :func:`dia_jacobi_res_k`, the
batched Jacobi-plus-residual composed as the reference's batch rule
composes it: K9, then B - A Y through K8.

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
import dataclasses
import functools
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
           "dia_jacobi_zero_res_k_ref", "dia_zero_chain_k_ref", "K8Plan",
           "k8_plan", "K11Plan", "k11_plan", "ChainPlan", "chain_plan",
           "MCGSPlan", "mcgs_plan", "colour_plan", "sweep_route",
           "dia_mcgs_sweep", "dia_mcgs_sweep_ref"]

# modes of csrc/dia.cu::dia_kernel and csrc/dia_chain.cu
_SPMV, _JACOBI, _JACOBI_ZERO_RES, _SPMV_SCALED, _SPMV_ADD = 0, 1, 2, 3, 4
_ZERO_CHAIN, _JACOBI_RES = 0, 1
# modes of csrc/dia_k.cu::dia_k_kernel
_SPMM, _SPMM_SCALED, _SPMM_ADD, _JACOBI_K, _ZERO_RES_K = 0, 1, 2, 3, 4
# K8, K9 and K10's lane kernel (csrc/dia_k.cu::dia_k_lane_kernel): threads
# per CTA (kThreads), the offsets it takes as a kernel argument at most
# (kMaxArgDiags), and row blocks a super tile per value type (LaneShape)
_K8_THREADS = 256
_K8_MAX_DIAGS = 32
_K8_SUPER = {torch.float32: 128, torch.float64: 1}
# K11's strip march (csrc/dia_k.cu::zero_chain_k_ring_kernel): threads
# per CTA and rows per step (kRingThreads), lanes per group at most
# (kRingLanes); the shared memory a block may hold (an H100's 227 KB,
# kMaxSmem)
_K11_THREADS = 1024
_K11_MAX_GROUP = 8
_SMEM_BLOCK = 232448
# K4 / K5's strip march (csrc/dia_chain.cu::chain_ring_kernel): rows a
# thread per dtype (16 bytes), threads per CTA in the plan's order of
# preference (1024 fill an SM's registers: one CTA an SM, the fastest form
# at levels 0 and 1 of both kernels in both types; smaller CTAs give the
# coarse levels more strips, PERF.md §6, K4 and K5), and the diagonals per
# operator at most (kMaxDiags, staged in shared memory)
_CHAIN_VEC = {torch.float32: 4, torch.float64: 2}
_CHAIN_THREADS = (1024, 512, 256)
_CHAIN_MAX_DIAGS = 32
# the multicolour sweeps (csrc/mcgs.cu, csrc/block_dia.cu's B3; the
# barriers of csrc/sweep.cuh): phases a launch at most (kMaxPhases), the
# threads of the one-CTA route (its one CTA) and of the grid route (a
# CTA), the largest colour, in work items (rows, nodes, or a node's
# components at a run-time block size), that the one-CTA route takes (a
# work item a thread; PERF.md §6, S1 and B3: the grid route wins from
# ~1600 rows a colour, the one CTA below ~400), and the iterate's bytes
# that its shared memory holds (227 KB less the offsets' few)
_SWEEP_MAX_PHASES = 256
_SWEEP_CTA_THREADS = 1024
_SWEEP_GRID_THREADS = 128
_SWEEP_CTA_ITEMS = 1024
_SWEEP_CTA_X_BYTES = _SMEM_BLOCK - 4096


@dataclass(frozen=True)
class DIAMatrix:
    """Diagonal-stored square matrix over padded vectors."""

    data: torch.Tensor           # (ndiags, n_pad)
    offsets: Tuple[int, ...]     # ascending
    shape: Tuple[int, int]       # logical
    nnz: int

    @cached_property
    def offsets_c(self):
        """The offsets as a host int array (K8 / K9's kernel argument)."""
        return (ctypes.c_int * len(self.offsets))(*self.offsets)

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


def dia_mcgs_sweep_ref(A: DIAMatrix, x, b, dinv, plan, order):
    """The colour steps of ``order`` one after another, each K2's twin with
    that colour's inverse diagonal ``where(colors == c, dinv, 0)`` and
    omega 1 (the parent chain's form)."""
    zero = torch.zeros((), dtype=dinv.dtype, device=dinv.device)
    for c in order:
        x = dia_jacobi_ref(A, x, b, torch.where(plan.colors == c, dinv, zero),
                           1.0)
    return x


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


@dataclass(frozen=True)
class K8Plan:
    """A launch of K8 / K9 / K10's lane kernel: ``row_blocks`` blocks of
    ``rows`` rows (``vec`` a thread) for each of ``lanes`` lanes.  The
    blocks walk super tiles of ``super`` row blocks, the lanes of a tile
    one after another (:meth:`block`); the row blocks [lo, hi) have every
    neighbour in [0, n_pad), with vec - 1 rows to spare on either side, and
    carry no bounds checks."""

    vec: int
    rows: int
    super: int
    row_blocks: int
    lanes: int
    lo: int
    hi: int

    @property
    def blocks(self):
        return self.row_blocks * self.lanes

    def block(self, b):
        """(lane, row block) of block ``b``, as the kernel computes them."""
        st, rem = divmod(b, self.super * self.lanes)
        tile = min(self.super, self.row_blocks - st * self.super)
        k, r = divmod(rem, tile)
        return k, st * self.super + r


@functools.lru_cache(maxsize=256)
def k8_plan(offsets, n_pad, K, dtype, aligned=True):
    """K8 / K9 / K10's lane-kernel launch for ``offsets`` on ``n_pad`` rows
    and K lanes of ``dtype`` (``aligned``: every operand 16-byte aligned), or
    None when the kernel does not take the shape (then the thread-per-row
    kernel runs): rows past 2^31, more than 32 diagonals, or more than
    2^31 - 1 blocks.  A thread takes 4 float32 rows in 16-byte loads where
    n_pad is a multiple of 4 and the operands are aligned, else 1 row."""
    vec = 4 if dtype == torch.float32 and aligned and n_pad % 4 == 0 else 1
    rows = _K8_THREADS * vec
    row_blocks = -(-n_pad // rows)
    if (n_pad >= 2 ** 31 - rows or not 1 <= len(offsets) <= _K8_MAX_DIAGS
            or row_blocks * K >= 2 ** 31):
        return None
    # the aligned 16-byte runs around a neighbour run reach vec - 1 rows
    # past it
    below, above = (r + vec - 1 for r in _reach(offsets))
    lo = -(-below // rows)
    hi = max(lo, (n_pad - above) // rows)
    return K8Plan(vec=vec, rows=rows, super=_K8_SUPER[dtype],
                  row_blocks=row_blocks, lanes=K, lo=lo, hi=hi)


@dataclass(frozen=True)
class K11Plan:
    """A launch of K11's strip march: lanes in ``groups`` groups of at most
    ``group`` (gridDim.y), rows in ``strips`` strips of ``strip``
    (gridDim.x), each walked in steps of ``step`` (the kernel's 1024) rows
    with a ring of ``ring`` = 2 step + hl + hr rows of r per lane in shared
    memory (a step's rows with St's reach, and the next step's)."""

    al: int          # A's reach below the diagonal (rows)
    ar: int          # and above it
    hl: int          # St's reach below the diagonal
    hr: int          # and above it
    group: int
    groups: int
    strip: int
    strips: int

    step = _K11_THREADS

    @property
    def ring(self):
        return 2 * self.step + self.hl + self.hr

    def smem(self, itemsize):
        return self.ring * self.group * itemsize


def _reach(offsets):
    return max(0, -min(offsets)), max(0, max(offsets))


@functools.lru_cache(maxsize=256)
def k11_plan(offsets, soffsets, n_pad, K, dtype, sms):
    """K11's launch for A's ``offsets`` and St's ``soffsets`` on ``n_pad``
    rows and K lanes of ``dtype`` on a card of ``sms`` SMs, or None when
    one lane's ring of 2048 + hl + hr rows exceeds a block's shared memory
    or n_pad needs 64 bits (then the per-row kernel runs).  Lanes go in
    the fewest groups whose rings fit (at most 8 lanes each, split
    evenly); a step is 1024 rows; one CTA per SM (its 1024 threads fill
    the register file), so sms // groups strips, but no strip shorter than
    max(step, 2 (hl + hr)) rows, which keeps the rows computed twice under
    half."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    (al, ar), (hl, hr) = _reach(offsets), _reach(soffsets)
    step = K11Plan.step
    fit = _SMEM_BLOCK // ((2 * step + hl + hr) * itemsize)
    if fit < 1 or n_pad >= 2 ** 31:
        return None
    groups = -(-K // min(fit, _K11_MAX_GROUP, K))
    strips = max(1, min(sms // groups, -(-n_pad // max(step, 2 * (hl + hr)))))
    strip = -(-n_pad // strips)
    return K11Plan(al=al, ar=ar, hl=hl, hr=hr, group=-(-K // groups),
                   groups=groups, strip=strip, strips=-(-n_pad // strip))


@dataclass(frozen=True)
class ChainPlan:
    """A launch of K4 / K5's strip march: ``strips`` CTAs of ``threads``
    threads, CTA s owning the rows [s strip, (s + 1) strip) and walking
    them in passes of ``step`` = threads * vec rows, ``vec`` consecutive
    rows a thread.  In pass p stage k takes the rows from s0 + a_k + p step
    (:attr:`anchors`); ring 1 holds the first stage's values over A's reach
    (al below the diagonal, ar above), ring 2 the inner values over the
    outer operator's (hl, hr: St's for K5, A's for K4); each reach is
    rounded up to whole vec groups (:attr:`reaches`), as the kernel does."""

    threads: int
    vec: int
    strip: int
    strips: int
    al: int
    ar: int
    hl: int
    hr: int

    @property
    def step(self):
        return self.threads * self.vec

    @property
    def reaches(self):
        """(al, ar, hl, hr) rounded up to multiples of vec."""
        return tuple(-(-r // self.vec) * self.vec
                     for r in (self.al, self.ar, self.hl, self.hr))

    @property
    def anchors(self):
        """(a1, a2, a3), rows relative to a strip's first: stage 2 lags
        stage 1 by a step and A's reach above, stage 3 stage 2 by a step and
        the outer reach above."""
        al, ar, hl, hr = self.reaches
        a1 = -(hl + al)
        a2 = a1 - self.step - ar
        return a1, a2, a2 - self.step - hr

    @property
    def caps(self):
        """Rows of ring 1 and ring 2."""
        al, ar, hl, hr = self.reaches
        return 2 * self.step + al + ar, 2 * self.step + hl + hr

    def smem(self, itemsize):
        """Dynamic shared memory of one CTA (both rings), bytes."""
        return sum(self.caps) * itemsize

    def passes(self, s0, s1):
        """Passes of the CTA whose strip is [s0, s1)."""
        return (s1 - 1 - (s0 + self.anchors[2])) // self.step + 1


@functools.lru_cache(maxsize=256)
def chain_plan(offsets, soffsets, n_pad, dtype, sms, aligned=True):
    """K4 / K5's strip-march launch for A's ``offsets`` and the outer
    operator's ``soffsets`` (St's for K5, A's again for K4) on ``n_pad``
    rows of ``dtype`` on a card of ``sms`` SMs (``aligned``: every operand
    16-byte aligned), or None when the kernel does not take the shape (then
    the per-row kernel runs): one CTA's two rings beyond a block's shared
    memory (an outer reach such as a 3-D grid's +-n^2), more than 32
    diagonals in either operator, or rows whose strips and halos reach
    2^31, each judged at 1024 threads.  A thread takes 16 bytes of rows (4
    float32, 2 float64) where n_pad is a multiple of that and the operands
    are aligned, else 1 row.  Strips: at most one per SM, none shorter than
    max(step, 2 (hl + hr)), which keeps the inner rows formed twice under
    half; the CTA has 1024 threads where that leaves at least half the SMs
    a strip, else 512 where that does, else 256."""
    vec = _CHAIN_VEC[dtype]
    if vec > 1 and not (aligned and n_pad % vec == 0):
        vec = 1
    itemsize = torch.empty((), dtype=dtype).element_size()
    (al, ar), (hl, hr) = _reach(offsets), _reach(soffsets)

    def form(threads):
        p = ChainPlan(threads=threads, vec=vec, strip=vec, strips=1, al=al,
                      ar=ar, hl=hl, hr=hr)
        return p, n_pad // max(p.step, 2 * (hl + hr))

    plan, strips = form(_CHAIN_THREADS[0])
    smem = plan.smem(itemsize) + 2 * _CHAIN_MAX_DIAGS * 4
    if (smem > _SMEM_BLOCK
            or max(len(offsets), len(soffsets)) > _CHAIN_MAX_DIAGS
            or 2 * n_pad + 4 * plan.step + al + ar + hl + hr + 4 * vec
            >= 2 ** 31):
        return None
    for threads in _CHAIN_THREADS[1:]:
        if strips >= sms // 2:
            break
        plan, strips = form(threads)
    strips = max(1, min(sms, strips))
    strip = -(-(-(-n_pad // strips)) // vec) * vec
    return dataclasses.replace(plan, strip=strip, strips=-(-n_pad // strip))


@dataclass(frozen=True)
class MCGSPlan:
    """A multicolour smoother's colour plan on one operator: the coloured
    rows (of a scalar DIA operator; nodes of a block one) sorted by colour
    with the padding (colour -1) dropped, ``rows[offsets[c]:offsets[c +
    1]]`` colour c's, both int32 on the device (the kernels read
    ``offsets`` themselves); ``sizes`` the rows of each colour (host);
    ``colors`` the colouring itself (the first phase and the twins read
    it); ``staged`` whether a stored nonzero couples two rows of one colour
    (a colour phase then stages its new values); ``route`` "grid" (a
    cooperative launch) or "cta" (one CTA) and its ``threads`` a CTA."""

    rows: torch.Tensor
    offsets: torch.Tensor
    sizes: Tuple[int, ...]
    colors: torch.Tensor
    staged: bool
    route: str
    threads: int

    @property
    def ncolors(self):
        return len(self.sizes)

    @property
    def max_rows(self):
        """The largest colour's rows (the staged scratch, the grid)."""
        return max(self.sizes, default=0)


def sweep_route(items, x_bytes):
    """(route, threads) of a multicolour sweep whose largest colour holds
    ``items`` work items on an iterate of ``x_bytes``: one CTA of 1024
    threads (its barrier a __syncthreads(), the iterate in its shared
    memory) where every thread holds at most one item and the iterate
    fits, else a cooperative grid of 128-thread CTAs (a grid-wide barrier
    costs microseconds; one CTA's items, a memory round trip each, cost
    more beyond the crossover, PERF.md §6, S1)."""
    if items <= _SWEEP_CTA_ITEMS and x_bytes <= _SWEEP_CTA_X_BYTES:
        return "cta", _SWEEP_CTA_THREADS
    return "grid", _SWEEP_GRID_THREADS


def colour_plan(colors, ncolors, coupled, x_bytes, items_per_row=1):
    """The :class:`MCGSPlan` of the int32 colouring ``colors`` (-1 on the
    padding) with ``ncolors`` colours, built on its device: a stable sort
    of the rows by colour, a count of each colour and its prefix sum.
    ``coupled``: a 0-d bool tensor, whether a stored nonzero couples two
    rows of one colour.  The counts and that verdict come to the host in
    one read; nothing later reads the device.  ``x_bytes``: the
    iterate's size; ``items_per_row``: work items a row gives the kernel
    (a node's components at a run-time block size); both for the
    route."""
    dev = colors.device
    key = torch.where(colors >= 0, colors,
                      torch.full((), ncolors, dtype=colors.dtype, device=dev))
    rows = torch.argsort(key, stable=True).to(torch.int32)
    # a count by index_add_ (bincount reads its maximum to the host)
    counts = torch.zeros(ncolors + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, key.long(), torch.ones_like(key, dtype=torch.int64))
    counts = counts[:ncolors]
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)]).to(torch.int32)
    host = torch.cat([counts, coupled.reshape(1).to(torch.int64)]).tolist()
    sizes = tuple(int(v) for v in host[:-1])
    route, threads = sweep_route(max(sizes, default=0) * items_per_row,
                                 x_bytes)
    return MCGSPlan(rows=rows[:sum(sizes)].contiguous(), offsets=offsets,
                    sizes=sizes, colors=colors, staged=bool(host[-1]),
                    route=route, threads=threads)


def _same_colour_coupling(colors, offsets, nonzero):
    """0-d bool: whether some row i and its neighbour j = i + offsets[d]
    (both in range) share a colour (not -1) while ``nonzero(d, lo, hi)``,
    the stored entries of diagonal d on rows [lo, hi), is True there."""
    n = colors.shape[0]
    found = torch.zeros((), dtype=torch.bool, device=colors.device)
    for d, o in enumerate(offsets):
        if o == 0 or abs(o) >= n:
            continue
        lo, hi = max(0, -o), n - max(0, o)
        ci, cj = colors[lo:hi], colors[lo + o:hi + o]
        found = found | (nonzero(d, lo, hi) & (ci == cj) & (ci >= 0)).any()
    return found


def mcgs_plan(A: DIAMatrix, colors, ncolors):
    """The colour plan of a multicolour smoother (int32 ``colors`` (n_pad,),
    -1 on padded rows) on the DIA operator A: staged where a stored nonzero
    of A couples two rows of one colour (a one-sided pattern coloured as
    it is can; a JP colouring of a symmetric one never does)."""
    if colors.shape != (A.n_pad,) or colors.dtype != torch.int32:
        raise ValueError(f"colors: expected int32 ({A.n_pad},), got "
                         f"{colors.dtype} {tuple(colors.shape)}")
    coupled = _same_colour_coupling(
        colors, A.offsets, lambda d, lo, hi: A.data[d, lo:hi] != 0)
    return colour_plan(colors, ncolors, coupled,
                       A.n_pad * A.data.element_size())


def _sweep_order(order, ncolors):
    """The phases of a sweep as ints, each a colour of the plan."""
    order = [int(c) for c in order]
    if any(c < 0 or c >= ncolors for c in order):
        raise ValueError(f"order: colours must lie in [0, {ncolors}), got "
                         f"{order}")
    return order


def _sweep_chunks(order):
    """The phases of each launch: at most _SWEEP_MAX_PHASES a launch."""
    return [order[k:k + _SWEEP_MAX_PHASES]
            for k in range(0, len(order), _SWEEP_MAX_PHASES)]


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


def _chain(mode, kernel, plan, A, St, x, b, dinv, tv, omega, out0, out1):
    """K4 / K5 (csrc/dia_chain.cu): the strip march by ``plan``, counted as
    ``kernel``, or for plan None the per-row kernel, counted as ``kernel +
    "_rows"``.  Both give the same bits.  ``St`` is None for K4 (the outer
    operator is A)."""
    _kernel_operand(A)
    suffix, c_scalar = _KERNEL_DTYPES[A.dtype]
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
    stream = torch.cuda.current_stream(A.device).cuda_stream
    operands = (_ptr(x), _ptr(b), _ptr(dinv), _ptr(tv), w, w_dev,
                out0.data_ptr(), out1.data_ptr(), mode, stream)
    if plan is None:
        fn_name = f"pyamg_dia_chain_{suffix}"
        err = getattr(_build.library(), fn_name)(
            A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags, sdata,
            soffs, nds, A.n_pad, *operands)
        kernel = f"{kernel}_rows"
    else:
        fn_name = f"pyamg_dia_chain_ring_{suffix}"
        err = getattr(_build.library(), fn_name)(
            A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags, sdata,
            soffs, nds, A.n_pad, plan.threads, plan.vec, plan.strip,
            plan.al, plan.ar, plan.hl, plan.hr, *operands)
    _build.check(fn_name, err)
    _count(kernel, A)


def _zero_chain_rows(A, St, b, dinv, tv, omega):
    """K5 in the per-row form whatever the shape (for checks that hold the
    strip march to it)."""
    x, y = torch.empty_like(b), torch.empty_like(b)
    _chain(_ZERO_CHAIN, "dia_zero_chain", None, A, St, None, b, dinv, tv,
           omega, x, y)
    return x, y


def _jacobi_res_rows(A, x, b, dinv, omega):
    """K4 in the per-row form whatever the shape."""
    y, r = torch.empty_like(x), torch.empty_like(x)
    _chain(_JACOBI_RES, "dia_jacobi_res", None, A, None, x, b, dinv, None,
           omega, y, r)
    return y, r


def _launch_k(kernel, mode, A, Xk, b, dinv, omega, Yk, Rk=None):
    """Launch csrc/dia_k.cu::dia_k_kernel (one thread per row) over (K,
    n_pad) stacks in lane chunks; ``b`` is a shared (n_pad,) vector or a
    per-lane stack, ``Rk`` the second output stack (K10's residual)."""
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


def _aligned(*tensors):
    """Every operand's storage 16-byte aligned (the lane kernel's 16-byte
    loads)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _launch_k8(kernel, mode, A, Xk, b, dinv, omega, Yk, Rk=None):
    """K8 / K9 / K10: the lane kernel by :func:`k8_plan`, every lane in one
    launch, counted as ``kernel``; a shape it refuses takes the
    thread-per-row kernel in lane chunks, counted as ``kernel + "_rows"``.
    Both give the same bits.  ``Rk``: K10's residual stack (``Xk`` None)."""
    _kernel_operand(A)
    plan = k8_plan(A.offsets, A.n_pad, Yk.shape[0], A.dtype,
                   _aligned(A.data, Xk, b, dinv, Yk, Rk))
    if plan is None:
        _launch_k(f"{kernel}_rows", mode, A, Xk, b, dinv, omega, Yk, Rk)
        return
    suffix, c_scalar = _KERNEL_DTYPES[A.dtype]
    fn_name = f"pyamg_dia_k_lanes_{suffix}"
    w, w_dev = _omega_args(omega, A, c_scalar)
    err = getattr(_build.library(), fn_name)(
        A.data.data_ptr(), A.offsets_c, A.ndiags, A.n_pad, Yk.shape[0],
        plan.vec, plan.lo, plan.hi, _ptr(Xk), _ptr(b), _ptr(dinv), w,
        w_dev, Yk.data_ptr(), _ptr(Rk), mode,
        torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(fn_name, err)
    _count(kernel, A)


def _dia_k_rows(kernel, mode, A, Xk, b, dinv, omega):
    """K8 / K9 in the thread-per-row form whatever the shape (for checks
    that hold the lane kernel to it)."""
    Yk = torch.empty_like(Xk)
    _launch_k(f"{kernel}_rows", mode, A, Xk, b, dinv, omega, Yk)
    return Yk


def _zero_res_k_rows(A, Bk, dinv, omega):
    """K10 in the thread-per-row form whatever the shape (for checks that
    hold the lane kernel to it)."""
    Xk, Rk = torch.empty_like(Bk), torch.empty_like(Bk)
    _launch_k("dia_jacobi_zero_res_k_rows", _ZERO_RES_K, A, None, Bk, dinv,
              omega, Xk, Rk)
    return Xk, Rk


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
    b - A @ y) (K4: the strip march by :func:`chain_plan`, y formed once
    into a ring; the per-row kernel for a shape it refuses)."""
    if _build.on_cpu(A.data, x, b, dinv):
        return dia_jacobi_res_ref(A, x, b, dinv, omega)
    _check_vectors(A, x=x, b=b, dinv=dinv)
    y = torch.empty_like(x)
    r = torch.empty_like(x)
    plan = chain_plan(A.offsets, A.offsets, A.n_pad, A.dtype,
                      _build.sm_count(A.device),
                      _aligned(A.data, x, b, dinv, y, r))
    _chain(_JACOBI_RES, "dia_jacobi_res", plan, A, None, x, b, dinv, None,
           omega, y, r)
    return y, r


def dia_zero_chain(A: DIAMatrix, St: DIAMatrix, b, dinv, tv, omega):
    """The zero-entry level front-end in one pass: (x, y) =
    (omega * dinv * b, tv * (St @ (b - A @ x))); the residual is never
    stored (K5: the strip march by :func:`chain_plan`, r formed once into a
    ring; the per-row kernel for a shape it refuses)."""
    if _build.on_cpu(A.data, St.data, b, dinv, tv):
        return dia_zero_chain_ref(A, St, b, dinv, tv, omega)
    _check_vectors(A, b=b, dinv=dinv, tv=tv)
    x = torch.empty_like(b)
    y = torch.empty_like(b)
    plan = chain_plan(A.offsets, St.offsets, A.n_pad, A.dtype,
                      _build.sm_count(A.device),
                      _aligned(A.data, St.data, b, dinv, tv, x, y))
    _chain(_ZERO_CHAIN, "dia_zero_chain", plan, A, St, None, b, dinv, tv,
           omega, x, y)
    return x, y


def dia_mcgs_sweep(A: DIAMatrix, x, b, dinv, plan: MCGSPlan, order):
    """A multicolour Gauss-Seidel smoother call on one vector: for each
    colour c of ``order`` (every colour of each direction of every
    iteration), x = x + 1 * (dinv * (b - A @ x)) on the rows of colour c,
    in one launch of ``csrc/mcgs.cu`` by ``plan`` (:func:`mcgs_plan`), each
    row K2's bits.  The caller's x is not changed."""
    if _build.on_cpu(A.data, x, b, dinv, plan.rows):
        return dia_mcgs_sweep_ref(A, x, b, dinv, plan, order)
    _kernel_operand(A)
    _check_vectors(A, x=x, b=b, dinv=dinv)
    order = _sweep_order(order, plan.ncolors)
    if plan.colors.shape != (A.n_pad,):
        raise ValueError(f"plan: built for {tuple(plan.colors.shape)} rows, "
                         f"not {A.n_pad}")
    if not order:
        return x
    suffix, c_scalar = _KERNEL_DTYPES[A.dtype]
    fn_name = f"pyamg_mcgs_sweep_{suffix}"
    fn = getattr(_build.library(), fn_name)
    y = torch.empty_like(x)
    scratch = (torch.empty(max(plan.max_rows, 1), dtype=x.dtype,
                           device=x.device) if plan.staged else None)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    x_in = x
    for chunk in _sweep_chunks(order):
        err = fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                 A.n_pad, x_in.data_ptr(), y.data_ptr(), b.data_ptr(),
                 dinv.data_ptr(), c_scalar(1.0), plan.colors.data_ptr(),
                 plan.rows.data_ptr(), plan.offsets.data_ptr(),
                 plan.ncolors, plan.max_rows, _ptr(scratch),
                 (ctypes.c_int * len(chunk))(*chunk), len(chunk),
                 plan.threads, int(plan.route == "grid"), int(plan.staged),
                 stream)
        _build.check(fn_name, err)
        _count("dia_mcgs_sweep", A)
        x_in = y
    return y


def dia_spmm(A: DIAMatrix, Xk):
    """Y = A @ X lane by lane for a K-major stack Xk (K, n_pad) (K8)."""
    if _build.on_cpu(A.data, Xk):
        return dia_spmm_ref(A, Xk)
    _check_stacks(A, None, Xk=Xk)
    Yk = torch.empty_like(Xk)
    _launch_k8("dia_spmm", _SPMM, A, Xk, None, None, 0.0, Yk)
    return Yk


def dia_spmm_scaled(A: DIAMatrix, Rk, s):
    """s * (A @ R) lane by lane, with the shared scale s (n_pad,) in the
    epilogue (the structured restrictor's tv factor; K8 ``scale``)."""
    if _build.on_cpu(A.data, Rk, s):
        return dia_spmm_scaled_ref(A, Rk, s)
    _check_stacks(A, None, Rk=Rk)
    _check_vectors(A, s=s)
    Yk = torch.empty_like(Rk)
    _launch_k8("dia_spmm_scaled", _SPMM_SCALED, A, Rk, s, None, 0.0, Yk)
    return Yk


def dia_spmm_add(A: DIAMatrix, Tk, Xk):
    """X + A @ T lane by lane, with the per-lane add in the epilogue (the
    structured prolongator's correction add; K8 ``addk``)."""
    if _build.on_cpu(A.data, Tk, Xk):
        return dia_spmm_add_ref(A, Tk, Xk)
    _check_stacks(A, Tk.shape[0], Tk=Tk, Xk=Xk)
    Yk = torch.empty_like(Tk)
    _launch_k8("dia_spmm_add", _SPMM_ADD, A, Tk, Xk, None, 0.0, Yk)
    return Yk


def dia_jacobi_k(A: DIAMatrix, Xk, Bk, dinv, omega):
    """One weighted-Jacobi sweep per lane, X + omega * dinv * (B - A @ X)
    (K9)."""
    if _build.on_cpu(A.data, Xk, Bk, dinv):
        return dia_jacobi_k_ref(A, Xk, Bk, dinv, omega)
    _check_stacks(A, Xk.shape[0], Xk=Xk, Bk=Bk)
    _check_vectors(A, dinv=dinv)
    Yk = torch.empty_like(Xk)
    _launch_k8("dia_jacobi_k", _JACOBI_K, A, Xk, Bk, dinv, omega, Yk)
    return Yk


def dia_jacobi_zero_res_k(A: DIAMatrix, Bk, dinv, omega):
    """Zero-guess Jacobi sweep and its residual per lane in one pass:
    (X, R) = (omega * dinv * B, B - A @ X) (K10: the lane kernel by
    :func:`k8_plan`, one launch for every lane; the thread-per-row kernel
    in 16-lane chunks for a shape it refuses, with the same bits)."""
    if _build.on_cpu(A.data, Bk, dinv):
        return dia_jacobi_zero_res_k_ref(A, Bk, dinv, omega)
    _check_stacks(A, None, Bk=Bk)
    _check_vectors(A, dinv=dinv)
    Xk = torch.empty_like(Bk)
    Rk = torch.empty_like(Bk)
    _launch_k8("dia_jacobi_zero_res_k", _ZERO_RES_K, A, None, Bk, dinv,
               omega, Xk, Rk)
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
    stored (K11: one launch of the strip march, or the per-row kernel in
    16-lane chunks for an St whose reach is too large for its ring; both
    give the same bits)."""
    if _build.on_cpu(A.data, St.data, Bk, dinv, tv):
        return dia_zero_chain_k_ref(A, St, Bk, dinv, tv, omega)
    _kernel_operand(A)
    _kernel_operand(St, "St")
    if St.dtype != A.dtype or St.n_pad != A.n_pad:
        raise ValueError(f"St: expected {A.dtype} with n_pad {A.n_pad}, "
                         f"got {St.dtype} with n_pad {St.n_pad}")
    _check_stacks(A, None, Bk=Bk)
    _check_vectors(A, dinv=dinv, tv=tv)
    Xk = torch.empty_like(Bk)
    Yk = torch.empty_like(Bk)
    plan = k11_plan(tuple(A.offsets), tuple(St.offsets), A.n_pad,
                    Bk.shape[0], A.dtype, _build.sm_count(A.device))
    if plan is None:
        _zero_chain_k_rows(A, St, Bk, dinv, tv, omega, Xk, Yk)
    else:
        _zero_chain_k_ring(A, St, Bk, dinv, tv, omega, Xk, Yk, plan)
    return Xk, Yk


def _zero_chain_k_ring(A, St, Bk, dinv, tv, omega, Xk, Yk, plan):
    """K11's strip march by ``plan``, every lane in one launch."""
    suffix, c_scalar = _KERNEL_DTYPES[A.dtype]
    fn_name = f"pyamg_dia_zero_chain_k_ring_{suffix}"
    w, w_dev = _omega_args(omega, A, c_scalar)
    err = getattr(_build.library(), fn_name)(
        A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
        St.data.data_ptr(), St.offsets_t.data_ptr(), St.ndiags, A.n_pad,
        Bk.shape[0], plan.group, plan.strip, plan.al, plan.ar, plan.hl,
        plan.hr, Bk.data_ptr(), dinv.data_ptr(), tv.data_ptr(), w, w_dev,
        Xk.data_ptr(), Yk.data_ptr(),
        torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(fn_name, err)
    _count("dia_zero_chain_k", A)


def _zero_chain_k_rows(A, St, Bk, dinv, tv, omega, Xk, Yk):
    """K11's per-row kernel, one thread per row, in 16-lane chunks."""
    suffix, c_scalar = _KERNEL_DTYPES[A.dtype]
    fn_name = f"pyamg_dia_zero_chain_k_{suffix}"
    fn = getattr(_build.library(), fn_name)
    w, w_dev = _omega_args(omega, A, c_scalar)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    for k0, k1 in _build.lane_chunks(Bk.shape[0]):
        err = fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                 St.data.data_ptr(), St.offsets_t.data_ptr(), St.ndiags,
                 A.n_pad, k1 - k0, Bk[k0:k1].data_ptr(), dinv.data_ptr(),
                 tv.data_ptr(), w, w_dev, Xk[k0:k1].data_ptr(),
                 Yk[k0:k1].data_ptr(), stream)
        _build.check(fn_name, err)
        _count("dia_zero_chain_k", A)


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
