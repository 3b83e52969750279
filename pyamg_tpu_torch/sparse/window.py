"""Windowed ELL transfer operators, and the windowed kernel entry points.

Counterpart of ``pyamg_tpu/sparse/window.py``.  Layout, built on the host
exactly as the JAX package builds it (same block, w2, starts, idx):

- rows in blocks of ``block``; block b reads the source window
  ``[starts[b] * w2, starts[b] * w2 + 2 * w2)``;
- ``data`` and ``idx`` are slot-major ``(n_blocks, k, block)``, ``idx``
  window-relative; padding slots hold (0, 0.0).

Kernel entry points (``csrc/window.cu``):

- :func:`windowed_matvec`     y = A x    (TPU: ``WindowedELL._matvec_pallas``)
- :func:`windowed_rmatvec`    y = A^T r  (TPU: ``WindowedELL._rmatvec_pallas``)
- :func:`windowed_matmat_k`   Y = A X    (TPU: ``WindowedELL._matmat_pallas_k``)
- :func:`windowed_rmatmat_k`  Y = A^T R  (TPU: ``WindowedELL._rmatmat_pallas_k``)
- :func:`windowed_select`     out[b, s, r] = x[starts[b] * w2 + idx[b, s, r]]
                              (TPU: ``WindowedELL._select_pallas``)

The K-lane forms take K-major (K, m) lane stacks, the batched solve's
layout; the operators' ``@`` takes a vector or such a stack, padding and
slicing along the last axis.  The TPU forms' lane caps (VMEM budgets) do
not carry over: any K runs in one launch, each CTA staging its rows (K12)
or its tile of columns (K13) once for up to 64 lanes.

Each has a plain PyTorch twin (gather / scatter-add, ``*_ref``).  A
wrapper runs the twin only when its operands lie on the CPU; on CUDA
tensors it launches the kernel or raises.

The forward apply (K6) and the select (K14) are one kernel template with
two epilogues, launched by :func:`gather_plan`: a CTA inside one row
block, 16 bytes of each stream a thread.  K6 keeps the bits of the
per-row kernel it replaced (:func:`_windowed_matvec_rows`, kept as their
reference and launched by no path).

The transposes sum without atomics: each operator builds a column plan
once, at its first transpose apply on the card
(:attr:`WindowedELL.column_plan`), and K7/K13 sum each output column's
entries in ascending entry order, the order of the twins' ``index_add_``
on the CPU, so a transpose gives the same bits on every launch and run.
K13, and K7 on long columns, walk the plan in tiles of whole columns
balanced by entries (:meth:`WindowedELL.column_tiles`), also built once,
on the device.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import _build
from .formats import fit, pad_to

__all__ = ["WindowedELL", "TransposedWindowed", "windowed_from_scipy",
           "windowed_matvec", "windowed_rmatvec", "windowed_matmat_k",
           "windowed_rmatmat_k", "windowed_select", "windowed_matvec_ref",
           "windowed_rmatvec_ref", "windowed_matmat_k_ref",
           "windowed_rmatmat_k_ref", "windowed_select_ref", "GatherPlan",
           "gather_plan"]

_LANES = 128

# the dtypes the JAX package's windowed Pallas kernels accept; kept so
# the transpose gate below decides as the reference does
_PALLAS_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_KERNEL_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# lanes per CTA of K12 and K13 (kLaneTile in csrc/window.cu); a call with
# more lanes tiles them over the grid's second dimension, in one launch
_LANE_TILE = 64
# lanes per K12 thread (kK12Lanes in csrc/window.cu)
_K12_LANES_PER_THREAD = 4
# K13's lanes per thread (1, 2, 4, 8 or 16) aim at this many bytes of
# gathers per (column, lane group) pair, so that long columns spread their
# lanes over more threads; chosen on the card (PERF.md §6, from
# scripts/measure_windowed_k.py)
_K13_PAIR_BYTES = 128
# the (row or column, lane group) pairs a CTA aims at, which set K12's
# rows per CTA and K13's columns per tile
_K12_PAIRS = 1024
_K13_PAIRS = 1024
# shared memory a CTA may take without raising its kernel's limit
_SMEM_DEFAULT = 48 * 1024
# streaming multiprocessors a CPU operator's tile budget assumes (an
# H100's); an operator on the card takes its device's count
_CPU_SMS = _build.CPU_SMS
# K7's tile form takes operators with at least this many stored slots
# per column, the rest its one-thread-per-column form; a tile holds at
# most _K7_COLS columns (one per thread of its 256-thread CTA) and at
# least _K7_MIN_BUDGET live entries' worth of budget (chosen on the card,
# PERF.md §6, from scripts/measure_k7_k11.py)
_K7_TILE_SLOTS = 16
_K7_COLS = 256
_K7_MIN_BUDGET = 512
# K6 / K14 (csrc/window.cu::windowed_gather_kernel), chosen on the card
# (PERF.md §6, from scripts/measure_k6_k14.py):
# - a K6 thread takes one item: 16 bytes of rows while that leaves at
#   least _GATHER_FULL threads an SM (each loops over its rows' slots), in
#   CTAs of _GATHER_THREADS threads; else one row, a CTA taking a whole
#   row block of up to _GATHER_ROW_THREADS rows, so that the block's
#   gathers share one SM's L1; the CTA halved down to _GATHER_MIN_THREADS
#   threads while the grid would not give every SM a CTA;
# - a K14 thread takes 16 bytes of entries and as many items (1 to
#   _SELECT_ITEMS) as leave _GATHER_FULL threads an SM, a CTA up to
#   _SELECT_THREADS threads, a row block as few CTAs as that and one wave
#   of the card allow (each CTA launched costs, and each reads the block's
#   window into its SM's L1 again).
_GATHER_SUM, _GATHER_SELECT = 0, 1
_GATHER_FULL = 1024
_GATHER_THREADS = 256
_GATHER_ROW_THREADS = 1024
_GATHER_MIN_THREADS = 128
_SELECT_ITEMS = 8
_SELECT_THREADS = 512

@dataclass(frozen=True)
class WindowedELL:
    """Window-blocked ELL matrix (see module docstring)."""

    data: torch.Tensor     # (n_blocks, k, block)
    idx: torch.Tensor      # (n_blocks, k, block) int32, window-relative
    starts: torch.Tensor   # (n_blocks,) int32, window start in w2 units
    shape: Tuple[int, int]
    block: int
    w2: int
    m_chunks: int          # padded source length in w2 units
    nnz: int

    @property
    def n_pad(self):
        return self.data.shape[0] * self.block

    @property
    def k(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @cached_property
    def column_plan(self):
        """(perm, colptr), the transpose kernels' column plan, built once
        at the first transpose apply and kept on the operator (as
        ``DIAMatrix.offsets_t`` is): every entry keyed by its global
        column, a dead one (data == 0) by the sentinel column m =
        m_chunks * w2, and sorted stably; ``perm`` (int32, one per entry)
        holds the flat indices into ``data`` in that order, ``colptr``
        (int32, m + 1) each column's range of ``perm``.  The kernels stop
        at ``colptr[m]``, so the dead entries past it are never read.
        4 * (entries + m + 1) bytes on the operator's device; the build
        sorts once and reads nothing back to the host."""
        m = self.m_chunks * self.w2
        keys = torch.where(self.data != 0,
                           self.starts[:, None, None] * self.w2 + self.idx,
                           m)                       # int32: m < 2**31
        keys, perm = torch.sort(keys.reshape(-1), stable=True)
        colptr = torch.searchsorted(
            keys, torch.arange(m + 1, dtype=keys.dtype, device=self.device),
            out_int32=True)
        return perm.to(torch.int32).contiguous(), colptr.contiguous()

    @cached_property
    def _tile_tables(self):
        return {}

    def column_tiles(self, max_cols, min_budget=0):
        """(budget, tiles), a K7 / K13 tile table over :attr:`column_plan`,
        built once per ``max_cols`` and ``min_budget`` at the first
        transpose on the card that asks for it: tile t is the columns
        ``[tiles[t], tiles[t + 1])`` (int32 boundaries from 0 to m), at
        most ``max_cols`` columns with at most ``budget`` live entries
        between them, or a single longer column; ``budget`` is
        :func:`tile_budget`'s, at least ``min_budget``.  See
        :func:`column_tile_table`."""
        tables = self._tile_tables
        key = (max_cols, min_budget)
        if key not in tables:
            perm, colptr = self.column_plan
            budget = max(tile_budget(self.nnz, _build.sm_count(self.device)),
                         min_budget)
            tables[key] = (budget, column_tile_table(
                colptr, perm.numel(), budget, max_cols))
        return tables[key]

    def _x_padded(self, x):
        """x (or each lane of a (K, m) stack) fitted to the source length
        ``m_chunks * w2``."""
        return fit(x, self.m_chunks * self.w2)

    def _can_transpose_pallas(self):
        """The JAX package's gate for its transpose kernel (the output had
        to fit the TPU's VMEM).  Kept as is: compile_hierarchy's choice of
        restriction form follows it, so the port builds the reference's
        hierarchy one for one."""
        return (self.block % 128 == 0 and self.w2 % 1024 == 0
                and self.m_chunks * self.w2 * 4 <= 6 * 2**20
                and self.dtype in _PALLAS_DTYPES)

    def matvec(self, x):
        """A @ x for a vector, or lane by lane for a K-major stack (K12)."""
        if x.ndim == 2:
            return self.matmat_k(x)
        return windowed_matvec(self, self._x_padded(x))

    def rmatvec(self, x):
        """A^T @ x for a vector, or lane by lane for a K-major stack
        (K13)."""
        if x.ndim == 2:
            return self.rmatmat_k(x)
        return windowed_rmatvec(self, x[: self.n_pad])

    def matmat_k(self, Xk):
        """Y = A @ X for a K-major stack (K, m) -> (K, n_pad) (K12)."""
        return windowed_matmat_k(self, self._x_padded(Xk))

    def rmatmat_k(self, Rk):
        """Y = A^T @ R for a K-major stack (K, n_pad) -> (K, m_chunks * w2)
        (K13)."""
        return windowed_rmatmat_k(self, fit(Rk, self.n_pad))

    def select(self, x):
        """Per-slot window selection, (n_blocks, k, block) in x's dtype:
        each entry's slot holds x at the entry's column (K14).  The
        unstructured setup's graph passes are elementwise functions of
        it."""
        return windowed_select(self, self._x_padded(x))

    def diagonal(self):
        """The diagonal as an (n_pad,) vector (duplicate entries summed)."""
        rows = torch.arange(self.n_pad, device=self.device).reshape(
            self.data.shape[0], 1, self.block)
        return torch.sum(torch.where(_global_index(self) == rows, self.data,
                                     0), dim=1).reshape(-1)

    def __matmul__(self, x):
        return self.matvec(x)


@dataclass(frozen=True)
class TransposedWindowed:
    """Lazy transpose of a WindowedELL: ``matvec`` is the base operator's
    transpose apply, on the base operator's own arrays (K7, or K13 lane by
    lane for a K-major stack)."""

    base: WindowedELL

    @property
    def shape(self):
        return (self.base.shape[1], self.base.shape[0])

    @property
    def nnz(self):
        return self.base.nnz

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def n_pad(self):
        return self.base.m_chunks * self.base.w2

    def matvec(self, x):
        return self.base.rmatvec(fit(x, self.base.n_pad))

    def rmatvec(self, x):
        return self.base.matvec(x)

    def __matmul__(self, x):
        return self.matvec(x)


def windowed_from_scipy(A, dtype=torch.float32, device=None, block=None,
                        max_w2=16384):
    """Build a WindowedELL on ``device``, with the JAX package's block and
    w2 choice (its TPU cost model, kept so the layouts agree); None when
    some row block's column span exceeds ``max_w2``."""
    if device is None:
        raise ValueError("pass device= explicitly")
    if np.iscomplexobj(getattr(A, "data", np.zeros(0))) or dtype.is_complex:
        raise NotImplementedError("complex windowed operators are not "
                                  "ported yet")
    candidates = ((8192, 4096, 2048, 1024, 512, 256) if block is None
                  else (int(block),))
    A = sp.csr_matrix(A)
    A.sort_indices()
    n, m = A.shape
    n_pad_max = pad_to(max(n, 1), max(candidates))
    lens = np.diff(A.indptr)
    k = max(int(lens.max()) if n else 0, 1)

    rows = np.repeat(np.arange(n), lens)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], lens)
    cols = np.zeros((n_pad_max, k), dtype=np.int64)
    vals = np.zeros((n_pad_max, k), dtype=np.float64)
    has = np.zeros((n_pad_max, k), dtype=bool)
    if A.nnz:
        cols[rows, slots] = A.indices
        vals[rows, slots] = A.data
        has[rows, slots] = True

    GR = min(candidates)
    g = n_pad_max // GR
    g_min = np.where(has, cols, np.iinfo(np.int64).max).reshape(
        g, -1).min(axis=1)
    g_max = np.where(has, cols, -1).reshape(g, -1).max(axis=1)

    best = None
    best_cost = None
    for blk in candidates:
        n_pad_c = pad_to(max(n, 1), blk)
        nb = n_pad_c // blk
        if k * blk * 8 * 2 > 4 * 2**20:
            continue
        q = blk // GR
        gm = g_min[: n_pad_c // GR].reshape(nb, q).min(axis=1)
        gM = g_max[: n_pad_c // GR].reshape(nb, q).max(axis=1)
        empty = gM < 0
        gm[empty] = 0
        gM[empty] = 0
        w2_c = 1024
        while True:
            if (gM < (gm // w2_c + 2) * w2_c).all():
                break
            w2_c *= 2
            if w2_c > max_w2:
                w2_c = None
                break
        if w2_c is None:
            continue
        cost = nb * 0.15e-6 + k * n_pad_c * (2 * w2_c // _LANES) * 8e-12
        if best_cost is None or cost < best_cost:
            best = (blk, w2_c, n_pad_c, nb, gm)
            best_cost = cost
    if best is None:
        return None
    block, w2, n_pad, n_blocks, mins = best
    cols = cols[:n_pad]
    vals = vals[:n_pad]
    has = has[:n_pad]
    starts = mins // w2

    m_chunks = pad_to(max(m, 1), w2) // w2
    m_chunks = max(m_chunks, int(starts.max()) + 2)   # starts+1 addressable

    local = cols - (starts[:, None] * w2).repeat(block, axis=0).reshape(n_pad, 1)
    local = np.where(has, local, 0)
    idx = local.reshape(n_blocks, block, k).transpose(0, 2, 1)
    data = vals.reshape(n_blocks, block, k).transpose(0, 2, 1)
    return WindowedELL(
        data=torch.as_tensor(np.ascontiguousarray(data), dtype=dtype,
                             device=device),
        idx=torch.as_tensor(np.ascontiguousarray(idx), dtype=torch.int32,
                            device=device),
        starts=torch.as_tensor(starts, dtype=torch.int32, device=device),
        shape=(n, m),
        block=int(block),
        w2=int(w2),
        m_chunks=int(m_chunks),
        nnz=int(A.nnz),
    )


@dataclass(frozen=True)
class GatherPlan:
    """A launch of K6 / K14 (``csrc/window.cu::windowed_gather_kernel``):
    ``ctas_per_block`` CTAs of ``threads`` threads for each of the
    ``n_blocks`` row blocks, CTA c of a block taking its items [c * items,
    (c + 1) * items), its threads in turn.  An item is ``vec`` rows (K6)
    or ``vec`` entries of the block's flat k * block (K14, ``select``):
    16 bytes of each stream, or 1 value."""

    select: bool
    vec: int
    threads: int
    items: int
    ctas_per_block: int
    n_blocks: int

    @property
    def grid(self):
        return self.n_blocks * self.ctas_per_block


@functools.lru_cache(maxsize=256)
def gather_plan(select, n_pad, k, block, itemsize, sms, aligned=True):
    """K6's (``select`` False) or K14's launch for an operator of ``n_pad``
    rows in blocks of ``block`` with ``k`` slots and values of
    ``itemsize`` bytes, on a card of ``sms`` SMs (``aligned``: every pack
    operand, data, idx and the output, 16-byte aligned).  The rules are
    those of the constants above; a vector item needs aligned operands and
    a block of whole items."""
    if n_pad % block:
        raise ValueError(f"{n_pad} rows are not whole blocks of {block}")
    n_blocks = n_pad // block
    vec = 16 // itemsize
    if (not aligned or block % vec
            or not select and n_pad // vec < _GATHER_FULL * sms):
        vec = 1
    per_block = (k * block if select else block) // vec
    if select:
        # items a thread: as many as leave _GATHER_FULL threads an SM, 1
        # to _SELECT_ITEMS; at least one wave of CTAs, the items a CTA
        # rounded down so that none is empty
        per_thread = min(max(n_blocks * per_block // (_GATHER_FULL * sms),
                             1), _SELECT_ITEMS)
        cpb = max(-(-per_block // (_SELECT_THREADS * per_thread)),
                  -(-sms // n_blocks))
        items = max(per_block // cpb, 1)
        want = -(-items // per_thread)
        threads = min(max(1 << (want - 1).bit_length(), _GATHER_MIN_THREADS),
                      _SELECT_THREADS)
    else:
        threads = (_GATHER_THREADS if vec > 1 else
                   min(_GATHER_ROW_THREADS, 1 << (per_block - 1).bit_length()))
        while True:
            cpb = -(-per_block // threads)
            if n_blocks * cpb >= sms or threads <= _GATHER_MIN_THREADS:
                break
            threads //= 2
        items = -(-per_block // cpb)
    return GatherPlan(select=bool(select), vec=vec, threads=threads,
                      items=items, ctas_per_block=-(-per_block // items),
                      n_blocks=n_blocks)


def tile_budget(nnz, sms):
    """Live entries per K7 / K13 tile: a power of two that gives each of the
    card's ``sms`` SMs about 8 tiles, from 128 to 2048 (16 KB of float32
    or 24 KB of float64 staged per CTA)."""
    per_tile = max(int(nnz) // (sms * 8), 1)
    return min(max(1 << (per_tile.bit_length() - 1), 128), 2048)


def column_tile_table(colptr, n_entries, budget, max_cols):
    """Cut the columns ``0 .. m`` of a column plan (``colptr``, int32, m +
    1) into K13's tiles, on ``colptr``'s device with no read back to the
    host: the int32 boundaries (0, ..., m) of 2 * n_keys tiles, where
    n_keys depends only on ``n_entries`` (an upper bound of colptr[m]),
    ``budget``, ``max_cols`` and m, so the table's size is known without a
    sync.  Column c's key colptr[c] // budget + c // max_cols is
    nondecreasing; the columns of one key (their starts in one window of
    ``budget`` entries, at most ``max_cols`` of them) make a run, and a
    run holding more than ``budget`` entries gives its last column a tile
    of its own: the rest start and end inside the window.  Empty tiles
    (keys no column has) cost a CTA that exits at once."""
    m = colptr.numel() - 1
    dev = colptr.device
    key = (colptr[:-1] // budget
           + torch.arange(m, dtype=colptr.dtype, device=dev) // max_cols)
    n_keys = n_entries // budget + max(m - 1, 0) // max_cols + 1
    start = torch.searchsorted(
        key, torch.arange(n_keys + 1, dtype=key.dtype, device=dev),
        out_int32=True)                   # run t = [start[t], start[t + 1])
    lo, hi = start[:-1], start[1:]
    cp = colptr.long()
    mid = torch.where((hi > lo) & (cp[hi] - cp[lo] > budget), hi - 1, hi)
    tiles = torch.stack([lo, mid], dim=1).reshape(-1)
    return torch.cat([tiles, tiles.new_full((1,), m)]).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch twins (pyamg_tpu/sparse/window.py, _matvec_reference and
# _rmatvec_reference)
# ---------------------------------------------------------------------------

def _global_index(W: WindowedELL):
    return W.starts.long()[:, None, None] * W.w2 + W.idx.long()


def windowed_matvec_ref(W: WindowedELL, x):
    """Gather form; ``x`` has length ``m_chunks * w2``."""
    return torch.sum(W.data * x[_global_index(W)], dim=1).reshape(-1)


def windowed_rmatvec_ref(W: WindowedELL, r):
    """Scatter-add form; ``r`` has length ``n_pad``."""
    y = torch.zeros(W.m_chunks * W.w2, dtype=W.dtype, device=r.device)
    rb = r.reshape(W.data.shape[0], 1, W.block)
    return y.index_add_(0, _global_index(W).reshape(-1),
                        (W.data * rb).reshape(-1))


def windowed_matmat_k_ref(W: WindowedELL, Xk):
    """The gather form lane by lane; ``Xk`` is (K, m_chunks * w2)."""
    return torch.stack([windowed_matvec_ref(W, x) for x in Xk])


def windowed_rmatmat_k_ref(W: WindowedELL, Rk):
    """The scatter-add form lane by lane; ``Rk`` is (K, n_pad)."""
    return torch.stack([windowed_rmatvec_ref(W, r) for r in Rk])


def windowed_select_ref(W: WindowedELL, x):
    """The gather ``x[column]`` per entry; ``x`` has length
    ``m_chunks * w2``."""
    return x[_global_index(W)]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_operator(W):
    if W.dtype not in _KERNEL_SUFFIX:
        raise TypeError(f"windowed kernel takes float32 or float64, not "
                        f"{W.dtype}")
    for name, t, dt in (("data", W.data, W.dtype), ("idx", W.idx, torch.int32),
                        ("starts", W.starts, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"windowed {name}: expected contiguous {dt}")


def _lib_fn(kind, W):
    _check_operator(W)
    fn_name = f"pyamg_windowed_{kind}_{_KERNEL_SUFFIX[W.dtype]}"
    return fn_name, getattr(_build.library(), fn_name)


def _k12_rows(W, K):
    """Rows per K12 CTA: a power of two near ``_K12_PAIRS`` (row, lane
    group) pairs, its staged slots within the default shared memory, at
    most the block (a block's last CTA takes the rows left, so a block
    that no large power of two divides keeps full CTAs)."""
    groups = -(-min(K, _LANE_TILE) // _K12_LANES_PER_THREAD)
    rows = max(_K12_PAIRS // groups, 1)
    rows = min(rows, max(_SMEM_DEFAULT // (W.k * (W.data.element_size()
                                                  + 4)), 1))
    return min(1 << (rows.bit_length() - 1), W.block)


def _launch_matmat_k(W, Xk, Y):
    """K12 over the stack Xk -> Y, every lane in one launch."""
    fn_name, fn = _lib_fn("matmat_k", W)
    K = Xk.shape[0]
    err = fn(W.data.data_ptr(), W.idx.data_ptr(), W.starts.data_ptr(), W.k,
             W.block, W.w2, W.n_pad, W.m_chunks * W.w2, K, _k12_rows(W, K),
             Xk.data_ptr(), Y.data_ptr(),
             torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(fn_name, err)
    _build.count_launch(f"windowed_matmat_k.{_build.dtype_name(W.dtype)}")


def _k13_mapping(W, K):
    """K13's (lanes per thread, columns per tile).  Lanes per thread: the
    power of two nearest ``_K13_PAIR_BYTES`` over the bytes of one lane's
    gathers down a column (entries per column taken as the stored slots
    over the columns, a bound known on the host), 1 to 16 and at most K.
    Columns per tile: about ``_K13_PAIRS`` (column, lane group) pairs, 32
    to 512 (a power of two)."""
    per_col = W.data.numel() / max(W.m_chunks * W.w2, 1)
    want = _K13_PAIR_BYTES / max(per_col * W.data.element_size(), 1e-9)
    lt = 1 << min(max(round(math.log2(max(want, 1.0))), 0), 4)
    while lt > K:
        lt //= 2
    cols = min(max(_K13_PAIRS // -(-min(K, _LANE_TILE) // lt), 32), 512)
    return lt, 1 << (cols.bit_length() - 1)


def _launch_rmatmat_k(W, Rk, Y):
    """K13 over the stack Rk -> Y, every lane in one launch, through the
    operator's column plan and tile table."""
    fn_name, fn = _lib_fn("rmatmat_k", W)
    perm, colptr = W.column_plan
    lt, cols = _k13_mapping(W, Rk.shape[0])
    budget, tiles = W.column_tiles(cols)
    err = fn(W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(),
             tiles.data_ptr(), tiles.numel() - 1, budget, cols, W.k,
             W.block, W.n_pad, W.m_chunks * W.w2, Rk.shape[0], lt,
             Rk.data_ptr(), Y.data_ptr(),
             torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(fn_name, err)
    _build.count_launch(f"windowed_rmatmat_k.{_build.dtype_name(W.dtype)}")


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _gather_plan_for(W, x, out, select):
    """:func:`gather_plan` for W, the payload x and the output out; the
    alignment is that of the operands read or written in packs (x is only
    gathered, one value at a time)."""
    operands = (W.idx, out) if select else (W.data, W.idx, out)
    return gather_plan(select, W.n_pad, W.k, W.block, x.element_size(),
                       _build.sm_count(W.device), _aligned(*operands))


def _gather(W, x, out, plan):
    """K6 / K14 by ``plan`` into ``out`` (x's dtype), counted as
    ``windowed_matvec`` / ``windowed_select``."""
    fn_name = f"pyamg_windowed_gather_{_KERNEL_SUFFIX[x.dtype]}"
    err = getattr(_build.library(), fn_name)(
        _GATHER_SELECT if plan.select else _GATHER_SUM,
        None if plan.select else W.data.data_ptr(), W.idx.data_ptr(),
        W.starts.data_ptr(), W.k, W.block, W.w2, plan.n_blocks, plan.vec,
        plan.threads, plan.ctas_per_block, plan.items, x.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(fn_name, err)
    kind = "select" if plan.select else "matvec"
    _build.count_launch(f"windowed_{kind}.{_build.dtype_name(x.dtype)}")
    return out


def _check_select(W, x):
    if x.dtype not in _KERNEL_SUFFIX:
        raise TypeError(f"windowed select takes float32 or float64 "
                        f"payloads, not {x.dtype}")
    _build.check_vector("x", x, W.m_chunks * W.w2, x.dtype)
    for name, t in (("idx", W.idx), ("starts", W.starts)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"windowed {name}: expected contiguous int32")


def windowed_matvec(W: WindowedELL, x):
    """y = A @ x, with x of length ``m_chunks * w2``; y has ``n_pad``.  On
    the card K6 by :func:`gather_plan`."""
    if _build.on_cpu(W.data, x):
        return windowed_matvec_ref(W, x)
    _build.check_vector("x", x, W.m_chunks * W.w2, W.dtype)
    _check_operator(W)
    y = torch.empty(W.n_pad, dtype=W.dtype, device=x.device)
    return _gather(W, x, y, _gather_plan_for(W, x, y, False))


def _windowed_matvec_rows(W: WindowedELL, x):
    """y = A @ x by the per-row kernel K6 replaced (one thread per row, its
    slots in order), counted as ``windowed_matvec_rows``: K6's bit
    reference for checks on the card; it has no CPU form."""
    if _build.on_cpu(W.data, W.idx, W.starts, x):
        raise ValueError("the per-row K6 kernel runs on CUDA tensors only")
    _build.check_vector("x", x, W.m_chunks * W.w2, W.dtype)
    _check_operator(W)
    y = torch.empty(W.n_pad, dtype=W.dtype, device=x.device)
    fn_name = f"pyamg_windowed_matvec_rows_{_KERNEL_SUFFIX[W.dtype]}"
    err = getattr(_build.library(), fn_name)(
        W.data.data_ptr(), W.idx.data_ptr(), W.starts.data_ptr(), W.k,
        W.block, W.w2, W.n_pad, x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(fn_name, err)
    _build.count_launch(f"windowed_matvec_rows.{_build.dtype_name(W.dtype)}")
    return y


def windowed_rmatvec(W: WindowedELL, r):
    """y = A^T @ r, with r of length ``n_pad``; y has ``m_chunks * w2``.
    On the card each column sums its entries in ascending entry order
    through the operator's column plan (built at the first call), so the
    result is the same on every run and equals the CPU twin's (K7: one
    thread per column where columns hold under ``_K7_TILE_SLOTS`` stored
    slots on average; else one CTA per tile of whole columns forms the
    tile's products in parallel and a thread per column adds them in plan
    order)."""
    if _build.on_cpu(W.data, r):
        return windowed_rmatvec_ref(W, r)
    _build.check_vector("r", r, W.n_pad, W.dtype)
    _check_operator(W)
    perm, colptr = W.column_plan
    m = W.m_chunks * W.w2
    y = torch.empty(m, dtype=W.dtype, device=r.device)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    if W.data.numel() < _K7_TILE_SLOTS * m:
        fn_name = f"pyamg_windowed_rmatvec_{_KERNEL_SUFFIX[W.dtype]}"
        err = getattr(_build.library(), fn_name)(
            W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(), W.k,
            W.block, m, r.data_ptr(), y.data_ptr(), stream)
    else:
        budget, tiles = W.column_tiles(_K7_COLS, _K7_MIN_BUDGET)
        fn_name = f"pyamg_windowed_rmatvec_tiles_{_KERNEL_SUFFIX[W.dtype]}"
        err = getattr(_build.library(), fn_name)(
            W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(),
            tiles.data_ptr(), tiles.numel() - 1, budget, _K7_COLS, W.k,
            W.block, r.data_ptr(), y.data_ptr(), stream)
    _build.check(fn_name, err)
    _build.count_launch(f"windowed_rmatvec.{_build.dtype_name(W.dtype)}")
    return y


def windowed_select(W: WindowedELL, x):
    """out[b, s, r] = x[starts[b] * w2 + idx[b, s, r]], (n_blocks, k,
    block) in x's dtype (float32 or float64, whatever W's dtype), with x of
    length ``m_chunks * w2`` (K14: an exact indexed load, by
    :func:`gather_plan`)."""
    if _build.on_cpu(W.idx, x):
        return windowed_select_ref(W, x)
    _check_select(W, x)
    out = torch.empty(W.idx.shape, dtype=x.dtype, device=x.device)
    return _gather(W, x, out, _gather_plan_for(W, x, out, True))


def windowed_matmat_k(W: WindowedELL, Xk):
    """Y = A @ X lane by lane for a K-major stack Xk (K, m_chunks * w2); Y
    is (K, n_pad) (K12: one launch; each CTA stages its rows' data and idx
    once for up to 64 lanes, and each (row, lane) sums its slots in
    ascending order with one FMA each)."""
    if _build.on_cpu(W.data, Xk):
        return windowed_matmat_k_ref(W, Xk)
    _build.check_stack("Xk", Xk, W.m_chunks * W.w2, W.dtype)
    Y = torch.empty(Xk.shape[0], W.n_pad, dtype=W.dtype, device=Xk.device)
    _launch_matmat_k(W, Xk, Y)
    return Y


def windowed_rmatmat_k(W: WindowedELL, Rk):
    """Y = A^T @ R lane by lane for a K-major stack Rk (K, n_pad); Y is
    (K, m_chunks * w2) (K13: one launch over the operator's tile table;
    K7's column plan, every lane of a column summed in ascending entry
    order, so each lane equals K7's result and the CPU twin's on every
    run)."""
    if _build.on_cpu(W.data, Rk):
        return windowed_rmatmat_k_ref(W, Rk)
    _build.check_stack("Rk", Rk, W.n_pad, W.dtype)
    Y = torch.empty(Rk.shape[0], W.m_chunks * W.w2, dtype=W.dtype,
                    device=Rk.device)
    _launch_rmatmat_k(W, Rk, Y)
    return Y
