"""K13's tile tables (``WindowedELL.column_tiles``) on the CPU.

A table cuts a windowed operator's column plan into tiles of whole
columns for the K-lane transpose kernel: every column in exactly one tile,
the tiles covering ``colptr[0 : m + 1]`` in order, none above its entry
budget or its column cap unless it holds a single long column, and a size
known from the operator's shapes alone.  It is built on the
operator's device with no read back to the host: on the CPU that shows as
no call into the tensor's host conversions (``item``, ``tolist``,
``numpy``, ``bool``, ``int``, ``float``) while it is built.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from pyamg_tpu_torch.sparse import window  # noqa: E402


def _operator(n, m, per_row, spread, seed, dense_col=None, block=None):
    """A banded random rectangular operator (stored zeros included), with
    an optional dense column (a column longer than any tile budget)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows * m // n + rng.integers(-spread, spread + 1,
                                                rows.size), 0, m - 1)
    vals = rng.standard_normal(rows.size)
    vals[::9] = 0.0
    if dense_col is not None:
        extra = np.arange(0, n, 2)
        rows = np.concatenate([rows, extra])
        cols = np.concatenate([cols, np.full(extra.size, dense_col)])
        vals = np.concatenate([vals, rng.standard_normal(extra.size)])
    P = sp.csr_matrix((vals, (rows, cols)), shape=(n, m))
    return window.windowed_from_scipy(P, device="cpu", block=block)


CASES = {
    "banded": dict(n=4096, m=1500, per_row=3, spread=40, seed=1),
    "dense column": dict(n=2048, m=700, per_row=5, spread=30, seed=2,
                         dense_col=350),
    "square": dict(n=6000, m=6000, per_row=7, spread=3, seed=3, block=512),
    "wide rows": dict(n=1024, m=4000, per_row=25, spread=400, seed=4),
}


@pytest.mark.parametrize("max_cols", [32, 64, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_column_tiles_partition_the_plan(case, max_cols):
    W = _operator(**CASES[case])
    perm, colptr = W.column_plan
    budget, tiles = W.column_tiles(max_cols)
    assert W.column_tiles(max_cols)[1] is tiles          # built once
    m = W.m_chunks * W.w2
    assert budget == window.tile_budget(W.nnz, window._CPU_SMS)
    assert tiles.dtype == torch.int32 and tiles.is_contiguous()
    t = tiles.long()
    # the boundaries run from 0 to m in order: every column lies in
    # exactly one tile, and the tiles cover colptr[0 : m + 1]
    assert int(t[0]) == 0 and int(t[-1]) == m
    assert bool((t[1:] >= t[:-1]).all())
    cp = colptr.long()
    n_cols = t[1:] - t[:-1]
    n_ent = cp[t[1:]] - cp[t[:-1]]
    assert int(n_ent.sum()) == int(cp[m])
    # within budget and column cap, or a single (long) column
    assert bool(((n_ent <= budget) & (n_cols <= max_cols)
                 | (n_cols == 1)).all())
    # the table's size follows from the shapes alone
    n_keys = perm.numel() // budget + (m - 1) // max_cols + 1
    assert tiles.numel() == 2 * n_keys + 1
    if case == "dense column":
        assert int(n_ent.max()) > budget      # the long column's own tile


def test_column_tiles_budget():
    """128 live entries per tile at least, 2048 at most, about 8 tiles
    per SM of the card in between (a CPU operator's budget assumes an
    H100's 132 SMs)."""
    assert window._CPU_SMS == 132
    assert window.tile_budget(0, 132) == 128
    assert window.tile_budget(10_000, 132) == 128
    assert window.tile_budget(132 * 8 * 300, 132) == 256
    assert window.tile_budget(132 * 8 * 300, 66) == 512
    assert window.tile_budget(4_480_000, 132) == 2048
    W = _operator(**CASES["dense column"])
    long_col = window.column_tile_table(W.column_plan[1],
                                        W.column_plan[0].numel(), 128, 64)
    assert int(long_col[-1]) == W.m_chunks * W.w2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k13_mapping(dtype):
    """K13's lanes per thread (the power of two nearest 128 bytes of
    gathers per (column, lane group) pair, at most K) and columns per tile
    (about 1024 pairs, 32 to 512 columns, a power of two)."""
    sz = torch.tensor([], dtype=dtype).element_size()
    short = _operator(**CASES["banded"])              # 6 slots per column
    long = _operator(n=16384, m=1500, per_row=3, spread=40, seed=5)  # 24
    for W, per_col in ((short, 6), (long, 24)):
        W = dataclasses.replace(W, data=W.data.to(dtype))
        assert W.data.numel() / (W.m_chunks * W.w2) == per_col
        # 128 / (6 * 4) = 5.3 -> 4; / (6 * 8) = 2.7 -> 2; / (24 * 4) =
        # 1.3 -> 1; / (24 * 8) = 0.67 -> 1
        lt_k = {(6, 4): 4, (6, 8): 2, (24, 4): 1, (24, 8): 1}[per_col, sz]
        for K in (1, 3, 8, 64, 65, 200):
            lt, cols = window._k13_mapping(W, K)
            assert lt == min(lt_k, 1 << (K.bit_length() - 1))
            groups = -(-min(K, 64) // lt)
            want = min(max(1024 // groups, 32), 512)
            assert cols == 1 << (want.bit_length() - 1)


@pytest.mark.parametrize("case", ["banded", "dense column"])
def test_column_tiles_build_reads_nothing_back(case, monkeypatch):
    """The plan and the table are built without converting any tensor to
    a host value (each conversion would be a device sync on the card)."""
    W = _operator(**CASES[case])
    fresh = dataclasses.replace(W)           # no cached plan or table

    def host_read(*args, **kwargs):
        raise AssertionError("host read while building the tile table")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    budget, tiles = fresh.column_tiles(64)
    monkeypatch.undo()
    assert torch.equal(tiles, W.column_tiles(64)[1])
    assert budget == W.column_tiles(64)[0]
