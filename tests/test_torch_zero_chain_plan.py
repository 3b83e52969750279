"""K11's launch plan and K7's tiles, on the CPU.

K11 (``dia_zero_chain_k``) marches strips of rows with a ring of the
residual in shared memory (csrc/dia_k.cu::zero_chain_k_ring_kernel); its
launch is a host function of A's and St's offsets, n_pad, K, the dtype
and the card's SM count (``sparse/dia.py::k11_plan``).  These tests hold
the plan to the kernel's needs at the device-built 2048^2 hierarchy's real
offsets (levels 0 and 1, plain and lane-aligned): the strips cover the
rows once, each ring holds two steps plus St's reach on both sides,
shared memory stays within a block's 227 KB, and the per-row kernel is
taken exactly when one lane's ring does not fit.  An emulation of the kernel's strip
march and ring indexing in numpy (float64, the plan's strips, steps and
slots) is held against the plain twin.  K7 (``windowed_rmatvec``), in
its tile form, sums each column's products in plan order inside a tile;
its emulation over the wrapper's tile table is held against the CPU twin
bit for bit, and the table to its caps, built with no host read.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from pyamg_tpu_torch.sparse import DIAMatrix, dia, window  # noqa: E402

SMEM_BLOCK = 232448          # 227 KB, a block's shared memory on an H100
THREADS = 1024               # the ring kernel's threads per CTA
DTYPES = [torch.float32, torch.float64]

# the offsets (and n_pad) of the device-built 2048^2 hierarchy (A and St
# have the same ones on these levels), read from
# device_sa_setup(max_coarse=400) on the CPU: levels 0 and 1, plain and
# lane-aligned
LEVELS = {
    "level0": (4227072, (-2049, -1, 0, 1, 2049)),
    "level1": (475136, (-685, -684, -683, -1, 0, 1, 683, 684, 685)),
    "lane-aligned level0": (4784128, (-2304, -1, 0, 1, 2304)),
    "lane-aligned level1": (540672, (-769, -768, -767, -1, 0, 1, 767, 768,
                                     769)),
}


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", list(LEVELS))
def test_k11_plan_at_the_path_shapes(level, dtype):
    n_pad, offsets = LEVELS[level]
    h = max(abs(o) for o in offsets)
    for K in range(1, 17):
        for sms in (132, 66):
            plan = dia.k11_plan(offsets, offsets, n_pad, K, dtype, sms)
            assert plan is not None
            # the strips cover [0, n_pad) once
            assert plan.strips * plan.strip >= n_pad
            assert (plan.strips - 1) * plan.strip < n_pad
            assert plan.strips <= max(sms // plan.groups, 1)
            # the lane groups cover the K lanes, at most 8 each
            assert 1 <= plan.group <= 8
            assert plan.groups * plan.group >= K
            assert (plan.groups - 1) * plan.group < K
            # a step is a pass of the CTA's threads
            assert plan.step == THREADS
            # each ring holds two steps plus the reach on both sides
            assert (plan.al, plan.ar, plan.hl, plan.hr) == (h, h, h, h)
            assert plan.ring >= 2 * h + 2 * plan.step
            assert plan.smem(_itemsize(dtype)) <= SMEM_BLOCK


@pytest.mark.parametrize("dtype", DTYPES)
def test_k11_per_row_exactly_when_one_lanes_ring_does_not_fit(dtype):
    sz = _itemsize(dtype)
    edge = (SMEM_BLOCK // sz - 2 * THREADS) // 2
    for reach in list(range(0, 40001, 997)) + [edge, edge + 1]:
        for below in (reach, reach // 3):
            soffsets = (-below, 0, reach)
            plan = dia.k11_plan((-1, 0, 1), soffsets, 200_000, 8, dtype, 132)
            fits = (below + reach + 2 * THREADS) * sz <= SMEM_BLOCK
            assert (plan is not None) == fits, (below, reach)
            if plan is not None:
                assert (plan.hl, plan.hr) == (below, reach)
                assert plan.smem(sz) <= SMEM_BLOCK


def _random_dia(n_pad, offsets, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n_pad))
    i = np.arange(n_pad)
    for d, off in enumerate(offsets):
        data[d, (i + off < 0) | (i + off >= n_pad)] = 0.0
    return DIAMatrix(data=torch.as_tensor(data), offsets=tuple(offsets),
                     shape=(n_pad, n_pad), nnz=int((data != 0).sum()))


def _march(plan, A, St, B, dinv, tv, w):
    """The ring kernel's schedule in numpy: per lane group and strip, the
    first step's window of r rows, then per step the next step's new r
    rows and this step's X and Y rows (in the kernel one pass, here the
    next step's rows first, so a slot overwritten too early shows), with
    the kernel's slots (row j at (j - (s0 - hl)) mod ring)."""
    n = A.n_pad
    a, sd = A.data.numpy(), St.data.numpy()
    K = B.shape[0]
    X, Y = np.full((K, n), np.nan), np.full((K, n), np.nan)
    cap, T = plan.ring, plan.step

    def fill(b, ring, lo, f0, f1):
        j = np.arange(f0, f1)
        j = j[(j >= 0) & (j < n)]
        acc = np.zeros((b.shape[0], j.size))
        for e, off in enumerate(A.offsets):
            ok = (j + off >= 0) & (j + off < n)
            m = j[ok] + off
            acc[:, ok] += a[e, j[ok]] * (w * (dinv[m] * b[:, m]))
        ring[:, (j - lo) % cap] = b[:, j] - acc

    for g in range(plan.groups):
        lanes = slice(g * plan.group, min((g + 1) * plan.group, K))
        b = B[lanes]
        for s in range(plan.strips):
            s0, s1 = s * plan.strip, min((s + 1) * plan.strip, n)
            lo = s0 - plan.hl
            ring = np.full((b.shape[0], cap), np.nan)
            filled = min(s0 + T, s1) + plan.hr
            fill(b, ring, lo, lo, filled)
            for i in range(s0, s1, T):
                nxt = min(i + 2 * T, s1) + plan.hr
                if i + T < s1:
                    fill(b, ring, lo, filled, nxt)
                filled = nxt
                rows = np.arange(i, min(i + T, s1))
                acc2 = np.zeros((b.shape[0], rows.size))
                for e, so in enumerate(St.offsets):
                    ok = (rows + so >= 0) & (rows + so < n)
                    acc2[:, ok] += sd[e, rows[ok]] * ring[
                        :, (rows[ok] + so - lo) % cap]
                X[lanes, rows] = w * (dinv[rows] * b[:, rows])
                Y[lanes, rows] = tv[rows] * acc2
    return X, Y


@pytest.mark.parametrize("K,sms", [(3, 132), (14, 132), (5, 4)])
def test_k11_strip_march_emulation_matches_twin(K, sms):
    """The kernel's strip march (several strips of several steps, the last
    step partial, out-of-range neighbours at both ends, an asymmetric
    reach, unequal lane groups at K = 14 in float64) equals the plain
    twin."""
    n = 30011
    A = _random_dia(n, (-1203, -1, 0, 1, 1203), 0)
    St = _random_dia(n, (-2405, -1203, 0, 1, 700), 1)
    rng = np.random.default_rng(K)
    B = rng.standard_normal((K, n))
    dinv, tv = rng.random(n), rng.random(n)
    plan = dia.k11_plan(A.offsets, St.offsets, n, K, torch.float64, sms)
    assert plan.strips >= 2 and plan.strip > plan.step
    assert plan.strip % plan.step != 0
    if K == 14:
        assert plan.groups >= 2 and K % plan.group != 0
    X, Y = _march(plan, A, St, B, dinv, tv, 0.7)
    Xr, Yr = dia.dia_zero_chain_k_ref(A, St, torch.as_tensor(B),
                                      torch.as_tensor(dinv),
                                      torch.as_tensor(tv), 0.7)
    np.testing.assert_allclose(X, Xr.numpy(), rtol=1e-14, atol=0)
    np.testing.assert_allclose(Y, Yr.numpy(), rtol=1e-12,
                               atol=1e-12 * np.abs(Yr.numpy()).max())


def _k7_tiles(W, r):
    """K7's schedule on the CPU: per tile of the wrapper's table, the
    entries' products rounded in the operator's dtype, then each column's
    products added in plan order from 0."""
    perm, colptr = W.column_plan
    budget, tiles = W.column_tiles(window._K7_COLS, window._K7_MIN_BUDGET)
    e = perm.long()
    per_block = W.k * W.block
    rows = (e // per_block) * W.block + e % W.block
    prod = (W.data.reshape(-1)[e] * r[rows]).numpy()
    cp, t = colptr.numpy(), tiles.numpy()
    y = np.zeros(W.m_chunks * W.w2, dtype=prod.dtype)
    for c0, c1 in zip(t[:-1], t[1:]):
        assert c1 - c0 == 1 or cp[c1] - cp[c0] <= budget
        for c in range(c0, c1):
            acc = prod.dtype.type(0)
            for p in prod[cp[c]:cp[c + 1]]:
                acc = acc + p
            y[c] = acc
    return y


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(6000, 8, 1, 2), (2048, 700, 5, 30)])
def test_k7_tile_schedule_matches_twin_bit_for_bit(shape, dtype):
    """K7's tile schedule (long columns, longer than a warp and than the
    tile budget, and the empty columns past m) gives the CPU twin's bits:
    the same products summed in the same order."""
    n, m, per_row, spread = shape
    rng = np.random.default_rng(n)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows * m // n + rng.integers(-spread, spread + 1,
                                                rows.size), 0, m - 1)
    P = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, m))
    W = window.windowed_from_scipy(P, dtype=dtype, device="cpu")
    lens = np.diff(W.column_plan[1].numpy())
    assert lens.max() > 32 and (lens == 0).any()
    if n == 6000:
        budget, _ = W.column_tiles(window._K7_COLS, window._K7_MIN_BUDGET)
        assert lens.max() > budget
    r = torch.as_tensor(rng.standard_normal(W.n_pad), dtype=dtype)
    want = window.windowed_rmatvec_ref(W, r).numpy()
    got = _k7_tiles(dataclasses.replace(W), r)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("shape", [(6000, 8, 1, 2), (20000, 3000, 7, 40)])
def test_k7_tile_table_covers_the_plan_and_reads_nothing_back(shape,
                                                              monkeypatch):
    """K7's tile table (``_K7_COLS`` columns, a budget of at least
    ``_K7_MIN_BUDGET`` entries): every column in one tile, each tile within
    its caps or a single longer column, built with no host read."""
    n, m, per_row, spread = shape
    rng = np.random.default_rng(m)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows * m // n + rng.integers(-spread, spread + 1,
                                                rows.size), 0, m - 1)
    P = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, m))
    W = window.windowed_from_scipy(P, device="cpu")

    def host_read(*args, **kwargs):
        raise AssertionError("host read while building K7's tile table")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    budget, tiles = W.column_tiles(window._K7_COLS, window._K7_MIN_BUDGET)
    monkeypatch.undo()
    assert budget == max(window.tile_budget(W.nnz, window._CPU_SMS),
                         window._K7_MIN_BUDGET)
    t, cp = tiles.long(), W.column_plan[1].long()
    assert int(t[0]) == 0 and int(t[-1]) == W.m_chunks * W.w2
    assert bool((t[1:] >= t[:-1]).all())
    n_cols, n_ent = t[1:] - t[:-1], cp[t[1:]] - cp[t[:-1]]
    assert int(n_ent.sum()) == int(cp[-1])
    assert bool(((n_ent <= budget) & (n_cols <= window._K7_COLS)
                 | (n_cols == 1)).all())
