"""K16's row-block plan, on the CPU.

K16 (``parallel/halo_spmv.py``, kernel ``csrc/halo.cu``) computes one
rank's rows of a row-sharded DIA SpMV in row blocks of 256 threads, 4
float32 rows a thread (n_local a multiple of 4, operands 16-byte aligned)
or 1.  The interior row blocks [lo, hi) of the plan
(``parallel/halo_spmv.py::halo_plan``) read x only, with no select and no
check; the other blocks pick each term's source (left halo, x, right halo).
A ring of one takes one launch over every block; with an exchange, the
interior blocks run while the halos travel and the boundary blocks of
both ends after.  These tests hold the plan to the kernel's needs at the
sharded paths' offsets and sizes: the blocks cover every row once, every
neighbour of an interior block lies in [0, n_local) with the aligned
runs' rows to spare, the interior is as large as it can be, and a ring of
one is one range.  An emulation of the kernel's block and row indexing
in numpy (float64, small n_local, 2048^2-like and 64^3-like offsets) is
held against the plain twin bit for bit, for a ring of one and for P = 4
row blocks, under the float32 and the float64 plan.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyamg_tpu_torch.parallel.dist_spmv import dia_halo_rows_ref  # noqa: E402
from pyamg_tpu_torch.parallel.halo_spmv import (dia_halo_rows,  # noqa: E402
                                                halo_plan)

THREADS = 256                # the kernel's threads per CTA
DTYPES = [torch.float32, torch.float64]
# the sharded paths' (n_local, offsets): the host-built 2048^2 level 0
# (config 1; its float64 A64 has the same offsets) and the host-built
# config 2 64^3 level 0, as a ring of one and as one of 4 row blocks
PATHS = {
    "2048^2 level0 ring of one": (4194304, (-2048, -1, 0, 1, 2048)),
    "2048^2 level0 1 of 4": (1048576, (-2048, -1, 0, 1, 2048)),
    "64^3 level0 ring of one": (262144, (-4096, -64, -1, 0, 1, 64, 4096)),
    "64^3 level0 1 of 4": (65536, (-4096, -64, -1, 0, 1, 64, 4096)),
}
# small stand-ins with the same structure: a 48-wide 2-D grid's 5 points
# and a 24^3 grid's 7 points (n_global, offsets)
SMALL = {
    "2048^2-like": (9600, (-48, -1, 0, 1, 48)),
    "64^3-like": (13824, (-576, -24, -1, 0, 1, 24, 576)),
}


def _interior_ok(plan, offsets, rb):
    """Every neighbour of every row of row block rb lies in [0, n_local),
    with vec - 1 rows to spare on either side (the aligned 16-byte runs a
    thread of 4 rows loads around a neighbour run)."""
    i0, i1 = rb * plan.rows, (rb + 1) * plan.rows
    m = plan.vec - 1
    return (i1 <= plan.n_local and i0 + min(offsets) - m >= 0
            and i1 - 1 + max(offsets) + m < plan.n_local)


def _covered(plan, parts):
    rows = np.zeros(plan.n_local, dtype=int)
    for part in parts:
        for r0, r1 in plan.row_ranges(part):
            rows[r0:r1] += 1
    return rows


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", list(PATHS))
def test_halo_plan_at_the_path_shapes(path, dtype):
    n, offsets = PATHS[path]
    plan = halo_plan(offsets, n, dtype)
    vec = 4 if dtype == torch.float32 else 1
    assert (plan.vec, plan.rows) == (vec, THREADS * vec)
    assert plan.row_blocks * plan.rows >= n > (plan.row_blocks - 1) * plan.rows
    # a ring of one is one range, one launch over every block
    assert plan.blocks("all") == ((0, plan.row_blocks),)
    assert (_covered(plan, ["all"]) == 1).all()
    # the interior and the boundary of both ends cover every row once
    assert (_covered(plan, ["interior", "boundary"]) == 1).all()
    # [lo, hi) is exactly the blocks whose neighbours all lie in the block
    assert 0 < plan.lo < plan.hi < plan.row_blocks
    for rb in (plan.lo - 1, plan.lo, plan.hi - 1, plan.hi):
        assert _interior_ok(plan, offsets, rb) == (plan.lo <= rb < plan.hi)
    # most blocks are interior: the boundary is the reach, rounded up
    reach = max(abs(o) for o in offsets) + plan.vec - 1
    assert plan.hi - plan.lo >= plan.row_blocks - 2 * (
        -(-reach // plan.rows)) - 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_halo_plan_one_row_a_thread_and_no_interior(dtype):
    offsets = (-2048, -1, 0, 1, 2048)
    # an odd block or an unaligned operand: one row a thread
    for n, aligned in ((4194304, False), (4194302, True), (729, True)):
        plan = halo_plan(offsets if n > 4096 else (-28, 0, 28), n, dtype,
                         aligned)
        assert (plan.vec, plan.rows) == (1, THREADS)
        assert (_covered(plan, ["interior", "boundary"]) == 1).all()
    # a reach past half the block: no interior, the boundary is every block
    plan = halo_plan((-3000, 0, 3000), 4096, dtype)
    assert plan.lo == plan.hi
    assert 0 <= plan.lo <= plan.row_blocks
    assert (_covered(plan, ["boundary"]) == 1).all()
    assert plan.row_ranges("interior") == ((plan.lo * plan.rows,) * 2,)
    with pytest.raises(ValueError):
        plan.blocks("middle")


def _random_dia(n_global, offsets, seed):
    """(nd, n_global) random diagonals, zero where the column falls outside
    the matrix (the layout's structural zeros)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n_global))
    i = np.arange(n_global)
    for d, off in enumerate(offsets):
        data[d, (i + off < 0) | (i + off >= n_global)] = 0.0
    return data


def _launch(plan, part, data, offsets, left, x, right, halo, y):
    """One K16 launch over ``part`` of the plan's blocks in numpy, as the
    kernel indexes it: block b of the launch is row block a0 + b, then b0 +
    (b - (a1 - a0)); thread t holds rows rb * rows + t * vec + [0, vec) (a
    thread past n_local returns); an interior block reads x at its
    neighbour runs (and the aligned runs around them: an index outside
    [0, n_local) fails), any other picks each term's source by index.  The
    sum in offset order, as the twin's; every row written once."""
    n = x.shape[0]
    order = [rb for b0, b1 in plan.blocks(part) for rb in range(b0, b1)]
    for rb in order:
        rows = np.arange(rb * plan.rows, (rb + 1) * plan.rows).reshape(
            THREADS, plan.vec)
        rows = rows[rows[:, 0] < n]
        i = rows.reshape(-1)
        interior = plan.lo <= rb < plan.hi
        acc = None
        for d, off in enumerate(offsets):
            j = i + off
            if interior:
                run = rows[:, :1] + off
                if plan.vec == 4 and off % 4:
                    run = run - off % 4 + np.arange(8)
                assert run.min() >= 0 and run.max() < n
                xj = x[j]
            else:
                xj = np.where(j < 0, left[np.clip(halo + j, 0, halo - 1)],
                              np.where(j < n, x[np.clip(j, 0, n - 1)],
                                       right[np.clip(j - n, 0, halo - 1)]))
            term = data[d, i] * xj
            acc = term if acc is None else acc + term
        assert np.isnan(y[i]).all()
        y[i] = acc
    return y


def _same(a, b):
    return np.array_equal(np.asarray(a).view(np.uint64),
                          np.asarray(b).view(np.uint64))


@pytest.mark.parametrize("plan_dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SMALL))
def test_ring_of_one_emulation_matches_twin_bit_for_bit(shape, plan_dtype):
    """A ring of one (halos x's own tail and head): one launch over every
    block gives the twin's bits, and the CPU wrapper writes each part's
    rows and no others."""
    n, offsets = SMALL[shape]
    halo = max(abs(o) for o in offsets)
    data = _random_dia(n, offsets, 0)
    x = np.random.default_rng(1).standard_normal(n)
    plan = halo_plan(offsets, n, plan_dtype)
    assert 0 < plan.lo < plan.hi < plan.row_blocks
    left, right = x[n - halo:], x[:halo]
    got = _launch(plan, "all", data, offsets, left, x, right, halo,
                  np.full(n, np.nan))
    xt, dt = torch.as_tensor(x), torch.as_tensor(data)
    want = dia_halo_rows_ref(dt, offsets, xt[n - halo:], xt, xt[:halo], halo,
                             ((0, n),), torch.empty_like(xt))
    assert _same(got, want.numpy())
    for part in ("all", "interior", "boundary"):
        y = torch.full((n,), float("nan"), dtype=torch.float64)
        dia_halo_rows(dt, offsets, None, xt[n - halo:], xt, xt[:halo], halo,
                      part, y)
        cpu_plan = halo_plan(offsets, n, torch.float64)
        hit = _covered(cpu_plan, [part]) == 1
        assert _same(y.numpy()[hit], want.numpy()[hit])
        assert torch.isnan(y[torch.as_tensor(~hit)]).all()


@pytest.mark.parametrize("plan_dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SMALL))
def test_four_blocks_emulation_matches_twin_bit_for_bit(shape, plan_dtype):
    """P = 4 row blocks, each with its neighbours' halos (the ring wraps):
    the interior launch, then the boundary launch, give each block the
    twin's bits, and together the whole operator's."""
    n, offsets = SMALL[shape]
    P, halo = 4, max(abs(o) for o in offsets)
    nl = n // P
    data = _random_dia(n, offsets, 2)
    x = np.random.default_rng(3).standard_normal(n)
    plan = halo_plan(offsets, nl, plan_dtype)
    assert 0 < plan.lo < plan.hi < plan.row_blocks
    xt, dt = torch.as_tensor(x), torch.as_tensor(data)
    whole = dia_halo_rows_ref(dt, offsets, xt[n - halo:], xt, xt[:halo], halo,
                              ((0, n),), torch.empty_like(xt)).numpy()
    for p in range(P):
        blk = slice(p * nl, (p + 1) * nl)
        left = x[(p * nl - halo) % n:][:halo] if p else x[n - halo:]
        right = x[((p + 1) * nl) % n:][:halo]
        y = np.full(nl, np.nan)
        for part in ("interior", "boundary"):
            _launch(plan, part, data[:, blk], offsets, left, x[blk], right,
                    halo, y)
        want = dia_halo_rows_ref(
            dt[:, blk], offsets, torch.as_tensor(left), xt[blk],
            torch.as_tensor(right), halo, ((0, nl),),
            torch.empty(nl, dtype=torch.float64)).numpy()
        assert _same(y, want)
        assert _same(y, whole[blk])


def _lane_blocks(plan, part, lanes, super_):
    """(lane, row block) of each CTA of K16's lane-mode launch over
    ``part``, as the kernel maps blockIdx.x: the launch's row blocks
    ([a0, a1) then [b0, b1), nrb in all) in super tiles of ``super_``,
    the lanes of a tile one after another."""
    order = [rb for b0, b1 in plan.blocks(part) for rb in range(b0, b1)]
    nrb = len(order)
    out = []
    for bid in range(nrb * lanes):
        st, rem = divmod(bid, super_ * lanes)
        tile = min(super_, nrb - st * super_)
        k, v = divmod(rem, tile)
        out.append((k, order[st * super_ + v]))
    return out


@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("plan_dtype", DTYPES)
def test_lane_mode_maps_every_lane_block_once(plan_dtype, lanes):
    """K16's lane mode covers every (lane, row block) of a launch once, in
    super tiles of 128 launch row blocks (float32) or 1 (float64) with the
    lanes of a tile one after another, for the ring of one's single launch
    and for an exchange's interior and boundary launches; one lane maps
    block b to the launch's b-th row block, the one-vector order."""
    n, offsets = SMALL["2048^2-like"]
    plan = halo_plan(offsets, n // 4, plan_dtype)
    super_ = 128 if plan_dtype == torch.float32 else 1
    for part in ("all", "interior", "boundary"):
        rbs = [rb for b0, b1 in plan.blocks(part) for rb in range(b0, b1)]
        got = _lane_blocks(plan, part, lanes, super_)
        assert sorted(got) == sorted((k, rb) for k in range(lanes)
                                     for rb in rbs)
        if lanes == 1:
            assert [rb for _, rb in got] == rbs
    # a tile's lanes run back to back: each super tile's first lane ends
    # before its second begins
    big = halo_plan((-2048, -1, 0, 1, 2048), 4194304, torch.float32)
    got = _lane_blocks(big, "all", 2, 128)
    assert got[127] == (0, 127) and got[128] == (1, 0)
    assert got[256] == (0, 128)
