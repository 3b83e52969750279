"""K8, K9 and K10's launch plan, on the CPU.

K8 (``dia_spmm`` in its three modes), K9 (``dia_jacobi_k``) and K10
(``dia_jacobi_zero_res_k``) put the lane on the grid (csrc/dia_k.cu::dia_k_lane_kernel): a block computes one
row block of one lane, 4 float32 rows a thread (n_pad a multiple of 4,
operands 16-byte aligned) or 1, walking super tiles of row blocks (128
in float32) with the lanes of a tile one after another, and the row
blocks of the plan's interior [lo, hi) read their neighbours with no
bounds check.  The launch is a host function of the offsets, n_pad, K and the
dtype (``sparse/dia.py::k8_plan``).  These tests hold the plan to the
kernel's needs at the batched paths' real offsets and n_pad: the blocks
cover every (lane, row) once, every neighbour of an interior block lies in
[0, n_pad), the interior is as large as it can be, and the thread-per-row
kernel is taken exactly for the shapes the lane kernel refuses.  An
emulation of the kernel's block and row indexing in numpy (float64
arithmetic on a small n_pad with the real offsets, under the float32 and
the float64 plan) is held against the plain twins bit for bit in all five
modes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyamg_tpu_torch.sparse import DIAMatrix, dia  # noqa: E402

THREADS = 256                # the lane kernel's threads per CTA
MAX_DIAGS = 32               # the offsets it takes as a kernel argument
# rows a thread (at an n_pad that is a multiple of 4, aligned) and row
# blocks a super tile, per value type
SHAPE = {torch.float32: (4, 128), torch.float64: (1, 1)}
DTYPES = [torch.float32, torch.float64]

# the batched paths' (n_pad, offsets): the device-built 2048^2 hierarchy's
# levels 0, 1 and 4 (A; S and St have the same offsets there), the
# host-built level 0 and the lane-aligned levels 0, 1 and 4, read from
# device_sa_setup (max_coarse=400) and as_device_solver on the CPU
LEVELS = {
    "device level4": (729, (-28, -27, -26, -1, 0, 1, 26, 27, 28)),
    "lane-aligned level4": (990, (-31, -30, -29, -1, 0, 1, 29, 30, 31)),
    "device level0": (4227072, (-2049, -1, 0, 1, 2049)),
    "device level1": (475136, (-685, -684, -683, -1, 0, 1, 683, 684, 685)),
    "host level0": (4194304, (-2048, -1, 0, 1, 2048)),
    "lane-aligned level0": (4784128, (-2304, -1, 0, 1, 2304)),
    "lane-aligned level1": (540672, (-769, -768, -767, -1, 0, 1, 767, 768,
                                     769)),
    # config 3's level 0 (512^2 anisotropic FD diffusion, the classical
    # batched CG's K10 / K9 shape)
    "config3 level0": (262144, (-512, -1, 0, 1, 512)),
}


def _vec(dtype, n_pad):
    return SHAPE[dtype][0] if n_pad % 4 == 0 else 1


def _interior_ok(plan, n_pad, offsets, rb):
    """Every neighbour of every row of row block rb lies in [0, n_pad),
    with vec - 1 rows to spare on either side (the aligned 16-byte runs a
    thread of 4 rows loads around a neighbour run)."""
    i0, i1 = rb * plan.rows, (rb + 1) * plan.rows
    m = plan.vec - 1
    return (i1 <= n_pad and i0 + min(offsets) - m >= 0
            and i1 - 1 + max(offsets) + m < n_pad)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", list(LEVELS))
def test_k8_plan_at_the_path_shapes(level, dtype):
    n_pad, offsets = LEVELS[level]
    vec = _vec(dtype, n_pad)
    for K in (1, 2, 3, 8, 16, 17, 24, 64):
        plan = dia.k8_plan(offsets, n_pad, K, dtype)
        assert plan is not None
        assert (plan.vec, plan.rows) == (vec, THREADS * vec)
        assert plan.super == SHAPE[dtype][1]
        assert plan.lanes == K and plan.blocks == plan.row_blocks * K
        # the blocks cover every (lane, row block) once, a super tile's
        # lanes one after another
        if K <= 3:
            seen = {plan.block(b) for b in range(plan.blocks)}
            assert seen == {(k, rb) for k in range(K)
                            for rb in range(plan.row_blocks)}
        t0 = min(plan.super, plan.row_blocks)
        for b in (0, 1, t0 - 1, t0, t0 * K - 1):
            if 0 <= b < t0 * K:
                assert plan.block(b) == (b // t0, b % t0)
        # the row blocks cover [0, n_pad) once
        assert plan.row_blocks * plan.rows >= n_pad
        assert (plan.row_blocks - 1) * plan.rows < n_pad
        # the interior needs no check, and no block outside it could skip
        # one: [lo, hi) is exactly the blocks whose neighbours all lie in
        # [0, n_pad)
        assert 0 < plan.lo < plan.hi < plan.row_blocks
        for rb in (plan.lo - 1, plan.lo, plan.hi - 1, plan.hi):
            assert _interior_ok(plan, n_pad, offsets, rb) == (
                plan.lo <= rb < plan.hi), rb
        # most blocks are interior at the path's shapes
        reach = max(abs(o) for o in offsets) + plan.vec - 1
        assert plan.hi - plan.lo >= plan.row_blocks - 2 * (
            -(-reach // plan.rows)) - 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_per_row_exactly_for_the_shapes_the_lane_kernel_refuses(dtype):
    offsets = (-2049, -1, 0, 1, 2049)
    for n_pad in (1, 3, 4, 729, 50_001, 50_004, 4227072, 4227073,
                  2 ** 31 - 1024 - 4, 2 ** 31 - 1024, 2 ** 31 - 257,
                  2 ** 31 - 256, 2 ** 31):
        for aligned in (True, False):
            plan = dia.k8_plan(offsets, n_pad, 8, dtype, aligned)
            vec = SHAPE[dtype][0] if n_pad % 4 == 0 and aligned else 1
            takes = n_pad < 2 ** 31 - THREADS * vec
            assert (plan is not None) == takes, (n_pad, aligned)
            if plan is not None:
                assert (plan.vec, plan.rows) == (vec, THREADS * vec)
    for nd in (1, 9, MAX_DIAGS, MAX_DIAGS + 1, 125):
        offsets = tuple(range(-(nd // 2), nd - nd // 2))
        assert (dia.k8_plan(offsets, 4096, 8, dtype) is not None) == (
            nd <= MAX_DIAGS)
    # a shape with no interior block: every block checks its neighbours
    plan = dia.k8_plan((-3000, 0, 3000), 4096, 3, dtype)
    assert plan.lo == plan.hi
    # more blocks than a grid holds
    rows = THREADS * SHAPE[dtype][0]
    assert dia.k8_plan((0,), 2 ** 30, 2 ** 31 // (2 ** 30 // rows),
                       dtype) is None


def _random_dia(n_pad, offsets, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n_pad))
    i = np.arange(n_pad)
    for d, off in enumerate(offsets):
        data[d, (i + off < 0) | (i + off >= n_pad)] = 0.0
    return DIAMatrix(data=torch.as_tensor(data), offsets=tuple(offsets),
                     shape=(n_pad, n_pad), nnz=int((data != 0).sum()))


def _lane_grid(plan, mode, A, X, b, dinv, w):
    """The lane kernel's schedule in numpy: per block its lane and row
    block, each thread's vec rows, the neighbours (and the aligned runs
    around them) unchecked in the plan's interior (an index outside [0,
    n_pad) there fails) and out-of-range terms left out elsewhere, then the
    mode's epilogue; every (lane, row) written once.  Mode "zero_res"
    (K10): X is the lane's B, each neighbour's iterate w * (dinv_j * b_j)
    formed from B and dinv as the kernel forms it, and the result the pair
    (w * (dinv * B), B - A X)."""
    n = A.n_pad
    a = A.data.numpy()
    K = X.shape[0]
    Y = np.full((K, n), np.nan)
    R = np.full((K, n), np.nan)
    src = w * (dinv * X) if mode == "zero_res" else X
    for blk in range(plan.blocks):
        k, rb = plan.block(blk)
        interior = plan.lo <= rb < plan.hi
        # thread t holds rows rb * rows + t * vec + [0, vec)
        rows = np.arange(rb * plan.rows, (rb + 1) * plan.rows).reshape(
            THREADS, plan.vec)
        rows = rows[rows[:, 0] < n]          # a thread past n_pad returns
        i = rows.reshape(-1)
        acc = np.zeros(i.size)
        for d, off in enumerate(A.offsets):
            j = i + off
            if interior:
                # a thread's loads: its neighbour run, or with 4 rows and
                # an offset no multiple of 4 the two aligned runs around it
                run = rows[:, :1] + off
                if plan.vec == 4 and off % 4:
                    run = run - off % 4 + np.arange(8)
                assert run.min() >= 0 and run.max() < n
                acc = acc + a[d, i] * src[k, j]
            else:
                ok = (j >= 0) & (j < n)
                acc[ok] = acc[ok] + a[d, i[ok]] * src[k, j[ok]]
        if mode == "zero_res":
            assert np.isnan(R[k, i]).all()
            R[k, i] = X[k, i] - acc
            out = src[k, i]
        elif mode == "plain":
            out = acc
        elif mode == "scale":
            out = acc * b[i]
        elif mode == "add":
            out = acc + b[k, i]
        else:
            out = X[k, i] + w * (dinv[i] * (b[k, i] - acc))
        assert np.isnan(Y[k, i]).all()
        Y[k, i] = out
    return (Y, R) if mode == "zero_res" else Y


@pytest.mark.parametrize("mode", ["plain", "scale", "add", "jacobi"])
@pytest.mark.parametrize("level,n_pad,K,plan_dtype", [
    # two super tiles, the second partial
    ("device level0", 140_004, 3, torch.float32),
    ("device level0", 12_292, 3, torch.float64),
    ("device level1", 6_148, 8, torch.float32),
    ("host level0", 9_217, 2, torch.float64),
    # one float32 row a thread: level 4's odd n_pad
    ("device level4", 729, 8, torch.float32)])
def test_lane_grid_emulation_matches_twin_bit_for_bit(level, n_pad, K,
                                                      plan_dtype, mode):
    """The kernel's block and row indexing under the float32 or float64
    plan at the path's real offsets on a small n_pad (no multiple of the
    row block, so the last block is partial; interior and edge blocks at
    both ends), in float64: the twin's bits, in all four modes."""
    offsets = LEVELS[level][1]
    A = _random_dia(n_pad, offsets, 0)
    rng = np.random.default_rng(K)
    X, V = rng.standard_normal((2, K, n_pad))
    s, dinv = rng.random(n_pad), rng.random(n_pad)
    plan = dia.k8_plan(offsets, n_pad, K, plan_dtype)
    assert plan.row_blocks * plan.rows > n_pad
    assert 0 < plan.lo < plan.hi < plan.row_blocks
    b = {"plain": None, "scale": s, "add": V, "jacobi": V}[mode]
    got = _lane_grid(plan, mode, A, X, b, dinv, 0.7)
    Xt, Vt, st, dt = (torch.as_tensor(v) for v in (X, V, s, dinv))
    want = {"plain": lambda: dia.dia_spmm_ref(A, Xt),
            "scale": lambda: dia.dia_spmm_scaled_ref(A, Xt, st),
            "add": lambda: dia.dia_spmm_add_ref(A, Xt, Vt),
            "jacobi": lambda: dia.dia_jacobi_k_ref(A, Xt, Vt, dt, 0.7)}[mode]()
    assert np.array_equal(got.view(np.uint64), want.numpy().view(np.uint64))


@pytest.mark.parametrize("plan_dtype", DTYPES)
@pytest.mark.parametrize("level", list(LEVELS))
def test_lane_grid_zero_res_emulation_matches_twin_bit_for_bit(level,
                                                                plan_dtype):
    """K10 (``dia_jacobi_zero_res_k``) in the lane kernel: its block and
    row indexing under the float32 or float64 plan at each path level's
    real offsets (config 3's level 0 too), on an n_pad cut to a few row
    blocks past the reach (the real one where it is smaller: the coarse
    levels' odd n_pad, one row a thread), the neighbours' iterate formed
    from B and dinv, in float64: (X, R) are the twin's bits."""
    n_real, offsets = LEVELS[level]
    reach = max(abs(o) for o in offsets)
    n_pad = min(n_real, 4 * ((2 * reach + 3 * 1024) // 4 + 3))
    K = 3
    A = _random_dia(n_pad, offsets, 1)
    rng = np.random.default_rng(n_pad)
    B = rng.standard_normal((K, n_pad))
    dinv = rng.random(n_pad)
    plan = dia.k8_plan(offsets, n_pad, K, plan_dtype)
    assert plan.vec == _vec(plan_dtype, n_pad)
    assert 0 < plan.lo < plan.hi < plan.row_blocks
    got = _lane_grid(plan, "zero_res", A, B, None, dinv, 0.7)
    want = dia.dia_jacobi_zero_res_k_ref(A, torch.as_tensor(B),
                                         torch.as_tensor(dinv), 0.7)
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.uint64), w.numpy().view(np.uint64))
