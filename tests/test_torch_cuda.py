"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: every test skips where torch sees no GPU (the decision is
taken inside the fixture, never at import).  On a machine with a card,
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the port
neither needs nor imports.)
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from pyamg_tpu_torch import (_build, as_device_solver, device_sa_setup,  # noqa: E402
                             poisson, smoothed_aggregation_solver)
from pyamg_tpu_torch.sparse import (dia, dia_from_scipy, window,  # noqa: E402
                                    windowed_from_scipy)

pytestmark = pytest.mark.cuda

# f32: FMA contraction and other summation orders than the twins'; f64
# likewise.  The windowed transposes (K7, K13) sum in the CPU twins' order
# and are held to them bit for bit.
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _rand(m, dtype, dev, seed):
    return torch.as_tensor(np.random.default_rng(seed).random(m),
                           dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [(64, 64), (33, 70)])
def test_dia_kernels_match_twins(cuda, dtype, grid):
    A = poisson(grid, format="csr")
    D = dia_from_scipy(A, dtype=dtype, device=cuda, row_pad=1024)
    x, b = (_rand(D.n_pad, dtype, cuda, s) for s in (0, 1))
    dinv = torch.zeros(D.n_pad, dtype=dtype, device=cuda)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / A.diagonal(), dtype=dtype)
    _build.reset_launches()
    assert _rel_err(dia.dia_spmv(D, x), dia.dia_spmv_ref(D, x)) <= TOL[dtype]
    assert _rel_err(dia.dia_jacobi(D, x, b, dinv, 0.85),
                    dia.dia_jacobi_ref(D, x, b, dinv, 0.85)) <= TOL[dtype]
    got = dia.dia_jacobi_zero_res(D, b, dinv, 0.85)
    want = dia.dia_jacobi_zero_res_ref(D, b, dinv, 0.85)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= TOL[dtype]
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"dia_spmv.{name}": 1,
                               f"dia_jacobi.{name}": 1,
                               f"dia_jacobi_zero_res.{name}": 1}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [(64, 64), (33, 70)])
def test_epilogue_and_chain_kernels_match_twins(cuda, dtype, grid):
    """K1's SPMV_SCALED and SPMV_ADD, K4 and K5 against their twins, with
    omega by value and as a 0-d device tensor; St is a second operator
    with a wider pattern (the 9-point stencil of the coarse levels)."""
    A = poisson(grid, format="csr")
    D = dia_from_scipy(A, dtype=dtype, device=cuda, row_pad=1024)
    n9 = sp.diags([np.full(A.shape[0], v) for v in (0.3, 0.2, 0.3)],
                  [-grid[1] - 1, 0, grid[1] + 1], shape=A.shape)
    St = dia_from_scipy((0.1 * A + n9).tocsr(), dtype=dtype, device=cuda,
                        row_pad=1024)
    x, b, s, tv = (_rand(D.n_pad, dtype, cuda, k) for k in (0, 1, 2, 3))
    dinv = torch.zeros(D.n_pad, dtype=dtype, device=cuda)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / A.diagonal(), dtype=dtype)
    w_dev = torch.tensor(0.85, dtype=dtype, device=cuda)
    _build.reset_launches()
    assert _rel_err(dia.dia_spmv_scaled(D, x, s),
                    dia.dia_spmv_scaled_ref(D, x, s)) <= TOL[dtype]
    assert _rel_err(dia.dia_spmv_add(D, x, b),
                    dia.dia_spmv_add_ref(D, x, b)) <= TOL[dtype]
    for omega in (0.85, w_dev):
        for got, want in (
                (dia.dia_jacobi_res(D, x, b, dinv, omega),
                 dia.dia_jacobi_res_ref(D, x, b, dinv, omega)),
                (dia.dia_zero_chain(D, St, b, dinv, tv, omega),
                 dia.dia_zero_chain_ref(D, St, b, dinv, tv, omega)),
                ((dia.dia_jacobi(D, x, b, dinv, omega),),
                 (dia.dia_jacobi_ref(D, x, b, dinv, omega),))):
            for g, w in zip(got, want):
                assert _rel_err(g, w) <= TOL[dtype]
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"dia_spmv_scaled.{name}": 1,
                               f"dia_spmv_add.{name}": 1,
                               f"dia_jacobi_res.{name}": 2,
                               f"dia_zero_chain.{name}": 2,
                               f"dia_jacobi.{name}": 2}


def test_device_built_solve_on_card_matches_cpu(cuda):
    """The 128^2 device-built float64 hierarchy, built and solved on the
    card, against the same setup and solve on the CPU (plain twins): the
    same count, histories to rtol 1e-8; every path kernel launched."""
    A = poisson((128, 128), format="csr")
    b = np.random.default_rng(0).random(A.shape[0])
    kw = dict(grid=(128, 128), dtype=torch.float64, max_coarse=100,
              mixed_precision=True)
    res_g, res_c = [], []
    dg = device_sa_setup(A, device=cuda, **kw)
    _build.reset_launches()
    x = dg.solve(b, tol=1e-10, accel="cg", precision="mixed",
                 residuals=res_g)
    counts = dict(_build.launches)
    device_sa_setup(A, device="cpu", **kw).solve(
        b, tol=1e-10, accel="cg", precision="mixed", residuals=res_c)
    assert len(res_g) == len(res_c)
    np.testing.assert_allclose(res_g, res_c, rtol=1e-8)
    assert np.linalg.norm(b - A @ x) < 1e-10 * np.linalg.norm(b)
    for k in ("dia_zero_chain", "dia_spmv_add", "dia_jacobi", "dia_spmv"):
        assert counts.get(f"{k}.float64", 0) > 0, (k, counts)


def _random_rect(n, m, per_row, spread, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip((rows * m) // n + rng.integers(-spread, spread + 1,
                                                  len(rows)), 0, m - 1)
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(n, m))


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_kernels_match_twins(cuda, dtype):
    P = _random_rect(8192, 2600, per_row=4, spread=60, seed=4)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda)
    x = _rand(W.m_chunks * W.w2, dtype, cuda, 3)
    r = _rand(W.n_pad, dtype, cuda, 5)
    assert _rel_err(window.windowed_matvec(W, x),
                    window.windowed_matvec_ref(W, x)) <= TOL[dtype]
    assert _rel_err(window.windowed_rmatvec(W, r),
                    window.windowed_rmatvec_ref(W, r)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_transposes_are_deterministic(cuda, dtype):
    """K7 and K13 sum each column in a fixed order (the column plan): two
    launches give the same bits, within 1e-5 (f32) / 1e-12 (f64) of the
    card's twin, and equal to the ordered CPU twin bit for bit."""
    P = _random_rect(8192, 2600, per_row=9, spread=60, seed=4)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda)
    r = _rand(W.n_pad, dtype, cuda, 5)
    R = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (19, W.n_pad)), dtype=dtype, device=cuda)
    W_cpu = dataclasses.replace(W, data=W.data.cpu(), idx=W.idx.cpu(),
                                starts=W.starts.cpu())
    for launch, ref, v in ((window.windowed_rmatvec,
                            window.windowed_rmatvec_ref, r),
                           (window.windowed_rmatmat_k,
                            window.windowed_rmatmat_k_ref, R)):
        first, second = launch(W, v), launch(W, v)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        assert _rel_err(first, ref(W, v)) <= TOL[dtype]
        assert torch.equal(first.cpu(), ref(W_cpu, v.cpu()))
    perm, colptr = W.column_plan
    assert perm.dtype == colptr.dtype == torch.int32
    assert colptr.shape == (W.m_chunks * W.w2 + 1,)
    assert perm.numel() == W.data.numel()
    assert int(colptr[-1]) == int((W.data != 0).sum())


def test_kernel_wrapper_rejects_bad_operands(cuda):
    A = poisson((32, 32), format="csr")
    D = dia_from_scipy(A, device=cuda, row_pad=1024)
    with pytest.raises(TypeError):
        dia.dia_spmv(D, torch.ones(D.n_pad, dtype=torch.float64,
                                   device=cuda))
    with pytest.raises(ValueError):
        dia.dia_spmv(D, torch.ones(D.n_pad + 1, device=cuda))
    with pytest.raises(ValueError):
        dia.dia_spmv(D, torch.ones(D.n_pad))          # CPU x, CUDA A


def test_mixed_solve_on_card_matches_cpu(cuda):
    """The 128^2 main-path solve on the card against the same solve on the
    CPU (plain twins): iteration counts within one, first five history
    entries to 1e-3 (f32 summation order), both converged."""
    A = poisson((128, 128), format="csr")
    ml = smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    b = np.random.default_rng(1).random(A.shape[0])
    kw = dict(tol=1e-8, accel="cg", precision="mixed")
    res_g, res_c = [], []
    x = as_device_solver(ml, device=cuda, mixed_precision=True,
                         coarse_cutoff=1024).solve(b, residuals=res_g, **kw)
    as_device_solver(ml, device="cpu", mixed_precision=True,
                     coarse_cutoff=1024).solve(b, residuals=res_c, **kw)
    assert abs(len(res_g) - len(res_c)) <= 1
    np.testing.assert_allclose(res_g[:5], res_c[:5], rtol=1e-3)
    assert np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [3, 8, 19])
def test_k_lane_kernels_match_twins(cuda, dtype, K):
    """K8 in its three modes, K9 and K11 against their twins on K-major
    stacks; K8 and K9 (the lane on the grid) and K11's strip march take
    one launch per call for any K, K = 19 too; omega by value and as a 0-d
    device tensor."""
    grid = (48, 70)
    A = poisson(grid, format="csr")
    D = dia_from_scipy(A, dtype=dtype, device=cuda, row_pad=1024)
    n9 = sp.diags([np.full(A.shape[0], v) for v in (0.3, 0.2, 0.3)],
                  [-grid[1] - 1, 0, grid[1] + 1], shape=A.shape)
    St = dia_from_scipy((0.1 * A + n9).tocsr(), dtype=dtype, device=cuda,
                        row_pad=1024)
    rng = np.random.default_rng(K)
    X, B, V = (torch.as_tensor(rng.random((K, D.n_pad)), dtype=dtype,
                               device=cuda) for _ in range(3))
    s, tv = (_rand(D.n_pad, dtype, cuda, k) for k in (2, 3))
    dinv = torch.zeros(D.n_pad, dtype=dtype, device=cuda)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / A.diagonal(), dtype=dtype)
    w_dev = torch.tensor(0.85, dtype=dtype, device=cuda)
    _build.reset_launches()
    cases = [(dia.dia_spmm(D, X), dia.dia_spmm_ref(D, X)),
             (dia.dia_spmm_scaled(D, X, s), dia.dia_spmm_scaled_ref(D, X, s)),
             (dia.dia_spmm_add(D, X, V), dia.dia_spmm_add_ref(D, X, V))]
    for omega in (0.85, w_dev):
        cases.append((dia.dia_jacobi_k(D, X, B, dinv, omega),
                      dia.dia_jacobi_k_ref(D, X, B, dinv, omega)))
        got = dia.dia_zero_chain_k(D, St, B, dinv, tv, omega)
        want = dia.dia_zero_chain_k_ref(D, St, B, dinv, tv, omega)
        cases += list(zip(got, want))
    torch.cuda.synchronize()
    for got, want in cases:
        assert got.shape == (K, D.n_pad)
        assert _rel_err(got, want) <= TOL[dtype]
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"dia_spmm.{name}": 1,
                               f"dia_spmm_scaled.{name}": 1,
                               f"dia_spmm_add.{name}": 1,
                               f"dia_jacobi_k.{name}": 2,
                               f"dia_zero_chain_k.{name}": 2}


# name -> (n_pad, offsets, elements the stacks start past an aligned
# address): the batched paths' offsets (device-built levels 0, 1 and 4,
# host-built level 0) and a 3-D 7-point pattern (the lane kernel's
# run-time diagonal loop), each n_pad no multiple of a row block, so the
# first and last blocks check their neighbours and the last is partial;
# level 4's odd n_pad and an unaligned stack take one float32 row a
# thread
K8_CASES = {
    "device level0": (50_004, (-2049, -1, 0, 1, 2049), 0),
    "device level1": (20_012, (-685, -684, -683, -1, 0, 1, 683, 684, 685),
                      0),
    "device level4": (729, (-28, -27, -26, -1, 0, 1, 26, 27, 28), 0),
    "host level0": (30_724, (-2048, -1, 0, 1, 2048), 0),
    "3-D 7-point": (27_004, (-900, -30, -1, 0, 1, 30, 900), 0),
    "unaligned stack": (50_004, (-2049, -1, 0, 1, 2049), 1),
}


def _k8_modes(D, X, V, s, dinv, omega):
    """(kernel name, C mode, lane-kernel call, thread-per-row call, b,
    dinv, omega) for K8's three modes and K9."""
    return [
        ("dia_spmm", dia._SPMM, lambda: dia.dia_spmm(D, X), None, None, 0.0),
        ("dia_spmm_scaled", dia._SPMM_SCALED,
         lambda: dia.dia_spmm_scaled(D, X, s), s, None, 0.0),
        ("dia_spmm_add", dia._SPMM_ADD, lambda: dia.dia_spmm_add(D, X, V), V,
         None, 0.0),
        ("dia_jacobi_k", dia._JACOBI_K,
         lambda: dia.dia_jacobi_k(D, X, V, dinv, omega), V, dinv, omega)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1, 3, 8, 16, 24])
@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_k9_lane_kernel_equals_per_row_kernel(cuda, dtype, K, case):
    """K8 (three modes) and K9 with the lane on the grid at the paths'
    offsets, with 4 float32 rows a thread or 1: one launch per call for any
    K, bit for bit the thread-per-row kernel's result (16-lane chunks), two
    launches equal, within TOL of the twin; omega as a 0-d device
    tensor."""
    n, offsets, shift = K8_CASES[case]
    D = _random_dia(n, offsets, dtype, cuda, 0)
    rng = np.random.default_rng(K)
    big = torch.as_tensor(rng.random(K * n + shift), dtype=dtype,
                          device=cuda)
    X = big[shift:].view(K, n)
    V = torch.as_tensor(rng.random((K, n)), dtype=dtype, device=cuda)
    s, dinv = (_rand(n, dtype, cuda, k) for k in (2, 3))
    omega = torch.tensor(0.85, dtype=dtype, device=cuda)
    aligned = shift == 0
    plan = dia.k8_plan(D.offsets, n, K, dtype, aligned)
    assert plan is not None and plan.row_blocks * plan.rows > n
    assert 0 < plan.lo <= plan.hi < plan.row_blocks
    assert plan.vec == (4 if dtype == torch.float32 and n % 4 == 0
                        and aligned else 1)
    name = str(dtype).removeprefix("torch.")
    for kernel, mode, lane, b, dv, w in _k8_modes(D, X, V, s, dinv, omega):
        _build.reset_launches()
        got, again = lane(), lane()
        assert _build.launches == {f"{kernel}.{name}": 2}
        rows = dia._dia_k_rows(kernel, mode, D, X, b, dv, w)
        torch.cuda.synchronize()
        assert _build.launches[f"{kernel}_rows.{name}"] == -(-K // 16)
        assert torch.equal(got, again), kernel
        assert torch.equal(got, rows), kernel
        assert got.shape == (K, n)
    want = dia.dia_jacobi_k_ref(D, X, V, dinv, omega)
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_k8_k9_more_diagonals_than_the_lane_kernel_takes_run_per_row(
        cuda, dtype):
    """33 diagonals, more than the lane kernel takes as arguments: the
    thread-per-row kernel runs (counted as ``<kernel>_rows``), within TOL
    of the twin."""
    n, offsets = 20_000, tuple(range(-16, 17))
    name = str(dtype).removeprefix("torch.")
    D = _random_dia(n, offsets, dtype, cuda, 1)
    rng = np.random.default_rng(n)
    X, V = (torch.as_tensor(rng.random((3, n)), dtype=dtype, device=cuda)
            for _ in range(2))
    s, dinv = (_rand(n, dtype, cuda, k) for k in (2, 3))
    assert dia.k8_plan(D.offsets, n, 3, dtype) is None
    for kernel, mode, lane, b, dv, w in _k8_modes(D, X, V, s, dinv, 0.85):
        _build.reset_launches()
        got = lane()
        torch.cuda.synchronize()
        assert _build.launches == {f"{kernel}_rows.{name}": 1}
    assert _rel_err(got, dia.dia_jacobi_k_ref(D, X, V, dinv, 0.85)) \
        <= TOL[dtype]


def _random_dia(n_pad, offsets, dtype, dev, seed):
    """Random diagonals at ``offsets``, zero where the column falls outside
    [0, n_pad) (the layout's structural zeros)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n_pad))
    i = np.arange(n_pad)
    for d, off in enumerate(offsets):
        data[d, (i + off < 0) | (i + off >= n_pad)] = 0.0
    return dia.DIAMatrix(data=torch.as_tensor(data, dtype=dtype, device=dev),
                         offsets=tuple(offsets), shape=(n_pad, n_pad),
                         nnz=int((data != 0).sum()))


# name -> (n_pad, A's offsets, St's offsets, K): n_pad no multiple of the
# strip march's step, out-of-range neighbours at both ends
K11_CASES = {
    "ring, 5-point": (50_001, (-300, -1, 0, 1, 300), (-300, -1, 0, 1, 300),
                      8),
    "ring, asymmetric reach": (100_003, (-317, -1, 1, 317),
                               (-4000, -317, 0, 317, 2999), 8),
    "ring, lane groups": (60_001, (-1, 0, 1), (-3000, -1, 0, 1, 3000), 16),
    "per-row": (140_000, (-2, 0, 2), (-30_001, 0, 30_001), 19),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(K11_CASES))
def test_k11_strip_march_and_per_row_match_twin(cuda, dtype, case):
    """K11 in both branches: the strip march (several strips and steps;
    the unrolled 5-diagonal form; the generic form with an A that has no
    diagonal and St's reach 4000 rows below and 2999 above; lane groups of
    unequal sizes, K = 16 in three groups (f32) or six (f64)) in one
    launch per call, and the per-row kernel in 16-lane chunks for a reach
    (60 002 rows) that no ring holds.  Within TOL of the twin, two
    launches bit-identical, and the strip march equal to the per-row
    kernel bit for bit, under its plan and under another strip count."""
    n, offs, soffs, K = K11_CASES[case]
    A = _random_dia(n, offs, dtype, cuda, 0)
    St = _random_dia(n, soffs, dtype, cuda, 1)
    rng = np.random.default_rng(K)
    B = torch.as_tensor(rng.random((K, n)), dtype=dtype, device=cuda)
    dinv, tv = (_rand(n, dtype, cuda, s) for s in (2, 3))
    omega = torch.tensor(0.85, dtype=dtype, device=cuda)
    plan = dia.k11_plan(A.offsets, St.offsets, n, K, dtype,
                        _build.sm_count(cuda))
    assert (plan is None) == (case == "per-row")
    if plan is not None:
        assert plan.strips >= 2 and plan.strip > plan.step
        assert plan.groups >= (2 if case == "ring, lane groups" else 1)
    _build.reset_launches()
    got = dia.dia_zero_chain_k(A, St, B, dinv, tv, omega)
    again = dia.dia_zero_chain_k(A, St, B, dinv, tv, omega)
    torch.cuda.synchronize()
    name = str(dtype).removeprefix("torch.")
    per_call = 1 if plan is not None else -(-K // 16)
    assert _build.launches == {f"dia_zero_chain_k.{name}": 2 * per_call}
    want = dia.dia_zero_chain_k_ref(A, St, B, dinv, tv, omega)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert _rel_err(g, w) <= TOL[dtype]
    if plan is None:
        return
    rows = tuple(torch.empty_like(B) for _ in range(2))
    dia._zero_chain_k_rows(A, St, B, dinv, tv, omega, *rows)
    other = dataclasses.replace(plan, strip=-(-n // 3), strips=3)
    alt = tuple(torch.empty_like(B) for _ in range(2))
    dia._zero_chain_k_ring(A, St, B, dinv, tv, omega, *alt, other)
    torch.cuda.synchronize()
    for g, r_, a in zip(got, rows, alt):
        assert torch.equal(g, r_) and torch.equal(g, a)


# name -> (n_pad, A's offsets, St's offsets) for K5 and K4: the
# device-built 2048^2 levels 0 and 1 (random diagonals at their offsets),
# an odd n_pad with an asymmetric reach, the coarse levels' n_pad 729 and
# 990, and a 3-D 7-point pattern whose +-n^2 reach no ring holds
CHAIN_CASES = {
    "level0": (4227072, (-2049, -1, 0, 1, 2049), (-2049, -1, 0, 1, 2049)),
    "level1": (475136, (-685, -684, -683, -1, 0, 1, 683, 684, 685),
               (-685, -684, -683, -1, 0, 1, 683, 684, 685)),
    "odd n_pad": (100_003, (-317, -1, 1, 317), (-4000, -317, 0, 317, 2999)),
    "n_pad 729": (729, (-28, -27, -26, -1, 0, 1, 26, 27, 28),
                  (-28, -27, -26, -1, 0, 1, 26, 27, 28)),
    "n_pad 990": (990, (-34, -33, -32, -1, 0, 1, 32, 33, 34),
                  (-34, -33, -32, -1, 0, 1, 32, 33, 34)),
    "3-D 7-point": (20 * 120 * 120, (-14400, -120, -1, 0, 1, 120, 14400),
                    (-14400, -120, -1, 0, 1, 120, 14400)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_k4_k5_strip_march_equals_per_row_kernel(cuda, dtype, case):
    """K5 and K4 at the path shapes, omega by value and by device pointer:
    one launch per call of the strip march (the per-row kernel only for
    the 3-D reach, counted apart), within TOL of the twin, two launches
    bit-identical, and equal to the per-row kernel bit for bit, under the
    plan and under another (128 threads, one row a thread, 3 strips)."""
    n, offs, soffs = CHAIN_CASES[case]
    A = _random_dia(n, offs, dtype, cuda, 0)
    St = _random_dia(n, soffs, dtype, cuda, 1)
    x, b, dinv, tv = (_rand(n, dtype, cuda, s) for s in (2, 3, 4, 5))
    sms = _build.sm_count(cuda)
    name = str(dtype).removeprefix("torch.")
    for kernel, outer, call, ref, rows in (
            ("dia_zero_chain", St,
             lambda w: dia.dia_zero_chain(A, St, b, dinv, tv, w),
             lambda w: dia.dia_zero_chain_ref(A, St, b, dinv, tv, w),
             lambda w: dia._zero_chain_rows(A, St, b, dinv, tv, w)),
            ("dia_jacobi_res", A,
             lambda w: dia.dia_jacobi_res(A, x, b, dinv, w),
             lambda w: dia.dia_jacobi_res_ref(A, x, b, dinv, w),
             lambda w: dia._jacobi_res_rows(A, x, b, dinv, w))):
        plan = dia.chain_plan(A.offsets, outer.offsets, n, dtype, sms)
        assert (plan is None) == (case == "3-D 7-point")
        for omega in (0.85, torch.tensor(0.85, dtype=dtype, device=cuda)):
            _build.reset_launches()
            got, again = call(omega), call(omega)
            torch.cuda.synchronize()
            key = kernel if plan is not None else f"{kernel}_rows"
            assert _build.launches == {f"{key}.{name}": 2}
            for g, a, w in zip(got, again, ref(omega)):
                assert torch.equal(g, a)
                assert _rel_err(g, w) <= TOL[dtype]
            for g, r_ in zip(got, rows(omega)):
                assert torch.equal(g, r_)
        if plan is None:
            continue
        other = dataclasses.replace(plan, threads=128, vec=1,
                                    strip=-(-n // 3), strips=3)
        alt = tuple(torch.empty_like(b) for _ in range(2))
        mode = dia._ZERO_CHAIN if kernel == "dia_zero_chain" \
            else dia._JACOBI_RES
        dia._chain(mode, kernel, other, A, St if outer is St else None,
                   None if outer is St else x, b, dinv, tv, 0.85, *alt)
        torch.cuda.synchronize()
        for g, a in zip(call(0.85), alt):
            assert torch.equal(g, a)


def _long_column_rect():
    """16384 x 300, 3 entries per row (~164 per column: K7's tile form),
    plus column 150 with 8192 entries, longer than the tile budget."""
    P = _random_rect(16384, 300, per_row=3, spread=10, seed=7)
    rows = np.arange(0, 16384, 2)
    extra = sp.csr_matrix((np.random.default_rng(8).standard_normal(
        rows.size), (rows, np.full(rows.size, 150))), shape=P.shape)
    return (P + extra).tocsr()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["dense column", "long columns", "caps"])
def test_k7_tiles_match_cpu_twin(cuda, dtype, case):
    """K7 in both forms: one thread per column (short columns, with one of
    1024 entries) and tiles (~164 entries per column, longer than a warp,
    with one of 8192 entries, longer than the budget and staged in pieces;
    tiles at the 2048-entry budget); the empty columns past m.  Equal to
    the CPU twin bit for bit and across two launches, one launch per
    call."""
    P = {"dense column": _dense_column_rect,
         "long columns": _long_column_rect, "caps": _caps_rect}[case]()
    W = windowed_from_scipy(P, dtype=dtype, device=cuda)
    m = W.m_chunks * W.w2
    tiles_form = W.data.numel() >= window._K7_TILE_SLOTS * m
    assert tiles_form == (case != "dense column")
    r = _rand(W.n_pad, dtype, cuda, 5)
    _build.reset_launches()
    y = window.windowed_rmatvec(W, r)
    again = window.windowed_rmatvec(W, r)
    torch.cuda.synchronize()
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"windowed_rmatvec.{name}": 2}
    lens = W.column_plan[1].diff()
    assert int(lens.max()) > 32 and int((lens == 0).sum()) > 0
    if tiles_form:
        budget, _ = W.column_tiles(window._K7_COLS, window._K7_MIN_BUDGET)
        if case == "caps":
            assert budget == 2048
        else:
            assert int(lens.max()) > budget
    W_cpu = dataclasses.replace(W, data=W.data.cpu(), idx=W.idx.cpu(),
                                starts=W.starts.cpu())
    assert torch.equal(y, again)
    assert torch.equal(y.cpu(), window.windowed_rmatvec_ref(W_cpu, r.cpu()))


def test_batched_device_built_solve_on_card_matches_cpu(cuda):
    """A 128^2 device-built float64 batched solve (K=3, one lane zero) on
    the card against the same on the CPU (twins): per-lane counts equal,
    histories to rtol 1e-8; the K-lane kernels launched."""
    A = poisson((128, 128), format="csr")
    B = np.random.default_rng(0).random((A.shape[0], 3))
    B[:, 1] = 0.0
    kw = dict(grid=(128, 128), dtype=torch.float64, max_coarse=100,
              mixed_precision=True)
    res_g, res_c = [], []
    dg = device_sa_setup(A, device=cuda, **kw)
    _build.reset_launches()
    X = dg.solve(B, tol=1e-10, accel="cg", precision="mixed",
                 residuals=res_g)
    counts = dict(_build.launches)
    device_sa_setup(A, device="cpu", **kw).solve(
        B, tol=1e-10, accel="cg", precision="mixed", residuals=res_c)
    assert [len(r) for r in res_g] == [len(r) for r in res_c]
    for g, c in zip(res_g, res_c):
        np.testing.assert_allclose(g, c, rtol=1e-8)
    for j in (0, 2):
        assert np.linalg.norm(B[:, j] - A @ X[:, j]) < 1e-10 * np.linalg.norm(
            B[:, j])
    for k in ("dia_zero_chain_k", "dia_spmm_add", "dia_jacobi_k", "dia_spmm"):
        assert counts.get(f"{k}.float64", 0) > 0, (k, counts)


def test_k_lane_wrapper_rejects_bad_operands(cuda):
    A = poisson((32, 32), format="csr")
    D = dia_from_scipy(A, device=cuda, row_pad=1024)
    with pytest.raises(TypeError):
        dia.dia_spmm(D, torch.ones(2, D.n_pad, dtype=torch.float64,
                                   device=cuda))
    with pytest.raises(ValueError):
        dia.dia_spmm(D, torch.ones(2, D.n_pad + 1, device=cuda))
    with pytest.raises(ValueError):
        dia.dia_spmm(D, torch.ones(D.n_pad, 2, device=cuda).T)  # strided
    with pytest.raises(ValueError):
        dia.dia_spmm_add(D, torch.ones(2, D.n_pad, device=cuda),
                         torch.ones(3, D.n_pad, device=cuda))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [3, 8, 19])
def test_k10_zero_res_k_matches_twin(cuda, dtype, K):
    """K10 against its twin on K-major stacks, omega by value and as a 0-d
    device tensor; one launch per call for any K (the lane kernel)."""
    A = poisson((48, 70), format="csr")
    D = dia_from_scipy(A, dtype=dtype, device=cuda, row_pad=1024)
    B = torch.as_tensor(np.random.default_rng(K).random((K, D.n_pad)),
                        dtype=dtype, device=cuda)
    dinv = torch.zeros(D.n_pad, dtype=dtype, device=cuda)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / A.diagonal(), dtype=dtype)
    _build.reset_launches()
    for omega in (0.85, torch.tensor(0.85, dtype=dtype, device=cuda)):
        got = dia.dia_jacobi_zero_res_k(D, B, dinv, omega)
        want = dia.dia_jacobi_zero_res_k_ref(D, B, dinv, omega)
        for g, w in zip(got, want):
            assert g.shape == (K, D.n_pad)
            assert _rel_err(g, w) <= TOL[dtype]
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"dia_jacobi_zero_res_k.{name}": 2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [3, 8, 19])
@pytest.mark.parametrize("case", ["device level0", "device level1",
                                  "device level4", "host level0",
                                  "3-D 7-point", "unaligned stack"])
def test_k10_lane_kernel_equals_per_row_kernel(cuda, dtype, K, case):
    """K10 with the lane on the grid at the paths' offsets (nd 5, 9 and the
    7-point form), 4 float32 rows a thread or 1 (level 4's odd n_pad, a
    misaligned B): one launch per call for any K, two launches equal, bit
    for bit the thread-per-row kernel's (X, R), within TOL of the twin."""
    n, offsets, shift = K8_CASES[case]
    D = _random_dia(n, offsets, dtype, cuda, 0)
    rng = np.random.default_rng(K)
    big = torch.as_tensor(rng.random(K * n + shift), dtype=dtype,
                          device=cuda)
    B = big[shift:].view(K, n)
    dinv = _rand(n, dtype, cuda, 3)
    omega = torch.tensor(0.85, dtype=dtype, device=cuda)
    plan = dia.k8_plan(D.offsets, n, K, dtype, shift == 0)
    assert plan is not None and 0 < plan.lo <= plan.hi < plan.row_blocks
    assert plan.vec == (4 if dtype == torch.float32 and n % 4 == 0
                        and shift == 0 else 1)
    name = str(dtype).removeprefix("torch.")
    _build.reset_launches()
    got = dia.dia_jacobi_zero_res_k(D, B, dinv, omega)
    again = dia.dia_jacobi_zero_res_k(D, B, dinv, omega)
    assert _build.launches == {f"dia_jacobi_zero_res_k.{name}": 2}
    rows = dia._zero_res_k_rows(D, B, dinv, omega)
    torch.cuda.synchronize()
    assert _build.launches[f"dia_jacobi_zero_res_k_rows.{name}"] == \
        -(-K // 16)
    want = dia.dia_jacobi_zero_res_k_ref(D, B, dinv, omega)
    for g, a, r, w in zip(got, again, rows, want):
        assert g.shape == (K, n)
        assert torch.equal(g, a) and torch.equal(g, r)
        assert _rel_err(g, w) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [3, 8, 19, 64, 65])
def test_k12_k13_windowed_lane_kernels_match_twins(cuda, dtype, K):
    """K12 and K13 against their twins (the gather and scatter-add forms
    lane by lane): one launch per call (K=65 tiles its lanes over the
    grid), two launches bit-identical, and K13 equal to the CPU twin bit
    for bit (it sums each column in the twin's order)."""
    P = _random_rect(8192, 2600, per_row=4, spread=60, seed=4)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda)
    rng = np.random.default_rng(K)
    X = torch.as_tensor(rng.random((K, W.m_chunks * W.w2)), dtype=dtype,
                        device=cuda)
    R = torch.as_tensor(rng.random((K, W.n_pad)), dtype=dtype, device=cuda)
    _build.reset_launches()
    Y = window.windowed_matmat_k(W, X)
    Z = window.windowed_rmatmat_k(W, R)
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"windowed_matmat_k.{name}": 1,
                               f"windowed_rmatmat_k.{name}": 1}
    assert Y.shape == (K, W.n_pad) and Z.shape == (K, W.m_chunks * W.w2)
    assert _rel_err(Y, window.windowed_matmat_k_ref(W, X)) <= TOL[dtype]
    W_cpu = dataclasses.replace(W, data=W.data.cpu(), idx=W.idx.cpu(),
                                starts=W.starts.cpu())
    assert torch.equal(Z.cpu(), window.windowed_rmatmat_k_ref(W_cpu,
                                                              R.cpu()))
    assert torch.equal(window.windowed_matmat_k(W, X), Y)
    assert torch.equal(window.windowed_rmatmat_k(W, R), Z)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k12_block_no_power_of_two_divides(cuda, dtype):
    """K12 on row blocks of 1100 rows (4 x 275, as the sharded block
    transfers' candidate remap takes 7524): full CTAs of rows and a
    shorter last one a block, against its twin on K = 8 lanes, one
    launch a call, two launches bit-identical."""
    P = _random_rect(8192, 2600, per_row=4, spread=60, seed=5)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda, block=1100)
    assert W.block == 1100
    X = torch.as_tensor(np.random.default_rng(8).random(
        (8, W.m_chunks * W.w2)), dtype=dtype, device=cuda)
    assert window._k12_rows(W, 8) == 512
    _build.reset_launches()
    Y = window.windowed_matmat_k(W, X)
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"windowed_matmat_k.{name}": 1}
    assert _rel_err(Y, window.windowed_matmat_k_ref(W, X)) <= TOL[dtype]
    assert torch.equal(window.windowed_matmat_k(W, X), Y)


def _dense_column_rect():
    """2048 x 700, ~5 entries per row, plus column 350 with 1024 entries:
    longer than the tile budget (128 at this size), so it gets a tile of
    its own and K13 sums it from device memory."""
    P = _random_rect(2048, 700, per_row=5, spread=30, seed=2)
    rng = np.random.default_rng(3)
    rows = np.arange(0, 2048, 2)
    return (P + sp.csr_matrix((rng.standard_normal(rows.size),
                               (rows, np.full(rows.size, 350))),
                              shape=P.shape)).tocsr()


def _caps_rect():
    """2**19 x 2**18 with ~2.6M entries, for K13's tiles at their caps:
    the first half of the rows put 10 entries each into the first half of
    the columns (~20 per column: tiles fill the 2048-entry budget), the
    second half one entry each into the rest (2 per column: tiles fill
    the 512-column cap at K = 2)."""
    n, m = 2 ** 19, 2 ** 18
    rng = np.random.default_rng(6)
    dense = np.repeat(np.arange(n // 2), 10)
    sparse = np.arange(n // 2, n)
    rows = np.concatenate([dense, sparse])
    cols = np.concatenate([
        np.clip(dense // 2 + rng.integers(-16, 17, dense.size), 0,
                m // 2 - 1),
        sparse // 2])
    return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(n, m))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,K", [("dense column", 8),
                                    ("dense column", 64),
                                    ("dense column", 65), ("caps", 2),
                                    ("caps", 64)])
def test_k13_tiles_at_their_limits_match_twin(cuda, dtype, case, K):
    """K13 on tiles at the edges of its shared memory: a column longer
    than the tile budget (summed from device memory, its lanes over the
    threads), and tiles that fill the 2048-entry budget and the 512-column
    cap.  Equal to the CPU twin bit for bit and across two launches; K12
    on the same operator within tolerance."""
    P = _dense_column_rect() if case == "dense column" else _caps_rect()
    W = windowed_from_scipy(P, dtype=dtype, device=cuda)
    lt, cols = window._k13_mapping(W, K)
    budget, tiles = W.column_tiles(cols)
    colptr = W.column_plan[1].long()
    t = tiles.long()
    n_cols, n_ent = t[1:] - t[:-1], colptr[t[1:]] - colptr[t[:-1]]
    if case == "dense column":
        assert budget == 128 and int(n_ent.max()) > budget
    elif K == 2:
        assert (budget, cols) == (2048, 512)
        assert int(n_cols.max()) == 512
        assert int(n_ent[n_cols > 1].max()) > 3 * budget // 4
    rng = np.random.default_rng(K)
    X = torch.as_tensor(rng.random((K, W.m_chunks * W.w2)), dtype=dtype,
                        device=cuda)
    R = torch.as_tensor(rng.random((K, W.n_pad)), dtype=dtype, device=cuda)
    _build.reset_launches()
    Z = window.windowed_rmatmat_k(W, R)
    Y = window.windowed_matmat_k(W, X)
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"windowed_matmat_k.{name}": 1,
                               f"windowed_rmatmat_k.{name}": 1}
    W_cpu = dataclasses.replace(W, data=W.data.cpu(), idx=W.idx.cpu(),
                                starts=W.starts.cpu())
    assert torch.equal(Z.cpu(), window.windowed_rmatmat_k_ref(W_cpu,
                                                              R.cpu()))
    assert torch.equal(window.windowed_rmatmat_k(W, R), Z)
    assert _rel_err(Y, window.windowed_matmat_k_ref(W, X)) <= TOL[dtype]


@pytest.mark.parametrize("K", [3, 8, 19])
def test_k15_interleaved_modes_match_twins(cuda, K):
    """K15's five modes against their twins on the lane-aligned level-0
    operators of a (24, 512) grid; K=19 takes two launches per call."""
    from pyamg_tpu_torch.engine.batched_cycle import _jacobi_wd
    from pyamg_tpu_torch.sparse import interleaved as il

    grid = (24, 512)
    dsa = device_sa_setup(poisson(grid, format="csr"), grid=grid,
                          device=cuda, max_coarse=60, lane_align=True)
    lvl = dsa.hierarchy.levels[0]
    A, St, S, tv = lvl.A, lvl.R.St, lvl.P.S, lvl.R.tv
    wd = _jacobi_wd(lvl.pre)
    rng = np.random.default_rng(K)
    Bi, Xi = (torch.as_tensor(rng.random((A.n_pad // 128, K, 128)),
                              dtype=torch.float32, device=cuda)
              for _ in range(2))
    _build.reset_launches()
    cases = [(il.int_jacobi_zero_res(A, wd, Bi),
              il.int_jacobi_zero_res_ref(A, wd, Bi)),
             ((il.int_spmv_scaled(St, Bi, tv),),
              (il.int_spmv_scaled_ref(St, Bi, tv),)),
             ((il.int_spmv(A, Bi),), (il.int_spmv_ref(A, Bi),)),
             ((il.int_spmv_add(S, Bi, Xi),), (il.int_spmv_add_ref(S, Bi, Xi),)),
             ((il.int_jacobi_step(A, wd, Bi, Xi),),
              (il.int_jacobi_step_ref(A, wd, Bi, Xi),))]
    torch.cuda.synchronize()
    for got, want in cases:
        for g, w in zip(got, want):
            assert g.shape == Bi.shape
            assert _rel_err(g, w) <= TOL[torch.float32]
    per_call = -(-K // 16)
    assert _build.launches == {f"{m}.float32": per_call for m in (
        "int_jacobi_zero_res", "int_spmv_scaled", "int_spmv", "int_spmv_add",
        "int_jacobi_step")}
    with pytest.raises(ValueError):             # a K-major stack
        il.int_spmv(A, Bi.reshape(K, -1))
    with pytest.raises(TypeError):              # float64 operator
        il.int_spmv(dataclasses.replace(A, data=A.data.double()), Bi)


def test_host_built_batched_solve_on_card_matches_cpu(cuda):
    """A 128^2 host-built float64 batched solve (K=3, one lane zero) on the
    card against the same on the CPU (twins): per-lane counts equal,
    histories to rtol 1e-8; K10, K12 and K13 launched."""
    A = poisson((128, 128), format="csr")
    ml = smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    B = np.random.default_rng(0).random((A.shape[0], 3))
    B[:, 1] = 0.0
    kw = dict(tol=1e-10, accel="cg", precision="mixed")
    res_g, res_c = [], []
    dg = as_device_solver(ml, dtype=torch.float64, device=cuda,
                          mixed_precision=True)
    _build.reset_launches()
    X = dg.solve(B, residuals=res_g, **kw)
    counts = dict(_build.launches)
    as_device_solver(ml, dtype=torch.float64, device="cpu",
                     mixed_precision=True).solve(B, residuals=res_c, **kw)
    assert [len(r) for r in res_g] == [len(r) for r in res_c]
    for g, c in zip(res_g, res_c):
        np.testing.assert_allclose(g, c, rtol=1e-8)
    for j in (0, 2):
        assert np.linalg.norm(B[:, j] - A @ X[:, j]) < 1e-10 * np.linalg.norm(
            B[:, j])
    for k in ("dia_jacobi_zero_res_k", "windowed_matmat_k",
              "windowed_rmatmat_k", "dia_jacobi_k", "dia_spmm"):
        assert counts.get(f"{k}.float64", 0) > 0, (k, counts)


def test_interleaved_solve_on_card_matches_cpu(cuda):
    """The (24, 512) lane-aligned float32 batched CG on the card takes the
    interleaved route (every K15 mode launched) and agrees with the same
    solve on the CPU: counts within one, first histories to 1e-4."""
    grid = (24, 512)
    A = poisson(grid, format="csr")
    B = np.random.default_rng(5).standard_normal((A.shape[0], 4))
    kw = dict(grid=grid, max_coarse=60, lane_align=True)
    res_g, res_c = [], []
    _build.reset_launches()
    X = device_sa_setup(A, device=cuda, **kw).solve(
        B, tol=1e-6, maxiter=60, accel="cg", residuals=res_g)
    counts = dict(_build.launches)
    device_sa_setup(A, device="cpu", **kw).solve(
        B, tol=1e-6, maxiter=60, accel="cg", residuals=res_c)
    for g, c in zip(res_g, res_c):
        assert abs(len(g) - len(c)) <= 1
        np.testing.assert_allclose(g[:5], c[:5], rtol=1e-4)
    for j in range(4):
        assert np.linalg.norm(B[:, j] - A @ X[:, j]) < 5e-6 * np.linalg.norm(
            B[:, j])
    for m in ("int_jacobi_zero_res", "int_spmv_scaled", "int_spmv",
              "int_spmv_add", "int_jacobi_step"):
        assert counts.get(f"{m}.float32", 0) > 0, (m, counts)


@pytest.mark.parametrize("payload", [torch.float32, torch.float64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k14_windowed_select_matches_twin(cuda, dtype, payload):
    """K14 against its twin (the gather x[column]): exact, for a payload
    of either dtype on an operator of either dtype; one launch, counted
    under the payload's dtype."""
    P = _random_rect(8192, 2600, per_row=4, spread=60, seed=4)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda)
    x = torch.as_tensor(np.random.default_rng(9).integers(
        -2 ** 23, 2 ** 23, W.m_chunks * W.w2), dtype=payload, device=cuda)
    x = x / 7                          # non-integers too, still exact
    _build.reset_launches()
    got = window.windowed_select(W, x)
    assert got.shape == W.idx.shape and got.dtype == payload
    assert torch.equal(got, window.windowed_select_ref(W, x))
    assert torch.equal(W.select(x[: P.shape[1]]), got)
    assert _build.launches == {
        f"windowed_select.{str(payload).removeprefix('torch.')}": 2}
    with pytest.raises(ValueError):
        window.windowed_select(W, x[:-1])
    with pytest.raises(TypeError):
        window.windowed_select(W, x.to(torch.int32))


# K6 / K14 operators: (rows = columns, spread, block); square, so the last
# row block reads the last window (starts at m_chunks - 2)
GATHER_CASES = {"smallest block": (8192, 70, 256),
                "largest block": (32768, 1500, 8192),
                "under one wave": (2048, 40, 1024)}


def _gather_by(W, x, plan):
    """K6 / K14 by ``plan``: the wrappers' launch with another form."""
    out = torch.empty(W.idx.shape if plan.select else (W.n_pad,),
                      dtype=x.dtype, device=x.device)
    return window._gather(W, x, out, plan)


def _gather_forms(W, plan, itemsize):
    """The plan, and each other form it can pick at this operator: 16
    bytes or one value a thread, one item a thread with the fewest and
    the most threads, one CTA a row block."""
    forms = [plan]
    for vec in sorted({1, 16 // itemsize}):
        per_block = (W.k * W.block if plan.select else W.block) // vec
        for threads, cpb in ((128, None), (1024, None), (256, 1)):
            cpb = cpb or max(1, -(-per_block // threads))
            forms.append(dataclasses.replace(
                plan, vec=vec, threads=threads, ctas_per_block=cpb,
                items=-(-per_block // cpb)))
    return forms


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 5, 7, 25])
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_k6_gather_equals_per_row_kernel(cuda, dtype, k, case):
    """K6 by its plan, and in every form the plan can pick, equal to the
    per-row kernel bit for bit (one FMA a slot, in slot order), one launch
    a call counted as ``windowed_matvec``; the per-row kernel counted as
    ``windowed_matvec_rows``, and within the tolerance of the twin."""
    n, spread, block = GATHER_CASES[case]
    P = _random_rect(n, n, per_row=k, spread=spread, seed=k)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda, block=block)
    assert W.k == k and int(W.starts.max()) == W.m_chunks - 2
    x = _rand(W.m_chunks * W.w2, dtype, cuda, 3)
    name = str(dtype).removeprefix("torch.")
    _build.reset_launches()
    rows = window._windowed_matvec_rows(W, x)
    assert _build.launches == {f"windowed_matvec_rows.{name}": 1}
    assert _rel_err(rows, window.windowed_matvec_ref(W, x)) <= TOL[dtype]
    plan = window._gather_plan_for(W, x, rows, False)
    if case == "under one wave":
        assert plan.grid < _build.sm_count(W.device)
    for p in _gather_forms(W, plan, x.element_size()):
        _build.reset_launches()
        got = _gather_by(W, x, p)
        torch.cuda.synchronize()
        assert _build.launches == {f"windowed_matvec.{name}": 1}, p
        assert torch.equal(got, rows), p
    assert torch.equal(window.windowed_matvec(W, x), rows)


@pytest.mark.parametrize("payload", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_k14_gather_exact_in_every_form(cuda, case, dtype, payload):
    """K14 by its plan, and in every form the plan can pick, equal to its
    twin exactly, for a payload of either dtype on an operator of either
    dtype; one launch a call counted as ``windowed_select``."""
    n, spread, block = GATHER_CASES[case]
    P = _random_rect(n, n, per_row=7, spread=spread, seed=5)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda, block=block)
    assert int(W.starts.max()) == W.m_chunks - 2
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        W.m_chunks * W.w2), dtype=payload, device=cuda)
    want = window.windowed_select_ref(W, x)
    name = str(payload).removeprefix("torch.")
    out = torch.empty(W.idx.shape, dtype=payload, device=cuda)
    plan = window._gather_plan_for(W, x, out, True)
    assert plan.grid >= _build.sm_count(W.device)
    for p in _gather_forms(W, plan, x.element_size()):
        _build.reset_launches()
        got = _gather_by(W, x, p)
        torch.cuda.synchronize()
        assert _build.launches == {f"windowed_select.{name}": 1}, p
        assert got.dtype == payload and torch.equal(got, want), p
    _build.reset_launches()
    assert torch.equal(window.windowed_select(W, x), want)
    assert _build.launches == {f"windowed_select.{name}": 1}


@pytest.mark.parametrize("dtype", DTYPES)
def test_k6_k14_unaligned_payload_keeps_16_byte_packs(cuda, dtype):
    """A payload view off 16 bytes (x is only gathered) keeps the plan's
    16-byte packs, with K6 equal to the per-row kernel and K14 to its
    twin; the per-row kernel raises on CPU operands."""
    P = _random_rect(32768, 32768, per_row=5, spread=300, seed=1)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda, block=1024)
    m = W.m_chunks * W.w2
    x = _rand(m + 1, dtype, cuda, 2)[1:]
    assert x.data_ptr() % 16 != 0
    y = torch.empty(W.n_pad, dtype=dtype, device=cuda)
    out = torch.empty(W.idx.shape, dtype=dtype, device=cuda)
    assert window._gather_plan_for(W, x, out, True).vec == 16 // x.itemsize
    plan = window._gather_plan_for(W, x, y, False)
    assert plan.vec == window.gather_plan(False, W.n_pad, W.k, W.block,
                                          x.itemsize,
                                          _build.sm_count(W.device)).vec
    name = str(dtype).removeprefix("torch.")
    _build.reset_launches()
    got, sel = window.windowed_matvec(W, x), window.windowed_select(W, x)
    assert _build.launches == {f"windowed_matvec.{name}": 1,
                               f"windowed_select.{name}": 1}
    assert torch.equal(got, window._windowed_matvec_rows(W, x))
    assert torch.equal(sel, window.windowed_select_ref(W, x))
    with pytest.raises(ValueError):
        window._windowed_matvec_rows(W, x.cpu())


def test_unstructured_setup_on_card_matches_cpu(cuda):
    """A 48^2 P1 mesh operator: the unstructured setup on the card gives
    the CPU's levels (float64), every setup kernel launched, and its f32
    solve converges as the CPU one does."""
    from pyamg_tpu_torch import (device_unstructured_sa_setup,
                                 gradgradform, regular_triangle_mesh)

    A = gradgradform(*regular_triangle_mesh(48, 48))
    A = (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()
    _build.reset_launches()
    g = device_unstructured_sa_setup(A, dtype=torch.float64, device=cuda,
                                     max_coarse=30)
    counts = dict(_build.launches)
    c = device_unstructured_sa_setup(A, dtype=torch.float64, device="cpu",
                                     max_coarse=30)
    assert g.setup_info == c.setup_info
    for k in ("windowed_select.float32", "windowed_select.float64",
              "windowed_matvec.float64", "windowed_rmatvec.float64",
              "windowed_matmat_k.float64", "windowed_rmatmat_k.float64"):
        assert counts.get(k, 0) > 0, (k, counts)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res_g, res_c = [], []
    g32 = device_unstructured_sa_setup(A, device=cuda, max_coarse=30)
    g32.solve(b, tol=1e-6, accel="cg", residuals=res_g)
    device_unstructured_sa_setup(A, device="cpu", max_coarse=30).solve(
        b, tol=1e-6, accel="cg", residuals=res_c)
    assert abs(len(res_g) - len(res_c)) <= 1
    assert res_g[-1] <= 1e-6 * np.linalg.norm(b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [(96, 128), (64, 16, 16)])
def test_k16_ring_of_one_and_shards_match_k1(cuda, dtype, grid):
    """K16 on the card, on a 2-D 5-point and a 3-D 7-point operator: the
    ring of one (halos are x's own tail and head) and P = 4 in-process
    shards (halos copied on a side stream) equal K1 bit for bit; one
    launch per ring apply, two per shard (interior, then boundary)."""
    from pyamg_tpu_torch.parallel import halo_width
    from pyamg_tpu_torch.parallel.halo_spmv import halo_spmv, halo_spmv_shards
    from pyamg_tpu_torch.parallel.partition import SolverMesh

    A = dia_from_scipy(poisson(grid, format="csr"), dtype=dtype,
                       device=cuda, row_pad=1024)
    assert A.ndiags == 2 * len(grid) + 1
    x = _rand(A.n_pad, dtype, cuda, 7)
    want = dia.dia_spmv(A, x)
    one = SolverMesh(rank=0, world=1, device=cuda)
    _build.reset_launches()
    ring = halo_spmv(A.data, A.offsets, A.offsets_t, x, halo_width(A), one,
                     1)
    shards = halo_spmv_shards(A, x, 4)
    torch.cuda.synchronize()
    assert torch.equal(ring, want) and torch.equal(shards, want)
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"dia_halo_spmv.{name}": 1 + 2 * 4}


def test_sharded_solve_world_of_one_on_card(cuda, tmp_path):
    """A world-of-one NCCL process group (file:// rendezvous): all_reduce
    and all_gather of card tensors (the solve itself sends nothing: every
    level is a ring of one), then the 128^2 host-built float64 hierarchy
    sharded solves as the unsharded one does, through K16 on its DIA
    levels."""
    import torch.distributed as dist

    from pyamg_tpu_torch import DeviceMultilevelSolver
    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)

    A = poisson((128, 128), format="csr")
    ml = smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    dml = as_device_solver(ml, dtype=torch.float64, device=cuda)
    b = np.random.default_rng(2).random(A.shape[0])
    kw = dict(tol=1e-10, maxiter=30, accel="cg")
    res0, res1 = [], []
    x0 = dml.solve(b, residuals=res0, **kw)
    assert not dist.is_initialized()
    initialize_distributed(init_method=f"file://{tmp_path / 'rdzv'}",
                           world_size=1, rank=0, device=cuda)
    try:
        mesh = make_solver_mesh(device=cuda)
        v = torch.arange(5.0, device=cuda)
        parts = [torch.empty_like(v)]
        dist.all_gather(parts, v)
        s = v.clone()
        dist.all_reduce(s)
        assert torch.equal(parts[0], v) and torch.equal(s, v)
        sharded = DeviceMultilevelSolver(shard_hierarchy(dml.hierarchy, mesh))
        _build.reset_launches()
        x1 = sharded.solve(b, residuals=res1, **kw)
        counts = dict(_build.launches)
    finally:
        dist.destroy_process_group()
    assert len(res1) == len(res0)
    np.testing.assert_allclose(res1, res0, rtol=1e-8)
    np.testing.assert_allclose(x1, x0, atol=1e-10)
    assert counts.get("dia_halo_spmv.float64", 0) > 0, counts
    assert counts.get("windowed_rmatvec.float64", 0) > 0, counts


@pytest.fixture(scope="module")
def cycles_pair(cuda):
    """The 128^2 device-built float64 hierarchy (three levels) on the
    card and its copy on the CPU (the plain twins)."""
    A = poisson((128, 128), format="csr")
    kw = dict(grid=(128, 128), dtype=torch.float64, max_coarse=100,
              mixed_precision=True)
    return (A, device_sa_setup(A, device=cuda, **kw),
            device_sa_setup(A, device="cpu", **kw))


@pytest.mark.parametrize("cycle,accel", [
    ("W", None), ("W", "cg"), ("F", "cg"), ("AMLI", "cg"), ("V", "bicgstab"),
    ("V", "gmres"), ("W", "fgmres"), ("V", "cgnr"), ("V", "cgne"),
    ("V", "cr"), ("V", "minimal_residual"), ("V", "steepest_descent")])
def test_cycles_and_krylov_on_card_match_cpu(cycles_pair, cycle, accel):
    """Every cycle and accel on the card against the same solve of the
    CPU copy (float64, mixed loop): the same count, histories to rtol
    1e-8 (entries below 1e-14 of the first, where GMRES's restarts reach
    the rounding floor, to that); the W and F cycles' second visits launch
    K4 (``dia_jacobi_res``) on the card, AMLI's coarse products K1."""
    A, dg, dc = cycles_pair
    b = np.random.default_rng(0).random(A.shape[0])
    kw = dict(tol=1e-10, maxiter=10 if accel is None else 40, cycle=cycle,
              accel=accel, precision="mixed", restart=12)
    res_g, res_c = [], []
    _build.reset_launches()
    dg.solve(b, residuals=res_g, **kw)
    counts = dict(_build.launches)
    dc.solve(b, residuals=res_c, **kw)
    assert len(res_g) == len(res_c)
    np.testing.assert_allclose(res_g, res_c, rtol=1e-8, atol=1e-14 * res_c[0])
    for k in ("dia_zero_chain", "dia_spmv_add", "dia_jacobi"):
        assert counts.get(f"{k}.float64", 0) > 0, (k, counts)
    if cycle in ("W", "F"):
        assert counts.get("dia_jacobi_res.float64", 0) > 0, counts
    assert not any(k.startswith("dia_jacobi_res_rows") for k in counts)


@pytest.mark.parametrize("cycle", ["W", "F", "AMLI"])
def test_cycles_make_no_host_sync(cycles_pair, cycle):
    """One cycle from zero with every host sync an error, on a vector and
    on a K = 3 stack (AMLI's per-lane guards are selects)."""
    _, dg, _ = cycles_pair
    cyc = dg.cycle_operator(cycle)
    n_pad = dg.hierarchy.levels[0].n_pad
    for shape in ((n_pad,), (3, n_pad)):
        r = torch.ones(shape, dtype=torch.float64,
                       device=dg.hierarchy.device)
        cyc(r)
        torch.cuda.synchronize()
        try:
            torch.cuda.set_sync_debug_mode("error")
            y = cyc(r)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert bool(torch.isfinite(y).all())


def test_batched_w_gmres_on_card_matches_cpu(cycles_pair):
    """K = 3 lanes (one zero) of W-cycle GMRES (restart 4) on the card
    against the CPU copy: per-lane counts equal, histories to rtol 1e-8
    (to 1e-14 of the first entry at the rounding floor), the zero lane
    frozen at entry; K8 / K9 through the lane kernel only."""
    A, dg, dc = cycles_pair
    B = np.random.default_rng(1).random((A.shape[0], 3))
    B[:, 1] = 0.0
    kw = dict(tol=1e-8, maxiter=24, cycle="W", accel="gmres", restart=4,
              precision="mixed")
    res_g, res_c = [], []
    _build.reset_launches()
    dg.solve(B, residuals=res_g, **kw)
    counts = dict(_build.launches)
    dc.solve(B, residuals=res_c, **kw)
    assert [len(r) for r in res_g] == [len(r) for r in res_c]
    assert len(res_g[1]) == 1
    for g, c in zip(res_g, res_c):
        np.testing.assert_allclose(g, c, rtol=1e-8, atol=1e-14 * c[0])
    for k in ("dia_zero_chain_k", "dia_jacobi_k", "dia_spmm", "dia_spmm_add"):
        assert counts.get(f"{k}.float64", 0) > 0, (k, counts)
    assert not any("_rows" in k for k in counts), counts


# name -> (host spec, the device kind it compiles to)
SMOOTHER_SPECS = {
    "mcgs": (("gauss_seidel", {"sweep": "symmetric"}), "mcgs"),
    "sor": (("sor", {"omega": 1.0, "sweep": "backward"}), "mcgs"),
    "richardson": (("richardson", {"omega": 1.0, "iterations": 2}),
                   "richardson"),
    "chebyshev": (("chebyshev", {"degree": 3}), "poly"),
    "jacobi_ne": (("jacobi_ne", {"omega": 0.5}), "jacobi_ne"),
    "jacobi_nr": (("gauss_seidel_nr", {}), "jacobi_nr"),
    "win_schwarz": (("schwarz", {}), "win_schwarz"),
}


@pytest.mark.parametrize("name", list(SMOOTHER_SPECS))
def test_smoothers_on_card_match_cpu(cuda, name):
    """Each smoother kind compiled from a host-built 128^2 float64
    hierarchy, applied on the card and on the CPU copy (the twins) to the
    same inputs, on the DIA level 0, from a guess and from zero, to a
    vector and to K = 3 lanes, to rtol 1e-12; a multicolour call on one
    vector is one launch of the sweep kernel (a colour step K9 on lanes),
    a Horner step K1 ``SPMV_ADD`` (K8 on lanes)."""
    import warnings

    from pyamg_tpu_torch import compile_hierarchy

    spec, kind = SMOOTHER_SPECS[name]
    A = poisson((128, 128), format="csr")
    ml = smoothed_aggregation_solver(A, presmoother=spec, postsmoother=spec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hg = compile_hierarchy(ml, dtype=torch.float64, device=cuda)
        hc = compile_hierarchy(ml, dtype=torch.float64, device="cpu")
    lg, lc = hg.levels[0], hc.levels[0]
    assert lg.pre.config[0] == kind
    rng = np.random.default_rng(3)
    for shape in ((lg.n_pad,), (3, lg.n_pad)):
        x, b = rng.random(shape), rng.random(shape)
        _build.reset_launches()
        got = (lg.pre(lg.A, torch.as_tensor(x, device=cuda),
                      torch.as_tensor(b, device=cuda)),
               lg.pre.zero_call(lg.A, torch.as_tensor(b, device=cuda)))
        counts = dict(_build.launches)
        want = (lc.pre(lc.A, torch.as_tensor(x), torch.as_tensor(b)),
                lc.pre.zero_call(lc.A, torch.as_tensor(b)))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel_err(g.cpu(), w) <= 1e-12
        k = "_k" if len(shape) == 2 else ""
        if name in ("mcgs", "sor"):
            if k:
                assert counts.get("dia_jacobi_k.float64", 0) > 0, counts
            else:
                assert counts == {"dia_mcgs_sweep.float64": 2}, counts
        if name == "chebyshev":
            key = "dia_spmm_add" if k else "dia_spmv_add"
            assert counts.get(f"{key}.float64", 0) > 0, counts
        assert not any("_rows" in c for c in counts), counts


def test_multicolor_and_chebyshev_w_cycle_make_no_host_sync(cuda):
    """Config 2's host-built form at 24^3 (multicolour GS at level 0, the
    Chebyshev fallback at level 1): one W-cycle from zero with every host
    sync an error, on a vector and on K = 3 lanes; its mixed stationary
    W-cycle takes the CPU copy's count."""
    from pyamg_tpu_torch import DeviceMultilevelSolver, compile_hierarchy

    A = poisson((24, 24, 24), format="csr")
    gs = ("gauss_seidel", {"sweep": "symmetric"})
    ml = smoothed_aggregation_solver(A, presmoother=gs, postsmoother=gs)
    kw = dict(dtype=torch.float32, mixed_precision=True, coarse_cutoff=1024)
    dg = DeviceMultilevelSolver(compile_hierarchy(ml, device=cuda, **kw))
    dc = DeviceMultilevelSolver(compile_hierarchy(ml, device="cpu", **kw))
    assert [lvl.pre.config[0] for lvl in dg.hierarchy.levels] == [
        "mcgs", "poly", "identity"]
    cyc = dg.cycle_operator("W")
    n_pad = dg.hierarchy.levels[0].n_pad
    for shape in ((n_pad,), (3, n_pad)):
        r = torch.ones(shape, device=cuda)
        cyc(r)
        torch.cuda.synchronize()
        try:
            torch.cuda.set_sync_debug_mode("error")
            y = cyc(r)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert bool(torch.isfinite(y).all())
    b = np.random.default_rng(1).random(A.shape[0])
    solve = dict(tol=1e-8, maxiter=30, cycle="W", accel=None,
                 precision="mixed")
    res_g, res_c = [], []
    dg.solve(b, residuals=res_g, **solve)
    dc.solve(b, residuals=res_c, **solve)
    assert len(res_g) == len(res_c) == 13
    assert res_g[-1] <= 1e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("name", ["chebyshev", "richardson"])
def test_device_setup_smoothers_on_card_match_cpu(cuda, name):
    """The device-built setup with Chebyshev (``poly_dyn``) or Richardson
    (``richardson_dyn``) smoothers, float64, on the card and on the CPU:
    the same count, histories to rtol 1e-8."""
    spec = (name, {"degree": 3} if name == "chebyshev" else {})
    A = poisson((64, 64), format="csr")
    kw = dict(grid=(64, 64), dtype=torch.float64, max_coarse=100,
              presmoother=spec, postsmoother=spec)
    dg = device_sa_setup(A, device=cuda, **kw)
    dc = device_sa_setup(A, device="cpu", **kw)
    b = np.random.default_rng(0).random(A.shape[0])
    res_g, res_c = [], []
    dg.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_g)
    dc.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_c)
    assert len(res_g) == len(res_c) and res_g[-1] <= 1e-8 * res_g[0]
    np.testing.assert_allclose(res_g, res_c, rtol=1e-8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [1, 3])
def test_masked_jacobi_k2_matches_twin(cuda, dtype, lanes):
    """AIR's masked sweep at 256^2 (upwind advection): one K2 launch (K9
    on lanes) with where(mask, dinv, 0), against the composed where-form
    on the card and against the twin on the CPU; the rows off the mask
    keep their bits."""
    from pyamg_tpu_torch import advection_2d
    from pyamg_tpu_torch.engine import relaxation as rel

    A, _ = advection_2d((256, 256))
    D = dia_from_scipy(A, dtype=dtype, device=cuda, row_pad=1024)
    n, m = A.shape[0], D.n_pad
    dinv = torch.zeros(m, dtype=dtype, device=cuda)
    dinv[:n] = torch.as_tensor(1.0 / A.diagonal(), dtype=dtype)
    idx = torch.arange(m, device=cuda)
    f = (idx < n) & (idx % 2 == 1)
    c = (idx < n) & ~f
    sm = rel.masked_jacobi(dinv, (f, c), (2, 1), omega=1.0)
    shape = (m,) if lanes == 1 else (lanes, m)
    x, b = (torch.as_tensor(np.random.default_rng(s).random(shape),
                            dtype=dtype, device=cuda) for s in (0, 1))
    _build.reset_launches()
    got = sm(D, x, b)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    name = str(dtype).removeprefix("torch.")
    key = f"dia_jacobi{'_k' if lanes > 1 else ''}.{name}"
    assert counts == {key: 3}, counts
    composed = rel.apply_smoother(sm.config, sm.arrays, D, x, b)
    assert _rel_err(got, composed) <= TOL[dtype]
    Dc = dataclasses.replace(D, data=D.data.cpu())
    smc = rel.masked_jacobi(dinv.cpu(), (f.cpu(), c.cpu()), (2, 1))
    assert _rel_err(got.cpu(), smc(Dc, x.cpu(), b.cpu())) <= TOL[dtype]
    one = rel.masked_jacobi(dinv, (f,), (1,))(D, x, b)
    keep = (~f).expand_as(one)
    assert torch.equal(one[keep], x[keep])


def test_classical_setup_on_card_matches_cpu(cuda):
    """device_rs_setup at 128^2 (float64) on the card against the same
    setup on the CPU: every level's A, P_emb, R_emb and rho, and the CG
    history; EmbeddedProlongator.apply_correction through K1 SPMV_ADD
    against the composed x + P @ xc; a float32 AIR setup at 128^2 on the
    card and on the CPU, each first stationary cycle dropping the
    residual by more than 1e5."""
    from pyamg_tpu_torch import (advection_2d, device_air_setup,
                                 device_rs_setup)

    A = poisson((128, 128), format="csr")
    kw = dict(grid=(128, 128), dtype=torch.float64, max_coarse=100)
    dg = device_rs_setup(A, device=cuda, **kw)
    dc = device_rs_setup(A, device="cpu", **kw)
    for i, (lg, lc) in enumerate(zip(dg.hierarchy.levels[:-1],
                                     dc.hierarchy.levels[:-1])):
        for g, c in ((lg.A, lc.A), (lg.P.P_emb, lc.P.P_emb),
                     (lg.R.R_emb, lc.R.R_emb)):
            assert g.offsets == c.offsets, i
            assert _rel_err(g.data.cpu(), c.data) <= 1e-12, i
        rg = float(dg.setup_info["levels"][i]["rho_D_inv_A"])
        rc = float(dc.setup_info["levels"][i]["rho_D_inv_A"])
        assert abs(rg - rc) <= 1e-12 * rc
    b = np.random.default_rng(0).random(A.shape[0])
    res_g, res_c = [], []
    dg.solve(b, tol=1e-10, maxiter=40, accel="cg", residuals=res_g)
    dc.solve(b, tol=1e-10, maxiter=40, accel="cg", residuals=res_c)
    assert len(res_g) == len(res_c)
    np.testing.assert_allclose(res_g, res_c, rtol=1e-8)
    lvl = dg.hierarchy.levels[0]
    ncp = dg.hierarchy.levels[1].n_pad
    rng = np.random.default_rng(2)
    for shape in ((ncp,), (3, ncp)):
        xc = torch.as_tensor(rng.random(shape), device=cuda)
        x = torch.as_tensor(rng.random(shape[:-1] + (lvl.n_pad,)),
                            device=cuda)
        _build.reset_launches()
        got = lvl.P.apply_correction(xc, x)
        torch.cuda.synchronize()
        key = "dia_spmm_add" if len(shape) == 2 else "dia_spmv_add"
        assert _build.launches.get(f"{key}.float64", 0) == 1
        assert _rel_err(got, x + lvl.P @ xc) <= 1e-12
    Aa, ba = advection_2d((128, 128))
    akw = dict(grid=(128, 128), max_coarse=400)
    ag = device_air_setup(Aa, device=cuda, **akw)
    ac = device_air_setup(Aa, device="cpu", **akw)
    res_g, res_c = [], []
    ag.solve(ba, tol=1e-8, maxiter=2, residuals=res_g)
    ac.solve(ba, tol=1e-8, maxiter=2, residuals=res_c)
    # after the near-exact first cycle both sit at the float32 floor
    assert res_g[0] == pytest.approx(res_c[0], rel=1e-6)
    assert res_g[1] / res_g[0] < 1e-5 and res_c[1] / res_c[0] < 1e-5


def _classical_pair(cuda, family, dtype):
    """An unstructured classical hierarchy built on the card and the same
    setup on the CPU: RS (modified) on a 40^2 P1 mesh + 1e-2 I, or AIR on
    40^2 upwind advection."""
    from pyamg_tpu_torch import (advection_2d, device_unstructured_air_setup,
                                 device_unstructured_rs_setup, gradgradform,
                                 regular_triangle_mesh)

    if family == "rs":
        A = gradgradform(*regular_triangle_mesh(40, 40))
        A = (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        setup, kw = device_unstructured_rs_setup, dict(max_coarse=100)
    else:
        A, b = advection_2d((40, 40), theta=np.pi / 4)
        setup, kw = device_unstructured_air_setup, dict(max_coarse=200)
    _build.reset_launches()
    g = setup(A, dtype=dtype, device=cuda, **kw)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    return A, np.asarray(b), g, setup(A, dtype=dtype, device="cpu", **kw), \
        counts


def _cpu_windowed(W):
    return dataclasses.replace(W, data=W.data.cpu(), idx=W.idx.cpu(),
                               starts=W.starts.cpu())


@pytest.mark.parametrize("dtype", DTYPES)
def test_unstructured_classical_kernels_match_twins(cuda, dtype):
    """At the unstructured classical setups' shapes: K7 on the one-slot
    injection Tinj (AIR) and on M and P_direct (modified RS) equal to the
    CPU twins bit for bit, K6 within TOL, K14 exactly; at K = 64, K12
    through the composed P = M P_direct and K13 through P^T (one launch a
    factor; P^T the CPU twins' bits), and the degree-2 Neumann
    restriction (two K12, one K13) against its CPU copy."""
    from pyamg_tpu_torch import ComposedWindowed

    P = _classical_pair(cuda, "rs", dtype)[2].hierarchy.levels[0].P
    R = _classical_pair(cuda, "air", dtype)[2].hierarchy.levels[0].R
    M, Pd = P.factors
    for name, W in (("M", M), ("Pd", Pd), ("Tinj", R.Tinj)):
        cpu = _cpu_windowed(W)
        m = W.m_chunks * W.w2
        x, r = _rand(m, dtype, cuda, 1), _rand(W.n_pad, dtype, cuda, 2)
        assert torch.equal(window.windowed_rmatvec(W, r).cpu(),
                           window.windowed_rmatvec_ref(cpu, r.cpu())), name
        assert _rel_err(window.windowed_matvec(W, x).cpu(),
                        window.windowed_matvec_ref(cpu, x.cpu())) \
            <= TOL[dtype], name
        sel = _rand(m, torch.float32, cuda, 3)
        assert torch.equal(window.windowed_select(W, sel).cpu(),
                           window.windowed_select_ref(cpu, sel.cpu())), name
    Pc = ComposedWindowed(factors=(_cpu_windowed(M), _cpu_windowed(Pd)))
    Rc = dataclasses.replace(R, A=_cpu_windowed(R.A),
                             Tinj=_cpu_windowed(R.Tinj),
                             dinv_f=R.dinv_f.cpu())
    X = _rand(64 * Pd.m_chunks * Pd.w2, dtype, cuda, 4).reshape(64, -1)
    Y = _rand(64 * R.A.n_pad, dtype, cuda, 5).reshape(64, -1)
    Yp = Y[:, :M.n_pad].contiguous()
    name = str(dtype).removeprefix("torch.")
    for fn, want, exact, launches in (
            (lambda: P @ X, lambda: Pc @ X.cpu(), False,
             {f"windowed_matmat_k.{name}": 2}),
            (lambda: P.rmatvec(Yp), lambda: Pc.rmatvec(Yp.cpu()), True,
             {f"windowed_rmatmat_k.{name}": 2}),
            (lambda: R @ Y, lambda: Rc @ Y.cpu(), False,
             {f"windowed_matmat_k.{name}": 2,
              f"windowed_rmatmat_k.{name}": 1})):
        _build.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        assert dict(_build.launches) == launches
        if exact:
            assert torch.equal(got.cpu(), want())
        else:
            assert _rel_err(got.cpu(), want()) <= TOL[dtype]


@pytest.mark.parametrize("family", ["rs", "air"])
def test_unstructured_classical_solve_on_card_matches_cpu(cuda, family):
    """The unstructured RS (modified) and AIR setups on the card: the
    CPU's levels in float64, every setup kernel launched (K14, K7, K12,
    K13, and K6 in RS's spectral radius), the float64 solve's history the CPU's to 1e-8 (AIR: to
    1e-7 of the first entry below it, the float32-cast coarse entries),
    and a V-cycle with no host sync."""
    A, b, g, c, counts = _classical_pair(cuda, family, torch.float64)
    assert g.setup_info == c.setup_info
    # the AIR setup estimates no spectral radius: no K6
    for k in ("windowed_select.float32", "windowed_rmatvec.float64",
              "windowed_matmat_k.float64", "windowed_rmatmat_k.float64") \
            + (("windowed_matvec.float64",) if family == "rs" else ()):
        assert counts.get(k, 0) > 0, (k, counts)
    kw = (dict(tol=1e-8, maxiter=60, accel="cg") if family == "rs"
          else dict(tol=1e-8, maxiter=30, accel="fgmres"))
    res_g, res_c = [], []
    g.solve(b, residuals=res_g, **kw)
    c.solve(b, residuals=res_c, **kw)
    assert len(res_g) == len(res_c)
    np.testing.assert_allclose(res_g, res_c, rtol=1e-8,
                               atol=1e-7 * res_c[0])
    cycle = g.cycle_operator("V")
    r = _rand(g.hierarchy.levels[0].n_pad, torch.float64, cuda, 5)
    cycle(r)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        y = cycle(r)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(y).all())


def test_block_setup_on_card_matches_cpu(cuda):
    """The block device setup of 2-D elasticity (2x2 blocks, the three
    rigid-body modes) on the card and on the CPU in float64: the same
    levels and CG history (rtol 1e-10), and the block-DIA apply and its
    transpose within 1e-12 of the CPU's."""
    from pyamg_tpu_torch import device_sa_setup_block, linear_elasticity
    from pyamg_tpu_torch.sparse import block_dia_from_scipy

    A, B = linear_elasticity((32, 32))
    kw = dict(grid=(32, 31), B=B, max_coarse=300, dtype=torch.float64)
    on_card = device_sa_setup_block(A, device=cuda, **kw)
    on_cpu = device_sa_setup_block(A, device="cpu", **kw)
    assert ([(i["n"], i["bs"], i["ndiags"])
             for i in on_card.setup_info["levels"]]
            == [(i["n"], i["bs"], i["ndiags"])
                for i in on_cpu.setup_info["levels"]])
    b = np.random.default_rng(3).random(A.shape[0])
    rg, rc = [], []
    on_card.solve(b, tol=1e-8, accel="cg", residuals=rg)
    on_cpu.solve(b, tol=1e-8, accel="cg", residuals=rc)
    assert len(rg) == len(rc)
    np.testing.assert_allclose(rg, rc, rtol=1e-10)
    T = block_dia_from_scipy(A, dtype=torch.float64, device=cuda)
    Tc = block_dia_from_scipy(A, dtype=torch.float64, device="cpu")
    x = _rand(T.n_pad, torch.float64, "cpu", 4)
    assert _rel_err((T @ x.to(cuda)).cpu(), Tc @ x) <= TOL[torch.float64]
    assert _rel_err(T.rmatvec(x.to(cuda)).cpu(),
                    Tc.rmatvec(x)) <= TOL[torch.float64]


# -- the block-DIA kernels (csrc/block_dia.cu, B1 and B2) ---------------------

BLOCK_OFFSETS = (-9, -1, 0, 2, 11)     # the outer ones reach past the matrix
BLOCK_MODES = ["plain", "resid", "zero", "zero_res", "step", "colour"]


def _block_case(bs, dtype, dev, lanes, nb=300, pad=5, misalign=False,
                seed=0):
    """A random block-banded BlockDIAMatrix of bs x bs blocks on
    BLOCK_OFFSETS (nb nodes, padded by ``pad``), x and b (K-major stacks
    for ``lanes``), Dinv and int32 colours 0..3 (-1 and zero blocks on the
    padded nodes), on ``dev``.  ``misalign``: data and Dinv start 4 bytes
    past a 16-byte boundary (the run-time block size instance's case for
    bs 2 and 4)."""
    from pyamg_tpu_torch.sparse import block_dia as bd

    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in BLOCK_OFFSETS:
        r = np.arange(max(0, -off), min(nb, nb - off))
        rows.append(r)
        cols.append(r + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    data = rng.standard_normal((len(rows), bs, bs))
    data[rows == cols] += 4 * np.eye(bs)
    S = sp.bsr_matrix((data, cols, np.searchsorted(rows, np.arange(nb + 1))),
                      shape=(nb * bs, nb * bs))
    A = bd.block_dia_from_scipy(S, dtype=dtype, device=dev,
                                n_pad=(nb + pad) * bs)
    n = A.n_pad
    shape = (n,) if lanes is None else (lanes, n)
    x = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    x[..., nb * bs:] = 0
    b[..., nb * bs:] = 0
    D = rng.standard_normal((nb + pad, bs, bs))
    D[nb:] = 0
    colors = rng.integers(0, 4, nb + pad).astype(np.int32)
    colors[nb:] = -1
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    D = t(D)
    if misalign:
        def shifted(v):
            buf = torch.empty(v.numel() + 1, dtype=dtype, device=dev)
            out = buf[1:].view(v.shape)
            out.copy_(v)
            return out
        A = dataclasses.replace(A, data=shifted(A.data))
        D = shifted(D)
        assert A.data.data_ptr() % 16 and D.data_ptr() % 16
    return A, t(x), t(b), D, torch.as_tensor(colors, device=dev)


def _block_call(mode, A, x, b, D, colors, twin=False):
    from pyamg_tpu_torch.sparse import block_dia as bd

    omega = torch.tensor(0.7, dtype=A.dtype, device=A.device)
    sfx = "_ref" if twin else ""
    if mode == "plain":
        return ((bd.block_dia_spmv_ref if twin else bd.block_dia_apply)(
            A, x),)
    if mode == "resid":
        return (getattr(bd, "block_dia_resid" + sfx)(A, x, b),)
    if mode == "zero":
        return (getattr(bd, "block_jacobi_zero" + sfx)(D, b, omega),)
    if mode == "zero_res":
        return getattr(bd, "block_jacobi_zero_res" + sfx)(A, b, D, omega)
    if mode == "step":
        return (getattr(bd, "block_jacobi_step" + sfx)(A, x, b, D, omega),)
    return (getattr(bd, "block_colour_step" + sfx)(A, x, b, D, colors, 2),)


@pytest.mark.parametrize("lanes", [None, 1, 3, 8, 16, 17])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs,misalign", [(1, False), (2, False), (3, False),
                                         (4, False), (5, False), (2, True)])
@pytest.mark.parametrize("mode", BLOCK_MODES)
def test_block_dia_kernels_match_twins(cuda, mode, bs, misalign, dtype,
                                       lanes):
    """B1 / B2 in every mode against the twin on the same card tensors (bs
    1-4 unrolled, bs 5 and a misaligned bs 2 through the run-time block
    size instance), two launches bit-identical, one launch a call for up
    to MAX_LANES lanes (two at 17), every lane of a stack equal to the
    one-vector kernel on that lane alone bit for bit (the lane tiles sum
    each lane in the one-vector order), and the twin not run on the
    card."""
    from pyamg_tpu_torch.sparse import block_dia as bd

    A, x, b, D, colors = _block_case(bs, dtype, cuda, lanes,
                                     misalign=misalign)
    want = _block_call(mode, A, x, b, D, colors, twin=True)
    kernel = "block_dia_spmv" if mode in ("plain", "resid") \
        else "block_dia_jacobi"
    key = f"{kernel}.{str(dtype).removeprefix('torch.')}"
    per_call = 1 if (lanes or 1) <= _build.MAX_LANES else 2
    calls = []
    real = bd.block_dia_spmv_ref
    bd.block_dia_spmv_ref = lambda *a: calls.append(1) or real(*a)
    try:
        before = _build.launches.get(key, 0)
        got = _block_call(mode, A, x, b, D, colors)
        again = _block_call(mode, A, x, b, D, colors)
        torch.cuda.synchronize()
        assert _build.launches.get(key, 0) - before == 2 * per_call
        ones = [] if lanes is None else [
            _block_call(mode, A, x[k].clone(), b[k].clone(), D, colors)
            for k in range(lanes)]
    finally:
        bd.block_dia_spmv_ref = real
    assert not calls
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert g.is_cuda and g.shape == x.shape and g.dtype == dtype
        assert torch.equal(g, a)
        assert _rel_err(g, w) <= TOL[dtype], mode
        assert not g[..., -5 * bs:].any()
        for k, one in enumerate(ones):
            assert torch.equal(g[k], one[i]), (mode, k)


def test_block_dia_kernel_failure_raises_without_fallback(cuda,
                                                          monkeypatch):
    """A failed build and a launch that reports a CUDA error both raise
    from the wrapper; neither runs the twin."""
    from pyamg_tpu_torch.sparse import block_dia as bd

    A, x, b, D, _ = _block_case(2, torch.float32, cuda, None)
    calls = []
    monkeypatch.setattr(bd, "block_dia_spmv_ref",
                        lambda *a: calls.append(1))
    monkeypatch.setattr(bd, "block_jacobi_step_ref",
                        lambda *a: calls.append(1))

    def no_build():
        raise RuntimeError("nvcc failed (simulated)")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(RuntimeError, match="simulated"):
        bd.block_dia_apply(A, x)

    class Refusing:
        def __getattr__(self, name):
            if name == "pyamg_error_string":
                return lambda err: b"simulated launch failure"
            return lambda *args: 98        # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(_build, "library", lambda: Refusing())
    with pytest.raises(RuntimeError, match="simulated launch failure"):
        bd.block_dia_apply(A, x)
    with pytest.raises(RuntimeError, match="simulated launch failure"):
        bd.block_jacobi_step(A, x, b, D, 0.7)
    assert not calls


def test_block_dia_wrapper_rejects_bad_operands(cuda):
    from pyamg_tpu_torch.sparse import block_dia as bd

    A, x, b, D, colors = _block_case(2, torch.float32, cuda, None)
    with pytest.raises(TypeError):
        bd.block_dia_apply(A, x.double())
    with pytest.raises(ValueError):
        bd.block_dia_apply(A, x.cpu())                 # CPU x, CUDA A
    with pytest.raises(ValueError):
        bd.block_dia_apply(A, torch.zeros(2 * A.n_pad, device=cuda)[::2])
    with pytest.raises(ValueError):
        bd.block_jacobi_step(A, x, b, D[:-1], 0.7)
    with pytest.raises(ValueError):
        bd.block_jacobi_step(A, x, b, D, torch.tensor(0.7))  # CPU omega


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs,misalign", [(2, False), (3, False), (2, True)])
def test_block_halo_mode_matches_b1_and_twin(cuda, bs, misalign, dtype):
    """B1's halo mode on the card (csrc/block_dia.cu::block_dia_halo_kernel):
    a ring of one (halos are x's own tail and head) and 4 in-process
    node-row blocks (halos copied on a side stream) equal B1 ``PLAIN`` and
    ``RESID`` on the whole operator bit for bit (the outer offsets reach
    past the matrix: their stored zero blocks meet wrapped halo values),
    and the plain twin to the kernel tolerance; one launch a ring apply,
    two a block (interior, then boundary), and the twin not run."""
    from pyamg_tpu_torch.parallel import dist_spmv
    from pyamg_tpu_torch.parallel import halo_spmv as hs
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse import block_dia as bd

    A, x, b, _, _ = _block_case(bs, dtype, cuda, None, nb=4091,
                                misalign=misalign)
    assert A.nb_pad == 4096
    plain, resid = bd.block_dia_apply(A, x), bd.block_dia_resid(A, x, b)
    one = SolverMesh(rank=0, world=1, device=cuda)
    calls = []
    real = dist_spmv.block_dia_halo_rows_ref
    hs.block_dia_halo_rows_ref = lambda *a, **k: calls.append(1) or real(
        *a, **k)
    try:
        _build.reset_launches()
        ring = hs.block_halo_spmv(A.data, A.offsets, A.offsets_t, x, A.halo,
                                  one, 1)
        ring_r = hs.block_halo_spmv(A.data, A.offsets, A.offsets_t, x,
                                    A.halo, one, 1, b=b)
        shards = hs.block_halo_spmv_shards(A, x, 4)
        shards_r = hs.block_halo_spmv_shards(A, x, 4, b=b)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
    finally:
        hs.block_dia_halo_rows_ref = real
    assert not calls
    name = str(dtype).removeprefix("torch.")
    assert counts == {f"block_dia_halo.{name}": 2 + 2 * 2 * 4}, counts
    for got in (ring, shards):
        assert torch.equal(got, plain)
    for got in (ring_r, shards_r):
        assert torch.equal(got, resid)
    A_cpu = dataclasses.replace(A, data=A.data.cpu())
    want = bd.block_dia_spmv_ref(A_cpu, x.cpu())
    assert _rel_err(ring.cpu(), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [(96, 128), (64, 16, 16)])
@pytest.mark.parametrize("K", [3, 17])
def test_k16_lane_mode_matches_k8(cuda, dtype, grid, K):
    """K16's lane mode on the card: the ring of one (halos are every
    lane's own tail and head, ldl = n_local) and P = 4 in-process shards
    (each block's columns of the stack, halos copied as (K, halo) stacks)
    equal K8 (``dia_spmm``) bit for bit, and the plain twin to the kernel
    tolerance; every lane in one launch a ring apply (17 lanes too: the
    mode has no lane cap), two a shard."""
    from pyamg_tpu_torch.parallel import halo_width
    from pyamg_tpu_torch.parallel.halo_spmv import halo_spmv, halo_spmv_shards
    from pyamg_tpu_torch.parallel.partition import SolverMesh

    A = dia_from_scipy(poisson(grid, format="csr"), dtype=dtype,
                       device=cuda, row_pad=1024)
    X = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (K, A.n_pad)), dtype=dtype, device=cuda)
    want = dia.dia_spmm(A, X)
    one = SolverMesh(rank=0, world=1, device=cuda)
    _build.reset_launches()
    ring = halo_spmv(A.data, A.offsets, A.offsets_t, X, halo_width(A), one,
                     1)
    shards = halo_spmv_shards(A, X, 4)
    torch.cuda.synchronize()
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"dia_halo_spmm.{name}": 1 + 2 * 4}
    assert torch.equal(ring, want) and torch.equal(shards, want)
    A_cpu = dataclasses.replace(A, data=A.data.cpu())
    assert _rel_err(ring.cpu(), dia.dia_spmm_ref(A_cpu, X.cpu())) \
        <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs,misalign", [(2, False), (3, False), (5, False),
                                         (2, True)])
@pytest.mark.parametrize("K", [1, 3, 8, 16, 17])
def test_block_halo_lanes_match_b1(cuda, dtype, bs, misalign, K):
    """B1's halo mode on K lanes on the card: ring of one and 4 in-process
    node-row blocks, PLAIN and RESID, equal B1 on the whole operator's
    lanes bit for bit (both kernels take node_product's lane tiles), and
    each lane of B1 the one-vector B1 on that lane; at most 16 lanes a
    launch (17 lanes: two launches a part), as B1."""
    from pyamg_tpu_torch.parallel import halo_spmv as hs
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse import block_dia as bd

    A, X, Bv, _, _ = _block_case(bs, dtype, cuda, K, nb=4091,
                                 misalign=misalign)
    plain, resid = bd.block_dia_apply(A, X), bd.block_dia_resid(A, X, Bv)
    for k in range(K):
        assert torch.equal(plain[k], bd.block_dia_apply(A, X[k].clone()))
        assert torch.equal(resid[k], bd.block_dia_resid(A, X[k].clone(),
                                                        Bv[k].clone()))
    one = SolverMesh(rank=0, world=1, device=cuda)
    _build.reset_launches()
    ring = hs.block_halo_spmv(A.data, A.offsets, A.offsets_t, X, A.halo,
                              one, 1)
    ring_r = hs.block_halo_spmv(A.data, A.offsets, A.offsets_t, X, A.halo,
                                one, 1, b=Bv)
    shards = hs.block_halo_spmv_shards(A, X, 4)
    shards_r = hs.block_halo_spmv_shards(A, X, 4, b=Bv)
    torch.cuda.synchronize()
    chunks = -(-K // 16)
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {
        f"block_dia_halo_spmm.{name}": chunks * (2 + 2 * 2 * 4)}
    assert torch.equal(ring, plain) and torch.equal(shards, plain)
    assert torch.equal(ring_r, resid) and torch.equal(shards_r, resid)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_transposes_on_card(cuda, dtype):
    """A^T of a sharded level in a world of one on the card: the DIA
    level's transposed diagonals through K16 (one launch a vector or a
    stack) against ``DIAMatrix.rmatvec``'s rolls to the kernel tolerance
    (the rolls round each product apart from its sum, K16 fuses them),
    the block level's through B1's halo mode against
    ``BlockDIAMatrix.rmatvec`` (B1 on its transposed blocks) bit for
    bit."""
    from pyamg_tpu_torch.parallel.partition import (ShardedOperator,
                                                    SolverMesh)
    from pyamg_tpu_torch.sparse import block_dia as bd

    one = SolverMesh(rank=0, world=1, device=cuda)
    A = sp.csr_matrix(poisson((96, 128), format="csr"))
    A = A + sp.diags(np.linspace(0.1, 0.9, A.shape[0] - 1), 1)
    D = dia_from_scipy(A, dtype=dtype, device=cuda, row_pad=1024)
    sh = ShardedOperator(D, one, (1, D.n_pad), (1, D.n_pad), 1)
    Ab, X, _, _, _ = _block_case(2, dtype, cuda, 3, nb=4091)
    shb = ShardedOperator(Ab, one, (1, Ab.n_pad), (1, Ab.n_pad), 1)
    name = str(dtype).removeprefix("torch.")
    for lanes in (None, 3):
        y = _rand(D.n_pad, dtype, cuda, 4) if lanes is None else \
            torch.as_tensor(np.random.default_rng(4).random(
                (lanes, D.n_pad)), dtype=dtype, device=cuda)
        sh.rmatvec(y)
        _build.reset_launches()
        got = sh.rmatvec(y)
        torch.cuda.synchronize()
        kernel = "dia_halo_spmv" if lanes is None else "dia_halo_spmm"
        assert _build.launches == {f"{kernel}.{name}": 1}
        assert _rel_err(got, D.rmatvec(y)) <= TOL[dtype]
        xb = X[0] if lanes is None else X
        assert torch.equal(shb.rmatvec(xb), bd.block_dia_apply(Ab.T, xb))


# ---------------------------------------------------------------------------
# the one-launch multicolour sweeps (S1: csrc/mcgs.cu; B3: csrc/block_dia.cu)
# ---------------------------------------------------------------------------

SWEEP_THREADS = {"cta": 1024, "grid": 128}


def _forced(plan, route, staged):
    return dataclasses.replace(plan, route=route,
                               threads=SWEEP_THREADS[route], staged=staged)


def _scalar_sweep_case(which, dtype, dev):
    """(DIA, dinv, colours, ncolours, plan) of a symmetric operator
    (Poisson 64^2, JP colouring: in place) or upwind advection 64^2 (its
    one-sided pattern's JP colouring couples a colour: staged)."""
    from pyamg_tpu_torch import advection_2d
    from pyamg_tpu_torch.graph import vertex_coloring

    A = (poisson((64, 64), format="csr") if which == "poisson"
         else advection_2d((64, 64))[0].tocsr())
    D = dia_from_scipy(A, dtype=dtype, device=dev, row_pad=1024)
    c = vertex_coloring(A, method="JP")
    colors = np.full(D.n_pad, -1, dtype=np.int32)
    colors[: len(c)] = c
    dinv = torch.zeros(D.n_pad, dtype=dtype, device=dev)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / A.diagonal(), dtype=dtype)
    colors = torch.as_tensor(colors, device=dev)
    ncolors = int(c.max()) + 1
    return D, dinv, colors, ncolors, dia.mcgs_plan(D, colors, ncolors)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["cta", "grid"])
# in place only where no stored nonzero couples a colour (Poisson)
@pytest.mark.parametrize("which,staged", [("poisson", False),
                                          ("poisson", True),
                                          ("advection", True)])
def test_mcgs_sweep_matches_k2_chain(cuda, which, staged, route, dtype):
    """S1 in both barrier routes, in place and staged (in place only where
    the plan allows it), symmetric with 2 iterations: bit for bit the
    chain of K2 colour steps with each colour's inverse diagonal (the
    parent's path), within tolerance of its twin, one launch a call, two
    launches bit-identical, the caller's x unchanged, the twin not run."""
    from pyamg_tpu_torch.engine import relaxation as rel

    D, dinv, colors, ncolors, plan = _scalar_sweep_case(which, dtype, cuda)
    assert plan.staged == (which == "advection")
    p = _forced(plan, route, staged)
    order = rel._sweeps(ncolors, "symmetric") * 2
    x, b = (_rand(D.n_pad, dtype, cuda, s) for s in (3, 4))
    x0 = x.clone()
    stack = rel.multicolor_gs(dinv, colors, ncolors).color_dinv
    want = x
    for c in order:
        want = dia.dia_jacobi(D, want, b, stack[c], 1.0)
    name = f"dia_mcgs_sweep.{str(dtype).removeprefix('torch.')}"
    calls = []
    real = dia.dia_mcgs_sweep_ref
    dia.dia_mcgs_sweep_ref = lambda *a: calls.append(1) or real(*a)
    try:
        _build.reset_launches()
        got = dia.dia_mcgs_sweep(D, x, b, dinv, p, order)
        again = dia.dia_mcgs_sweep(D, x, b, dinv, p, order)
        torch.cuda.synchronize()
        assert _build.launches == {name: 2}
    finally:
        dia.dia_mcgs_sweep_ref = real
    assert not calls
    assert torch.equal(got, want) and torch.equal(again, got)
    assert torch.equal(x, x0)
    twin = dia.dia_mcgs_sweep_ref(D, x, b, dinv, plan, order)
    assert _rel_err(got, twin) <= TOL[dtype]


def test_mcgs_sweep_long_order_and_smoother(cuda):
    """An order longer than a launch's 256 phases takes two launches with
    the chain's bits; the smoother's own call on one vector is one sweep
    launch (its plan kept), on lanes K9 colour steps."""
    from pyamg_tpu_torch.engine import relaxation as rel

    D, dinv, colors, ncolors, plan = _scalar_sweep_case(
        "poisson", torch.float32, cuda)
    order = rel._sweeps(ncolors, "symmetric") * 40
    assert len(order) > 256
    x, b = (_rand(D.n_pad, torch.float32, cuda, s) for s in (5, 6))
    stack = rel.multicolor_gs(dinv, colors, ncolors).color_dinv
    want = x
    for c in order:
        want = dia.dia_jacobi(D, want, b, stack[c], 1.0)
    _build.reset_launches()
    got = dia.dia_mcgs_sweep(D, x, b, dinv, plan, order)
    assert _build.launches == {"dia_mcgs_sweep.float32": 2}
    assert torch.equal(got, want)
    sm = rel.multicolor_gs(dinv, colors, ncolors, sweep="symmetric",
                           iterations=40)
    _build.reset_launches()
    assert torch.equal(sm(D, x, b), want)
    assert sm.plan(D) is sm.plan(D)
    assert _build.launches == {"dia_mcgs_sweep.float32": 2}
    _build.reset_launches()
    sm1 = rel.multicolor_gs(dinv, colors, ncolors, sweep="symmetric")
    X = torch.stack([x, b])
    sm1(D, X, X)
    assert _build.launches == {"dia_jacobi_k.float32": 2 * ncolors}


def _block_sweep_case(dtype, dev, bs=2, misalign=False):
    """A block level with a valid colouring (elasticity 24^2, 2x2 blocks,
    the JP node colouring, Dinv its inverse diagonal blocks: in place),
    or for bs != 2 or a misaligned bs 2 the random banded case of
    ``_block_case`` with its random colours 0..3 (staged)."""
    from pyamg_tpu_torch import linear_elasticity
    from pyamg_tpu_torch.engine.hierarchy import (_block_colors_for,
                                                  _device_block_dinv)
    from pyamg_tpu_torch.sparse import block_dia as bd

    if bs == 2 and not misalign:
        A4, _ = linear_elasticity((24, 24))
        A = bd.block_dia_from_scipy(A4.tobsr(blocksize=(2, 2)), dtype=dtype,
                                    device=dev)
        D = _device_block_dinv(A4, 2, A.nb_pad, dtype, dev)
        colors, ncolors = _block_colors_for(A4, 2, A.nb_pad, dev)
        x, b = (_rand(A.n_pad, dtype, dev, s) for s in (7, 8))
    else:
        A, x, b, D, colors = _block_case(bs, dtype, dev, None,
                                         misalign=misalign)
        ncolors = 4
    return A, x, b, D, colors, ncolors, bd.block_mcgs_plan(A, colors,
                                                             ncolors)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["cta", "grid"])
# in place only on the elasticity level (bs 2, aligned): the others'
# random colours couple a colour
@pytest.mark.parametrize("bs,misalign,staged", [
    (2, False, False), (2, False, True), (1, False, True), (3, False, True),
    (4, False, True), (5, False, True), (2, True, True)])
def test_block_mcgs_sweep_matches_colour_chain(cuda, bs, misalign, staged,
                                               route, dtype):
    """B3 in both barrier routes, in place and staged (in place only where
    the plan allows it), symmetric with 2 iterations, bs 1-4 unrolled, bs
    5 and a misaligned bs 2 through the run-time block size: bit for bit
    the chain of B2 COLOUR steps (the parent's path), within tolerance of
    its twin, one launch a call, the caller's x unchanged, the twin not
    run."""
    from pyamg_tpu_torch.engine import relaxation as rel
    from pyamg_tpu_torch.sparse import block_dia as bd

    A, x, b, D, colors, ncolors, plan = _block_sweep_case(dtype, cuda, bs,
                                                          misalign)
    assert plan.staged == (bs != 2 or misalign)
    p = _forced(plan, route, staged)
    order = rel._sweeps(ncolors, "symmetric") * 2
    x0 = x.clone()
    want = x
    for c in order:
        want = bd.block_colour_step(A, want, b, D, colors, c)
    name = f"block_mcgs_sweep.{str(dtype).removeprefix('torch.')}"
    calls = []
    real = bd.block_mcgs_sweep_ref
    bd.block_mcgs_sweep_ref = lambda *a: calls.append(1) or real(*a)
    try:
        _build.reset_launches()
        got = bd.block_mcgs_sweep(A, x, b, D, p, order)
        again = bd.block_mcgs_sweep(A, x, b, D, p, order)
        torch.cuda.synchronize()
        assert _build.launches == {name: 2}
    finally:
        bd.block_mcgs_sweep_ref = real
    assert not calls
    assert torch.equal(got, want) and torch.equal(again, got)
    assert torch.equal(x, x0)
    twin = bd.block_mcgs_sweep_ref(A, x, b, D, plan, order)
    assert _rel_err(got, twin) <= TOL[dtype]


def test_mcgs_sweep_failures_raise_without_fallback(cuda):
    """A launch the kernel refuses (a CTA of 2000 threads) and a colour
    outside the plan raise from the scalar wrapper with neither its twin
    nor the K2 chain run; the refused launch raises from the block
    wrapper too."""
    from pyamg_tpu_torch.engine import relaxation as rel
    from pyamg_tpu_torch.sparse import block_dia as bd

    D, dinv, colors, ncolors, plan = _scalar_sweep_case(
        "poisson", torch.float32, cuda)
    order = rel._sweeps(ncolors, "forward")
    x, b = (_rand(D.n_pad, torch.float32, cuda, s) for s in (1, 2))
    calls = []
    real, real_k2 = dia.dia_mcgs_sweep_ref, dia.dia_jacobi
    dia.dia_mcgs_sweep_ref = lambda *a: calls.append(1)
    dia.dia_jacobi = lambda *a: calls.append(1)
    try:
        with pytest.raises(RuntimeError, match="pyamg_mcgs_sweep_f32"):
            dia.dia_mcgs_sweep(D, x, b, dinv,
                               dataclasses.replace(plan, threads=2000),
                               order)
        with pytest.raises(ValueError):
            dia.dia_mcgs_sweep(D, x, b, dinv, plan, [ncolors])
    finally:
        dia.dia_mcgs_sweep_ref, dia.dia_jacobi = real, real_k2
    assert not calls
    A, xb, bb, Db, cb, nc, bplan = _block_sweep_case(torch.float32, cuda)
    with pytest.raises(RuntimeError, match="pyamg_block_mcgs_sweep_f32"):
        bd.block_mcgs_sweep(A, xb, bb, Db,
                            dataclasses.replace(bplan, threads=2000),
                            rel._sweeps(nc, "forward"))
