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

# f32: FMA contraction (and, for the transposes' twins on the card,
# index_add_'s atomics order); f64 likewise
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
    stacks; K=19 takes two launches (16 lanes, then 3) per call; omega by
    value and as a 0-d device tensor."""
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
    per_call = -(-K // 16)
    assert _build.launches == {f"dia_spmm.{name}": per_call,
                               f"dia_spmm_scaled.{name}": per_call,
                               f"dia_spmm_add.{name}": per_call,
                               f"dia_jacobi_k.{name}": 2 * per_call,
                               f"dia_zero_chain_k.{name}": 2 * per_call}


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
    device tensor; K=19 takes two launches per call."""
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
    assert _build.launches == {f"dia_jacobi_zero_res_k.{name}":
                               2 * -(-K // 16)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [3, 8, 19])
def test_k12_k13_windowed_lane_kernels_match_twins(cuda, dtype, K):
    """K12 and K13 against their twins (the gather and scatter-add forms
    lane by lane)."""
    P = _random_rect(8192, 2600, per_row=4, spread=60, seed=4)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda)
    rng = np.random.default_rng(K)
    X = torch.as_tensor(rng.random((K, W.m_chunks * W.w2)), dtype=dtype,
                        device=cuda)
    R = torch.as_tensor(rng.random((K, W.n_pad)), dtype=dtype, device=cuda)
    _build.reset_launches()
    Y = window.windowed_matmat_k(W, X)
    Z = window.windowed_rmatmat_k(W, R)
    assert Y.shape == (K, W.n_pad) and Z.shape == (K, W.m_chunks * W.w2)
    assert _rel_err(Y, window.windowed_matmat_k_ref(W, X)) <= TOL[dtype]
    assert _rel_err(Z, window.windowed_rmatmat_k_ref(W, R)) <= TOL[dtype]
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"windowed_matmat_k.{name}": -(-K // 16),
                               f"windowed_rmatmat_k.{name}": -(-K // 16)}


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
def test_k16_ring_of_one_and_shards_match_k1(cuda, dtype):
    """K16 on the card: the ring of one (halos are x's own tail and head)
    and P = 4 in-process shards (halos copied on a side stream) equal K1
    bit for bit; two launches per ring apply, eight for the shards."""
    from pyamg_tpu_torch.parallel import halo_width
    from pyamg_tpu_torch.parallel.halo_spmv import halo_spmv, halo_spmv_shards
    from pyamg_tpu_torch.parallel.partition import SolverMesh

    A = dia_from_scipy(poisson((96, 128), format="csr"), dtype=dtype,
                       device=cuda, row_pad=1024)
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
    assert _build.launches == {f"dia_halo_spmv.{name}": 2 + 2 * 4}


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
