"""Batched (n, K) solves on the device-built hierarchy, and the K-lane
kernels' plain twins, against the JAX package on the CPU.

Each K-lane twin (K8 ``dia_spmm`` in its three modes, K9 ``dia_jacobi_k``,
K11 ``dia_zero_chain_k``) is held against the JAX package's Pallas kernel
in interpret mode at the sizes and blocks of the reference's own tests
(tests/test_pallas_kernels.py), as max-norm relative error: f32 <= 1e-5,
f64 <= 1e-12.  The port's batched solve on the 64^2 device-built float64
hierarchy (the JAX hierarchy's arrays, carried across) is held against
the JAX ``StructuredDeviceSolver.solve(B)``, whose whole solve is vmapped
over the lanes: identical iteration counts lane for lane, histories to
rtol 1e-8.  The JAX batched solves are computed once per module.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pyamg_tpu.engine import device_sa_setup as jax_device_sa_setup  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402
from pyamg_tpu.sparse import pad_vector as jax_pad_vector  # noqa: E402
from pyamg_tpu.sparse.dia import (_dia_pallas_matmat,  # noqa: E402
                                  _dia_pallas_matmat_k,
                                  dia_pallas_jacobi_km,
                                  dia_pallas_zero_chain_km)
from pyamg_tpu.sparse.dia import dia_from_scipy as jax_dia_from_scipy  # noqa: E402

import pyamg_tpu_torch as pt  # noqa: E402
from pyamg_tpu_torch import _build, structured_solver_from_jax  # noqa: E402
from pyamg_tpu_torch.engine.device_setup import (_block_sum,  # noqa: E402
                                                 _broadcast_coarse,
                                                 _grid_pad_vec,
                                                 _grid_unpad_vec)
from pyamg_tpu_torch.engine.solver import _fused_zero_entry_chain  # noqa: E402
from pyamg_tpu_torch.sparse import (DIAMatrix, dia_from_scipy,  # noqa: E402
                                    dia_jacobi_k, dia_jacobi_res_k,
                                    dia_spmm, dia_spmm_add, dia_spmm_scaled,
                                    dia_spmv, dia_zero_chain_k)
from pyamg_tpu_torch.sparse.dia import dia_jacobi_res  # noqa: E402

CPU = "cpu"
TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
TORCH = {np.float32: torch.float32, np.float64: torch.float64}
GRID = (64, 64)
SOLVES = [(None, "native"), (None, "mixed"), ("cg", "native"),
          ("cg", "mixed")]
# accel=None stops at 12 cycles: the stationary residual rises 16x in
# the first cycle, so f64 rounding grows past 1e-8 over longer runs
SOLVE_KW = {None: dict(tol=1e-8, maxiter=12), "cg": dict(tol=1e-10,
                                                         maxiter=40)}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(A, row_pad, dtype):
    return (jax_dia_from_scipy(A, dtype=jnp.dtype(dtype), row_pad=row_pad),
            dia_from_scipy(A, dtype=TORCH[dtype], device=CPU,
                           row_pad=row_pad))


def _dinv(jd):
    return jnp.where(jd.diagonal() != 0, 1.0 / jd.diagonal(), 0.0)


# ---------------------------------------------------------------------------
# the twins against the interpret-mode TPU kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("K", [2, 8])
def test_dia_spmm_k8_matches_pallas_interpret(K, dtype):
    """K8 plain on the reference test's 512^2 operator, B=8192 (chunked
    halos clamped at both array ends)."""
    A = poisson((512, 512), format="csr")
    jd, td = _pair(A, 8, dtype)
    X = np.random.default_rng(0).random((td.n_pad, K)).astype(dtype)
    want = np.asarray(_dia_pallas_matmat(jd.data, jd.offsets, jnp.asarray(X),
                                         8192, interpret=True))
    got = dia_spmm(td, torch.as_tensor(np.ascontiguousarray(X.T)))
    assert got.shape == (K, td.n_pad)
    assert _rel(got.numpy().T, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["scale", "addk"])
def test_dia_spmm_epilogues_k8_match_pallas_interpret(mode, dtype):
    """K8's scale (shared (n,) factor) and add (per-lane stack) epilogues
    against _dia_pallas_matmat_k(scale=/addk=, B=1024) on the reference
    test's 64^2 operator, K=4."""
    A = poisson((64, 64), format="csr")
    jd, td = _pair(A, 1024, dtype)
    rng = np.random.default_rng(13)
    K = 4
    Xk = rng.random((K, td.n_pad)).astype(dtype)
    s = rng.random(td.n_pad).astype(dtype)
    Zk = rng.random((K, td.n_pad)).astype(dtype)
    extra = {"scale": jnp.asarray(s)} if mode == "scale" else {
        "addk": jnp.asarray(Zk)}
    want = np.asarray(_dia_pallas_matmat_k(jd.data, jd.offsets,
                                           jnp.asarray(Xk), 1024,
                                           interpret=True, **extra))
    if mode == "scale":
        got = dia_spmm_scaled(td, torch.as_tensor(Xk), torch.as_tensor(s))
    else:
        got = dia_spmm_add(td, torch.as_tensor(Xk), torch.as_tensor(Zk))
    assert _rel(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_dia_jacobi_k9_matches_pallas_interpret(dtype):
    """K9 against dia_pallas_jacobi_km on the reference test's 512^2
    operator, K=4, force_B=8192; a 0-d omega tensor gives the same."""
    A = poisson((512, 512), format="csr")
    jd, td = _pair(A, 8, dtype)
    rng = np.random.default_rng(2)
    K = 4
    Xk = rng.random((K, td.n_pad)).astype(dtype)
    Bk = rng.random((K, td.n_pad)).astype(dtype)
    dinv = _dinv(jd)
    want = np.asarray(dia_pallas_jacobi_km(jd, jnp.asarray(Xk),
                                           jnp.asarray(Bk), dinv, 0.8,
                                           interpret=True, force_B=8192))
    dt = torch.as_tensor(np.array(dinv))
    for omega in (0.8, torch.tensor(0.8, dtype=TORCH[dtype])):
        got = dia_jacobi_k(td, torch.as_tensor(Xk), torch.as_tensor(Bk), dt,
                           omega)
        assert _rel(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_dia_zero_chain_k11_matches_pallas_interpret(dtype):
    """K11 against dia_pallas_zero_chain_km on the reference test's 128^2,
    row_pad=4096, force_B=4096 setup with St = 0.1 A + 0.9 I, K=4."""
    A = poisson((128, 128), format="csr")
    jd, td = _pair(A, 4096, dtype)
    St = (0.1 * A + 0.9 * sp.eye(A.shape[0], format="csr")).tocsr()
    jst, tst = _pair(St, 4096, dtype)
    rng = np.random.default_rng(29)
    K = 4
    Bk = rng.random((K, td.n_pad)).astype(dtype)
    tvh = rng.random(A.shape[0]).astype(dtype)
    tv = jax_pad_vector(jnp.asarray(tvh), jd.n_pad)
    dinv = _dinv(jd)
    x_want, y_want = dia_pallas_zero_chain_km(jd, jst, jnp.asarray(Bk), dinv,
                                              tv, 0.85, interpret=True,
                                              force_B=4096)
    x_got, y_got = dia_zero_chain_k(td, tst, torch.as_tensor(Bk),
                                    torch.as_tensor(np.array(dinv)),
                                    torch.as_tensor(np.array(tv)), 0.85)
    assert _rel(x_got.numpy(), x_want) <= TOL[dtype]
    assert _rel(y_got.numpy(), y_want) <= TOL[dtype]


def test_k_lane_twins_are_the_single_lane_ones_lane_by_lane():
    """Every K-lane twin equals its single-lane counterpart lane by lane,
    exactly (the same operations in the same order), and the batched
    Jacobi-plus-residual is K9 then the residual through K8."""
    A = poisson((40, 40), format="csr")
    td = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=1024)
    St = dia_from_scipy((0.1 * A + 0.9 * sp.eye(A.shape[0])).tocsr(),
                        dtype=torch.float64, device=CPU, row_pad=1024)
    rng = np.random.default_rng(3)
    Xk, Bk = (torch.as_tensor(rng.random((3, td.n_pad))) for _ in range(2))
    s, dinv = (torch.as_tensor(rng.random(td.n_pad)) for _ in range(2))
    Y = dia_spmm(td, Xk)
    Ys = dia_spmm_scaled(td, Xk, s)
    Ya = dia_spmm_add(td, Xk, Bk)
    Yj = dia_jacobi_k(td, Xk, Bk, dinv, 0.7)
    Yr, Rr = dia_jacobi_res_k(td, Xk, Bk, dinv, 0.7)
    Xc, Yc = dia_zero_chain_k(td, St, Bk, dinv, s, 0.7)
    for k in range(3):
        x, b = Xk[k], Bk[k]
        assert torch.equal(Y[k], dia_spmv(td, x))
        assert torch.equal(Ys[k], dia_spmv(td, x) * s)
        assert torch.equal(Ya[k], b + dia_spmv(td, x))
        yr, rr = dia_jacobi_res(td, x, b, dinv, 0.7)
        assert torch.equal(Yj[k], yr) and torch.equal(Yr[k], yr)
        assert torch.equal(Rr[k], rr)
        xc = 0.7 * (dinv * b)
        assert torch.equal(Xc[k], xc)
        assert torch.equal(Yc[k], s * dia_spmv(St, b - dia_spmv(td, xc)))
    assert torch.equal(td @ Xk, Y)
    torch.testing.assert_close(td.rmatvec(Xk)[1], td.rmatvec(Xk[1]),
                               rtol=0, atol=0)


def test_k_lane_wrappers_run_the_twin_only_on_cpu():
    """CPU stacks run the twins and count no launch; a stack on another
    device never falls back to a twin."""
    A = poisson((40, 40), format="csr")
    td = dia_from_scipy(A, device=CPU, row_pad=1024)
    X = torch.ones(2, td.n_pad)
    _build.reset_launches()
    dia_spmm(td, X)
    dia_jacobi_k(td, X, X, X[0], 0.5)
    dia_zero_chain_k(td, td, X, X[0], X[0], 0.5)
    assert _build.launches == {}
    with pytest.raises(ValueError, match="different devices"):
        dia_spmm(td, X.to("meta"))
    meta = DIAMatrix(data=td.data.to("meta"), offsets=td.offsets,
                     shape=td.shape, nnz=td.nnz)
    with pytest.raises(ValueError, match="unsupported device"):
        dia_spmm(meta, X.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        dia_zero_chain_k(meta, meta, X.to("meta"), X[0].to("meta"),
                         X[0].to("meta"), 0.5)


def test_grid_transforms_take_a_lane_axis():
    """The pad, unpad, block sum and spread act on each lane of a stack
    as on a vector, and block sum stays the spread's exact transpose."""
    rng = np.random.default_rng(4)
    grid, grid_p, cg = (7, 8), (9, 9), (3, 3)
    V = torch.as_tensor(rng.random((3, 56)))
    P = _grid_pad_vec(V, grid, grid_p)
    assert P.shape == (3, 81)
    for k in range(3):
        assert torch.equal(P[k], _grid_pad_vec(V[k], grid, grid_p))
    assert torch.equal(_grid_unpad_vec(P, grid, grid_p), V)
    F = torch.as_tensor(rng.random((3, 81)))
    C = torch.as_tensor(rng.random((3, 9)))
    S = _block_sum(F, cg, 3)
    E = _broadcast_coarse(C, cg, 3, 1)
    for k in range(3):
        assert torch.equal(S[k], _block_sum(F[k], cg, 3))
        assert torch.equal(E[k], _broadcast_coarse(C[k], cg, 3, 1))
    # <block_sum(f), c> == <f, spread(c)> lane by lane
    torch.testing.assert_close((S * C).sum(1), (F * E).sum(1), rtol=1e-14,
                               atol=0)


# ---------------------------------------------------------------------------
# batched solves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_setup():
    A = poisson(GRID, format="csr")
    J = jax_device_sa_setup(A, grid=GRID, dtype=jnp.float64, max_coarse=100,
                            mixed_precision=True)
    return A, J


@pytest.fixture(scope="module")
def B3(jax_setup):
    """Three lanes: a random one, a zero one (frozen from the start) and
    one scaled by 1e6."""
    rng = np.random.default_rng(5)
    n = jax_setup[0].shape[0]
    B = np.zeros((n, 3))
    B[:, 0] = rng.random(n)
    B[:, 2] = 1e6 * rng.random(n)
    return B


@pytest.fixture(scope="module")
def jax_solves(jax_setup, B3):
    """The JAX batched solve for each (accel, precision): (x, per-lane
    histories)."""
    _, J = jax_setup
    out = {}
    for accel, prec in SOLVES:
        res = []
        x = J.solve(B3, accel=accel, precision=prec, residuals=res,
                    **SOLVE_KW[accel])
        out[accel, prec] = (np.asarray(x), [np.asarray(r) for r in res])
    return out


@pytest.fixture(scope="module")
def port(jax_setup):
    return structured_solver_from_jax(jax_setup[1], CPU)


@pytest.mark.parametrize("accel,prec", SOLVES)
def test_batched_solve_matches_reference(port, B3, jax_solves, accel, prec):
    """Per-lane iteration counts identical, histories to rtol 1e-8, x to
    rtol 1e-8; x has shape (n, K) and the info is 0 only when every lane
    converged."""
    x_want, res_want = jax_solves[accel, prec]
    res = []
    x, info = port.solve(B3, accel=accel, precision=prec, residuals=res,
                         return_info=True, **SOLVE_KW[accel])
    assert x.shape == B3.shape and len(res) == 3
    assert [len(r) for r in res] == [len(r) for r in res_want]
    for got, want in zip(res, res_want):
        np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(x, x_want, rtol=1e-8, atol=1e-8 * np.abs(
        x_want).max())
    assert len(res[1]) == 1 and res[1][0] == 0.0 and not x[:, 1].any()
    if accel == "cg":
        assert info == 0
    else:
        assert info == SOLVE_KW[None]["maxiter"]


@pytest.mark.parametrize("accel", [None, "cg"])
def test_lane_equals_the_single_solve(port, B3, accel):
    """Lane j of the batched solve is the 1-D solve of column j: the same
    count, the history to rtol 1e-10."""
    res = []
    X = port.solve(B3, accel=accel, residuals=res, **SOLVE_KW[accel])
    for j in range(3):
        r1 = []
        x1 = port.solve(B3[:, j], accel=accel, residuals=r1,
                        **SOLVE_KW[accel])
        assert len(res[j]) == len(r1)
        np.testing.assert_allclose(res[j], r1, rtol=1e-10)
        np.testing.assert_allclose(X[:, j], x1, rtol=1e-9,
                                   atol=1e-12 * max(np.abs(x1).max(), 1.0))


def test_lanes_freeze_at_their_own_convergence(port):
    """Lanes that converge at different counts: each stops at its own
    count and keeps its iterate, as its 1-D solve does."""
    A = poisson(GRID, format="csr")
    n = A.shape[0]
    B = np.stack([np.random.default_rng(6).random(n),
                  A @ np.ones(n), np.ones(n)], axis=1)
    res = []
    X = port.solve(B, tol=1e-10, maxiter=40, accel="cg", residuals=res)
    counts = [len(r) - 1 for r in res]
    assert len(set(counts)) > 1, counts
    for j in range(3):
        r1 = []
        x1 = port.solve(B[:, j], tol=1e-10, maxiter=40, accel="cg",
                        residuals=r1)
        assert len(r1) - 1 == counts[j]
        np.testing.assert_allclose(X[:, j], x1, rtol=1e-9, atol=1e-12)
        assert np.linalg.norm(B[:, j] - A @ X[:, j]) <= 1e-10 * max(
            np.linalg.norm(B[:, j]), 1e-300)


def test_batched_tensor_in_tensor_out(port, B3):
    X = port.solve(torch.as_tensor(B3), tol=1e-8, accel="cg")
    assert isinstance(X, torch.Tensor) and X.shape == B3.shape
    np.testing.assert_array_equal(X.numpy(),
                                  port.solve(B3, tol=1e-8, accel="cg"))


def test_batched_float32_cycle_goes_through_the_lane_kernels():
    """The port's own float32 device-built hierarchy: the batched cycle's
    zero-entry front-end is K11's entry, and the mixed solve converges
    every lane to 1e-8 against the true operator."""
    A = poisson(GRID, format="csr")
    dsa = pt.device_sa_setup(A, grid=GRID, dtype=torch.float32, device=CPU,
                             max_coarse=100, mixed_precision=True)
    h = dsa.hierarchy
    Bk = torch.as_tensor(np.random.default_rng(7).random(
        (4, h.levels[0].n_pad)), dtype=torch.float32)
    out = _fused_zero_entry_chain(h.levels[0], Bk)
    assert out is not None and out[0].shape == Bk.shape
    B = np.random.default_rng(8).random((A.shape[0], 4))
    X, info = dsa.solve(B, tol=1e-8, accel="cg", precision="mixed",
                        return_info=True)
    assert info == 0
    for j in range(4):
        assert np.linalg.norm(B[:, j] - A @ X[:, j]) < 1e-8 * np.linalg.norm(
            B[:, j])


def test_batched_on_a_host_built_solver_runs():
    """A 2-D b on a host-built hierarchy solves lane by lane (K10, K12 and
    K13 on the card; tests/test_torch_host_batched.py holds it against
    the reference): every lane converges against the true operator."""
    A = pt.poisson((32, 32), format="csr")
    ml = pt.smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    dml = pt.as_device_solver(ml, dtype=torch.float64, device=CPU)
    B = np.random.default_rng(9).random((A.shape[0], 2))
    X, info = dml.solve(B, tol=1e-10, accel="cg", return_info=True)
    assert X.shape == B.shape and info == 0
    for j in range(2):
        assert np.linalg.norm(B[:, j] - A @ X[:, j]) < 1e-10 * np.linalg.norm(
            B[:, j])
