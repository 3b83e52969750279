"""Batched (n, K) solves on the host-built hierarchy, and the K-lane
kernels of that path (K10, K12, K13), against the JAX package on the CPU.

Each twin is held against the JAX package's Pallas kernel in interpret
mode at the sizes of the reference's own tests
(tests/test_pallas_kernels.py), as max-norm relative error: f32 <= 1e-5,
f64 <= 1e-12.  The operators of the host-built cycle (DIA, dense,
windowed, transposed windowed, composed) apply to K-major (K, n) stacks
lane by lane.  The port's batched solve on the 64^2 host-built float64
hierarchy (the JAX hierarchy's arrays, carried across) is held against
the JAX ``DeviceMultilevelSolver.solve(B)``, whose whole solve is vmapped
over the lanes: identical iteration counts lane for lane, histories to
rtol 1e-8.  The JAX hierarchy and its solves are computed once per module.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pyamg_tpu  # noqa: E402
from pyamg_tpu.engine import DeviceMultilevelSolver as JaxSolver  # noqa: E402
from pyamg_tpu.engine import compile_hierarchy as jax_compile_hierarchy  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402
from pyamg_tpu.sparse.dia import dia_from_scipy as jax_dia_from_scipy  # noqa: E402
from pyamg_tpu.sparse.dia import dia_pallas_jacobi_zero_res_km  # noqa: E402
from pyamg_tpu.sparse.window import windowed_from_scipy as jax_windowed  # noqa: E402

import pyamg_tpu_torch as pt  # noqa: E402
from pyamg_tpu_torch import _build, hierarchy_from_jax  # noqa: E402
from pyamg_tpu_torch.sparse import (ComposedOperator, DenseOperator,  # noqa: E402
                                    DIAMatrix, TransposedWindowed,
                                    WindowedELL, dense_from_scipy,
                                    dia_from_scipy, dia_jacobi_zero_res,
                                    dia_jacobi_zero_res_k, windowed_from_scipy,
                                    windowed_matmat_k, windowed_rmatmat_k)
from pyamg_tpu_torch.sparse.dia import dia_spmv  # noqa: E402

CPU = "cpu"
TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
TORCH = {np.float32: torch.float32, np.float64: torch.float64}
CONFIG1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
               postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
SOLVES = [(None, "native"), (None, "mixed"), ("cg", "native"),
          ("cg", "mixed")]
# accel=None stops at 12 cycles, as tests/test_torch_batched.py does
SOLVE_KW = {None: dict(tol=1e-8, maxiter=12), "cg": dict(tol=1e-10,
                                                         maxiter=40)}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_rect(n, m, per_row, spread, seed):
    """The reference test's banded random rectangular operator
    (tests/test_pallas_kernels.py)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip((rows * m) // n + rng.integers(-spread, spread + 1,
                                                  len(rows)), 0, m - 1)
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(n, m))


def _windowed_pair(P, dtype):
    jw = jax_windowed(P, dtype=jnp.dtype(dtype), block=256)
    tw = windowed_from_scipy(P, dtype=TORCH[dtype], device=CPU, block=256)
    assert (tw.block, tw.w2, tw.m_chunks) == (jw.block, jw.w2, jw.m_chunks)
    np.testing.assert_array_equal(tw.idx.numpy(), np.asarray(jw.idx))
    return jw, tw


# ---------------------------------------------------------------------------
# the twins against the interpret-mode TPU kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_dia_jacobi_zero_res_k10_matches_pallas_interpret(dtype):
    """K10 against dia_pallas_jacobi_zero_res_km on the reference test's
    64^2 operator, K=4, force_B=1024; a 0-d omega tensor gives the same."""
    A = poisson((64, 64), format="csr")
    jd = jax_dia_from_scipy(A, dtype=jnp.dtype(dtype), row_pad=1024)
    td = dia_from_scipy(A, dtype=TORCH[dtype], device=CPU, row_pad=1024)
    Bk = np.random.default_rng(17).random((4, td.n_pad)).astype(dtype)
    dinv = jnp.where(jd.diagonal() != 0, 1.0 / jd.diagonal(), 0.0)
    x_want, r_want = dia_pallas_jacobi_zero_res_km(
        jd, jnp.asarray(Bk), dinv, 0.85, interpret=True, force_B=1024)
    dt = torch.as_tensor(np.array(dinv))
    for omega in (0.85, torch.tensor(0.85, dtype=TORCH[dtype])):
        x_got, r_got = dia_jacobi_zero_res_k(td, torch.as_tensor(Bk), dt,
                                             omega)
        assert x_got.shape == r_got.shape == Bk.shape
        assert _rel(x_got.numpy(), x_want) <= TOL[dtype]
        assert _rel(r_got.numpy(), r_want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("K", [2, 8])
def test_windowed_matmat_k12_matches_pallas_interpret(K, dtype):
    """K12 against WindowedELL._matmat_pallas_k on the reference test's
    4096 x 1500 operator, block=256."""
    P = _random_rect(4096, 1500, per_row=3, spread=40, seed=7)
    jw, tw = _windowed_pair(P, dtype)
    Xk = np.random.default_rng(8).random((K, tw.m_chunks * tw.w2)).astype(
        dtype)
    want = np.asarray(jw._matmat_pallas_k(jnp.asarray(Xk), interpret=True))
    got = windowed_matmat_k(tw, torch.as_tensor(Xk))
    assert got.shape == (K, tw.n_pad)
    assert _rel(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("K", [2, 8])
def test_windowed_rmatmat_k13_matches_pallas_interpret(K, dtype):
    """K13 against WindowedELL._rmatmat_pallas_k (the K transposed outputs
    accumulated across overlapping windows) on the reference test's
    operator, block=256."""
    P = _random_rect(4096, 1500, per_row=3, spread=40, seed=11)
    jw, tw = _windowed_pair(P, dtype)
    Rk = np.random.default_rng(12).random((K, tw.n_pad)).astype(dtype)
    want = np.asarray(jw._rmatmat_pallas_k(jnp.asarray(Rk), interpret=True))
    got = windowed_rmatmat_k(tw, torch.as_tensor(Rk))
    assert got.shape == (K, tw.m_chunks * tw.w2)
    assert _rel(got.numpy(), want) <= TOL[dtype]


# ---------------------------------------------------------------------------
# the operators of the host-built cycle on lane stacks
# ---------------------------------------------------------------------------

def _lane_by_lane(op, X):
    return torch.stack([op @ x for x in X])


def test_operators_apply_to_stacks_lane_by_lane():
    """Dense, windowed, transposed windowed and composed operators (the
    factored P = S T and R = T^T S^T) on K-major stacks equal their 1-D
    applies lane by lane, including the fit of a shorter or longer input
    along the last axis; rmatvec likewise.  Tolerance 1e-14: the dense
    product of a stack and of a vector may sum in other orders (gemm and
    gemv); every other form is exact."""
    rng = np.random.default_rng(3)
    A = pt.poisson((40, 40), format="csr")
    S = dia_from_scipy((0.1 * A + 0.9 * sp.eye(A.shape[0])).tocsr(),
                       dtype=torch.float64, device=CPU, row_pad=1024)
    T = _random_rect(S.n_pad, 300, per_row=1, spread=3, seed=5)
    W = windowed_from_scipy(T, dtype=torch.float64, device=CPU)
    assert isinstance(W, WindowedELL)
    D = dense_from_scipy(sp.random(50, 70, density=0.2, random_state=1),
                         dtype=torch.float64, device=CPU)
    P = ComposedOperator(ops=(S, W), shape=(S.n_pad, 300), nnz=0)
    R = ComposedOperator(ops=(TransposedWindowed(W), S), shape=(300, S.n_pad),
                         nnz=0)
    cases = [(D, 72), (W, 300), (W, W.m_chunks * W.w2), (P, 290),
             (TransposedWindowed(W), S.n_pad), (R, S.n_pad - 5), (S, S.n_pad)]
    for op, m in cases:
        X = torch.as_tensor(rng.random((3, m)))
        Y = op @ X
        assert Y.shape[0] == 3
        torch.testing.assert_close(Y, _lane_by_lane(op, X), rtol=1e-14,
                                   atol=0)
    for op, m in ((D, D.n_pad), (W, W.n_pad), (P, S.n_pad)):
        X = torch.as_tensor(rng.random((3, m)))
        torch.testing.assert_close(op.rmatvec(X), torch.stack(
            [op.rmatvec(x) for x in X]), rtol=1e-14, atol=0)
    # K10 equals K3 lane by lane (the same operations in the same order)
    dinv = torch.as_tensor(rng.random(S.n_pad))
    B = torch.as_tensor(rng.random((3, S.n_pad)))
    Xk, Rk = dia_jacobi_zero_res_k(S, B, dinv, 0.7)
    for k in range(3):
        x, r = dia_jacobi_zero_res(S, B[k], dinv, 0.7)
        assert torch.equal(Xk[k], x) and torch.equal(Rk[k], r)
        assert torch.equal(Rk[k], B[k] - dia_spmv(S, x))


def test_host_batched_wrappers_run_the_twin_only_on_cpu():
    """CPU stacks run the twins and count no launch; a stack on another
    device never falls back to a twin."""
    A = pt.poisson((40, 40), format="csr")
    td = dia_from_scipy(A, device=CPU, row_pad=1024)
    W = windowed_from_scipy(_random_rect(2048, 700, 2, 20, 1), device=CPU)
    X = torch.ones(2, td.n_pad)
    _build.reset_launches()
    dia_jacobi_zero_res_k(td, X, X[0], 0.5)
    windowed_matmat_k(W, torch.ones(2, W.m_chunks * W.w2))
    windowed_rmatmat_k(W, torch.ones(2, W.n_pad))
    assert _build.launches == {}
    meta = DIAMatrix(data=td.data.to("meta"), offsets=td.offsets,
                     shape=td.shape, nnz=td.nnz)
    with pytest.raises(ValueError, match="unsupported device"):
        dia_jacobi_zero_res_k(meta, X.to("meta"), X[0].to("meta"), 0.5)
    with pytest.raises(ValueError, match="different devices"):
        windowed_matmat_k(W, torch.ones(2, W.m_chunks * W.w2).to("meta"))


# ---------------------------------------------------------------------------
# batched solves on the host-built hierarchy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_host():
    A = poisson((64, 64), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, **CONFIG1)
    jh = jax_compile_hierarchy(ml, dtype=jnp.float64, mixed_precision=True)
    return A, JaxSolver(jh)


@pytest.fixture(scope="module")
def B3(jax_host):
    """Three lanes: a random one, a zero one (frozen from the start) and
    one scaled by 1e6."""
    rng = np.random.default_rng(5)
    n = jax_host[0].shape[0]
    B = np.zeros((n, 3))
    B[:, 0] = rng.random(n)
    B[:, 2] = 1e6 * rng.random(n)
    return B


@pytest.fixture(scope="module")
def jax_solves(jax_host, B3):
    """The JAX vmapped batched solve for each (accel, precision): (x,
    per-lane histories)."""
    out = {}
    for accel, prec in SOLVES:
        res = []
        x = jax_host[1].solve(B3, accel=accel, precision=prec, residuals=res,
                              **SOLVE_KW[accel])
        out[accel, prec] = (np.asarray(x), [np.asarray(r) for r in res])
    return out


@pytest.fixture(scope="module")
def port(jax_host):
    return pt.DeviceMultilevelSolver(hierarchy_from_jax(
        jax_host[1].hierarchy, CPU))


def test_host_hierarchy_forms(port):
    """The 64^2 host-built hierarchy has the forms the batched cycle must
    take: a DIA level 0 with factored composed transfers, dense below."""
    lv0 = port.hierarchy.levels[0]
    assert isinstance(lv0.A, DIAMatrix)
    assert [type(o) for o in lv0.P.ops] == [DIAMatrix, WindowedELL]
    assert [type(o) for o in lv0.R.ops] == [TransposedWindowed, DIAMatrix]
    assert all(isinstance(lvl.A, DenseOperator)
               for lvl in port.hierarchy.levels[1:])


@pytest.mark.parametrize("accel,prec", SOLVES)
def test_host_batched_solve_matches_reference(port, B3, jax_solves, accel,
                                              prec):
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
    assert info == (0 if accel == "cg" else SOLVE_KW[None]["maxiter"])


def test_host_batched_lane_equals_the_single_solve(port, B3):
    """Lane j of the host-built batched CG is the 1-D solve of column j:
    the same count, the history to rtol 1e-10."""
    res = []
    X = port.solve(B3, accel="cg", residuals=res, **SOLVE_KW["cg"])
    for j in (0, 2):
        r1 = []
        x1 = port.solve(B3[:, j], accel="cg", residuals=r1, **SOLVE_KW["cg"])
        assert len(res[j]) == len(r1)
        np.testing.assert_allclose(res[j], r1, rtol=1e-10)
        np.testing.assert_allclose(X[:, j], x1, rtol=1e-9,
                                   atol=1e-12 * np.abs(x1).max())


def test_host_batched_float32_cycle_takes_k10():
    """The port's own float32 host-built hierarchy: the batched cycle's
    zero-entry front-end is K10's entry, and the mixed solve converges
    every lane to 1e-8 against the true operator."""
    A = pt.poisson((64, 64), format="csr")
    ml = pt.smoothed_aggregation_solver(A, **CONFIG1)
    dml = pt.as_device_solver(ml, device=CPU, mixed_precision=True)
    lv0 = dml.hierarchy.levels[0]
    Bk = torch.as_tensor(np.random.default_rng(7).random((4, lv0.n_pad)),
                         dtype=torch.float32)
    out = lv0.pre.zero_call_residual(lv0.A, Bk)
    assert out is not None and out[1].shape == Bk.shape
    B = np.random.default_rng(8).random((A.shape[0], 4))
    X, info = dml.solve(B, tol=1e-8, accel="cg", precision="mixed",
                        return_info=True)
    assert info == 0
    for j in range(4):
        assert np.linalg.norm(B[:, j] - A @ X[:, j]) < 1e-8 * np.linalg.norm(
            B[:, j])
