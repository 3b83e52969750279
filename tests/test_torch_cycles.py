"""The port's W, F and AMLI cycles against the JAX package's, on the CPU.

Both packages compile the same host-built hierarchy: 2-D Poisson 128^2,
smoothed aggregation with Jacobi (omega = 4/3) before and after,
``max_coarse=10``.  It has five levels: DIA levels 0 and 1 with composed
P = S T and R = T^T S^T (windowed T), and dense levels 2-4.  So a W-cycle
visits level 1 twice (its second visit enters through the sweep plus
residual of a nonzero iterate, K4's twin) and level 2 four times, and
AMLI's coarse corrections run on a DIA level and on dense ones.  Float64
cycle applications agree to rtol 1e-12, stationary and CG histories to
rtol 1e-10.  The batched lanes and the 2-level case are checked within
the port.  The JAX programs compile once per (cycle, accel) case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pyamg_tpu  # noqa: E402
from pyamg_tpu.engine import DeviceMultilevelSolver as JaxSolver  # noqa: E402
from pyamg_tpu.engine import compile_hierarchy as jax_compile  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402

from pyamg_tpu_torch import (DeviceMultilevelSolver, compile_hierarchy,  # noqa: E402
                             device_sa_setup)
from pyamg_tpu_torch.engine.solver import _make_cycle  # noqa: E402
from pyamg_tpu_torch.sparse import DIAMatrix  # noqa: E402

CPU = "cpu"
CYCLES = ["V", "W", "F", "AMLI"]
JACOBI = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
              postsmoother=("jacobi", {"omega": 4.0 / 3.0}))


@pytest.fixture(scope="module")
def ml():
    A = poisson((128, 128), format="csr")
    return pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=10, **JACOBI)


@pytest.fixture(scope="module")
def pair(ml):
    return (JaxSolver(jax_compile(ml, dtype=jnp.float64)),
            DeviceMultilevelSolver(compile_hierarchy(ml, dtype=torch.float64,
                                                     device=CPU)))


@pytest.fixture(scope="module")
def b(ml):
    return np.random.default_rng(1).random(ml.levels[0].A.shape[0])


def _padded(b, n_pad):
    r = np.zeros(n_pad)
    r[: len(b)] = b
    return r


def test_hierarchy_has_dia_levels_below_the_finest(pair):
    """The W-cycle's repeated visits reach DIA levels (K4 / K5 twins),
    not only dense ones."""
    _, T = pair
    levels = T.hierarchy.levels
    assert len(levels) == 5
    assert all(isinstance(lv.A, DIAMatrix) for lv in levels[:2])
    assert type(levels[2].A).__name__ == "DenseOperator"


@pytest.mark.parametrize("cycle", CYCLES)
def test_cycle_operator_matches_reference(pair, b, cycle):
    """One cycle from zero (the preconditioner application), float64:
    rtol 1e-12 against the JAX cycle (counterpart of
    tests/test_engine.py::test_device_cycles)."""
    J, T = pair
    r = _padded(b, T.hierarchy.levels[0].n_pad)
    want = np.asarray(J.cycle_operator(cycle)(jnp.asarray(r)))
    got = T.cycle_operator(cycle)(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("depth", [1, 3])
def test_amli_depth_matches_reference(pair, b, depth):
    """AMLI with one and with three coarse corrections a visit."""
    J, T = pair
    r = _padded(b, T.hierarchy.levels[0].n_pad)
    want = np.asarray(J.cycle_operator("AMLI", depth)(jnp.asarray(r)))
    got = T.cycle_operator("AMLI", amli_depth=depth)(
        torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("cycle", CYCLES)
def test_stationary_matches_reference(pair, b, cycle):
    """accel=None, ten cycles from the nonzero iterate: histories to rtol
    1e-10 (deeper, the stationary residual reaches its rounding floor)."""
    J, T = pair
    res_j, res_t = [], []
    J.solve(b, tol=1e-8, maxiter=10, cycle=cycle, residuals=res_j)
    T.solve(b, tol=1e-8, maxiter=10, cycle=cycle, residuals=res_t)
    assert len(res_t) == len(res_j) == 11
    np.testing.assert_allclose(res_t, res_j, rtol=1e-10)


@pytest.mark.parametrize("cycle", CYCLES)
def test_cg_matches_reference(pair, b, cycle):
    """Cycle-preconditioned CG to 1e-10: the same count, histories to rtol
    1e-10, solutions to 1e-10."""
    J, T = pair
    res_j, res_t = [], []
    xj = J.solve(b, tol=1e-10, maxiter=40, cycle=cycle, accel="cg",
                 residuals=res_j)
    xt = T.solve(b, tol=1e-10, maxiter=40, cycle=cycle, accel="cg",
                 residuals=res_t)
    assert len(res_t) == len(res_j)
    np.testing.assert_allclose(res_t, res_j, rtol=1e-10)
    np.testing.assert_allclose(xt, xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())


def test_mixed_w_cycle_cg_matches_reference(ml, b):
    """The float32 W-cycle under the float64 outer CG (config 2's solve):
    counts within one of the JAX package's, converged to 1e-8 against the
    true operator."""
    kw = dict(mixed_precision=True, coarse_cutoff=1024)
    J = JaxSolver(jax_compile(ml, dtype=jnp.float32, **kw))
    T = DeviceMultilevelSolver(compile_hierarchy(ml, dtype=torch.float32,
                                                 device=CPU, **kw))
    res_j, res_t = [], []
    J.solve(b, tol=1e-8, cycle="W", accel="cg", precision="mixed",
            residuals=res_j)
    x, info = T.solve(b, tol=1e-8, cycle="W", accel="cg", precision="mixed",
                      residuals=res_t, return_info=True)
    assert info == 0 and abs(len(res_t) - len(res_j)) <= 1
    np.testing.assert_allclose(res_t[:4], res_j[:4], rtol=1e-3)
    A = ml.levels[0].A
    assert np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("cycle", CYCLES)
def test_cycle_on_lanes_equals_each_lane(pair, b, cycle):
    """A K-major (3, n_pad) stack through the cycle gives each lane's
    vector cycle (AMLI's coarse scalars are per lane); a zero lane stays
    zero."""
    _, T = pair
    n_pad = T.hierarchy.levels[0].n_pad
    rng = np.random.default_rng(7)
    R = torch.as_tensor(np.stack([_padded(b, n_pad), np.zeros(n_pad),
                                  _padded(rng.random(len(b)), n_pad)]))
    cyc = T.cycle_operator(cycle)
    Y = cyc(R)
    for k in range(3):
        torch.testing.assert_close(Y[k], cyc(R[k].contiguous()),
                                   rtol=1e-12, atol=1e-14)
    assert not Y[1].any()


def test_cycles_on_two_levels_equal_v():
    """On a hierarchy of two levels the coarsest pair calls the coarse
    solve directly for every kind, so W, F and AMLI give the V-cycle's
    bits."""
    A = poisson((48, 48), format="csr")
    dsa = device_sa_setup(A, grid=(48, 48), dtype=torch.float64, device=CPU,
                          max_coarse=400)
    h = dsa.hierarchy
    assert len(h.levels) == 2
    r = torch.as_tensor(np.random.default_rng(2).random(h.levels[0].n_pad))
    want = _make_cycle(2, "V").zero(h, r)
    for cycle in CYCLES[1:]:
        assert torch.equal(_make_cycle(2, cycle).zero(h, r), want), cycle


def test_unknown_cycle_raises(pair, b):
    _, T = pair
    with pytest.raises(ValueError, match="cycle"):
        T.cycle_operator("X")
    with pytest.raises(ValueError, match="cycle"):
        T.solve(b, cycle="Y", accel="cg")


def test_batched_w_cycle_cg_lanes_match_1d():
    """The device-built float32 hierarchy (K-lane kernels' twins: K11 on
    the zero entries, K9 + K8 on the W-cycle's second visits), W-cycle CG
    to 1e-5 on three lanes: each lane within one iteration of its 1-D
    solve (tests/test_batched.py's allowance) and its solution to
    3e-5."""
    A = poisson((96, 96), format="csr")
    dsa = device_sa_setup(A, grid=(96, 96), dtype=torch.float32, device=CPU,
                          max_coarse=20)
    assert len(dsa.hierarchy.levels) >= 3
    B = np.random.default_rng(0).random((A.shape[0], 3))
    res_b = []
    X = dsa.solve(B, tol=1e-5, maxiter=40, cycle="W", accel="cg",
                  residuals=res_b)
    for j in range(3):
        res_1 = []
        x1 = dsa.solve(B[:, j], tol=1e-5, maxiter=40, cycle="W", accel="cg",
                       residuals=res_1)
        assert abs(len(res_b[j]) - len(res_1)) <= 1, j
        assert np.abs(X[:, j] - x1).max() < 3e-5 * np.abs(x1).max()


def test_aspreconditioner_matches_reference(pair, b, ml):
    """``aspreconditioner`` applies the card's cycle from the host in
    float64 (the reference's ``DeviceMultilevelSolver.aspreconditioner``):
    the same vector as the JAX one, and a scipy CG with it converges."""
    import scipy.sparse.linalg as spla

    J, T = pair
    for cycle in ("V", "W"):
        Mj, Mt = J.aspreconditioner(cycle), T.aspreconditioner(cycle)
        assert Mt.shape == Mj.shape and Mt.dtype == np.float64
        np.testing.assert_allclose(Mt @ b, Mj @ b, rtol=1e-12,
                                   atol=1e-12 * np.abs(Mj @ b).max())
    A = ml.levels[0].A
    x, info = spla.cg(A, b, rtol=1e-10, maxiter=40,
                      M=T.aspreconditioner("W"))
    assert info == 0
    assert np.linalg.norm(b - A @ x) < 1e-9 * np.linalg.norm(b)
