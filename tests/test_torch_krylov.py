"""The port's device Krylov family (``engine/krylov.py``) against the JAX
package's, on the CPU.

Three levels, float64 throughout:

- each method called directly, with a port ``DIAMatrix``'s apply and a
  Jacobi preconditioner, against the JAX ``device_*`` function on the
  same arrays (2-D Poisson 32^2; CGNR and CGNE on the nonsymmetric
  ``recirc_flow((48, 48), epsilon=1e-2)`` of tests/test_device_krylov.py),
  histories to rtol 1e-8; on a K-major stack each lane gives its vector
  run;
- solves through the AMG preconditioner (``accel=``) on the 32^2 SA
  hierarchy of tests/test_device_krylov.py (Jacobi before and after,
  ``max_coarse=16``), both packages compiling the same host hierarchy,
  histories to rtol 1e-8;
- batched (n, K) solves within the port (tests/test_batched.py's
  counterparts): each lane within one iteration of its 1-D solve, a zero
  lane frozen at entry across GMRES restarts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pyamg_tpu  # noqa: E402
from pyamg_tpu.engine import DeviceMultilevelSolver as JaxSolver  # noqa: E402
from pyamg_tpu.engine import compile_hierarchy as jax_compile  # noqa: E402
from pyamg_tpu.engine import krylov as jk  # noqa: E402
from pyamg_tpu.gallery import poisson, recirc_flow  # noqa: E402
from pyamg_tpu.sparse import dia_from_scipy as jax_dia_from_scipy  # noqa: E402

from pyamg_tpu_torch import (DeviceMultilevelSolver, as_device_solver,  # noqa: E402
                             compile_hierarchy)
from pyamg_tpu_torch.engine import krylov as tk  # noqa: E402
from pyamg_tpu_torch.sparse import dia_from_scipy  # noqa: E402

CPU = "cpu"
JACOBI = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
              postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
ACCELS = [None, "cg", "bicgstab", "gmres", "fgmres", "cgnr", "cgne", "cr",
          "minimal_residual", "steepest_descent"]
# method -> (operator, tol, maxiter, extra keywords).  BiCGStab and CGNE
# stop at 15 and 20 steps: on these operators their residuals stall and
# grow, and each further step amplifies the two packages' rounding
# differences (at 60 steps BiCGStab's histories part by a factor 25)
DIRECT = {
    "cg": ("spd", 1e-10, 60, {}),
    "bicgstab": ("spd", 1e-6, 15, {}),
    "gmres": ("spd", 1e-10, 60, dict(restart=12)),
    "fgmres": ("spd", 1e-10, 60, dict(restart=12)),
    "cr": ("spd", 1e-10, 60, {}),
    "minimal_residual": ("spd", 1e-6, 60, {}),
    "steepest_descent": ("spd", 1e-6, 60, {}),
    "cgnr": ("nonsym", 1e-6, 60, {}),
    "cgne": ("nonsym", 1e-6, 20, {}),
}


def _hist(h):
    h = np.asarray(h)
    return h[~np.isnan(h)]


@pytest.fixture(scope="module")
def operators():
    """(port DIA, JAX DIA, Jacobi weights, b) for each operator."""
    out = {}
    for key, A in (("spd", poisson((32, 32), format="csr")),
                   ("nonsym", recirc_flow((48, 48), epsilon=1e-2).tocsr())):
        td = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=64)
        jd = jax_dia_from_scipy(A, dtype=jnp.float64, row_pad=64)
        d = np.zeros(td.n_pad)
        d[: A.shape[0]] = 1.0 / A.diagonal()
        b = np.zeros(td.n_pad)
        b[: A.shape[0]] = np.random.default_rng(1).random(A.shape[0])
        out[key] = (td, jd, d, b)
    return out


def _port_call(name, td, d, b, x0, tol, maxiter, **kw):
    dinv = torch.as_tensor(d)
    M = lambda r: dinv * r                                   # noqa: E731
    fn = getattr(tk, f"device_{name}")
    if name in ("cgnr", "cgne"):
        return fn(td.__matmul__, td.rmatvec, b, x0, tol=tol, maxiter=maxiter,
                  M=M, **kw)
    return fn(td.__matmul__, b, x0, tol=tol, maxiter=maxiter, M=M, **kw)


@pytest.mark.parametrize("name", list(DIRECT))
def test_direct_matches_reference(operators, name):
    """The method on a DIA apply with a Jacobi preconditioner: the same
    count and histories to rtol 1e-8, solutions to 1e-8."""
    key, tol, maxiter, kw = DIRECT[name]
    td, jd, d, b = operators[key]
    dj = jnp.asarray(d)
    Mj = lambda r: dj * r                                    # noqa: E731
    fj = getattr(jk, f"device_{name}")
    bj = jnp.asarray(b)
    if name in ("cgnr", "cgne"):
        xj, hj, itj = fj(jd.__matmul__, jd.rmatvec, bj, jnp.zeros_like(bj),
                         tol=tol, maxiter=maxiter, M=Mj, **kw)
    else:
        xj, hj, itj = fj(jd.__matmul__, bj, jnp.zeros_like(bj), tol=tol,
                         maxiter=maxiter, M=Mj, **kw)
    bt = torch.as_tensor(b)
    xt, ht, itt = _port_call(name, td, d, bt, torch.zeros_like(bt), tol,
                             maxiter, **kw)
    assert itt == int(itj)
    hj, ht = _hist(hj), _hist(ht.numpy())
    assert len(ht) == len(hj) >= 3
    np.testing.assert_allclose(ht, hj, rtol=1e-8)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-8,
                               atol=1e-8 * np.abs(xj).max())


@pytest.mark.parametrize("name", list(DIRECT))
def test_direct_on_lanes_equals_each_lane(operators, name):
    """A K-major (3, n) stack [b, 0, 2 b'] runs each lane's vector
    iteration (per-lane scalars, breakdown flags and freeze): counts
    equal, histories to rtol 1e-10; the zero lane stops at entry with x
    zero."""
    key, tol, maxiter, kw = DIRECT[name]
    td, _, d, b = operators[key]
    b2 = np.roll(b, 7) * 2.0
    b2[td.shape[0]:] = 0.0
    B = torch.as_tensor(np.stack([b, np.zeros_like(b), b2]))
    X, H, its = _port_call(name, td, d, B, torch.zeros_like(B), tol, maxiter,
                           **kw)
    assert H.shape == (maxiter + 1, 3) and its.shape == (3,)
    assert int(its[1]) == 0 and len(_hist(H[:, 1].numpy())) == 1
    assert not X[1].any()
    for k in (0, 2):
        x1, h1, it1 = _port_call(name, td, d, B[k].contiguous(),
                                 torch.zeros_like(B[k]), tol, maxiter, **kw)
        assert int(its[k]) == it1
        np.testing.assert_allclose(_hist(H[:, k].numpy()),
                                   _hist(h1.numpy()), rtol=1e-10)
        torch.testing.assert_close(X[k], x1, rtol=1e-9,
                                   atol=1e-9 * float(x1.abs().max()))


@pytest.fixture(scope="module")
def spd_pair():
    """The 32^2 SA hierarchy of tests/test_device_krylov.py (Jacobi,
    max_coarse=16), compiled by both packages in float64."""
    A = poisson((32, 32), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=16, **JACOBI)
    b = np.random.default_rng(0).random(A.shape[0])
    return (A, JaxSolver(jax_compile(ml, dtype=jnp.float64)),
            DeviceMultilevelSolver(compile_hierarchy(ml, dtype=torch.float64,
                                                     device=CPU)), b)


@pytest.mark.parametrize("accel", ACCELS)
def test_solve_matches_reference(spd_pair, accel):
    """Every accel through the V-cycle preconditioner (GMRES and FGMRES
    restarted every 7 steps): the same count, histories to rtol 1e-8,
    solutions to 1e-8 (counterpart of tests/test_device_krylov.py).  The
    stationary cycles stop at 1e-6: below it their residual reaches the
    rounding floor, where the two packages part at 5e-8."""
    A, J, T, b = spd_pair
    kw = dict(tol=1e-8 if accel else 1e-6, maxiter=30, accel=accel,
              restart=7)
    res_j, res_t = [], []
    xj = J.solve(b, residuals=res_j, **kw)
    xt = T.solve(b, residuals=res_t, **kw)
    assert len(res_t) == len(res_j) >= 3
    np.testing.assert_allclose(res_t, res_j, rtol=1e-8)
    np.testing.assert_allclose(xt, xj, rtol=1e-8,
                               atol=1e-8 * np.abs(xj).max())


@pytest.mark.parametrize("accel", ["gmres", "fgmres"])
def test_gmres_count_is_capped_at_maxiter(spd_pair, accel):
    """Restart 3 against maxiter 8, short of the tolerance: three restarts
    of three inner steps each run (the last one whole), the history stops
    at entry 8 and the info is min(9, 8), as in the reference."""
    A, J, T, b = spd_pair
    kw = dict(tol=1e-12, maxiter=8, accel=accel, restart=3,
              return_info=True)
    res_j, res_t = [], []
    xj, info_j = J.solve(b, residuals=res_j, **kw)
    xt, info_t = T.solve(b, residuals=res_t, **kw)
    assert info_t == info_j == 8
    assert len(res_t) == len(res_j) == 9
    np.testing.assert_allclose(res_t, res_j, rtol=1e-8)
    np.testing.assert_allclose(xt, xj, rtol=1e-8,
                               atol=1e-8 * np.abs(xj).max())


def test_unknown_accel_raises(spd_pair):
    _, _, T, b = spd_pair
    with pytest.raises(ValueError, match="accelerator"):
        T.solve(b, accel="minres")


@pytest.fixture(scope="module")
def batched():
    """The port's float32 host-built 64^2 SA hierarchy (Jacobi), the
    counterpart of tests/test_batched.py's."""
    A = poisson((64, 64), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, **JACOBI)
    return A, as_device_solver(ml, device=CPU)


@pytest.mark.parametrize("accel", ACCELS)
def test_batched_matches_single(batched, accel):
    """Three lanes to 1e-5: each lane within one iteration of its own 1-D
    solve and its solution to 3e-5 (tests/test_batched.py::
    test_batched_matches_single, every accel)."""
    A, dml = batched
    n = A.shape[0]
    B = np.random.default_rng(0).random((n, 3))
    res_b = []
    Xb = dml.solve(B, tol=1e-5, maxiter=40, accel=accel, residuals=res_b)
    assert Xb.shape == (n, 3) and len(res_b) == 3
    for j in range(3):
        res1 = []
        x1 = dml.solve(B[:, j], tol=1e-5, maxiter=40, accel=accel,
                       residuals=res1)
        assert abs(len(res_b[j]) - len(res1)) <= 1, (accel, j)
        assert np.max(np.abs(Xb[:, j] - x1)) < 3e-5 * np.max(np.abs(x1))


def test_batched_gmres_multi_restart(batched):
    """A zero lane freezes at entry and stays frozen across GMRES
    restarts while the others iterate (tests/test_batched.py::
    test_batched_gmres_multi_restart)."""
    A, dml = batched
    n = A.shape[0]
    rng = np.random.default_rng(9)
    B = np.stack([rng.random(n), np.zeros(n), rng.random(n)], axis=1)
    res_b = []
    Xb = dml.solve(B, tol=1e-6, maxiter=24, accel="gmres", restart=4,
                   residuals=res_b)
    assert len(res_b[1]) == 1 and not Xb[:, 1].any()
    for j in (0, 2):
        res1 = []
        x1 = dml.solve(B[:, j], tol=1e-6, maxiter=24, accel="gmres",
                       restart=4, residuals=res1)
        assert len(res1) > 5                   # several restarts ran
        assert abs(len(res_b[j]) - len(res1)) <= 1
        assert np.max(np.abs(Xb[:, j] - x1)) < 3e-5 * np.max(np.abs(x1))
