"""The port's classical setups on nonsymmetric operators and in mixed
precision, against the JAX package, on the CPU.

- ``device_air_setup`` (float64) on upwind advection 32^2 (theta = pi/4)
  and on the 8^2, theta = pi/3 golden case of
  ``tests/test_classical_device.py``: level by level as the Ruge-Stüben
  cases (``test_torch_classical.py``), the masked F-then-C Jacobi
  included; the first stationary cycle's residual drop (> 1e5) and the
  FGMRES history, each to the reference's; the batched elimination
  ``_unrolled_solve`` against the reference's unrolled one to 1e-12,
  zero pivots included.
- ``device_rs_setup`` on ``recirc_flow((64, 64))`` (float64): levels, and
  FGMRES to 1e-6 at the JAX package's count and history.
- Mixed precision (a float32 hierarchy, the float64 A64 outer loop) for
  both setups: the float32 levels to float32 rounding, the JAX package's
  count (the stationary AIR count within 3: it moves with the float32
  cycle's rounding), true relative residual <= 1e-10
  (``tests/test_classical_device.py::test_mixed_precision_true_residual``
  and ``test_air_mixed_precision``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyamg_tpu import gallery as jgal  # noqa: E402
from pyamg_tpu.engine import device_air_setup as jax_air  # noqa: E402
from pyamg_tpu.engine import device_rs_setup as jax_rs  # noqa: E402
from pyamg_tpu.engine.classical_setup import \
    _unrolled_solve as jax_unrolled_solve  # noqa: E402

import pyamg_tpu_torch as pt  # noqa: E402
from pyamg_tpu_torch import structured_solver_from_jax  # noqa: E402
from pyamg_tpu_torch.engine.classical_setup import \
    _unrolled_solve  # noqa: E402

from test_torch_classical import (assert_histories_match,  # noqa: E402
                                  assert_levels_match)

CPU = "cpu"

AIR_CASES = {
    "advection32": (lambda: jgal.advection_2d((32, 32), theta=np.pi / 4),
                    dict(grid=(32, 32), max_coarse=30)),
    "golden8": (lambda: jgal.advection_2d((8, 8), theta=np.pi / 3),
                dict(grid=(8, 8), max_coarse=10, max_levels=2)),
}


@pytest.fixture(autouse=True, scope="module")
def _x64_one_thread():
    jax.config.update("jax_enable_x64", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=list(AIR_CASES))
def air(request):
    make, kw = AIR_CASES[request.param]
    A, rhs = make()
    js = jax_air(A, dtype=jnp.float64, **kw)
    ts = pt.device_air_setup(A, dtype=torch.float64, device=CPU, **kw)
    return request.param, A, rhs, js, ts


def test_air_levels_match_reference(air):
    _, _, _, js, ts = air
    assert_levels_match(ts, js)
    post = ts.hierarchy.levels[0].post
    assert post.config == ("masked_jacobi", (2, 1), 1.0, 1)
    assert ts.hierarchy.levels[0].pre.config == ("identity",)


def test_air_solves_match_reference(air):
    """One stationary AIR cycle drops the residual by more than 1e5 (the
    reference air_solver's near-exact reduction), its history the JAX
    package's to rounding; FGMRES at the JAX package's count."""
    name, A, rhs, js, ts = air
    rj, rt = [], []
    js.solve(rhs, tol=1e-8, maxiter=5, residuals=rj)
    ts.solve(rhs, tol=1e-8, maxiter=5, residuals=rt)
    assert len(rt) == len(rj) and rt[0] == pytest.approx(rj[0], rel=1e-12)
    assert rt[1] / rt[0] < 1e-5 and rj[1] / rj[0] < 1e-5
    np.testing.assert_allclose(rt, rj, rtol=1e-8, atol=1e-12 * rj[0])
    rj, rt = [], []
    js.solve(rhs, tol=1e-10, maxiter=30, accel="fgmres", residuals=rj)
    x = ts.solve(rhs, tol=1e-10, maxiter=30, accel="fgmres", residuals=rt)
    assert len(rt) == len(rj) and len(rt) - 1 <= 20
    np.testing.assert_allclose(rt, rj, rtol=1e-8, atol=1e-12 * rj[0])
    assert np.linalg.norm(rhs - A @ x) <= 1e-9 * np.linalg.norm(rhs)


def test_air_from_jax(air):
    """The JAX AIR hierarchy carried across (bool masks, embedded
    transfers) applies its cycle as the JAX one does."""
    _, _, rhs, js, _ = air
    ts = structured_solver_from_jax(js, CPU)
    post = ts.hierarchy.levels[0].post
    assert post.arrays[1].dtype == torch.bool
    rj, rt = [], []
    js.solve(rhs, tol=1e-8, maxiter=3, residuals=rj)
    ts.solve(rhs, tol=1e-8, maxiter=3, residuals=rt)
    np.testing.assert_allclose(rt, rj, rtol=1e-8, atol=1e-12 * rj[0])


@pytest.mark.parametrize("k", [1, 5, 24])
def test_unrolled_solve_matches_reference(k):
    """The batched elimination against the reference's unrolled one:
    diagonally dominant systems, and rows whose pivot vanishes (an
    identity row with a zero right-hand side)."""
    rng = np.random.default_rng(k)
    n = 64
    M = rng.standard_normal((n, k, k)) + 2.0 * k * np.eye(k)[None]
    M[::7, 0, :] = 0.0                  # a zero first pivot (and its row)
    if k > 2:
        M[3::9, k // 2, k // 2] = 0.0   # a pivot left at zero
        M[3::9, k // 2, :] = 0.0
    b = rng.standard_normal((n, k))
    got = _unrolled_solve(torch.as_tensor(M), torch.as_tensor(b)).numpy()
    want = np.asarray(jax_unrolled_solve(jnp.asarray(M), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    ok = np.ones(n, dtype=bool)
    ok[::7] = False
    if k > 2:
        ok[3::9] = False
    np.testing.assert_allclose(np.einsum("nij,nj->ni", M[ok], got[ok]),
                               b[ok], rtol=1e-10, atol=1e-10)


def test_rs_recirc_fgmres_matches_reference():
    """Config 5's operator family at 64^2: the classical hierarchy of the
    nonsymmetric recirculating flow, FGMRES to 1e-6 at the JAX package's
    count and history."""
    A = jgal.recirc_flow((64, 64), epsilon=1e-2)
    kw = dict(grid=(64, 64), max_coarse=200)
    js = jax_rs(A, dtype=jnp.float64, **kw)
    ts = pt.device_rs_setup(A, dtype=torch.float64, device=CPU, **kw)
    assert_levels_match(ts, js)
    b = np.random.default_rng(4).random(A.shape[0])
    rj, rt = [], []
    js.solve(b, tol=1e-6, maxiter=60, accel="fgmres", residuals=rj)
    ts.solve(b, tol=1e-6, maxiter=60, accel="fgmres", residuals=rt)
    assert_histories_match(rt, rj)
    assert rt[-1] / rt[0] < 1e-6 and len(rt) - 1 < 50


def _mixed(setup, jsetup, A, b, kw, solve_kw):
    js = jsetup(A, mixed_precision=True, **kw)
    ts = setup(A, device=CPU, mixed_precision=True, **kw)
    assert ts.hierarchy.dtype == torch.float32
    for tl, jl in zip(ts.hierarchy.levels[:-1], js.hierarchy.levels[:-1]):
        for t, j in ((tl.A, jl.A), (tl.P.P_emb, jl.P.P_emb),
                     (tl.R.R_emb, jl.R.R_emb)):
            j = np.asarray(j.data)
            np.testing.assert_allclose(t.data.numpy(), j, rtol=1e-5,
                                       atol=1e-5 * np.abs(j).max())
    assert ts.hierarchy.A64.dtype == torch.float64
    np.testing.assert_array_equal(ts.hierarchy.A64.data.numpy(),
                                  np.asarray(js.hierarchy.A64.data))
    rj, rt = [], []
    js.solve(b, precision="mixed", residuals=rj, **solve_kw)
    x = ts.solve(b, precision="mixed", residuals=rt, **solve_kw)
    true = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert true <= 1e-10, true
    return rt, rj


def test_rs_mixed_precision():
    A = jgal.poisson((32, 32), format="csr")
    b = np.random.default_rng(3).random(A.shape[0])
    rt, rj = _mixed(pt.device_rs_setup, jax_rs, A, b,
                    dict(grid=(32, 32), max_coarse=30),
                    dict(tol=1e-11, maxiter=60, accel="cg"))
    assert len(rt) == len(rj)


def test_air_mixed_precision():
    """The float32 AIR cycle sits at its rounding floor after the first
    (near-exact) cycle, so the stationary count moves with the cycle's
    float32 rounding (the masked sweeps' and SpMVs' summation orders):
    the port's cycle on the JAX hierarchy's own arrays takes the port's
    count.  Held: the float32 hierarchy to float32 rounding, the count
    within 3 of the JAX package's, and the true relres <= 1e-10."""
    A, rhs = jgal.advection_2d((32, 32), theta=np.pi / 3)
    rt, rj = _mixed(pt.device_air_setup, jax_air, A, rhs,
                    dict(grid=(32, 32), max_coarse=100),
                    dict(tol=1e-11, maxiter=40))
    assert abs(len(rt) - len(rj)) <= 3, (len(rt), len(rj))
