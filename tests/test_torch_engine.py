"""The port's hierarchy, smoothers, V-cycle and CG against the JAX
package, on the CPU, on the main path's configuration cut to 128^2.

Host setup (smoothed aggregation, Jacobi omega = 4/3 before and after) is
shared; both packages compile the same host hierarchy.  At 128^2 the
device hierarchy still has every operator form of the 2048^2 path: DIA
levels, P = Composed(DIA S, WindowedELL T), R = Composed(T^T, DIA S^T)
and dense coarse levels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pyamg_tpu  # noqa: E402
from pyamg_tpu.engine import DeviceMultilevelSolver as JaxSolver  # noqa: E402
from pyamg_tpu.engine import compile_hierarchy as jax_compile  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402

from pyamg_tpu_torch import (DeviceMultilevelSolver, as_device_solver,  # noqa: E402
                             compile_hierarchy, hierarchy_from_jax)
from pyamg_tpu_torch.engine.relaxation import jacobi, jacobi_dyn  # noqa: E402
from pyamg_tpu_torch.sparse import (ComposedOperator, DIAMatrix,  # noqa: E402
                                    TransposedWindowed, WindowedELL,
                                    dia_from_scipy)

CPU = "cpu"
GRID = (128, 128)
MIXED = dict(mixed_precision=True, coarse_cutoff=1024)


@pytest.fixture(scope="module")
def ml():
    A = poisson(GRID, format="csr")
    return pyamg_tpu.smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))


@pytest.fixture(scope="module")
def b(ml):
    return np.random.default_rng(1).random(ml.levels[0].A.shape[0])


@pytest.fixture(scope="module")
def pair64(ml):
    return (jax_compile(ml, dtype=jnp.float64),
            compile_hierarchy(ml, dtype=torch.float64, device=CPU))


@pytest.fixture(scope="module")
def pair32(ml):
    return (jax_compile(ml, dtype=jnp.float32, **MIXED),
            compile_hierarchy(ml, dtype=torch.float32, device=CPU, **MIXED))


def _form(op):
    name = type(op).__name__
    if isinstance(op, ComposedOperator) or name == "ComposedOperator":
        return (name,) + tuple(_form(o) for o in op.ops)
    if name == "TransposedWindowed":
        return (name, _form(op.base))
    if name == "WindowedELL":
        return (name, op.block, op.w2, op.m_chunks, op.n_pad)
    if name in ("DIAMatrix", "DenseOperator"):
        return (name, tuple(op.data.shape))
    return (name,)


@pytest.mark.parametrize("which", ["pair64", "pair32"])
def test_compile_hierarchy_matches_reference(which, request):
    """Same level count, operator forms (with windowed block/w2 and
    paddings), n / n_pad, smoother configs and omegas."""
    hj, ht = request.getfixturevalue(which)
    assert len(ht.levels) == len(hj.levels)
    for lj, lt in zip(hj.levels, ht.levels):
        assert (lt.n, lt.n_pad) == (lj.n, lj.n_pad)
        for a in ("A", "P", "R"):
            oj, ot = getattr(lj, a), getattr(lt, a)
            assert (ot is None) == (oj is None)
            if ot is not None:
                assert _form(ot) == _form(oj), a
        assert lt.pre.config == lj.pre.config
        assert lt.post.config == lj.post.config
    assert (ht.nc, ht.nc_pad) == (hj.nc, hj.nc_pad)
    np.testing.assert_array_equal(ht.coarse_inv.numpy(),
                                  np.asarray(hj.coarse_inv))
    assert (ht.A64 is None) == (hj.A64 is None)


def test_hierarchy_has_every_path_form(pair32):
    """The 128^2 hierarchy exercises every operator form of the main path,
    and R applies T's own arrays (an exact transpose)."""
    _, ht = pair32
    lv0 = ht.levels[0]
    assert isinstance(lv0.A, DIAMatrix) and lv0.A.ndiags == 5
    assert isinstance(lv0.P, ComposedOperator)
    assert isinstance(lv0.P.ops[0], DIAMatrix)
    assert isinstance(lv0.P.ops[-1], WindowedELL) and lv0.P.ops[-1].k == 1
    assert isinstance(lv0.R.ops[0], TransposedWindowed)
    assert lv0.R.ops[0].base is lv0.P.ops[-1]
    assert type(ht.levels[-1].A).__name__ == "DenseOperator"
    assert isinstance(ht.A64, DIAMatrix) and ht.A64.dtype == torch.float64
    for lvl in ht.levels[:-1]:
        assert lvl.pre.config[0] == "jacobi"


def test_cycle_operator_float64_matches_reference(pair64, b):
    """One V-cycle application (zero guess) agrees to rtol 1e-10 in
    float64 (the two differ only in summation order)."""
    hj, ht = pair64
    n_pad = ht.levels[0].n_pad
    r = np.zeros(n_pad)
    r[: len(b)] = b
    want = np.asarray(JaxSolver(hj).cycle_operator()(jnp.asarray(r)))
    got = DeviceMultilevelSolver(ht).cycle_operator()(
        torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


def test_cg_float64_matches_reference(pair64, b):
    """V-cycle-preconditioned CG in float64: the same iteration count and
    residual histories to rtol 1e-8."""
    hj, ht = pair64
    res_j, res_t = [], []
    xj = JaxSolver(hj).solve(b, tol=1e-10, maxiter=40, accel="cg",
                             residuals=res_j)
    xt = DeviceMultilevelSolver(ht).solve(b, tol=1e-10, maxiter=40,
                                          accel="cg", residuals=res_t)
    assert len(res_t) == len(res_j)
    np.testing.assert_allclose(res_t, res_j, rtol=1e-8)
    np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-12)


def test_stationary_float64_matches_reference(pair64, b):
    """accel=None: repeated V-cycles from the nonzero iterate (the fused
    sweep-then-residual entry, K4's twin, on the DIA levels), histories
    to rtol 1e-8."""
    hj, ht = pair64
    res_j, res_t = [], []
    JaxSolver(hj).solve(b, tol=1e-6, maxiter=12, residuals=res_j)
    DeviceMultilevelSolver(ht).solve(b, tol=1e-6, maxiter=12,
                                     residuals=res_t)
    assert len(res_t) == len(res_j)
    np.testing.assert_allclose(res_t, res_j, rtol=1e-8)


def test_mixed_precision_cg_matches_reference(pair32, b):
    """f32 cycle + f64 outer CG to 1e-8 (the main path's precision):
    iteration counts within +-1, the first five history entries to rtol
    1e-3 (f32 rounding order differs between the two)."""
    hj, ht = pair32
    res_j, res_t = [], []
    JaxSolver(hj).solve(b, tol=1e-8, accel="cg", precision="mixed",
                        residuals=res_j)
    x, info = DeviceMultilevelSolver(ht).solve(
        b, tol=1e-8, accel="cg", precision="mixed", residuals=res_t,
        return_info=True)
    assert info == 0
    assert abs(len(res_t) - len(res_j)) <= 1
    np.testing.assert_allclose(res_t[:5], res_j[:5], rtol=1e-3)
    assert res_t[-1] < 1e-8 * np.linalg.norm(b)
    A = poisson(GRID, format="csr")
    assert np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)


def test_hierarchy_from_jax_gives_the_same_solve(pair32, b):
    """The JAX hierarchy's arrays carried across solve exactly as the
    port's own compile does (both are built from the same host data),
    and R keeps sharing P's tentative operator."""
    hj, ht = pair32
    hc = hierarchy_from_jax(hj, CPU)
    for lc, lt in zip(hc.levels, ht.levels):
        for a in ("A", "P", "R"):
            assert _form(getattr(lc, a)) == _form(getattr(lt, a))
    assert hc.levels[0].R.ops[0].base is hc.levels[0].P.ops[-1]
    np.testing.assert_array_equal(hc.levels[0].A.data.numpy(),
                                  ht.levels[0].A.data.numpy())
    res_c, res_t = [], []
    xc = DeviceMultilevelSolver(hc).solve(b, tol=1e-8, accel="cg",
                                          precision="mixed",
                                          residuals=res_c)
    xt = DeviceMultilevelSolver(ht).solve(b, tol=1e-8, accel="cg",
                                          precision="mixed",
                                          residuals=res_t)
    np.testing.assert_array_equal(res_c, res_t)
    np.testing.assert_array_equal(xc, xt)


def test_tensor_in_tensor_out(pair32, b):
    _, ht = pair32
    bt = torch.as_tensor(b)
    x = DeviceMultilevelSolver(ht).solve(bt, tol=1e-8, accel="cg",
                                         precision="mixed")
    assert isinstance(x, torch.Tensor) and x.shape == (len(b),)
    xn = DeviceMultilevelSolver(ht).solve(b, tol=1e-8, accel="cg",
                                          precision="mixed")
    np.testing.assert_array_equal(x.numpy(), xn)


def test_single_level_direct_solve_matches_reference():
    """A hierarchy of one level: the cycle is the dense coarse solve."""
    A = poisson((20, 20), format="csr")
    ml1 = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=1000)
    assert len(ml1.levels) == 1
    b1 = np.random.default_rng(4).random(A.shape[0])
    res_j, res_t = [], []
    xj = JaxSolver(jax_compile(ml1, dtype=jnp.float64)).solve(
        b1, tol=1e-10, accel="cg", residuals=res_j)
    xt = as_device_solver(ml1, dtype=torch.float64, device=CPU).solve(
        b1, tol=1e-10, accel="cg", residuals=res_t)
    assert len(res_t) == len(res_j)
    np.testing.assert_allclose(xt, xj, rtol=1e-10)
    np.testing.assert_allclose(A @ xt, b1, rtol=1e-8, atol=1e-10)


def test_zero_call_residual_equals_composed_step():
    """The smoother's fused zero-guess sweep + residual (K3's entry) is
    the composed x = w dinv b, r = b - A x."""
    A = poisson((40, 40), format="csr")
    D = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=1024)
    dinv = torch.zeros(D.n_pad, dtype=torch.float64)
    dinv[: A.shape[0]] = 0.25
    sm = jacobi(dinv, 0.8)
    bb = torch.as_tensor(np.random.default_rng(2).random(D.n_pad))
    bb[A.shape[0]:] = 0
    x, r = sm.zero_call_residual(D, bb)
    xz = sm.zero_call(D, bb)
    torch.testing.assert_close(x, xz, rtol=0, atol=0)
    xn = x.numpy()[: A.shape[0]]
    np.testing.assert_allclose(r.numpy()[: A.shape[0]],
                               bb.numpy()[: A.shape[0]] - A @ xn,
                               rtol=1e-13, atol=1e-14)
    y = sm(D, x, bb)
    want = xn + 0.8 * 0.25 * (bb.numpy()[: A.shape[0]] - A @ xn)
    np.testing.assert_allclose(y.numpy()[: A.shape[0]], want, rtol=1e-13)
    # the nonzero-guess sweep + residual of its result (K4's entry)
    y_k4, r_k4 = sm.call_residual(D, x, bb)
    torch.testing.assert_close(y_k4, y, rtol=0, atol=0)
    yn = y.numpy()[: A.shape[0]]
    np.testing.assert_allclose(r_k4.numpy()[: A.shape[0]],
                               bb.numpy()[: A.shape[0]] - A @ yn,
                               rtol=1e-13, atol=1e-14)
    assert jacobi(dinv, 0.8, iterations=2).call_residual(D, x, bb) is None


def test_jacobi_dyn_equals_jacobi():
    """The device-weight Jacobi smoother (omega a 0-d tensor) gives the
    float-weight one's results in every entry form."""
    A = poisson((24, 24), format="csr")
    D = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=1024)
    rng = np.random.default_rng(5)
    dinv = torch.zeros(D.n_pad, dtype=torch.float64)
    dinv[: A.shape[0]] = 0.25
    x, bb = (torch.as_tensor(rng.random(D.n_pad)) for _ in range(2))
    for iters in (1, 2):
        s_f = jacobi(dinv, 0.8, iters)
        s_t = jacobi_dyn(dinv, torch.tensor(0.8, dtype=torch.float64), iters)
        assert s_t.config == ("jacobi_dyn", iters)
        for name, args in (("__call__", (D, x, bb)), ("zero_call", (D, bb)),
                           ("zero_call_residual", (D, bb)),
                           ("call_residual", (D, x, bb))):
            got, want = getattr(s_t, name)(*args), getattr(s_f, name)(*args)
            if want is None:
                assert got is None and iters == 2
                continue
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                torch.testing.assert_close(g, w, rtol=1e-15, atol=0)


@pytest.mark.parametrize("kwargs", [
    dict(cycle="W"), dict(accel="gmres"), dict(precision="double")])
def test_unported_solve_options_raise(pair32, b, kwargs):
    _, ht = pair32
    kw = dict(tol=1e-8, precision="mixed")
    kw.update(kwargs)
    with pytest.raises((NotImplementedError, ValueError)):
        DeviceMultilevelSolver(ht).solve(b, **kw)


def test_batched_rhs_raises(pair32, b):
    """An (n, K) right-hand side solves lane by lane on the host-built
    hierarchy (a lane scaled by 2 takes the same steps, scaled exactly;
    lane 0 is the 1-D solve to float32 rounding); a ``b`` of more than
    two dimensions raises."""
    _, ht = pair32
    solver = DeviceMultilevelSolver(ht)
    kw = dict(tol=1e-5, accel="cg")
    res, res1 = [], []
    X = solver.solve(np.stack([b, 2 * b], axis=1), residuals=res, **kw)
    x1 = solver.solve(b, residuals=res1, **kw)
    assert X.shape == (b.shape[0], 2)
    np.testing.assert_array_equal(res[1], 2 * res[0])
    assert abs(len(res[0]) - len(res1)) <= 1
    np.testing.assert_allclose(X[:, 0], x1, rtol=0,
                               atol=1e-4 * np.abs(x1).max())
    with pytest.raises(ValueError, match="dimensions"):
        solver.solve(np.ones((b.shape[0], 2, 1)))


def test_unported_smoother_raises():
    A = poisson((64, 64), format="csr")
    ml_gs = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=100)
    with pytest.raises(NotImplementedError, match="item 8"):
        compile_hierarchy(ml_gs, device=CPU)


def test_compile_needs_an_explicit_device(ml):
    """With no device given the compile targets the CUDA device: where
    torch sees none it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        assert compile_hierarchy(ml).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_hierarchy(ml)
