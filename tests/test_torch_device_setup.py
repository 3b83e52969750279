"""The port's device-built SA setup (``device_sa_setup``) and its solves
against the JAX package, on the CPU.

The same scipy operator goes to both packages' ``device_sa_setup``; the
float64 hierarchies must agree operator for operator (offsets, paddings,
S, S^T, tv, A, the coarse pseudo-inverse) and solve with the same residual
histories.  The JAX setups are module-scoped fixtures, so its setup
program compiles twice in this file (64^2 and 14^3).  The structured
Galerkin product is also held against the scipy golden of the reference's
own test (tests/test_device_setup.py).
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_device_setup import _dia_to_scipy, _host_structured_sa  # noqa: E402

from pyamg_tpu.engine import device_sa_setup as jax_device_sa_setup  # noqa: E402
from pyamg_tpu.engine.device_setup import _ns_pinv as jax_ns_pinv  # noqa: E402
from pyamg_tpu.engine.device_setup import detect_grid as jax_detect_grid  # noqa: E402
from pyamg_tpu.engine.setup import _hash_weights as jax_hash_weights  # noqa: E402
from pyamg_tpu.gallery import (diffusion_stencil_2d, poisson,  # noqa: E402
                               stencil_grid)

from pyamg_tpu_torch import (StructuredDeviceSolver, detect_grid,  # noqa: E402
                             device_sa_setup, dia_from_stencil,
                             structured_solver_from_jax)
from pyamg_tpu_torch.engine.device_setup import (_ns_pinv,  # noqa: E402
                                                 _solve_pad,
                                                 StructuredProlongator,
                                                 StructuredRestrictor)
from pyamg_tpu_torch.engine.setup import _hash_weights  # noqa: E402
from pyamg_tpu_torch.engine.solver import (_fused_zero_entry_chain,  # noqa: E402
                                           _make_cycle)
from pyamg_tpu_torch.sparse import DenseOperator, DIAMatrix  # noqa: E402

CPU = "cpu"
SETUP = dict(max_coarse=100, mixed_precision=True)


def _setups(grid, **kw):
    A = poisson(grid, format="csr")
    return (A, jax_device_sa_setup(A, grid=grid, dtype=jnp.float64, **kw),
            device_sa_setup(A, grid=grid, dtype=torch.float64, device=CPU,
                            **kw))


@pytest.fixture(scope="module")
def pair2d():
    return _setups((64, 64), **SETUP)


@pytest.fixture(scope="module")
def pair3d():
    return _setups((14, 14, 14), max_coarse=100)


@pytest.fixture(scope="module")
def b2d(pair2d):
    return np.random.default_rng(0).random(pair2d[0].shape[0])


def _assert_close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("grid", [(48, 96), (8, 12, 20), "fe9"])
def test_detect_grid_matches_reference(grid):
    if grid == "fe9":
        A = stencil_grid(diffusion_stencil_2d(epsilon=1.0, type="FE"),
                         (32, 40)).tocsr()
    else:
        A = poisson(grid, format="csr")
    assert detect_grid(A) == jax_detect_grid(A)
    assert detect_grid(A) == (tuple(grid) if grid != "fe9" else (32, 40))


@pytest.mark.parametrize("n,seed", [(1000, 12345), (4227072, 12345),
                                    (77, 0), (5003, 9876)])
def test_hash_weights_bit_for_bit(n, seed):
    got = _hash_weights(n, seed).numpy()
    want = np.asarray(jax_hash_weights(n, seed))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("which", ["pair2d", "pair3d"])
def test_setup_matches_reference(which, request):
    """Same plan, offsets, n / n_pad and grids; S, S^T, tv, each A, the
    smoother weights and the coarse pseudo-inverse to rtol 1e-10; rho to
    rtol 1e-12 (float64)."""
    _, J, T = request.getfixturevalue(which)
    assert (T.grid, T.grid_p) == (J.grid, J.grid_p)
    hj, ht = J.hierarchy, T.hierarchy
    assert len(ht.levels) == len(hj.levels)
    for i, (lj, lt) in enumerate(zip(hj.levels[:-1], ht.levels[:-1])):
        assert (lt.n, lt.n_pad) == (lj.n, lj.n_pad)
        assert isinstance(lt.P, StructuredProlongator)
        assert isinstance(lt.R, StructuredRestrictor)
        for a, b in ((lt.A, lj.A), (lt.P.S, lj.P.S), (lt.R.St, lj.R.St)):
            assert a.offsets == b.offsets and a.n_pad == b.n_pad
            _assert_close(a.data, b.data, 1e-10, 1e-14)
        for f in ("fine_grid_p", "coarse_grid", "coarse_grid_p", "stride",
                  "center"):
            assert getattr(lt.P, f) == getattr(lj.P, f)
            assert getattr(lt.R, f) == getattr(lj.R, f)
        _assert_close(lt.P.tv, lj.P.tv, 1e-10)
        _assert_close(lt.R.tv, lj.R.tv, 1e-10)
        assert lt.pre.config == lj.pre.config == ("jacobi_dyn", 1)
        for ta, ja in zip(lt.pre.arrays, lj.pre.arrays):
            _assert_close(ta, ja, 1e-10)
        _assert_close(T.setup_info["levels"][i]["rho_D_inv_A"],
                      J.setup_info["levels"][i]["rho_D_inv_A"], 1e-12)
    cj, ct = hj.levels[-1], ht.levels[-1]
    assert isinstance(ct.A, DenseOperator) and (ct.n, ct.n_pad) == (cj.n,
                                                                    cj.n_pad)
    _assert_close(ct.A.data, cj.A.data, 1e-10, 1e-14)
    _assert_close(ht.coarse_inv, hj.coarse_inv, 1e-10, 1e-12)
    assert (ht.nc, ht.nc_pad) == (hj.nc, hj.nc_pad)
    assert (ht.A64 is None) == (hj.A64 is None)
    if ht.A64 is not None:
        assert ht.A64.offsets == hj.A64.offsets
        np.testing.assert_array_equal(ht.A64.data.numpy(),
                                      np.asarray(hj.A64.data))


@pytest.mark.parametrize("grid", [(9, 12), (8, 10), (9, 9, 9)])
def test_structured_rap_golden(grid):
    """P, R = P^T and the Galerkin coarse operator match the scipy golden
    of the reference's test entry for entry."""
    A = poisson(grid, format="csr")
    dml = device_sa_setup(A, grid=grid, dtype=torch.float64, device=CPU,
                          max_coarse=2, max_levels=2)
    lvl0 = dml.hierarchy.levels[0]
    rho = float(dml.setup_info["levels"][0]["rho_D_inv_A"])
    A_p, P_host, A_c_host, _ = _host_structured_sa(
        A, grid, stride=3, omega=4.0 / 3.0, rho=rho)
    rng = np.random.default_rng(1)
    xc = rng.random(P_host.shape[1])
    _assert_close((lvl0.P @ torch.as_tensor(xc)).numpy(), P_host @ xc, 0,
                  1e-12)
    r = rng.random(A_p.shape[0])
    _assert_close((lvl0.R @ torch.as_tensor(r)).numpy(), P_host.T @ r, 0,
                  1e-12)
    _assert_close(dml.hierarchy.levels[1].A.data.numpy(),
                  A_c_host.toarray(), 0, 1e-11)
    _assert_close(_dia_to_scipy(lvl0.A).toarray(), A_p.toarray(), 0, 0)


@pytest.mark.parametrize("which", ["pair2d", "pair3d"])
def test_cg_float64_matches_reference(which, request):
    """f64 CG on the two hierarchies: the same count, histories to rtol
    1e-8, converged against the true operator."""
    A, J, T = request.getfixturevalue(which)
    b = np.random.default_rng(1).random(A.shape[0])
    res_j, res_t = [], []
    J.solve(b, tol=1e-10, maxiter=40, accel="cg", residuals=res_j)
    x = T.solve(b, tol=1e-10, maxiter=40, accel="cg", residuals=res_t)
    assert len(res_t) == len(res_j)
    _assert_close(res_t, res_j, 1e-8)
    assert np.linalg.norm(b - A @ x) < 1e-9 * np.linalg.norm(b)


def test_stationary_float64_matches_reference(pair2d, b2d):
    """accel=None: V-cycles from the nonzero iterate, whose entry
    front-end is the Jacobi-plus-residual step (K4's twin) and whose
    restriction is the scaled SpMV (K1 SPMV_SCALED's twin); histories
    to rtol 1e-8."""
    _, J, T = pair2d
    res_j, res_t = [], []
    J.solve(b2d, tol=1e-8, maxiter=12, residuals=res_j)
    T.solve(b2d, tol=1e-8, maxiter=12, residuals=res_t)
    assert len(res_t) == len(res_j)
    _assert_close(res_t, res_j, 1e-8)


def test_mixed_float32_counts_within_one(pair2d, b2d):
    """The port's float32 hierarchy under the mixed float64 outer loop
    (the main path's precision) against the reference's float64 solve:
    counts within one, converged to 1e-8 against the true operator."""
    A, J, _ = pair2d
    dsa = device_sa_setup(A, grid=(64, 64), dtype=torch.float32, device=CPU,
                          **SETUP)
    assert dsa.hierarchy.levels[0].A.dtype == torch.float32
    assert dsa.hierarchy.A64.dtype == torch.float64
    res_j, res_t = [], []
    J.solve(b2d, tol=1e-8, accel="cg", precision="mixed", residuals=res_j)
    x, info = dsa.solve(b2d, tol=1e-8, accel="cg", precision="mixed",
                        residuals=res_t, return_info=True)
    assert info == 0 and abs(len(res_t) - len(res_j)) <= 1
    assert np.linalg.norm(b2d - A @ x) < 1e-8 * np.linalg.norm(b2d)


def test_structured_solver_from_jax_gives_the_same_solve(pair2d, b2d):
    """The JAX hierarchy's arrays carried across solve as the port's own
    setup does (the two setups agree to rounding)."""
    _, J, T = pair2d
    C = structured_solver_from_jax(J, CPU)
    assert isinstance(C, StructuredDeviceSolver)
    assert (C.grid, C.grid_p) == (T.grid, T.grid_p)
    assert C.hierarchy.levels[0].pre.config == ("jacobi_dyn", 1)
    res_c, res_t = [], []
    xc = C.solve(b2d, tol=1e-10, accel="cg", residuals=res_c)
    xt = T.solve(b2d, tol=1e-10, accel="cg", residuals=res_t)
    assert len(res_c) == len(res_t)
    _assert_close(res_c, res_t, 1e-10)
    _assert_close(xc, xt, 1e-10, 1e-13)


def test_tensor_in_tensor_out(pair2d, b2d):
    _, _, T = pair2d
    x = T.solve(torch.as_tensor(b2d), tol=1e-8, accel="cg")
    assert isinstance(x, torch.Tensor) and x.shape == b2d.shape
    np.testing.assert_array_equal(x.numpy(),
                                  T.solve(b2d, tol=1e-8, accel="cg"))


def test_fused_zero_entry_chain_equals_composed():
    """One zero-entry front-end through K5's entry equals the composed
    sweep, residual and restriction, on a stencil-built operator; the
    V-cycle through it is the one through the composed levels."""
    S1 = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=float)
    Ad = dia_from_stencil(S1, (48, 48), dtype=torch.float32, device=CPU)
    dsa = device_sa_setup(Ad, grid=(48, 48), dtype=torch.float32,
                          device=CPU, max_coarse=100)
    h = dsa.hierarchy
    lvl = h.levels[0]
    b = torch.as_tensor(np.random.default_rng(3).random(lvl.n_pad),
                        dtype=torch.float32)
    out = _fused_zero_entry_chain(lvl, b)
    assert out is not None, "the chain gate engages on the SA level"
    x, rc = out
    x_want = lvl.pre.zero_call(lvl.A, b)
    rc_want = lvl.R @ (b - (lvl.A @ x_want))
    torch.testing.assert_close(x, x_want, rtol=0, atol=0)
    torch.testing.assert_close(rc, rc_want, rtol=1e-5, atol=1e-6)
    y = _make_cycle(len(h.levels), "V").zero(h, b)
    assert y.shape == b.shape and bool(torch.isfinite(y).all())


def test_ns_pinv_matches_numpy():
    A = poisson((5, 5), format="csr").toarray()
    Ap = np.zeros((27, 27))
    Ap[:25, :25] = A
    X = _ns_pinv(torch.as_tensor(Ap)).numpy()
    np.testing.assert_allclose(X, np.linalg.pinv(Ap), atol=1e-8)
    np.testing.assert_allclose(X, np.asarray(jax_ns_pinv(jnp.asarray(Ap))),
                               rtol=1e-12, atol=1e-14)


def test_solve_pad_is_the_reference_padding():
    assert _solve_pad(4198401) == 4227072      # 2049^2 -> 129 * 32768
    assert _solve_pad(467856) == 475136
    assert _solve_pad(66560) == 69632
    assert _solve_pad(51984) == 51984


def test_solve_padded_hierarchy_solves():
    """A level above 65536 rows carries solve padding; A64 gets the same
    n_pad, so the mixed loop cuts no rows."""
    A = poisson((256, 260), format="csr")
    dsa = device_sa_setup(A, grid=(256, 260), dtype=torch.float32,
                          device=CPU, max_coarse=200, mixed_precision=True)
    l0 = dsa.hierarchy.levels[0]
    assert l0.n_pad == 69632 and l0.n == 258 * 261
    assert dsa.hierarchy.A64.n_pad == l0.n_pad == l0.R.tv.shape[0]
    b = np.random.default_rng(9).random(A.shape[0])
    x = dsa.solve(b, tol=1e-8, accel="cg", precision="mixed")
    assert np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)


def test_semicoarsening_anisotropic_diffusion():
    """stride='auto' reads the stencil anisotropy: x is coarsened first,
    the stencils stay at <= 9 diagonals, and the factor stays below 0.25
    (the reference test's bounds)."""
    S = diffusion_stencil_2d(epsilon=1e-3, theta=0.0, type="FD")
    g = (128, 128)
    A = stencil_grid(S, g).tocsr()
    ds = device_sa_setup(A, grid=g, max_coarse=400, dtype=torch.float64,
                         device=CPU, stride="auto")
    assert ds.setup_info["levels"][0]["strides"] == (1, 3)
    assert all(i["ndiags"] <= 9 for i in ds.setup_info["levels"])
    b = np.random.default_rng(0).random(A.shape[0])
    res = []
    x = ds.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
    assert (res[-1] / res[0]) ** (1.0 / (len(res) - 1)) < 0.25
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


def test_candidate_options():
    """A user candidate B and the improvement sweeps, on a diagonally
    rescaled operator (the reference test's bounds): the exact candidate
    is best, and eight sweeps recover most of it."""
    grid = (48, 48)
    A = poisson(grid, format="csr")
    rng = np.random.default_rng(0)
    d = 10.0 ** rng.uniform(-2, 2, A.shape[0])
    Dh = sp.diags(np.sqrt(d))
    As = (Dh @ A @ Dh).tocsr()
    b = rng.random(As.shape[0])

    def iters(**kw):
        ds = device_sa_setup(As, grid=grid, max_coarse=150, device=CPU,
                             **kw)
        res = []
        ds.solve(b, tol=1e-5, maxiter=60, accel="cg", residuals=res)
        return len(res) - 1

    it0 = iters(improve_candidates_iters=0)
    it8 = iters(improve_candidates_iters=8)
    it_exact = iters(B=1.0 / np.sqrt(d))
    assert it8 < it0 - 10, (it0, it8)
    assert it_exact <= it8, (it_exact, it8)


@pytest.mark.parametrize("kwargs,match", [
    (dict(dtype=torch.bfloat16), "item 4"),
    (dict(presmoother=("chebyshev", {"degree": 3})), "item 8"),
    (dict(postsmoother=("richardson", {})), "item 8"),
])
def test_unported_options_raise(kwargs, match):
    A = poisson((24, 24), format="csr")
    with pytest.raises(NotImplementedError, match=match):
        device_sa_setup(A, grid=(24, 24), device=CPU, max_coarse=20,
                        **kwargs)


def test_non_grid_operator_raises():
    """An operator that is not a grid stencil names the unstructured
    device setup, which is not ported."""
    n = 400
    M = sp.random(n, n, density=0.2, random_state=1, format="csr")
    A = (M + M.T + sp.identity(n) * n).tocsr()
    with pytest.raises(NotImplementedError, match="item 13"):
        device_sa_setup(A, device=CPU)
    with pytest.raises(ValueError, match="grid="):
        device_sa_setup(DIAMatrix(data=torch.ones(1, 9), offsets=(0,),
                                  shape=(9, 9), nnz=9), device=CPU)
