"""The port's device-built Ruge-Stüben setup (``device_rs_setup``) against
the JAX package's, on the CPU, in float64.

Each case builds both setups from the same scipy operator (the JAX one
once per module: its compile dominates) and holds them level by level:
the padded operator, P_emb and R_emb (offsets equal, data to 1e-12 of
the largest entry), the rho(D^-1 A) estimate, the smoother tensors, the
strides, the diagonal counts and n_pad; the dense coarsest operator and
its pseudo-inverse.  Then V-cycle CG to 1e-10: the same iteration count
and histories to 1e-10 relative.  The cases: 2-D Poisson 32^2 (5-point
FD), the 9-point FE diffusion stencil, 48^2 anisotropic diffusion with
``stride='auto'`` (semicoarsening), ``stride=(2, 1)`` and 3-D Poisson
12^3.  Also a batched K = 2 solve, a JAX hierarchy carried across by
``structured_solver_from_jax``, and the route of an operator with no
grid to the unstructured classical setups.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyamg_tpu import gallery as jgal  # noqa: E402
from pyamg_tpu.engine import device_rs_setup as jax_rs  # noqa: E402

import pyamg_tpu_torch as pt  # noqa: E402
from pyamg_tpu_torch import structured_solver_from_jax  # noqa: E402
from pyamg_tpu_torch.engine import (EmbeddedProlongator,  # noqa: E402
                                    EmbeddedRestrictor)

CPU = "cpu"
F64 = torch.float64

# case -> (operator, setup keyword arguments)
CASES = {
    "fd5": (lambda: jgal.poisson((32, 32), format="csr"),
            dict(grid=(32, 32), max_coarse=30)),
    "fe9": (lambda: jgal.stencil_grid(jgal.diffusion_stencil_2d(
        1.0, 0.0, "FE"), (32, 32)).tocsr(),
        dict(grid=(32, 32), max_coarse=30)),
    "aniso_auto": (lambda: jgal.stencil_grid(jgal.diffusion_stencil_2d(
        1e-3, 0.0, "FD"), (48, 48)).tocsr(),
        dict(grid=(48, 48), max_coarse=30)),
    "stride21": (lambda: jgal.stencil_grid(jgal.diffusion_stencil_2d(
        1e-2, 0.0, "FD"), (24, 16)).tocsr(),
        dict(grid=(24, 16), stride=(2, 1), max_coarse=10, max_levels=3)),
    "poisson3d": (lambda: jgal.poisson((12, 12, 12), format="csr"),
                  dict(grid=(12, 12, 12), max_coarse=250)),
}


@pytest.fixture(autouse=True, scope="module")
def _x64_one_thread():
    jax.config.update("jax_enable_x64", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    make, kw = CASES[request.param]
    A = make()
    js = jax_rs(A, dtype=jnp.float64, **kw)
    ts = pt.device_rs_setup(A, dtype=F64, device=CPU, **kw)
    return request.param, A, js, ts


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale,
                               err_msg=what)


def _dia_close(T, J, what):
    assert T.offsets == tuple(int(o) for o in J.offsets), what
    assert T.shape == tuple(J.shape), what
    _close(T.data, J.data, what)


def assert_levels_match(ts, js):
    """Level by level: operators, transfers, smoothers, plan."""
    th, jh = ts.hierarchy, js.hierarchy
    assert ts.grid == tuple(js.grid) and ts.grid_p == tuple(js.grid_p)
    assert len(th.levels) == len(jh.levels)
    assert ts.setup_info["family"] == js.setup_info["family"]
    assert ts.setup_info["nlevels"] == js.setup_info["nlevels"]
    for i, (tl, jl) in enumerate(zip(th.levels[:-1], jh.levels[:-1])):
        assert (tl.n, tl.n_pad) == (jl.n, jl.n_pad), i
        _dia_close(tl.A, jl.A, f"level {i} A")
        assert isinstance(tl.P, EmbeddedProlongator)
        assert isinstance(tl.R, EmbeddedRestrictor)
        _dia_close(tl.P.P_emb, jl.P.P_emb, f"level {i} P_emb")
        _dia_close(tl.R.R_emb, jl.R.R_emb, f"level {i} R_emb")
        for attr in ("fine_grid_p", "coarse_grid", "coarse_grid_p", "stride",
                     "center"):
            assert getattr(tl.P, attr) == tuple(getattr(jl.P, attr)), attr
            assert getattr(tl.R, attr) == tuple(getattr(jl.R, attr)), attr
        for tsm, jsm in ((tl.pre, jl.pre), (tl.post, jl.post)):
            assert tsm.config == tuple(jsm.config)
            for ta, ja in zip(tsm.arrays, jsm.arrays, strict=True):
                if np.asarray(ja).dtype == bool:
                    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
                else:
                    _close(ta, ja, f"level {i} smoother {tsm.config[0]}")
        ti, ji = ts.setup_info["levels"][i], js.setup_info["levels"][i]
        assert ti["strides"] == tuple(ji["strides"])
        assert (ti["n"], ti["ndiags"]) == (ji["n"], ji["ndiags"])
        if "rho_D_inv_A" in ji:
            _close(ti["rho_D_inv_A"], ji["rho_D_inv_A"], f"level {i} rho")
    _close(th.levels[-1].A.data, jh.levels[-1].A.data, "coarsest A")
    _close(th.coarse_inv, jh.coarse_inv, "coarse pseudo-inverse")
    assert (th.nc, th.nc_pad) == (jh.nc, jh.nc_pad)


def assert_histories_match(got, want, rtol=1e-10):
    assert len(got) == len(want), (len(got), len(want))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * 1e-3 * want[0])


def test_rs_levels_match_reference(case):
    _, _, js, ts = case
    assert_levels_match(ts, js)


def test_rs_cg_matches_reference(case):
    _, A, js, ts = case
    b = np.random.default_rng(0).random(A.shape[0])
    rj, rt = [], []
    js.solve(b, tol=1e-10, maxiter=60, accel="cg", residuals=rj)
    x = ts.solve(b, tol=1e-10, maxiter=60, accel="cg", residuals=rt)
    assert_histories_match(rt, rj)
    assert len(rt) - 1 < 60
    assert np.linalg.norm(b - A @ x) <= 1e-9 * np.linalg.norm(b)


def test_rs_stride_decision(case):
    """``stride='auto'`` semicoarsens the anisotropic problem first and
    evens out deeper (the couplings rescale by 1/s^2), as the reference
    decides; an isotropic stencil coarsens every dim."""
    name, _, js, ts = case
    got = [i["strides"] for i in ts.setup_info["levels"]]
    assert got == [tuple(i["strides"]) for i in js.setup_info["levels"]]
    if name == "aniso_auto":
        # the reference's rule (tests/test_classical_device.py)
        assert got[0] in ((1, 2), (2, 1))
        assert got[-1] == (2, 2) or len(got) < 5
    elif name == "stride21":
        assert set(got) == {(2, 1)}
    else:
        assert all(s == (2,) * len(s) for s in got)


@pytest.fixture(scope="module")
def fd5():
    make, kw = CASES["fd5"]
    A = make()
    return A, jax_rs(A, dtype=jnp.float64, **kw), kw


def test_batched_rs_solve(fd5):
    """A K = 2 CG solve on the classical hierarchy: each lane its 1-D
    solve's count and history (the JAX package's 1-D counts)."""
    A, js, kw = fd5
    ts = pt.device_rs_setup(A, dtype=F64, device=CPU, **kw)
    B = np.random.default_rng(4).random((A.shape[0], 2))
    res = []
    X = ts.solve(B, tol=1e-8, maxiter=40, accel="cg", residuals=res)
    assert X.shape == B.shape
    for k in range(2):
        rj = []
        js.solve(B[:, k], tol=1e-8, maxiter=40, accel="cg", residuals=rj)
        assert_histories_match(np.asarray(res[k]), rj)
    r = np.linalg.norm(B - A @ X, axis=0) / np.linalg.norm(B, axis=0)
    assert (r <= 1e-8).all(), r


def test_from_jax_classical_solver(fd5):
    """The JAX classical hierarchy carried across (embedded transfers,
    jacobi_dyn smoothers) solves with the JAX solver's history."""
    A, js, _ = fd5
    ts = structured_solver_from_jax(js, CPU)
    assert ts.setup_info["family"] == "classical"
    assert isinstance(ts.hierarchy.levels[0].P, EmbeddedProlongator)
    b = np.random.default_rng(1).random(A.shape[0])
    rj, rt = [], []
    js.solve(b, tol=1e-10, maxiter=40, accel="cg", residuals=rj)
    ts.solve(b, tol=1e-10, maxiter=40, accel="cg", residuals=rt)
    assert_histories_match(rt, rj)


def test_no_grid_raises_item_13():
    """An operator that is not a grid stencil: the port routes it to its
    unstructured classical setups, as the reference does (the routes are
    held against the JAX package in
    tests/test_torch_unstructured_classical.py); a DIAMatrix without a
    grid raises the reference's ValueError."""
    n = 400
    M = sp.random(n, n, density=0.02, random_state=3, format="csr")
    M = (M + M.T + 10.0 * sp.eye(n)).tocsr()
    with pytest.raises(ValueError):
        pt.detect_grid(M)
    for setup, direct, family in (
            (pt.device_rs_setup, pt.device_unstructured_rs_setup, "rs"),
            (pt.device_air_setup, pt.device_unstructured_air_setup, "air")):
        # no negative coupling: AIR's 'min' strength finds no strong
        # connection and leaves the one dense level, as in the reference
        routed = setup(M, device=CPU, max_coarse=100)
        assert type(routed).__name__ == "DeviceMultilevelSolver"
        assert type(routed.hierarchy.levels[0].A).__name__ in (
            "WindowedELL", "DenseOperator")
        info = routed.setup_info["levels"]
        assert {lv["family"] for lv in info} == ({"rs"} if family == "rs"
                                                 else set())
        kw = dict(max_coarse=100, max_levels=12 if family == "rs" else 4)
        assert direct(M, device=CPU, **kw).setup_info == routed.setup_info
    D = pt.sparse.dia_from_scipy(jgal.poisson((8, 8), format="csr"),
                                 device=CPU)
    with pytest.raises(ValueError, match="grid= is required"):
        pt.device_rs_setup(D, device=CPU)
