"""The port's own host smoothed-aggregation setup against the JAX package's,
on the CPU.

``pyamg_tpu_torch.smoothed_aggregation_solver`` is a copy of the reference
setup for config 1's options (symmetric strength, standard aggregation,
block Gauss-Seidel candidate improvement, Jacobi prolongation smoothing,
the native C++ subset).  Level for level it must give the reference's
operators, candidates, prolongation recipe and spectral radii, and the
device compile of either must solve alike.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import pyamg_tpu  # noqa: E402
from pyamg_tpu.gallery import poisson as jax_poisson  # noqa: E402

from pyamg_tpu_torch import (DeviceMultilevelSolver, MultilevelSolver,  # noqa: E402
                             compile_hierarchy, poisson,
                             smoothed_aggregation_solver)
from pyamg_tpu_torch.amg_core import _loader  # noqa: E402
from pyamg_tpu_torch.gallery import stencil_grid  # noqa: E402
from pyamg_tpu_torch.relaxation.smoothing import rho_D_inv_A  # noqa: E402

CONFIG1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
               postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
TOL = 1e-12


def _rel(a, b):
    a = a.toarray() if sp.issparse(a) else np.asarray(a)
    b = b.toarray() if sp.issparse(b) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module", params=[(64, 64), (128, 128)],
                ids=["64x64", "128x128"])
def pair(request):
    grid = request.param
    A = poisson(grid, format="csr")
    return (grid, smoothed_aggregation_solver(A, **CONFIG1),
            pyamg_tpu.smoothed_aggregation_solver(
                jax_poisson(grid, format="csr"), **CONFIG1))


@pytest.mark.parametrize("grid,kind", [((33, 70), "FD"), ((9, 12, 7), "FD"),
                                       ((20, 24), "FE"), ((50,), "FD")])
def test_poisson_is_the_reference(grid, kind):
    got = poisson(grid, format="csr", type=kind)
    want = jax_poisson(grid, format="csr", type=kind)
    assert got.shape == want.shape and (got != want).nnz == 0


def test_stencil_grid_matches_poisson():
    S = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=float)
    assert (stencil_grid(S, (17, 23)) != poisson((17, 23))).nnz == 0


def test_levels_match_the_reference(pair):
    """A, P, R and B level for level, the _sa_factor recipe (dinv, scaled
    omega, T, degree) and rho(D^-1 A), each to rel 1e-12."""
    _, mt, mj = pair
    assert isinstance(mt, MultilevelSolver)
    assert len(mt.levels) == len(mj.levels) >= 3
    for i, (lt, lj) in enumerate(zip(mt.levels, mj.levels)):
        assert lt.A.shape == lj.A.shape
        assert _rel(lt.A, lj.A) <= TOL, i
        assert _rel(lt.B, lj.B) <= TOL, i
        if lj.P is None:
            assert lt.P is None and lt.R is None
            continue
        for a in ("P", "R"):
            assert getattr(lt, a).shape == getattr(lj, a).shape
            assert _rel(getattr(lt, a), getattr(lj, a)) <= TOL, (i, a)
        ft, fj = lt.P._sa_factor, lj.P._sa_factor
        assert ft["degree"] == fj["degree"] == 1
        assert abs(ft["omega"] - fj["omega"]) <= TOL * abs(fj["omega"])
        assert _rel(ft["dinv"], fj["dinv"]) <= TOL
        assert _rel(ft["T"], fj["T"]) <= TOL
        assert lt.R_is_PT and lj.R_is_PT
        assert abs(rho_D_inv_A(lt.A) - lj.A._rho_D_inv) <= TOL * lj.A._rho_D_inv
        assert lt.presmoother_spec == lj.presmoother_spec
        assert lt.postsmoother_spec == lj.postsmoother_spec


def test_compiled_hierarchies_solve_alike(pair):
    """compile_hierarchy of either setup: the same float64 CG history on
    the CPU, rtol 1e-10."""
    grid, mt, mj = pair
    b = np.random.default_rng(2).random(int(np.prod(grid)))
    hists = []
    for ml in (mt, mj):
        res = []
        DeviceMultilevelSolver(compile_hierarchy(
            ml, dtype=torch.float64, device="cpu")).solve(
                b, tol=1e-10, maxiter=40, accel="cg", residuals=res)
        hists.append(res)
    assert len(hists[0]) == len(hists[1]) > 5
    np.testing.assert_allclose(hists[0], hists[1], rtol=1e-10)
    assert hists[0][-1] < 1e-10 * np.linalg.norm(b)


@pytest.mark.parametrize("kwargs,match", [
    (dict(strength="classical"), "item 16"),
    (dict(strength=("symmetric", {"theta": 0.1}), aggregate="naive"),
     "item 16"),
    (dict(smooth=("energy", {})), "item 16"),
    (dict(smooth=("jacobi", {"weighting": "local"})), "item 16"),
    (dict(improve_candidates=("jacobi", {})), "item 16"),
    (dict(B=np.ones((400, 2))), "item 16"),
    (dict(keep=True), "item 16"),
    (dict(symmetry="nonsymmetric"), "item 16"),
    (dict(coarse_solver="splu"), "item 16"),
    ("bsr", "item 16"),
])
def test_unported_options_raise(kwargs, match):
    A = poisson((20, 20), format="csr")
    if kwargs == "bsr":
        A, kwargs = A.tobsr(blocksize=(2, 2)), {}
    kw = dict(CONFIG1, max_coarse=10)
    kw.update(kwargs)
    with pytest.raises(NotImplementedError, match=match):
        smoothed_aggregation_solver(A, **kw)


@pytest.mark.parametrize("kwargs", [
    dict(presmoother=("block_gauss_seidel", {"blocksize": 2})),
    dict(postsmoother=("block_jacobi", {"blocksize": 2}))],
    ids=["block_gauss_seidel", "block_jacobi"])
def test_block_smoother_specs_match_reference(kwargs):
    """The block smoothers with 2x2 blocks on a scalar operator: the
    port's setup gives the reference's levels, specs and block Jacobi's
    rho(block-D^-1 A) cache (rel 1e-12), and its compile the smoothers of
    the reference hierarchy's compile (block multicolour GS, block
    Jacobi), in float64 to 1e-15."""
    import jax.numpy as jnp

    from pyamg_tpu.engine import compile_hierarchy as jax_compile

    grid = (24, 24)
    kw = dict(CONFIG1, max_coarse=10)
    kw.update(kwargs)
    mt = smoothed_aggregation_solver(poisson(grid, format="csr"), **kw)
    mj = pyamg_tpu.smoothed_aggregation_solver(
        jax_poisson(grid, format="csr"), **kw)
    assert len(mt.levels) == len(mj.levels) >= 3
    for lt, lj in zip(mt.levels, mj.levels):
        assert _rel(lt.A, lj.A) <= TOL
        for spec in ("presmoother_spec", "postsmoother_spec"):
            assert getattr(lt, spec, None) == getattr(lj, spec, None)
        rho_j = getattr(lj.A, "_rho_block_D_inv", None)
        if rho_j is not None:
            assert abs(lt.A._rho_block_D_inv - rho_j) <= TOL * rho_j
    ht = compile_hierarchy(mt, dtype=torch.float64, device="cpu")
    hj = jax_compile(mj, dtype=jnp.float64)
    kinds = set()
    for lt, lj in zip(ht.levels, hj.levels):
        for st, sj in ((lt.pre, lj.pre), (lt.post, lj.post)):
            assert st.config == tuple(sj.config)
            kinds.add(st.config[0])
            for a, t in zip(sj.arrays, st.arrays):
                np.testing.assert_allclose(t.numpy(), np.asarray(a),
                                           rtol=1e-15, atol=0)
    assert kinds & {"block_mcgs", "block_jacobi"}


def test_default_smoothers_are_config1():
    """With no smoother arguments the setup records the reference's
    default, symmetric block Gauss-Seidel, on every level, and builds
    config 1's hierarchy (the smoothers do not change it)."""
    A = poisson((20, 20), format="csr")
    got = smoothed_aggregation_solver(A, max_coarse=10)
    want = smoothed_aggregation_solver(A, max_coarse=10, **CONFIG1)
    ref = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=10)
    assert len(got.levels) == len(want.levels) >= 2
    for lg, lw, lr in zip(got.levels[:-1], want.levels[:-1], ref.levels):
        assert lg.presmoother_spec == lg.postsmoother_spec == (
            "block_gauss_seidel", {"sweep": "symmetric"}) == (
                lr.presmoother_spec)
        assert (lg.P != lw.P).nnz == 0 and (lg.A != lw.A).nnz == 0


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises; nothing falls back to NumPy."""
    bad = tmp_path / "amg_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_loader, "_SRC", bad)
    monkeypatch.setattr(_loader, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_loader, "_native", None)
    with pytest.raises(RuntimeError, match="amg_core build failed"):
        _loader.native()
