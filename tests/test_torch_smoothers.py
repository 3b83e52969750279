"""The port's smoother compile and the solves it drives, against the JAX
package, on the CPU.

- The compile: one host hierarchy built by ``pyamg_tpu.
  smoothed_aggregation_solver`` with each smoother spec, compiled by both
  packages: the same configs, the same colours, inverse diagonals,
  weights and coefficients to 1e-15, the same warnings (counterparts of
  ``tests/test_multilevel.py`` and ``tests/test_baseline_configs.py``).
- Config 2 at 24^3, float64: 3-D 7-point Poisson, SA with symmetric
  Gauss-Seidel, the hierarchy cut at 1024 rows (multicolour GS with 6
  colours at level 0, the degree-4 Chebyshev fallback at level 1, which
  needs 19 colours).  The stationary W-cycle to 1e-8 takes the
  reference's 12 iterations; W-cycle CG the reference's count; a K = 4
  lane solve takes each lane's 1-D count; the JAX hierarchy carried
  across (``hierarchy_from_jax``) solves alike.
- The device-built setups with Chebyshev and Richardson smoothers
  (``device_sa_setup``, ``device_unstructured_sa_setup``; Chebyshev before,
  Richardson after, so BiCGStab): the same smoother tensors, counts and
  histories (within 1e-8) as the JAX setups.
- Row sharding keeps every smoother array whole but the per-row ones.

Histories: CG to rtol 1e-10.  The stationary W-cycle's entries agree to
rtol 1e-10, and below that to the round-off of forming b - A x (the two
packages sum the SpMVs in other orders): atol eps (||b|| + ||A||_1 ||x||),
about 4e-14 of its first entry; the counts are equal.
"""
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pyamg_tpu  # noqa: E402
import pyamg_tpu.engine.unstructured_setup as jus  # noqa: E402
from pyamg_tpu.engine import DeviceMultilevelSolver as JaxSolver  # noqa: E402
from pyamg_tpu.engine import compile_hierarchy as jax_compile  # noqa: E402
from pyamg_tpu.engine import device_sa_setup as jax_device_sa_setup  # noqa: E402
from pyamg_tpu.engine.hierarchy import \
    _windowed_schwarz_blocks as jax_schwarz_blocks  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402
from pyamg_tpu.relaxation.smoothing import change_smoothers  # noqa: E402

import pyamg_tpu_torch as pt  # noqa: E402
from pyamg_tpu_torch import (DeviceMultilevelSolver,  # noqa: E402
                             compile_hierarchy, device_sa_setup,
                             device_unstructured_sa_setup,
                             hierarchy_from_jax)
from pyamg_tpu_torch.engine import relaxation as rel  # noqa: E402
from pyamg_tpu_torch.engine.hierarchy import \
    _windowed_schwarz_blocks  # noqa: E402
from pyamg_tpu_torch.parallel.partition import (SolverMesh,  # noqa: E402
                                                _shard_smoother)

CPU = "cpu"
GS_SYM = ("gauss_seidel", {"sweep": "symmetric"})

SPECS = {
    "gs_forward": ("gauss_seidel", {}),
    "gs_symmetric": ("gauss_seidel", {"sweep": "symmetric",
                                      "iterations": 2}),
    "sor": ("sor", {"omega": 1.2, "sweep": "backward"}),
    "bgs_default": ("block_gauss_seidel", {"sweep": "symmetric"}),
    "block_jacobi": ("block_jacobi", {"omega": 0.8}),
    "jacobi": ("jacobi", {"omega": 4.0 / 3.0}),
    "jacobi_norho": ("jacobi", {"omega": 0.6, "withrho": False}),
    "richardson": ("richardson", {"omega": 0.9, "iterations": 2}),
    "chebyshev": ("chebyshev", {"degree": 4, "lower_bound": 0.05}),
    "polynomial": ("polynomial", {"coefficients": [-0.1, 0.4, 1.1]}),
    "jacobi_ne": ("jacobi_ne", {"omega": 0.5}),
    "gs_ne": ("gauss_seidel_ne", {"sweep": "symmetric"}),
    "gs_nr": ("gauss_seidel_nr", {}),
    "schwarz": ("schwarz", {}),
    "sb_schwarz": ("strength_based_schwarz", {"sweep": "symmetric"}),
    "gmres": ("gmres", {}),
    "none": None,
}


@pytest.fixture(autouse=True, scope="module")
def _x64_one_thread():
    """float64 JAX, and one torch thread: the port's CPU twins run many
    small ops, and the test workers share the cores."""
    jax.config.update("jax_enable_x64", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _compile_both(ml, **kw):
    """(JAX hierarchy, port hierarchy, JAX warnings, port warnings)."""
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        hj = jax_compile(ml, dtype=jnp.float64, **kw)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        ht = compile_hierarchy(ml, dtype=torch.float64, device=CPU, **kw)
    return hj, ht, [str(w.message) for w in wj], [str(w.message) for w in wt]


def _assert_same_smoother(js, ts):
    assert len(js.config) == len(ts.config)
    for a, b in zip(js.config, ts.config):
        if isinstance(a, float):
            assert b == pytest.approx(a, rel=1e-15, abs=0), (js.config,
                                                             ts.config)
        elif isinstance(a, tuple):
            np.testing.assert_allclose(b, a, rtol=1e-15, atol=0)
        else:
            assert a == b
    assert len(js.arrays) == len(ts.arrays)
    for a, b in zip(js.arrays, ts.arrays):
        a = np.asarray(a)
        assert b.shape == a.shape
        if a.dtype.kind in "iu":
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-15, atol=0)


@pytest.fixture(scope="module")
def A64():
    return poisson((64, 64), format="csr")


@pytest.fixture(scope="module")
def ml64(A64):
    """One reference hierarchy; each test binds its smoothers with the
    reference's ``change_smoothers`` (a copy of A: the reference's setup
    keeps A itself as level 0's operator and caches its spectral radii
    there)."""
    return pyamg_tpu.smoothed_aggregation_solver(A64.copy(), max_coarse=100)


@pytest.mark.parametrize("name", list(SPECS))
def test_compile_matches_reference(ml64, name):
    spec = SPECS[name]
    ml = change_smoothers(ml64, spec, spec)
    hj, ht, wj, wt = _compile_both(ml)
    assert wj == wt
    for lj, lt in zip(hj.levels, ht.levels):
        _assert_same_smoother(lj.pre, lt.pre)
        _assert_same_smoother(lj.post, lt.post)


@pytest.mark.parametrize("name", ["gs_symmetric", "richardson",
                                  "chebyshev"])
def test_port_setup_records_the_reference_specs(A64, name):
    """The port's own host setup resolves each spec as the reference's
    does (the same records and spectral-radius caches), so its compile is
    the reference's."""
    spec = SPECS[name]
    mlj = pyamg_tpu.smoothed_aggregation_solver(A64.copy(), max_coarse=100,
                                                presmoother=spec,
                                                postsmoother=spec)
    mlt = pt.smoothed_aggregation_solver(A64, max_coarse=100,
                                         presmoother=spec, postsmoother=spec)
    for lj, lt in zip(mlj.levels[:-1], mlt.levels[:-1]):
        assert lt.presmoother_spec == lj.presmoother_spec
        for cache in ("_rho", "_rho_D_inv"):
            assert getattr(lt.A, cache, None) == getattr(lj.A, cache, None)
    hj = jax_compile(mlj, dtype=jnp.float64)
    ht = compile_hierarchy(mlt, dtype=torch.float64, device=CPU)
    for lj, lt in zip(hj.levels, ht.levels):
        _assert_same_smoother(lj.pre, lt.pre)


def test_default_spec_compiles_to_multicolor_gs(A64):
    ml = pt.smoothed_aggregation_solver(A64, max_coarse=100)
    h = compile_hierarchy(ml, device=CPU)
    assert h.levels[0].pre.config[:3] == ("mcgs", 5, "symmetric")


def test_setup_raises_as_the_reference():
    A = poisson((20, 20), format="csr")
    for mod in (pyamg_tpu, pt):
        with pytest.raises(ValueError, match="splitting"):
            mod.smoothed_aggregation_solver(A, presmoother="cf_jacobi")
        with pytest.raises(ValueError, match="unknown smoother"):
            mod.smoothed_aggregation_solver(A, presmoother="bogus")
        with pytest.raises(ValueError, match="coefficients"):
            mod.smoothed_aggregation_solver(A, presmoother="polynomial")


def test_cf_smoothers_raise_at_compile():
    """Without a C/F splitting both compiles raise the reference's
    ValueError; with one, cf_jacobi / fc_jacobi compile to the masked
    Jacobi with the JAX compile's masks (in its order), iteration counts,
    inverse diagonal and weight, and smooth to its iterate (1e-12)."""
    ml = pyamg_tpu.smoothed_aggregation_solver(
        poisson((48, 48), format="csr"), max_coarse=100,
        presmoother="jacobi", postsmoother="jacobi")
    for lvl in ml.levels[:-1]:
        lvl.presmoother_spec = ("cf_jacobi", {})
    with pytest.raises(ValueError, match="splitting"):
        jax_compile(ml)
    with pytest.raises(ValueError, match="splitting"):
        compile_hierarchy(ml, device=CPU)
    for lvl in ml.levels[:-1]:
        lvl.splitting = np.arange(lvl.A.shape[0]) % 3 == 0
        lvl.postsmoother_spec = ("fc_jacobi", {"omega": 0.7,
                                               "f_iterations": 2,
                                               "iterations": 2})
    hj = jax_compile(ml, dtype=jnp.float64)
    ht = compile_hierarchy(ml, dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(6)
    for lj, lt in zip(hj.levels[:-1], ht.levels[:-1]):
        for sj, st in ((lj.pre, lt.pre), (lj.post, lt.post)):
            assert st.config == tuple(sj.config)
            assert st.config[0] == "masked_jacobi"
            np.testing.assert_allclose(st.arrays[0].numpy(),
                                       np.asarray(sj.arrays[0]), rtol=1e-15)
            for mt, mj in zip(st.arrays[1:], sj.arrays[1:], strict=True):
                assert mt.dtype == torch.bool
                np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
            x, b = rng.random((2, lt.n_pad))
            want = np.asarray(sj(lj.A, jnp.asarray(x), jnp.asarray(b)))
            got = st(lt.A, torch.as_tensor(x), torch.as_tensor(b)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max())


def test_schwarz_blocks_match_reference(A64):
    got = _windowed_schwarz_blocks(A64, 5120, 16, 8)
    np.testing.assert_allclose(got, jax_schwarz_blocks(A64, 5120, 16, 8),
                               rtol=1e-13, atol=1e-13)


# ---------------------------------------------------------------------------
# config 2 at 24^3, float64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def config2():
    A = poisson((24, 24, 24), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, presmoother=GS_SYM,
                                               postsmoother=GS_SYM)
    hj, ht, wj, wt = _compile_both(ml, coarse_cutoff=1024)
    b = np.random.default_rng(1).random(A.shape[0])
    return A, hj, ht, b


def test_config2_compile_matches_reference(config2):
    _, hj, ht, _ = config2
    assert [lvl.pre.config[0] for lvl in ht.levels] == [
        "mcgs", "poly", "identity"]
    assert ht.levels[0].pre.config[1] == 6
    for lj, lt in zip(hj.levels, ht.levels):
        _assert_same_smoother(lj.pre, lt.pre)


def _histories(hj, ht, b, **kw):
    rj, rt = [], []
    JaxSolver(hj).solve(b, residuals=rj, **kw)
    DeviceMultilevelSolver(ht).solve(b, residuals=rt, **kw)
    return np.asarray(rj), np.asarray(rt)


def test_config2_stationary_w_cycle(config2):
    A, hj, ht, b = config2
    kw = dict(tol=1e-8, maxiter=30, cycle="W", accel=None)
    rj, rt = [], []
    JaxSolver(hj).solve(b, residuals=rj, **kw)
    x = DeviceMultilevelSolver(ht).solve(b, residuals=rt, **kw)
    assert len(rj) - 1 == len(rt) - 1 == 12
    norm_a = abs(A).sum(axis=0).max()
    atol = np.finfo(np.float64).eps * (np.linalg.norm(b)
                                       + norm_a * np.linalg.norm(x))
    np.testing.assert_allclose(rt, rj, rtol=1e-10, atol=atol)
    assert rt[-1] <= 1e-8 * np.linalg.norm(b)


def test_config2_w_cycle_cg(config2):
    _, hj, ht, b = config2
    rj, rt = _histories(hj, ht, b, tol=1e-8, maxiter=30, cycle="W",
                        accel="cg")
    assert len(rj) == len(rt)
    np.testing.assert_allclose(rt, rj, rtol=1e-10)


def test_config2_lanes_take_their_1d_counts(config2):
    A, _, ht, b = config2
    solver = DeviceMultilevelSolver(ht)
    B = np.random.default_rng(4).random((A.shape[0], 4))
    B[:, 0] = b
    kw = dict(tol=1e-8, maxiter=30, cycle="W", accel="cg")
    res = []
    X = solver.solve(B, residuals=res, **kw)
    for j in range(B.shape[1]):
        r1 = []
        x1 = solver.solve(B[:, j], residuals=r1, **kw)
        assert len(res[j]) == len(r1)
        np.testing.assert_allclose(X[:, j], x1, rtol=1e-10,
                                   atol=1e-10 * np.abs(x1).max())


def test_config2_hierarchy_from_jax_solves_alike(config2):
    _, hj, ht, b = config2
    hc = hierarchy_from_jax(hj, CPU)
    for lc, lt in zip(hc.levels, ht.levels):
        assert lc.pre.config == lt.pre.config
        for a, c in zip(lc.pre.arrays, lt.pre.arrays):
            assert a.dtype == c.dtype and torch.equal(a, c)
    kw = dict(tol=1e-8, maxiter=30, cycle="W", accel="cg")
    rc, rt = [], []
    DeviceMultilevelSolver(hc).solve(b, residuals=rc, **kw)
    DeviceMultilevelSolver(ht).solve(b, residuals=rt, **kw)
    np.testing.assert_array_equal(rc, rt)


def test_hierarchy_from_jax_raises_on_block_smoothers(ml64):
    """A JAX hierarchy with block Jacobi (2x2 blocks) carries across: the
    port's compile of the same host hierarchy gives its smoothers, and
    the carried hierarchy its CG history (rtol 1e-10)."""
    spec = ("block_jacobi", {"blocksize": 2})
    ml = change_smoothers(ml64, spec, spec)
    hj = jax_compile(ml, dtype=jnp.float64)
    assert hj.levels[0].pre.config[0] == "block_jacobi"
    hc = hierarchy_from_jax(hj, CPU)
    ht = compile_hierarchy(ml, dtype=torch.float64, device=CPU)
    for lj, lc, lt in zip(hj.levels, hc.levels, ht.levels):
        _assert_same_smoother(lj.pre, lc.pre)
        _assert_same_smoother(lj.pre, lt.pre)
    b = np.random.default_rng(6).random(ml.levels[0].A.shape[0])
    rj, rc = [], []
    kw = dict(tol=1e-8, maxiter=40, accel="cg")
    JaxSolver(hj).solve(b, residuals=rj, **kw)
    DeviceMultilevelSolver(hc).solve(b, residuals=rc, **kw)
    assert len(rc) == len(rj) > 3
    np.testing.assert_allclose(rc, rj, rtol=1e-10)


# ---------------------------------------------------------------------------
# the device-built setups with Chebyshev and Richardson smoothers
# ---------------------------------------------------------------------------

# one setup each, Chebyshev before and Richardson after (one JAX program
# each); the cycle is then not symmetric, so the solve is BiCGStab
DEVICE_SMOOTHERS = dict(presmoother=("chebyshev", {"degree": 3}),
                        postsmoother=("richardson", {"omega": 1.0}))
SOLVE = dict(tol=1e-8, maxiter=60, accel="bicgstab")


def _assert_dyn_smoothers(J, T):
    for lj, lt in zip(J.hierarchy.levels[:-1], T.hierarchy.levels[:-1]):
        for sj, st, kind in ((lj.pre, lt.pre, "poly_dyn"),
                             (lj.post, lt.post, "richardson_dyn")):
            assert st.config == sj.config == (kind, 1)
            np.testing.assert_allclose(st.arrays[0].numpy(),
                                       np.asarray(sj.arrays[0]), rtol=1e-9)


def test_device_sa_setup_smoothers_match_reference():
    grid = (32, 32)
    A = poisson(grid, format="csr")
    kw = dict(grid=grid, max_coarse=200, **DEVICE_SMOOTHERS)
    J = jax_device_sa_setup(A, dtype=jnp.float64, **kw)
    T = device_sa_setup(A, dtype=torch.float64, device=CPU, **kw)
    _assert_dyn_smoothers(J, T)
    b = np.ones(A.shape[0])
    rj, rt = [], []
    J.solve(b, residuals=rj, **SOLVE)
    T.solve(b, residuals=rt, **SOLVE)
    assert len(rj) == len(rt) and rt[-1] < 1e-8 * rt[0]
    np.testing.assert_allclose(rt, rj, rtol=1e-8)


def _fem(nx):
    A = sp.csr_matrix(pt.gradgradform(*pt.regular_triangle_mesh(nx, nx)))
    return (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()


def test_unstructured_setup_smoothers_match_reference():
    A = _fem(16)
    kw = dict(max_coarse=60, **DEVICE_SMOOTHERS)
    J = jus.device_unstructured_sa_setup(A, dtype=jnp.float64, **kw)
    T = device_unstructured_sa_setup(A, dtype=torch.float64, device=CPU,
                                     **kw)
    _assert_dyn_smoothers(J, T)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rj, rt = [], []
    J.solve(jnp.asarray(b), residuals=rj, **SOLVE)
    T.solve(b, residuals=rt, **SOLVE)
    assert len(rj) == len(rt) and rt[-1] < 1e-8 * rt[0]
    np.testing.assert_allclose(rt, rj, rtol=1e-8)


# ---------------------------------------------------------------------------
# row sharding of the smoother arrays
# ---------------------------------------------------------------------------

def test_shard_smoother_keeps_non_row_arrays_whole():
    """Only per-row arrays are cut to the rank's block: a Chebyshev
    coefficient stack of length 3 stays whole on rank 1 of 2 (cutting it
    by rows, as every 1-D array once was, left one coefficient), as does
    a 0-d weight; dinv and the colours are cut."""
    mesh = SolverMesh(rank=1, world=2, device=torch.device(CPU))
    coef = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)
    poly = _shard_smoother(rel.polynomial_dyn(coef), mesh, 2)
    assert torch.equal(poly.arrays[0], coef)
    dinv = torch.arange(8, dtype=torch.float64)
    omega = torch.tensor(0.7, dtype=torch.float64)
    jac = _shard_smoother(rel.jacobi_dyn(dinv, omega), mesh, 2)
    assert torch.equal(jac.arrays[0], dinv[4:]) and jac.arrays[1] is omega
    colors = torch.tensor([0, 1, 0, 1, 0, 1, -1, -1], dtype=torch.int32)
    gs = _shard_smoother(rel.multicolor_gs(dinv, colors, 2), mesh, 2)
    assert torch.equal(gs.arrays[1], colors[4:])
    assert gs.color_dinv.shape == (2, 4)
    rich = _shard_smoother(rel.richardson_dyn(omega), mesh, 2)
    assert rich.arrays[0] is omega


@pytest.mark.parametrize("sm", [
    rel.jacobi_ne(torch.ones(8), 0.5), rel.jacobi_nr(torch.ones(8), 0.5)],
    ids=["jacobi_ne", "jacobi_nr"])
def test_shard_smoother_cuts_cimmino_norms(sm):
    """The Cimmino sweeps shard on a world of 2: their inverse row
    (column) norms cut by rows, their A^T coming from the sharded
    operator."""
    mesh = SolverMesh(rank=1, world=2, device=torch.device(CPU))
    cut = _shard_smoother(sm, mesh, 2)
    assert cut.config == sm.config
    assert torch.equal(cut.arrays[0], sm.arrays[0][4:])


@pytest.mark.parametrize("sm", [
    rel.windowed_schwarz(torch.ones(1, 16, 16), 16, 8)], ids=["win_schwarz"])
def test_shard_smoother_cuts_schwarz_windows_or_raises(sm):
    """Windowed Schwarz shards on a world of 2: it cuts its windows by
    their starts, and raises ValueError where the windows cannot split
    over the blocks (one window of stride 8 over 2 blocks)."""
    mesh = SolverMesh(rank=1, world=2, device=torch.device(CPU))
    with pytest.raises(ValueError, match="stride 8"):
        _shard_smoother(sm, mesh, 2)
    blocks = torch.rand(4, 16, 16, dtype=torch.float64)
    cut = _shard_smoother(rel.windowed_schwarz(blocks, 16, 8), mesh, 2)
    assert torch.equal(cut.arrays[0], blocks[2:])
