"""The port's own rootnode and Ruge-Stuben host setups against the JAX
package's, on the CPU.

``pyamg_tpu_torch.rootnode_solver`` (2-D elasticity, 2x2 blocks, the
rigid-body modes truncated to the blocksize, symmetric strength, energy
smoothing) and ``ruge_stuben_solver`` (the reference's defaults:
classical strength, RS splitting, classical interpolation) are copies of
the reference setups for the options BASELINE configs 4 and 3 run.
Level for level they must give the reference's hierarchy bit for bit:
splittings, roots and C/F dofs, every pattern and every value of A (BSR
blocks too), P, R and B.  The device compile of either hierarchy must
then solve alike (bit for bit on the CPU), and the port's compile of its
RS hierarchy must take the JAX compile's GMRES steps.  The pieces
(block Gauss-Seidel at bs 2 and 3, the batched QR fit of 3 candidates,
the constraint projection, classical strength) are held to the
reference's one by one, and every unported option raises.
"""
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import pyamg_tpu  # noqa: E402
from pyamg_tpu import gallery as jg  # noqa: E402
from pyamg_tpu import strength as jstrength  # noqa: E402
from pyamg_tpu.aggregation import smooth as jsmooth  # noqa: E402
from pyamg_tpu.aggregation import tentative as jtentative  # noqa: E402
from pyamg_tpu.relaxation import relaxation as jrelax  # noqa: E402
from pyamg_tpu.util import utils as jutils  # noqa: E402

from pyamg_tpu_torch import (DeviceMultilevelSolver, compile_hierarchy,  # noqa: E402
                             diffusion_stencil_2d, linear_elasticity,
                             rootnode_solver, ruge_stuben_solver,
                             stencil_grid)
from pyamg_tpu_torch import strength as tstrength  # noqa: E402
from pyamg_tpu_torch.aggregation import smooth as tsmooth  # noqa: E402
from pyamg_tpu_torch.aggregation import tentative as ttentative  # noqa: E402
from pyamg_tpu_torch.relaxation import relaxation as trelax  # noqa: E402
from pyamg_tpu_torch.util import utils as tutils  # noqa: E402

C3_STENCIL = dict(epsilon=1e-3, theta=0.0, type="FD")
RS_GRIDS = [(64, 64), (40, 72)]


def _same(a, b):
    """Equal bit for bit: dense arrays, or sparse matrices of one format
    with the same structure arrays and values (BSR blocksize too)."""
    if sp.issparse(b):
        assert sp.issparse(a) and a.format == b.format, (a.format, b.format)
        assert a.shape == b.shape
        if b.format == "bsr":
            assert a.blocksize == b.blocksize
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


@pytest.fixture(scope="module")
def torch_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rootnode_pair():
    """Rootnode of elasticity 48^2 (4512 dofs) in both packages."""
    A, B = linear_elasticity((48, 48))
    Aj, Bj = jg.linear_elasticity((48, 48))
    return ((A, _quiet(rootnode_solver, A, B=B, strength="symmetric")),
            (Aj, _quiet(pyamg_tpu.rootnode_solver, Aj, B=Bj,
                        strength="symmetric")))


@pytest.fixture(scope="module", params=RS_GRIDS,
                ids=[f"{g[0]}x{g[1]}" for g in RS_GRIDS])
def rs_pair(request):
    """Ruge-Stuben of config 3's stencil in both packages."""
    grid = request.param
    A = stencil_grid(diffusion_stencil_2d(**C3_STENCIL), grid).tocsr()
    Aj = jg.stencil_grid(jg.diffusion_stencil_2d(**C3_STENCIL), grid).tocsr()
    return grid, (A, ruge_stuben_solver(A)), (Aj,
                                               pyamg_tpu.ruge_stuben_solver(Aj))


# (a) the gallery copies

@pytest.mark.parametrize("grid", [(48, 48), (17, 30)])
def test_linear_elasticity_is_the_reference(grid):
    A, B = linear_elasticity(grid)
    Aj, Bj = jg.linear_elasticity(grid)
    _same(A, Aj)
    _same(B, Bj)


@pytest.mark.parametrize("kw", [C3_STENCIL, dict(epsilon=0.1, theta=0.3,
                                                 type="FE")],
                         ids=["config3", "rotated_fe"])
def test_diffusion_stencil_grid_is_the_reference(kw):
    S = diffusion_stencil_2d(**kw)
    np.testing.assert_array_equal(S, jg.diffusion_stencil_2d(**kw))
    _same(stencil_grid(S, (33, 21)).tocsr(),
          jg.stencil_grid(jg.diffusion_stencil_2d(**kw), (33, 21)).tocsr())


# (b) the hierarchies, level for level

def test_rootnode_levels_are_the_reference(rootnode_pair):
    """Roots, C/F dofs, A (BSR 2x2 blocks on every level), P, R and B bit
    for bit; the smoother specs the reference's."""
    (_, mt), (_, mj) = rootnode_pair
    assert [lvl.A.shape[0] for lvl in mt.levels] == [
        lvl.A.shape[0] for lvl in mj.levels] == [4512, 512, 68, 8]
    for i, (lt, lj) in enumerate(zip(mt.levels, mj.levels)):
        assert lt.A.format == lj.A.format == "bsr", i
        _same(lt.A, lj.A)
        _same(lt.B, lj.B)
        if lj.P is None:
            assert lt.P is None
            continue
        for attr in ("P", "R", "Cnodes", "Cpts", "Fpts"):
            _same(getattr(lt, attr), getattr(lj, attr))
        assert lt.R_is_PT and lj.R_is_PT
        assert lt.presmoother_spec == lj.presmoother_spec == (
            "block_gauss_seidel", {"sweep": "symmetric"})
        assert lt.postsmoother_spec == lj.postsmoother_spec


def test_rs_levels_are_the_reference(rs_pair):
    """Splitting, A, P and R bit for bit on every level; the smoother
    specs the reference's."""
    _, (_, mt), (_, mj) = rs_pair
    assert len(mt.levels) == len(mj.levels) >= 6
    for lt, lj in zip(mt.levels, mj.levels):
        _same(lt.A, lj.A)
        if lj.P is None:
            assert lt.P is None
            continue
        for attr in ("P", "R", "splitting"):
            _same(getattr(lt, attr), getattr(lj, attr))
        assert lt.splitting.dtype == lj.splitting.dtype == np.int32
        assert lt.R_is_PT and lj.R_is_PT
        assert lt.presmoother_spec == lj.presmoother_spec == (
            "gauss_seidel", {"sweep": "symmetric"})
        assert lt.postsmoother_spec == lj.postsmoother_spec


def test_rootnode_keeps_the_references_extras():
    """keep=True records C, AggOp and T as the reference's; B beyond the
    blocksize is truncated with the reference's warning."""
    A, B = linear_elasticity((16, 16))
    Aj, Bj = jg.linear_elasticity((16, 16))
    with pytest.warns(UserWarning, match="truncating B from 3"):
        mt = rootnode_solver(A, B=B, strength="symmetric", keep=True)
    mj = _quiet(pyamg_tpu.rootnode_solver, Aj, B=Bj, strength="symmetric",
                keep=True)
    for lt, lj in zip(mt.levels[:-1], mj.levels[:-1]):
        for attr in ("C", "AggOp", "T", "P"):
            _same(getattr(lt, attr), getattr(lj, attr))


def test_rs_options_and_keep_are_the_reference():
    """The RS second pass, unmodified classical interpolation and
    keep=True (the strength matrix recorded) give the reference's levels
    bit for bit."""
    kw = dict(CF=("RS", {"second_pass": True}),
              interpolation=("classical", {"modified": False}), keep=True)
    A = stencil_grid(diffusion_stencil_2d(**C3_STENCIL), (24, 40)).tocsr()
    Aj = jg.stencil_grid(jg.diffusion_stencil_2d(**C3_STENCIL),
                         (24, 40)).tocsr()
    mt = ruge_stuben_solver(A, **kw)
    mj = pyamg_tpu.ruge_stuben_solver(Aj, **kw)
    assert len(mt.levels) == len(mj.levels) >= 4
    for lt, lj in zip(mt.levels[:-1], mj.levels[:-1]):
        for attr in ("A", "C", "P", "splitting"):
            _same(getattr(lt, attr), getattr(lj, attr))
    _same(mt.levels[-1].A, mj.levels[-1].A)


# (c) the compile of either hierarchy solves alike

def _history(ml, b, **kw):
    res = []
    x = DeviceMultilevelSolver(compile_hierarchy(
        ml, dtype=torch.float64, device="cpu")).solve(b, residuals=res, **kw)
    return x, res


def test_rootnode_compiles_solve_alike(rootnode_pair, torch_one_thread):
    """CG on the port's and the reference's rootnode hierarchy: the same
    history, bit for bit, to 1e-8."""
    (A, mt), (_, mj) = rootnode_pair
    b = np.random.default_rng(5).random(A.shape[0])
    kw = dict(tol=1e-8, maxiter=60, accel="cg")
    x, ht = _history(mt, b, **kw)
    _, hj = _history(mj, b, **kw)
    assert ht == hj and len(ht) > 5
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


def _rs_solves_alike(mt, mj, A, accel):
    b = np.random.default_rng(2).random(A.shape[0])
    kw = dict(tol=1e-8, maxiter=60, accel=accel)
    _, ht = _history(mt, b, **kw)
    _, hj = _history(mj, b, **kw)
    assert ht == hj and len(ht) > 3
    assert ht[-1] <= 1e-8 * ht[0]


def test_rs_compiles_solve_alike(rs_pair, torch_one_thread):
    """CG on the port's and the reference's RS hierarchy: the same
    history, bit for bit, to 1e-8."""
    _, (A, mt), (_, mj) = rs_pair
    _rs_solves_alike(mt, mj, A, "cg")


def test_rs_gmres_compiles_solve_alike(torch_one_thread):
    """GMRES likewise, on the non-square grid (its history is the left
    preconditioned residual's; at 64^2 GMRES is held to the JAX
    compile's below)."""
    A = stencil_grid(diffusion_stencil_2d(**C3_STENCIL), RS_GRIDS[1]).tocsr()
    Aj = jg.stencil_grid(jg.diffusion_stencil_2d(**C3_STENCIL),
                         RS_GRIDS[1]).tocsr()
    _rs_solves_alike(ruge_stuben_solver(A), pyamg_tpu.ruge_stuben_solver(Aj),
                     A, "gmres")


# (d) the port's compile against the JAX compile

def test_rs_gmres_takes_the_jax_steps(torch_one_thread):
    """float64 GMRES at 64^2: the port's compile of its own RS hierarchy
    and the JAX compile of the reference's have the same level forms and
    smoothers (multicolour GS, the same colourings and inverse diagonals)
    and take the same steps (count equal, histories at rtol 1e-10)."""
    import jax
    import jax.numpy as jnp

    from pyamg_tpu.engine import compile_hierarchy as jax_compile
    from pyamg_tpu.engine.solver import DeviceMultilevelSolver as JaxSolver

    jax.config.update("jax_enable_x64", True)
    A = stencil_grid(diffusion_stencil_2d(**C3_STENCIL), (64, 64)).tocsr()
    Aj = jg.stencil_grid(jg.diffusion_stencil_2d(**C3_STENCIL),
                         (64, 64)).tocsr()
    b = np.random.default_rng(2).random(A.shape[0])
    kw = dict(tol=1e-8, maxiter=60, accel="gmres")
    ht = compile_hierarchy(ruge_stuben_solver(A), dtype=torch.float64,
                           device="cpu")
    hj = jax_compile(pyamg_tpu.ruge_stuben_solver(Aj), dtype=jnp.float64)
    assert len(ht.levels) == len(hj.levels)
    for lt, lj in zip(ht.levels, hj.levels):
        assert type(lt.A).__name__ == type(lj.A).__name__
        assert (lt.n, lt.n_pad) == (lj.n, lj.n_pad)
        for st, sj in ((lt.pre, lj.pre), (lt.post, lj.post)):
            assert st.config == tuple(sj.config)
            for t, a in zip(st.arrays, sj.arrays):
                np.testing.assert_allclose(t.numpy(), np.asarray(a),
                                           rtol=1e-15, atol=0)
    assert ht.levels[0].pre.config[0] == "mcgs"
    rt, rj = [], []
    DeviceMultilevelSolver(ht).solve(b, residuals=rt, **kw)
    JaxSolver(hj).solve(b, residuals=rj, **kw)
    assert len(rt) == len(rj) > 3
    np.testing.assert_allclose(rt, rj, rtol=1e-10)


# (e) the unported options raise

def _small_elasticity():
    return linear_elasticity((12, 12))


def _small_c3():
    return stencil_grid(diffusion_stencil_2d(**C3_STENCIL), (16, 16)).tocsr()


@pytest.mark.parametrize("solver,kwargs", [
    ("rootnode", dict(strength="evolution")),         # the default
    ("rootnode", dict(symmetry="nonsymmetric")),
    ("rootnode", dict(smooth=("energy", {"krylov": "cgnr"}))),
    ("rootnode", dict(smooth=("energy", {"krylov": "gmres"}))),
    ("rootnode", dict(smooth=("energy", {"weighting": "block"}))),
    ("rootnode", dict(smooth=("energy", {"postfilter": {"theta": 0.1}}))),
    ("rootnode", dict(smooth=("jacobi", {}))),
    ("rootnode", dict(aggregate="naive")),
    ("rootnode", dict(strength=("symmetric", {"theta": 0.1}))),
    ("rootnode", dict(improve_candidates=("jacobi", {}))),
    ("rootnode", dict(improve_candidates="gauss_seidel")),
    ("rootnode", dict(strength="classical")),
    ("rootnode", dict(coarse_solver="splu")),
    ("ruge_stuben", dict(CF="PMIS")),
    ("ruge_stuben", dict(interpolation="direct")),
    ("ruge_stuben", dict(strength="evolution")),
    ("ruge_stuben", dict(strength="symmetric")),
    ("ruge_stuben", dict(coarse_solver="splu")),
])
def test_unported_options_raise(solver, kwargs):
    if solver == "rootnode":
        A, B = _small_elasticity()
        kw = dict(B=B[:, :2], strength="symmetric")
        kw.update(kwargs)
        call = lambda: rootnode_solver(A, **kw)       # noqa: E731
    else:
        A = _small_c3()
        call = lambda: ruge_stuben_solver(A, **kwargs)  # noqa: E731
    with pytest.raises(NotImplementedError, match="item 16"):
        call()


# (f) the pieces one by one

def _block_system(bs, seed):
    """A random diagonally dominant BSR operator of bs x bs blocks."""
    rng = np.random.default_rng(seed)
    nb = 40
    M = sp.random(nb, nb, density=0.15, random_state=seed, format="csr")
    M = (M + M.T + sp.eye(nb)).tocsr()
    A = sp.kron(M, np.ones((bs, bs))).tocsr()
    A.data = rng.standard_normal(A.nnz)
    A = (A + A.T).tocsr()
    A = A + sp.diags(np.abs(A).sum(axis=1).A.ravel() + 1.0)
    return A.tobsr(blocksize=(bs, bs)), rng


@pytest.mark.parametrize("bs", [2, 3])
@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
def test_block_gauss_seidel_is_the_reference(bs, sweep):
    A, rng = _block_system(bs, seed=bs)
    x0 = rng.standard_normal(A.shape[0])
    b = rng.standard_normal(A.shape[0])
    xt, xj = x0.copy(), x0.copy()
    trelax.block_gauss_seidel(A, xt, b, iterations=2, sweep=sweep)
    jrelax.block_gauss_seidel(A, xj, b, iterations=2, sweep=sweep)
    np.testing.assert_array_equal(xt, xj)
    assert not np.array_equal(xt, x0)


def test_fit_candidates_three_candidates_bs2():
    """The batched QR of 3 candidates on 2-dof nodes (aggregates of 1 to
    4 nodes, one node unaggregated, one aggregate of dependent
    candidates): T and the R factors bit for bit."""
    rng = np.random.default_rng(3)
    n_nodes, n_agg = 30, 9
    assign = np.concatenate([np.arange(n_agg), rng.integers(0, n_agg, n_nodes - n_agg)])
    rows = np.flatnonzero(np.arange(n_nodes) != 7)
    AggOp = sp.csr_matrix((np.ones(len(rows)), (rows, assign[rows])),
                          shape=(n_nodes, n_agg))
    B = rng.standard_normal((2 * n_nodes, 3))
    dep = np.flatnonzero(assign == 4)
    dofs = (2 * dep[:, None] + np.arange(2)).ravel()
    B[dofs, 2] = B[dofs, 0]                        # dependent on aggregate 4
    Tt, Bct = ttentative.fit_candidates(AggOp, B)
    Tj, Bcj = jtentative.fit_candidates(AggOp, B)
    _same(Tt, Tj)
    _same(Bct, Bcj)
    assert Tt.shape == (60, 27)


def test_satisfy_constraints_and_gram_inverses():
    """compute_BtBinv over a pattern and the projection U B = 0 row by
    row, bit for bit with the reference's; the projected U annihilates
    B."""
    A, B = linear_elasticity((10, 10))
    B = B[:, :2]
    pattern = sp.csr_matrix(A)
    pattern.data[:] = 1.0
    Gt = tutils.compute_BtBinv(B, pattern)
    Gj = jutils.compute_BtBinv(B, pattern)
    _same(Gt, Gj)
    U = sp.csr_matrix(A, copy=True)
    U.data = np.random.default_rng(4).standard_normal(U.nnz)
    Ut = tsmooth.satisfy_constraints(U.copy(), B, Gt)
    Uj = jsmooth.satisfy_constraints(U.copy(), B, Gj)
    _same(Ut, Uj)
    assert np.abs(Ut @ B).max() <= 1e-10 * np.abs(U @ B).max()


@pytest.mark.parametrize("theta,norm", [(0.25, "abs"), (0.5, "min"),
                                        (0.0, "abs")])
def test_classical_strength_is_the_reference(theta, norm):
    A = stencil_grid(diffusion_stencil_2d(epsilon=1e-2, theta=0.4,
                                          type="FE"), (20, 24)).tocsr()
    _same(tstrength.classical_strength_of_connection(A, theta, norm=norm),
          jstrength.classical_strength_of_connection(A, theta, norm=norm))


def test_symmetric_strength_of_bsr_is_the_reference():
    A, _ = linear_elasticity((20, 20))
    _same(tstrength.symmetric_strength_of_connection(A),
          jstrength.symmetric_strength_of_connection(A))


def test_rootnode_helpers_are_the_reference(rootnode_pair):
    """get_Cpt_params and scale_T on level 0's aggregation and candidates,
    bit for bit."""
    from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation

    (A, mt), _ = rootnode_pair
    AggOp, Cnodes = standard_aggregation(
        tstrength.symmetric_strength_of_connection(A))
    T, _ = ttentative.fit_candidates(AggOp, mt.levels[0].B)
    got = tutils.get_Cpt_params(A, Cnodes, AggOp, T)
    want = jutils.get_Cpt_params(A, Cnodes, AggOp, T)
    for key in want:
        _same(got[key], want[key])
    _same(tutils.scale_T(T, got["P_I"], got["I_F"]),
          jutils.scale_T(T, want["P_I"], want["I_F"]))


@pytest.mark.parametrize("k", [2, 3])
def test_block_diag_and_pinv_are_the_reference(k):
    """get_block_diag of a k x k BSR operator and pinv_array of a batch of
    k x k Gram blocks (one singular) bit for bit."""
    from pyamg_tpu.util.linalg import pinv_array as jpinv

    from pyamg_tpu_torch.util.linalg import pinv_array as tpinv

    A, rng = _block_system(k, seed=10 + k)
    _same(tutils.get_block_diag(A, k), jutils.get_block_diag(A, k))
    G = rng.standard_normal((50, k + 1, k))
    G[0, :, -1] = G[0, :, 0]
    G = np.einsum("nmi,nmj->nij", G, G)
    _same(tpinv(G.copy()), jpinv(G.copy()))
