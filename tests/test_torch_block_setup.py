"""The port's block / multi-candidate device SA setup
(``engine/block_setup.py``) and adaptive SA against the JAX package, on
the CPU (the counterpart of ``tests/test_block_setup.py``).

- The batched small-matrix algebra: Cholesky, triangular inverse and SPD
  inverse against numpy and the JAX functions (m = 1..4, rtol 1e-12), an
  all-zero block giving zeros, not NaN.
- m = 1, bs = 1 against the port's own ``device_sa_setup``: the same CG
  history (rtol 1e-8).
- The tentative fit: per-aggregate Q^T Q = I and R^T R = G, and Q and R
  equal to the JAX fit (rtol 1e-12).
- Elasticity (32 x 31 free nodes, 2x2 blocks, three rigid-body modes) in
  float64 and mixed precision, and Poisson 48^2 with m = 2: JAX's level
  sizes, block sizes and diagonal counts; float64 CG histories to rtol
  1e-8 of JAX's (the packages sum the block products in other orders) and
  its count; the mixed solve's count, and its history to rtol 1e-3 (its
  float32 cycle rounds in another order: 1.6e-4 apart at most), true
  relres <= 1e-8.
- A JAX hierarchy carried across (``block_solver_from_jax``) solves with
  the JAX history (rtol 1e-10).
- Bad inputs raise, and so does a 2-D ``b`` on the block solver.
- ``device_adaptive_sa_setup`` with ``stages=2`` on Poisson 48^2: the
  candidates, levels and CG history of the JAX setup (rtol 1e-6: the
  candidates pass through six float64 cycles, each summed in another
  order).

Each JAX setup is built once per module: JAX's compile of the block
pipeline is most of this file's time.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyamg_tpu.engine import \
    device_adaptive_sa_setup as jax_adaptive  # noqa: E402
from pyamg_tpu.engine import device_sa_setup_block as jax_block  # noqa: E402
from pyamg_tpu.engine import block_setup as jbs  # noqa: E402
from pyamg_tpu.gallery import linear_elasticity as jax_elasticity  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402

import pyamg_tpu_torch as pt  # noqa: E402
from pyamg_tpu_torch import (BlockDIAMatrix,  # noqa: E402
                             BlockStructuredDeviceSolver,
                             block_solver_from_jax, device_adaptive_sa_setup,
                             device_sa_setup, device_sa_setup_block)
from pyamg_tpu_torch.engine import block_setup as tbs  # noqa: E402
from pyamg_tpu_torch.engine import relaxation as rel  # noqa: E402

CPU = "cpu"
F64 = torch.float64
HIST_RTOL = 1e-8
MIXED_RTOL = 1e-3
ELAST_GRID = (32, 31)
POISSON_GRID = (48, 48)
SOLVE = dict(tol=1e-8, maxiter=100, accel="cg")
MIXED = dict(tol=1e-9, maxiter=100, accel="cg", precision="mixed")


@pytest.fixture(autouse=True, scope="module")
def _x64_one_thread():
    """float64 JAX, and one torch thread (the test workers share the
    cores)."""
    jax.config.update("jax_enable_x64", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the batched small-matrix algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_chol_tri_inv_spd_inv_goldens(m):
    rng = np.random.default_rng(m)
    X = rng.standard_normal((12, m, m))
    G = np.einsum("nij,nkj->nik", X, X) + 3 * np.eye(m)
    L = tbs._chol_small(torch.as_tensor(G)).numpy()
    Li = tbs._tri_inv_small(torch.as_tensor(L)).numpy()
    Ginv = tbs._spd_inv_small(torch.as_tensor(G)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(G), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(Li @ L, np.broadcast_to(np.eye(m), L.shape),
                               atol=1e-12)
    np.testing.assert_allclose(Ginv @ G, np.broadcast_to(np.eye(m), G.shape),
                               atol=1e-11)
    for got, fn, arg in ((L, jbs._chol_small, G), (Li, jbs._tri_inv_small, L),
                         (Ginv, jbs._spd_inv_small, G)):
        np.testing.assert_allclose(got, np.asarray(fn(jnp.asarray(arg))),
                                   rtol=1e-12, atol=1e-14)


def test_chol_small_zero_blocks_give_zeros():
    """Padded (all-zero) aggregates factor and invert to zero, not NaN."""
    G = torch.zeros((3, 3, 3), dtype=F64)
    L = tbs._chol_small(G)
    assert bool(torch.isfinite(L).all())
    assert bool((tbs._tri_inv_small(L) == 0).all())
    assert bool((tbs._spd_inv_small(G) == 0).all())


# ---------------------------------------------------------------------------
# one candidate, and the tentative fit
# ---------------------------------------------------------------------------

def test_block_m1_matches_scalar_device_setup():
    """The m = 1, bs = 1 block pipeline gives the scalar setup's
    hierarchy: the same CG history."""
    A = poisson(POISSON_GRID, format="csr")
    n = A.shape[0]
    b = np.random.default_rng(0).random(n)
    kw = dict(max_coarse=200, dtype=F64, device=CPU)
    blk = device_sa_setup_block(A, grid=POISSON_GRID, B=np.ones((n, 1)),
                                **kw)
    sca = device_sa_setup(A, grid=POISSON_GRID, **kw)
    r1, r2 = [], []
    x1 = blk.solve(b, tol=1e-10, maxiter=60, accel="cg", residuals=r1)
    x2 = sca.solve(b, tol=1e-10, maxiter=60, accel="cg", residuals=r2)
    assert len(r1) == len(r2) > 5
    np.testing.assert_allclose(r1, r2, rtol=HIST_RTOL)
    np.testing.assert_allclose(x1, x2, rtol=1e-7, atol=1e-12)


def test_tentative_fit_orthonormal_and_equal_to_reference():
    g, bs, m = (9, 9), 2, 3
    n = int(np.prod(g))
    B = np.random.default_rng(1).standard_normal((n, bs, m))
    Qv, Bc = tbs._fit_candidates_gram(torch.as_tensor(B), g, 3, F64)
    pairs = [(i, j) for i in range(m) for j in range(i + 1)]
    fields = torch.stack([torch.sum(Qv[:, :, i] * Qv[:, :, j], dim=1)
                          for (i, j) in pairs])
    gram = tbs._block_sum(fields, (3, 3), 3).numpy()
    for p, (i, j) in enumerate(pairs):
        np.testing.assert_allclose(gram[p], 1.0 if i == j else 0.0,
                                   atol=1e-10)
    Bnp = B.reshape(3, 3, 3, 3, bs, m)
    for cy in range(3):
        for cx in range(3):
            blk = Bnp[cy, :, cx, :].reshape(-1, m)
            R = Bc.numpy()[cy * 3 + cx]
            np.testing.assert_allclose(R.T @ R, blk.T @ blk, rtol=1e-9,
                                       atol=1e-9)
    Qj, Bcj = jbs._fit_candidates_gram(jnp.asarray(B), g, 3, jnp.float64)
    np.testing.assert_allclose(Qv.numpy(), np.asarray(Qj), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(Bc.numpy(), np.asarray(Bcj), rtol=1e-12,
                               atol=1e-14)


# ---------------------------------------------------------------------------
# whole setups against JAX's
# ---------------------------------------------------------------------------

def _levels(solver):
    return [(i["n"], i["bs"], i["ndiags"]) for i in
            solver.setup_info["levels"]], solver.hierarchy.levels[-1].n


def _assert_same_setup(tj, tt, rho_rtol=1e-10):
    assert _levels(tt) == _levels(tj)
    assert (tt.grid, tt.grid_p, tt.bs) == (tj.grid, tj.grid_p, tj.bs)
    for lj, lt in zip(tj.setup_info["levels"], tt.setup_info["levels"]):
        assert float(lt["rho"]) == pytest.approx(float(lj["rho"]),
                                                 rel=rho_rtol)
    for lj, lt in zip(tj.hierarchy.levels, tt.hierarchy.levels):
        assert type(lt.A).__name__ == type(lj.A).__name__
        if isinstance(lt.A, BlockDIAMatrix):
            assert lt.A.offsets == lj.A.offsets and lt.A.bs == lj.A.bs


@pytest.fixture(scope="module")
def elasticity():
    A, B = jax_elasticity((32, 32))
    b = np.random.default_rng(3).random(A.shape[0])
    kw = dict(grid=ELAST_GRID, B=B, max_coarse=300)
    tj = jax_block(A, dtype=jnp.float64, **kw)
    rj = []
    xj = tj.solve(b, residuals=rj, **SOLVE)
    return A, B, b, kw, tj, rj, xj


def test_elasticity_float64_matches_reference(elasticity):
    A, B, b, kw, tj, rj, _ = elasticity
    At, Bt = pt.linear_elasticity((32, 32))
    tt = device_sa_setup_block(At, dtype=F64, device=CPU, **dict(kw, B=Bt))
    assert [lvl.A.bs for lvl in tt.hierarchy.levels[:-1]] == [2, 3]
    _assert_same_setup(tj, tt)
    rt = []
    x = tt.solve(b, residuals=rt, **SOLVE)
    assert len(rt) == len(rj) < 40
    np.testing.assert_allclose(rt, rj, rtol=HIST_RTOL)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


@pytest.fixture(scope="module")
def elasticity_mixed():
    A, B = jax_elasticity((32, 32))
    b = np.random.default_rng(1).random(A.shape[0])
    kw = dict(grid=ELAST_GRID, B=B, mixed_precision=True)
    tj = jax_block(A, **kw)
    rj = []
    tj.solve(b, residuals=rj, **MIXED)
    return A, b, kw, tj, rj


def test_elasticity_mixed_matches_reference(elasticity_mixed):
    A, b, kw, tj, rj = elasticity_mixed
    tt = device_sa_setup_block(A, device=CPU, **kw)
    assert tt.hierarchy.dtype == torch.float32
    assert tt.hierarchy.A64.dtype == F64
    _assert_same_setup(tj, tt, rho_rtol=1e-5)
    rt = []
    x = tt.solve(b, residuals=rt, **MIXED)
    assert len(rt) == len(rj)
    np.testing.assert_allclose(rt, rj, rtol=MIXED_RTOL)
    true = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert true < 1e-8
    np.testing.assert_allclose(rt[-1] / rt[0], true, rtol=1e-3)


@pytest.mark.parametrize("precision", ["float64", "mixed"])
def test_block_cycle_enters_through_the_zero_residual_hook(
        precision, elasticity, elasticity_mixed, monkeypatch):
    """Every level visit of the small elasticity V-cycle takes its (x, r)
    from the block Jacobi ``zero_call_residual`` hook (one B2 ``ZERO_RES``
    pass on the card), and the solve keeps the JAX package's count and
    history (rtol 1e-3, the mixed solve's tolerance)."""
    if precision == "float64":
        _, _, b, kw, _, rj, _ = elasticity
        At, Bt = pt.linear_elasticity((32, 32))
        tt = device_sa_setup_block(At, dtype=F64, device=CPU,
                                   **dict(kw, B=Bt))
        solve = SOLVE
    else:
        A, b, kw, _, rj = elasticity_mixed
        tt = device_sa_setup_block(A, device=CPU, **kw)
        solve = MIXED
    hook = rel.DeviceSmoother.zero_call_residual
    taken = []

    def spy(self, A_, b_):
        out = hook(self, A_, b_)
        taken.append(out is not None)
        return out

    monkeypatch.setattr(rel.DeviceSmoother, "zero_call_residual", spy)
    rt = []
    tt.solve(b, residuals=rt, **solve)
    visits = len(tt.hierarchy.levels) - 1       # the levels above the dense
    assert taken and all(taken) and len(taken) % visits == 0
    assert len(rt) == len(rj)
    np.testing.assert_allclose(rt, rj, rtol=MIXED_RTOL)


@pytest.fixture(scope="module")
def poisson_m2():
    A = poisson(POISSON_GRID, format="csr")
    n = A.shape[0]
    x = np.arange(n, dtype=float) % POISSON_GRID[1]
    B = np.stack([np.ones(n), x - x.mean()], axis=1)
    return A, B, np.random.default_rng(0).random(n)


def test_poisson_two_candidates_matches_reference(poisson_m2):
    A, B, b = poisson_m2
    kw = dict(grid=POISSON_GRID, B=B, max_coarse=200)
    tj = jax_block(A, dtype=jnp.float64, **kw)
    tt = device_sa_setup_block(A, dtype=F64, device=CPU, **kw)
    assert tt.hierarchy.levels[1].A.bs == 2 and tt.bs == 1
    _assert_same_setup(tj, tt)
    rj, rt = [], []
    tj.solve(b, residuals=rj, **SOLVE)
    x = tt.solve(b, residuals=rt, **SOLVE)
    assert len(rt) == len(rj)
    np.testing.assert_allclose(rt, rj, rtol=HIST_RTOL)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-8


def test_hierarchy_carried_across_solves_alike(elasticity):
    A, _, b, _, tj, rj, xj = elasticity
    tc = block_solver_from_jax(tj, CPU)
    assert isinstance(tc, BlockStructuredDeviceSolver) and tc.bs == 2
    assert isinstance(tc.hierarchy.levels[0].P,
                      pt.engine.BlockStructuredProlongator)
    assert tc.hierarchy.levels[0].pre.config[0] == "block_jacobi_dyn"
    rc = []
    x = tc.solve(b, residuals=rc, **SOLVE)
    assert len(rc) == len(rj)
    np.testing.assert_allclose(rc, rj, rtol=1e-10)
    np.testing.assert_allclose(x, np.asarray(xj), rtol=1e-8,
                               atol=1e-10 * np.abs(x).max())


def test_bad_inputs_raise(elasticity):
    A = poisson((16, 16), format="csr")
    n = A.shape[0]
    kw = dict(dtype=F64, device=CPU)
    with pytest.raises(ValueError, match="m <= 4"):
        device_sa_setup_block(A, grid=(16, 16), B=np.ones((n, 5)), **kw)
    with pytest.raises(ValueError, match="does not match"):
        device_sa_setup_block(A, grid=(8, 8), B=np.ones((n, 1)), **kw)
    with pytest.raises(ValueError, match="B rows"):
        device_sa_setup_block(A, grid=(16, 16), B=np.ones((n - 1, 1)), **kw)
    with pytest.raises(ValueError, match="coarsening threshold"):
        device_sa_setup_block(A, grid=(16, 16), B=np.ones((n, 1)),
                              max_coarse=1000, **kw)
    with pytest.raises(ValueError, match="multi-candidate: use "
                       "device_sa_setup_block"):
        device_sa_setup(A, grid=(16, 16), B=torch.ones((n, 2), dtype=F64),
                        max_coarse=10, **kw)
    bd = pt.block_dia_from_scipy(A.tobsr(blocksize=(1, 1)), dtype=F64,
                                 device=CPU)
    with pytest.raises(ValueError, match="mixed_precision needs"):
        device_sa_setup_block(bd, grid=(16, 16), B=np.ones((n, 1)),
                              max_coarse=10, mixed_precision=True, **kw)
    # the block solver takes one right-hand side at a time
    Ae, Be, b, kwe, _, _, _ = elasticity
    tt = device_sa_setup_block(Ae, dtype=F64, device=CPU, **kwe)
    assert not tt.lane_solves
    with pytest.raises(ValueError, match="one right-hand side"):
        tt.solve(np.stack([b, b], axis=1), tol=1e-8, accel="cg")
    with pytest.raises(ValueError, match="one right-hand side"):
        tt.solve(torch.as_tensor(np.stack([b, b], axis=1)), tol=1e-8)


def test_adaptive_sa_matches_reference(poisson_m2):
    """stages=2: stage 0's relaxed ones candidate through device_sa_setup,
    then the probe cycles' candidate joins it through the block setup."""
    A, _, b = poisson_m2
    kw = dict(grid=POISSON_GRID, stages=2, max_coarse=200)
    tj = jax_adaptive(A, dtype=jnp.float64, **kw)
    tt = device_adaptive_sa_setup(A, dtype=F64, device=CPU, **kw)
    assert isinstance(tt, BlockStructuredDeviceSolver)
    assert tt.setup_info["m"] == tj.setup_info["m"] == 2
    _assert_same_setup(tj, tt, rho_rtol=1e-6)
    rj, rt = [], []
    tj.solve(b, residuals=rj, **SOLVE)
    tt.solve(b, residuals=rt, **SOLVE)
    assert len(rt) == len(rj)
    np.testing.assert_allclose(rt, rj, rtol=1e-6)
    with pytest.raises(ValueError, match="stages"):
        device_adaptive_sa_setup(A, dtype=F64, device=CPU, stages=5, **{
            k: v for k, v in kw.items() if k != "stages"})
