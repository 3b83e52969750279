"""The lane-aligned device-built hierarchy and the interleaved batched
route (K15, ``engine/batched_cycle.py``) against the JAX package on the
CPU, on the reference's own (24, 512) lane-aligned grid
(tests/test_interleaved.py).

``device_sa_setup(lane_align=True)`` must equal the JAX one n_pad for
n_pad and array for array (float64, rtol 1e-10).  Each K15 twin is held
against the JAX package's Pallas kernel (``_run``) in interpret mode, mode
by mode, as max-norm relative error <= 1e-5 (float32).  The interleaved
V-cycle, ``interleaved_batched_cg`` and ``solve(B, accel="cg")`` are held
against the JAX ones on the same float32 hierarchy (carried across):
iteration counts equal lane for lane, histories to rtol 1e-4 (float32
sums in another order).  The JAX setups and solves run once per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pyamg_tpu.sparse.interleaved as jil  # noqa: E402
from pyamg_tpu.engine import device_sa_setup as jax_device_sa_setup  # noqa: E402
from pyamg_tpu.engine.batched_cycle import \
    interleaved_batched_cg as jax_interleaved_batched_cg  # noqa: E402
from pyamg_tpu.engine.batched_cycle import \
    interleaved_zero_vcycle as jax_interleaved_zero_vcycle  # noqa: E402
from pyamg_tpu.engine.device_setup import _padded_grid as jax_padded_grid  # noqa: E402
from pyamg_tpu.engine.device_setup import _solve_pad as jax_solve_pad  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402

from pyamg_tpu_torch import (_build, device_sa_setup,  # noqa: E402
                             structured_solver_from_jax)
from pyamg_tpu_torch.engine import batched_cycle  # noqa: E402
from pyamg_tpu_torch.engine.batched_cycle import (  # noqa: E402
    _jacobi_wd, interleaved_batched_cg, interleaved_zero_vcycle,
    supports_interleaved)
from pyamg_tpu_torch.engine.device_setup import _padded_grid, _solve_pad  # noqa: E402
from pyamg_tpu_torch.sparse import DIAMatrix  # noqa: E402
from pyamg_tpu_torch.sparse import interleaved as il  # noqa: E402

CPU = "cpu"
GRID = (24, 512)
SETUP = dict(grid=GRID, max_coarse=60, lane_align=True)
LANES = 4
CG_KW = dict(tol=1e-6, maxiter=60)
MODES = ["zero_res", "scaled", "plain", "add", "jstep"]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def A():
    return poisson(GRID, format="csr")


@pytest.fixture(scope="module")
def jax32(A):
    return jax_device_sa_setup(A, dtype=jnp.float32, mixed_precision=True,
                               **SETUP)


@pytest.fixture(scope="module")
def port32(jax32):
    return structured_solver_from_jax(jax32, CPU)


@pytest.fixture(scope="module")
def B(A):
    return np.random.default_rng(5).standard_normal((A.shape[0], LANES))


@pytest.fixture(scope="module")
def Bk(jax32, B):
    """B in the level-0 padded-grid layout, K-major (K, n_pad)."""
    gy, gx = jax32.grid_p
    Bg = np.zeros((LANES, gy, gx))
    Bg[:, : GRID[0], : GRID[1]] = B.T.reshape(LANES, *GRID)
    return Bg.reshape(LANES, -1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_cg(jax32, Bk):
    X, hist = jax.jit(lambda hh, b: jax_interleaved_batched_cg(
        hh, b, **CG_KW))(jax32.hierarchy, jnp.asarray(Bk))
    return np.asarray(X), np.asarray(hist)


def test_layout_round_trip():
    """to_interleaved / from_interleaved invert each other and equal the
    reference's layout."""
    Xk = np.random.default_rng(0).standard_normal((8, 1024)).astype(
        np.float32)
    Xi = il.to_interleaved(torch.as_tensor(Xk))
    assert Xi.shape == (8, 8, 128) and Xi.is_contiguous()
    np.testing.assert_array_equal(Xi.numpy(),
                                  np.asarray(jil.to_interleaved(Xk)))
    assert torch.equal(il.from_interleaved(Xi), torch.as_tensor(Xk))


@pytest.mark.parametrize("grid,stride", [((2048, 2048), 3), (GRID, 3),
                                         ((100, 700), (3, 1)),
                                         ((5, 70, 600), 3)])
def test_lane_aligned_padding_matches_reference(grid, stride):
    """_padded_grid with lane_align, and the solve padding on top of it,
    equal the reference's; at 2048^2 the fine grid is 2064 x 2304 =
    4 755 456 rows and the solve padding 4 784 128."""
    got = _padded_grid(grid, stride, lane_align=True)
    assert got == jax_padded_grid(grid, stride, lane_align=True)
    n = int(np.prod(got))
    assert _solve_pad(n) == jax_solve_pad(n)
    if grid == (2048, 2048):
        assert got == (2064, 2304) and n == 4755456
        assert _solve_pad(n) == 4784128


def test_lane_aligned_setup_matches_reference(A):
    """device_sa_setup(lane_align=True) in float64: the same grids, n and
    n_pad per level; A, S, S^T, tv, the smoother arrays and the coarse
    operator array for array."""
    J = jax_device_sa_setup(A, dtype=jnp.float64, **SETUP)
    T = device_sa_setup(A, dtype=torch.float64, device=CPU, **SETUP)
    assert (T.grid, T.grid_p) == (J.grid, J.grid_p) == (GRID, (24, 768))
    hj, ht = J.hierarchy, T.hierarchy
    assert len(ht.levels) == len(hj.levels)
    for lj, lt in zip(hj.levels[:-1], ht.levels[:-1]):
        assert (lt.n, lt.n_pad) == (lj.n, lj.n_pad)
        assert lt.P.fine_grid_p == lj.P.fine_grid_p
        assert lt.P.coarse_grid_p == lj.P.coarse_grid_p
        for a, b in ((lt.A, lj.A), (lt.P.S, lj.P.S), (lt.R.St, lj.R.St)):
            assert a.offsets == b.offsets and a.n_pad == b.n_pad
            np.testing.assert_allclose(a.data.numpy(), np.asarray(b.data),
                                       rtol=1e-10, atol=1e-14)
        for a, b in ((lt.P.tv, lj.P.tv), (lt.R.tv, lj.R.tv)) + tuple(
                zip(lt.pre.arrays, lj.pre.arrays)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)
    np.testing.assert_allclose(ht.coarse_inv.numpy(),
                               np.asarray(hj.coarse_inv), rtol=1e-10,
                               atol=1e-12)
    assert supports_interleaved(ht)


@pytest.mark.parametrize("mode", MODES)
def test_k15_twin_matches_pallas_interpret(port32, jax32, mode):
    """Each K15 twin against the reference's Pallas kernel (``_run``) in
    interpret mode on the lane-aligned level-0 operators, K = 8."""
    lj, lt = jax32.hierarchy.levels[0], port32.hierarchy.levels[0]
    rng = np.random.default_rng(4)
    S = lt.A.n_pad // 128
    b, x = (rng.standard_normal((S, 8, 128)).astype(np.float32)
            for _ in range(2))
    bt, xt = torch.as_tensor(b), torch.as_tensor(x)
    dinv, omega = lj.pre.arrays
    wd_j = (omega * dinv).reshape(-1, 128)
    wd_t = _jacobi_wd(lt.pre)
    if mode == "zero_res":
        want = jil._run(lj.A, mode, [(jnp.asarray(b), False), (wd_j, True)],
                        [], out_count=2, interpret=True)
        got = il.int_jacobi_zero_res(lt.A, wd_t, bt)
    elif mode == "scaled":
        want = jil._run(lj.R.St, mode, [(jnp.asarray(b), False)],
                        [(lj.R.tv.reshape(-1, 128), True)], interpret=True)
        got = il.int_spmv_scaled(lt.R.St, bt, lt.R.tv)
    elif mode == "plain":
        want = jil._run(lj.A, mode, [(jnp.asarray(b), False)], [],
                        interpret=True)
        got = il.int_spmv(lt.A, bt)
    elif mode == "add":
        want = jil._run(lj.P.S, mode, [(jnp.asarray(b), False)],
                        [(jnp.asarray(x), False)], interpret=True)
        got = il.int_spmv_add(lt.P.S, bt, xt)
    else:
        want = jil._run(lj.A, mode, [(jnp.asarray(x), False)],
                        [(jnp.asarray(b), False), (wd_j, True)],
                        interpret=True)
        got = il.int_jacobi_step(lt.A, wd_t, bt, xt)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got, want):
        assert g.shape == (S, 8, 128)
        assert _rel(g.numpy(), w) <= 1e-5


def test_interleaved_wrappers_run_the_twin_only_on_cpu(port32):
    """CPU stacks run the twins and count no launch; an operand on another
    device never falls back to a twin."""
    lvl = port32.hierarchy.levels[0]
    Bi = torch.ones(lvl.A.n_pad // 128, 2, 128)
    _build.reset_launches()
    il.int_spmv(lvl.A, Bi)
    il.int_jacobi_step(lvl.A, _jacobi_wd(lvl.pre), Bi, Bi)
    assert _build.launches == {}
    meta = DIAMatrix(data=lvl.A.data.to("meta"), offsets=lvl.A.offsets,
                     shape=lvl.A.shape, nnz=lvl.A.nnz)
    with pytest.raises(ValueError, match="unsupported device"):
        il.int_spmv(meta, Bi.to("meta"))


def test_interleaved_vcycle_matches_reference(port32, jax32, Bk):
    """One interleaved zero V-cycle on K = 4 lanes equals the reference's,
    and equals the port's K-major cycle lane for lane (the same operator
    applied, to rounding)."""
    Bi = il.to_interleaved(torch.as_tensor(Bk))
    got = il.from_interleaved(interleaved_zero_vcycle(port32.hierarchy, Bi))
    want = jil.from_interleaved(jax_interleaved_zero_vcycle(
        jax32.hierarchy, jil.to_interleaved(jnp.asarray(Bk))))
    assert _rel(got.numpy(), want) <= 1e-5
    kmajor = port32.cycle_operator("V")(torch.as_tensor(Bk))
    assert _rel(got.numpy(), kmajor.numpy()) <= 2e-5


def test_interleaved_batched_cg_matches_reference(port32, Bk, jax_cg):
    """interleaved_batched_cg against the reference's: per-lane counts
    equal, histories to rtol 1e-4, x to 1e-4 of its largest entry."""
    X_want, hist_want = jax_cg
    X, hist = interleaved_batched_cg(port32.hierarchy, torch.as_tensor(Bk),
                                     **CG_KW)
    assert X.shape == Bk.shape and hist.shape == hist_want.shape
    hist = hist.numpy()
    np.testing.assert_array_equal(np.isnan(hist), np.isnan(hist_want))
    ok = ~np.isnan(hist_want)
    np.testing.assert_allclose(hist[ok], hist_want[ok], rtol=1e-4)
    assert _rel(X.numpy(), X_want) <= 1e-4


def test_solve_routes_to_interleaved_cg(port32, jax32, A, B, monkeypatch):
    """solve(B, accel='cg') on the lane-aligned float32 hierarchy takes the
    interleaved route (one call) and equals the reference's routed solve:
    counts lane for lane, histories to rtol 1e-4, every lane converged
    against the true operator."""
    calls = []
    real = batched_cycle.interleaved_batched_cg

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(batched_cycle, "interleaved_batched_cg", counted)
    res, res_j = [], []
    X, info = port32.solve(B, accel="cg", residuals=res, return_info=True,
                           **CG_KW)
    assert calls == [1] and info == 0 and X.shape == B.shape
    jax32.solve(B, accel="cg", residuals=res_j, **CG_KW)
    assert [len(r) for r in res] == [len(r) for r in res_j]
    for got, want in zip(res, res_j):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    for j in range(LANES):
        assert np.linalg.norm(B[:, j] - A @ X[:, j].astype(np.float64)) \
            < 5e-6 * np.linalg.norm(B[:, j])
    # mixed precision, an x0, or float64 take the K-major path
    port32.solve(B, accel="cg", precision="mixed", tol=1e-8, maxiter=30)
    port32.solve(B, x0=np.zeros_like(B), accel="cg", **CG_KW)
    assert calls == [1]


def test_non_lane_aligned_hierarchy_is_refused(A):
    """A hierarchy without the lane-aligned layout is rejected, not
    miscomputed, and its batched CG takes the K-major path with the same
    per-lane counts as the interleaved route."""
    T = device_sa_setup(A, device=CPU, grid=GRID, max_coarse=60)
    h = T.hierarchy
    assert not supports_interleaved(h)
    with pytest.raises(ValueError, match="interleaved"):
        interleaved_zero_vcycle(h, torch.zeros(h.levels[0].n_pad // 128, 2,
                                               128))
    B = np.random.default_rng(5).standard_normal((A.shape[0], LANES))
    res, res_int = [], []
    T.solve(B, accel="cg", residuals=res, **CG_KW)
    device_sa_setup(A, device=CPU, **SETUP).solve(B, accel="cg",
                                                  residuals=res_int, **CG_KW)
    assert [len(r) for r in res] == [len(r) for r in res_int]
