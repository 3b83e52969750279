"""The port's unstructured device SA setup (``device_unstructured_sa_setup``)
and its solves against the JAX package, on the CPU.

The same scipy operator (the reference test's P1 FEM stiffness matrix plus
1e-2 I, tests/test_unstructured_setup.py) goes to both packages; the
float64 hierarchies must agree level for level (``setup_info``, sizes,
every A and P as scipy matrices) and solve with the same histories.  The
select twin (K14's plain version) is held against the Pallas kernel in
interpret mode.  The JAX setups are module-scoped fixtures, so each JAX
program compiles once.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_pallas_kernels import _random_rect  # noqa: E402

import pyamg_tpu.engine.unstructured_setup as jus  # noqa: E402
from pyamg_tpu.engine import device_sa_setup as jax_device_sa_setup  # noqa: E402
from pyamg_tpu.gallery import gradgradform as jax_gradgradform  # noqa: E402
from pyamg_tpu.gallery import load_example  # noqa: E402
from pyamg_tpu.gallery import regular_triangle_mesh as jax_mesh  # noqa: E402
from pyamg_tpu.sparse import windowed_from_scipy as jax_windowed  # noqa: E402

import pyamg_tpu_torch.engine.unstructured_setup as tus  # noqa: E402
from pyamg_tpu_torch import (ComposedWindowed, ReorderedSolver,  # noqa: E402
                             device_sa_setup, device_unstructured_sa_setup,
                             gradgradform, regular_triangle_mesh,
                             unstructured_solver_from_jax)
from pyamg_tpu_torch.sparse import DenseOperator, WindowedELL  # noqa: E402
from pyamg_tpu_torch.sparse.window import (windowed_from_scipy,  # noqa: E402
                                           windowed_select,
                                           windowed_select_ref)

CPU = "cpu"
F64 = dict(max_coarse=30)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU twins run many small ops: one thread each, so that
    the test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fem_matrix(nx):
    V, E = regular_triangle_mesh(nx, nx)
    A = sp.csr_matrix(gradgradform(V, E))
    return (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to_scipy(op):
    """A windowed, composed or dense operator of either package as a scipy
    matrix over its padded rows (zero entries dropped)."""
    if hasattr(op, "factors"):
        M = None
        for f in op.factors:
            Fm = _to_scipy(f)
            if M is not None:
                k = min(M.shape[1], Fm.shape[0])
                Fm = M[:, :k] @ Fm[:k]
            M = Fm
        return M.tocsr()
    if type(op).__name__ == "DenseOperator":
        return sp.csr_matrix(_np(op.data).astype(np.float64))
    data, idx, starts = _np(op.data), _np(op.idx), _np(op.starts)
    nb, k, B = data.shape
    rows = np.broadcast_to((np.arange(nb) * B)[:, None, None]
                           + np.arange(B)[None, None, :], data.shape)
    cols = starts.astype(np.int64)[:, None, None] * op.w2 + idx
    keep = data != 0
    ncols = max(op.shape[1], int(cols.max()) + 1)
    return sp.csr_matrix((data[keep].astype(np.float64),
                          (rows[keep], cols[keep])), shape=(nb * B, ncols))


def _assert_same_operator(got, want, rtol):
    G, Wm = _to_scipy(got), _to_scipy(want)
    m = min(G.shape[1], Wm.shape[1])
    G, Wm = G[:, :m], Wm[:, :m]
    assert G.shape == Wm.shape and G.nnz == Wm.nnz
    assert abs(G - Wm).max() <= rtol * abs(Wm).max()


def _history(solver, b, tol=1e-6, maxiter=60):
    res = []
    solver.solve(b, tol=tol, maxiter=maxiter, accel="cg", residuals=res)
    res = np.asarray(res, dtype=np.float64)
    return res[~np.isnan(res)]


def _jittered_fem(nx):
    """The airfoil stand-in's recipe (pyamg_tpu/gallery/example.py): a P1
    mesh whose interior vertices move by 0.25/nx standard normal steps
    (seed 5), many elements inverted; plus 1e-2 I."""
    V, E = regular_triangle_mesh(nx, nx)
    rng = np.random.default_rng(5)
    interior = ((V[:, 0] > 0) & (V[:, 0] < 1) & (V[:, 1] > 0)
                & (V[:, 1] < 1))
    V = V + 0.25 / nx * rng.standard_normal(V.shape) * interior[:, None]
    A = sp.csr_matrix(gradgradform(V, E))
    return (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()


@pytest.fixture(scope="module")
def pair48():
    """(A, JAX, port) float64 hierarchies at nx = 48 (four levels)."""
    A = _fem_matrix(48)
    return (A, jus.device_unstructured_sa_setup(A, dtype=jnp.float64, **F64),
            device_unstructured_sa_setup(A, dtype=torch.float64, device=CPU,
                                         **F64))


# ---------------------------------------------------------------------------
# K14's twin, the diagonal, the gallery and the host planning
# ---------------------------------------------------------------------------

# (rows, spread, block, w2): the reference test's operator, and one at
# the 640k level-1 A's window (w2 4096) with 2048-row blocks
SELECT_SHAPES = {"": (4096, 70, 256, 1024), "-b2048": (8192, 200, 2048, 4096)}


@pytest.mark.parametrize("payload", ["int", "f32", "f64", "int-b2048",
                                     "f32-b2048"])
def test_select_twin_matches_pallas_interpret(payload):
    """Integer payloads < 2^24 bit-exact against the interpret-mode Pallas
    kernel; arbitrary f32 within its Dekker split's 2e-7 relative tail;
    every payload exact against the reference's gather form."""
    payload, _, shape = payload.partition("-")
    n, spread, block, w2 = SELECT_SHAPES["-" + shape if shape else ""]
    P = _random_rect(n, n, per_row=5, spread=spread, seed=21)
    JW = jax_windowed(P, block=block)
    TW = windowed_from_scipy(P, device=CPU, block=block)
    assert (TW.block, TW.w2, JW.w2) == (block, w2, w2)
    rng = np.random.default_rng(22)
    m = JW.m_chunks * JW.w2
    x = (rng.integers(0, 2 ** 23, m) if payload == "int"
         else rng.standard_normal(m) * 1e3)
    dt = np.float64 if payload == "f64" else np.float32
    x = x.astype(dt)
    got = windowed_select(TW, torch.as_tensor(x))
    assert got.dtype == torch.as_tensor(x).dtype
    got = got.numpy()
    np.testing.assert_array_equal(got, windowed_select_ref(
        TW, torch.as_tensor(x)).numpy())
    np.testing.assert_array_equal(got, np.asarray(
        JW._select_reference(jnp.asarray(x))))
    if payload == "f64":
        return
    want = np.asarray(JW._select_pallas(jnp.asarray(x), interpret=True))
    if payload == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def test_select_method_fits_the_payload():
    """``WindowedELL.select`` pads a short payload to the source length,
    as the reference's ``_x_padded`` does."""
    A = _fem_matrix(24)
    JW = jax_windowed(A, dtype=jnp.float64, block=1024)
    TW = windowed_from_scipy(A, dtype=torch.float64, device=CPU, block=1024)
    x = np.random.default_rng(3).random(A.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(TW.select(torch.as_tensor(x)).numpy(),
                                  np.asarray(JW.select(jnp.asarray(x))))


@pytest.mark.parametrize("nx", [24, 40])
def test_diagonal_matches_reference(nx):
    A = _fem_matrix(nx)
    JW = jax_windowed(A, dtype=jnp.float64, block=1024)
    TW = windowed_from_scipy(A, dtype=torch.float64, device=CPU, block=1024)
    np.testing.assert_array_equal(TW.diagonal().numpy(),
                                  np.asarray(JW.diagonal()))
    np.testing.assert_array_equal(TW.diagonal().numpy()[: A.shape[0]],
                                  A.diagonal())


@pytest.mark.parametrize("kappa", [None, 2.5, "fn"])
def test_gallery_copies_match_reference(kappa):
    V, E = regular_triangle_mesh(9, 7)
    JV, JE = jax_mesh(9, 7)
    np.testing.assert_array_equal(V, JV)
    np.testing.assert_array_equal(E, JE)
    k = (lambda c: 1.0 + c[0] * c[1]) if kappa == "fn" else kappa
    A, JA = gradgradform(V, E, kappa=k), jax_gradgradform(JV, JE, kappa=k)
    for attr in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(A, attr), getattr(JA, attr))


def test_span_plan_matches_reference():
    """Range queries, hulls, window plans and geometries: equal arrays."""
    rng = np.random.default_rng(3)
    n = 4096
    A = sp.random(n, n, density=0.002, random_state=rng, format="csr")
    A = (A + sp.eye(n, format="csr")).tocsr()
    A.sort_indices()
    tp, jp = tus._SpanPlan.from_csr(A), jus._SpanPlan.from_csr(A)
    np.testing.assert_array_equal(tp.lo, jp.lo)
    np.testing.assert_array_equal(tp.hi, jp.hi)
    ng = len(tp.lo)
    g0 = rng.integers(0, ng, size=200).astype(np.int64)
    g1 = np.minimum(g0 + rng.integers(0, ng, size=200), ng - 1)
    for a, b in zip(tp._range_minmax(g0, g1), jp._range_minmax(g0, g1)):
        np.testing.assert_array_equal(a, b)
    lo = np.arange(0, n, 512, dtype=np.int64)
    hi = np.minimum(lo + 512, n)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rng.random(n) < 0.3, out=cum[1:])
    for dist in (1, 2, 3, 7):
        h, jh = tp.hull(lo, hi, dist), jp.hull(lo, hi, dist)
        np.testing.assert_array_equal(h[0], jh[0])
        np.testing.assert_array_equal(h[1], jh[1])
        w, jw = tus._plan_windows(cum, *h), jus._plan_windows(cum, *jh)
        np.testing.assert_array_equal(w[0], jw[0])
        np.testing.assert_array_equal(w[1], jw[1])
        g, jg = (tus._pick_geometry(*w, 512, int(cum[-1])),
                 jus._pick_geometry(*jw, 512, int(cum[-1])))
        assert g[0] == jg[0] and g[2] == jg[2]
        np.testing.assert_array_equal(g[1], jg[1])


def test_flat_unflat_round_trip():
    """_flat's slot-wise (k, n) layout and _unflat's (nb, k, block) one
    are each other's inverse, as the reference's are."""
    v3 = np.random.default_rng(1).random((3, 4, 256))
    kn = tus._flat(torch.as_tensor(v3), 3 * 256)
    np.testing.assert_array_equal(kn.numpy(),
                                  np.asarray(jus._flat(jnp.asarray(v3),
                                                       3 * 256)))
    np.testing.assert_array_equal(
        tus._unflat(kn[:, :700], 3, 256, 768).numpy(),
        np.asarray(jus._unflat(jnp.asarray(kn.numpy()[:, :700]), 3, 256,
                               768)))
    np.testing.assert_array_equal(tus._unflat(kn, 3, 256, 768).numpy(), v3)


def test_hull_contains_neighbours():
    A = _fem_matrix(30)
    plan = tus._SpanPlan.from_csr(A)
    lo = np.array([100, 400], dtype=np.int64)
    hi = np.array([200, 500], dtype=np.int64)
    h_lo, h_hi = plan.hull(lo, hi, 1)
    for j in range(2):
        sub = A[int(lo[j]):int(hi[j])]
        assert sub.indices.min() >= h_lo[j]
        assert sub.indices.max() < h_hi[j]


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def w24():
    A = _fem_matrix(24)
    return (A, jax_windowed(A, dtype=jnp.float64, block=1024),
            windowed_from_scipy(A, dtype=torch.float64, device=CPU,
                                block=1024))


@pytest.mark.parametrize("densify", [True, False],
                         ids=["standard", "aggressive"])
def test_stage_roots_match_reference(w24, densify):
    _, JW, TW = w24
    for seed in (0, 3):
        got = tus._stage_roots(TW, seed=seed, densify=densify)
        want = jus._stage_roots(JW, seed=seed, densify=densify)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.sum()) < TW.shape[0]


def test_stage_build_p_matches_reference(w24):
    """float64: cval identical; T, P, dinv, rho and the norms within
    1e-12."""
    A, JW, TW = w24
    root = tus._stage_roots(TW)
    jroot = jus._stage_roots(JW)
    nc = int(root.sum())
    geom = (1024, 1024, (0,), 2)
    kw = dict(theta=0.0, omega=4.0 / 3.0, t_geom=geom, p_geom=geom)
    got = tus._stage_build_p(TW, root, None, dtype=torch.float64, **kw)
    want = jus._stage_build_p(JW, jroot, None, dtype="float64", **kw)
    T, P, dinv, rho, norms, cval, S = got
    JT, JP, Jdinv, Jrho, Jnorms, Jcval, JS = want
    assert S is None and JS is None
    np.testing.assert_array_equal(cval.numpy(), np.asarray(Jcval))
    assert int(cval.max()) == nc - 1
    for a, b in ((T, JT), (P, JP)):
        np.testing.assert_array_equal(a.idx.numpy(), np.asarray(b.idx))
        np.testing.assert_allclose(a.data.numpy(), np.asarray(b.data),
                                   rtol=1e-12, atol=1e-15)
    for a, b in ((dinv, Jdinv), (rho, Jrho), (norms, Jnorms)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-15)
    # the slot merge: same distinct count, same merged slots in order
    kd = int(tus._max_distinct(P))
    assert kd == int(jus._max_distinct(JP)) and kd < P.k
    M = tus._merge_slots(P, k_new=kd, geometry=geom, dtype=torch.float64)
    JM = jus._merge_slots(JP, k_new=kd, geometry=geom, dtype="float64")
    np.testing.assert_array_equal(M.idx.numpy(), np.asarray(JM.idx))
    np.testing.assert_allclose(M.data.numpy(), np.asarray(JM.data),
                               rtol=1e-12, atol=1e-15)
    _assert_same_operator(M, P, 1e-14)


def test_extract_topk_keeps_the_reference_order(monkeypatch):
    """Ties in |value| (a regular mesh's coarse band is full of them) come
    out in the reference's order: descending |value|, first position; in
    one pass or in several."""
    rng = np.random.default_rng(5)
    band = rng.choice([0.0, 0.0, 0.0, 1.0, -1.0, 2.0, -0.5], size=(3, 16, 40))
    band[0, 0] = 0.0                                     # an empty row
    kc = int(jus._band_nnz_max(jnp.asarray(band)))
    assert int(tus._band_nnz_max(torch.as_tensor(band))) == kc
    want = jus._extract_topk(jnp.asarray(band), kc)
    for entries in (2**27, 7 * 40):
        monkeypatch.setattr(tus, "_PASS_ENTRIES", entries)
        assert int(tus._band_nnz_max(torch.as_tensor(band))) == kc
        got = tus._extract_topk(torch.as_tensor(band), kc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_band_to_dense_and_col_bounds_match_reference():
    rng = np.random.default_rng(6)
    nc, nc_pad, bc, period = 500, 512, 256, 48
    band = rng.standard_normal((2, bc, period)) * (rng.random((2, bc, period))
                                                   < 0.2)
    band[1, nc - 256:] = 0.0
    cst = np.array([0, 230])
    got = tus._band_to_dense(torch.as_tensor(band), torch.as_tensor(cst),
                             nc=nc, nc_pad=nc_pad)
    want = jus._band_to_dense(jnp.asarray(band), jnp.asarray(cst),
                              nc=nc, nc_pad=nc_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = band.reshape(-1, period)[:, :5].T.copy()
    cols = rng.integers(0, nc, vals.shape).astype(np.float32)
    for gr in (64, 256):
        for g, w in zip(tus._col_bounds(torch.as_tensor(vals),
                                        torch.as_tensor(cols), gr=gr),
                        jus._col_bounds(jnp.asarray(vals), jnp.asarray(cols),
                                        gr=gr)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# whole hierarchies and solves
# ---------------------------------------------------------------------------

def test_hierarchy_matches_reference(pair48):
    """float64: setup_info identical, n and n_pad identical level for
    level, every A and P equal to the JAX one as scipy matrices within
    1e-6 relative (the float32 cast of the probe chains)."""
    A, J, T = pair48
    assert T.setup_info == J.setup_info
    jl, tl = J.hierarchy.levels, T.hierarchy.levels
    assert [(lv.n, lv.n_pad) for lv in tl] == [(lv.n, lv.n_pad) for lv in jl]
    assert len(tl) >= 4
    for a, b in zip(tl, jl):
        assert type(a.A).__name__ == type(b.A).__name__
        _assert_same_operator(a.A, b.A, 1e-6)
        if b.P is not None:
            _assert_same_operator(a.P, b.P, 1e-6)
    np.testing.assert_allclose(_np(T.hierarchy.coarse_inv),
                               np.asarray(J.hierarchy.coarse_inv),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("nx", [24, 48])
def test_rap_matches_scipy(pair48, nx):
    """The port's chain-probed RAP equals scipy's P^T A P entrywise at
    every level, with the same pattern."""
    if nx == 48:
        A_sp, _, T = pair48
    else:
        A_sp = _fem_matrix(nx)
        T = device_unstructured_sa_setup(A_sp, dtype=torch.float64,
                                         device=CPU, **F64)
    h = T.hierarchy
    for lvl in range(len(h.levels) - 1):
        n1 = h.levels[lvl + 1].n
        P = _to_scipy(h.levels[lvl].P)[: A_sp.shape[0], :n1]
        RAP = (P.T @ A_sp @ P).tocsr()
        A1 = _to_scipy(h.levels[lvl + 1].A)[:n1, :n1]
        assert abs(RAP - A1).max() <= 2e-5 * abs(RAP).max(), lvl
        assert RAP.nnz == A1.nnz
        A_sp = RAP


def test_f64_solve_matches_reference(pair48):
    A, J, T = pair48
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    hj = _history(J, jnp.asarray(b))
    ht = _history(T, b)
    assert len(ht) == len(hj)
    np.testing.assert_allclose(ht, hj, rtol=1e-6)


def test_f32_solve_matches_reference():
    """float32: the same iteration count, histories within 1e-4; the true
    residual at the float32 floor."""
    A = _fem_matrix(24)
    J = jus.device_unstructured_sa_setup(A, dtype=jnp.float32, **F64)
    T = device_unstructured_sa_setup(A, device=CPU, **F64)
    assert T.setup_info == J.setup_info
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    hj = _history(J, jnp.asarray(b, dtype=jnp.float32))
    ht = _history(T, b)
    assert len(ht) == len(hj)
    np.testing.assert_allclose(ht, hj, rtol=1e-4)
    x = T.solve(b, tol=1e-6, maxiter=60, accel="cg")
    assert x.shape == b.shape and isinstance(x, np.ndarray)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-4


def test_smooth_passes_2_matches_reference():
    """aggregate='aggressive', smooth_passes=2: composed prolongators
    S P, equal to the JAX ones, and the same solve."""
    A = _fem_matrix(12)
    kw = dict(aggregate="aggressive", smooth_passes=2, **F64)
    J = jus.device_unstructured_sa_setup(A, dtype=jnp.float64, **kw)
    T = device_unstructured_sa_setup(A, dtype=torch.float64, device=CPU,
                                     **kw)
    assert T.setup_info == J.setup_info
    for a, b in zip(T.hierarchy.levels[:-1], J.hierarchy.levels[:-1]):
        assert isinstance(a.P, ComposedWindowed)
        assert a.P.n_pad == b.P.n_pad and a.R.n_pad == b.R.n_pad
        _assert_same_operator(a.P, b.P, 1e-6)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    hj, ht = _history(J, jnp.asarray(b)), _history(T, b)
    assert len(ht) == len(hj)
    np.testing.assert_allclose(ht, hj, rtol=1e-6)


def _f32_floor(nx, scramble=False):
    """aggregate='aggressive', smooth_passes=2, max_coarse=400 on the
    jittered nx^2 mesh (``scramble``: a seeded random permutation first,
    as chip_smoke.py's routed case): CG to 1e-6 with the JAX package in
    float32 and the port in float32 and float64.  Returns {run: (levels,
    iterations, history relres, true relres)}."""
    A = _jittered_fem(nx)
    if scramble:
        q = np.random.default_rng(11).permutation(A.shape[0])
        A = A[q][:, q].tocsr()
    b = np.random.default_rng(12).standard_normal(A.shape[0])
    kw = dict(max_coarse=400, aggregate="aggressive", smooth_passes=2)
    runs = (("jax f32", jus.device_unstructured_sa_setup(
                A, dtype=jnp.float32, **kw), jnp.asarray(b, jnp.float32)),
            ("port f32", device_unstructured_sa_setup(A, device=CPU, **kw), b),
            ("port f64", device_unstructured_sa_setup(
                A, dtype=torch.float64, device=CPU, **kw), b))
    out = {}
    normb = np.linalg.norm(b)
    for name, s, bb in runs:
        res = []
        x = s.solve(bb, tol=1e-6, maxiter=400, accel="cg", residuals=res)
        x = np.asarray(x, dtype=np.float64)
        out[name] = ([lv.n for lv in s.hierarchy.levels], len(res) - 1,
                     float(res[-1]) / normb,
                     float(np.linalg.norm(b - A @ x)) / normb)
    return out


def test_f32_true_residual_floor_matches_reference():
    """On the distorted airfoil stand-in, aggressive with smooth_passes=2
    in float32: both packages build the same levels and reach a history
    relres <= 1e-6 in the same count, and in both the true relres stalls
    well above it (float32 rounding on an operator this ill-conditioned).
    The port's float64 run of the same setup closes the gap, so the
    composed prolongator is not at fault."""
    A = sp.csr_matrix(load_example("airfoil")["A"]).astype(np.float64)
    A = (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()
    assert abs(A - _jittered_fem(40)).max() == 0
    out = _f32_floor(40)
    (jl, ji, jh, jt), (tl, ti, th, tt) = out["jax f32"], out["port f32"]
    assert tl == jl == out["port f64"][0] and ti == ji
    for hist, true in ((jh, jt), (th, tt)):
        assert hist <= 1e-6 and 10 * hist <= true <= 1e-3
    _, _, h64, t64 = out["port f64"]
    assert h64 <= 1e-6 and t64 <= 1.01 * h64


def test_device_sa_setup_routes_non_grid_operators():
    """The airfoil stand-in (a jittered P1 mesh, not a grid stencil) goes
    to the unstructured setup in both packages: the same levels, and the
    same CG history (its distorted elements cost iterations in both)."""
    A = sp.csr_matrix(load_example("airfoil")["A"]).astype(np.float64)
    A = (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()
    J = jax_device_sa_setup(A, dtype=jnp.float64, max_coarse=100)
    T = device_sa_setup(A, dtype=torch.float64, device=CPU, max_coarse=100)
    assert type(T).__name__ == "DeviceMultilevelSolver"
    assert T.setup_info == J.setup_info
    assert [lv.n for lv in T.hierarchy.levels] == [
        lv.n for lv in J.hierarchy.levels]
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    hj, ht = _history(J, jnp.asarray(b)), _history(T, b)
    assert len(ht) == len(hj) and ht[-1] / ht[0] < 1e-5
    np.testing.assert_allclose(ht, hj, rtol=1e-6)


def test_reorder_auto_matches_reference():
    """A seeded random permutation of a 182^2 mesh operator (the smallest
    square mesh with more rows than a window admits columns, 2 * 16384)
    is not windowable; both packages RCM-reorder it (the same
    permutation), build the same levels (aggressive, the fewest) and take
    the same iterations.  A numpy b gives a numpy x, a tensor b a tensor
    x, both in the caller's ordering."""
    A0 = _fem_matrix(182)
    q = np.random.default_rng(7).permutation(A0.shape[0])
    A = A0[q][:, q].tocsr()
    assert windowed_from_scipy(A, device=CPU, block=1024) is None
    kw = dict(max_coarse=1000, aggregate="aggressive")
    J = jus.device_unstructured_sa_setup(A, dtype=jnp.float64, **kw)
    T = device_unstructured_sa_setup(A, dtype=torch.float64, device=CPU,
                                     **kw)
    assert isinstance(T, ReorderedSolver)
    np.testing.assert_array_equal(T._perm, J._perm)
    assert T.setup_info == J.setup_info and T.setup_info["reordered"] == "rcm"
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    hj, ht = _history(J, jnp.asarray(b)), _history(T, b)
    assert len(ht) == len(hj)
    np.testing.assert_allclose(ht, hj, rtol=1e-6)
    x = T.solve(b, tol=1e-8, accel="cg")
    xt, info = T.solve(torch.as_tensor(b), tol=1e-8, accel="cg",
                       return_info=True)
    assert isinstance(x, np.ndarray) and isinstance(xt, torch.Tensor)
    assert info == 0
    np.testing.assert_allclose(xt.numpy(), x, rtol=1e-12, atol=1e-14)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


def test_unstructured_solver_from_jax(pair48):
    """The JAX hierarchy's arrays carried across solve with the JAX
    solve's history, plain and inside the JAX solver's permutation."""
    A, J, _ = pair48
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    C = unstructured_solver_from_jax(J, CPU)
    assert C.setup_info == J.setup_info
    np.testing.assert_allclose(_history(C, b), _history(J, jnp.asarray(b)),
                               rtol=1e-10)
    perm = np.random.default_rng(8).permutation(A.shape[0])
    JR = jus.ReorderedSolver(J, perm)
    CR = unstructured_solver_from_jax(JR, CPU)
    assert isinstance(CR, ReorderedSolver)
    np.testing.assert_array_equal(CR._perm, perm)
    np.testing.assert_allclose(CR.solve(b, tol=1e-8, accel="cg"),
                               np.asarray(JR.solve(b, tol=1e-8, accel="cg")),
                               rtol=1e-8, atol=1e-12)


def test_single_level_densifies_the_operator_not_its_transpose():
    """max_levels=1 leaves the finest operator as the coarsest: its dense
    form is A itself, also for a nonsymmetric A."""
    A = _fem_matrix(12)
    A = (A + sp.triu(A, 1) * 0.5).tocsr()
    T = device_unstructured_sa_setup(A, dtype=torch.float64, device=CPU,
                                     max_levels=1)
    (lvl,) = T.hierarchy.levels
    assert isinstance(lvl.A, DenseOperator)
    n = A.shape[0]
    np.testing.assert_array_equal(lvl.A.data.numpy()[:n, :n], A.toarray())
    b = np.random.default_rng(0).random(n)
    x = T.solve(b, tol=1e-10, maxiter=3)
    np.testing.assert_allclose(A @ x, b, rtol=1e-8)


def test_levels_hold_windowed_forms(pair48):
    _, _, T = pair48
    for lvl in T.hierarchy.levels[:-1]:
        assert isinstance(lvl.A, WindowedELL)
        assert isinstance(lvl.P, WindowedELL)
        assert lvl.R.base is lvl.P
    assert isinstance(T.hierarchy.levels[-1].A, DenseOperator)


def test_candidate_and_improvement_match_reference():
    """A user candidate (scaled ones) and candidate improvement follow the
    reference's dtypes: the same hierarchy as the JAX one (at the shapes
    the 48^2 pair has compiled)."""
    A = _fem_matrix(48)
    n = A.shape[0]
    kw = dict(B=2.5 * np.ones(n), improve_candidates_iters=2, **F64)
    J = jus.device_unstructured_sa_setup(A, dtype=jnp.float64, **kw)
    T = device_unstructured_sa_setup(A, dtype=torch.float64, device=CPU,
                                     **kw)
    assert T.setup_info == J.setup_info
    for a, b in zip(T.hierarchy.levels[:-1], J.hierarchy.levels[:-1]):
        _assert_same_operator(a.P, b.P, 1e-6)


@pytest.mark.parametrize("case", ["mixed", "smoother", "windowable",
                                  "aggregate", "passes"])
def test_unported_and_invalid_options_raise(case):
    A = _fem_matrix(12)
    if case == "mixed":
        with pytest.raises(NotImplementedError, match="mixed precision"):
            device_unstructured_sa_setup(A, device=CPU, mixed_precision=True)
    elif case == "smoother":
        gs = ("gauss_seidel", {})
        with pytest.raises(ValueError, match="jacobi/richardson/chebyshev"):
            device_unstructured_sa_setup(A, device=CPU, presmoother=gs,
                                         postsmoother=gs)
    elif case == "windowable":
        # random columns over a span far wider than max_w2 = 16384
        rng = np.random.default_rng(0)
        n = 80000
        R = sp.random(n, n, density=2e-4, random_state=rng, format="csr")
        with pytest.raises(ValueError, match="windowable"):
            device_unstructured_sa_setup(
                (R + sp.eye(n, format="csr")).tocsr(), device=CPU)
    elif case == "aggregate":
        with pytest.raises(ValueError, match="aggregate"):
            device_unstructured_sa_setup(A, device=CPU, aggregate="bogus")
    else:
        with pytest.raises(ValueError, match="smooth_passes"):
            device_unstructured_sa_setup(A, device=CPU, smooth_passes=3)


def test_profile_records_each_stage():
    A = _fem_matrix(24)
    prof = {}
    device_unstructured_sa_setup(A, dtype=torch.float64, device=CPU,
                                 profile=prof, **F64)
    assert {"L0.roots", "L0.plan", "L0.build_p", "L0.probe_rap",
            "L0.extract", "L1.roots", "L1.probe_rap"} <= set(prof)
    assert all(v >= 0 for v in prof.values())


if __name__ == "__main__":
    # chip_smoke.py's routed aggressive case (200^2 jittered, scrambled)
    # in float32 with both packages and in float64 with the port, on the
    # CPU: JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
    #     python tests/test_torch_unstructured.py
    for run, (levels, iters, hist, true) in _f32_floor(200, True).items():
        print(f"{run}: levels {levels}, {iters} iterations, history relres "
              f"{hist:.3e}, true relres {true:.3e}")
