"""The port's unstructured classical device setups
(``pyamg_tpu_torch/engine/unstructured_classical.py``: PMIS, direct and
modified Ruge-Stüben interpolation, one-point P with the Neumann AIR
restriction) against the JAX package's, on the CPU.

The same scipy operators as the reference test (tests/
test_unstructured_classical.py: the P1 FEM stiffness matrix plus 1e-2 I,
and upwind advection, whose pattern is nonsymmetric) go to both packages.
The stages agree bit for bit (strength, PMIS, the coarse indices) or to
rtol 1e-12 in float64 (the interpolation weights, the Neumann
restriction); the hierarchies have the same levels, and the solves the
same iteration counts and histories (float64 rtol 1e-6, float32 1e-4).
The coarse operators come from float32-cast probe chains in both
packages, and a chain value on a float32 rounding midpoint may round
either way (1 ulp of a coarse entry), so where a history falls below
1e-7 of its first entry (AIR's first cycle drops it 1e6-fold) it is held
to 1e-7 of the first entry.  The JAX setups are module-scoped fixtures,
so each JAX program compiles once.
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse import csgraph

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_unstructured import _fem_matrix, _np, _to_scipy  # noqa: E402

import pyamg_tpu.engine as je  # noqa: E402
import pyamg_tpu.engine.unstructured_classical as juc  # noqa: E402
from pyamg_tpu.sparse import windowed_from_scipy as jax_windowed  # noqa: E402

import pyamg_tpu_torch.engine.unstructured_classical as tuc  # noqa: E402
from pyamg_tpu_torch import (ComposedWindowed,  # noqa: E402
                             NeumannAIRRestriction, ReorderedSolver,
                             advection_2d, detect_grid, device_air_setup,
                             device_rs_setup, device_unstructured_air_setup,
                             device_unstructured_rs_setup,
                             unstructured_solver_from_jax)
from pyamg_tpu_torch.engine.setup import _hash_weights  # noqa: E402
from pyamg_tpu_torch.sparse import DenseOperator, WindowedELL  # noqa: E402
from pyamg_tpu_torch.sparse.window import windowed_from_scipy  # noqa: E402

CPU = "cpu"
RS = dict(max_coarse=150)
AIR = dict(max_coarse=400)
# a geometry holding every coarse column of the small stage operators
GEOM = (1024, 1024, np.zeros(1, np.int32), 2)
JGEOM = (1024, 1024, (0,), 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _advection(nx, theta=np.pi / 4):
    A, b = advection_2d((nx, nx), theta=theta)
    return sp.csr_matrix(A), np.asarray(b)


def _rcm(A, b=None):
    """A (and b) in the RCM order of |A| + |A^T|: windows stay bounded,
    the grid stencil's constant offsets are gone."""
    perm = csgraph.reverse_cuthill_mckee(sp.csr_matrix(abs(A) + abs(A.T)),
                                         symmetric_mode=True)
    Ap = sp.csr_matrix(A[perm][:, perm])
    return Ap if b is None else (Ap, b[perm])


def _history(solver, b, **kw):
    res = []
    solver.solve(b, residuals=res, **kw)
    res = np.asarray(res, dtype=np.float64)
    return res[~np.isnan(res)]


def _same_history(ht, hj, rtol, floor=0.0):
    """Equal length, the entries within ``rtol`` or within ``floor`` of the
    first entry (AIR: 1e-7, the float32 resolution of the coarse
    operators)."""
    assert len(ht) == len(hj)
    np.testing.assert_allclose(ht, hj, rtol=rtol, atol=floor * hj[0])


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ops():
    """{name: (A, norm, JAX WindowedELL, port WindowedELL)} in float64:
    the 24^2 FEM operator with the RS setup's 'abs' strength, and 32^2
    upwind advection with AIR's 'min'."""
    out = {}
    for name, A, norm in (("fem", _fem_matrix(24), "abs"),
                          ("advection", _advection(32)[0], "min")):
        out[name] = (A, norm, jax_windowed(A, dtype=jnp.float64, block=1024),
                     windowed_from_scipy(A, dtype=torch.float64, device=CPU,
                                         block=1024))
    return out


@pytest.mark.parametrize("name", ["fem", "advection"])
@pytest.mark.parametrize("norm", ["abs", "min"])
def test_strength_mask_matches_reference(ops, name, norm):
    A, _, JW, TW = ops[name]
    got = tuc._cls_strength_mask(TW, 0.25, norm)
    want = juc._cls_strength_mask(JW, 0.25, norm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            np.broadcast_to(g.numpy(), got[0].shape),
            np.broadcast_to(np.asarray(w), got[0].shape))
    assert 0 < int(got[0].sum()) < A.nnz


@pytest.mark.parametrize("name", ["fem", "advection"])
def test_pmis_matches_reference(ops, name):
    """The C mask bit for bit for two seeds; every F point keeps a strong
    C out-neighbour (what direct interpolation needs)."""
    A, norm, JW, TW = ops[name]
    n = A.shape[0]
    for seed in (0, 3):
        got = tuc._stage_pmis(TW, theta=0.25, seed=seed, norm=norm)
        want = juc._stage_pmis(JW, theta=0.25, seed=seed, norm=norm)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < n
        mask, _, col, _ = tuc._cls_strength_mask(TW, 0.25, norm)
        c = got[col.clamp_max(TW.n_pad - 1)] > 0.5
        covered = (mask & c).any(dim=0)[:n]
        assert bool((covered | (got[:n] > 0.5)).all())


def test_strength_indicator_shares_the_column_plan(ops):
    """lambda's operator reuses W's column plan and tile tables (no second
    plan), and its transpose apply gives the strength graph's column
    counts."""
    A, norm, _, TW = ops["fem"]
    mask = tuc._cls_strength_mask(TW, 0.25, norm)[0]
    V = tuc._with_data(TW, mask)
    assert V.column_plan is TW.column_plan
    assert V._tile_tables is TW._tile_tables
    S = sp.csr_matrix((np.ones(int(mask.sum())), (
        np.broadcast_to(np.arange(TW.n_pad), mask.shape)[mask.numpy()],
        tuc._slot_fields(TW)[1][mask].numpy())), shape=(TW.n_pad,) * 2)
    lam = V.rmatvec(torch.ones(TW.n_pad, dtype=torch.float64))[:TW.n_pad]
    np.testing.assert_array_equal(lam.numpy(), np.asarray(S.sum(axis=0))[0])


def _assert_windowed_equal(got, want, rtol=1e-12):
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(want.starts))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=rtol, atol=1e-15)
    assert (got.shape, got.nnz) == (tuple(want.shape), want.nnz)


@pytest.mark.parametrize("name", ["fem", "advection"])
def test_interpolation_stages_match_reference(ops, name):
    """Direct P, the modified M and its P_direct, one-point P and the
    injection Tinj, dinv, rho, the F mask and the coarse indices: float64
    within 1e-12, indices exact."""
    _, norm, JW, TW = ops[name]
    c = tuc._stage_pmis(TW, theta=0.25, seed=0, norm=norm)
    jc = juc._stage_pmis(JW, theta=0.25, seed=0, norm=norm)
    kw = dict(theta=0.25, norm=norm)
    P, dinv, rho, cval = tuc._stage_build_p_rs(
        TW, c, dtype=torch.float64, p_geom=GEOM, **kw)
    JP, Jdinv, Jrho, Jcval = juc._stage_build_p_rs(
        JW, jc, dtype="float64", p_geom=JGEOM, **kw)
    _assert_windowed_equal(P, JP)
    np.testing.assert_array_equal(cval.numpy(), np.asarray(Jcval))
    for a, b in ((dinv, Jdinv), (rho, Jrho)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    M, Pd, _, _ = tuc._stage_build_m_mod(TW, c, dtype=torch.float64,
                                         p_geom=GEOM, **kw)
    JM, JPd, _, _ = juc._stage_build_m_mod(JW, jc, dtype="float64",
                                           p_geom=JGEOM, **kw)
    _assert_windowed_equal(M, JM)
    _assert_windowed_equal(Pd, JPd)
    P1, Tinj, dinv1, fmask, _ = tuc._stage_build_p_onepoint(
        TW, c, dtype=torch.float64, p_geom=GEOM, **kw)
    JP1, JTinj, _, Jfmask, _ = juc._stage_build_p_onepoint(
        JW, jc, dtype="float64", p_geom=JGEOM, **kw)
    _assert_windowed_equal(P1, JP1)
    _assert_windowed_equal(Tinj, JTinj)
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(Jfmask))
    assert P1.k == Tinj.k == 1 and torch.equal(dinv1, dinv)


def _neumann_pair(ops, name, degree):
    _, norm, JW, TW = ops[name]
    c = tuc._stage_pmis(TW, theta=0.25, seed=0, norm=norm)
    jc = juc._stage_pmis(JW, theta=0.25, seed=0, norm=norm)
    kw = dict(theta=0.25, norm=norm)
    P, Tinj, dinv, fmask, _ = tuc._stage_build_p_onepoint(
        TW, c, dtype=torch.float64, p_geom=GEOM, **kw)
    JP, JTinj, Jdinv, Jfmask, _ = juc._stage_build_p_onepoint(
        JW, jc, dtype="float64", p_geom=JGEOM, **kw)
    nc = int(c.sum())
    shape = (-(-nc // 256) * 256, TW.n_pad)
    R = NeumannAIRRestriction(A=TW, Tinj=Tinj,
                              dinv_f=torch.where(fmask, dinv, 0),
                              shape=shape, nnz=TW.nnz, degree=degree)
    JR = juc.NeumannAIRRestriction(A=JW, Tinj=JTinj,
                                   dinv_f=jnp.where(Jfmask, Jdinv, 0),
                                   shape=shape, nnz=TW.nnz, degree=degree)
    return P, R, JP, JR, nc


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_neumann_restriction_matches_reference(ops, degree):
    """R r and R on a K-major stack (K = 3 lanes against the reference's
    (n, K) matmat), float64 within 1e-12; a short vector is zero-padded
    (the port's ``fit``)."""
    _, R, _, JR, nc = _neumann_pair(ops, "advection", degree)
    rng = np.random.default_rng(degree)
    n = R.A.shape[0]
    r = rng.standard_normal(n)
    want = np.asarray(JR.matvec(jnp.asarray(r)))
    got = R @ torch.as_tensor(r)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert got.shape == want.shape and np.abs(want[:nc]).max() > 0
    X = rng.standard_normal((R.A.n_pad, 3))
    want = np.asarray(JR.matmat(jnp.asarray(X)))
    got = R @ torch.as_tensor(X.T.copy())
    np.testing.assert_allclose(got.numpy().T, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def _neumann_dense(A, R, n):
    """R as a dense matrix from scipy: Tinj^T (I - A Z), Z the degree-d
    Neumann series on the F rows."""
    Af = A.toarray()
    df = R.dinv_f.numpy()[:n]
    D, Fm = np.diag(df), np.diag((df != 0).astype(float))
    Z = np.zeros((n, n))
    for _ in range(R.degree):
        Z = Z + D @ (Fm - Af @ Z)
    Ti = _to_scipy(R.Tinj)[:n].toarray()
    return Ti.T @ (np.eye(n) - Af @ Z)


@pytest.mark.parametrize("family", ["rs", "air"])
def test_probe_rap_matches_reference_and_scipy(ops, family):
    """The banded R A P probe (R = P^T for direct RS, the degree-2 Neumann
    restriction for AIR, the chain P, then A, then R) against the
    reference's ``_probe_rap`` / ``_probe_rap_r`` within 1e-6 of the
    band's max (the reference places its float32 chains through a bf16
    split), and against scipy's product (the reference test's 2e-5 /
    1e-6)."""
    A, norm, JW, TW = ops["fem" if family == "rs" else "advection"]
    n = A.shape[0]
    if family == "rs":
        c = tuc._stage_pmis(TW, theta=0.25, seed=0, norm=norm)
        jc = juc._stage_pmis(JW, theta=0.25, seed=0, norm=norm)
        P = tuc._stage_build_p_rs(TW, c, theta=0.25, norm=norm,
                                  dtype=torch.float64, p_geom=GEOM)[0]
        JP = juc._stage_build_p_rs(JW, jc, theta=0.25, norm=norm,
                                   dtype="float64", p_geom=JGEOM)[0]
        R = JR = None
        nc = int(c.sum())
    else:
        P, R, JP, JR, nc = _neumann_pair(ops, "advection", 2)
    nc_pad = -(-nc // 256) * 256
    period = max(-(-nc // 16) * 16, 32)
    cst = np.zeros(nc_pad // 256, np.int64)
    kw = dict(period=period, K=64, nc_pad=nc_pad, bc=256)
    got = tuc._probe_rap(TW, P, torch.as_tensor(cst), dtype=torch.float64,
                         R=R, **kw).reshape(nc_pad, period).numpy()
    if family == "rs":
        want = je.unstructured_setup._probe_rap(
            JW, JP, jnp.asarray(cst, jnp.int32), dtype=jnp.float64, **kw)
    else:
        want = juc._probe_rap_r(JW, JP, JR, jnp.asarray(cst, jnp.int32),
                                dtype=jnp.float64, **kw)
    want = np.asarray(want).reshape(nc_pad, period)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    Pm = _to_scipy(P)[:n, :nc].toarray()
    Rm = Pm.T if R is None else _neumann_dense(A, R, n)[:nc]
    exact = Rm @ A.toarray() @ Pm
    np.testing.assert_allclose(got[:nc, :nc], exact, rtol=2e-5, atol=1e-6)


def _numpy_pmis(A, theta, seed, rounds):
    """PMIS on the classical 'abs' strength graph of A in numpy (the
    module docstring's rules), ``rounds`` rounds, leftovers to C."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    meas = np.where(rows != A.indices, np.abs(A.data), 0.0)
    rowmax = np.maximum.reduceat(meas, A.indptr[:-1])
    strong = (meas >= theta * rowmax[rows]) & (meas > 0)
    S = sp.csr_matrix((np.ones(strong.sum()),
                       (rows[strong], A.indices[strong])), shape=(n, n))
    lam = np.asarray(S.sum(axis=0))[0].astype(np.float32)
    w = lam + _hash_weights(n, seed).numpy()

    def nbr_max(x):
        out = np.full(n, -np.inf)
        np.maximum.at(out, S.tocoo().row, x[S.tocoo().col])
        return out

    state = np.full(n, -1)
    for _ in range(rounds):
        if not (state == -1).any():
            break
        und = state == -1
        wv = np.where(und, w, -1.0).astype(np.float32)
        winners = und & (wv >= np.maximum(nbr_max(wv), 0.0))
        state[winners] = 1
        covered = nbr_max(winners.astype(float)) > 0.5
        state[(state == -1) & covered] = 0
    return (state != 0).astype(np.float32), int((state == -1).sum())


@pytest.mark.parametrize("cap", [1, 2, 64])
def test_pmis_round_cap_promotes_leftovers(ops, monkeypatch, cap):
    """With the round cap lowered, the undecided points left at the cap
    become C points, as a numpy PMIS with the same cap gives them."""
    A, _, _, TW = ops["fem"]
    n = A.shape[0]
    monkeypatch.setattr(tuc, "_MAX_ROUNDS", cap)
    got = tuc._stage_pmis(TW, theta=0.25, seed=1, norm="abs").numpy()
    want, leftover = _numpy_pmis(A, 0.25, 1, cap)
    np.testing.assert_array_equal(got[:n], want)
    assert (leftover > 0) == (cap < 64)


# ---------------------------------------------------------------------------
# whole hierarchies and solves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rs64():
    """(A, {interpolation: (JAX, port)}) float64 RS hierarchies, 32^2."""
    A = _fem_matrix(32)
    return A, {i: (juc.device_unstructured_rs_setup(
        A, dtype=jnp.float64, interpolation=i, **RS),
        device_unstructured_rs_setup(A, dtype=torch.float64, device=CPU,
                                     interpolation=i, **RS))
        for i in ("modified", "direct")}


@pytest.fixture(scope="module")
def air64():
    """(A, b, JAX, port) float64 AIR hierarchies, 40^2 advection."""
    A, b = _advection(40)
    return (A, b, juc.device_unstructured_air_setup(A, dtype=jnp.float64,
                                                    **AIR),
            device_unstructured_air_setup(A, dtype=torch.float64,
                                          device=CPU, **AIR))


def _assert_same_operator(got, want, rtol):
    """Equal as scipy matrices within ``rtol`` of the largest entry, with
    the same pattern once entries below 1e-14 of it are dropped (a coarse
    entry that cancels leaves roundoff, 1e-17 here, in either package)."""
    G, Wm = _to_scipy(got), _to_scipy(want)
    m = min(G.shape[1], Wm.shape[1])
    G, Wm = G[:, :m].tocsr(), Wm[:, :m].tocsr()
    scale = abs(Wm).max()
    for M in (G, Wm):
        M.data[abs(M.data) <= 1e-14 * scale] = 0
        M.eliminate_zeros()
    assert G.shape == Wm.shape and G.nnz == Wm.nnz
    assert abs(G - Wm).max() <= rtol * scale


def _assert_same_levels(T, J):
    assert T.setup_info == J.setup_info
    jl, tl = J.hierarchy.levels, T.hierarchy.levels
    assert [(lv.n, lv.n_pad) for lv in tl] == [(lv.n, lv.n_pad) for lv in jl]
    assert isinstance(tl[-1].A, DenseOperator)


@pytest.mark.parametrize("interp", ["modified", "direct"])
def test_rs_hierarchy_matches_reference(rs64, interp):
    """float64: setup_info identical, every A and P equal to the JAX one
    within 1e-6 (the float32 cast of the probe chains), R = P^T, modified
    P composed of two windowed factors; CG to 1e-8 in the reference's
    count with its history to 1e-6."""
    A, pairs = rs64
    J, T = pairs[interp]
    _assert_same_levels(T, J)
    assert len(T.hierarchy.levels) >= 3
    for a, b in zip(T.hierarchy.levels, J.hierarchy.levels):
        _assert_same_operator(a.A, b.A, 1e-6)
        if b.P is not None:
            _assert_same_operator(a.P, b.P, 1e-6)
            assert isinstance(a.P, ComposedWindowed) == (interp == "modified")
            assert a.R.base is a.P
            assert (a.pre.config, a.post.config) == (b.pre.config,
                                                     b.post.config)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    kw = dict(tol=1e-8, maxiter=60, accel="cg")
    ht, hj = _history(T, b, **kw), _history(J, jnp.asarray(b), **kw)
    _same_history(ht, hj, 1e-6)
    assert ht[-1] <= 1e-8 * ht[0]


def test_rs_coarse_operators_equal_scipy_rap(rs64):
    """Each coarse operator of the direct hierarchy is P^T A P of the one
    above it, entrywise (the reference test's 2e-5 / 1e-6)."""
    A, pairs = rs64
    h = pairs["direct"][1].hierarchy
    for i in range(len(h.levels) - 1):
        n1 = h.levels[i + 1].n
        P = _to_scipy(h.levels[i].P)[:A.shape[0], :n1]
        RAP = (P.T @ A @ P).toarray()
        A1 = _to_scipy(h.levels[i + 1].A)[:n1, :n1]
        np.testing.assert_allclose(A1.toarray(), RAP, rtol=2e-5, atol=1e-6)
        A = sp.csr_matrix(A1)


def test_air_hierarchy_matches_reference(air64):
    """float64: setup_info identical, A, P and the Neumann restriction's
    Tinj and F-masked inverse diagonal equal to the JAX ones, no
    pre-smoother and the masked F-then-C Jacobi after; one cycle drops
    the residual >= 1e4 (the reference test's bar) and FGMRES reaches 1e-8
    in the reference's count (<= 10), histories as the module docstring
    says."""
    A, b, J, T = air64
    _assert_same_levels(T, J)
    for a, lj in zip(T.hierarchy.levels[:-1], J.hierarchy.levels[:-1]):
        _assert_same_operator(a.A, lj.A, 1e-6)
        _assert_same_operator(a.P, lj.P, 1e-6)
        assert isinstance(a.R, NeumannAIRRestriction) and a.R.A is a.A
        assert (a.R.shape, a.R.nnz, a.R.degree) == (
            tuple(lj.R.shape), lj.R.nnz, lj.R.degree)
        _assert_same_operator(a.R.Tinj, lj.R.Tinj, 1e-6)
        np.testing.assert_allclose(a.R.dinv_f.numpy(),
                                   np.asarray(lj.R.dinv_f), rtol=1e-12)
        assert a.pre.config == ("identity",) and a.post.config == \
            lj.post.config
        for x, y in zip(a.post.arrays, lj.post.arrays):
            np.testing.assert_array_equal(_np(x), np.asarray(y))
    h1 = _history(T, b, tol=1e-8, maxiter=2)
    assert h1[0] / h1[1] > 1e4
    kw = dict(tol=1e-8, maxiter=30, accel="fgmres")
    ht, hj = _history(T, b, **kw), _history(J, jnp.asarray(b), **kw)
    _same_history(ht, hj, 1e-6, floor=1e-7)
    assert ht[-1] <= 1e-8 * ht[0] and len(ht) - 1 <= 10


@pytest.fixture(scope="module")
def routed():
    """The routes of device_rs_setup / device_air_setup (no grid=, float32)
    in both packages: {family: (A, b, JAX, port)}.  RS: a seeded random
    permutation of the 80^2 mesh, with max_w2 capped at 2048 in both
    packages (the reference test's TestAutoReorder fixture), so that it is
    not windowable while its RCM reordering is (``reorder="auto"``); AIR:
    RCM-permuted advection 40^2."""
    from pyamg_tpu.engine import unstructured_setup as jus
    from pyamg_tpu_torch.engine import unstructured_setup as tus

    A0 = _fem_matrix(80)
    q = np.random.default_rng(7).permutation(A0.shape[0])
    A = sp.csr_matrix(A0[q][:, q])
    b = np.random.default_rng(4).random(A.shape[0])
    Aa, ba = _rcm(*_advection(40, np.pi / 3))
    with pytest.MonkeyPatch.context() as mp:
        for mod, fn in ((juc, jax_windowed), (jus, jax_windowed),
                        (tus, windowed_from_scipy)):
            mp.setattr(mod, "windowed_from_scipy",
                       functools.partial(fn, max_w2=2048))
        assert tus.windowed_from_scipy(A, device=CPU, block=1024) is None
        rs = (A, b, je.device_rs_setup(A, max_coarse=600),
              device_rs_setup(A, device=CPU, max_coarse=600))
    return {"rs": rs, "air": (Aa, ba, je.device_air_setup(Aa, **AIR),
                              device_air_setup(Aa, device=CPU, **AIR))}


@pytest.mark.parametrize("family", ["rs", "air"])
def test_routes_match_reference(routed, family):
    """An operator detect_grid rejects goes to the unstructured setups
    with the reference's arguments: the same float32 levels and families
    (RS: the unstructured defaults' two Jacobi sweeps, and the same RCM
    permutation, x back in the caller's ordering; AIR: max_levels 4), the
    same iteration count, histories within 1e-4."""
    A, b, J, T = routed[family]
    with pytest.raises(ValueError):
        detect_grid(A)
    if family == "rs":
        assert isinstance(T, ReorderedSolver)
        np.testing.assert_array_equal(T._perm, J._perm)
        assert T.setup_info["reordered"] == "rcm"
        lvl = T.hierarchy.levels[0]
        assert lvl.pre.config == lvl.post.config == ("jacobi_dyn", 2)
        kw = dict(tol=1e-5, maxiter=40, accel="cg")
    else:
        assert type(T).__name__ == "DeviceMultilevelSolver"
        assert len(T.hierarchy.levels) <= 4
        kw = dict(tol=1e-6, maxiter=30, accel="fgmres")
    _assert_same_levels(T, J)
    assert {lv["family"] for lv in T.setup_info["levels"]} == {family}
    ht = _history(T, b, **kw)
    hj = _history(J, jnp.asarray(b, jnp.float32), **kw)
    _same_history(ht, hj, 1e-4, floor=1e-7 if family == "air" else 0.0)
    x = T.solve(b, **kw)
    assert isinstance(x, np.ndarray) and x.shape == b.shape
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 10 * kw["tol"]


def test_route_passes_changed_smoothers_only(monkeypatch):
    """device_rs_setup hands the unstructured setup its smoothers only
    where the caller changed them from its own default, and the other
    arguments always (the reference's pass-through)."""
    from pyamg_tpu_torch.engine import classical_setup

    calls = []
    monkeypatch.setattr(classical_setup, "device_unstructured_rs_setup",
                        lambda A, **kw: calls.append(kw))
    monkeypatch.setattr(classical_setup, "device_unstructured_air_setup",
                        lambda A, **kw: calls.append(kw))
    A = _rcm(_fem_matrix(32))
    cheb = ("chebyshev", {"degree": 3})
    device_rs_setup(A, device=CPU, max_coarse=50, max_levels=5)
    device_rs_setup(A, device=CPU, presmoother=cheb)
    device_air_setup(A, device=CPU, degree=1, omega=0.7, f_iterations=3)
    base = dict(dtype=torch.float32, device=torch.device(CPU),
                mixed_precision=False)
    assert calls[0] == dict(base, max_coarse=50, max_levels=5)
    assert calls[1] == dict(base, max_coarse=400, max_levels=12,
                            presmoother=cheb)
    assert calls[2] == dict(base, degree=1, max_coarse=400, max_levels=4,
                            f_iterations=3, c_iterations=1, omega=0.7)


def test_sharding_the_air_restriction_raises(air64):
    """The AIR level's Neumann restriction shards (rank 0 of 8, level 0's
    two row blocks on two groups: rank 0 keeps the first block of A and
    Tinj and its rows of dinv_f, the masked Jacobi its rows of dinv and of
    each mask), and a batched (n, K) apply of it no longer raises: sharded
    over a world of one, it applies a K-major stack as the unsharded
    restriction does (K12 and K13 on the lanes), bit for bit."""
    from pyamg_tpu_torch import shard_hierarchy
    from pyamg_tpu_torch.parallel.partition import (SolverMesh,
                                                    _ShardedNeumannAIR)
    from pyamg_tpu_torch.sparse.formats import fit

    mesh = SolverMesh(rank=0, world=8, device=torch.device(CPU))
    h = air64[3].hierarchy
    hs = shard_hierarchy(h, mesh, min_local_rows=1024)
    lvl, lvl_s = h.levels[0], hs.levels[0]
    (f,) = lvl_s.R.factors
    assert isinstance(f, _ShardedNeumannAIR) and f.groups == hs.groups[0] == 2
    rows = lvl.R.A.n_pad // f.groups
    assert f.A.n_pad == f.Tinj.n_pad == rows
    assert torch.equal(f.dinv_f, lvl.R.dinv_f[:rows])
    for a, a_s in zip(lvl.post.arrays, lvl_s.post.arrays):
        n = a.shape[0] // hs.groups[0]
        assert torch.equal(a_s, a[:n])
    one = shard_hierarchy(h, SolverMesh(rank=0, world=1,
                                        device=torch.device(CPU)))
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, lvl.n_pad)))
    got = one.levels[0].R.matvec(r)
    want = fit(lvl.R @ r, got.shape[-1])
    assert got.shape == (2, one.levels[1].n_pad)
    assert torch.equal(got, want)


@pytest.mark.parametrize("setup", ["rs", "air"])
def test_mixed_precision_and_bad_options_raise(setup):
    A = _fem_matrix(12)
    fn = (device_unstructured_rs_setup if setup == "rs"
          else device_unstructured_air_setup)
    with pytest.raises(NotImplementedError, match="mixed precision"):
        fn(A, device=CPU, mixed_precision=True)
    if setup == "rs":
        with pytest.raises(ValueError, match="interpolation"):
            fn(A, device=CPU, interpolation="classical")
        gs = ("gauss_seidel", {})
        with pytest.raises(ValueError, match="jacobi/richardson/chebyshev"):
            fn(A, device=CPU, presmoother=gs)


def test_solvers_from_jax_give_its_histories(rs64, air64):
    """The JAX hierarchies' arrays carried across (the composed RS
    prolongator, the Neumann restriction with its level's A shared, the
    masked Jacobi) solve with the JAX solve's history, plain and inside
    the JAX solver's permutation."""
    A, pairs = rs64
    J = pairs["modified"][0]
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    C = unstructured_solver_from_jax(J, CPU)
    assert C.setup_info == J.setup_info
    kw = dict(tol=1e-8, maxiter=60, accel="cg")
    np.testing.assert_allclose(_history(C, b, **kw),
                               _history(J, jnp.asarray(b), **kw), rtol=1e-10)
    Aa, ba, Ja, _ = air64
    Ca = unstructured_solver_from_jax(Ja, CPU)
    R = Ca.hierarchy.levels[0].R
    assert isinstance(R, NeumannAIRRestriction)
    assert R.A is Ca.hierarchy.levels[0].A and R.degree == 2
    kw = dict(tol=1e-8, maxiter=30, accel="fgmres")
    hj = _history(Ja, jnp.asarray(ba), **kw)
    np.testing.assert_allclose(_history(Ca, ba, **kw), hj, rtol=1e-10,
                               atol=1e-12 * hj[0])
    perm = np.random.default_rng(8).permutation(Aa.shape[0])
    JR = je.unstructured_setup.ReorderedSolver(Ja, perm)
    CR = unstructured_solver_from_jax(JR, CPU)
    assert isinstance(CR, ReorderedSolver)
    np.testing.assert_allclose(CR.solve(ba, **kw),
                               np.asarray(JR.solve(ba, **kw)),
                               rtol=1e-8, atol=1e-12)


def test_lane_stack_solve_and_profile(air64):
    """A K-major stack goes through the Neumann restriction lane by lane
    (each lane the 1-D solve's history); ``profile={}`` records each stage
    of each level."""
    A, b, _, T = air64
    B = np.stack([b, np.random.default_rng(5).standard_normal(A.shape[0])],
                 axis=1)
    kw = dict(tol=1e-8, maxiter=30, accel="fgmres")
    res = []
    T.solve(B, residuals=res, **kw)
    for k in range(2):
        np.testing.assert_allclose(res[k], _history(T, B[:, k], **kw),
                                   rtol=1e-10, atol=1e-12 * res[k][0])
    prof = {}
    device_unstructured_rs_setup(_fem_matrix(24), dtype=torch.float64,
                                 device=CPU, max_coarse=50, profile=prof)
    assert {"L0.pmis", "L0.plan", "L0.build_p", "L0.probe_rap",
            "L0.extract", "L1.pmis"} <= set(prof)
    assert all(v >= 0 for v in prof.values())
    assert isinstance(T.hierarchy.levels[0].A, WindowedELL)


if __name__ == "__main__":
    # chip_smoke.py's parity pins (UCL_PARITY, UCL_AIR_PARITY) from the
    # JAX package on the CPU: JAX_PLATFORMS=cpu JAX_ENABLE_X64=1
    # PYTHONPATH=. python tests/test_torch_unstructured_classical.py
    A = _fem_matrix(200)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    for interp in ("modified", "direct"):
        for dt in (jnp.float32, jnp.float64):
            s = juc.device_unstructured_rs_setup(A, dtype=dt,
                                                 interpolation=interp)
            h = _history(s, jnp.asarray(b, dt), tol=1e-6, maxiter=100,
                         accel="cg")
            print(f"RS {interp} 200^2 {np.dtype(dt).name}: levels "
                  f"{[lv.n for lv in s.hierarchy.levels]}, {len(h) - 1} CG")
    Aa, ba = _rcm(*_advection(128))
    for dt in (jnp.float32, jnp.float64):
        s = je.device_air_setup(Aa, dtype=dt)
        h = _history(s, jnp.asarray(ba, dt), tol=1e-8, maxiter=30,
                     accel="fgmres")
        print(f"AIR routed 128^2 {np.dtype(dt).name}: levels "
              f"{[lv.n for lv in s.hierarchy.levels]}, {len(h) - 1} FGMRES")
