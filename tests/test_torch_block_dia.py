"""The port's block-DIA format, block smoothers and host-built BSR compile
against the JAX package, on the CPU.

- ``block_dia_from_scipy`` and every ``BlockDIAMatrix`` apply (A x, A X on
  a K-major lane stack and on a column stack, A^T x, the scalar and block
  diagonals) against scipy's BSR products and the JAX ``BlockDIAMatrix``,
  float64, to 1e-13 of the largest entry: 2-D elasticity (2x2 blocks) and
  a random banded BSR operator of 3x3 blocks.
- ``_block_apply`` and the three block smoothers (``block_jacobi``,
  ``block_jacobi_dyn``, ``block_mcgs`` forward and symmetric) from a
  nonzero guess and from zero against the JAX ``apply_smoother`` /
  ``apply_smoother_zero`` on the elasticity block-DIA operator, float64
  to rtol 1e-12; a K = 3 lane stack lane by lane against the vector.
- ``compile_hierarchy`` on the reference's rootnode hierarchy of
  ``linear_elasticity((48, 48))`` (``row_pad=8``, the counterpart of
  ``tests/test_engine.py::test_device_elasticity_block_dia_path``): level
  0 a ``BlockDIAMatrix``, the same smoother configs and arrays as the JAX
  compile (block multicolour GS by default, block Jacobi with its weight
  from rho(block-D^-1 A)), and the same float64 CG history (rtol 1e-8:
  the two packages sum the block products in other orders) and count.
- The C/F repair: ``cf_block_jacobi`` / ``fc_block_jacobi`` on a BSR
  level with a C/F splitting compile, as in the reference, to the masked
  point Jacobi (a node's mask covering its 2 rows).
"""
import types
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pyamg_tpu  # noqa: E402
from pyamg_tpu.engine import compile_hierarchy as jax_compile  # noqa: E402
from pyamg_tpu.engine import relaxation as jrel  # noqa: E402
from pyamg_tpu.engine.hierarchy import \
    _compile_smoother as jax_compile_smoother  # noqa: E402
from pyamg_tpu.engine.solver import \
    DeviceMultilevelSolver as JaxSolver  # noqa: E402
from pyamg_tpu.gallery import linear_elasticity as jax_elasticity  # noqa: E402
from pyamg_tpu.relaxation.smoothing import change_smoothers  # noqa: E402
from pyamg_tpu.sparse import \
    block_dia_from_scipy as jax_block_dia  # noqa: E402

from pyamg_tpu_torch import (BlockDIAMatrix, DeviceMultilevelSolver,  # noqa: E402
                             block_dia_from_scipy, compile_hierarchy,
                             linear_elasticity)
from pyamg_tpu_torch.engine import relaxation as rel  # noqa: E402
from pyamg_tpu_torch.engine.hierarchy import \
    _compile_smoother  # noqa: E402

CPU = "cpu"
APPLY_TOL = 1e-13       # block-DIA applies, of the largest entry
SMOOTH_TOL = 1e-12      # block smoothers, float64
HIST_RTOL = 1e-8        # CG histories on one hierarchy compiled twice
LANES = 3


@pytest.fixture(autouse=True, scope="module")
def _x64_one_thread():
    """float64 JAX, and one torch thread (the test workers share the
    cores)."""
    jax.config.update("jax_enable_x64", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _banded_bsr(nb=60, bs=3, seed=0):
    """A random square BSR matrix of bs x bs blocks on 5 block diagonals."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in (-7, -1, 0, 1, 7):
        r = np.arange(max(0, -off), min(nb, nb - off))
        rows.append(r)
        cols.append(r + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    data = rng.standard_normal((len(rows), bs, bs))
    coo = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(nb, nb))
    order = np.lexsort((coo.col, coo.row))
    indptr = np.searchsorted(coo.row[order], np.arange(nb + 1))
    return sp.bsr_matrix((data[order], coo.col[order], indptr),
                         shape=(nb * bs, nb * bs))


@pytest.fixture(scope="module")
def elasticity():
    A, B = linear_elasticity((12, 12))
    Aj, Bj = jax_elasticity((12, 12))
    return A, B, Aj, Bj


def test_linear_elasticity_is_the_reference(elasticity):
    A, B, Aj, Bj = elasticity
    assert A.format == "bsr" and A.blocksize == (2, 2) == Aj.blocksize
    assert (A.tocsr() != Aj.tocsr()).nnz == 0
    np.testing.assert_array_equal(B, Bj)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("which", ["elasticity", "banded_bs3"])
def test_block_dia_applies_match_scipy_and_jax(which, elasticity):
    A = elasticity[0] if which == "elasticity" else _banded_bsr()
    n = A.shape[0]
    bs = A.blocksize[0]
    n_pad = n + 4 * bs
    T = block_dia_from_scipy(A, dtype=torch.float64, device=CPU, n_pad=n_pad)
    J = jax_block_dia(A, dtype=jnp.float64, n_pad=n_pad)
    assert isinstance(T, BlockDIAMatrix)
    assert (T.offsets, T.shape, T.bs, T.nnz) == (J.offsets, J.shape, J.bs,
                                                 J.nnz)
    assert (T.nb_pad, T.n_pad, T.ndiags) == (J.nb_pad, J.n_pad, J.ndiags)
    assert T.dtype == torch.float64
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
    rng = np.random.default_rng(1)
    x = np.zeros(n_pad)
    x[:n] = rng.standard_normal(n)
    X = np.zeros((LANES, n_pad))
    X[:, :n] = rng.standard_normal((LANES, n))
    xt = torch.as_tensor(x)
    Ax, ATx = A @ x[:n], A.T @ x[:n]
    assert _rel(T.matvec(xt)[:n], Ax) <= APPLY_TOL
    assert _rel((T @ xt).numpy(), np.asarray(J @ jnp.asarray(x))) <= APPLY_TOL
    assert _rel(T.rmatvec(xt)[:n], ATx) <= APPLY_TOL
    assert _rel(T.rmatvec(xt).numpy(),
                np.asarray(J.rmatvec(jnp.asarray(x)))) <= APPLY_TOL
    # a K-major lane stack against the JAX column stack
    Y = (T @ torch.as_tensor(X)).numpy()
    assert Y.shape == (LANES, n_pad)
    assert _rel(Y, np.asarray(J.matmat(jnp.asarray(X.T))).T) <= APPLY_TOL
    assert _rel(Y[:, :n], (A @ X[:, :n].T).T) <= APPLY_TOL
    assert _rel(T.matmat(torch.as_tensor(X.T)).numpy(), Y.T) == 0
    np.testing.assert_array_equal(T.diagonal().numpy(),
                                  np.asarray(J.diagonal()))
    np.testing.assert_array_equal(T.block_diagonal().numpy(),
                                  np.asarray(J.block_diagonal()))
    assert block_dia_from_scipy(A, dtype=torch.float64, device=CPU,
                                max_diags=T.ndiags - 1) is None
    with pytest.raises(ValueError, match="multiple of the block size"):
        block_dia_from_scipy(A, dtype=torch.float64, device=CPU,
                             n_pad=n + 1)


@pytest.mark.parametrize("nb,size", [(1, 4), (7, 0), (7, 40), (500, 3000)])
def test_distinct_offsets_match_unique(nb, size):
    """The count over (-nb, nb) gives ``np.unique``'s values and places."""
    from pyamg_tpu_torch.sparse.block_dia import _distinct

    offs = np.random.default_rng(nb + size).integers(-nb + 1, nb, size)
    for got, want in zip(_distinct(offs, nb),
                         np.unique(offs, return_inverse=True)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the block smoothers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_level(elasticity):
    """The elasticity block-DIA operator in both packages, its inverse
    diagonal blocks, node colours and a nonzero guess and right-hand
    side."""
    from pyamg_tpu_torch.engine.hierarchy import (_block_colors_for,
                                                  _device_block_dinv)

    A = elasticity[0]
    n = A.shape[0]
    n_pad = n + 8
    T = block_dia_from_scipy(A, dtype=torch.float64, device=CPU, n_pad=n_pad)
    J = jax_block_dia(A, dtype=jnp.float64, n_pad=n_pad)
    Dinv = _device_block_dinv(A, 2, T.nb_pad, torch.float64, CPU)
    colors, ncolors = _block_colors_for(A, 2, T.nb_pad, CPU)
    rng = np.random.default_rng(2)
    x = np.zeros((LANES, n_pad))
    b = np.zeros((LANES, n_pad))
    x[:, :n] = rng.standard_normal((LANES, n))
    b[:, :n] = rng.standard_normal((LANES, n))
    return T, J, Dinv, colors, ncolors, x, b


def _block_smoothers(kind, Dinv, colors, ncolors):
    """(JAX smoother, port smoother) of ``kind`` on the same arrays."""
    Dj, cj = jnp.asarray(Dinv.numpy()), jnp.asarray(colors.numpy())
    if kind == "block_jacobi":
        return (jrel.block_jacobi(Dj, 0.7, iterations=2),
                rel.block_jacobi(Dinv, 0.7, iterations=2))
    if kind == "block_jacobi_dyn":
        w = 0.55
        return (jrel.block_jacobi_dyn(Dj, jnp.asarray(w), iterations=3),
                rel.block_jacobi_dyn(Dinv, torch.tensor(w,
                                                        dtype=torch.float64),
                                     iterations=3))
    sweep = kind.split("_")[-1]
    return (jrel.block_multicolor_gs(Dj, cj, ncolors, sweep=sweep),
            rel.block_multicolor_gs(Dinv, colors, ncolors, sweep=sweep))


def test_block_apply_matches_reference(block_level):
    T, _, Dinv, _, _, x, _ = block_level
    r2 = x[0].reshape(-1, 2)
    want = np.asarray(jrel._block_apply(jnp.asarray(Dinv.numpy()),
                                        jnp.asarray(r2)))
    got = rel._block_apply(Dinv, torch.as_tensor(r2)).numpy()
    assert _rel(got, want) <= SMOOTH_TOL
    lanes = rel._block_apply(Dinv, torch.as_tensor(x.reshape(LANES, -1, 2)))
    np.testing.assert_allclose(lanes[0].numpy(), got, rtol=0,
                               atol=SMOOTH_TOL * np.abs(got).max())


@pytest.mark.parametrize("kind", ["block_jacobi", "block_jacobi_dyn",
                                  "block_mcgs_forward",
                                  "block_mcgs_symmetric"])
def test_block_smoothers_match_reference(kind, block_level):
    T, J, Dinv, colors, ncolors, x, b = block_level
    js, ts = _block_smoothers(kind, Dinv, colors, ncolors)
    assert ts.config == js.config
    want = np.asarray(jrel.apply_smoother(js.config, js.arrays, J,
                                          jnp.asarray(x[0]),
                                          jnp.asarray(b[0])))
    want0 = np.asarray(jrel.apply_smoother_zero(js.config, js.arrays, J,
                                                jnp.asarray(b[0])))
    got = ts(T, torch.as_tensor(x[0]), torch.as_tensor(b[0])).numpy()
    got0 = ts.zero_call(T, torch.as_tensor(b[0])).numpy()
    assert _rel(got, want) <= SMOOTH_TOL
    assert _rel(got0, want0) <= SMOOTH_TOL
    # a block level never takes the fused DIA forms: the caller composes
    assert ts.zero_call_residual(T, torch.as_tensor(b[0])) is None
    assert ts.call_residual(T, torch.as_tensor(x[0]),
                            torch.as_tensor(b[0])) is None
    # a K = 3 lane stack, lane by lane
    lanes = ts(T, torch.as_tensor(x), torch.as_tensor(b)).numpy()
    lanes0 = ts.zero_call(T, torch.as_tensor(b)).numpy()
    for k in range(LANES):
        wk = np.asarray(jrel.apply_smoother(js.config, js.arrays, J,
                                            jnp.asarray(x[k]),
                                            jnp.asarray(b[k])))
        assert _rel(lanes[k], wk) <= SMOOTH_TOL
    assert _rel(lanes0[0], want0) <= SMOOTH_TOL


# ---------------------------------------------------------------------------
# the host-built BSR compile (config 4's host hierarchy)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rootnode():
    """The reference's rootnode hierarchy of 2-D elasticity 48^2 (BSR
    2x2 levels, symmetric block Gauss-Seidel) and b."""
    A, B = jax_elasticity((48, 48))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ml = pyamg_tpu.rootnode_solver(A, B=B, strength="symmetric")
    b = np.random.default_rng(5).random(A.shape[0])
    return A, ml, b


def _assert_same_smoother(js, ts):
    assert ts.config == tuple(js.config), (js.config, ts.config)
    assert len(js.arrays) == len(ts.arrays)
    for a, t in zip(js.arrays, ts.arrays):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            np.testing.assert_allclose(t.numpy(), a, rtol=1e-15, atol=0)


@pytest.mark.parametrize("spec", [None, ("block_jacobi", {"omega": 0.8})],
                         ids=["block_gauss_seidel", "block_jacobi"])
def test_rootnode_compile_matches_reference(spec, rootnode):
    """Level 0 is a BlockDIAMatrix in both compiles, every smoother is
    the reference's, and CG takes the reference's steps."""
    A, ml, b = rootnode
    if spec is not None:
        change_smoothers(ml, spec, spec)
    try:
        hj = jax_compile(ml, dtype=jnp.float64, row_pad=8)
        ht = compile_hierarchy(ml, dtype=torch.float64, device=CPU,
                               row_pad=8)
    finally:
        if spec is not None:
            sym = ("block_gauss_seidel", {"sweep": "symmetric"})
            change_smoothers(ml, sym, sym)
    assert type(hj.levels[0].A).__name__ == "BlockDIAMatrix"
    assert isinstance(ht.levels[0].A, BlockDIAMatrix)
    assert ht.levels[0].A.offsets == hj.levels[0].A.offsets
    kinds = {"block_mcgs"} if spec is None else {"block_jacobi"}
    assert {lt.pre.config[0] for lt in ht.levels[:-1]} == kinds
    for lj, lt in zip(hj.levels, ht.levels):
        assert type(lt.A).__name__ == type(lj.A).__name__
        assert (lt.n, lt.n_pad) == (lj.n, lj.n_pad)
        _assert_same_smoother(lj.pre, lt.pre)
        _assert_same_smoother(lj.post, lt.post)
    rj, rt = [], []
    kw = dict(tol=1e-8, maxiter=60, accel="cg")
    JaxSolver(hj).solve(b, residuals=rj, **kw)
    x = DeviceMultilevelSolver(ht).solve(b, residuals=rt, **kw)
    assert len(rt) == len(rj) > 5
    np.testing.assert_allclose(rt, rj, rtol=HIST_RTOL)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


@pytest.mark.parametrize("name", ["cf_block_jacobi", "fc_block_jacobi"])
def test_cf_block_jacobi_on_a_bsr_level(name, rootnode):
    """The C/F block forms on a BSR level (2x2 blocks) with a C/F
    splitting compile, as in the reference, to the masked point Jacobi:
    the same masks (a node's covering its 2 rows), inverse diagonal and
    sweep counts, and the same sweep on the level's block-DIA operator."""
    A, ml, _ = rootnode
    A0 = ml.levels[0].A
    nb = A0.shape[0] // 2
    splitting = (np.random.default_rng(4).random(nb) < 0.3).astype(np.int8)
    lvl = types.SimpleNamespace(A=A0, splitting=splitting)
    spec = (name, {"omega": 0.9, "f_iterations": 2, "c_iterations": 1})
    n_pad = A0.shape[0] + 8
    js = jax_compile_smoother(lvl, spec, jnp.float64, n_pad)
    ts = _compile_smoother(lvl, spec, torch.float64, n_pad, CPU)
    assert ts.config[0] == "masked_jacobi"
    _assert_same_smoother(js, ts)
    cmask = ts.arrays[1] if name.startswith("cf") else ts.arrays[2]
    np.testing.assert_array_equal(cmask[:nb * 2].reshape(nb, 2).numpy(),
                                  np.repeat(splitting[:, None] == 1, 2, 1))
    T = block_dia_from_scipy(A0, dtype=torch.float64, device=CPU,
                             n_pad=n_pad)
    J = jax_block_dia(A0, dtype=jnp.float64, n_pad=n_pad)
    rng = np.random.default_rng(6)
    x, b = np.zeros(n_pad), np.zeros(n_pad)
    x[:A0.shape[0]] = rng.standard_normal(A0.shape[0])
    b[:A0.shape[0]] = rng.standard_normal(A0.shape[0])
    want = np.asarray(jrel.apply_smoother(js.config, js.arrays, J,
                                          jnp.asarray(x), jnp.asarray(b)))
    got = ts(T, torch.as_tensor(x), torch.as_tensor(b)).numpy()
    assert _rel(got, want) <= SMOOTH_TOL
