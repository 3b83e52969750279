"""Each device smoother kind of the port against the JAX package's
``apply_smoother`` / ``apply_smoother_zero`` (``pyamg_tpu/engine/
relaxation.py``), on the CPU.

Two operators: a DIA one (2-D Poisson 32^2, the multicolour colour steps
and the masked Jacobi sweeps then run K2's twin with a per-colour or
per-mask inverse diagonal, the Horner steps K1's ``SPMV_ADD`` twin) and a windowed one (a nonsymmetric 2-D
convection-diffusion operator on 48^2, whose transpose apply and column
padding the Cimmino sweeps exercise).  Each kind is applied from a
nonzero guess (``__call__``) and from zero (``zero_call``), to one vector
and to a K = 3 lane stack (each lane against the reference's 1-D result),
on the same numpy inputs: float64 to rtol 1e-12, float32 to 1e-5 (of the
largest entry).
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyamg_tpu.engine import relaxation as jrel  # noqa: E402
from pyamg_tpu.engine.hierarchy import \
    _windowed_schwarz_blocks as jax_schwarz_blocks  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402
from pyamg_tpu.graph import vertex_coloring as jax_coloring  # noqa: E402
from pyamg_tpu.sparse.dia import dia_from_scipy as jax_dia  # noqa: E402
from pyamg_tpu.sparse.window import \
    windowed_from_scipy as jax_windowed  # noqa: E402

from pyamg_tpu_torch.engine import relaxation as rel  # noqa: E402
from pyamg_tpu_torch.sparse import (DIAMatrix, dia_from_scipy,  # noqa: E402
                                    windowed_from_scipy)

CPU = "cpu"
LANES = 3
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@pytest.fixture(autouse=True, scope="module")
def _x64_one_thread():
    """float64 JAX, and one torch thread (the test workers share the
    cores)."""
    jax.config.update("jax_enable_x64", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _operator(which):
    if which == "dia":
        return poisson((32, 32), format="csr")
    # -Laplacian + upwinded convection (nonsymmetric), and a few scattered
    # couplings so the operator is windowed rather than DIA
    n = 48
    A = poisson((n, n), format="csr").tolil()
    for i in range(n * n - 1):
        A[i, i + 1] += -0.4
        A[i, i] += 0.4
    rng = np.random.default_rng(7)
    for i in rng.integers(0, n * n - 60, 40):
        A[i, i + int(rng.integers(20, 60))] = -0.05
    return sp.csr_matrix(A)


def _pair(which, dtype):
    A = _operator(which)
    if which == "dia":
        J = jax_dia(A, dtype=JNP[dtype], row_pad=1024)
        T = dia_from_scipy(A, dtype=dtype, device=CPU, row_pad=1024)
        assert isinstance(T, DIAMatrix) and J.n_pad == T.n_pad
    else:
        J = jax_windowed(A, dtype=JNP[dtype])
        T = windowed_from_scipy(A, dtype=dtype, device=CPU)
        assert J is not None and T is not None and J.n_pad == T.n_pad
        assert T.m_chunks * T.w2 != T.n_pad    # rmatvec output is cut
    return A, J, T


def _padded(v, n_pad):
    out = np.zeros(n_pad)
    out[: len(v)] = v
    return out


def _arrays(kind, A, n_pad, dtype):
    """The constructor arguments of ``kind`` as numpy values, the same for
    both packages."""
    d = A.diagonal()
    dinv = _padded(np.where(d != 0, 1.0 / d, 0.0), n_pad)
    rho = float(abs(A).sum(axis=1).max())         # a Gershgorin bound
    if kind.startswith("mcgs"):
        colors = np.full(n_pad, -1, dtype=np.int32)
        c = jax_coloring(A)
        colors[: len(c)] = c
        ncolors = int(c.max()) + 1
        sweep = kind.split("_")[1]
        return ("mcgs", dinv, colors, ncolors, dict(sweep=sweep))
    coef = np.array([-0.31, 1.47, -2.2, 1.5]) / np.array(
        [rho ** 4, rho ** 3, rho ** 2, rho])
    if kind == "poly":
        return ("poly", coef)
    if kind == "poly_dyn":
        return ("poly_dyn", coef)
    if kind == "richardson":
        return ("richardson", 0.9 / rho)
    if kind == "richardson_dyn":
        return ("richardson_dyn", 0.9 / rho)
    if kind in ("jacobi_ne", "jacobi_nr"):
        sq = sp.csr_matrix(A).copy()
        sq.data = sq.data ** 2
        norm2 = np.asarray(sq.sum(axis=1 if kind == "jacobi_ne" else 0))
        dvals = _padded(1.0 / norm2.ravel(), n_pad)
        return (kind, dvals, 0.7)
    if kind == "win_schwarz":
        return ("win_schwarz", jax_schwarz_blocks(sp.csr_matrix(A), n_pad,
                                                  16, 8))
    if kind == "jacobi_dyn":
        return ("jacobi_dyn", dinv, 0.8)
    if kind == "masked_jacobi":
        # F = the rows off every third index, C the others; padded rows in
        # neither
        rows = np.arange(n_pad) < A.shape[0]
        f = rows & (np.arange(n_pad) % 3 != 0)
        return ("masked_jacobi", dinv, f, rows & ~f)
    raise AssertionError(kind)


def _smoothers(kind, A, n_pad, dtype):
    spec = _arrays(kind, A, n_pad, dtype)
    jd = JNP[dtype]

    def j(v, dt=jd):
        return jnp.asarray(v, dtype=dt)

    def t(v, dt=dtype):
        return torch.as_tensor(np.asarray(v), dtype=dt)

    name = spec[0]
    if name == "mcgs":
        _, dinv, colors, ncolors, kw = spec
        return (jrel.multicolor_gs(j(dinv), j(colors, jnp.int32), ncolors,
                                   **kw),
                rel.multicolor_gs(t(dinv), t(colors, torch.int32), ncolors,
                                  **kw))
    if name == "poly":
        return (jrel.polynomial(spec[1], 2), rel.polynomial(spec[1], 2))
    if name == "poly_dyn":
        return (jrel.polynomial_dyn(j(spec[1]), 2),
                rel.polynomial_dyn(t(spec[1]), 2))
    if name == "richardson":
        return (jrel.richardson(spec[1], 3), rel.richardson(spec[1], 3))
    if name == "richardson_dyn":
        return (jrel.richardson_dyn(j(spec[1]), 3),
                rel.richardson_dyn(t(spec[1]), 3))
    if name in ("jacobi_ne", "jacobi_nr"):
        return (getattr(jrel, name)(j(spec[1]), spec[2], 2),
                getattr(rel, name)(t(spec[1]), spec[2], 2))
    if name == "win_schwarz":
        return (jrel.windowed_schwarz(j(spec[1]), 16, 8, omega=0.9,
                                      iterations=2),
                rel.windowed_schwarz(t(spec[1]), 16, 8, omega=0.9,
                                     iterations=2))
    if name == "jacobi_dyn":
        return (jrel.jacobi_dyn(j(spec[1]), j(spec[2]), 2),
                rel.jacobi_dyn(t(spec[1]), t(spec[2]), 2))
    if name == "masked_jacobi":
        _, dinv, f, c = spec
        kw = dict(iters_per_mask=(2, 1), omega=0.8, iterations=2)
        return (jrel.masked_jacobi(j(dinv), (j(f, bool), j(c, bool)), **kw),
                rel.masked_jacobi(t(dinv), (t(f, torch.bool),
                                            t(c, torch.bool)), **kw))
    raise AssertionError(name)


KINDS = ["mcgs_forward", "mcgs_backward", "mcgs_symmetric", "poly",
         "poly_dyn", "richardson", "richardson_dyn", "jacobi_ne",
         "jacobi_nr", "win_schwarz", "jacobi_dyn", "masked_jacobi"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("op", ["dia", "windowed"])
@pytest.mark.parametrize("kind", KINDS)
def test_smoother_matches_reference(kind, op, dtype):
    A, J, T = _pair(op, dtype)
    n_pad = T.n_pad
    js, ts = _smoothers(kind, A, n_pad, dtype)
    assert ts.config == js.config
    rng = np.random.default_rng(11)
    X = np.stack([_padded(rng.random(A.shape[0]), n_pad)
                  for _ in range(LANES)])
    B = np.stack([_padded(rng.random(A.shape[0]), n_pad)
                  for _ in range(LANES)])
    jd = JNP[dtype]
    want_call = [np.asarray(js(J, jnp.asarray(x, jd), jnp.asarray(b, jd)))
                 for x, b in zip(X, B)]
    want_zero = [np.asarray(js.zero_call(J, jnp.asarray(b, jd)))
                 for b in B]
    Xt = torch.as_tensor(X, dtype=dtype)
    Bt = torch.as_tensor(B, dtype=dtype)
    got = {"call": ts(T, Xt[0], Bt[0]), "zero": ts.zero_call(T, Bt[0]),
           "call_k": ts(T, Xt, Bt), "zero_k": ts.zero_call(T, Bt)}
    tol = TOL[dtype]
    for form, want in (("call", want_call[:1]), ("zero", want_zero[:1]),
                       ("call_k", want_call), ("zero_k", want_zero)):
        g = got[form].numpy().reshape(len(want), -1)
        assert g.dtype == np.dtype(str(dtype).removeprefix("torch."))
        for lane, w in enumerate(want):
            np.testing.assert_allclose(
                g[lane], w, rtol=tol, atol=tol * np.abs(w).max(),
                err_msg=f"{kind} {op} {form} lane {lane}")
        assert np.isfinite(g).all()


def test_multicolor_stack_is_built_with_the_smoother():
    """The smoother's (ncolors, n_pad) per-colour inverse diagonals: zero
    outside each colour and on padded rows, built once on the device and
    read only by colour steps on a DIA operator."""
    dinv = torch.tensor([0.5, 0.25, 0.2, 0.1, 0.0])
    colors = torch.tensor([0, 1, 0, 2, -1], dtype=torch.int32)
    sm = rel.multicolor_gs(dinv, colors, 3, sweep="symmetric")
    want = torch.tensor([[0.5, 0.0, 0.2, 0.0, 0.0],
                         [0.0, 0.25, 0.0, 0.0, 0.0],
                         [0.0, 0.0, 0.0, 0.1, 0.0]])
    assert torch.equal(sm.color_dinv, want)
    assert sm.color_dinv is sm.color_dinv
    assert rel.jacobi(dinv, 1.0).color_dinv is None
    assert sm._stack(object()) is None


def test_mask_stack_is_built_with_the_smoother():
    """A masked Jacobi smoother's (nmasks, n_pad) inverse diagonals, in
    its mask order: dinv on the mask, zero off it; built once and read
    only by the sweeps on a DIA operator."""
    dinv = torch.tensor([0.5, 0.25, 0.2, 0.1, 0.0])
    f = torch.tensor([True, False, True, False, False])
    c = torch.tensor([False, True, False, True, False])
    sm = rel.masked_jacobi(dinv, (f, c), (2, 1))
    want = torch.tensor([[0.5, 0.0, 0.2, 0.0, 0.0],
                         [0.0, 0.25, 0.0, 0.1, 0.0]])
    assert torch.equal(sm.mask_dinv, want)
    assert sm.mask_dinv is sm.mask_dinv and sm.color_dinv is None
    assert rel.jacobi(dinv, 1.0).mask_dinv is None
    assert sm._stack(object()) is None


def test_only_single_jacobi_sweeps_fuse_the_residual():
    """zero_call_residual / call_residual fuse only a single Jacobi sweep
    on a DIA operator; every other kind returns None (the caller
    composes), as the reference's do."""
    A, _, T = _pair("dia", torch.float64)
    n_pad = T.n_pad
    b = torch.rand(n_pad, dtype=torch.float64)
    for kind in KINDS:
        _, ts = _smoothers(kind, A, n_pad, torch.float64)
        assert ts.zero_call_residual(T, b) is None
        assert ts.call_residual(T, b, b) is None
    one = rel.jacobi(torch.ones(n_pad, dtype=torch.float64) / 4, 0.8)
    assert one.zero_call_residual(T, b) is not None


@pytest.mark.parametrize("kind", ["block_jacobi", "block_mcgs"])
def test_unported_kinds_raise(kind):
    """The block kinds (ported) on a scalar DIA operator with 2x2 node
    blocks: from a nonzero guess and from zero, one vector and a K = 3
    stack, against the JAX ``apply_smoother`` (float64, rtol 1e-12); they
    never take the fused single-sweep forms."""
    from pyamg_tpu.util.utils import get_block_diag

    A, J, T = _pair("dia", torch.float64)
    n, n_pad = A.shape[0], T.n_pad
    Dinv = np.zeros((n_pad // 2, 2, 2))
    Dinv[: n // 2] = get_block_diag(A, 2, inv_flag=True)
    if kind == "block_jacobi":
        js = jrel.block_jacobi(jnp.asarray(Dinv), 0.6, iterations=2)
        ts = rel.block_jacobi(torch.as_tensor(Dinv), 0.6, iterations=2)
    else:
        colors = np.full(n_pad // 2, -1, dtype=np.int32)
        colors[: n // 2] = np.arange(n // 2) % 2
        js = jrel.block_multicolor_gs(jnp.asarray(Dinv), jnp.asarray(colors),
                                      2, sweep="symmetric")
        ts = rel.block_multicolor_gs(torch.as_tensor(Dinv),
                                     torch.as_tensor(colors), 2,
                                     sweep="symmetric")
    assert ts.config == js.config
    rng = np.random.default_rng(9)
    x = rng.standard_normal((LANES, n_pad))
    b = rng.standard_normal((LANES, n_pad))
    x[:, n:] = b[:, n:] = 0
    want = [np.asarray(jrel.apply_smoother(js.config, js.arrays, J,
                                           jnp.asarray(x[k]),
                                           jnp.asarray(b[k])))
            for k in range(LANES)]
    want0 = np.asarray(jrel.apply_smoother_zero(js.config, js.arrays, J,
                                                jnp.asarray(b[0])))
    got = ts(T, torch.as_tensor(x[0]), torch.as_tensor(b[0])).numpy()
    lanes = ts(T, torch.as_tensor(x), torch.as_tensor(b)).numpy()
    got0 = ts.zero_call(T, torch.as_tensor(b[0])).numpy()
    for g, w in [(got, want[0]), (got0, want0)] + list(zip(lanes, want)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL[torch.float64] * np.abs(w).max())
    assert ts.zero_call_residual(T, torch.as_tensor(b[0])) is None
