"""The classical slice's gallery and setup primitives against the JAX
package, on the CPU.

- The gallery copies (``diffusion_stencil_2d`` on ``stencil_grid``,
  ``advection_2d`` with its right-hand side, ``recirc_flow``) give the
  reference's CSR exactly (indptr, indices, data), at two sizes each.
- The ``engine/setup.py`` primitives on the 16^2 Poisson DIA of
  ``tests/test_engine.py::test_device_setup_primitives`` and on a 9-point
  rotated anisotropic FE stencil (float64, row_pad 8): the strength mask,
  Luby MIS, JP colours and PMIS splitting array for array (two seeds),
  the neighbour reductions and Bellman-Ford distances to 1e-12; a chain
  through two neighbours whose hash weights tie ends JP with a raise.
- The masked Jacobi sweep on a DIA operator (K2's twin with the masked
  inverse diagonal) against the composed form and the JAX
  ``masked_jacobi``, float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyamg_tpu import gallery as jgal  # noqa: E402
from pyamg_tpu.engine import relaxation as jrel  # noqa: E402
from pyamg_tpu.engine import setup as jsetup  # noqa: E402
from pyamg_tpu.sparse import dia_from_scipy as jax_dia  # noqa: E402

from pyamg_tpu_torch import gallery as tgal  # noqa: E402
from pyamg_tpu_torch.engine import relaxation as rel  # noqa: E402
from pyamg_tpu_torch.engine import setup as tsetup  # noqa: E402
from pyamg_tpu_torch.sparse import dia_from_scipy  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)


def _csr_equal(A, B):
    A, B = A.tocsr(), B.tocsr()
    assert A.shape == B.shape
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    np.testing.assert_array_equal(A.data, B.data)


@pytest.mark.parametrize("grid", [(9, 7), (32, 32)])
@pytest.mark.parametrize("kind", ["diffusion", "advection", "recirc"])
def test_gallery_matches_reference(kind, grid):
    if kind == "diffusion":
        for eps, theta, typ in ((1e-3, 0.0, "FD"), (1.0, 0.0, "FE"),
                                (0.1, np.pi / 6, "FE"), (0.01, 0.3, "FD")):
            S = tgal.diffusion_stencil_2d(eps, theta, typ)
            np.testing.assert_array_equal(
                S, jgal.diffusion_stencil_2d(eps, theta, typ))
            _csr_equal(tgal.stencil_grid(S, grid),
                       jgal.stencil_grid(S, grid))
    elif kind == "advection":
        for theta in (np.pi / 4, np.pi / 3):
            A, rhs = tgal.advection_2d(grid, theta=theta)
            Aj, rhsj = jgal.advection_2d(grid, theta=theta)
            _csr_equal(A, Aj)
            np.testing.assert_array_equal(rhs, rhsj)
        with pytest.raises(ValueError, match="theta"):
            tgal.advection_2d(grid, theta=-0.5)
    else:
        for eps in (1e-2, 0.5):
            _csr_equal(tgal.recirc_flow(grid, epsilon=eps),
                       jgal.recirc_flow(grid, epsilon=eps))


def _operator(which):
    if which == "poisson16":
        return jgal.poisson((16, 16), format="csr")
    S = jgal.diffusion_stencil_2d(0.1, np.pi / 6, "FE")
    return jgal.stencil_grid(S, (16, 16)).tocsr()


@pytest.fixture(scope="module", params=["poisson16", "aniso9"])
def pair(request):
    A = _operator(request.param)
    J = jax_dia(A, dtype=jnp.float64, row_pad=8)
    T = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=8)
    assert J.offsets == T.offsets and J.n_pad == T.n_pad
    return A, J, T


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


PRIMITIVES = ["strength", "luby_mis", "jp_coloring", "pmis",
              "reduce_max", "min_plus", "bellman_ford"]


@pytest.mark.parametrize("prim", PRIMITIVES)
def test_primitive_matches_reference(pair, prim):
    A, J, T = pair
    n_pad = T.n_pad
    rng = np.random.default_rng(3)
    if prim == "strength":
        for theta, norm in ((0.25, "abs"), (0.5, "min"), (0.0, "abs")):
            got = tsetup.device_strength_mask(T, theta=theta, norm=norm)
            want = jsetup.device_strength_mask(J, theta=theta, norm=norm)
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(_np(got), _np(want))
        return
    if prim == "luby_mis":
        for seed in (0, 7):
            got = tsetup.device_luby_mis(T, seed=seed)
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(
                _np(got), _np(jsetup.device_luby_mis(J, seed=seed)))
        valid = np.arange(n_pad) % 5 != 2
        np.testing.assert_array_equal(
            _np(tsetup.device_luby_mis(T, seed=1, valid=torch.as_tensor(
                valid))),
            _np(jsetup.device_luby_mis(J, seed=1, valid=jnp.asarray(valid))))
        return
    if prim == "jp_coloring":
        for seed in (0, 5):
            got = tsetup.device_jp_coloring(T, seed=seed)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                _np(got), _np(jsetup.device_jp_coloring(J, seed=seed)))
        return
    if prim == "pmis":
        for seed in (0, 2):
            got = tsetup.device_pmis_splitting(T, seed=seed)
            assert got.dtype == torch.int8 and 0 < int(got.sum()) < n_pad
            np.testing.assert_array_equal(
                _np(got), _np(jsetup.device_pmis_splitting(J, seed=seed)))
        sm = tsetup.device_strength_mask(T, theta=0.5)
        np.testing.assert_array_equal(
            _np(tsetup.device_pmis_splitting(T, strength_mask=sm)),
            _np(jsetup.device_pmis_splitting(
                J, strength_mask=jnp.asarray(_np(sm)))))
        return
    x = rng.random(n_pad)
    if prim == "reduce_max":
        for fill in (float("-inf"), -1.0):
            np.testing.assert_array_equal(
                _np(tsetup.neighbor_reduce_max(T, torch.as_tensor(x), fill)),
                _np(jsetup.neighbor_reduce_max(J, jnp.asarray(x), fill)))
        return
    if prim == "min_plus":
        w = rng.random((len(T.offsets), n_pad))
        for weights in (None, w):
            got = tsetup.neighbor_reduce_min_plus(
                T, torch.as_tensor(x),
                None if weights is None else torch.as_tensor(weights))
            want = jsetup.neighbor_reduce_min_plus(
                J, jnp.asarray(x),
                None if weights is None else jnp.asarray(weights))
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12)
        return
    seeds = np.zeros(n_pad, dtype=bool)
    seeds[[0, 100, 200]] = True
    for maxiter in (None, 3):
        got = tsetup.device_bellman_ford(T, torch.as_tensor(seeds),
                                         maxiter=maxiter)
        want = _np(jsetup.device_bellman_ford(J, jnp.asarray(seeds),
                                              maxiter=maxiter))
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(np.isinf(_np(got)), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(_np(got)[fin], want[fin], rtol=1e-12,
                                   atol=1e-12)


def test_pmis_splitting_is_a_strong_independent_set(pair):
    """The C points share no strong connection, and every F point with a
    strong connection sees a C point (the PMIS invariants)."""
    A, _, T = pair
    n = A.shape[0]
    split = tsetup.device_pmis_splitting(T).numpy()[:n]
    smask = tsetup.device_strength_mask(T).numpy()
    for d, off in enumerate(T.offsets):
        if off == 0:
            continue
        i = np.arange(n)
        j = i + off
        ok = (j >= 0) & (j < n) & smask[d, :n]
        assert not (split[i[ok]] & split[j[ok]]).any()


@pytest.mark.parametrize("lanes", [1, 3])
def test_masked_jacobi_kernel_form_matches(lanes):
    """A masked sweep on a DIA operator is K2 (K9 on lanes; their twins
    here) with dinv * mask as the inverse diagonal: off the mask the
    iterate keeps its bits, on it the update agrees with the composed
    where-form and with the JAX ``masked_jacobi`` to 1e-12 (float64)."""
    A = _operator("aniso9")
    J = jax_dia(A, dtype=jnp.float64, row_pad=8)
    T = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=8)
    n, n_pad = A.shape[0], T.n_pad
    rng = np.random.default_rng(9)
    d = A.diagonal()
    dinv = np.zeros(n_pad)
    dinv[:n] = 1.0 / d
    rows = np.arange(n_pad) < n
    c = rows & (rng.random(n_pad) < 0.3)
    f = rows & ~c
    kw = dict(iters_per_mask=(2, 1), omega=0.7, iterations=2)
    ts = rel.masked_jacobi(torch.as_tensor(dinv),
                           (torch.as_tensor(f), torch.as_tensor(c)), **kw)
    js = jrel.masked_jacobi(jnp.asarray(dinv),
                            (jnp.asarray(f), jnp.asarray(c)), **kw)
    X = rng.random((lanes, n_pad)) * rows
    B = rng.random((lanes, n_pad)) * rows
    Xt, Bt = torch.as_tensor(X), torch.as_tensor(B)
    if lanes == 1:
        Xt, Bt = Xt[0], Bt[0]
    fused = ts(T, Xt, Bt)                                   # K2 / K9 form
    composed = rel.apply_smoother(ts.config, ts.arrays, T, Xt, Bt)
    assert ts._stack(T) is ts.mask_dinv
    np.testing.assert_allclose(fused.numpy(), composed.numpy(), rtol=1e-12,
                               atol=1e-12 * np.abs(composed.numpy()).max())
    # one masked sweep: rows off the mask keep their bits
    one = rel.masked_jacobi(torch.as_tensor(dinv), (torch.as_tensor(f),),
                            (1,), omega=0.7)
    y = one(T, Xt, Bt)
    keep = torch.as_tensor(~f).expand_as(y)
    assert torch.equal(y[keep], Xt[keep])
    for lane in range(lanes):
        want = np.asarray(js(J, jnp.asarray(X[lane]), jnp.asarray(B[lane])))
        got = fused.reshape(lanes, -1)[lane].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
        want0 = np.asarray(js.zero_call(J, jnp.asarray(B[lane])))
        got0 = ts.zero_call(T, torch.as_tensor(B[lane])).numpy()
        np.testing.assert_allclose(got0, want0, rtol=1e-12,
                                   atol=1e-12 * np.abs(want0).max())


def test_tied_neighbours_end_the_rounds():
    """Vertices 4378 and 4379 get the same float32 hash weight for seed 0
    (in the reference's hash too), so on a 1-D chain through them neither
    ever beats the other: the reference's JP loop would not end, the
    port's stops at the first round that changes nothing and raises with
    that state (the pair and lighter neighbours waiting on it undecided,
    every other vertex coloured)."""
    w = np.asarray(jsetup._hash_weights(4400, 0))
    np.testing.assert_array_equal(tsetup._hash_weights(4400, 0).numpy(), w)
    assert w[4378] == w[4379]
    A = jgal.poisson((4400,), format="csr")
    T = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=8)
    with pytest.raises(tsetup.UndecidedVertices, match="never be decided") \
            as err:
        tsetup.device_jp_coloring(T, seed=0)
    state = err.value.state.numpy()
    stuck = np.flatnonzero(state == -1)
    # the pair, and lighter neighbours waiting on it
    assert {4378, 4379} <= set(stuck.tolist())
    assert stuck.min() >= 4370 and stuck.max() <= 4390
    assert (np.delete(state[:4400], stuck) >= 0).all()
    assert 0 < err.value.rounds < T.n_pad
    # another seed has no tied neighbours on this chain
    assert (tsetup.device_jp_coloring(T, seed=1).numpy()[:4400] >= 0).all()
