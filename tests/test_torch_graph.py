"""The port's host graph algorithms and polynomial coefficients against the
JAX package's (``pyamg_tpu/graph.py``, ``pyamg_tpu/relaxation/
chebyshev.py``), on the CPU.

The colourings and independent sets must equal the reference's array for
array, on symmetric and one-sided patterns: the port's rounds are
vectorised where the pattern is symmetric, the reference's colour their
winners one by one.  The coefficients agree to 1e-15 relative.
"""
import numpy as np
import pytest
import scipy.sparse as sp

from pyamg_tpu.gallery import poisson
from pyamg_tpu.graph import maximal_independent_set as jax_mis
from pyamg_tpu.graph import vertex_coloring as jax_coloring
from pyamg_tpu.relaxation.chebyshev import (
    chebyshev_polynomial_coefficients as jax_chebyshev,
    mls_polynomial_coefficients as jax_mls)

from pyamg_tpu_torch.graph import maximal_independent_set, vertex_coloring
from pyamg_tpu_torch.relaxation import (chebyshev_polynomial_coefficients,
                                        mls_polynomial_coefficients)


def _graph(name):
    if name == "poisson2d":
        return poisson((40, 40), format="csr")
    if name == "poisson3d":
        return poisson((12, 12, 12), format="csr")
    # a random symmetric pattern with isolated nodes and a dense row
    R = sp.random(600, 600, density=0.01, random_state=1, format="csr")
    R = R + R.T
    R = R.tolil()
    R[7, :] = 1.0
    R[:, 7] = 1.0
    return sp.csr_matrix(R)


GRAPHS = ["poisson2d", "poisson3d", "random"]


@pytest.mark.parametrize("method", ["JP", "LDF", "MIS"])
@pytest.mark.parametrize("graph", GRAPHS)
def test_vertex_coloring_matches_reference(graph, method):
    G = _graph(graph)
    got = vertex_coloring(G, method=method)
    want = jax_coloring(G, method=method)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # a proper colouring
    C = sp.coo_matrix(G)
    off = C.row != C.col
    assert not np.any(got[C.row[off]] == got[C.col[off]])


def _nonsymmetric_graph(name):
    if name == "random":
        return sp.random(600, 600, density=0.01, random_state=2,
                         format="csr")
    # a one-sided stencil: the lower triangle of 2-D Poisson plus a few
    # random entries
    L = sp.tril(poisson((30, 30), format="csr"), format="csr")
    return sp.csr_matrix(L + sp.random(900, 900, density=0.002,
                                       random_state=4, format="csr"))


@pytest.mark.parametrize("method", ["JP", "LDF", "MIS"])
@pytest.mark.parametrize("graph", ["random", "lower"])
def test_vertex_coloring_nonsymmetric_matches_reference(graph, method):
    """On a pattern that is not structurally symmetric two winners of one
    round can share a one-sided edge; the colours still equal the
    reference's, which colours its winners one after another."""
    G = _nonsymmetric_graph(graph)
    assert (G != G.T).nnz
    np.testing.assert_array_equal(vertex_coloring(G, method=method),
                                  jax_coloring(G, method=method))


@pytest.mark.parametrize("seed", [0, 3])
def test_vertex_coloring_seeds_match_reference(seed):
    G = _graph("random")
    np.testing.assert_array_equal(vertex_coloring(G, seed=seed),
                                  jax_coloring(G, seed=seed))


@pytest.mark.parametrize("algo,k", [("serial", None), ("parallel", None),
                                    ("parallel", 2)])
@pytest.mark.parametrize("graph", GRAPHS)
def test_maximal_independent_set_matches_reference(graph, algo, k):
    G = _graph(graph)
    got = maximal_independent_set(G, algo=algo, k=k)
    np.testing.assert_array_equal(got, jax_mis(G, algo=algo, k=k))


def test_tied_weights_match_reference():
    """Equal weights leave no strict winner: the tied nodes all join, as
    in the reference."""
    G = poisson((6, 6), format="csr")
    w = np.ones(G.shape[0])
    np.testing.assert_array_equal(
        maximal_independent_set(G, algo="parallel", weights=w),
        jax_mis(G, algo="parallel", weights=w))


@pytest.mark.parametrize("a,b,degree", [(1 / 30, 1.1, 3), (0.2, 7.5, 4),
                                        (1e-3, 1.0, 1), (0.5, 2.0, 6)])
def test_chebyshev_coefficients_match_reference(a, b, degree):
    got = chebyshev_polynomial_coefficients(a, b, degree)
    want = jax_chebyshev(a, b, degree)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("rho,degree", [(1.0, 3), (7.9, 2), (2.5, 5)])
def test_mls_coefficients_match_reference(rho, degree):
    got, roots = mls_polynomial_coefficients(rho, degree)
    want, want_roots = jax_mls(rho, degree)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(roots, want_roots, rtol=1e-15, atol=0)


def test_chebyshev_rejects_bad_intervals():
    with pytest.raises(ValueError, match="a < b"):
        chebyshev_polynomial_coefficients(1.0, 1.0, 3)
    with pytest.raises(ValueError, match="degree"):
        chebyshev_polynomial_coefficients(0.1, 1.0, 0)
