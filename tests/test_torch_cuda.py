"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: every test skips where torch sees no GPU (the decision is
taken inside the fixture, never at import).  On a machine with a card,
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the port
neither needs nor imports.)
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import pyamg_tpu  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402

from pyamg_tpu_torch import _build, as_device_solver  # noqa: E402
from pyamg_tpu_torch.sparse import (dia, dia_from_scipy, window,  # noqa: E402
                                    windowed_from_scipy)

pytestmark = pytest.mark.cuda

# f32: FMA contraction and the transpose's atomics order; f64 likewise
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _rand(m, dtype, dev, seed):
    return torch.as_tensor(np.random.default_rng(seed).random(m),
                           dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [(64, 64), (33, 70)])
def test_dia_kernels_match_twins(cuda, dtype, grid):
    A = poisson(grid, format="csr")
    D = dia_from_scipy(A, dtype=dtype, device=cuda, row_pad=1024)
    x, b = (_rand(D.n_pad, dtype, cuda, s) for s in (0, 1))
    dinv = torch.zeros(D.n_pad, dtype=dtype, device=cuda)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / A.diagonal(), dtype=dtype)
    _build.reset_launches()
    assert _rel_err(dia.dia_spmv(D, x), dia.dia_spmv_ref(D, x)) <= TOL[dtype]
    assert _rel_err(dia.dia_jacobi(D, x, b, dinv, 0.85),
                    dia.dia_jacobi_ref(D, x, b, dinv, 0.85)) <= TOL[dtype]
    got = dia.dia_jacobi_zero_res(D, b, dinv, 0.85)
    want = dia.dia_jacobi_zero_res_ref(D, b, dinv, 0.85)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= TOL[dtype]
    name = str(dtype).removeprefix("torch.")
    assert _build.launches == {f"dia_spmv.{name}": 1,
                               f"dia_jacobi.{name}": 1,
                               f"dia_jacobi_zero_res.{name}": 1}


def _random_rect(n, m, per_row, spread, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip((rows * m) // n + rng.integers(-spread, spread + 1,
                                                  len(rows)), 0, m - 1)
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(n, m))


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_kernels_match_twins(cuda, dtype):
    P = _random_rect(8192, 2600, per_row=4, spread=60, seed=4)
    W = windowed_from_scipy(P, dtype=dtype, device=cuda)
    x = _rand(W.m_chunks * W.w2, dtype, cuda, 3)
    r = _rand(W.n_pad, dtype, cuda, 5)
    assert _rel_err(window.windowed_matvec(W, x),
                    window.windowed_matvec_ref(W, x)) <= TOL[dtype]
    assert _rel_err(window.windowed_rmatvec(W, r),
                    window.windowed_rmatvec_ref(W, r)) <= TOL[dtype]


def test_kernel_wrapper_rejects_bad_operands(cuda):
    A = poisson((32, 32), format="csr")
    D = dia_from_scipy(A, device=cuda, row_pad=1024)
    with pytest.raises(TypeError):
        dia.dia_spmv(D, torch.ones(D.n_pad, dtype=torch.float64,
                                   device=cuda))
    with pytest.raises(ValueError):
        dia.dia_spmv(D, torch.ones(D.n_pad + 1, device=cuda))
    with pytest.raises(ValueError):
        dia.dia_spmv(D, torch.ones(D.n_pad))          # CPU x, CUDA A


def test_mixed_solve_on_card_matches_cpu(cuda):
    """The 128^2 main-path solve on the card against the same solve on the
    CPU (plain twins): iteration counts within one, first five history
    entries to 1e-3 (f32 summation order), both converged."""
    A = poisson((128, 128), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    b = np.random.default_rng(1).random(A.shape[0])
    kw = dict(tol=1e-8, accel="cg", precision="mixed")
    res_g, res_c = [], []
    x = as_device_solver(ml, device=cuda, mixed_precision=True,
                         coarse_cutoff=1024).solve(b, residuals=res_g, **kw)
    as_device_solver(ml, device="cpu", mixed_precision=True,
                     coarse_cutoff=1024).solve(b, residuals=res_c, **kw)
    assert abs(len(res_g) - len(res_c)) <= 1
    np.testing.assert_allclose(res_g[:5], res_c[:5], rtol=1e-3)
    assert np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)
