"""The port's sparse formats and kernel entry points against the JAX
package, on the CPU.

On CPU tensors each kernel entry point of ``pyamg_tpu_torch`` runs its
plain PyTorch twin; here that twin is held against the JAX package's TPU
kernel run in Pallas interpret mode, at the sizes of the reference's own
tests (tests/test_pallas_kernels.py).  Inputs come from numpy with a
seed and go to both sides.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pyamg_tpu  # noqa: E402
from pyamg_tpu.engine.device_setup import dia_transpose as jax_dia_transpose  # noqa: E402
from pyamg_tpu.gallery import poisson  # noqa: E402
from pyamg_tpu.sparse import pad_vector as jax_pad_vector  # noqa: E402
from pyamg_tpu.sparse import select_operator as jax_select_operator  # noqa: E402
from pyamg_tpu.sparse.dia import (_dia_pallas_matvec,  # noqa: E402
                                  dia_pallas_jacobi,
                                  dia_pallas_jacobi_zero_res)
from pyamg_tpu.sparse.dia import dia_from_scipy as jax_dia_from_scipy  # noqa: E402
from pyamg_tpu.sparse.window import \
    windowed_from_scipy as jax_windowed_from_scipy  # noqa: E402

from pyamg_tpu_torch import _build  # noqa: E402
from pyamg_tpu_torch.engine.device_setup import dia_transpose  # noqa: E402
from pyamg_tpu_torch.sparse import (ComposedOperator, DenseOperator,  # noqa: E402
                                    DIAMatrix, TransposedWindowed,
                                    WindowedELL, dia_from_scipy,
                                    dia_jacobi, dia_jacobi_zero_res,
                                    dia_spmv, pad_to, pad_vector,
                                    select_operator, windowed_from_scipy,
                                    windowed_matvec, windowed_rmatvec)

CPU = "cpu"


def _random_rect(n, m, per_row, spread, seed=0):
    """The reference tests' random banded rectangle
    (tests/test_pallas_kernels.py::_random_rect)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip((rows * m) // n + rng.integers(-spread, spread + 1,
                                                  len(rows)), 0, m - 1)
    vals = rng.standard_normal(len(rows))
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, m))


def _pair(A, row_pad, dtype=np.float32):
    """The same DIA operator in both packages."""
    jd = jax_dia_from_scipy(A, dtype=jnp.dtype(dtype), row_pad=row_pad)
    td = dia_from_scipy(A, dtype=torch.float32 if dtype == np.float32
                        else torch.float64, device=CPU, row_pad=row_pad)
    return jd, td


def _dinv_of(jd):
    return jnp.where(jd.diagonal() != 0, 1.0 / jd.diagonal(), 0.0)


def test_dia_from_scipy_matches_reference():
    A = poisson((40, 40), format="csr")
    jd, td = _pair(A, 1024)
    assert td.offsets == jd.offsets and td.shape == jd.shape
    assert td.nnz == jd.nnz and td.n_pad == jd.n_pad
    np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))


def test_dia_spmv_k1_matches_pallas_interpret():
    """K1 plain mode: the port's entry point against the TPU kernel body
    (B=1024, lane-crossing offsets +-1 and row offsets +-64).  rtol 1e-6,
    not equality: the two sum the diagonals in the same order, but the
    kernel on the card contracts to FMAs, so only rounding-level
    agreement is the contract."""
    A = poisson((64, 64), format="csr")
    jd, td = _pair(A, 1024)
    xh = np.random.default_rng(0).random(A.shape[0]).astype(np.float32)
    xj = jax_pad_vector(jnp.asarray(xh), jd.n_pad)
    want = np.asarray(_dia_pallas_matvec(jd.data, jd.offsets, xj, 1024,
                                         interpret=True))
    got = dia_spmv(td, pad_vector(xh, td.n_pad, device=CPU)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dia_spmv_float64_matches_scipy():
    """The f64 instantiation (the mixed-precision A64) on its plain twin."""
    A = poisson((48, 48), format="csr")
    td = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=1024)
    x = np.random.default_rng(3).random(A.shape[0])
    got = dia_spmv(td, pad_vector(x, td.n_pad, dtype=torch.float64,
                                  device=CPU)).numpy()
    np.testing.assert_allclose(got[: A.shape[0]], A @ x, rtol=1e-13,
                               atol=1e-13)
    assert not got[A.shape[0]:].any()


def test_dia_jacobi_k2_matches_pallas_interpret():
    """K2 against dia_pallas_jacobi (force_B=1024), atol 2e-6 (the
    reference test's own tolerance for this kernel)."""
    A = poisson((64, 64), format="csr")
    jd, td = _pair(A, 1024)
    rng = np.random.default_rng(1)
    xh = rng.random(A.shape[0]).astype(np.float32)
    bh = rng.random(A.shape[0]).astype(np.float32)
    xj = jax_pad_vector(jnp.asarray(xh), jd.n_pad)
    bj = jax_pad_vector(jnp.asarray(bh), jd.n_pad)
    dinv = _dinv_of(jd)
    want = np.asarray(dia_pallas_jacobi(jd, xj, bj, dinv, 0.85,
                                        interpret=True, force_B=1024))
    got = dia_jacobi(td, pad_vector(xh, td.n_pad, device=CPU),
                     pad_vector(bh, td.n_pad, device=CPU),
                     torch.as_tensor(np.array(dinv)), 0.85).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_dia_jacobi_zero_res_k3_matches_pallas_interpret():
    """K3 against dia_pallas_jacobi_zero_res on the reference test's
    512^2, row_pad=32768, force_B=8192 setup (chunked halos clamped at
    both array ends): atol 2e-6 on x, 2e-5 on r."""
    A = poisson((512, 512), format="csr")
    jd, td = _pair(A, 32768)
    bh = np.random.default_rng(7).random(A.shape[0]).astype(np.float32)
    bj = jax_pad_vector(jnp.asarray(bh), jd.n_pad)
    dinv = _dinv_of(jd)
    x_want, r_want = dia_pallas_jacobi_zero_res(jd, bj, dinv, 0.85,
                                                interpret=True, force_B=8192)
    x_got, r_got = dia_jacobi_zero_res(
        td, pad_vector(bh, td.n_pad, device=CPU),
        torch.as_tensor(np.array(dinv)), 0.85)
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=2e-6)
    np.testing.assert_allclose(r_got.numpy(), np.asarray(r_want), atol=2e-5)


@pytest.mark.parametrize("block", [256, 1024, 2048])
def test_windowed_layout_matches_reference(block):
    """windowed_from_scipy builds the reference's layout exactly."""
    P = _random_rect(4096, 1500, per_row=3, spread=40, seed=2)
    jw = jax_windowed_from_scipy(P, block=block)
    tw = windowed_from_scipy(P, device=CPU, block=block)
    _assert_same_layout(tw, jw)


def test_windowed_layout_adaptive_block_matches_reference():
    """The adaptive block/w2 choice agrees too, on the reference's
    transpose-test operator and on a 2-D SA tentative operator."""
    P = _random_rect(8192, 2600, per_row=4, spread=60, seed=4)
    _assert_same_layout(windowed_from_scipy(P, device=CPU),
                        jax_windowed_from_scipy(P))
    A = poisson((96, 96), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=100)
    T = sp.csr_matrix(ml.levels[0].P._sa_factor["T"])
    tw = windowed_from_scipy(T, device=CPU)
    _assert_same_layout(tw, jax_windowed_from_scipy(T))
    assert tw.k == 1


def _assert_same_layout(tw, jw):
    assert (tw.block, tw.w2, tw.m_chunks, tw.shape, tw.nnz) == (
        jw.block, jw.w2, jw.m_chunks, jw.shape, jw.nnz)
    np.testing.assert_array_equal(tw.starts.numpy(), np.asarray(jw.starts))
    np.testing.assert_array_equal(tw.idx.numpy(), np.asarray(jw.idx))
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    assert tw._can_transpose_pallas() == jw._can_transpose_pallas()


@pytest.mark.parametrize("block", [256, 1024, 2048])
def test_windowed_matvec_k6_matches_pallas_interpret(block):
    """K6 against WindowedELL._matvec_pallas(interpret=True) on the
    reference test's operator, to the reference test's rtol 2e-6 and
    atol 1e-6: the TPU kernel selects through a 3-way bf16 split, exact
    to 2^-26 of each term, so outputs that cancel to near zero differ by
    ~1e-7 absolute while their relative difference is unbounded."""
    P = _random_rect(4096, 1500, per_row=3, spread=40, seed=2)
    jw = jax_windowed_from_scipy(P, block=block)
    tw = windowed_from_scipy(P, device=CPU, block=block)
    xh = np.random.default_rng(3).random(jw.m_chunks * jw.w2).astype(
        np.float32)
    want = np.asarray(jw._matvec_pallas(jnp.asarray(xh), interpret=True))
    got = windowed_matvec(tw, torch.as_tensor(xh)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(got[: P.shape[0]], P @ xh[: P.shape[1]],
                               rtol=2e-6, atol=1e-6)


def test_windowed_rmatvec_k7_matches_pallas_interpret():
    """K7 against WindowedELL._rmatvec_pallas(interpret=True): overlapping
    windows accumulate into one output, to the reference test's rtol
    2e-6 and atol 1e-6 (the same bf16-split selection error as K6)."""
    P = _random_rect(8192, 2600, per_row=4, spread=60, seed=4)
    jw = jax_windowed_from_scipy(P)
    tw = windowed_from_scipy(P, device=CPU)
    assert jw._can_transpose_pallas()
    rh = np.random.default_rng(5).random(jw.n_pad).astype(np.float32)
    want = np.asarray(jw._rmatvec_pallas(jnp.asarray(rh), interpret=True))
    got = windowed_rmatvec(tw, torch.as_tensor(rh)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(got[: P.shape[1]], P.T @ rh[: P.shape[0]],
                               rtol=2e-6, atol=1e-6)


def test_windowed_operator_padding_rules():
    """matvec pads/cuts x to m_chunks*w2; TransposedWindowed pads its
    input to base.n_pad and returns m_chunks*w2 entries."""
    P = _random_rect(5000, 1700, per_row=2, spread=20, seed=9)
    tw = windowed_from_scipy(P, dtype=torch.float64, device=CPU)
    x = np.random.default_rng(10).random(P.shape[1])
    y = tw.matvec(torch.as_tensor(x))
    assert y.shape == (tw.n_pad,)
    np.testing.assert_allclose(y[: P.shape[0]].numpy(), P @ x, rtol=1e-13)
    R = TransposedWindowed(tw)
    r = np.random.default_rng(11).random(P.shape[0])
    z = R.matvec(torch.as_tensor(r))       # shorter than base.n_pad
    assert z.shape == (R.n_pad,) == (tw.m_chunks * tw.w2,)
    np.testing.assert_allclose(z[: P.shape[1]].numpy(), P.T @ r, rtol=1e-12)
    assert R.shape == (P.shape[1], P.shape[0])


def test_dia_transpose_is_exact():
    """The rolled transpose equals the reference's entry for entry."""
    A = (poisson((30, 10), format="csr")
         + sp.diags(np.arange(1.0, 300), 1, shape=(300, 300))
         + sp.diags(np.arange(1.0, 290), -11, shape=(300, 300)))
    jd, td = _pair(A, 8, dtype=np.float64)
    jt = jax_dia_transpose(jd)
    tt = dia_transpose(td)
    assert tt.offsets == jt.offsets and tt.shape == jt.shape
    np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
    dense = np.zeros((td.n_pad, td.n_pad))
    for d, off in enumerate(tt.offsets):
        for i in range(td.n_pad):
            if 0 <= i + off < td.n_pad:
                dense[i, i + off] = tt.data[d, i]
    np.testing.assert_array_equal(dense[:300, :300], A.T.toarray())


@pytest.mark.parametrize("shape,kind", [
    ((40 * 40, 40 * 40), "DenseOperator"),
    ((64 * 64, 64 * 64), "DIAMatrix"),
])
def test_select_operator_matches_reference(shape, kind):
    g = int(round(np.sqrt(shape[0])))
    A = poisson((g, g), format="csr")
    tj = jax_select_operator(A, row_pad=1024)
    tt = select_operator(A, device=CPU, row_pad=1024)
    assert type(tt).__name__ == type(tj).__name__ == kind
    assert tt.n_pad == tj.n_pad


def test_select_operator_windowed_for_rectangular():
    P = _random_rect(4096, 2100, per_row=3, spread=40, seed=2)
    assert isinstance(select_operator(P, device=CPU), WindowedELL)
    assert type(jax_select_operator(P)).__name__ == "WindowedELL"


def test_select_operator_gather_ell_not_ported():
    """The reference's gather-ELL last resort raises in the port."""
    rng = np.random.default_rng(0)
    n = 5000
    cols = rng.integers(0, 100_000, n)      # row blocks span > 2 * max_w2
    A = sp.csr_matrix((np.ones(n), (np.arange(n), cols)), shape=(n, 100_000))
    assert jax_windowed_from_scipy(A) is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select_operator(A, device=CPU)


def test_composed_operator_length_rules():
    """ComposedOperator fits lengths between factors of different row
    paddings, as the reference's _fit/_expected_in rules do."""
    A = poisson((70, 70), format="csr")
    S = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=1024)
    T = _random_rect(A.shape[0], 900, per_row=1, spread=0, seed=1)
    W = windowed_from_scipy(T, dtype=torch.float64, device=CPU)
    C = ComposedOperator(ops=(S, W), shape=T.shape, nnz=T.nnz)
    assert W.n_pad != S.n_pad
    x = np.random.default_rng(2).random(900)
    y = C.matvec(torch.as_tensor(x))
    assert y.shape == (S.n_pad,)
    np.testing.assert_allclose(y[: A.shape[0]].numpy(), A @ (T @ x),
                               rtol=1e-12)
    r = np.random.default_rng(3).random(S.n_pad)
    r[A.shape[0]:] = 0
    z = C.rmatvec(torch.as_tensor(r))
    np.testing.assert_allclose(z[:900].numpy(),
                               T.T @ (A.T @ r[: A.shape[0]]), rtol=1e-12)


def test_dense_operator_matches_scipy():
    M = _random_rect(300, 200, per_row=3, spread=10, seed=5)
    D = select_operator(M, dtype=torch.float64, device=CPU)
    assert isinstance(D, DenseOperator) and D.data.shape == (304, 200)
    x = np.random.default_rng(1).random(200)
    np.testing.assert_allclose(D.matvec(torch.as_tensor(x))[:300].numpy(),
                               M @ x, rtol=1e-13)


def test_wrappers_run_the_twin_only_on_cpu():
    """CPU operands run the plain twin and count no launch; operands on
    another device never fall back to the twin: they raise (no card
    here, so a meta tensor stands in for a device the twin must not
    serve)."""
    A = poisson((40, 40), format="csr")
    td = dia_from_scipy(A, device=CPU, row_pad=1024)
    x = torch.ones(td.n_pad)
    _build.reset_launches()
    dia_spmv(td, x)
    dia_jacobi(td, x, x, x, 0.5)
    dia_jacobi_zero_res(td, x, x, 0.5)
    assert _build.launches == {}
    with pytest.raises(ValueError, match="different devices"):
        dia_spmv(td, x.to("meta"))
    meta = DIAMatrix(data=td.data.to("meta"), offsets=td.offsets,
                     shape=td.shape, nnz=td.nnz)
    with pytest.raises(ValueError, match="unsupported device"):
        dia_spmv(meta, x.to("meta"))
    P = _random_rect(4096, 1500, per_row=3, spread=40, seed=2)
    tw = windowed_from_scipy(P, device=CPU)
    windowed_matvec(tw, torch.ones(tw.m_chunks * tw.w2))
    windowed_rmatvec(tw, torch.ones(tw.n_pad))
    assert _build.launches == {}
    with pytest.raises(ValueError, match="different devices"):
        windowed_matvec(tw, torch.ones(tw.m_chunks * tw.w2, device="meta"))


def test_build_needs_nvcc():
    """Without a CUDA toolchain the build raises a clear error (it is
    never reached from CPU tensors)."""
    try:
        _build._nvcc()
    except RuntimeError as exc:
        assert "nvcc not found" in str(exc)
    else:
        pytest.skip("a CUDA toolchain is installed here")


def test_pad_helpers():
    assert pad_to(1000, 1024) == 1024 and pad_to(2048, 1024) == 2048
    v = pad_vector(np.arange(3.0), 8, dtype=torch.float64, device=CPU)
    np.testing.assert_array_equal(v.numpy(), [0, 1, 2, 0, 0, 0, 0, 0])
    with pytest.raises(ValueError):
        pad_vector(np.arange(3.0), 8)
