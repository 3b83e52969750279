"""The block-DIA kernel wrappers (``sparse/block_dia.py``, the kernels of
``csrc/block_dia.cu``) on the CPU, where each runs its plain twin.

- Every mode (B1 ``PLAIN`` and ``RESID``; B2 ``ZERO``, ``ZERO_RES``,
  ``STEP`` and ``COLOUR``) on bs = 1, 2 and 3, float32 and float64, one
  vector and a K = 3 lane stack, a random block-banded operator whose
  outer diagonals reach past the matrix (their out-of-range blocks are
  stored as zero) and padded nodes (nb_pad > nb): the wrapper equals its
  twin bit for bit, and both agree with a numpy emulation of the kernels'
  loops (one node at a time, the diagonals ascending, a neighbour outside
  the matrix skipped; float64 to 1e-13, float32 to 1e-5, of the largest
  entry).
- ``ZERO_RES`` equals ``ZERO`` followed by ``b - A x`` bit for bit, and
  ``COLOUR`` the composed ``torch.where`` form of a colour step.
- A float16 or mismatched dtype, a non-contiguous operand, a wrong
  length, Dinv or colours of the wrong shape raise, on the CPU as on the
  card.

The card's kernels are held to these twins by ``tests/test_torch_cuda.py``
(marker ``cuda``) and ``chip_smoke.py`` phase 19.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from pyamg_tpu_torch.sparse import block_dia as bd  # noqa: E402

CPU = "cpu"
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
DTYPES = [torch.float32, torch.float64]
LANES = 3
NB = 40                          # nodes of the operator
PAD = 5                          # padded nodes beyond them
OFFSETS = (-9, -1, 0, 2, 11)     # block offsets; the outer ones reach past
OMEGA = 0.7


def _operator(bs, dtype, seed=0):
    """A random square BSR matrix of bs x bs blocks on OFFSETS (every block
    inside the matrix present), as scipy and as a BlockDIAMatrix padded to
    NB + PAD nodes."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in OFFSETS:
        r = np.arange(max(0, -off), min(NB, NB - off))
        rows.append(r)
        cols.append(r + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    data = rng.standard_normal((len(rows), bs, bs))
    data[rows == cols] += 4 * np.eye(bs)
    indptr = np.searchsorted(rows, np.arange(NB + 1))
    S = sp.bsr_matrix((data, cols, indptr), shape=(NB * bs, NB * bs))
    A = bd.block_dia_from_scipy(S, dtype=dtype, device=CPU,
                                n_pad=(NB + PAD) * bs)
    assert A.offsets == OFFSETS and A.nb_pad == NB + PAD
    return S, A


def _inputs(bs, dtype, lanes, seed=1):
    """x, b (zero on the padded nodes), Dinv (nb_pad, bs, bs; zero on the
    padded nodes) and colours (int32, 0..3, -1 on the padded nodes)."""
    rng = np.random.default_rng(seed)
    shape = (NB + PAD) * bs if lanes is None else (lanes, (NB + PAD) * bs)
    x = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    x[..., NB * bs:] = 0
    b[..., NB * bs:] = 0
    D = rng.standard_normal((NB + PAD, bs, bs))
    D[NB:] = 0
    colors = rng.integers(0, 4, NB + PAD).astype(np.int32)
    colors[NB:] = -1
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return t(x), t(b), t(D), torch.as_tensor(colors)


# -- a numpy emulation of the kernels' loops ---------------------------------

def _emulate_product(A, v, zero_guess=None):
    """(A v) node by node as the kernels form it: for each diagonal in
    ascending order, the neighbour's block of v (or, for ``zero_guess`` =
    (Dinv, b, w), the zero-guess sweep recomputed there) against the
    stored block; a neighbour outside [0, nb) is skipped."""
    data = A.data.double().numpy()
    nb, bs = A.nb_pad, A.bs
    acc = np.zeros((nb, bs))
    nodes = np.arange(nb)
    for d, off in enumerate(A.offsets):
        j = nodes + off
        live = (j >= 0) & (j < nb)
        jl = j[live]
        if zero_guess is None:
            vj = v.reshape(nb, bs)[jl]
        else:
            D, b, w = zero_guess
            vj = w * np.einsum("npq,nq->np", D[jl], b.reshape(nb, bs)[jl])
        acc[live] += np.einsum("npq,nq->np", data[d][live], vj)
    return acc.reshape(-1)


def _emulate(mode, A, x, b, D, colors, colour, w):
    """One lane of each mode, in float64."""
    nb, bs = A.nb_pad, A.bs
    apply_D = lambda v: np.einsum("npq,nq->np", D,  # noqa: E731
                                  v.reshape(nb, bs)).reshape(-1)
    if mode == "plain":
        return _emulate_product(A, x)
    if mode == "resid":
        return b - _emulate_product(A, x)
    if mode == "zero":
        return w * apply_D(b)
    if mode == "zero_res":
        return (w * apply_D(b), b - _emulate_product(A, None, (D, b, w)))
    if mode == "step":
        return x + w * apply_D(b - _emulate_product(A, x))
    upd = x + apply_D(b - _emulate_product(A, x))
    keep = np.repeat(colors == colour, bs)
    return np.where(keep, upd, x)


def _call(mode, A, x, b, D, colors, colour, omega):
    """(wrapper's outputs, twin's outputs) of ``mode``."""
    if mode == "plain":
        return bd.block_dia_apply(A, x), bd.block_dia_spmv_ref(A, x)
    if mode == "resid":
        return bd.block_dia_resid(A, x, b), bd.block_dia_resid_ref(A, x, b)
    if mode == "zero":
        return (bd.block_jacobi_zero(D, b, omega),
                bd.block_jacobi_zero_ref(D, b, omega))
    if mode == "zero_res":
        return (bd.block_jacobi_zero_res(A, b, D, omega),
                bd.block_jacobi_zero_res_ref(A, b, D, omega))
    if mode == "step":
        return (bd.block_jacobi_step(A, x, b, D, omega),
                bd.block_jacobi_step_ref(A, x, b, D, omega))
    return (bd.block_colour_step(A, x, b, D, colors, colour),
            bd.block_colour_step_ref(A, x, b, D, colors, colour))


MODES = ["plain", "resid", "zero", "zero_res", "step", "colour"]


def _tuple(v):
    return v if isinstance(v, tuple) else (v,)


@pytest.mark.parametrize("lanes", [None, LANES])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs", [1, 2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_wrappers_equal_twins_and_the_kernel_emulation(mode, bs, dtype,
                                                       lanes):
    _, A = _operator(bs, dtype)
    x, b, D, colors = _inputs(bs, dtype, lanes)
    omega = (torch.tensor(OMEGA, dtype=dtype) if mode == "step"
             else OMEGA)                       # a 0-d weight as the dyn kinds
    colour = 2
    got, twin = _call(mode, A, x, b, D, colors, colour, omega)
    for g, t in zip(_tuple(got), _tuple(twin)):
        assert g.dtype == dtype and g.shape == x.shape
        assert torch.equal(g, t)
    xs = x.double().numpy().reshape(-1, x.shape[-1])
    bs_ = b.double().numpy().reshape(xs.shape)
    for k in range(xs.shape[0]):
        want = _tuple(_emulate(mode, A, xs[k], bs_[k], D.double().numpy(),
                               colors.numpy(), colour, OMEGA))
        for g, w in zip(_tuple(got), want):
            gk = (g if lanes is None else g[k]).double().numpy()
            scale = max(np.abs(w).max(), 1e-300)
            assert np.abs(gk - w).max() <= TOL[dtype] * scale, mode
            assert not gk[NB * bs:].any()


@pytest.mark.parametrize("lanes", [None, LANES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_res_equals_zero_then_residual(dtype, lanes):
    _, A = _operator(2, dtype)
    _, b, D, _ = _inputs(2, dtype, lanes)
    x, r = bd.block_jacobi_zero_res(A, b, D, OMEGA)
    x0 = bd.block_jacobi_zero(D, b, OMEGA)
    assert torch.equal(x, x0)
    assert torch.equal(r, b - (A @ x0))
    assert torch.equal(r, bd.block_dia_resid(A, x0, b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_colour_step_equals_the_where_form(dtype):
    _, A = _operator(3, dtype)
    x, b, D, colors = _inputs(3, dtype, None)
    for colour in range(4):
        got = bd.block_colour_step(A, x, b, D, colors, colour)
        xb = x.reshape(-1, 3)
        upd = xb + torch.sum(D * (b - A @ x).reshape(-1, 3)[:, None, :],
                             dim=-1)
        want = torch.where((colors == colour)[:, None], upd, xb).reshape(-1)
        assert torch.equal(got, want)
        # the other colours' nodes keep x exactly
        keep = np.repeat(colors.numpy() != colour, 3)
        assert torch.equal(got[keep], x[keep])


def test_bad_operands_raise():
    _, A = _operator(2, torch.float32)
    x, b, D, colors = _inputs(2, torch.float32, None)
    n = A.n_pad
    with pytest.raises(TypeError):
        bd.block_dia_apply(A, x.double())                  # dtype mismatch
    with pytest.raises(TypeError):
        bd.block_jacobi_zero(D.half(), b.half(), OMEGA)    # float16
    with pytest.raises(ValueError):
        bd.block_dia_apply(A, torch.zeros(2 * n)[::2])     # non-contiguous
    with pytest.raises(ValueError):
        bd.block_dia_resid(A, x, torch.zeros((n, 2))[:, 0])
    with pytest.raises(ValueError):
        bd.block_dia_apply(A, torch.zeros(n + 2))          # wrong length
    with pytest.raises(ValueError):
        bd.block_jacobi_step(A, x, b[:-2], D, OMEGA)
    with pytest.raises(ValueError):
        bd.block_jacobi_step(A, x, b, D[:-1], OMEGA)       # Dinv shape
    with pytest.raises(ValueError):
        bd.block_colour_step(A, x, b, D, colors[:-1], 0)   # colours shape
    with pytest.raises(TypeError):
        bd.block_colour_step(A, x, b, D, colors.long(), 0)
    with pytest.raises(ValueError):
        bd.block_dia_apply(A, torch.zeros((2, 2, n)))      # 3-D
