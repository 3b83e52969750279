"""B1 and B2 on K-major lane stacks (``sparse/block_dia.py``, the kernels
of ``csrc/block_dia.cu``) on the CPU, where each wrapper runs its plain
twin.

For B1 ``PLAIN`` / ``RESID`` and B2 ``ZERO`` / ``ZERO_RES`` / ``STEP`` /
``COLOUR`` at K = 1, 3 and 17 (two chunks of MAX_LANES), bs 1-5 and a
bs 2 operator whose blocks start off a 16-byte boundary (the kernels'
run-time block size instance), float32 and float64, on a random operator
over a 9 x 11 node grid with the 9-point node stencil (outer offsets
reaching past the matrix, padded nodes):

- each lane of the wrapper's stack result equals the one-vector call on
  that lane bit for bit (the kernels sum every lane in the one-vector
  order; so do the twins);
- each lane agrees with the JAX package (``BlockDIAMatrix.matmat`` and its
  block smoothers' node-block product, composed as its block Jacobi and
  block multicolour Gauss-Seidel sweeps) to 1e-5 of the largest entry in
  float32 and 1e-12 in float64;
- B1's halo mode as a ring of one (``block_halo_spmv`` on a world of one,
  the halos x's own tail and head) equals ``block_dia_spmv_ref`` (and
  ``RESID`` ``block_dia_resid_ref``) on the whole operator bit for bit.

And ``csrc/block_dia.cu`` keeps one lane order: no lane index on the
grid's second dimension, no super tiles.  The card's kernels are held to
the same by ``tests/test_torch_cuda.py`` (marker ``cuda``).
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyamg_tpu.engine import relaxation as jrel  # noqa: E402
from pyamg_tpu.sparse import block_dia_from_scipy as jax_block_dia  # noqa: E402
from pyamg_tpu_torch.parallel.halo_spmv import block_halo_spmv  # noqa: E402
from pyamg_tpu_torch.parallel.partition import SolverMesh  # noqa: E402
from pyamg_tpu_torch.sparse import block_dia as bd  # noqa: E402

CPU = torch.device("cpu")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]
GRID = (9, 11)                       # node rows, node columns
NB = GRID[0] * GRID[1]
PAD = 5                              # padded nodes beyond them
OFFSETS = tuple(dy * GRID[1] + dx for dy in (-1, 0, 1) for dx in (-1, 0, 1))
KMAX = 17                            # the largest stack: two chunks
OMEGA = 0.7
COLOUR = 2
MODES = ["plain", "resid", "zero", "zero_res", "step", "colour"]
# (bs, blocks off a 16-byte boundary)
SHAPES = [(1, False), (2, False), (3, False), (4, False), (5, False),
          (2, True)]
SHAPE_IDS = ["bs1", "bs2", "bs3", "bs4", "bs5", "bs2-misaligned"]


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)


def _bsr(bs, seed):
    """A random square BSR matrix of bs x bs blocks on the node grid's
    9-point offsets (every block inside the matrix present), diagonally
    dominant."""
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
    data[rows == cols] += 9 * np.eye(bs)
    indptr = np.searchsorted(rows, np.arange(NB + 1))
    return sp.bsr_matrix((data, cols, indptr), shape=(NB * bs, NB * bs))


def _misaligned(v):
    """A copy of ``v`` one element past a 16-byte boundary."""
    buf = torch.empty(v.numel() + 1, dtype=v.dtype)
    out = buf[1:].view(v.shape)
    out.copy_(v)
    return out


_CASES = {}


def _case(bs, misalign, dtype):
    """(S, A, X, B, Dinv, colours) for K = KMAX, built once per shape: the
    smaller stacks are its first lanes."""
    key = (bs, misalign, dtype)
    if key not in _CASES:
        S = _bsr(bs, seed=bs)
        A = bd.block_dia_from_scipy(S, dtype=dtype, device=CPU,
                                    n_pad=(NB + PAD) * bs)
        assert A.offsets == OFFSETS and A.nb_pad == NB + PAD
        rng = np.random.default_rng(10 + bs)
        n = A.n_pad
        X = rng.standard_normal((KMAX, n))
        B = rng.standard_normal((KMAX, n))
        X[:, NB * bs:] = 0
        B[:, NB * bs:] = 0
        D = rng.standard_normal((NB + PAD, bs, bs)) / (9 * bs)
        D[NB:] = 0
        colors = rng.integers(0, 4, NB + PAD).astype(np.int32)
        colors[NB:] = -1
        t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
        D = t(D)
        if misalign:
            A = dataclasses.replace(A, data=_misaligned(A.data))
            D = _misaligned(D)
            assert A.data.data_ptr() % 16 and D.data_ptr() % 16
        _CASES[key] = (S, A, t(X), t(B), D, torch.as_tensor(colors))
    return _CASES[key]


def _call(mode, A, x, b, D, colors):
    """The wrapper's outputs of ``mode``, as a tuple."""
    if mode == "plain":
        return (bd.block_dia_apply(A, x),)
    if mode == "resid":
        return (bd.block_dia_resid(A, x, b),)
    if mode == "zero":
        return (bd.block_jacobi_zero(D, b, OMEGA),)
    if mode == "zero_res":
        return bd.block_jacobi_zero_res(A, b, D, OMEGA)
    if mode == "step":
        omega = torch.tensor(OMEGA, dtype=A.dtype)   # a 0-d weight
        return (bd.block_jacobi_step(A, x, b, D, omega),)
    return (bd.block_colour_step(A, x, b, D, colors, COLOUR),)


@jax.jit
def _jax_modes(J, X, B, D, keep):
    """Every mode on the (K, n_pad) lane stacks X and B through the JAX
    package: ``BlockDIAMatrix.matmat`` on the (n_pad, K) columns (the
    stack and its zero-guess sweep side by side) and the block smoothers'
    node-block product (``relaxation._block_apply``) lane by lane,
    composed as its block Jacobi sweeps and block multicolour
    Gauss-Seidel colour step compose them."""
    def block(V):
        return jax.vmap(lambda v: jrel._block_apply(
            D, v.reshape(-1, J.bs)).reshape(-1))(V)

    Z = OMEGA * block(B)
    AX, AZ = jnp.split(J.matmat(jnp.concatenate([X, Z]).T).T, 2)
    return {"plain": (AX,), "resid": (B - AX,), "zero": (Z,),
            "zero_res": (Z, B - AZ), "step": (X + OMEGA * block(B - AX),),
            "colour": (jnp.where(keep, X + block(B - AX), X),)}


_JAX = {}
_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _jax_lanes(bs, dtype, mode):
    """The JAX package's outputs of ``mode`` (:func:`_jax_modes`) on every
    lane of the KMAX stack, as float64 numpy arrays on the case's own
    (rounded) values, computed once a shape (the float32 case reuses the
    float64 case's compile)."""
    key = (bs, dtype)
    if key not in _JAX:
        S, A, X, B, D, colors = _case(bs, False, dtype)
        S = S.copy()
        S.data = S.data.astype(_NP[dtype]).astype(np.float64)
        J = jax_block_dia(S, dtype=jnp.float64, n_pad=A.n_pad)
        keep = jnp.repeat(jnp.asarray(colors.numpy()) == COLOUR, bs)
        out = _jax_modes(J, *(jnp.asarray(v.double().numpy())
                              for v in (X, B, D)), keep)
        _JAX[key] = {k: tuple(np.asarray(o) for o in v)
                     for k, v in out.items()}
    return _JAX[key][mode]


@pytest.mark.parametrize("K", [1, 3, 17])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs,misalign", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("mode", MODES)
def test_lanes_equal_one_vector_calls_and_jax(mode, bs, misalign, dtype, K):
    _, A, X, B, D, colors = _case(bs, misalign, dtype)
    X, B = X[:K].contiguous(), B[:K].contiguous()
    got = _call(mode, A, X, B, D, colors)
    want = _jax_lanes(bs, dtype, mode)
    for k in range(K):
        one = _call(mode, A, X[k].clone(), B[k].clone(), D, colors)
        for g, o in zip(got, one):
            assert g.shape == X.shape and g.dtype == dtype
            assert torch.equal(g[k], o), (mode, k)
    for g, w in zip(got, want):
        w = w[:K]
        scale = max(np.abs(w).max(), 1e-300)
        err = np.abs(g.double().numpy() - w).max() / scale
        assert err <= TOL[dtype], (mode, err)
        assert not g[:, NB * bs:].any()


@pytest.mark.parametrize("K", [1, 3, 17])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs,misalign", SHAPES, ids=SHAPE_IDS)
def test_ring_of_one_equals_b1_twin(bs, misalign, dtype, K):
    _, A, X, B, _, _ = _case(bs, misalign, dtype)
    X, B = X[:K].contiguous(), B[:K].contiguous()
    one = SolverMesh(rank=0, world=1, device=CPU)
    halo = max(A.halo, 1)
    ring = block_halo_spmv(A.data, A.offsets, A.offsets_t, X, halo, one, 1)
    ring_r = block_halo_spmv(A.data, A.offsets, A.offsets_t, X, halo, one,
                             1, b=B)
    assert torch.equal(ring, bd.block_dia_spmv_ref(A, X))
    assert torch.equal(ring_r, bd.block_dia_resid_ref(A, X, B))


def test_block_dia_source_has_one_lane_order():
    """No lane on the grid's second dimension, and no super tile of row
    blocks: every kernel of csrc/block_dia.cu walks its lanes in the
    thread (node_product)."""
    src = (Path(bd.__file__).resolve().parent.parent / "csrc"
           / "block_dia.cu").read_text()
    assert not re.search(r"(blockIdx|gridDim)\.y", src)
    assert "SUPER" not in src and "super tile" not in src
    assert src.count("node_product<T, BS, L>(") >= 4
