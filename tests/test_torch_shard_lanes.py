"""The lane forms and transposes of the row-sharded operators, on the CPU
in one process (``pyamg_tpu_torch.parallel``).

- K16's lane mode (``halo_spmv`` on a K-major (K, n_local) stack, its
  plain twin on the CPU) equals K8's twin (``dia_spmm_ref``) bit for bit,
  as a ring of one and in 4 in-process row blocks (halos copied from the
  neighbouring blocks), float32 and float64, K = 1, 3, 8, on a 2-D
  5-point and a 3-D 27-point operator.
- B1's halo mode on lanes equals B1's lane twin (``block_dia_spmv_ref``,
  ``block_dia_resid_ref``) bit for bit, ring of one and 4 blocks, bs 2
  and 3.
- A sharded operator's ``rmatvec`` (a world of one) equals the unsharded
  transpose: ``DIAMatrix.rmatvec``'s rolls bit for bit (the transposed
  DIA keeps A's diagonal order), ``BlockDIAMatrix.rmatvec`` bit for bit,
  the windowed and dense transposes; one vector and K = 3 lanes.
- Windowed Schwarz on a sharded operator (a world of one: its halo and
  spill wrap onto the block itself) equals the unsharded sweep bit for
  bit, on a vector and on lanes; a block that a window overruns raises
  ValueError naming the sizes, before any communication.
- A sharded hierarchy never takes the interleaved route.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import pyamg_tpu_torch as pt  # noqa: E402
from pyamg_tpu_torch.engine import relaxation as rel  # noqa: E402
from pyamg_tpu_torch.parallel import halo_width  # noqa: E402
from pyamg_tpu_torch.parallel.halo_spmv import (  # noqa: E402
    block_halo_spmv, block_halo_spmv_shards, halo_spmv, halo_spmv_shards)
from pyamg_tpu_torch.parallel.partition import (  # noqa: E402
    ShardedOperator, SolverMesh, _schwarz_update)
from pyamg_tpu_torch.sparse import (DenseOperator, dia_from_scipy,  # noqa: E402
                                    windowed_from_scipy)
from pyamg_tpu_torch.sparse.block_dia import (  # noqa: E402
    block_dia_from_scipy, block_dia_resid_ref, block_dia_spmv_ref)
from pyamg_tpu_torch.sparse.dia import dia_spmm_ref  # noqa: E402

CPU = "cpu"
DTYPES = [torch.float32, torch.float64]


def _one():
    return SolverMesh(rank=0, world=1, device=torch.device(CPU))


def _random_stencil_matrix(grid, seed):
    """A nonsymmetric operator of the full 3^d-point stencil on ``grid``
    (5 points in 2-D, 27 in 3-D), random coefficients."""
    d = len(grid)
    rng = np.random.default_rng(seed)
    if d == 2:
        st = np.zeros((3, 3))
        st[1, :] = rng.standard_normal(3)
        st[:, 1] = rng.standard_normal(3)
        st[1, 1] = 8.0
    else:
        st = rng.standard_normal((3,) * d)
        st[(1,) * d] = 30.0
    return pt.stencil_grid(st, grid).tocsr()


def _stack(n, K, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((K, n))
    return torch.as_tensor(x, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("grid", [(40, 48), (8, 8, 8)], ids=["nd5", "nd27"])
def test_k16_lanes_equal_k8(dtype, K, grid):
    """K16's lane mode, ring of one and 4 row blocks, equals K8's twin bit
    for bit on every lane."""
    A = dia_from_scipy(_random_stencil_matrix(grid, 1), dtype=dtype,
                       device=CPU, row_pad=64)
    assert A.ndiags == 3 ** len(grid) - (4 if len(grid) == 2 else 0)
    X = _stack(A.n_pad, K, dtype, 2)
    want = dia_spmm_ref(A, X)
    ring = halo_spmv(A.data, A.offsets, A.offsets_t, X, halo_width(A),
                     _one(), 1)
    assert ring.shape == (K, A.n_pad)
    assert torch.equal(ring, want)
    assert torch.equal(halo_spmv_shards(A, X, 4), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs", [2, 3])
def test_block_halo_lanes_equal_b1(dtype, bs):
    """B1's halo mode on K = 3 lanes (PLAIN and RESID), ring of one and 4
    node-row blocks, equals B1's lane twin bit for bit."""
    rng = np.random.default_rng(bs)
    nb = 96
    pattern = sp.diags([1.0] * 5, [-9, -1, 0, 1, 9], shape=(nb, nb))
    blocks = rng.standard_normal((pattern.nnz, bs, bs))
    pattern = pattern.tocsr()
    A = sp.bsr_matrix((blocks, pattern.indices, pattern.indptr),
                      shape=(nb * bs, nb * bs))
    Ab = block_dia_from_scipy(A, dtype=dtype, device=CPU)
    X = _stack(Ab.n_pad, 3, dtype, 5)
    Bv = _stack(Ab.n_pad, 3, dtype, 6)
    halo = max(Ab.halo, 1)
    plain, resid = block_dia_spmv_ref(Ab, X), block_dia_resid_ref(Ab, X, Bv)
    for got in (block_halo_spmv(Ab.data, Ab.offsets, Ab.offsets_t, X, halo,
                                _one(), 1),
                block_halo_spmv_shards(Ab, X, 4)):
        assert torch.equal(got, plain)
    for got in (block_halo_spmv(Ab.data, Ab.offsets, Ab.offsets_t, X, halo,
                                _one(), 1, b=Bv),
                block_halo_spmv_shards(Ab, X, 4, b=Bv)):
        assert torch.equal(got, resid)


def _operator(kind):
    """(unsharded operator, its transpose apply) of a nonsymmetric
    float64 level of each sharded kind."""
    A = _random_stencil_matrix((24, 32), 3)
    if kind == "dia":
        op = dia_from_scipy(A, dtype=torch.float64, device=CPU, row_pad=64)
        return op, op.rmatvec
    if kind == "block":
        Ae, _ = pt.linear_elasticity((12, 12))
        Ae = (Ae + sp.triu(Ae, 1) * 0.5).tobsr(blocksize=(2, 2))
        op = block_dia_from_scipy(Ae, dtype=torch.float64, device=CPU)
        return op, op.rmatvec
    if kind == "windowed":
        op = windowed_from_scipy(A, dtype=torch.float64, device=CPU)
        return op, op.rmatvec
    data = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (64, 64)))
    op = DenseOperator(data=data, shape=(64, 64), nnz=64 * 64)
    return op, op.rmatvec


@pytest.mark.parametrize("kind", ["dia", "block", "windowed", "dense"])
def test_sharded_rmatvec_equals_transpose(kind):
    """A sharded level operator's A^T (a world of one: the DIA and block
    levels' transposed diagonals built from the ring-wrapped halos) equals
    the unsharded transpose on a vector and on K = 3 lanes: bit for bit
    for the DIA, block and windowed levels (the same products summed in
    the same order), to 1e-15 for the dense one."""
    op, rmatvec = _operator(kind)
    n_pad = op.n_pad
    sh = ShardedOperator(op, _one(), (1, n_pad), (1, n_pad), 1)
    for y in (_stack(n_pad, 1, torch.float64, 7)[0],
              _stack(n_pad, 3, torch.float64, 8)):
        got, want = sh.rmatvec(y), rmatvec(y)
        want = want[..., :n_pad]
        assert got.shape == y.shape
        if kind == "dense":
            torch.testing.assert_close(got, want, rtol=1e-15, atol=1e-15)
        else:
            assert torch.equal(got, want)
    # built once, at the first transpose
    (f,) = sh.factors
    if kind in ("dia", "block"):
        assert f.transposed is f.transposed


def _schwarz_rolls(inv, r, w, s):
    """The reference's windowed Schwarz update by rolls: every window's
    chunks from r rolled left, its corrections' chunks rolled back and
    summed in chunk order."""
    q, lead = w // s, r.shape[:-1]
    Wn = torch.cat([torch.roll(r, -c * s, dims=-1).reshape(
        lead + (inv.shape[0], s)) for c in range(q)], dim=-1)
    u = torch.einsum("nij,...nj->...ni", inv, Wn)
    upd = torch.zeros_like(r)
    for c in range(q):
        upd = upd + torch.roll(
            u[..., c * s:(c + 1) * s].reshape(lead + (-1,)), c * s, dims=-1)
    return upd


@pytest.mark.parametrize("lanes", [False, True], ids=["vector", "lanes"])
def test_sharded_schwarz_world_of_one_bit_for_bit(lanes):
    """Windowed Schwarz (window 16, stride 8, and window 24, stride 8:
    two and three chunks a window) on the sharded form of a DIA level in
    a world of one equals the unsharded sweep bit for bit, and both
    equal the reference's rolls: the right halo and the spills wrap onto
    the block, where the rolls wrap, and every entry's chunks are summed
    in the rolls' order.  On 16 rows, windows of 32 (stride 8) wrap onto
    them more than once, as the rolls do."""
    A = dia_from_scipy(_random_stencil_matrix((16, 24), 9),
                       dtype=torch.float64, device=CPU, row_pad=64)
    n_pad = A.n_pad
    sh = ShardedOperator(A, _one(), (1, n_pad), (1, n_pad), 1)
    K = 3 if lanes else 1
    x = _stack(n_pad, K, torch.float64, 10)
    b = _stack(n_pad, K, torch.float64, 11)
    if not lanes:
        x, b = x[0], b[0]
    for w, s in ((16, 8), (24, 8)):
        inv = torch.as_tensor(np.random.default_rng(w).standard_normal(
            (n_pad // s, w, w)))
        assert torch.equal(rel.schwarz_corrections(inv, b, w, s),
                           _schwarz_rolls(inv, b, w, s))
        sm = rel.windowed_schwarz(inv, w, s, omega=0.9, iterations=2)
        want = sm(A, x, b)
        assert torch.equal(sm(sh, x, b), want)
    inv = torch.as_tensor(np.random.default_rng(32).standard_normal(
        (2, 32, 32)))
    r = b[..., :16]
    assert torch.equal(rel.schwarz_corrections(inv, r, 32, 8),
                       _schwarz_rolls(inv, r, 32, 8))


def test_sharded_schwarz_overrun_raises():
    """A block that a window overruns (window 24, stride 8: 16 rows past
    the start of the block's last window, on blocks of 8 rows) raises
    ValueError naming the sizes, before any communication."""
    mesh = SolverMesh(rank=0, world=4, device=torch.device(CPU))
    inv = torch.zeros((1, 24, 24), dtype=torch.float64)
    r = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="window 24 .stride 8. overruns "
                       "a block of 8 rows"):
        _schwarz_update(r, inv, 24, 8, mesh, 4)


def test_sharded_hierarchy_never_interleaved():
    """A lane-aligned device-built hierarchy takes the interleaved route
    unsharded; sharded (a world of one) it does not, and its batched
    float32 CG runs on K-major lanes to the tolerance."""
    from pyamg_tpu_torch.engine.batched_cycle import supports_interleaved
    from pyamg_tpu_torch.parallel import shard_hierarchy

    A = pt.poisson((24, 384), format="csr")
    ds = pt.device_sa_setup(A, grid=(24, 384), device=CPU, max_coarse=60,
                            lane_align=True)
    assert supports_interleaved(ds.hierarchy)
    hs = shard_hierarchy(ds.hierarchy, _one())
    assert not supports_interleaved(hs)
    sv = pt.StructuredDeviceSolver(hs, ds.grid, ds.grid_p, ds.setup_info)
    B = np.random.default_rng(0).random((A.shape[0], 2))
    res = []
    X, info = sv.solve(B, tol=1e-5, accel="cg", residuals=res,
                       return_info=True)
    assert info == 0 and X.shape == B.shape
    for h, col in zip(res, B.T):
        assert h[-1] < 1e-5 * np.linalg.norm(col)
