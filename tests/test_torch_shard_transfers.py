"""The row-sharded forms of the device-built hierarchies' pieces, on the
CPU in one process (``pyamg_tpu_torch.parallel.partition``).

- Each device-built transfer's factor form (``shard_factors``: the
  structured SA P = S T and R = T^T S^T, the embedded classical P = P_emb
  E and R = E^T R_emb, the block P = S Q and R = Q^T S^T, T, E and Q as
  windowed operators) equals its fused apply to f64 rtol 1e-12, on inputs
  whose solve-padding tail holds values the transfer must ignore.  A
  level's P and R shard one remap, built once a block on the device in
  ``windowed_from_scipy``'s layout.
- B1's halo mode's plain twin on 4 in-process row blocks, and as a ring
  of one, equals ``block_dia_spmv_ref`` on the whole operator bit for bit
  (``PLAIN`` and ``RESID``, bs 2 and 3, f32 and f64); the device-built
  block levels store a zero block wherever a column falls outside the
  operator, which a ring of one relies on.
- The masked Jacobi's and the block smoothers' sharded arrays are the
  row and node blocks of the unsharded ones, and the per-mask inverse
  diagonals are built from the rank's blocks.
- A sharded device-built solver runs lanes and CGNR with the unsharded
  histories; mixed precision still raises (no A64, as the reference's),
  citing ROADMAP.md Queue 1 item 14.  The Cimmino and Schwarz smoothers
  shard by rows and by window starts.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import pyamg_tpu_torch as pt  # noqa: E402
from pyamg_tpu_torch.engine import relaxation as rel  # noqa: E402
from pyamg_tpu_torch.parallel.halo_spmv import (  # noqa: E402
    block_halo_spmv, block_halo_spmv_shards)
from pyamg_tpu_torch.parallel.partition import (  # noqa: E402
    SolverMesh, _shard_smoother, _transfer_block, shard_hierarchy)
from pyamg_tpu_torch.sparse import DIAMatrix  # noqa: E402
from pyamg_tpu_torch.sparse.block_dia import (  # noqa: E402
    BlockDIAMatrix, block_dia_from_scipy, block_dia_resid_ref,
    block_dia_spmv_ref)
from pyamg_tpu_torch.sparse.formats import fit  # noqa: E402
from pyamg_tpu_torch.sparse.window import TransposedWindowed  # noqa: E402

CPU = "cpu"
F64 = dict(dtype=torch.float64, device=CPU)
# 258^2: 66 564 fine rows, solve-padded to 69 632 (the reference's 4096
# multiple at >= 65 536 rows)
GRID = (258, 258)


def _one(world=1, rank=0):
    return SolverMesh(rank=rank, world=world, device=torch.device(CPU))


@pytest.fixture(scope="module")
def transfers():
    """Level 0's (P, R, coarse n_pad) of each device-built family."""
    A = pt.poisson(GRID, format="csr")
    A4, B4 = pt.linear_elasticity((24, 24))
    out = {}
    for key, solver in (
            ("structured", pt.device_sa_setup(A, grid=GRID, max_coarse=400,
                                              **F64)),
            ("embedded", pt.device_rs_setup(A, grid=GRID, max_coarse=400,
                                            **F64)),
            ("block", pt.device_sa_setup_block(A4, grid=(24, 23), B=B4,
                                               max_coarse=120, **F64))):
        h = solver.hierarchy
        out[key] = (h.levels[0], h.levels[1].n_pad)
    return out


def _in_len(f):
    if isinstance(f, (DIAMatrix, BlockDIAMatrix)):
        return f.n_pad
    if isinstance(f, TransposedWindowed):
        return f.base.n_pad
    return f.m_chunks * f.w2


def _apply(factors, x):
    """The factors applied right to left, each input fitted to its
    length (what a world of one applies)."""
    for f in reversed(factors):
        x = f @ fit(x, _in_len(f))
    return x


@pytest.mark.parametrize("key", ["structured", "embedded", "block"])
def test_factor_forms_equal_the_fused_transfers(transfers, key):
    """P xc and R r through the factors equal the fused applies to rtol
    1e-12, the fine and coarse solve-padding tails filled with values the
    transfers ignore (their rows and columns are structural zeros), the
    outputs' tails zero in both."""
    lvl, nc_pad = transfers[key]
    n_pad = lvl.n_pad
    nf = int(np.prod(lvl.P.fine_grid_p)) * getattr(lvl.A, "bs", 1)
    if key != "block":
        assert n_pad > nf               # the level is solve-padded
    block = _transfer_block(n_pad // 8)
    rng = np.random.default_rng(3)
    xc = torch.as_tensor(rng.standard_normal(nc_pad))
    r = torch.as_tensor(rng.standard_normal(n_pad))
    want_p = fit(lvl.P @ xc, n_pad)
    got_p = fit(_apply(lvl.P.shard_factors(block), xc), n_pad)
    want_r = fit(lvl.R @ r, nc_pad)
    got_r = fit(_apply(lvl.R.shard_factors(block), r), nc_pad)
    for got, want in ((got_p, want_p), (got_r, want_r)):
        torch.testing.assert_close(got, want, rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))
    assert not got_p[nf:].any() and not want_p[nf:].any()
    T = lvl.P.shard_factors(block)[-1]
    assert T.block == block and T.n_pad == n_pad
    assert T.k == (1 if key != "block" else lvl.P.m)


@pytest.mark.parametrize("key", ["structured", "embedded", "block"])
def test_level_shards_one_remap(transfers, key):
    """A level's P and R shard one remap: built once a block size and
    kept in the dict the two share (the block transfers' own block is
    built at setup, the one their unsharded applies take)."""
    lvl, _ = transfers[key]
    block = _transfer_block(lvl.n_pad // 8)
    T = lvl.P.shard_factors(block)[-1]
    assert lvl.R.shard_factors(block)[0].base is T
    assert lvl.P.remaps is lvl.R.remaps and lvl.P.remaps[block] is T
    if key == "block":
        assert lvl.P.Q is lvl.R.Q
        assert set(lvl.P.remaps) == {block, lvl.P.Q.block}


@pytest.mark.parametrize("k", [1, 3])
def test_device_remap_build_has_the_scipy_layout(k):
    """The remaps' device build (``_windowed_rows``) lays a row-local
    operator out as ``windowed_from_scipy`` does at the same block, entry
    for entry: rows without entries, explicit zeros, padding rows and a
    window wider than one w2 chunk included."""
    from pyamg_tpu_torch.engine.device_setup import _windowed_rows
    from pyamg_tpu_torch.sparse.window import windowed_from_scipy

    rng = np.random.default_rng(k)
    n, m, block = 5000, 60000, 256
    cols = (np.arange(n) * (m - k) // n)[:, None] + np.arange(k)
    cols[rng.random(n) < 0.1] = -1                  # rows with no entry
    vals = rng.standard_normal((n, k))
    vals[rng.random((n, k)) < 0.05] = 0.0           # explicit zeros
    shape = (n + 120, m)
    got = _windowed_rows(torch.as_tensor(cols), torch.as_tensor(vals), shape,
                         block, torch.float64)
    keep = cols >= 0
    rows = np.broadcast_to(np.arange(n)[:, None], cols.shape)
    M = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=shape)
    want = windowed_from_scipy(M, dtype=torch.float64, device=CPU,
                               block=block, max_w2=1 << 30)
    assert want.w2 > 1024
    for f in ("data", "idx", "starts"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("shape", "block", "w2", "m_chunks", "nnz"):
        assert getattr(got, f) == getattr(want, f), f


def _bsr(bs, dtype):
    """A block operator on a 12 x 10 node grid: the 9-point pattern's
    couplings times random bs x bs blocks."""
    rng = np.random.default_rng(bs)
    S = pt.stencil_grid(np.ones((3, 3)), (12, 10), format="csr")
    M = sp.kron(S, np.ones((bs, bs)), format="bsr")
    M.data = rng.standard_normal(M.data.shape)
    return block_dia_from_scipy(M.tobsr(blocksize=(bs, bs)), dtype=dtype,
                                device=CPU)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [2, 3])
def test_block_halo_twin_equals_whole_operator(bs, dtype):
    """B1's halo mode's twin on 4 in-process node-row blocks (halos copied
    from the neighbouring blocks; 7 uneven ones too) and as a ring of one
    (halos from x's own tail and head) equals block_dia_spmv_ref /
    block_dia_resid_ref on the whole operator bit for bit."""
    A = _bsr(bs, dtype)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(A.n_pad), dtype=dtype)
    b = torch.as_tensor(rng.standard_normal(A.n_pad), dtype=dtype)
    plain, resid = block_dia_spmv_ref(A, x), block_dia_resid_ref(A, x, b)
    assert torch.equal(block_halo_spmv_shards(A, x, 4), plain)
    assert torch.equal(block_halo_spmv_shards(A, x, 4, b=b), resid)
    ring = dict(mesh=_one(), groups=1)
    assert torch.equal(block_halo_spmv(A.data, A.offsets, A.offsets_t, x,
                                       A.halo, **ring), plain)
    assert torch.equal(block_halo_spmv(A.data, A.offsets, A.offsets_t, x,
                                       A.halo, b=b, **ring), resid)
    assert torch.equal(block_halo_spmv_shards(A, x, 7), plain)  # uneven
    with pytest.raises(ValueError):
        block_halo_spmv_shards(A, x, 20)        # 6-node blocks, halo 11


def test_device_built_block_levels_keep_zero_blocks_out_of_range(transfers):
    """A device-built block level's A, S and S^T store a zero block where
    a column falls outside the operator (so a ring of one, whose halos
    wrap round, adds exact zeros there)."""
    lvl, _ = transfers["block"]
    for M in (lvl.A, lvl.P.S, lvl.R.St):
        rows = torch.arange(M.nb_pad)
        for d, o in enumerate(M.offsets):
            out = (rows + o < 0) | (rows + o >= M.nb_pad)
            assert not M.data[d][out].any(), (o, type(M))


def test_masked_and_block_smoothers_shard_by_rows_and_nodes():
    """masked_jacobi: dinv and each mask cut to the rank's rows, whatever
    the number of masks, its per-mask inverse diagonals built from them;
    block Jacobi and block multicolour GS: Dinv and the colours cut to the
    rank's nodes, the 0-d weight whole."""
    n, nb, bs = 16, 8, 2
    dinv = torch.arange(1.0, n + 1, dtype=torch.float64)
    masks = tuple(torch.arange(n) % k == 0 for k in (2, 3, 5))
    Dinv = torch.arange(nb * bs * bs, dtype=torch.float64).reshape(nb, bs,
                                                                   bs)
    colors = torch.arange(nb, dtype=torch.int32) % 3
    omega = torch.tensor(0.7, dtype=torch.float64)
    for rank in range(4):
        mesh = _one(4, rank)
        rows = slice(rank * n // 4, (rank + 1) * n // 4)
        nodes = slice(rank * nb // 4, (rank + 1) * nb // 4)
        full = rel.masked_jacobi(dinv, masks, (2, 1, 1))
        mj = _shard_smoother(full, mesh, 4)
        assert mj.config == full.config and len(mj.arrays) == 4
        for a, a_s in zip(full.arrays, mj.arrays):
            assert torch.equal(a_s, a[rows])
        assert torch.equal(mj.mask_dinv, full.mask_dinv[:, rows])
        bj = _shard_smoother(rel.block_jacobi_dyn(Dinv, omega), mesh, 4)
        assert torch.equal(bj.arrays[0], Dinv[nodes])
        assert bj.arrays[1] is omega
        gs = _shard_smoother(rel.block_multicolor_gs(Dinv, colors, 3), mesh,
                             4)
        assert torch.equal(gs.arrays[0], Dinv[nodes])
        assert torch.equal(gs.arrays[1], colors[nodes])


@pytest.fixture(scope="module")
def sharded_sa():
    """A 48^2 device-built SA solver and its hierarchy sharded over a
    world of one (raises come before any collective)."""
    A = pt.poisson((48, 48), format="csr")
    ds = pt.device_sa_setup(A, grid=(48, 48), max_coarse=100,
                            mixed_precision=True, **F64)
    hs = shard_hierarchy(ds.hierarchy, _one())
    return A, ds, pt.StructuredDeviceSolver(hs, ds.grid, ds.grid_p,
                                            ds.setup_info)


@pytest.mark.parametrize("what", ["batched", "cgnr"])
def test_sharded_device_built_lanes_and_cgnr_solve(sharded_sa, what):
    """On a sharded device-built solver (a world of one): a batched (n, K)
    solve and CGNR run (K16's lane mode, the transposed DIA levels in a
    ring of one), with the unsharded solve's counts and histories to f64
    rtol 1e-12, as the one-vector solve (the unsharded cycle fuses its
    level entries and restrictions, the sharded one composes them)."""
    A, ds, sv = sharded_sa
    b = np.random.default_rng(0).random(A.shape[0])
    kw = dict(tol=1e-8, maxiter=30, accel="cg")
    rhs = np.stack([b, np.sin(np.arange(b.size))], axis=1) \
        if what == "batched" else b
    kw["accel"] = "cg" if what == "batched" else "cgnr"
    res0, res1 = [], []
    x0 = ds.solve(rhs, residuals=res0, **kw)
    x1 = sv.solve(rhs, residuals=res1, **kw)
    hist0, hist1 = (res0, res1) if what == "batched" else ([res0], [res1])
    assert len(hist1) == len(hist0) == (2 if what == "batched" else 1)
    for h0, h1 in zip(hist0, hist1):
        assert len(h1) == len(h0) > 3
        np.testing.assert_allclose(h1, h0, rtol=1e-12)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=1e-12)


@pytest.mark.parametrize("what", ["mixed", "tensor_b"])
def test_sharded_device_built_raises(sharded_sa, what):
    """On a sharded device-built solver (a world of one):
    precision="mixed" raises (a sharded hierarchy carries no A64, as the
    reference's, which cannot run it either), citing ROADMAP.md Queue 1
    item 14; a tensor b raises (its solve would give this rank's block of
    the padded grid); a numpy b solves with the unsharded history."""
    A, ds, sv = sharded_sa
    b = np.random.default_rng(0).random(A.shape[0])
    kw = dict(tol=1e-8, maxiter=30, accel="cg")
    if what == "mixed":
        call = lambda: sv.solve(b, precision="mixed", **kw)  # noqa: E731
    else:
        call = lambda: sv.solve(torch.as_tensor(b), **kw)  # noqa: E731
    exc = TypeError if what == "tensor_b" else ValueError
    with pytest.raises(exc, match="block" if what == "tensor_b"
                       else "item 14"):
        call()
    res0, res1 = [], []
    ds.solve(b, residuals=res0, **kw)
    sv.solve(b, residuals=res1, **kw)
    assert len(res0) == len(res1)
    np.testing.assert_allclose(res1, res0, rtol=1e-12)


@pytest.mark.parametrize("sm", [rel.jacobi_ne(torch.ones(8), 0.5)],
                         ids=["jacobi_ne"])
def test_cross_shard_cimmino_cuts_by_rows(sm):
    """The Cimmino sweep shards: its inverse row norms cut by rows (its
    A^T is the sharded operator's)."""
    cut = _shard_smoother(sm, _one(2, 1), 2)
    assert cut.config == sm.config
    assert torch.equal(cut.arrays[0], sm.arrays[0][4:])


@pytest.mark.parametrize("sm", [rel.windowed_schwarz(torch.ones(1, 8, 8), 8,
                                                     4)],
                         ids=["win_schwarz"])
def test_cross_shard_schwarz_cuts_windows_or_raises(sm):
    """Windowed Schwarz shards by its windows' starts; windows that cannot
    split over the blocks (one window of stride 4 over 2 blocks) raise
    ValueError naming the sizes, as does a window that overruns its block
    on more than one block."""
    with pytest.raises(ValueError, match="4 rows in 2 blocks"):
        _shard_smoother(sm, _one(2), 2)
    blocks = torch.arange(4 * 64, dtype=torch.float64).reshape(4, 8, 8)
    ok = rel.windowed_schwarz(blocks, 8, 4)
    cut = _shard_smoother(ok, _one(2, 1), 2)
    assert torch.equal(cut.arrays[0], blocks[2:])
    wide = rel.windowed_schwarz(torch.ones(2, 12, 12), 12, 4)
    with pytest.raises(ValueError, match="overruns a block of 4 rows"):
        _shard_smoother(wide, _one(2), 2)
    # a level on one group is a ring of one: its windows wrap onto its
    # rows however far they reach, as the unsharded sweep's do
    assert torch.equal(_shard_smoother(wide, _one(2), 1).arrays[0],
                       wide.arrays[0])
