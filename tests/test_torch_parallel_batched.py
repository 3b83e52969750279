"""Sharded batched (n, K) solves, CGNR / CGNE and the lane forms of the
cross-shard smoothers on 4 gloo CPU ranks (``pyamg_tpu_torch.parallel``),
against the port's unsharded solves and the JAX package's.

Every hierarchy is built whole in the parent and sharded on the ranks of
one spawn (its own fixture and deadline, apart from
``tests/test_torch_parallel.py``'s two spawns): each rank runs every case
of :func:`_rank_cases` and saves its results, and the tests compare.

- Batched solves (a K-major (K, n_local) lane stack a rank: K16's lane
  mode on the DIA levels, B1's halo mode on lanes on the block levels,
  K12 / K13 on the windowed ones) on the host-built config 1 hierarchy
  (64^2, CG, W-cycle BiCGStab, GMRES restart 5), the device-built
  structured SA, classical RS, routed AIR and block (elasticity 16^2)
  hierarchies and the unstructured SA hierarchy: every lane's count and
  its history to f64 rtol 1e-10 against the port's unsharded batched
  solve, x within 1e-10, every rank the same histories.  The lanes
  converge at different counts (a random, a checkerboard scaled by 1e3
  and a smooth right-hand side scaled by 1e-3), so the per-lane freeze
  runs on all-reduced norms.
- On the host-built case the JAX package's batched solve of its own
  hierarchy (the reference's vmapped path, which it takes sharded or not)
  gives every lane's count and its history to rtol 1e-10.
- CGNR and CGNE (A^T of each sharded level: the transposed DIA through
  K16, built at first use) on the AIR 32^2 hierarchy, float64, and CGNR
  on two lanes: the one-rank count and history to rtol 1e-10; the JAX
  package's AIR setup and solve give the same history to rtol 1e-10
  (both stall and run to maxiter, so the residual norms, not the count,
  hold A^T).
- The Cimmino sweep and windowed Schwarz on lanes (host-built 64^2,
  GMRES): the one-rank counts and histories.

Tolerances: the sharded dots and coarse partials sum over the ranks in
another order (``all_reduce``), and a device-built level composes what
the unsharded cycle fuses, so histories agree to rounding, not bits.
"""
import os
import time
import traceback
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import _fem, _routed_advection  # noqa: E402

from pyamg_tpu_torch import (BlockStructuredDeviceSolver,  # noqa: E402
                             DeviceMultilevelSolver, StructuredDeviceSolver,
                             advection_2d, compile_hierarchy,
                             device_air_setup, device_rs_setup,
                             device_sa_setup, device_sa_setup_block,
                             device_unstructured_sa_setup,
                             linear_elasticity, poisson,
                             smoothed_aggregation_solver)
from pyamg_tpu_torch.relaxation import change_smoothers  # noqa: E402

WORLD = 4
DEADLINE_S = 150
CONFIG1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
               postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
F64 = dict(dtype=torch.float64, device="cpu")
# the host-built hierarchy's lane solves
HOST = {"host_cg": dict(accel="cg"),
        "host_bicgstab_w": dict(accel="bicgstab", cycle="W"),
        "host_gmres": dict(accel="gmres", restart=5)}
# the cross-shard smoothers on lanes (host-built 64^2)
CROSS = {"cimmino_lanes": ("gauss_seidel_nr", {}),
         "schwarz_lanes": ("schwarz", {})}


def _lanes(n, grid_n=None):
    """Three right-hand sides that converge at different counts: random,
    a checkerboard times 1e3 and a smooth one times 1e-3."""
    i = np.arange(n)
    g = grid_n or int(round(np.sqrt(n)))
    rand = np.random.default_rng(0).random(n)
    checker = (-1.0) ** (i % g + i // g)
    smooth = np.sin(np.pi * (i % g + 1) / (g + 1)) * np.sin(
        np.pi * (i // g % g + 1) / (g + 1))
    return np.stack([rand, 1e3 * checker, 1e-3 * smooth], axis=1)


def _cases():
    """key -> (hierarchy, grid solver or None, b, solve keywords,
    min_local_rows)."""
    A = poisson((64, 64), format="csr")
    h = compile_hierarchy(smoothed_aggregation_solver(A, **CONFIG1),
                          row_pad=64, **F64)
    B = _lanes(A.shape[0])
    cases = {key: (h, None, B, dict(tol=1e-10, maxiter=40, **kw), 128)
             for key, kw in HOST.items()}
    cg10 = dict(tol=1e-10, maxiter=40, accel="cg")
    A48 = poisson((48, 48), format="csr")
    B48 = _lanes(A48.shape[0])
    sa = device_sa_setup(A48, grid=(48, 48), max_coarse=100, **F64)
    rs = device_rs_setup(A48, grid=(48, 48), max_coarse=100, **F64)
    A_un, b_un = _routed_advection(40)
    air = device_air_setup(A_un, max_coarse=400, **F64)
    B_un = np.stack([b_un, np.roll(b_un, 17), _lanes(A_un.shape[0])[:, 0]],
                    axis=1)
    A_bk, B_m = linear_elasticity((16, 16))
    block = device_sa_setup_block(A_bk, grid=(16, 15), B=B_m,
                                  max_coarse=60, **F64)
    # the block solver takes one right-hand side at a time (the
    # reference's): a lane stack goes through the plain solver on its
    # grid-encoded columns
    B_bk = np.stack([block._encode(c) for c in _lanes(A_bk.shape[0], 32).T],
                    axis=1)
    M = _fem(48)
    us = device_unstructured_sa_setup(M, max_coarse=100, **F64)
    cases.update({
        "sa": (sa.hierarchy, sa, B48, cg10, 128),
        "rs": (rs.hierarchy, rs, B48, cg10, 128),
        "air_routed": (air.hierarchy, None, B_un,
                       dict(tol=1e-10, maxiter=30, accel="fgmres"), 1024),
        "block": (block.hierarchy, None, B_bk,
                  dict(tol=1e-8, maxiter=60, accel="cg"), 128),
        "unstructured": (us.hierarchy, None, _lanes(M.shape[0], 48),
                         dict(tol=1e-10, maxiter=40, accel="cg"), 128),
    })
    A_air, b_air = advection_2d((32, 32), theta=np.pi / 4)
    d_air = device_air_setup(A_air, grid=(32, 32), max_coarse=30, **F64)
    b_air = np.asarray(b_air)
    ne = dict(tol=1e-8, maxiter=20)
    cases.update({
        "cgnr": (d_air.hierarchy, d_air, b_air, dict(ne, accel="cgnr"),
                 128),
        "cgne": (d_air.hierarchy, d_air, b_air, dict(ne, accel="cgne"),
                 128),
        "cgnr_lanes": (d_air.hierarchy, d_air,
                       np.stack([b_air, np.roll(b_air, 5)], axis=1),
                       dict(ne, accel="cgnr"), 128),
    })
    ml = smoothed_aggregation_solver(A, **CONFIG1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for key, spec in CROSS.items():
            hc = compile_hierarchy(change_smoothers(ml, spec, spec),
                                   row_pad=64, **F64)
            cases[key] = (hc, None, B[:, :2],
                          dict(tol=1e-8, maxiter=12, accel="gmres",
                               restart=10), 128)
    return cases


def _solver(h, grid):
    """A solver over ``h`` keeping a grid solver's encoding."""
    if isinstance(grid, BlockStructuredDeviceSolver):
        return BlockStructuredDeviceSolver(h, grid.grid, grid.grid_p,
                                           grid.bs, grid.setup_info)
    if isinstance(grid, StructuredDeviceSolver):
        return StructuredDeviceSolver(h, grid.grid, grid.grid_p,
                                      grid.setup_info)
    return DeviceMultilevelSolver(h)


def _solve(h, grid, b, kw):
    """(per-lane histories (or one), x, info) of one solve."""
    res = []
    x, info = _solver(h, grid).solve(b, residuals=res, return_info=True,
                                     **kw)
    hists = [np.asarray(r) for r in res] if np.ndim(b) == 2 \
        else [np.asarray(res)]
    return hists, x, info


def _rank_cases(mesh, inp):
    """One rank's sharded solves: its block of every hierarchy."""
    from pyamg_tpu_torch.parallel import shard_hierarchy

    g = torch.arange(3 * 64, dtype=torch.float64).reshape(3, 64)
    blk = mesh.local(g, WORLD)
    out = {"stacks": (blk, mesh.gather(blk, WORLD),
                      mesh.relayout(blk, (WORLD, 64), (2, 64)),
                      mesh.relayout(blk, (WORLD, 64), (1, 40)),
                      mesh.relayout(mesh.local(g[:, :48], 2), (2, 48),
                                    (WORLD, 64)))}
    for key, (h, grid, b, kw, mlr) in inp.items():
        hs = shard_hierarchy(h, mesh, min_local_rows=mlr)
        out[key] = _solve(hs, grid, b, kw) + (hs.groups,)
    return out


def _rank_main(rank, init_file, inputs_path, out_dir):
    """One gloo rank: :func:`_rank_cases`'s results saved per rank."""
    import torch.distributed as dist

    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh)

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    try:
        got = initialize_distributed(init_method=f"file://{init_file}",
                                     world_size=WORLD, rank=rank,
                                     device="cpu")
        mesh = make_solver_mesh(device="cpu")
        out = {"init": got, **_rank_cases(
            mesh, torch.load(inputs_path, weights_only=False))}
        dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(tmp, inputs):
    """:func:`_rank_main` on WORLD ranks; every rank's results (fails the
    caller on an error or past the deadline)."""
    import torch.multiprocessing as mp

    inputs_path = str(tmp / "inputs.pt")
    torch.save(inputs, inputs_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "rendezvous"), inputs_path,
                               str(tmp)))
             for r in range(WORLD)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    deadline = t0 + DEADLINE_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp / f"rank{r}.err").read_text() for r in range(WORLD)
              if (tmp / f"rank{r}.err").exists()]
    assert not hung, f"ranks {hung} still running after {DEADLINE_S} s"
    assert not errors and all(p.exitcode == 0 for p in procs), \
        "\n".join(errors) or [p.exitcode for p in procs]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """The cases, the port's unsharded solves of each, and every rank's
    sharded solves.  Built single-threaded: beside the other test workers
    and the ranks, intra-op threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cases = _cases()
            refs = {key: _solve(h, grid, b, kw)
                    for key, (h, grid, b, kw, _) in cases.items()}
        ranks = _spawn(tmp_path_factory.mktemp("spmd_batched"), cases)
        return dict(cases=cases, refs=refs, ranks=ranks)
    finally:
        torch.set_num_threads(threads)


def _assert_lanes(spmd, key, rtol=1e-10):
    """Rank 0's sharded solve of ``key`` against the unsharded one: every
    lane's count, its history to ``rtol`` (entries far below the first
    to 1e-14 of it), x within 1e-10 of its size, the same info; every
    rank the same histories and x."""
    hists, x, info, groups = spmd["ranks"][0][key]
    hists1, x1, info1 = spmd["refs"][key]
    assert groups[0] > 1, groups
    assert len(hists) == len(hists1)
    for h, h1 in zip(hists, hists1):
        assert len(h) == len(h1) > 3
        np.testing.assert_allclose(h, h1, rtol=rtol, atol=1e-14 * h1[0])
    assert x.shape == x1.shape
    np.testing.assert_allclose(x, x1, rtol=0,
                               atol=1e-10 * np.abs(x1).max())
    assert info == info1
    for out in spmd["ranks"][1:]:
        for h, h0 in zip(out[key][0], hists):
            np.testing.assert_array_equal(h, h0)
        np.testing.assert_array_equal(out[key][1], x)
    return hists


def test_ranks_initialize(spmd):
    """Every rank saw the world of 4."""
    for r, out in enumerate(spmd["ranks"]):
        assert out["init"] == (r, WORLD, WORLD)


def test_mesh_moves_lane_stacks(spmd):
    """``SolverMesh.local``, ``gather`` and ``relayout`` act on the last
    axis of a (K, n) stack: each rank's block is its columns, the gather
    the whole stack, a relayout onto 2 groups or 1 (fitted to 40
    columns) the new layout's block, and from 2 groups of a 48-column
    stack onto 4 of 64 the zero-padded stack's block."""
    g = torch.arange(3 * 64, dtype=torch.float64).reshape(3, 64)
    pad = torch.cat([g[:, :48], torch.zeros(3, 16, dtype=g.dtype)], dim=1)
    for r, out in enumerate(spmd["ranks"]):
        blk, full, two, one, up = out["stacks"]
        assert torch.equal(blk, g[:, 16 * r:16 * (r + 1)])
        assert torch.equal(full, g)
        s2 = r // 2
        assert torch.equal(two, g[:, 32 * s2:32 * (s2 + 1)])
        assert torch.equal(one, g[:, :40])
        assert torch.equal(up, pad[:, 16 * r:16 * (r + 1)])


@pytest.mark.parametrize("key", list(HOST))
def test_sharded_host_lanes(spmd, key):
    """The host-built config 1 hierarchy (64^2, float64) over 4 ranks on
    K = 3 lanes (CG, W-cycle BiCGStab, GMRES restart 5): each lane's
    unsharded count and history; the lanes stop at different counts."""
    hists = _assert_lanes(spmd, key)
    assert len({len(h) for h in hists}) > 1


def test_sharded_host_lanes_match_jax(spmd):
    """The JAX package's batched CG (its vmapped path, which it takes
    sharded or not) on its own compile of config 1's 64^2 hierarchy:
    every lane's count and its history to rtol 1e-10 against the port's
    sharded solve."""
    import jax
    import jax.numpy as jnp

    from pyamg_tpu.aggregation import smoothed_aggregation_solver as jax_sa
    from pyamg_tpu.engine import DeviceMultilevelSolver as JaxSolver
    from pyamg_tpu.engine import compile_hierarchy as jax_compile

    jax.config.update("jax_enable_x64", True)
    _, _, B, kw, _ = spmd["cases"]["host_cg"]
    h = jax_compile(jax_sa(poisson((64, 64), format="csr"), **CONFIG1),
                    dtype=jnp.float64, row_pad=64)
    res = []
    JaxSolver(h).solve(B, residuals=res, **kw)
    hists = spmd["ranks"][0]["host_cg"][0]
    assert len(res) == len(hists) == B.shape[1]
    for h_port, h_jax in zip(hists, res):
        h_jax = np.asarray(h_jax)
        h_jax = h_jax[~np.isnan(h_jax)]
        assert len(h_port) == len(h_jax)
        np.testing.assert_allclose(h_port, h_jax, rtol=1e-10,
                                   atol=1e-14 * h_jax[0])


@pytest.mark.parametrize("key", ["sa", "rs", "air_routed", "block",
                                 "unstructured"])
def test_sharded_device_built_lanes(spmd, key):
    """The device-built structured SA and classical RS (48^2), the routed
    AIR (40^2 advection in RCM order, level 0 on 2 groups), the block
    setup (elasticity 16^2, encoded column by column) and the unstructured
    SA hierarchy (48^2 P1 mesh + 1e-2 I), float64, over 4 ranks on K = 3
    lanes: each lane's unsharded count and history."""
    _assert_lanes(spmd, key)


@pytest.mark.parametrize("key", ["cgnr", "cgne", "cgnr_lanes"])
def test_sharded_cgnr_cgne(spmd, key):
    """CGNR and CGNE on the AIR 32^2 hierarchy (float64) over 4 ranks,
    A^T of every level through its transposed DIA (K16): the one-rank
    count and history; CGNR on two lanes too.  The JAX package's AIR
    setup and the same solve give the same history to rtol 1e-10: its
    AMG-preconditioned normal equations stall on this operator, as the
    port's do, so both run to maxiter and the count alone says nothing of
    A^T; the residual norms do."""
    hists = _assert_lanes(spmd, key)
    if key == "cgnr_lanes":
        return
    import jax
    import jax.numpy as jnp

    from pyamg_tpu import engine as je

    jax.config.update("jax_enable_x64", True)
    A, _ = advection_2d((32, 32), theta=np.pi / 4)
    _, _, b, kw, _ = spmd["cases"][key]
    res = []
    je.device_air_setup(A, grid=(32, 32), max_coarse=30,
                        dtype=jnp.float64).solve(b, residuals=res, **kw)
    res = np.asarray(res)
    assert len(res) == len(hists[0])
    np.testing.assert_allclose(hists[0], res, rtol=1e-10,
                               atol=1e-14 * res[0])


@pytest.mark.parametrize("key", list(CROSS))
def test_sharded_cross_shard_smoothers_on_lanes(spmd, key):
    """The Cimmino sweep (``jacobi_nr``) and windowed Schwarz on two lanes
    of the host-built 64^2 hierarchy over 4 ranks (GMRES restart 10): the
    one-rank counts and histories (a Schwarz window's halo and spill cross
    the ranks for every lane in one message)."""
    _assert_lanes(spmd, key)
