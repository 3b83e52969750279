"""The port's distributed paths (``pyamg_tpu_torch.parallel``) against the
JAX package's (``tests/test_parallel.py``), and the deterministic windowed
transposes' plan form against their twins.

The device-built hierarchies (structured SA, classical RS, the block
setup, structured and routed AIR) are built whole in the parent and
sharded on the ranks of a second spawn (its own fixture and deadline), the
counterparts of ``test_parallel.py``'s distributed setups (whose setup
GSPMD partitions; here the setup's result is sharded): each sharded solve
against the port's one-rank solve (same length, rtol 1e-9, x within 1e-10
relative) and against the JAX package's unsharded solve at its family's
parity tolerance.

The JAX side runs as ``tests/test_parallel.py`` runs it, on the 8 virtual
CPU devices of ``tests/conftest.py`` (K16 under the Pallas interpreter).
The port side runs SPMD on 8 gloo ranks: each of two module-scoped
fixtures spawns them once (``torch.multiprocessing``, a ``file://``
rendezvous under the test's temporary directory, each rank
single-threaded, a 120 s deadline after which the ranks are killed and
the tests fail), every rank runs every case of the fixture's body
(:func:`_cases`, :func:`_device_built_rank_cases`) and saves its
results, and the tests compare.  The first fixture takes 25-29 s alone,
but ~100 s beside three other test workers, most of it the ranks
starting and importing under load: the deadline bounds the ranks, not
the fixture's own setup, and the sharded batched solves have a spawn of
their own (``tests/test_torch_parallel_batched.py``) so as not to grow
these two.  Inputs come from numpy seeds; the spawned ranks import torch,
numpy and the port only (JAX is imported inside the tests).  Tolerances:
bit-equality where the arithmetic is the same; f64 parity at the
reference's rtol 1e-9 (1e-10 against the port's one-rank solve), since
the sharded dots and restrictions sum their partials over ranks in
another order (``all_reduce``).
"""
import os
import time
import traceback

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from pyamg_tpu_torch import (BlockStructuredDeviceSolver,  # noqa: E402
                             ComposedWindowed, DeviceMultilevelSolver,
                             StructuredDeviceSolver, advection_2d,
                             compile_hierarchy, device_air_setup,
                             device_rs_setup, device_sa_setup,
                             device_sa_setup_block,
                             device_unstructured_rs_setup,
                             device_unstructured_sa_setup, gradgradform,
                             linear_elasticity, poisson,
                             regular_triangle_mesh,
                             smoothed_aggregation_solver)
from pyamg_tpu_torch.relaxation import change_smoothers  # noqa: E402
from pyamg_tpu_torch.sparse import dia_from_scipy, window  # noqa: E402
from pyamg_tpu_torch.sparse.dia import dia_spmv_ref  # noqa: E402

WORLD = 8
DEADLINE_S = 120
CONFIG1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
               postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
# the other cycles and Krylov methods on the sharded host-built hierarchy:
# GMRES's basis projections and AMLI's coarse dots (level 1 sits on a
# subset of the ranks) sum over the shards too
SHARDED_CYCLES = {"bicgstab_w": dict(accel="bicgstab", cycle="W"),
                  "gmres_amli": dict(accel="gmres", cycle="AMLI",
                                     restart=5)}
# the other smoothers on sharded hierarchies: multicolour Gauss-Seidel and
# Chebyshev host-built (every colour step and Horner step a K16 SpMV), and
# the unstructured setup's Chebyshev (its coefficient stack, length 3,
# stays whole on every rank); the sweeps that cross shards: the Cimmino
# sweep (A^T of the sharded operator, its transposed DIA levels) and
# windowed Schwarz (a halo of r in, the windows' spills out)
CHEB = ("chebyshev", {"degree": 3})
SHARDED_SMOOTHERS = {"mcgs": ("gauss_seidel", {"sweep": "symmetric"}),
                     "chebyshev": CHEB}
CROSS_SHARD_SMOOTHERS = {"cimmino": ("gauss_seidel_nr", {}),
                         "schwarz": ("schwarz", {})}


def _fem(nx):
    A = sp.csr_matrix(gradgradform(*regular_triangle_mesh(nx, nx)))
    return (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()


def _routed_advection(nx):
    """Upwind advection (theta = pi/4) in the RCM order of |A| + |A^T|:
    no grid stencil left, so device_air_setup routes it to the
    unstructured AIR setup (40^2: a 32^2 grid's RCM order still reads as
    a (64, 4, 4) grid)."""
    from scipy.sparse import csgraph

    A, b = advection_2d((nx, nx), theta=np.pi / 4)
    A = sp.csr_matrix(A)
    perm = csgraph.reverse_cuthill_mckee(sp.csr_matrix(abs(A) + abs(A.T)),
                                         symmetric_mode=True)
    return sp.csr_matrix(A[perm][:, perm]), np.asarray(b)[perm]


def _device_built_cases():
    """The device-built hierarchies sharded on the ranks: key -> (A, b,
    the JAX setup's call, the port's solver, solve kwargs,
    min_local_rows).  The first three are test_parallel.py:176, :229 and
    :277's cases."""
    f64 = dict(dtype=torch.float64, device="cpu")
    A_sa = poisson((96, 96), format="csr")
    b_sa = np.random.default_rng(0).random(A_sa.shape[0])
    A_rs = poisson((64, 64), format="csr")
    b_rs = np.random.default_rng(0).random(A_rs.shape[0])
    A_bk, B_bk = linear_elasticity((24, 24))
    b_bk = np.random.default_rng(0).random(A_bk.shape[0])
    A_air, b_air = advection_2d((64, 64), theta=np.pi / 4)
    A_un, b_un = _routed_advection(40)
    cg10 = dict(tol=1e-10, maxiter=40, accel="cg")
    fg = dict(tol=1e-10, maxiter=30, accel="fgmres")
    return {
        "sa": (A_sa, b_sa, ("sa", dict(grid=(96, 96), max_coarse=200)),
               device_sa_setup(A_sa, grid=(96, 96), max_coarse=200, **f64),
               cg10, 128),
        "sa_f32": (A_sa, b_sa, None,
                   device_sa_setup(A_sa, grid=(96, 96), max_coarse=200,
                                   device="cpu"),
                   dict(tol=1e-5, maxiter=40, accel="cg"), 128),
        "rs": (A_rs, b_rs, ("rs", dict(grid=(64, 64), max_coarse=200)),
               device_rs_setup(A_rs, grid=(64, 64), max_coarse=200, **f64),
               cg10, 128),
        "block": (A_bk, b_bk, ("block", dict(grid=(24, 23), B=B_bk,
                                             max_coarse=120)),
                  device_sa_setup_block(A_bk, grid=(24, 23), B=B_bk,
                                        max_coarse=120, **f64),
                  dict(tol=1e-8, maxiter=60, accel="cg"), 128),
        "air": (A_air, b_air, ("air", dict(grid=(64, 64), max_coarse=30)),
                device_air_setup(A_air, grid=(64, 64), max_coarse=30, **f64),
                fg, 128),
        # level 0's two row blocks of 1024 split over 2 groups
        "air_routed": (A_un, b_un, ("air", dict(max_coarse=400)),
                       device_air_setup(A_un, max_coarse=400, **f64), fg,
                       1024),
    }


def _sharded_solver(solver, mesh, min_local_rows):
    """The solver over its hierarchy sharded, keeping a grid solver's
    encoding (and a block solver's block size)."""
    from pyamg_tpu_torch.parallel import shard_hierarchy

    hs = shard_hierarchy(solver.hierarchy, mesh,
                         min_local_rows=min_local_rows)
    if isinstance(solver, BlockStructuredDeviceSolver):
        return BlockStructuredDeviceSolver(hs, solver.grid, solver.grid_p,
                                           solver.bs, solver.setup_info)
    if isinstance(solver, StructuredDeviceSolver):
        return StructuredDeviceSolver(hs, solver.grid, solver.grid_p,
                                      solver.setup_info)
    return DeviceMultilevelSolver(hs)


def _rank_main(body, rank, init_file, inputs_path, out_dir):
    """One gloo rank: ``body(mesh, inputs)``'s results saved per rank."""
    import torch.distributed as dist

    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh)

    torch.set_num_threads(1)
    try:
        got = initialize_distributed(init_method=f"file://{init_file}",
                                     world_size=WORLD, rank=rank,
                                     device="cpu")
        mesh = make_solver_mesh(device="cpu")
        out = {"init": got,
               **body(mesh, torch.load(inputs_path, weights_only=False))}
        dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _device_built_rank_cases(mesh, inp):
    """One rank's sharded device-built solves."""
    out = {}
    for key, (solver, b, kw, mlr) in inp.items():
        sv = _sharded_solver(solver, mesh, mlr)
        res = []
        x = sv.solve(b, residuals=res, **kw)
        out[key] = (np.asarray(res), x, sv.hierarchy.groups)
    return out


def _cases(mesh, inp):
    """One rank's host-built, unstructured, smoother and Krylov cases."""
    from pyamg_tpu_torch.engine.krylov import device_cg
    from pyamg_tpu_torch.parallel import (halo_width, make_halo_dia_spmv,
                                          shard_hierarchy, shard_vector)
    from pyamg_tpu_torch.parallel.halo_spmv import halo_spmv

    out = {}
    for key in ("dia64", "dia32"):
        A, x = inp[key]
        spmv, place = make_halo_dia_spmv(A, mesh)
        out[key] = mesh.gather(spmv(A.data, place(x)), WORLD)
        out[key + "_k16"] = mesh.gather(halo_spmv(
            mesh.local(A.data, WORLD), A.offsets, A.offsets_t, place(x),
            halo_width(A), mesh, WORLD), WORLD)
    for key, kw in (("host", dict(min_local_rows=128)),
                    ("unstructured", {}), ("unstructured_rs", {})):
        h, b, tol, maxiter = inp[key]
        hs = shard_hierarchy(h, mesh, **kw)
        res = []
        x = DeviceMultilevelSolver(hs).solve(b, tol=tol, maxiter=maxiter,
                                             accel="cg", residuals=res)
        out[key] = (np.asarray(res), x, hs.groups, hs.n_pads)
    h, b, tol, maxiter = inp["host"]
    hs = shard_hierarchy(h, mesh, min_local_rows=128)
    for key, kw in SHARDED_CYCLES.items():
        res = []
        x = DeviceMultilevelSolver(hs).solve(b, tol=tol, maxiter=maxiter,
                                             residuals=res, **kw)
        out[key] = (np.asarray(res), x)
    out["asprecond"] = DeviceMultilevelSolver(hs).aspreconditioner(
        "W") @ b
    for key in list(SHARDED_SMOOTHERS) + ["unstructured_chebyshev"]:
        h, b, tol, maxiter = inp[key]
        hs = shard_hierarchy(h, mesh, min_local_rows=128)
        res = []
        x = DeviceMultilevelSolver(hs).solve(b, tol=tol, maxiter=maxiter,
                                             accel="cg", residuals=res)
        out[key] = (np.asarray(res), x)
    for key in CROSS_SHARD_SMOOTHERS:
        h, b, tol, maxiter = inp[key]
        hs = shard_hierarchy(h, mesh, min_local_rows=128)
        res = []
        x = DeviceMultilevelSolver(hs).solve(b, tol=tol, maxiter=maxiter,
                                             accel="gmres", restart=10,
                                             residuals=res)
        out[key] = (np.asarray(res), x)
    d = torch.arange(1.0, 513.0, dtype=torch.float32)
    d_loc = shard_vector(mesh, d)
    ones = shard_vector(mesh, torch.ones(512))
    x, _, _ = device_cg(lambda v: d_loc * v, ones, torch.zeros_like(ones),
                        tol=1e-6, maxiter=50, M=lambda r: r / d_loc,
                        reduce=lambda s: mesh.sum_groups(s, WORLD))
    out["cg_diag"] = mesh.gather(x, WORLD)
    return out


def _spawn(tmp, inputs, body=_cases):
    """Run :func:`_rank_main` with ``body`` on WORLD ranks; returns each
    rank's results (fails the caller on an error or past the deadline)."""
    import torch.multiprocessing as mp

    inputs_path = str(tmp / "inputs.pt")
    torch.save(inputs, inputs_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(body, r, str(tmp / "rendezvous"), inputs_path,
                               str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
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
    """The inputs (numpy seeds), the port's one-rank references, and every
    rank's results.  Built single-threaded: beside the other test workers
    and the 8 ranks, intra-op threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _spmd(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _spmd(tmp_path_factory):
    A32 = poisson((32, 32), format="csr")
    dia64 = dia_from_scipy(A32, dtype=torch.float64, device="cpu",
                           row_pad=64)
    x64 = np.random.default_rng(0).random(dia64.n_pad)
    x64[A32.shape[0]:] = 0.0
    dia32 = dia_from_scipy(A32, dtype=torch.float32, device="cpu",
                           row_pad=128 * 8)
    x32 = np.random.default_rng(0).random(dia32.n_pad).astype(np.float32)

    A64 = poisson((64, 64), format="csr")
    ml = smoothed_aggregation_solver(A64, **CONFIG1)
    h = compile_hierarchy(ml, dtype=torch.float64, device="cpu", row_pad=64)
    b_host = np.random.default_rng(0).random(A64.shape[0])
    res_host = []
    x_host = DeviceMultilevelSolver(h).solve(b_host, tol=1e-10, maxiter=20,
                                             accel="cg", residuals=res_host)

    ref_cycles = {}
    for key, kw in SHARDED_CYCLES.items():
        res = []
        x = DeviceMultilevelSolver(h).solve(b_host, tol=1e-10, maxiter=20,
                                            residuals=res, **kw)
        ref_cycles[key] = (res, x)
    ref_cycles["asprecond"] = DeviceMultilevelSolver(h).aspreconditioner(
        "W") @ b_host

    smoothers, ref_smoothers = {}, {}
    ml_s = smoothed_aggregation_solver(A64, **CONFIG1)
    for key, spec in (list(SHARDED_SMOOTHERS.items())
                      + list(CROSS_SHARD_SMOOTHERS.items())):
        smoothers[key] = compile_hierarchy(change_smoothers(ml_s, spec, spec),
                                           dtype=torch.float64, device="cpu",
                                           row_pad=64)
    for key in SHARDED_SMOOTHERS:
        res = []
        x = DeviceMultilevelSolver(smoothers[key]).solve(
            b_host, tol=1e-10, maxiter=20, accel="cg", residuals=res)
        smoothers[key] = (smoothers[key], b_host, 1e-10, 20)
        ref_smoothers[key] = (res, x)
    for key in CROSS_SHARD_SMOOTHERS:
        res = []
        x = DeviceMultilevelSolver(smoothers[key]).solve(
            b_host, tol=1e-8, maxiter=12, accel="gmres", restart=10,
            residuals=res)
        smoothers[key] = (smoothers[key], b_host, 1e-8, 12)
        ref_smoothers[key] = (res, x)

    M = _fem(128)
    dus = device_unstructured_sa_setup(M, dtype=torch.float64, device="cpu",
                                       max_coarse=400)
    b_un = np.random.default_rng(3).random(M.shape[0])
    res_un = []
    x_un = dus.solve(b_un, tol=1e-10, maxiter=30, accel="cg",
                     residuals=res_un)

    dus_c = device_unstructured_sa_setup(M, dtype=torch.float64, device="cpu",
                                         max_coarse=400, presmoother=CHEB,
                                         postsmoother=CHEB)
    res = []
    x = dus_c.solve(b_un, tol=1e-10, maxiter=30, accel="cg", residuals=res)
    smoothers["unstructured_chebyshev"] = (dus_c.hierarchy, b_un, 1e-10, 30)
    ref_smoothers["unstructured_chebyshev"] = (res, x)

    drs = device_unstructured_rs_setup(M, dtype=torch.float64, device="cpu",
                                       max_coarse=400)
    assert isinstance(drs.hierarchy.levels[0].P, ComposedWindowed)
    b_rs = np.random.default_rng(5).random(M.shape[0])
    res_rs = []
    x_rs = drs.solve(b_rs, tol=1e-8, maxiter=40, accel="cg",
                     residuals=res_rs)

    inputs = {"dia64": (dia64, torch.as_tensor(x64)),
              "dia32": (dia32, torch.as_tensor(x32)),
              "host": (h, b_host, 1e-10, 20),
              "unstructured": (dus.hierarchy, b_un, 1e-10, 30),
              "unstructured_rs": (drs.hierarchy, b_rs, 1e-8, 40), **smoothers}
    ranks = _spawn(tmp_path_factory.mktemp("spmd"), inputs)
    return dict(A32=A32, x64=x64, x32=x32, dia32=dia32, ml=ml, A64=A64,
                b_host=b_host, res_host=res_host, x_host=x_host,
                ref_cycles=ref_cycles, ref_smoothers=ref_smoothers, M=M,
                res_un=res_un, x_un=x_un, res_rs=res_rs, x_rs=x_rs,
                ranks=ranks)


@pytest.fixture(scope="module")
def spmd_device_built(tmp_path_factory):
    """The device-built cases (:func:`_device_built_cases`), the port's
    one-rank solves of each, and every rank's sharded solves, from a spawn
    of their own (single-threaded, as :func:`spmd`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases = _device_built_cases()
        refs = {}
        for key, (_, b, _, solver, kw, _) in cases.items():
            res = []
            x = solver.solve(b, residuals=res, **kw)
            refs[key] = (np.asarray(res), x)
        ranks = _spawn(tmp_path_factory.mktemp("spmd_device_built"),
                       {key: (c[3], c[1], c[4], c[5])
                        for key, c in cases.items()},
                       _device_built_rank_cases)
        return dict(cases=cases, refs=refs, ranks=ranks)
    finally:
        torch.set_num_threads(threads)


def test_ranks_agree_and_initialize(spmd):
    """Every rank saw the world of 8 and returned the same results (the
    sharded solves run in lock-step on all-reduced scalars)."""
    r0 = spmd["ranks"][0]
    for r, out in enumerate(spmd["ranks"]):
        assert out["init"] == (r, WORLD, WORLD)
        np.testing.assert_array_equal(out["host"][0], r0["host"][0])
        np.testing.assert_array_equal(out["unstructured"][0],
                                      r0["unstructured"][0])


def test_halo_dia_spmv_matches_scipy(spmd):
    """Counterpart of test_parallel.py::test_halo_dia_spmv_matches_scipy:
    the port's make_halo_dia_spmv on 8 gloo ranks, f64, 32^2."""
    A, x = spmd["A32"], spmd["x64"]
    y = spmd["ranks"][0]["dia64"].numpy()[: A.shape[0]]
    np.testing.assert_allclose(y, A @ x[: A.shape[0]], atol=1e-12)


def test_halo_spmv_f32_equals_jax_ppermute_and_pallas(spmd):
    """Counterpart of test_parallel.py::test_pallas_halo_spmv_interpret:
    in f32 the port's halo SpMV on 8 ranks equals JAX's ppermute halo SpMV
    and its Pallas remote-DMA kernel (interpret mode) on the 8-device mesh
    bit for bit (the same products summed in the same offset order), and
    K16's wrapper (its plain twin on the CPU) equals the port's
    make_halo_dia_spmv."""
    import jax
    import jax.numpy as jnp

    from pyamg_tpu.parallel.dist_spmv import make_halo_dia_spmv
    from pyamg_tpu.parallel.pallas_halo import make_pallas_halo_spmv
    from pyamg_tpu.sparse import dia_from_scipy as jax_dia_from_scipy

    A, x = spmd["A32"], spmd["x32"]
    dia = jax_dia_from_scipy(A, dtype=jnp.float32, row_pad=128 * 8)
    mesh = jax.make_mesh((8,), ("x",),
                         axis_types=(jax.sharding.AxisType.Explicit,))
    spmv_i, place_i = make_pallas_halo_spmv(dia, mesh, interpret=True)
    y_interp = np.asarray(spmv_i(dia.data, place_i(x)))
    spmv_ref, place_ref = make_halo_dia_spmv(dia, mesh)
    y_ppermute = np.asarray(spmv_ref(dia.data, place_ref(x)))
    out = spmd["ranks"][0]
    y_port, y_k16 = out["dia32"].numpy(), out["dia32_k16"].numpy()
    assert y_port.dtype == np.float32
    np.testing.assert_array_equal(y_port, y_ppermute)
    np.testing.assert_array_equal(y_port, y_interp)
    np.testing.assert_array_equal(y_k16, y_port)


def test_halo_width_and_errors():
    """Counterpart of test_parallel.py::test_halo_width_and_errors: the
    same width as the JAX package's on the same operators, and the same
    ValueErrors (checked before any communication)."""
    import jax.numpy as jnp

    from pyamg_tpu.parallel import halo_width as jax_halo_width
    from pyamg_tpu.sparse import dia_from_scipy as jax_dia_from_scipy
    from pyamg_tpu_torch.parallel import halo_width, make_halo_dia_spmv
    from pyamg_tpu_torch.parallel.partition import SolverMesh

    A = poisson((16, 16), format="csr")
    dia = dia_from_scipy(A, device="cpu", row_pad=8)
    assert halo_width(dia) == jax_halo_width(
        jax_dia_from_scipy(A, dtype=jnp.float32, row_pad=8)) == 16
    mesh = SolverMesh(rank=0, world=8, device=torch.device("cpu"))
    make_halo_dia_spmv(dia, mesh)          # 256 rows / 8 = 32 >= halo 16
    dia_bad = dia_from_scipy(A, device="cpu", row_pad=7)
    assert dia_bad.n_pad % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        make_halo_dia_spmv(dia_bad, mesh)
    with pytest.raises(ValueError, match="exceeds local block"):
        make_halo_dia_spmv(dia_from_scipy(poisson((8, 8), format="csr"),
                                          device="cpu", row_pad=64),
                           SolverMesh(rank=0, world=16,
                                      device=torch.device("cpu")))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k16_ring_of_one_and_shards_equal_dia_spmv(dtype):
    """K16's ring of one (halos = x's own tail and head) and its P = 4
    in-process shards (halos copied from the neighbouring blocks) equal
    the rolled-DIA SpMV bit for bit on the CPU (its twin): a wrapped slot
    stores zero, so its term adds exactly 0."""
    from pyamg_tpu_torch.parallel import halo_width
    from pyamg_tpu_torch.parallel.halo_spmv import halo_spmv, halo_spmv_shards
    from pyamg_tpu_torch.parallel.partition import SolverMesh

    A = dia_from_scipy(poisson((40, 48), format="csr"), dtype=dtype,
                       device="cpu", row_pad=64)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(A.n_pad),
                        dtype=dtype)
    want = dia_spmv_ref(A, x)
    one = SolverMesh(rank=0, world=1, device=torch.device("cpu"))
    ring = halo_spmv(A.data, A.offsets, A.offsets_t, x, halo_width(A), one,
                     1)
    assert torch.equal(ring, want)
    assert torch.equal(halo_spmv_shards(A, x, 4), want)
    with pytest.raises(ValueError):
        halo_spmv_shards(A, x, 7)


def test_level_groups_and_sharded_host_solve(spmd):
    """Counterpart of test_parallel.py::test_coarse_level_agglomeration:
    the group-count policy, each level's count equal to JAX's on the same
    n_pad (a mid level on a subset), and the sharded f64 CG on 8 ranks
    against the port's one-rank solve (same length, rtol 1e-10), against
    JAX's sharded solve on 8 devices (rtol 1e-9), solution within 1e-10."""
    import jax.numpy as jnp

    from pyamg_tpu.aggregation import smoothed_aggregation_solver as jax_sa
    from pyamg_tpu.engine import DeviceMultilevelSolver as JaxSolver
    from pyamg_tpu.engine import compile_hierarchy as jax_compile
    from pyamg_tpu.parallel import make_solver_mesh, shard_hierarchy
    from pyamg_tpu.parallel.partition import _level_groups as jax_groups
    from pyamg_tpu_torch.parallel.partition import _level_groups

    for args, k in (((65536, 8, 2048), 8), ((7304, 8, 2048), 2),
                    ((841, 8, 2048), 1), ((8192, 8, 2048), 4)):
        assert _level_groups(*args) == jax_groups(*args) == k
    res, x, groups, n_pads = spmd["ranks"][0]["host"]
    assert groups == tuple(jax_groups(n, WORLD, 128) for n in n_pads)
    assert groups[0] == WORLD and 1 < groups[1] < WORLD
    assert len(res) == len(spmd["res_host"])
    np.testing.assert_allclose(res, spmd["res_host"], rtol=1e-10)
    np.testing.assert_allclose(x, spmd["x_host"], atol=1e-10)

    ml = jax_sa(spmd["A64"], **CONFIG1)
    hier = shard_hierarchy(jax_compile(ml, dtype=jnp.float64, row_pad=64),
                           make_solver_mesh(8), min_local_rows=128)
    assert tuple(lvl.n_pad for lvl in hier.levels) == n_pads
    res_jax = []
    JaxSolver(hier).solve(spmd["b_host"], tol=1e-10, maxiter=20, accel="cg",
                          residuals=res_jax)
    assert len(res) == len(res_jax)
    np.testing.assert_allclose(res, res_jax, rtol=1e-9)


@pytest.mark.parametrize("key", list(SHARDED_CYCLES))
def test_sharded_cycles_and_krylov(spmd, key):
    """BiCGStab with the W-cycle, and GMRES (restart 5) with the AMLI
    cycle, on the host-built hierarchy sharded over 8 ranks: the one-rank
    solve's count, its history to rtol 1e-10 (GMRES's entries far below
    the first, where the sums' other order shows, to 1e-14 of the first)
    and its solution within 1e-10."""
    res, x = spmd["ranks"][0][key]
    res1, x1 = spmd["ref_cycles"][key]
    assert len(res) == len(res1) > 3
    np.testing.assert_allclose(res, res1, rtol=1e-10, atol=1e-14 * res1[0])
    np.testing.assert_allclose(x, x1, atol=1e-10)
    for out in spmd["ranks"][1:]:
        np.testing.assert_array_equal(out[key][0], res)


@pytest.mark.parametrize("key", list(SHARDED_SMOOTHERS)
                         + ["unstructured_chebyshev"])
def test_sharded_smoothers(spmd, key):
    """Multicolour Gauss-Seidel and Chebyshev (host-built), and the
    unstructured setup's Chebyshev with its coefficient stack on the
    device, on hierarchies sharded over 8 ranks: CG takes the one-rank
    solve's count, its history to rtol 1e-10 and its solution within
    1e-10; every rank holds the same history."""
    res, x = spmd["ranks"][0][key]
    res1, x1 = spmd["ref_smoothers"][key]
    assert len(res) == len(res1) > 3
    np.testing.assert_allclose(res, res1, rtol=1e-10, atol=1e-14 * res1[0])
    np.testing.assert_allclose(x, x1, atol=1e-10)
    for out in spmd["ranks"][1:]:
        np.testing.assert_array_equal(out[key][0], res)


@pytest.mark.parametrize("key", list(CROSS_SHARD_SMOOTHERS))
def test_sharded_cimmino_and_schwarz_solve(spmd, key):
    """The sweeps that once raised on a sharded hierarchy now shard: the
    Cimmino sweep (``gauss_seidel_nr``, compiled to ``jacobi_nr``: A^T of
    the sharded operator through each DIA level's transposed diagonals)
    and windowed Schwarz (a right halo of r in, each window chunk's spill
    out, through the ring) on the host-built hierarchy over 8 ranks:
    GMRES (restart 10) takes the one-rank solve's count, its history to
    rtol 1e-10 and its solution within 1e-10; every rank holds the same
    history."""
    res, x = spmd["ranks"][0][key]
    res1, x1 = spmd["ref_smoothers"][key]
    assert len(res) == len(res1) > 3
    np.testing.assert_allclose(res, res1, rtol=1e-10, atol=1e-14 * res1[0])
    np.testing.assert_allclose(x, x1, atol=1e-10)
    for out in spmd["ranks"][1:]:
        np.testing.assert_array_equal(out[key][0], res)


def test_sharded_aspreconditioner(spmd):
    """The W-cycle as a host LinearOperator on the sharded hierarchy:
    every rank stages the full vector, applies the cycle on its blocks and
    gathers the full result, the one-rank operator's to 1e-12."""
    want = spmd["ref_cycles"]["asprecond"]
    for out in spmd["ranks"]:
        got = out["asprecond"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_sharded_windowed_unstructured_solve(spmd):
    """Counterpart of test_parallel.py::test_sharded_windowed_unstructured_
    solve: the 128^2 P1 mesh + 1e-2 I hierarchy (max_coarse=400, f64)
    sharded over 8 ranks (windowed A and P row blocks, the transposes'
    partials summed over the ranks), its CG history against the one-rank
    solve's (same length, rtol 1e-9) and its solution's relative error
    below 1e-9; level 0 is split across the ranks."""
    res, x, groups, _ = spmd["ranks"][0]["unstructured"]
    n = spmd["M"].shape[0]
    assert groups[0] == WORLD
    assert len(res) == len(spmd["res_un"])
    np.testing.assert_allclose(res, spmd["res_un"], rtol=1e-9)
    rel = np.linalg.norm(x - spmd["x_un"]) / np.linalg.norm(spmd["x_un"])
    assert x.shape == (n,) and rel < 1e-9, rel


def test_sharded_unstructured_rs_solve(spmd):
    """Counterpart of test_parallel.py::test_sharded_unstructured_rs_solve:
    the modified-interpolation RS hierarchy of the 128^2 P1 mesh + 1e-2 I
    (max_coarse=400, f64; level 0's P composed of two windowed factors,
    each sharded, re-laid out between them) on 8 ranks: CG to 1e-8 with
    the one-rank solve's history (same length, rtol 1e-9) and its solution
    within 1e-9 relative; every rank holds the same history."""
    res, x, groups, _ = spmd["ranks"][0]["unstructured_rs"]
    assert groups[0] == WORLD
    assert len(res) == len(spmd["res_rs"]) > 3
    np.testing.assert_allclose(res, spmd["res_rs"], rtol=1e-9)
    assert res[-1] <= 1e-8 * res[0]
    rel = np.linalg.norm(x - spmd["x_rs"]) / np.linalg.norm(spmd["x_rs"])
    assert x.shape == (spmd["M"].shape[0],) and rel < 1e-9, rel
    for out in spmd["ranks"][1:]:
        np.testing.assert_array_equal(out["unstructured_rs"][0], res)


def _jax_history(case):
    """The JAX package's unsharded float64 solve of a device-built case."""
    import jax
    import jax.numpy as jnp

    from pyamg_tpu import engine as je

    A, b, (family, kw), _, solve_kw, _ = case
    jax.config.update("jax_enable_x64", True)
    setup = {"sa": je.device_sa_setup, "rs": je.device_rs_setup,
             "air": je.device_air_setup,
             "block": je.device_sa_setup_block}[family]
    res = []
    setup(A, dtype=jnp.float64, **kw).solve(b, residuals=res, **solve_kw)
    return np.asarray(res)


def _assert_sharded_device_built(db, key, groups0):
    """The sharded solve of ``key`` on rank 0 against the one-rank solve
    (same length, rtol 1e-9, x within 1e-10 relative), every rank's
    history equal to rank 0's, level 0 on ``groups0`` groups (or more than
    one); returns rank 0's history."""
    res, x, groups = db["ranks"][0][key]
    res1, x1 = db["refs"][key]
    assert groups[0] == groups0 if groups0 else groups[0] > 1, groups
    assert len(res) == len(res1) > 1
    np.testing.assert_allclose(res, res1, rtol=1e-9)
    rel = np.linalg.norm(x - x1) / np.linalg.norm(x1)
    assert x.shape == x1.shape and rel < 1e-10, rel
    for out in db["ranks"][1:]:
        np.testing.assert_array_equal(out[key][0], res)
    return res


def test_distributed_device_setup(spmd_device_built):
    """Counterpart of test_parallel.py::test_distributed_device_setup_gspmd
    (96^2 5-point, device_sa_setup(max_coarse=200), f64): the hierarchy
    sharded over 8 ranks (level 0 on all 8; S, S^T through K16, the
    remap T through K6 and T^T through K7) solves CG to 1e-10 with the
    unsharded history, and with the JAX package's to rtol 1e-8 (the
    device SA parity test's)."""
    res = _assert_sharded_device_built(spmd_device_built, "sa", WORLD)
    hj = _jax_history(spmd_device_built["cases"]["sa"])
    assert len(res) == len(hj)
    np.testing.assert_allclose(res, hj, rtol=1e-8)


def test_distributed_classical_setup(spmd_device_built):
    """Counterpart of test_parallel.py::
    test_distributed_classical_setup_gspmd (64^2, device_rs_setup(
    max_coarse=200), f64): the embedded P_emb / R_emb through K16, the
    embedding and its transpose (the compaction) through K6 / K7, on 8
    ranks; CG to 1e-10 with the unsharded history, and the JAX package's
    at the classical parity test's tolerance."""
    res = _assert_sharded_device_built(spmd_device_built, "rs", WORLD)
    hj = _jax_history(spmd_device_built["cases"]["rs"])
    assert len(res) == len(hj)
    np.testing.assert_allclose(res, hj, rtol=1e-10, atol=1e-13 * hj[0])


def test_distributed_block_setup(spmd_device_built):
    """Counterpart of test_parallel.py::test_distributed_block_setup_gspmd
    (linear_elasticity((24, 24)) on the (24, 23) node grid,
    device_sa_setup_block(max_coarse=120), f64): the block levels through
    B1's halo mode (its CPU twin here), the block Jacobi sweeps as the
    halo RESID and the local B2 ZERO, the candidates' remap through K6 /
    K7, on 8 ranks; CG to 1e-8 with the unsharded history, and the JAX
    package's to rtol 1e-8 (the block setup's parity tolerance)."""
    res = _assert_sharded_device_built(spmd_device_built, "block", WORLD)
    hj = _jax_history(spmd_device_built["cases"]["block"])
    assert len(res) == len(hj)
    np.testing.assert_allclose(res, hj, rtol=1e-8)


@pytest.mark.parametrize("key", ["air", "air_routed"])
def test_sharded_air_solves(spmd_device_built, key):
    """AIR sharded over 8 ranks, f64 FGMRES to 1e-10: the structured
    setup on 64^2 advection (embedded transfers, the masked F-then-C
    Jacobi by rows) and the routed unstructured one on the RCM-ordered
    40^2 (the Neumann restriction's A, Tinj and dinv_f by rows, level 0
    split over 2 groups); the unsharded history, and the JAX package's at
    the AIR parity tests' tolerances (structured rtol 1e-8, unstructured
    1e-6 with a floor of 1e-7 of the first entry)."""
    res = _assert_sharded_device_built(spmd_device_built, key,
                                       WORLD if key == "air" else 2)
    hj = _jax_history(spmd_device_built["cases"][key])
    assert len(res) == len(hj)
    np.testing.assert_allclose(
        res, hj, rtol=1e-8 if key == "air" else 1e-6,
        atol=(1e-12 if key == "air" else 1e-7) * hj[0])
    assert res[-1] <= 1e-10 * res[0]


def test_sharded_device_built_float32(spmd_device_built):
    """The 96^2 device-built SA hierarchy in float32 sharded over 8
    ranks: CG to 1e-5 in the unsharded count, its history within 1e-5
    (float32 sums in another order)."""
    res, x, groups = spmd_device_built["ranks"][0]["sa_f32"]
    res1, x1 = spmd_device_built["refs"]["sa_f32"]
    assert groups[0] == WORLD and len(res) == len(res1) > 3
    np.testing.assert_allclose(res, res1, rtol=1e-5)
    assert res[-1] <= 1e-5 * res[0]


def test_krylov_dots_partition(spmd):
    """Counterpart of test_parallel.py::test_krylov_dots_partition: CG on
    a diagonal system sharded over 8 ranks, its dots all-reduced, gives
    x = 1/d."""
    d = np.arange(1.0, 513.0)
    np.testing.assert_allclose(spmd["ranks"][0]["cg_diag"].numpy(), 1.0 / d,
                               atol=1e-5)


def test_initialize_distributed_single_process():
    """Counterpart of test_parallel.py::
    test_initialize_distributed_single_process: with no environment, a
    world of one (gloo on the CPU); a second call changes nothing; a mesh
    of the CPU device needs no card."""
    import torch.distributed as dist

    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh)

    was = dist.is_initialized()
    try:
        rank, world, ndev = initialize_distributed(device="cpu")
        assert rank == 0 and world >= 1 and ndev >= 1
        assert initialize_distributed(device="cpu") == (rank, world, ndev)
        mesh = make_solver_mesh(device="cpu")
        assert (mesh.rank, mesh.world) == (rank, world)
        with pytest.raises(ValueError):
            make_solver_mesh(n_devices=world + 1, device="cpu")
        if not torch.cuda.is_available():    # device=None means the card
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_solver_mesh()
    finally:
        if not was and dist.is_initialized():
            dist.destroy_process_group()


def _plan_transpose(W, r):
    """The transpose through the column plan, the order K7 and K13 sum in:
    each column's live entries in ascending entry order (scatter-add of
    the plan's terms up to ``colptr[m]``).  ``r`` is (n_pad,) or a K-major
    (K, n_pad) stack."""
    perm, colptr = W.column_plan
    m = W.m_chunks * W.w2
    e = perm[: int(colptr[m])].long()
    per_block = W.k * W.block
    rows = (e // per_block) * W.block + e % W.block
    terms = W.data.reshape(-1)[e] * r[..., rows]
    cols = torch.repeat_interleave(torch.arange(m),
                                   torch.diff(colptr.long()))
    y = torch.zeros(r.shape[:-1] + (m,), dtype=W.dtype)
    return y.index_add_(-1, cols, terms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transpose_plan_equals_twins(dtype):
    """The column plan K7 and K13 sum through (live entries sorted stably
    by column, each column in ascending entry order) reproduces the
    scatter-add twins bit for bit, one vector and a K-major stack."""
    rng = np.random.default_rng(4)
    n, m = 5000, 1300
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows * m // n + rng.integers(-40, 41, rows.size), 0,
                   m - 1)
    vals = rng.standard_normal(rows.size)
    vals[::7] = 0.0                              # stored zeros: not live
    P = sp.csr_matrix((vals, (rows, cols)), shape=(n, m))
    W = window.windowed_from_scipy(P, dtype=dtype, device="cpu")
    r = torch.as_tensor(rng.standard_normal(W.n_pad), dtype=dtype)
    R = torch.as_tensor(rng.standard_normal((5, W.n_pad)), dtype=dtype)
    assert torch.equal(_plan_transpose(W, r), window.windowed_rmatvec_ref(W, r))
    assert torch.equal(_plan_transpose(W, R),
                       window.windowed_rmatmat_k_ref(W, R))
    perm, colptr = W.column_plan
    live = int((W.data != 0).sum())
    assert perm.dtype == colptr.dtype == torch.int32
    assert colptr.shape == (W.m_chunks * W.w2 + 1,)
    assert perm.numel() == W.data.numel() and int(colptr[-1]) == live
    assert bool((W.data.reshape(-1)[perm[:live].long()] != 0).all())
