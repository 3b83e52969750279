"""The port's distributed paths (``pyamg_tpu_torch.parallel``) against the
JAX package's (``tests/test_parallel.py``), and the deterministic windowed
transposes' plan form against their twins.

The JAX side runs as ``tests/test_parallel.py`` runs it, on the 8 virtual
CPU devices of ``tests/conftest.py`` (K16 under the Pallas interpreter).
The port side runs SPMD on 8 gloo ranks: one module-scoped fixture spawns
them once (``torch.multiprocessing``, a ``file://`` rendezvous under the
test's temporary directory, each rank single-threaded, a 120 s deadline
after which the ranks are killed and the tests fail), every rank runs
every case in :func:`_rank_main` and saves its results, and the tests
compare.  Inputs come from numpy seeds; the spawned ranks import torch,
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

from pyamg_tpu_torch import (DeviceMultilevelSolver,  # noqa: E402
                             compile_hierarchy, device_unstructured_sa_setup,
                             gradgradform, poisson, regular_triangle_mesh,
                             smoothed_aggregation_solver)
from pyamg_tpu_torch.sparse import dia_from_scipy, window  # noqa: E402
from pyamg_tpu_torch.sparse.dia import dia_spmv_ref  # noqa: E402

WORLD = 8
DEADLINE_S = 120
CONFIG1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
               postsmoother=("jacobi", {"omega": 4.0 / 3.0}))


def _fem(nx):
    A = sp.csr_matrix(gradgradform(*regular_triangle_mesh(nx, nx)))
    return (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()


def _rank_main(rank, init_file, inputs_path, out_dir):
    """One gloo rank: every distributed case, results saved per rank."""
    import torch.distributed as dist

    from pyamg_tpu_torch.engine.krylov import device_cg
    from pyamg_tpu_torch.parallel import (halo_width, initialize_distributed,
                                          make_halo_dia_spmv,
                                          make_solver_mesh, shard_hierarchy,
                                          shard_vector)
    from pyamg_tpu_torch.parallel.halo_spmv import halo_spmv

    torch.set_num_threads(1)
    try:
        got = initialize_distributed(init_method=f"file://{init_file}",
                                     world_size=WORLD, rank=rank,
                                     device="cpu")
        mesh = make_solver_mesh(device="cpu")
        inp = torch.load(inputs_path, weights_only=False)
        out = {"init": got}
        for key in ("dia64", "dia32"):
            A, x = inp[key]
            spmv, place = make_halo_dia_spmv(A, mesh)
            out[key] = mesh.gather(spmv(A.data, place(x)), WORLD)
            out[key + "_k16"] = mesh.gather(halo_spmv(
                mesh.local(A.data, WORLD), A.offsets, A.offsets_t, place(x),
                halo_width(A), mesh, WORLD), WORLD)
        for key, kw in (("host", dict(min_local_rows=128)),
                        ("unstructured", {})):
            h, b, tol, maxiter = inp[key]
            hs = shard_hierarchy(h, mesh, **kw)
            res = []
            x = DeviceMultilevelSolver(hs).solve(b, tol=tol, maxiter=maxiter,
                                                 accel="cg", residuals=res)
            out[key] = (np.asarray(res), x, hs.groups, hs.n_pads)
        d = torch.arange(1.0, 513.0, dtype=torch.float32)
        d_loc = shard_vector(mesh, d)
        ones = shard_vector(mesh, torch.ones(512))
        x, _, _ = device_cg(lambda v: d_loc * v, ones, torch.zeros_like(ones),
                            tol=1e-6, maxiter=50, M=lambda r: r / d_loc,
                            reduce=lambda s: mesh.sum_groups(s, WORLD))
        out["cg_diag"] = mesh.gather(x, WORLD)
        dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(tmp, inputs):
    """Run :func:`_rank_main` on WORLD ranks; returns each rank's results
    (fails the caller on an error or past the deadline)."""
    import torch.multiprocessing as mp

    inputs_path = str(tmp / "inputs.pt")
    torch.save(inputs, inputs_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "rendezvous"), inputs_path,
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

    M = _fem(128)
    dus = device_unstructured_sa_setup(M, dtype=torch.float64, device="cpu",
                                       max_coarse=400)
    b_un = np.random.default_rng(3).random(M.shape[0])
    res_un = []
    x_un = dus.solve(b_un, tol=1e-10, maxiter=30, accel="cg",
                     residuals=res_un)

    inputs = {"dia64": (dia64, torch.as_tensor(x64)),
              "dia32": (dia32, torch.as_tensor(x32)),
              "host": (h, b_host, 1e-10, 20),
              "unstructured": (dus.hierarchy, b_un, 1e-10, 30)}
    ranks = _spawn(tmp_path_factory.mktemp("spmd"), inputs)
    return dict(A32=A32, x64=x64, x32=x32, dia32=dia32, ml=ml, A64=A64,
                b_host=b_host, res_host=res_host, x_host=x_host, M=M,
                res_un=res_un, x_un=x_un, ranks=ranks)


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
