"""The partitioned device SA setup (``device_sa_setup(A, grid, mesh=mesh)``,
``pyamg_tpu_torch/parallel/partitioned_setup.py``) on 8 gloo CPU ranks,
against the port's whole setup sharded by ``shard_hierarchy`` and the JAX
package's ``device_sa_setup`` (counterpart of ``tests/test_parallel.py::
test_distributed_device_setup_gspmd``).

One spawn of 8 ranks (its own fixture and deadline, apart from the other
parallel files' spawns) runs every case: each rank builds the partitioned
setup and saves its blocks of the level arrays (A, S and S^T's
diagonals, the remap T's rows, the smoothers' arrays, the dense coarsest
level, the coarse inverse) and its CG history.  While the ranks run, the
parent builds each case's whole setup, cuts each rank's blocks of it with
``shard_hierarchy`` over a mesh of that rank (which sends nothing) and
solves it, and computes the JAX references, one ``device_sa_setup`` a
grid.

- 96^2, float64, ``max_coarse=200`` (the reference test's case): level 0
  partitioned over 8 groups, the odd 33^2 level gathered;
- 192^2, float64: levels partitioned over 8, 4 and 2 groups, level 1's
  slabs uneven (22 aggregate rows of 3 grid rows over 4 groups);
- 192^2 float32, a tuple stride (3, 2) at 96^2 (levels on 8 and 4
  groups), Chebyshev smoothing at 48^2, and at 48^2 a candidate B (each
  rank takes its rows) with two improvement sweeps (through K16) and
  ``stride="auto"`` (its couplings summed over the ranks).

The partitioned setup's norms sum by rank (``all_reduce``), so its levels
equal the whole setup's to rounding (rtol 1e-12 in float64); in a world of
one they give the whole setup's bits.  In the 192^2 case a
``TorchDispatchMode`` on every rank records the largest dimension of any
tensor an operation makes while a partitioned level is built, which stays
within the rank's slab (or solve block) plus two halos of the products'
reach, below the level's rows.
"""
import os
import time
import traceback
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyamg_tpu_torch import (StructuredDeviceSolver,  # noqa: E402
                             device_sa_setup, poisson)
from pyamg_tpu_torch.parallel.partition import (SolverMesh,  # noqa: E402
                                                shard_hierarchy)

WORLD = 8
DEADLINE_S = 300
F64, F32 = torch.float64, torch.float32
# key -> (grid side, setup keywords, solve keywords)
CG10 = dict(tol=1e-10, maxiter=40, accel="cg")
CG6 = dict(tol=1e-6, maxiter=40, accel="cg")
CASES = {
    "96": (96, dict(dtype=F64, max_coarse=200), CG10),
    "192": (192, dict(dtype=F64), CG10),
    "192_f32": (192, dict(dtype=F32), dict(tol=1e-5, maxiter=40,
                                           accel="cg")),
    "chebyshev": (48, dict(dtype=F64, max_coarse=200,
                           presmoother=("chebyshev", {}),
                           postsmoother=("chebyshev", {})), CG6),
    "tuple_stride": (96, dict(dtype=F64, max_coarse=200, stride=(3, 2)),
                     CG6),
    "candidate_auto": (48, dict(dtype=F64, max_coarse=200, stride="auto",
                                B=np.linspace(1.0, 2.0, 48 * 48),
                                improve_candidates_iters=2), CG6),
}
# the cases the dispatch-mode guard watches, and those held to JAX
GUARDED = ("192",)
JAX_CASES = ("96", "192")


def _b(side):
    return np.random.default_rng(0).random(side * side)


def _level_arrays(h):
    """name -> (this rank's block as a numpy array, the groups it was cut
    over) of a sharded structured hierarchy."""
    out = {}

    def put(name, t, groups):
        out[name] = (t.detach().cpu().numpy(), groups)

    for i, lvl in enumerate(h.levels):
        A = lvl.A.factors[0]
        put(f"L{i}.A", A.data, A.groups)
        if lvl.P is not None:
            S, T = lvl.P.factors
            Tt, St = lvl.R.factors
            put(f"L{i}.S", S.data, S.groups)
            put(f"L{i}.St", St.data, St.groups)
            for tag, f in (("T", T), ("Tt", Tt)):
                W = f.local
                put(f"L{i}.{tag}.data", W.data, f.groups)
                put(f"L{i}.{tag}.idx", W.idx, f.groups)
                put(f"L{i}.{tag}.starts", W.starts, f.groups)
                put(f"L{i}.{tag}.meta", torch.tensor(
                    [W.w2, W.m_chunks, W.nnz, W.block, *W.shape]), f.groups)
        for side in ("pre", "post"):
            for j, a in enumerate(getattr(lvl, side).arrays):
                put(f"L{i}.{side}{j}", a, h.groups[i] if a.ndim else 1)
    put("coarse_inv", h.coarse_inv, 1)
    return out


class _Guard:
    """A TorchDispatchMode recording the largest dimension of any tensor
    an operation returns, by the phase it is set to."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        guard = self
        self.phase, self.seen = None, {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if guard.phase is not None:
                    for t in tree_leaves(out):
                        if isinstance(t, torch.Tensor) and t.dim():
                            guard.seen[guard.phase] = max(
                                guard.seen.get(guard.phase, 0), max(t.shape))
                return out

        self.mode = Mode()


def _watch(guard, checks):
    """Wrap the partitioned setup's level steps so that ``guard`` records
    each one: a level's build (``_partition_level``), the move of its
    coarse rows onto the next level's slabs (``_next_slabs``) and the
    host rows of level 0 (``_HostOperator.padded_rows``); ``checks`` gets
    a dict per step: its phase, the largest dimension made, the bound
    (this rank's slab or solve block, whichever is longer, plus two
    halos of the products' reach), the level's rows and slabs.  Returns
    the undo."""
    from pyamg_tpu_torch.parallel import partitioned_setup as ps

    level, nxt, host = (ps._partition_level, ps._next_slabs,
                        ps._HostOperator.padded_rows)

    def record(phase, st, i, offsets):
        lv = st.level(i)
        r0, r1 = lv.slabs.mine(st.mesh)
        s0, s1 = lv.solve.mine(st.mesh)
        checks.append(dict(phase=phase, seen=guard.seen.get(phase, 0),
                           bound=max(r1 - r0, s1 - s0)
                           + 2 * lv.reach(offsets),
                           n=lv.n, slabs=lv.slabs.ranges))

    def run(phase, fn, *args):
        guard.phase = phase
        try:
            return fn(*args)
        finally:
            guard.phase = None

    def watched_level(st, i, A, Bv):
        out = run(("level", i), level, st, i, A, Bv)
        record(("level", i), st, i, A.offsets)
        return out

    def watched_next(st, i, A_c, Bc):
        out = run(("next", i + 1), nxt, st, i, A_c, Bc)
        record(("next", i + 1), st, i + 1, out[0].offsets)
        return out

    def watched_host(self, grid_p, g0, g1, dtype, device):
        return run(("host", 0), host, self, grid_p, g0, g1, dtype, device)

    ps._partition_level, ps._next_slabs = watched_level, watched_next
    ps._HostOperator.padded_rows = watched_host

    def undo():
        ps._partition_level, ps._next_slabs = level, nxt
        ps._HostOperator.padded_rows = host
    return undo


def _rank_cases(mesh):
    """One rank's partitioned setup of every case and its CG history."""
    out = {}
    for key, (side, kw, solve_kw) in CASES.items():
        grid = (side, side)
        A = poisson(grid, format="csr")
        guard, checks = _Guard(), []
        undo = _watch(guard, checks)
        try:
            if key in GUARDED:
                with guard.mode:
                    part = device_sa_setup(A, grid=grid, device="cpu",
                                           mesh=mesh, **kw)
            else:
                part = device_sa_setup(A, grid=grid, device="cpu", mesh=mesh,
                                       **kw)
        finally:
            undo()
        res = []
        part.solve(_b(side), residuals=res, **solve_kw)
        out[key] = dict(part=_level_arrays(part.hierarchy),
                        groups=part.hierarchy.groups, hist=np.asarray(res),
                        checks=checks, host=guard.seen.get(("host", 0), 0))
    return out


def _whole_refs():
    """Per case: the whole setup's blocks for each rank (``shard_hierarchy``
    over a mesh of that rank, which cuts and sends nothing), its groups and
    its unsharded CG history."""
    refs = {}
    for key, (side, kw, solve_kw) in CASES.items():
        grid = (side, side)
        whole = device_sa_setup(poisson(grid, format="csr"), grid=grid,
                                device="cpu", **kw)
        sliced = [shard_hierarchy(whole.hierarchy, SolverMesh(
            rank=r, world=WORLD, device=torch.device("cpu")))
            for r in range(WORLD)]
        res = []
        whole.solve(_b(side), residuals=res, **solve_kw)
        refs[key] = dict(arrays=[_level_arrays(h) for h in sliced],
                         groups=sliced[0].groups, hist=np.asarray(res))
    return refs


def _rank_main(rank, init_file, out_dir):
    """One gloo rank: :func:`_rank_cases`'s results saved per rank."""
    import torch.distributed as dist

    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh)

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    try:
        initialize_distributed(init_method=f"file://{init_file}",
                               world_size=WORLD, rank=rank, device="cpu")
        out = _rank_cases(make_solver_mesh(device="cpu"))
        dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _jax_refs():
    """Per JAX case: the JAX package's level arrays (whole) and CG
    history."""
    import jax
    import jax.numpy as jnp

    from pyamg_tpu.engine import device_sa_setup as jax_setup

    jax.config.update("jax_enable_x64", True)
    refs = {}
    for key in JAX_CASES:
        side, kw, solve_kw = CASES[key]
        kw = {k: v for k, v in kw.items() if k != "dtype"}
        A = poisson((side, side), format="csr")
        d = jax_setup(A, grid=(side, side), dtype=jnp.float64, **kw)
        arrays = {}
        for i, lvl in enumerate(d.hierarchy.levels):
            arrays[f"L{i}.A"] = np.asarray(lvl.A.data)
            if lvl.P is not None:
                arrays[f"L{i}.S"] = np.asarray(lvl.P.S.data)
                arrays[f"L{i}.St"] = np.asarray(lvl.R.St.data)
                arrays[f"L{i}.tv"] = np.asarray(lvl.R.tv)
                for j, a in enumerate(lvl.pre.arrays):
                    arrays[f"L{i}.pre{j}"] = np.asarray(a)
        arrays["coarse_inv"] = np.asarray(d.hierarchy.coarse_inv)
        res = []
        d.solve(_b(side), residuals=res, **solve_kw)
        refs[key] = dict(arrays=arrays, hist=np.asarray(res))
    return refs


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """Every rank's results, and the whole setup's and the JAX references
    (computed while the ranks run, single-threaded: beside the ranks and
    the other test workers, intra-op threads oversubscribe the cores)."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("partitioned_setup")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "rendezvous"), str(tmp)))
             for r in range(WORLD)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                refs = dict(whole=_whole_refs(), jax=_jax_refs())
        finally:
            torch.set_num_threads(threads)
    finally:
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
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, **refs)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(initial=0),
                                               1e-300))


def _jax_block(a, groups, rank):
    """Rank ``rank``'s block of a whole JAX array (last axis, or rows of a
    2-D dense level) cut over ``groups`` groups."""
    if a.ndim == 0 or groups == 1:
        return a
    s = rank // (WORLD // groups)
    m = a.shape[-1] // groups
    return a[..., s * m:(s + 1) * m]


def test_ranks_partition_levels(spmd):
    """The levels' groups are ``shard_hierarchy``'s: 96^2 (8, 1, 1), level
    0 built on slabs and the odd 33^2 level gathered; 192^2 (8, 4, 2, 1),
    three levels on slabs, level 1's uneven (6, 6, 5, 5 aggregate rows of
    3 grid rows of 66); a tuple stride's two levels on 8 and 4 groups."""
    want = {"96": ((8, 1, 1), 1), "192": ((8, 4, 2, 1), 3),
            "tuple_stride": ((8, 4, 1, 1), 2)}
    for out in spmd["ranks"]:
        for key, (groups, built) in want.items():
            got = out[key]
            assert got["groups"] == spmd["whole"][key]["groups"] == groups
            levels = [c for c in got["checks"] if c["phase"][0] == "level"]
            assert len(levels) == built, (key, levels)
        lv1 = next(c for c in out["192"]["checks"]
                   if c["phase"] == ("level", 1))
        assert [b - a for a, b in lv1["slabs"]] == [1188, 1188, 990, 990]


@pytest.mark.parametrize("key", list(CASES))
def test_partitioned_levels_match_whole_setup(spmd, key):
    """Every rank's block of every level (A, S, S^T, the remap T and its
    transpose's rows with their w2, chunk count and nnz, the smoothers'
    arrays, the dense coarsest level, the coarse inverse) equals the same
    rank's block of the whole setup sharded by ``shard_hierarchy``: index
    arrays exactly, values to rtol 1e-12 in float64 (1e-5 in float32),
    the norms being summed by rank."""
    rtol = 1e-5 if CASES[key][1]["dtype"] == F32 else 1e-12
    for out, sliced in zip(spmd["ranks"], spmd["whole"][key]["arrays"]):
        part = out[key]["part"]
        assert list(part) == list(sliced)
        for name, (a, ga) in part.items():
            b, gb = sliced[name]
            assert ga == gb and a.shape == b.shape, (name, ga, gb)
            if np.issubdtype(b.dtype, np.floating):
                _close(a, b, rtol)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("key", JAX_CASES)
def test_partitioned_levels_match_jax(spmd, key):
    """Every rank's blocks of A, S, S^T, tv (the remap T's values), the
    Jacobi dinv and omega and the coarse inverse equal the same blocks of
    the JAX package's ``device_sa_setup`` of the grid, float64, to rtol
    1e-10."""
    ref = spmd["jax"][key]["arrays"]
    for rank, out in enumerate(spmd["ranks"]):
        part = out[key]["part"]
        for name, want in ref.items():
            src = name.replace(".tv", ".T.data")
            got, groups = part[src]
            want = _jax_block(want, groups, rank)
            _close(got.reshape(want.shape), want, 1e-10)


@pytest.mark.parametrize("key", JAX_CASES)
def test_partitioned_cg_matches_jax(spmd, key):
    """CG to 1e-10 on the partitioned hierarchy: the JAX package's count
    and its history to rtol 1e-9 (``test_distributed_device_setup_gspmd``'s
    bar), every rank the same history."""
    hist = spmd["ranks"][0][key]["hist"]
    ref = spmd["jax"][key]["hist"]
    assert len(hist) == len(ref) > 3
    np.testing.assert_allclose(hist, ref, rtol=1e-9)
    assert hist[-1] <= 1e-10 * hist[0]
    for out in spmd["ranks"][1:]:
        np.testing.assert_array_equal(out[key]["hist"], hist)


@pytest.mark.parametrize("key", ["192_f32", "chebyshev", "tuple_stride",
                                 "candidate_auto"])
def test_partitioned_cg_matches_whole_setup(spmd, key):
    """float32 192^2 CG to 1e-5; a (3, 2) stride at 96^2, Chebyshev
    smoothing and an improved candidate with ``stride="auto"`` at 48^2,
    CG to 1e-6: the
    count of the whole setup's solve and its
    history to rtol 1e-9, or 1e-3 in float32 (there a change of 1e-7 in
    rho alone moves the whole setup's own history by 3e-4: the 12
    iterations amplify the hierarchy's rounding, which the partitioned
    norms change)."""
    hist = spmd["ranks"][0][key]["hist"]
    whole = spmd["whole"][key]["hist"]
    rtol = 1e-3 if key == "192_f32" else 1e-9
    assert len(hist) == len(whole) > 3
    np.testing.assert_allclose(hist, whole, rtol=rtol)
    assert hist[-1] <= CASES[key][2]["tol"] * hist[0]


@pytest.mark.parametrize("key", GUARDED)
def test_setup_is_partitioned(spmd, key):
    """Under a TorchDispatchMode, no operation of a partitioned level's
    build, of the move onto the next level's slabs or of level 0's host
    rows makes a tensor with a dimension past the rank's slab (or solve
    block) plus two halos of the products' reach, and that bound is below
    the level's rows: no rank holds a whole partitioned level."""
    for out in spmd["ranks"]:
        checks = out[key]["checks"]
        assert checks
        for c in checks:
            assert 0 < c["seen"] <= c["bound"] < c["n"], c
        level0 = next(c for c in checks if c["phase"] == ("level", 0))
        assert 0 < out[key]["host"] <= level0["bound"]


@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_world_of_one_gives_whole_setup_bits(dtype, monkeypatch):
    """In a world of one (no process group: nothing is sent) the
    partitioned 192^2 setup builds its three large levels as rings of one
    and gives the whole setup's bits: every array of every level, rho,
    and the CG history.  Single-threaded, as the fixture's work: beside
    the other test workers, intra-op threads oversubscribe the cores."""
    from pyamg_tpu_torch.parallel import partitioned_setup as ps

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _world_of_one(dtype, monkeypatch, ps)
    finally:
        torch.set_num_threads(threads)


def _world_of_one(dtype, monkeypatch, ps):
    """The body of :func:`test_world_of_one_gives_whole_setup_bits`."""
    built = []
    level = ps._partition_level
    monkeypatch.setattr(ps, "_partition_level",
                        lambda st, i, *a: built.append(i) or level(st, i, *a))
    mesh = SolverMesh(rank=0, world=1, device=torch.device("cpu"))
    grid = (192, 192)
    A = poisson(grid, format="csr")
    kw = dict(grid=grid, dtype=dtype, device="cpu")
    whole = device_sa_setup(A, **kw)
    sliced = StructuredDeviceSolver(shard_hierarchy(whole.hierarchy, mesh),
                                    whole.grid, whole.grid_p,
                                    whole.setup_info)
    part = device_sa_setup(A, mesh=mesh, **kw)
    assert built == [0, 1, 2]
    got, want = _level_arrays(part.hierarchy), _level_arrays(
        sliced.hierarchy)
    assert list(got) == list(want)
    for name, (a, _) in got.items():
        assert a.dtype == want[name][0].dtype
        np.testing.assert_array_equal(a, want[name][0], err_msg=name)
    for li, lw in zip(part.setup_info["levels"], whole.setup_info["levels"]):
        assert torch.equal(li["rho_D_inv_A"], lw["rho_D_inv_A"])
    hists = []
    for s in (part, sliced):
        res = []
        s.solve(_b(192), residuals=res, tol=1e-5, maxiter=40, accel="cg")
        hists.append(res)
    assert hists[0] == hists[1]


@pytest.mark.parametrize("option", ["lane_align", "mixed_precision"])
def test_partitioned_setup_raises_for_unsharded_options(option):
    """``lane_align`` and ``mixed_precision`` raise ValueError naming
    ROADMAP Queue 1 item 14: a sharded hierarchy never takes the
    interleaved route and carries no float64 A64."""
    mesh = SolverMesh(rank=0, world=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="Queue 1 item 14"):
        device_sa_setup(poisson((48, 48), format="csr"), grid=(48, 48),
                        device="cpu", mesh=mesh, **{option: True})
