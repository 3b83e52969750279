"""The partitioned classical (Ruge-Stüben) and block device setups
(``device_rs_setup(A, grid, mesh=mesh)``, ``pyamg_tpu_torch/parallel/
partitioned_classical.py``; ``device_sa_setup_block(A, grid, B,
mesh=mesh)``, ``parallel/partitioned_block.py``) on 8 gloo CPU ranks,
against the port's whole setups sharded by ``shard_hierarchy`` and the
JAX package's setups brought across (counterparts of ``tests/
test_parallel.py::test_distributed_classical_setup_gspmd`` and
``test_distributed_block_setup_gspmd``).

One spawn of 8 ranks (its own fixture and deadline) runs every case: each
rank builds the partitioned setup and saves its blocks of the level
arrays (A and the transfers' DIA or block-DIA factors, the grid remaps'
rows, the smoothers' arrays, the dense coarsest level, the coarse
inverse) and its CG history.  While the ranks run, the parent builds each
case's whole setup and cuts each rank's blocks of it with
``shard_hierarchy`` over a mesh of that rank (which sends nothing), and
computes the RS JAX references; one more spawned process computes the
block one (the JAX setups' compiles are most of this file's time).  The
JAX hierarchies come across with ``convert.py``'s
``structured_solver_from_jax`` / ``block_solver_from_jax`` and are cut
the same way.

- ``rs64``: 64^2 Poisson, ``max_coarse=200``, float64 (the reference
  test's case): levels on 8 and 4 groups partitioned, 16^2 gathered;
- ``rs_c3``: config 3's anisotropic stencil (epsilon 1e-3) at 196^2,
  ``stride="auto"``, float64: four levels of strides (1, 2), whose slabs
  cut at single grid rows, 196 of them over 8 groups (25, 25, 25, 25,
  24, 24, 24, 24; at 192^2 every level's slabs are even), two of (2, 2),
  every level partitioned;
- ``rs64_f32``: 64^2 Poisson in float32, CG to 1e-5;
- ``block24``: ``linear_elasticity((24, 24))`` on the node grid (24,
  23), ``max_coarse=120``, float64 (the reference test's case): level 0
  on 4 groups;
- ``block48``: (48, 48) on (48, 47), float64: levels on 8 and 2 groups.

The norms sum by rank (``all_reduce``), so the levels equal the whole
setups' to rounding (rtol 1e-12 in float64); in a world of one (the
parent's tests) they are the whole setups' bits.  A ``TorchDispatchMode``
on every rank records the largest dimension of any tensor an operation
makes while a partitioned level is built (``rs64``, ``block48``): it
stays within the rank's slab (or solve block) plus two halos of the
products' reach, below the level's rows.
"""
import os
import time
import traceback
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyamg_tpu_torch import (BlockStructuredDeviceSolver,  # noqa: E402
                             StructuredDeviceSolver, device_air_setup,
                             device_rs_setup, device_sa_setup_block,
                             diffusion_stencil_2d, linear_elasticity, poisson,
                             stencil_grid)
from pyamg_tpu_torch.parallel.partition import (SolverMesh,  # noqa: E402
                                                shard_hierarchy)

WORLD = 8
DEADLINE_S = 300
F64, F32 = torch.float64, torch.float32
CG10 = dict(tol=1e-10, maxiter=40, accel="cg")
CG8 = dict(tol=1e-8, maxiter=60, accel="cg")
C3 = 196
# key -> (route, problem, setup keywords, solve keywords)
CASES = {
    "rs64": ("rs", 64, dict(dtype=F64, max_coarse=200), CG10),
    "rs_c3": ("rs", C3, dict(dtype=F64, stride="auto"), CG8),
    "rs64_f32": ("rs", 64, dict(dtype=F32, max_coarse=200),
                 dict(tol=1e-5, maxiter=40, accel="cg")),
    "block24": ("block", 24, dict(dtype=F64, max_coarse=120), CG8),
    "block48": ("block", 48, dict(dtype=F64, max_coarse=120), CG8),
}
# the cases the dispatch-mode guard watches, those whose levels are held
# to the JAX package's, and those whose CG histories are
GUARDED = ("rs64", "block48")
JAX_LEVELS = ("rs64", "rs_c3", "block24")
JAX_CG = ("rs64", "block24")
# the block parity tests' history tolerance (tests/test_torch_block_setup.py)
BLOCK_HIST_RTOL = 1e-8


def _problem(route, side):
    """(A, grid, B) of a case; B None for RS."""
    if route == "block":
        A, B = linear_elasticity((side, side))
        return A, (side, side - 1), B
    if side == 64:
        return poisson((64, 64), format="csr"), (64, 64), None
    return stencil_grid(diffusion_stencil_2d(epsilon=1e-3, theta=0.0,
                                             type="FD"),
                        (side, side)).tocsr(), (side, side), None


def _setup(route, A, grid, B, **kw):
    if route == "block":
        return device_sa_setup_block(A, grid=grid, B=B, device="cpu", **kw)
    return device_rs_setup(A, grid=grid, device="cpu", **kw)


def _b(n):
    return np.random.default_rng(0).random(n)


def _level_arrays(h):
    """name -> (this rank's block as a numpy array, the groups it was cut
    over) of a sharded structured or block hierarchy: every factor of A,
    P and R (a DIA or block-DIA factor's diagonals; a grid remap's rows,
    with its w2, chunk count, nnz, block and shape), the smoothers'
    arrays, the coarse inverse."""
    out = {}

    def put(name, t, groups):
        out[name] = (t.detach().cpu().numpy(), groups)

    for i, lvl in enumerate(h.levels):
        put(f"L{i}.A", lvl.A.factors[0].data, lvl.A.factors[0].groups)
        if lvl.P is not None:
            for tag, f in zip(("P0", "P1", "R0", "R1"),
                              lvl.P.factors + lvl.R.factors):
                W = getattr(f, "local", None)
                if W is None:
                    put(f"L{i}.{tag}", f.data, f.groups)
                    continue
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
    an operation returns, by the phase it is set to (the partitioned SA
    setup's test's)."""

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
    """Wrap both partitioned setups' level steps so that ``guard`` records
    each one: a level's build (``_rs_level``, ``_block_level``), the move
    of its coarse rows onto the next level's slabs and the host rows of
    level 0; ``checks`` gets a dict per step: its phase, the largest
    dimension made, the bound (this rank's slab or solve block, whichever
    is longer, plus two halos of the products' reach; in a block level's
    scalar rows, bs a node), the level's rows and slabs.  Returns the
    undo."""
    from pyamg_tpu_torch.parallel import partitioned_block as pb
    from pyamg_tpu_torch.parallel import partitioned_classical as pc
    from pyamg_tpu_torch.parallel import partitioned_setup as ps

    saved = [(pc, "_rs_level"), (pc, "_next_slabs"), (pb, "_block_level"),
             (pb, "_next_block_slabs"), (ps._HostOperator, "padded_rows"),
             (pb._HostBlockOperator, "padded_rows")]
    originals = [getattr(o, name) for o, name in saved]

    def record(phase, st, i, offsets, bs):
        lv = st.level(i)
        r0, r1 = lv.slabs.mine(st.mesh)
        s0, s1 = lv.solve.mine(st.mesh)
        checks.append(dict(phase=phase, seen=guard.seen.get(phase, 0),
                           bound=(max(r1 - r0, s1 - s0)
                                  + 2 * lv.reach(offsets)) * bs,
                           n=lv.n * bs, slabs=lv.slabs.ranges))

    def run(phase, fn, *args):
        guard.phase = phase
        try:
            return fn(*args)
        finally:
            guard.phase = None

    def level(fn, bs_of):
        def watched(st, i, A, *rest):
            out = run(("level", i), fn, st, i, A, *rest)
            record(("level", i), st, i, A.offsets, bs_of(st, i, A))
            return out
        return watched

    def nxt(fn, bs_of):
        def watched(st, i, *rest):
            out = run(("next", i + 1), fn, st, i, *rest)
            record(("next", i + 1), st, i + 1, out[0].offsets,
                   bs_of(st, i + 1, out[0]))
            return out
        return watched

    def host(fn):
        def watched(self, *args):
            return run(("host", 0), fn, self, *args)
        return watched

    def scalar(st, i, A):
        return 1

    def block(st, i, A):
        return A.bs

    wrapped = [level(originals[0], scalar), nxt(originals[1], scalar),
               level(originals[2], block), nxt(originals[3], block),
               host(originals[4]), host(originals[5])]
    for (o, name), w in zip(saved, wrapped):
        setattr(o, name, w)

    def undo():
        for (o, name), f in zip(saved, originals):
            setattr(o, name, f)
    return undo


def _rank_cases(mesh):
    """One rank's partitioned setup of every case and its CG history."""
    out = {}
    for key, (route, side, kw, solve_kw) in CASES.items():
        A, grid, B = _problem(route, side)
        guard, checks = _Guard(), []
        undo = _watch(guard, checks)
        try:
            if key in GUARDED:
                with guard.mode:
                    part = _setup(route, A, grid, B, mesh=mesh, **kw)
            else:
                part = _setup(route, A, grid, B, mesh=mesh, **kw)
        finally:
            undo()
        res = []
        part.solve(_b(A.shape[0]), residuals=res, **solve_kw)
        out[key] = dict(part=_level_arrays(part.hierarchy),
                        groups=part.hierarchy.groups, hist=np.asarray(res),
                        checks=checks, host=guard.seen.get(("host", 0), 0))
    return out


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


def _sliced(solver):
    """Every rank's arrays of a whole hierarchy cut by ``shard_hierarchy``
    over a mesh of that rank (which sends nothing), and its groups."""
    sliced = [shard_hierarchy(solver.hierarchy, SolverMesh(
        rank=r, world=WORLD, device=torch.device("cpu")))
        for r in range(WORLD)]
    return [_level_arrays(h) for h in sliced], sliced[0].groups


def _whole_refs():
    """Per case: the whole setup's blocks for each rank, its groups and
    its unsharded CG history."""
    refs = {}
    for key, (route, side, kw, solve_kw) in CASES.items():
        A, grid, B = _problem(route, side)
        whole = _setup(route, A, grid, B, **kw)
        arrays, groups = _sliced(whole)
        res = []
        whole.solve(_b(A.shape[0]), residuals=res, **solve_kw)
        refs[key] = dict(arrays=arrays, groups=groups, hist=np.asarray(res))
    return refs


def _jax_refs(route):
    """Per JAX case of ``route``: the JAX setup's hierarchy brought across
    and cut for each rank, and (in ``JAX_CG``) its CG history."""
    import jax
    import jax.numpy as jnp

    from pyamg_tpu import gallery as jgal
    from pyamg_tpu.engine import device_rs_setup as jax_rs
    from pyamg_tpu.engine import device_sa_setup_block as jax_block
    from pyamg_tpu_torch.convert import (block_solver_from_jax,
                                         structured_solver_from_jax)

    jax.config.update("jax_enable_x64", True)
    refs = {}
    for key in JAX_LEVELS:
        r, side, kw, solve_kw = CASES[key]
        if r != route:
            continue
        kw = {k: v for k, v in kw.items() if k != "dtype"}
        if route == "block":
            A, B = jgal.linear_elasticity((side, side))
            d = jax_block(A, grid=(side, side - 1), B=B, dtype=jnp.float64,
                          **kw)
            carried = block_solver_from_jax(d, "cpu")
        else:
            A = (jgal.poisson((64, 64), format="csr") if side == 64
                 else jgal.stencil_grid(jgal.diffusion_stencil_2d(
                     epsilon=1e-3, theta=0.0, type="FD"),
                     (side, side)).tocsr())
            d = jax_rs(A, grid=(side, side), dtype=jnp.float64, **kw)
            carried = structured_solver_from_jax(d, "cpu")
        arrays, groups = _sliced(carried)
        res = []
        if key in JAX_CG:
            d.solve(_b(A.shape[0]), residuals=res, **solve_kw)
        refs[key] = dict(arrays=arrays, groups=groups, hist=np.asarray(res))
    return refs


def _jax_block_main(out_dir):
    """The spawned process of the block JAX reference (its platform set
    before any backend starts, as ``conftest.py`` sets the parent's)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    try:
        torch.save(_jax_refs("block"), os.path.join(out_dir, "jax_block.pt"))
    except BaseException:
        with open(os.path.join(out_dir, "jax_block.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """Every rank's results, the whole setups' and the JAX references
    (computed while the ranks run, single-threaded: beside the ranks and
    the other test workers, intra-op threads oversubscribe the cores)."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("partitioned_rs_block")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "rendezvous"), str(tmp)))
             for r in range(WORLD)]
    procs.append(ctx.Process(target=_jax_block_main, args=(str(tmp),)))
    t0 = time.monotonic()
    for p in procs:
        p.start()
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                refs = dict(whole=_whole_refs(), jax=_jax_refs("rs"))
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
    errors = [f.read_text() for f in sorted(tmp.glob("*.err"))]
    assert not hung, f"processes {hung} still running after {DEADLINE_S} s"
    assert not errors and all(p.exitcode == 0 for p in procs), \
        "\n".join(errors) or [p.exitcode for p in procs]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    refs["jax"].update(torch.load(tmp / "jax_block.pt", weights_only=False))
    return dict(ranks=ranks, **refs)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(initial=0),
                                               1e-300))


def _same_arrays(part, ref, rtol):
    """Every array of ``part`` equals ``ref``'s: the same names, groups
    and shapes, index arrays exactly, values to ``rtol``."""
    assert list(part) == list(ref)
    for name, (a, ga) in part.items():
        b, gb = ref[name]
        assert ga == gb and a.shape == b.shape, (name, ga, gb)
        if np.issubdtype(b.dtype, np.floating):
            _close(a, b, rtol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_ranks_partition_levels(spmd):
    """The levels' groups are ``shard_hierarchy``'s, and the large ones
    are built on slabs: RS 64^2 (8, 4, 1, 1), two levels; config 3 at
    196^2 (8, 8, 8, 8, 8, 2, 1), six levels, level 0's slabs single grid
    rows (strides (1, 2)), uneven (25, 25, 25, 25, 24, 24, 24, 24 rows of
    196); block (24, 23) (4, 1, 1), one level; block (48, 47) (8, 2,
    1), two levels, level 0 over 8 groups (2 aggregate rows of 3 node
    rows of 48 each)."""
    want = {"rs64": ((8, 4, 1, 1), 2),
            "rs_c3": ((8, 8, 8, 8, 8, 2, 1), 6),
            "rs64_f32": ((8, 4, 1, 1), 2),
            "block24": ((4, 1, 1), 1),
            "block48": ((8, 2, 1), 2)}
    for out in spmd["ranks"]:
        for key, (groups, built) in want.items():
            got = out[key]
            assert got["groups"] == spmd["whole"][key]["groups"] == groups
            levels = [c for c in got["checks"] if c["phase"][0] == "level"]
            assert len(levels) == built, (key, levels)
        lv0 = next(c for c in out["rs_c3"]["checks"]
                   if c["phase"] == ("level", 0))
        assert [(b - a) // C3 for a, b in lv0["slabs"]] == [25] * 4 + [24] * 4
        lv0 = next(c for c in out["block48"]["checks"]
                   if c["phase"] == ("level", 0))
        assert [b - a for a, b in lv0["slabs"]] == [6 * 48] * 8


@pytest.mark.parametrize("key", list(CASES))
def test_partitioned_levels_match_whole_setup(spmd, key):
    """Every rank's block of every level (A, the transfers' factors, the
    grid remaps' rows with their w2, chunk count and nnz, the smoothers'
    arrays, the dense coarsest level, the coarse inverse) equals the same
    rank's block of the whole setup sharded by ``shard_hierarchy``: index
    arrays exactly, values to rtol 1e-12 in float64 (1e-5 in float32),
    the norms being summed by rank."""
    rtol = 1e-5 if CASES[key][2]["dtype"] == F32 else 1e-12
    for out, sliced in zip(spmd["ranks"], spmd["whole"][key]["arrays"]):
        _same_arrays(out[key]["part"], sliced, rtol)


@pytest.mark.parametrize("key", JAX_LEVELS)
def test_partitioned_levels_match_jax(spmd, key):
    """Every rank's blocks of every level equal the same blocks of the
    JAX package's setup of the case (brought across by ``convert.py`` and
    cut by ``shard_hierarchy``), float64, to rtol 1e-10."""
    ref = spmd["jax"][key]
    assert ref["groups"] == spmd["ranks"][0][key]["groups"]
    for out, sliced in zip(spmd["ranks"], ref["arrays"]):
        _same_arrays(out[key]["part"], sliced, 1e-10)


@pytest.mark.parametrize("key", JAX_CG)
def test_partitioned_cg_matches_jax(spmd, key):
    """CG on the partitioned hierarchy: the JAX package's count and its
    history, to rtol 1e-9 for RS 64^2 (``test_distributed_classical_
    setup_gspmd``'s bar) and 1e-8 for the block (24, 23) case (the block
    parity tests'), every rank the same history."""
    hist = spmd["ranks"][0][key]["hist"]
    ref = spmd["jax"][key]["hist"]
    solve_kw = CASES[key][3]
    assert len(hist) == len(ref) > 3
    np.testing.assert_allclose(
        hist, ref, rtol=BLOCK_HIST_RTOL if CASES[key][0] == "block" else 1e-9)
    assert hist[-1] <= solve_kw["tol"] * hist[0]
    for out in spmd["ranks"][1:]:
        np.testing.assert_array_equal(out[key]["hist"], hist)


@pytest.mark.parametrize("key", ["rs_c3", "rs64_f32", "block48"])
def test_partitioned_cg_matches_whole_setup(spmd, key):
    """Config 3 at 196^2 (CG to 1e-8), 64^2 Poisson in float32 (CG to
    1e-5) and the block (48, 47) case (CG to 1e-8): the count of the
    whole setup's
    solve and its history to rtol 1e-9, or 1e-3 in float32 (the
    iterations amplify the hierarchy's rounding, which the partitioned
    norms change), every rank the same history."""
    hist = spmd["ranks"][0][key]["hist"]
    whole = spmd["whole"][key]["hist"]
    rtol = 1e-3 if CASES[key][2]["dtype"] == F32 else 1e-9
    assert len(hist) == len(whole) > 3
    np.testing.assert_allclose(hist, whole, rtol=rtol)
    assert hist[-1] <= CASES[key][3]["tol"] * hist[0]
    for out in spmd["ranks"][1:]:
        np.testing.assert_array_equal(out[key]["hist"], hist)


@pytest.mark.parametrize("key", GUARDED)
def test_setup_is_partitioned(spmd, key):
    """Under a TorchDispatchMode, no operation of a partitioned level's
    build or of the move onto the next level's slabs makes a tensor with
    a dimension past the rank's slab (or solve block) plus two halos of
    the products' reach (a block level's in scalar rows), and that bound
    is below the level's rows: no rank holds a whole partitioned level.
    Level 0's host rows stay within the bound (RS) or within the stored
    blocks of the rank's slab (block: the blocks and their places go to
    the device, which scatters them), below the whole level's."""
    route = CASES[key][0]
    for out in spmd["ranks"]:
        checks = out[key]["checks"]
        assert checks
        for c in checks:
            assert 0 < c["seen"] <= c["bound"] < c["n"], c
        level0 = next(c for c in checks if c["phase"] == ("level", 0))
        if route == "rs":
            assert 0 < out[key]["host"] <= level0["bound"]
        else:
            nd = 9        # elasticity's node stencil: 3 x 3 block diagonals
            a, b = level0["slabs"][0]
            assert 0 < out[key]["host"] <= nd * (b - a) < nd * level0["n"]


@pytest.mark.parametrize("route", ["rs", "block"])
@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_world_of_one_gives_whole_setup_bits(route, dtype, monkeypatch):
    """In a world of one (no process group: nothing is sent) the
    partitioned setup builds its large levels as rings of one and gives
    the whole setup's bits: every array of every level, rho, and the CG
    history (config 3 at 196^2 RS, six levels; elasticity (48, 47), two
    levels).  Single-threaded, as the fixture's work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _world_of_one(route, dtype, monkeypatch)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("route", ["rs", "block"])
def test_world_of_one_smoothers_give_whole_setup_bits(route, monkeypatch):
    """Chebyshev before and Richardson after, whose rho(A) the partitioned
    levels estimate through K16 (RS 64^2) or B1's halo mode (block (48,
    47)), in a world of one, float64: the whole setup's bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _world_of_one(route, F64, monkeypatch, side=64 if route == "rs"
                      else 48, presmoother=("chebyshev", {}),
                      postsmoother=("richardson", {}))
    finally:
        torch.set_num_threads(threads)


def _world_of_one(route, dtype, monkeypatch, side=None, **smoothers):
    """The body of :func:`test_world_of_one_gives_whole_setup_bits`."""
    from pyamg_tpu_torch.parallel import partitioned_block as pb
    from pyamg_tpu_torch.parallel import partitioned_classical as pc

    mod, name, side, rho, nbuilt = (
        (pc, "_rs_level", side or C3, "rho_D_inv_A", 2 if side else 6)
        if route == "rs" else (pb, "_block_level", side or 48, "rho", 2))
    built = []
    level = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda st, i, *a: built.append(i) or level(st, i, *a))
    mesh = SolverMesh(rank=0, world=1, device=torch.device("cpu"))
    A, grid, B = _problem(route, side)
    kw = dict(dtype=dtype, max_coarse=120) if route == "block" else dict(
        dtype=dtype, max_coarse=200 if side == 64 else 400)
    kw.update(smoothers)
    whole = _setup(route, A, grid, B, **kw)
    if route == "block":
        sliced = BlockStructuredDeviceSolver(
            shard_hierarchy(whole.hierarchy, mesh), whole.grid, whole.grid_p,
            whole.bs, whole.setup_info)
    else:
        sliced = StructuredDeviceSolver(
            shard_hierarchy(whole.hierarchy, mesh), whole.grid, whole.grid_p,
            whole.setup_info)
    part = _setup(route, A, grid, B, mesh=mesh, **kw)
    assert built == list(range(nbuilt))
    got, want = _level_arrays(part.hierarchy), _level_arrays(
        sliced.hierarchy)
    assert list(got) == list(want)
    for key, (a, _) in got.items():
        assert a.dtype == want[key][0].dtype
        np.testing.assert_array_equal(a, want[key][0], err_msg=key)
    for li, lw in zip(part.setup_info["levels"], whole.setup_info["levels"]):
        assert torch.equal(li[rho], lw[rho])
    hists = []
    for s in (part, sliced):
        res = []
        s.solve(_b(A.shape[0]), residuals=res, tol=1e-5, maxiter=60,
                accel="cg")
        hists.append(res)
    assert hists[0] == hists[1]


def _raising(case):
    mesh = SolverMesh(rank=0, world=1, device=torch.device("cpu"))
    if case == "rs_mixed":
        device_rs_setup(poisson((48, 48), format="csr"), grid=(48, 48),
                        device="cpu", mesh=mesh, mixed_precision=True)
    elif case == "block_mixed":
        A, B = linear_elasticity((24, 24))
        device_sa_setup_block(A, grid=(24, 23), B=B, device="cpu", mesh=mesh,
                              mixed_precision=True)
    elif case == "rs_unstructured":
        import scipy.sparse as sp

        R = sp.random(400, 400, density=0.02, random_state=0)
        device_rs_setup((R + R.T + 10 * sp.eye(400)).tocsr(), device="cpu",
                        mesh=mesh)
    else:
        A, _ = __import__("pyamg_tpu_torch").advection_2d((32, 32))
        device_air_setup(A, grid=(32, 32), device="cpu", mesh=mesh)


@pytest.mark.parametrize("case", ["rs_mixed", "block_mixed",
                                  "rs_unstructured", "air"])
def test_unpartitioned_routes_raise(case):
    """What the partitioned setups do not build raises, naming ROADMAP
    Queue 1 item 14: ``mixed_precision=True`` (a sharded hierarchy holds
    no float64 A64; ValueError), an operator that is not a grid stencil
    for RS (the unstructured route) and ``device_air_setup(...,
    mesh=mesh)`` (the AIR neighbourhood solves' degree-2 halo;
    NotImplementedError)."""
    want = ValueError if case.endswith("mixed") else NotImplementedError
    with pytest.raises(want, match="Queue 1 item 14"):
        _raising(case)
