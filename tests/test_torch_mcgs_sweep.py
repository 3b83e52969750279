"""The one-launch multicolour Gauss-Seidel sweeps of the port
(``sparse/dia.py::dia_mcgs_sweep``, ``sparse/block_dia.py::
block_mcgs_sweep``) and their colour plans, on the CPU.

- Each sweep on ``device="cpu"`` (its plain twin, the parent's colour-step
  chain) against the JAX package's ``apply_smoother`` for ``mcgs`` /
  ``block_mcgs`` (``pyamg_tpu/engine/relaxation.py``) on the same numpy
  inputs: forward, backward and symmetric, 1 and 2 iterations, float32
  (rtol 1e-6 of the largest entry) and float64 (1e-12).  Operators: levels
  0 and 1 of config 3's Ruge-Stuben hierarchy at 32^2, level 0 of a
  rootnode hierarchy of elasticity at 16^2 (2x2 blocks), and upwind
  advection at 32^2, whose one-sided pattern's JP colouring couples two
  rows of one colour with a stored nonzero.
- The smoother's own call (``DeviceSmoother``) goes through the sweep with
  the sweep's bits, and keeps its plan.
- The plans: every coloured row (node) exactly once, the colours in
  order, the padding left out, the offsets the counts' prefix sums; the
  in-place or staged verdict on each operator, the route by the largest
  colour and the iterate's size, and a numpy emulation of the grid route's
  schedule (its first phase out of place over every row, the later phases
  in place row by row, or staged; the one-CTA route's phases on a copy of
  x are the same updates) equal to the chain exactly where the plan says
  so, and in place not equal to it on the coupled operator.
"""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyamg_tpu.engine import relaxation as jrel  # noqa: E402
from pyamg_tpu.sparse import \
    block_dia_from_scipy as jax_block_dia  # noqa: E402
from pyamg_tpu.sparse.dia import dia_from_scipy as jax_dia  # noqa: E402

import pyamg_tpu_torch as pt  # noqa: E402
from pyamg_tpu_torch.engine import relaxation as rel  # noqa: E402
from pyamg_tpu_torch.engine.hierarchy import (  # noqa: E402
    _block_colors_for, _device_block_dinv)
from pyamg_tpu_torch.graph import vertex_coloring  # noqa: E402
from pyamg_tpu_torch.sparse import block_dia as bd  # noqa: E402
from pyamg_tpu_torch.sparse import dia  # noqa: E402

CPU = "cpu"
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}
SWEEPS = ("forward", "backward", "symmetric")
SCALAR = ("rs_level0", "rs_level1", "advection")


@pytest.fixture(autouse=True, scope="module")
def _x64_one_thread():
    """float64 JAX, and one torch thread (the test workers share the
    cores)."""
    jax.config.update("jax_enable_x64", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _scalar_operator(which):
    """The scipy CSR operator of a scalar case."""
    if which == "advection":
        return pt.advection_2d((32, 32))[0].tocsr()
    A = pt.stencil_grid(pt.diffusion_stencil_2d(epsilon=1e-3, type="FD"),
                        (32, 32)).tocsr()
    ml = pt.ruge_stuben_solver(A)
    return ml.levels[int(which[-1])].A.tocsr()


@functools.lru_cache(maxsize=None)
def _scalar_case(which, dtype):
    """(port DIA, JAX DIA, dinv, colours, ncolours) as the host-built
    compile makes them: the JP colouring of the row pattern, -1 on the
    padding, dinv zero there."""
    A = _scalar_operator(which)
    T = dia.dia_from_scipy(A, dtype=dtype, device=CPU, row_pad=8)
    J = jax_dia(A, dtype=JNP[dtype], row_pad=8)
    assert T is not None and J.n_pad == T.n_pad
    c = vertex_coloring(A, method="JP")
    colors = np.full(T.n_pad, -1, dtype=np.int32)
    colors[: len(c)] = c
    d = A.diagonal()
    dinv = np.zeros(T.n_pad)
    dinv[: len(d)] = 1.0 / d
    return T, J, dinv, colors, int(c.max()) + 1


@functools.lru_cache(maxsize=None)
def _block_case(dtype):
    """(port block DIA, JAX block DIA, Dinv, node colours, ncolours) of
    level 0 of a rootnode hierarchy of elasticity at 16^2 (2x2 blocks)."""
    A, B = pt.linear_elasticity((16, 16))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ml = pt.rootnode_solver(A, B=B, strength="symmetric")
    A0 = ml.levels[0].A.tobsr()
    bs = A0.blocksize[0]
    T = bd.block_dia_from_scipy(A0, dtype=dtype, device=CPU)
    J = jax_block_dia(A0, dtype=JNP[dtype])
    Dinv = _device_block_dinv(A0, bs, T.nb_pad, torch.float64, CPU).numpy()
    colors, ncolors = _block_colors_for(A0, bs, T.nb_pad, CPU)
    return T, J, Dinv, colors.numpy(), ncolors


def _inputs(n_pad, n, seed):
    rng = np.random.default_rng(seed)
    x, b = rng.standard_normal(n_pad), rng.standard_normal(n_pad)
    x[n:] = b[n:] = 0
    return x, b


def _close(got, want, dtype, what):
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("sweep", SWEEPS)
@pytest.mark.parametrize("which", SCALAR)
def test_scalar_sweep_matches_reference(which, sweep, iterations, dtype):
    T, J, dinv, colors, ncolors = _scalar_case(which, dtype)
    x, b = _inputs(T.n_pad, T.shape[0], 1)
    js = jrel.multicolor_gs(jnp.asarray(dinv, JNP[dtype]),
                            jnp.asarray(colors), ncolors, sweep=sweep,
                            iterations=iterations)
    jd = JNP[dtype]
    want = np.asarray(jrel.apply_smoother(js.config, js.arrays, J,
                                          jnp.asarray(x, jd),
                                          jnp.asarray(b, jd)))
    dinv_t = torch.as_tensor(dinv, dtype=dtype)
    colors_t = torch.as_tensor(colors)
    plan = dia.mcgs_plan(T, colors_t, ncolors)
    order = rel._sweeps(ncolors, sweep) * iterations
    xt, bt = (torch.as_tensor(v, dtype=dtype) for v in (x, b))
    got = dia.dia_mcgs_sweep(T, xt, bt, dinv_t, plan, order)
    assert got.dtype == dtype and got.shape == xt.shape
    assert torch.equal(xt, torch.as_tensor(x, dtype=dtype))   # x kept
    _close(got.numpy(), want, dtype, f"{which} {sweep} x{iterations}")
    # the smoother's own call is the sweep, with its bits
    ts = rel.multicolor_gs(dinv_t, colors_t, ncolors, sweep=sweep,
                           iterations=iterations)
    assert ts.config == js.config
    assert torch.equal(ts(T, xt, bt), got)
    assert ts.plan(T) is ts.plan(T)
    want0 = np.asarray(jrel.apply_smoother_zero(js.config, js.arrays, J,
                                                jnp.asarray(b, jd)))
    _close(ts.zero_call(T, bt).numpy(), want0, dtype,
           f"{which} {sweep} x{iterations} from zero")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("sweep", SWEEPS)
def test_block_sweep_matches_reference(sweep, iterations, dtype):
    T, J, Dinv, colors, ncolors = _block_case(dtype)
    x, b = _inputs(T.n_pad, T.shape[0], 2)
    jd = JNP[dtype]
    js = jrel.block_multicolor_gs(jnp.asarray(Dinv, jd), jnp.asarray(colors),
                                  ncolors, sweep=sweep, iterations=iterations)
    want = np.asarray(jrel.apply_smoother(js.config, js.arrays, J,
                                          jnp.asarray(x, jd),
                                          jnp.asarray(b, jd)))
    Dt = torch.as_tensor(Dinv, dtype=dtype)
    colors_t = torch.as_tensor(colors)
    plan = bd.block_mcgs_plan(T, colors_t, ncolors)
    order = rel._sweeps(ncolors, sweep) * iterations
    xt, bt = (torch.as_tensor(v, dtype=dtype) for v in (x, b))
    got = bd.block_mcgs_sweep(T, xt, bt, Dt, plan, order)
    assert torch.equal(xt, torch.as_tensor(x, dtype=dtype))
    _close(got.numpy(), want, dtype, f"block {sweep} x{iterations}")
    ts = rel.block_multicolor_gs(Dt, colors_t, ncolors, sweep=sweep,
                                 iterations=iterations)
    assert ts.config == js.config
    assert torch.equal(ts(T, xt, bt), got)
    # a lane stack keeps the B2 COLOUR chain, lane by lane the same bits
    lanes = ts(T, torch.stack([xt, xt]), torch.stack([bt, bt]))
    assert torch.equal(lanes[1], got)


def _plan_invariants(plan, colors, ncolors):
    rows = plan.rows.numpy()
    coloured = np.flatnonzero(colors >= 0)
    assert plan.rows.dtype == torch.int32 and plan.offsets.dtype == torch.int32
    assert sorted(rows.tolist()) == coloured.tolist()      # each once
    assert np.all(np.diff(colors[rows]) >= 0)             # by colour
    offs = plan.offsets.numpy()
    assert offs[0] == 0 and len(offs) == ncolors + 1
    assert tuple(np.diff(offs)) == plan.sizes
    for c in range(ncolors):
        seg = rows[offs[c]:offs[c + 1]]
        assert np.all(colors[seg] == c)
        assert np.all(np.diff(seg) > 0)                   # stable sort
    assert plan.ncolors == ncolors and plan.max_rows == max(plan.sizes)


@pytest.mark.parametrize("which", SCALAR + ("block",))
def test_plan_invariants_and_verdict(which):
    if which == "block":
        T, _, _, colors, ncolors = _block_case(torch.float64)
        plan = bd.block_mcgs_plan(T, torch.as_tensor(colors), ncolors)
    else:
        T, _, _, colors, ncolors = _scalar_case(which, torch.float64)
        plan = dia.mcgs_plan(T, torch.as_tensor(colors), ncolors)
    _plan_invariants(plan, colors, ncolors)
    # a JP colouring of a symmetric pattern never couples a colour; the
    # upwind operator's one-sided pattern, coloured as it is, does
    assert plan.staged == (which == "advection")
    assert (plan.route, plan.threads) == dia.sweep_route(
        plan.max_rows, T.n_pad * T.data.element_size())


def test_plan_rejects_bad_colours_and_order():
    T, _, dinv, colors, ncolors = _scalar_case("rs_level0", torch.float64)
    with pytest.raises(ValueError):
        dia.mcgs_plan(T, torch.as_tensor(colors[:-1]), ncolors)
    with pytest.raises(ValueError):
        dia.mcgs_plan(T, torch.as_tensor(colors.astype(np.int64)), ncolors)
    with pytest.raises(ValueError):
        dia._sweep_order([0, ncolors], ncolors)
    chunks = dia._sweep_chunks(list(range(3)) * 200)
    assert [len(c) for c in chunks] == [256, 256, 88]


def test_sweep_route_crossover():
    """One CTA while every thread holds at most one item and the iterate
    fits its shared memory, else the cooperative grid."""
    fits = dia._SWEEP_CTA_X_BYTES
    assert dia.sweep_route(dia._SWEEP_CTA_ITEMS, fits) == ("cta", 1024)
    assert dia.sweep_route(dia._SWEEP_CTA_ITEMS + 1, fits) == ("grid", 128)
    assert dia.sweep_route(1, fits + 1) == ("grid", 128)


def _emulate(T, x, b, dinv, plan, order, staged):
    """The kernel's schedule in float64 numpy, row by row in plan order:
    phase 0 out of place over every row, the later phases in place (each
    row reading x as the rows before it left it) or staged."""
    data, offs, n = T.data.numpy(), T.offsets, T.n_pad
    colors, rows = plan.colors.numpy(), plan.rows.numpy()
    co = plan.offsets.numpy()

    def row(src, i):
        acc = 0.0
        first = True
        for d, o in enumerate(offs):
            j = i + o
            term = data[d, i] * (src[j] if 0 <= j < n else 0.0)
            acc = term if first else acc + term
            first = False
        return src[i] + 1.0 * (dinv[i] * (b[i] - acc))

    y = np.array([row(x, i) if colors[i] == order[0] else x[i]
                  for i in range(n)])
    for c in order[1:]:
        seg = rows[co[c]:co[c + 1]]
        if staged:
            y[seg] = [row(y, i) for i in seg]
        else:
            for i in seg:
                y[i] = row(y, i)
    return y


@pytest.mark.parametrize("which", ["rs_level1", "advection"])
def test_kernel_schedule_needs_staging_only_where_planned(which):
    T, _, dinv, colors, ncolors = _scalar_case(which, torch.float64)
    plan = dia.mcgs_plan(T, torch.as_tensor(colors), ncolors)
    x, b = _inputs(T.n_pad, T.shape[0], 3)
    order = rel._sweeps(ncolors, "symmetric")
    chain = dia.dia_mcgs_sweep(T, torch.as_tensor(x), torch.as_tensor(b),
                               torch.as_tensor(dinv), plan, order).numpy()
    staged = _emulate(T, x, b, dinv, plan, order, True)
    in_place = _emulate(T, x, b, dinv, plan, order, False)
    np.testing.assert_array_equal(staged, chain)
    if plan.staged:
        assert not np.array_equal(in_place, chain)
    else:
        np.testing.assert_array_equal(in_place, chain)
