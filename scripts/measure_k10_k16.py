"""K10 and K16 on the card, beside a parent checkout's kernels.

K10 (``dia_jacobi_zero_res_k``) runs the lane kernel of K8 / K9
(csrc/dia_k.cu::dia_k_lane_kernel, mode ZERO_RES_K, ``sparse/dia.py::
k8_plan``); K16 (``parallel/halo_spmv.py::halo_spmv``, csrc/halo.cu) runs
row blocks of 4 float32 rows a thread or 1 by ``halo_plan``, a ring of one
in one launch.  For each path shape this script:

- checks the bits: equal across two launches, to the thread-per-row K10
  (K10) or to K1 (K16), and with ``--parent DIR`` to the kernel built from
  the checkout DIR (its own ``_build.py`` and C interface: K10 one thread
  per row in 16-lane chunks, K16 the interior rows and then the boundary
  rows of the ring of one, two launches); and its error against the plain
  twin;
- times it by CUDA events (``chip_smoke.py::time_ms``, 30 calls) in the
  order parent, change, change, parent (the best of each pair), beside the
  plain twin, K1 and ``torch.mv`` on CSR (K16), and the bound (bytes once
  at 3.35 TB/s); and counts its launches a call (one call captured in a
  CUDA graph).

Shapes: K10 at the host-built 2048^2 level 0 (nd 5, n 4.19M, K = 8,
float32) and config 3's level 0 (512^2 anisotropic diffusion,
device_rs_setup, K = 8, float32); K16 as a ring of one at the host-built
2048^2 level 0 (float32, and its float64 A64) and the host-built config 2
64^3 level 0 (nd 7, float32).

With ``--solves`` (needs ``--parent``) it then times whole solves in four
child processes, parent, change, change, parent, each importing its own
tree: the host-built batched config 1 solve (2048^2, K = 8, b on the
card, native float32 CG to 1e-5 and mixed CG to 1e-8), the host-built
config 1 hierarchy sharded in a world of one (NCCL, native float32 CG to
1e-5) and the host-built config 2 64^3 hierarchy sharded in a world of
one (native float32 stationary W-cycle to 1e-4); median of 3 walls (numpy
b for the sharded solves), iterations, and torch.profiler's busy share
with K10's and K16's time and launches over one solve.  The card's name
and power limit, then one JSON line, end the output.

    python scripts/measure_k10_k16.py [--parent DIR [--solves]]   # one GPU
"""
import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
if "--solves-of" in sys.argv:        # a child: the package of that tree
    sys.path.insert(0, os.path.abspath(
        sys.argv[sys.argv.index("--solves-of") + 1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LANES = 8
CONFIG1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
               postsmoother=("jacobi", {"omega": 4.0 / 3.0}))


def _scalar(dtype):
    return ctypes.c_float if dtype == torch.float32 else ctypes.c_double


def parent_kernels(parent):
    """K10 and K16 of the checkout ``parent``, built by its own _build.py:
    (A, B, dinv, omega) -> (X, R), its thread-per-row K10 in 16-lane
    chunks; and (A, x) -> y, its K16 on a ring of one (the interior rows
    [halo, n - halo), then both boundary ranges)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(parent, "pyamg_tpu_torch", "_build.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    lib = ctypes.CDLL(str(pb.build()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def k10(A, B, dinv, omega):
        suffix = "f32" if A.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"pyamg_dia_k_{suffix}")
        fn.argtypes = [P, P, I, L, I, P, P, P, _scalar(A.dtype), P, P, P, I,
                       P]
        fn.restype = ctypes.c_int
        X, R = torch.empty_like(B), torch.empty_like(B)
        for k0 in range(0, B.shape[0], 16):
            k1 = min(B.shape[0], k0 + 16)
            assert fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                      A.n_pad, k1 - k0, None, B[k0:k1].data_ptr(),
                      dinv.data_ptr(), float(omega), None,
                      X[k0:k1].data_ptr(), R[k0:k1].data_ptr(), 4,
                      torch.cuda.current_stream().cuda_stream) == 0
        return X, R

    def k16(A, x, halo):
        suffix = "f32" if A.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"pyamg_halo_spmv_{suffix}")
        fn.argtypes = [P, L, P, I, L, I, P, P, P, L, L, L, L, P, P]
        fn.restype = ctypes.c_int
        n = A.n_pad
        y = torch.empty_like(x)
        left, right = x[n - halo:], x[:halo]
        for a0, a1, b0, b1 in ((halo, n - halo, n - halo, n - halo),
                               (0, halo, n - halo, n)):
            assert fn(A.data.data_ptr(), A.data.stride(0),
                      A.offsets_t.data_ptr(), A.ndiags, n, halo,
                      left.data_ptr(), x.data_ptr(), right.data_ptr(), a0,
                      a1, b0, b1, y.data_ptr(),
                      torch.cuda.current_stream().cuda_stream) == 0
        return y

    return k10, k16


def turns(parent_fn, change_fn):
    """(change ms, parent ms): parent, change, change, parent."""
    t = [cs.time_ms(f) for f in (parent_fn, change_fn, change_fn, parent_fn)]
    return min(t[1], t[2]), min(t[0], t[3])


def same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def rel_err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def shapes(dev):
    """The path shapes: [(label, A, dinv, omega)] for K10 and [(label, A)]
    for K16."""
    from pyamg_tpu_torch import (compile_hierarchy, device_rs_setup,
                                 as_device_solver, diffusion_stencil_2d,
                                 poisson, smoothed_aggregation_solver,
                                 stencil_grid)

    A = poisson(cs.GRID, format="csr")
    h = as_device_solver(smoothed_aggregation_solver(A, **CONFIG1),
                         device=dev, mixed_precision=True,
                         coarse_cutoff=cs.COARSE_CUTOFF).hierarchy
    A3 = stencil_grid(diffusion_stencil_2d(epsilon=1e-3, theta=0.0,
                                           type="FD"), cs.C3_GRID).tocsr()
    h3 = device_rs_setup(A3, grid=cs.C3_GRID, dtype=torch.float32,
                         max_coarse=400, device=dev).hierarchy
    ml2 = smoothed_aggregation_solver(poisson(cs.GRID3, format="csr"),
                                      presmoother=cs.C2_GS,
                                      postsmoother=cs.C2_GS)
    h2 = compile_hierarchy(ml2, dtype=torch.float32, device=dev,
                           mixed_precision=True, coarse_cutoff=1024)
    l0, c0 = h.levels[0], h3.levels[0]
    k10 = [("host level0", l0.A, l0.pre.arrays[0], l0.pre.config[1]),
           ("config3 level0", c0.A, c0.pre.arrays[0], c0.pre.arrays[1])]
    k16 = [("host level0", l0.A), ("host A64 level0", h.A64),
           ("config2 64^3 level0", h2.levels[0].A)]
    return k10, k16


def measure(dev, rng, parent):
    from pyamg_tpu_torch.parallel import halo_width
    from pyamg_tpu_torch.parallel.dist_spmv import dia_halo_rows_ref
    from pyamg_tpu_torch.parallel.halo_spmv import halo_plan, halo_spmv
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse import dia

    ok, out = True, []
    k10_shapes, k16_shapes = shapes(dev)
    for label, A, dinv, omega in k10_shapes:
        n, sz = A.n_pad, A.data.element_size()
        B = torch.as_tensor(rng.random((LANES, n)), dtype=A.dtype,
                            device=dev)
        change = lambda: dia.dia_jacobi_zero_res_k(A, B, dinv, omega)  # noqa
        plain = lambda: dia.dia_jacobi_zero_res_k_ref(A, B, dinv, omega)  # noqa
        rows = lambda: dia._zero_res_k_rows(A, B, dinv, omega)  # noqa
        got = change()
        plan = dia.k8_plan(A.offsets, n, LANES, A.dtype)
        rec = dict(kernel="K10", shape=label, dtype=str(A.dtype), n_pad=n,
                   offsets=list(A.offsets), lanes=LANES,
                   plan=None if plan is None else dict(
                       vec=plan.vec, rows=plan.rows, blocks=plan.blocks,
                       lo=plan.lo, hi=plan.hi),
                   two_launches_equal=same(got, change()),
                   rows_bits=same(got, rows()),
                   max_rel_err_twin=rel_err(got, plain()),
                   launches_per_call=cs.launches_per_call(change),
                   bound_ms=(A.ndiags + 1 + 3 * LANES) * n * sz
                   / cs.PEAK_BYTES * 1e3)
        if parent is not None:
            w = float(omega)          # the parent takes omega by value
            pk = lambda: parent[0](A, B, dinv, w)  # noqa: E731
            rec["parent_bits"] = same(got, pk())
            rec["parent_launches_per_call"] = cs.launches_per_call(pk)
            rec["ms"], rec["parent_ms"] = turns(pk, change)
        else:
            rec["ms"] = min(cs.time_ms(change) for _ in range(2))
        rec["rows_ms"] = min(cs.time_ms(rows) for _ in range(2))
        rec["plain_ms"] = cs.time_ms(plain)
        ok &= (rec["two_launches_equal"] and rec["rows_bits"]
               and rec["launches_per_call"] == 1
               and rec.get("parent_bits", True))
        print(f"K10 {json.dumps(rec)}", flush=True)
        out.append(rec)
        del B, got
    for label, A in k16_shapes:
        n, sz, halo = A.n_pad, A.data.element_size(), halo_width(A)
        one = SolverMesh(rank=0, world=1, device=dev)
        x = torch.as_tensor(rng.random(n), dtype=A.dtype, device=dev)
        change = lambda: halo_spmv(A.data, A.offsets, A.offsets_t, x,  # noqa
                                   halo, one, 1)
        plain = lambda: dia_halo_rows_ref(  # noqa: E731
            A.data, A.offsets, x[n - halo:], x, x[:halo], halo, ((0, n),),
            torch.empty_like(x))
        k1 = lambda: dia.dia_spmv(A, x)  # noqa: E731
        csr = cs.dia_to_csr(A)
        got = change()
        plan = halo_plan(tuple(A.offsets), n, A.dtype)
        rec = dict(kernel="K16", shape=label, dtype=str(A.dtype), n_pad=n,
                   offsets=list(A.offsets), halo=halo,
                   plan=dict(vec=plan.vec, rows=plan.rows,
                             row_blocks=plan.row_blocks, lo=plan.lo,
                             hi=plan.hi),
                   two_launches_equal=same(got, change()),
                   k1_bits=same(got, k1()),
                   max_rel_err_twin=rel_err(got, plain()),
                   launches_per_call=cs.launches_per_call(change),
                   bound_ms=(A.ndiags + 2) * n * sz / cs.PEAK_BYTES * 1e3)
        if parent is not None:
            pk = lambda: parent[1](A, x, halo)  # noqa: E731
            rec["parent_bits"] = same(got, pk())
            rec["parent_launches_per_call"] = cs.launches_per_call(pk)
            rec["ms"], rec["parent_ms"] = turns(pk, change)
        else:
            rec["ms"] = min(cs.time_ms(change) for _ in range(2))
        rec["k1_ms"] = min(cs.time_ms(k1) for _ in range(2))
        rec["plain_ms"] = cs.time_ms(plain)
        rec["library_ms"] = min(cs.time_ms(lambda: torch.mv(csr, x))
                                for _ in range(2))
        ok &= (rec["two_launches_equal"] and rec["k1_bits"]
               and rec["launches_per_call"] == 1
               and rec.get("parent_bits", True))
        print(f"K16 {json.dumps(rec)}", flush=True)
        out.append(rec)
        del x, got, csr
    return ok, out


_KERNEL_RE = re.compile(r"(dia_k_lane_kernel|dia_k_kernel)<(float|double), "
                        r"4[,>]|(halo_spmv_kernel)<(float|double)")


def _profile(fn):
    """(wall ms, device ms, busy share, {kernel: (ms, launches)}) of one
    call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, kern = 0.0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.device_time_total / 1e3
        busy += t
        m = _KERNEL_RE.search(e.name)
        if m is None:
            continue
        name = "K16" if m.group(3) else "K10"
        if m.group(1) == "dia_k_kernel":
            name += " (per-row)"
        name += " f32" if (m.group(2) or m.group(4)) == "float" else " f64"
        ms, cnt = kern.get(name, (0.0, 0))
        kern[name] = (ms + t, cnt + 1)
    return wall, busy, busy / wall, {k: dict(ms=v[0], launches=v[1])
                                      for k, v in sorted(kern.items())}


def _timed(label, fn, out):
    """Median of 3 walls after a warm call that records the iterations,
    and one profiled call."""
    res = fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall, busy_ms, busy, kern = _profile(fn)
    out[label] = dict(iterations=res, wall_ms=float(np.median(walls)),
                      walls_ms=walls, profiled_wall_ms=wall,
                      kernel_ms=busy_ms, busy=busy, kernels=kern)


def solves_of(tree):
    """Child process: the solves on the package of ``tree``; one JSON
    line."""
    import torch.distributed as dist

    from pyamg_tpu_torch import (DeviceMultilevelSolver, _build,
                                 as_device_solver, compile_hierarchy, poisson,
                                 smoothed_aggregation_solver)
    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        _build.__file__)), tree)
    dev = torch.device("cuda", 0)
    A = poisson(cs.GRID, format="csr")
    dml = as_device_solver(smoothed_aggregation_solver(A, **CONFIG1),
                           device=dev, mixed_precision=True,
                           coarse_cutoff=cs.COARSE_CUTOFF)
    ml2 = smoothed_aggregation_solver(poisson(cs.GRID3, format="csr"),
                                      presmoother=cs.C2_GS,
                                      postsmoother=cs.C2_GS)
    dml2 = DeviceMultilevelSolver(compile_hierarchy(
        ml2, dtype=torch.float32, device=dev, mixed_precision=True,
        coarse_cutoff=1024))
    Bt = torch.as_tensor(np.random.default_rng(3).random((A.shape[0], LANES)),
                         device=dev)
    b1 = np.random.default_rng(1).random(A.shape[0])
    b2 = np.random.default_rng(1).random(ml2.levels[0].A.shape[0])
    out = {}

    def lanes(**kw):
        def run():
            res = []
            dml.solve(Bt, residuals=res, maxiter=100, accel="cg", **kw)
            return [len(r) - 1 for r in res]
        return run
    _timed("host-built batched native", lanes(tol=1e-5, precision="native"),
           out)
    _timed("host-built batched mixed", lanes(tol=1e-8, precision="mixed"),
           out)
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(init_method=f"file://{tmp}/rendezvous",
                               world_size=1, rank=0, device=dev)
        try:
            mesh = make_solver_mesh(device=dev)
            for label, solver, b, kw in (
                    ("sharded host-built config 1 CG", dml, b1,
                     dict(tol=1e-5, maxiter=100, accel="cg")),
                    ("sharded config 2 64^3 W-cycle", dml2, b2,
                     dict(tol=1e-4, maxiter=30, cycle="W", accel=None))):
                sharded = DeviceMultilevelSolver(
                    shard_hierarchy(solver.hierarchy, mesh))

                def run(s=sharded, b=b, kw=kw):
                    res = []
                    s.solve(b, residuals=res, **kw)
                    return len(res) - 1
                _timed(label, run, out)
        finally:
            dist.destroy_process_group()
    print(json.dumps(out))


def measure_solves(parent):
    rows = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--solves-of", tree], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"solves of {tree} failed:\n{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec = dict(tree="parent" if tree == parent else "change", **rec)
        print(f"solves {json.dumps(rec)}", flush=True)
        rows.append(rec)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose K10 / K16 bits the "
                    "kernels must equal, timed beside them")
    ap.add_argument("--solves", action="store_true", help="also time whole "
                    "solves, parent and change (needs --parent)")
    ap.add_argument("--solves-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_k10_k16: torch sees no CUDA device")
    if args.solves_of:
        solves_of(os.path.abspath(args.solves_of))
        return
    if args.solves and not args.parent:
        sys.exit("measure_k10_k16: --solves needs --parent")
    from pyamg_tpu_torch import _build

    dev = torch.device("cuda", 0)
    parent = parent_kernels(os.path.abspath(args.parent)) if args.parent \
        else None
    _build.library()
    for line in _build.build_info.get("log", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    ok, recs = measure(dev, np.random.default_rng(0), parent)
    solves = measure_solves(os.path.abspath(args.parent)) if args.solves \
        else None
    print(cs.nvidia_smi_line())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          kernels=recs, solves=solves)))
    if not ok:
        sys.exit("measure_k10_k16: a kernel changed the bits or its "
                 "launches")


if __name__ == "__main__":
    main()
