"""B1 and B2 on K lanes beside a parent checkout's kernels, and a trace of
the K = 8 config 4 1024^2 batched solves that run them.

Each tree (the parent given by ``--parent DIR``, and this checkout) runs
in a child process of its own, in the order parent, change, change,
parent, importing its own ``pyamg_tpu_torch`` and building its own
kernels.  In each, at config 4's 1024^2 levels (``linear_elasticity``,
``device_sa_setup_block``, float32, max_coarse 400, as ``chip_smoke.py``
phase 21 builds them), on inputs made from a fixed seed:

- level 0 (bs 2, 9 block diagonals) on K = 8 lanes and on one vector:
  B1 ``PLAIN`` and ``RESID`` (``block_dia_apply`` / ``block_dia_resid``),
  B1's halo mode as a ring of one (``block_halo_spmv``, world of one),
  B2 ``ZERO``, ``ZERO_RES``, ``STEP`` (the level's Dinv and weight) and
  ``COLOUR`` (colour 0 of the node grid's 4-colour parity colouring);
  K = 16 ``PLAIN``;
- level 0's float64 copy (A64 as the mixed-precision solve's residual
  takes it): B1 ``PLAIN`` and ``RESID`` on K = 8 and one vector;
- level 1 (bs 3): B1 ``PLAIN`` and B2 ``STEP`` / ``ZERO_RES`` on K = 8,
  ``PLAIN`` on one vector;

each timed by CUDA events (``chip_smoke.py::time_ms``, the best of two),
with a digest of its output's bytes, which must be the same in every run
(the parent's bits); then the unsharded and the sharded (world of one)
batched CG to 1e-5 on K = 8 grid-encoded columns, each traced by
``torch.profiler`` after a warm solve: wall, kernel ms, launches, the
device's busy share, the block kernels by instance (<T, bs, lane tile,
mode> in this tree) and the largest others; the iterations per lane and
a digest of the histories.  Per operation: its bound (``block_cost``).
The card's name and power limit, then one JSON line, end the output;
``--json PATH`` writes every run's numbers there too.

``--yardsticks`` (no parent) times, in this tree alone, what the lane
rows lack: at the A64 (float64) level 0 B1 ``PLAIN`` / ``RESID`` on K = 8
and at level 1 B1 ``PLAIN`` on K = 8, each beside its plain twin and
``torch.sparse.mm`` / ``torch.addmm`` of the operator as CSR against the
(n, 8) columns; at level 1 B2 ``STEP`` / ``ZERO_RES`` on K = 8 beside
their twins; the kernel against its twin at the kernel tolerance.

    python scripts/measure_block_lanes.py --parent DIR [--json PATH]
    python scripts/measure_block_lanes.py --yardsticks

(one GPU each)."""
import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--tree" in sys.argv:             # a child: the package of that tree
    sys.path.insert(0, os.path.abspath(
        sys.argv[sys.argv.index("--tree") + 1]))
else:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# this checkout's harness (its timer, bounds and seeds) in every child
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

LANES = 8


def _digest(out):
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time(fn):
    fn()
    torch.cuda.synchronize()
    return min(cs.time_ms(fn) for _ in range(2))


def _bound_ms(nbytes, ops, dtype):
    return max(nbytes / cs.PEAK_BYTES,
               ops / cs.PEAK_OPS[str(dtype).removeprefix("torch.")]) * 1e3


def _trace(fn):
    """One traced call of ``fn`` after a warm one: wall, kernel ms,
    launches, busy share and the kernels by name (ms, count)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.name)
        t, c = kern.get(name, (0.0, 0))
        kern[name] = (t + e.device_time_total / 1e3, c + 1)
    busy = sum(t for t, _ in kern.values())
    block = {k: v for k, v in kern.items() if k.startswith("block_dia")}
    top = dict(sorted(kern.items(), key=lambda kv: -kv[1][0])[:8])
    return dict(wall_ms=wall * 1e3, kernel_ms=busy,
                launches=sum(c for _, c in kern.values()),
                busy_share=busy / (wall * 1e3) if busy > 0 else None,
                block_kernels=block, top=top)


def tree_run(tree):
    """Child process: the kernels of the package of ``tree``; one JSON
    line."""
    import dataclasses

    import torch.distributed as dist

    from pyamg_tpu_torch import (_build, DeviceMultilevelSolver,
                                 device_sa_setup_block, linear_elasticity)
    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)
    from pyamg_tpu_torch.parallel.halo_spmv import block_halo_spmv
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse import block_dia as bd

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        _build.__file__)), tree)
    dev = torch.device("cuda", 0)
    one = SolverMesh(rank=0, world=1, device=dev)
    rng = np.random.default_rng(21)
    out = {}
    A4, Bm = linear_elasticity(cs.C4_BIG)
    d4 = device_sa_setup_block(A4, grid=cs.C4_BIG_NODE_GRID, B=Bm,
                               max_coarse=400, dtype=torch.float32,
                               device=dev)
    lv0, lv1 = d4.hierarchy.levels[:2]

    def rand(shape, dtype):
        return torch.as_tensor(rng.random(shape), dtype=dtype, device=dev)

    def record(what, fn, cost, dtype):
        out[what] = dict(ms=_time(fn), bits=_digest(fn()),
                         bound_ms=_bound_ms(*cost, dtype))

    def lanes_cost(A, K, vectors, **kw):
        return (cs.block_cost(A, K * vectors, **kw)[0],
                K * cs.block_cost(A, vectors, **kw)[1])

    def level(A, Dinv, omega, tag, K, modes, colors=None):
        dt = A.dtype
        shape = (A.n_pad,) if K == 1 else (K, A.n_pad)
        X, B = rand(shape, dt), rand(shape, dt)
        halo = max(A.halo, 1)
        n0 = 0 if colors is None else int((colors == 0).sum())
        zero_bytes = (Dinv.numel() + 2 * K * A.n_pad) * A.data.element_size()
        calls = {
            "PLAIN": (lambda: bd.block_dia_apply(A, X), lanes_cost(A, K, 2)),
            "RESID": (lambda: bd.block_dia_resid(A, X, B),
                      lanes_cost(A, K, 3, extra_ops=1)),
            "halo PLAIN": (lambda: block_halo_spmv(
                A.data, A.offsets, A.offsets_t, X, halo, one, 1),
                lanes_cost(A, K, 2)),
            "halo RESID": (lambda: block_halo_spmv(
                A.data, A.offsets, A.offsets_t, X, halo, one, 1, b=B),
                lanes_cost(A, K, 3, extra_ops=1)),
            "ZERO": (lambda: bd.block_jacobi_zero(Dinv, B, omega),
                     (zero_bytes, K * (2 * A.nb_pad * A.bs * A.bs
                                       + A.nb_pad * A.bs))),
            "ZERO_RES": (lambda: bd.block_jacobi_zero_res(A, B, Dinv, omega),
                         lanes_cost(A, K, 3, dinv=True, extra_ops=2)),
            "STEP": (lambda: bd.block_jacobi_step(A, X, B, Dinv, omega),
                     lanes_cost(A, K, 3, dinv=True, extra_ops=3)),
            "COLOUR": (lambda: bd.block_colour_step(A, X, B, Dinv, colors, 0),
                       (cs.block_cost(A, K * (2 + n0 / A.nb_pad), dinv=True,
                                      nodes=n0)[0],
                        K * cs.block_cost(A, 2 + n0 / A.nb_pad, dinv=True,
                                          nodes=n0, extra_ops=3)[1])),
        }
        for m in modes:
            fn, cost = calls[m]
            record(f"{m} {tag} K={K}", fn, cost, dt)

    Dinv0, omega0 = lv0.pre.arrays
    gx = lv0.P.fine_grid_p[1]
    node = torch.arange(lv0.A.nb_pad, device=dev)
    parity = ((node // gx) % 2 * 2 + node % gx % 2).to(torch.int32)
    every = ("PLAIN", "RESID", "halo PLAIN", "halo RESID", "ZERO",
             "ZERO_RES", "STEP", "COLOUR")
    tag0 = f"level0 bs={lv0.A.bs} nd={lv0.A.ndiags} nb={lv0.A.nb_pad} f32"
    for K in (LANES, 1):
        level(lv0.A, Dinv0, omega0, tag0, K, every, parity)
    level(lv0.A, Dinv0, omega0, tag0, 16, ("PLAIN",))
    A64 = dataclasses.replace(lv0.A, data=lv0.A.data.double())
    for K in (LANES, 1):
        level(A64, Dinv0.double(), omega0.double(),
              tag0.replace("f32", "f64 (A64)"), K, ("PLAIN", "RESID"))
    del A64
    Dinv1, omega1 = lv1.pre.arrays
    tag1 = f"level1 bs={lv1.A.bs} nd={lv1.A.ndiags} nb={lv1.A.nb_pad} f32"
    level(lv1.A, Dinv1, omega1, tag1, LANES, ("PLAIN", "STEP", "ZERO_RES"))
    level(lv1.A, Dinv1, omega1, tag1, 1, ("PLAIN",))
    torch.cuda.empty_cache()

    # the K = 8 batched solves, unsharded and sharded (world of one)
    Bs = np.random.default_rng(21).random((A4.shape[0], LANES))
    E4 = np.stack([d4._encode(c) for c in Bs.T], axis=1)
    kw = dict(tol=1e-5, maxiter=100, accel="cg")
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(init_method=f"file://{tmp}/rendezvous",
                               world_size=1, rank=0, device=dev)
        try:
            mesh = make_solver_mesh(device=dev)
            solves = (("unsharded", DeviceMultilevelSolver(d4.hierarchy)),
                      ("sharded", DeviceMultilevelSolver(
                          shard_hierarchy(d4.hierarchy, mesh))))
            for what, solver in solves:
                res = []
                solver.solve(E4, residuals=res, **kw)
                rec = _trace(lambda: solver.solve(E4, **kw))
                rec["iterations"] = [len(r) - 1 for r in res]
                rec["history_bits"] = hashlib.sha256(np.concatenate(
                    [np.asarray(r, dtype=np.float64) for r in res]
                ).tobytes()).hexdigest()[:16]
                out[f"trace {what} batched CG K={LANES}"] = rec
        finally:
            dist.destroy_process_group()
    print(json.dumps(out))


def yardsticks():
    """The lane rows' plain-twin and library times (``--yardsticks``);
    one line an operation, then the card's line and a JSON line."""
    import dataclasses

    from pyamg_tpu_torch import device_sa_setup_block, linear_elasticity
    from pyamg_tpu_torch.sparse import block_dia as bd

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(21)
    A4, Bm = linear_elasticity(cs.C4_BIG)
    d4 = device_sa_setup_block(A4, grid=cs.C4_BIG_NODE_GRID, B=Bm,
                               max_coarse=400, dtype=torch.float32,
                               device=dev)
    lv0, lv1 = d4.hierarchy.levels[:2]
    A64 = dataclasses.replace(lv0.A, data=lv0.A.data.double())
    rows, ok = [], True

    def lanes_cost(A, vectors, **kw):
        return (cs.block_cost(A, LANES * vectors, **kw)[0],
                LANES * cs.block_cost(A, vectors, **kw)[1])

    for tag, A, Dinv, omega, modes in (
            ("A64 level0 f64", A64, None, None, ("PLAIN", "RESID")),
            ("level1 f32", lv1.A, *lv1.pre.arrays,
             ("PLAIN", "STEP", "ZERO_RES"))):
        dt = A.dtype
        X, B = (torch.as_tensor(rng.random((LANES, A.n_pad)), dtype=dt,
                                device=dev) for _ in range(2))
        csr = cs.bdia_to_csr(A, dev)
        Xc, Bc = X.T.contiguous(), B.T.contiguous()
        calls = {
            "PLAIN": (lambda: bd.block_dia_apply(A, X),
                      lambda: bd.block_dia_spmv_ref(A, X),
                      lambda: torch.sparse.mm(csr, Xc), lanes_cost(A, 2)),
            "RESID": (lambda: bd.block_dia_resid(A, X, B),
                      lambda: bd.block_dia_resid_ref(A, X, B),
                      lambda: torch.addmm(Bc, csr, Xc, alpha=-1.0),
                      lanes_cost(A, 3, extra_ops=1)),
            "STEP": (lambda: bd.block_jacobi_step(A, X, B, Dinv, omega),
                     lambda: bd.block_jacobi_step_ref(A, X, B, Dinv, omega),
                     None, lanes_cost(A, 3, dinv=True, extra_ops=3)),
            "ZERO_RES": (lambda: bd.block_jacobi_zero_res(A, B, Dinv, omega),
                         lambda: bd.block_jacobi_zero_res_ref(A, B, Dinv,
                                                              omega),
                         None, lanes_cost(A, 3, dinv=True, extra_ops=2)),
        }
        for m in modes:
            kern, plain, lib, cost = calls[m]
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
            tol = cs.F32_REL_TOL if dt == torch.float32 else cs.F64_REL_TOL
            ok = ok and err <= tol
            row = dict(name=f"{m} {tag} bs={A.bs} nb={A.nb_pad} K={LANES}",
                       ms=_time(kern), plain_ms=_time(plain),
                       library_ms=_time(lib) if lib is not None else None,
                       bound_ms=_bound_ms(*cost, dt), max_rel_err=err)
            rows.append(row)
            lib_s = (f"{row['library_ms']:.4f} ms" if lib is not None
                     else "none")
            print(f"{row['name']}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, library {lib_s}, bound "
                  f"{row['bound_ms']:.4f} ms, max_rel_err {err:.2e} "
                  f"(tol {tol:g})", flush=True)
    print(cs.nvidia_smi_line())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          yardsticks=rows, ok=ok)))
    sys.exit(0 if ok else 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout timed beside this one")
    ap.add_argument("--yardsticks", action="store_true",
                    help="this tree's lane rows' twin and library times")
    ap.add_argument("--json", help="write every run's numbers to this file")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_block_lanes: torch sees no CUDA device")
    if args.tree:
        tree_run(os.path.abspath(args.tree))
        return
    if args.yardsticks:
        yardsticks()
        return
    if not args.parent:
        ap.error("--parent DIR is required (or --yardsticks)")
    parent = os.path.abspath(args.parent)
    rows = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--parent", parent, "--tree", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree} failed:\n{proc.stderr[-4000:]}")
        rec = dict(tree="parent" if tree == parent else "change",
                   **json.loads(proc.stdout.strip().splitlines()[-1]))
        rows.append(rec)
    keys = [k for k in rows[0] if k != "tree" and not k.startswith("trace")]
    same = all(r[k]["bits"] == rows[0][k]["bits"] for r in rows for k in keys)
    for k in keys:
        ms = {t: [r[k]["ms"] for r in rows if r["tree"] == t]
              for t in ("parent", "change")}
        tag = "" if len({r[k]["bits"] for r in rows}) == 1 else " BITS DIFFER"
        runs = ", ".join(f"{r[k]['ms']:.4f}" for r in rows)
        print(f"{k}: parent {min(ms['parent']):.4f} ms, change "
              f"{min(ms['change']):.4f} ms (best of each pair; runs p, c, "
              f"c, p {runs}), bound {rows[0][k]['bound_ms']:.4f} ms{tag}")
    traces = [k for k in rows[0] if k.startswith("trace")]
    for k in traces:
        for r in rows:
            t = r[k]
            print(f"{k} [{r['tree']}]: iterations {t['iterations']}, "
                  f"wall {t['wall_ms']:.2f} ms, kernel {t['kernel_ms']:.2f} "
                  f"ms, {t['launches']} kernels, busy share "
                  f"{t['busy_share']}, history {t['history_bits']}")
            for name, (ms, c) in sorted(t["block_kernels"].items(),
                                        key=lambda kv: -kv[1][0]):
                print(f"    {ms:8.3f} ms {c:5d}x  {name}")
    hist = all(len({r[k]["history_bits"] for r in rows}) == 1
               for k in traces)
    print("bits: the parent's in every run" if same else "bits: DIFFER")
    print("histories: the parent's in every run" if hist
          else "histories: DIFFER")
    print(cs.nvidia_smi_line())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(device=torch.cuda.get_device_name(0),
                           card=cs.nvidia_smi_line(), runs=rows), f)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          same_bits=same, same_histories=hist)))
    sys.exit(0 if same and hist else 1)


if __name__ == "__main__":
    main()
