"""The multicolour Gauss-Seidel smoothers of the host-built configs 3 and 4
beside a parent checkout's, and the two solves that run them.

Each tree (the parent given by ``--parent DIR``, and this checkout) runs
in a child process of its own, in the order parent, change, change,
parent, importing its own ``pyamg_tpu_torch`` and building its own
kernels.  In each, the hierarchies ``chip_smoke.py`` phase 23 builds
(config 3: the port's ``ruge_stuben_solver`` on the 512^2 rotated
anisotropic diffusion stencil; config 4: ``rootnode_solver`` on
``linear_elasticity((128, 128))``; both compiled float32 with the float64
A64, cut at 1024 rows):

- at every multicolour level (config 3's DIA levels 0-6, config 4's block
  levels 0-1), one smoother call as the solve makes it (``lvl.pre(A, x,
  b)``, the symmetric sweep; the parent's chain of colour steps, this
  tree's one launch) on inputs made from a fixed seed, timed by CUDA
  events (``chip_smoke.py::time_ms``, the best of two), its launches, and
  a digest of its output's bytes, which must be the same in every run
  (the parent's bits);
- the mixed GMRES (config 3) and mixed CG (config 4) to 1e-8 with
  ``chip_smoke.py``'s b: iterations, a digest of the residual history
  (the same in every run), the launches of each kernel instance, walls
  (the median of 5 after a warm solve), and a ``torch.profiler`` trace
  of one solve: wall, kernel ms, kernels, the device's busy share and
  the largest kernels.

The card's name and power limit, then one JSON line, end the output;
``--json PATH`` writes every run's numbers there too.

    python scripts/measure_mcgs_sweeps.py --parent DIR [--json PATH]

(one GPU; ~4 min)."""
import argparse
import hashlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--tree" in sys.argv:             # a child: the package of that tree
    sys.path.insert(0, os.path.abspath(
        sys.argv[sys.argv.index("--tree") + 1]))
else:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# this checkout's harness (its timer, seeds and sizes) in every child
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _trace(fn):
    """One traced call of ``fn`` after a warm one: wall, kernel ms,
    kernels, busy share and the largest kernels by name (ms, count)."""
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
        name = name if len(name) < 70 else name[:67] + "..."
        t, c = kern.get(name, (0.0, 0))
        kern[name] = (t + e.device_time_total / 1e3, c + 1)
    busy = sum(t for t, _ in kern.values())
    top = dict(sorted(kern.items(), key=lambda kv: -kv[1][0])[:8])
    return dict(wall_ms=wall * 1e3, kernel_ms=busy,
                launches=sum(c for _, c in kern.values()),
                busy_share=busy / (wall * 1e3) if busy > 0 else None,
                top=top)


def tree_run(tree):
    """Child process: the smoothers and solves of the package of
    ``tree``; one JSON line."""
    from pyamg_tpu_torch import (_build, DeviceMultilevelSolver,
                                 compile_hierarchy, diffusion_stencil_2d,
                                 linear_elasticity, rootnode_solver,
                                 ruge_stuben_solver, stencil_grid)

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        _build.__file__)), tree)
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    A3 = stencil_grid(diffusion_stencil_2d(epsilon=1e-3, theta=0.0,
                                           type="FD"), cs.C3_GRID).tocsr()
    A4, B4 = linear_elasticity(cs.C4_GRID)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # B truncated to 2 columns
        ml3 = ruge_stuben_solver(A3)
        ml4 = rootnode_solver(A4, B=B4, strength="symmetric")
    cases = {
        "config 3": (ml3, A3, np.random.default_rng(2).random(A3.shape[0]),
                     dict(tol=1e-8, maxiter=60, accel="gmres",
                          precision="mixed")),
        "config 4": (ml4, A4, np.random.default_rng(3).random(A4.shape[0]),
                     dict(tol=1e-8, maxiter=60, accel="cg",
                          precision="mixed"))}
    out = {}
    rng = np.random.default_rng(17)
    for label, (ml, A, b, kw) in cases.items():
        h = compile_hierarchy(ml, f32, device=dev, mixed_precision=True,
                              coarse_cutoff=cs.COARSE_CUTOFF)
        for i, lvl in enumerate(h.levels):
            if lvl.pre.config[0] not in ("mcgs", "block_mcgs"):
                continue
            x = torch.as_tensor(rng.random(lvl.A.n_pad), dtype=f32,
                                device=dev)
            r = torch.as_tensor(rng.random(lvl.A.n_pad), dtype=f32,
                                device=dev)
            call = (lambda s=lvl.pre, M=lvl.A, x=x, r=r: s(M, x, r))
            y = call()
            torch.cuda.synchronize()
            _build.reset_launches()
            call()
            torch.cuda.synchronize()
            out[f"{label} level {i} smoother"] = dict(
                kind=lvl.pre.config[0], colours=lvl.pre.config[1],
                n_pad=lvl.A.n_pad, launches=dict(_build.launches),
                ms=min(cs.time_ms(call) for _ in range(2)),
                bits=_digest([y.cpu().numpy()]))
        d = DeviceMultilevelSolver(h)
        d.solve(b, **kw)                                   # warm
        res = []
        torch.cuda.synchronize()
        _build.reset_launches()
        d.solve(b, residuals=res, **kw)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            d.solve(b, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"{label} solve"] = dict(
            iterations=len(res) - 1, relres=res[-1] / res[0],
            history_bits=_digest([np.asarray(res, dtype=np.float64)]),
            launches=counts, walls=walls,
            wall_median=statistics.median(walls),
            trace=_trace(lambda: d.solve(b, **kw)))
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout measured beside this one")
    ap.add_argument("--json", help="write every run's numbers to this file")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_mcgs_sweeps: torch sees no CUDA device")
    if args.tree:
        tree_run(os.path.abspath(args.tree))
        return
    parent = os.path.abspath(args.parent)
    rows = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--parent", parent, "--tree", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree} failed:\n{proc.stderr[-4000:]}")
        rows.append(dict(tree="parent" if tree == parent else "change",
                         **json.loads(proc.stdout.strip().splitlines()[-1])))
    card = cs.nvidia_smi_line()
    keys = [k for k in rows[0] if k != "tree"]
    same = True
    for k in keys:
        bits = {r[k].get("bits", r[k].get("history_bits")) for r in rows}
        same = same and len(bits) == 1
        tag = "" if len(bits) == 1 else " BITS DIFFER"
        if k.endswith("smoother"):
            runs = ", ".join(f"{r[k]['ms']:.4f}" for r in rows)
            print(f"{k} ({rows[0][k]['kind']}, {rows[0][k]['colours']} "
                  f"colours, n_pad {rows[0][k]['n_pad']}): runs p, c, c, p "
                  f"{runs} ms; launches parent {rows[0][k]['launches']}, "
                  f"change {rows[1][k]['launches']}{tag}")
            continue
        for r in rows:
            s, t = r[k], r[k]["trace"]
            print(f"{k} [{r['tree']}]: {s['iterations']} iterations, "
                  f"history relres {s['relres']:.4e}, walls median "
                  f"{s['wall_median']:.4f} s ({', '.join(f'{w:.4f}' for w in s['walls'])}); "
                  f"traced wall {t['wall_ms']:.2f} ms, kernel "
                  f"{t['kernel_ms']:.2f} ms, {t['launches']} kernels, busy "
                  f"share {t['busy_share']}{tag}")
            print(f"    launches {json.dumps(s['launches'], sort_keys=True)}")
            for name, (ms, c) in t["top"].items():
                print(f"    {ms:8.3f} ms {c:5d}x  {name}")
    print("bits and histories: the parent's in every run" if same
          else "bits or histories: DIFFER")
    print(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(device=torch.cuda.get_device_name(0), card=card,
                           runs=rows), f)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          same_bits=same)))
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
