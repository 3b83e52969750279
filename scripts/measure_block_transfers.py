"""Config 4's block transfers on the card, beside a parent checkout's.

Each tree (the parent given by ``--parent DIR``, and this checkout) runs
in a child process of its own, in the order parent, change, change,
parent, importing its own ``pyamg_tpu_torch`` and building its own
kernels.  In each, for config 4 (``linear_elasticity`` at 128^2 and
1024^2, ``device_sa_setup_block``, float32, mixed precision,
max_coarse 400, as ``chip_smoke.py`` builds it):

- the level-0 transfers ``P @ xc`` and ``R @ r`` on random vectors:
  device ms by CUDA events (``chip_smoke.py::time_ms``), host ms a call
  (the mean of 50 calls issued back to back, then one synchronize), and
  the device operations one call issues (``launches_per_call``);
- the solves: native float32 CG to 1e-5 and mixed CG to 1e-8 (numpy b),
  iterations, the median of 3 walls after a warm call, and one call under
  torch.profiler: its wall, its device time and their ratio (busy);
- the setup's wall (the second call, CUDA-synchronised).

The card's name and power limit, then one JSON line, end the output.

    python scripts/measure_block_transfers.py --parent DIR   # one GPU
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
if "--tree" in sys.argv:             # a child: the package of that tree
    sys.path.insert(0, os.path.abspath(
        sys.argv[sys.argv.index("--tree") + 1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SIZES = {"128^2": (cs.C4_GRID, cs.C4_NODE_GRID),
         "1024^2": (cs.C4_BIG, cs.C4_BIG_NODE_GRID)}
HOST_CALLS = 50


def _host_ms(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e3


def _solve(solver, b, kw):
    from torch.profiler import ProfilerActivity, profile

    res = []
    solver.solve(b, residuals=res, **kw)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solver.solve(b, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(b, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dict(iterations=len(res) - 1, wall_ms=float(np.median(walls)),
                walls_ms=walls, profiled_wall_ms=wall, device_ms=busy,
                busy=busy / wall)


def tree_run(tree):
    """Child process: config 4 on the package of ``tree``; one JSON
    line."""
    from pyamg_tpu_torch import (_build, device_sa_setup_block,
                                 linear_elasticity)

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        _build.__file__)), tree)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    out = {}
    for size, (grid, node_grid) in SIZES.items():
        A, B = linear_elasticity(grid)
        kw = dict(grid=node_grid, B=B, max_coarse=400, dtype=torch.float32,
                  device=dev, mixed_precision=True)
        device_sa_setup_block(A, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = device_sa_setup_block(A, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        lv0 = solver.hierarchy.levels[0]
        xc = torch.as_tensor(rng.random(lv0.P.shape[1]),
                             dtype=torch.float32, device=dev)
        r = torch.as_tensor(rng.random(lv0.R.shape[1]), dtype=torch.float32,
                            device=dev)
        rec = dict(setup_s=setup_s)
        for what, fn in (("P", lambda: lv0.P @ xc), ("R", lambda: lv0.R @ r)):
            rec[what] = dict(device_ms=cs.time_ms(fn), host_ms=_host_ms(fn),
                             operations=cs.launches_per_call(fn))
        b = rng.random(A.shape[0])
        rec["native CG 1e-5"] = _solve(
            solver, b, dict(tol=1e-5, maxiter=100, accel="cg"))
        rec["mixed CG 1e-8"] = _solve(
            solver, b, dict(tol=1e-8, maxiter=100, accel="cg",
                            precision="mixed"))
        out[size] = rec
        del solver, lv0
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout timed beside this one")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_block_transfers: torch sees no CUDA device")
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
        rec = dict(tree="parent" if tree == parent else "change",
                   **json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    print(cs.nvidia_smi_line())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), runs=rows)))


if __name__ == "__main__":
    main()
