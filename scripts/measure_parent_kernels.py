"""Kernels changed beside a parent checkout's: K16 and B1's halo mode on
one vector, and K12 on a K = 8 lane stack of config 4's candidate remap.

Each tree (the parent given by ``--parent DIR``, and this checkout) runs
in a child process of its own, in the order parent, change, change,
parent, importing its own ``pyamg_tpu_torch`` and building its own
kernels.  In each:

- K16 (``parallel/halo_spmv.py::halo_spmv``), a ring of one
  (``SolverMesh(rank=0, world=1)``), at config 1's device-built 2048^2
  level-0 S and S^T (``device_sa_setup``, float32, max_coarse 400, mixed
  precision, as ``chip_smoke.py`` builds it), one vector;
- at config 4's 1024^2 level 0 (``linear_elasticity``,
  ``device_sa_setup_block``, float32, max_coarse 400): B1's halo mode
  (``block_halo_spmv``), a ring of one, PLAIN and RESID on one vector,
  and K12 (``sparse/window.py::windowed_matmat_k``) on the transfers'
  candidate remap Q (row blocks of 7524 rows) on K = 8 lanes;

each on inputs made from a fixed seed: device ms by CUDA events
(``chip_smoke.py::time_ms``, the best of two) and a digest of the
output's bytes, which must be the same in every run (the parent's bits).
The card's name and power limit, then one JSON line, end the output.

    python scripts/measure_parent_kernels.py --parent DIR   # one GPU
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
if "--tree" in sys.argv:             # a child: the package of that tree
    sys.path.insert(0, os.path.abspath(
        sys.argv[sys.argv.index("--tree") + 1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _time(fn):
    fn()
    torch.cuda.synchronize()
    return min(cs.time_ms(fn) for _ in range(2))


def tree_run(tree):
    """Child process: the kernels of the package of ``tree``; one JSON
    line."""
    from pyamg_tpu_torch import (_build, device_sa_setup,
                                 device_sa_setup_block, linear_elasticity,
                                 poisson)
    from pyamg_tpu_torch.parallel import halo_width
    from pyamg_tpu_torch.parallel.halo_spmv import (block_halo_spmv,
                                                    halo_spmv)
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse.window import windowed_matmat_k

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        _build.__file__)), tree)
    dev = torch.device("cuda", 0)
    one = SolverMesh(rank=0, world=1, device=dev)
    rng = np.random.default_rng(20)
    out = {}
    ds = device_sa_setup(poisson(cs.GRID, format="csr"), grid=cs.GRID,
                         dtype=torch.float32, device=dev, max_coarse=400,
                         mixed_precision=True)
    lv0 = ds.hierarchy.levels[0]
    for what, A in (("K16 2048^2 level-0 S", lv0.P.S),
                    ("K16 2048^2 level-0 S^T", lv0.R.St)):
        x = torch.as_tensor(rng.random(A.n_pad), dtype=A.dtype, device=dev)
        halo = halo_width(A)

        def ring(A=A, x=x, halo=halo):
            return halo_spmv(A.data, A.offsets, A.offsets_t, x, halo, one,
                             1)

        out[what] = dict(ms=_time(ring), bits=_digest(ring()))
    del ds, lv0
    torch.cuda.empty_cache()
    A4, B4 = linear_elasticity(cs.C4_BIG)
    d4 = device_sa_setup_block(A4, grid=cs.C4_BIG_NODE_GRID, B=B4,
                               max_coarse=400, dtype=torch.float32,
                               device=dev)
    A = d4.hierarchy.levels[0].A
    x, b = (torch.as_tensor(rng.random(A.n_pad), dtype=A.dtype, device=dev)
            for _ in range(2))
    halo = max(A.halo, 1)
    for what, kw in (("B1 halo PLAIN config 4 1024^2 level-0 A", {}),
                     ("B1 halo RESID config 4 1024^2 level-0 A",
                      dict(b=b))):
        def ring(kw=kw):
            return block_halo_spmv(A.data, A.offsets, A.offsets_t, x, halo,
                                   one, 1, **kw)

        out[what] = dict(ms=_time(ring), bits=_digest(ring()))
    Q = d4.hierarchy.levels[0].P.Q
    X = torch.as_tensor(rng.random((8, Q.m_chunks * Q.w2)), dtype=Q.dtype,
                        device=dev)
    out[f"K12 K=8 config 4 1024^2 level-0 Q block={Q.block}"] = dict(
        ms=_time(lambda: windowed_matmat_k(Q, X)),
        bits=_digest(windowed_matmat_k(Q, X)))
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout timed beside this one")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_parent_kernels: torch sees no CUDA device")
    if args.tree:
        tree_run(os.path.abspath(args.tree))
        return
    parent = os.path.abspath(args.parent)
    rows = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--parent", parent, "--tree", tree],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree} failed:\n{proc.stderr[-4000:]}")
        rec = dict(tree="parent" if tree == parent else "change",
                   **json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    same = all(r[k]["bits"] == rows[0][k]["bits"] for r in rows
               for k in rows[0] if k != "tree")
    for k in rows[0]:
        if k == "tree":
            continue
        ms = {t: [r[k]["ms"] for r in rows if r["tree"] == t]
              for t in ("parent", "change")}
        print(f"{k}: parent {min(ms['parent']):.4f} ms, change "
              f"{min(ms['change']):.4f} ms (best of each pair)")
    print("bits: the parent's in every run" if same else "bits: DIFFER")
    print(cs.nvidia_smi_line())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          same_bits=same, runs=rows)))
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
