"""Time pyamg_tpu_torch's unstructured device SA setup on the card.

The case is chip_smoke.py's 640k one: the P1 stiffness matrix of a regular
800^2 triangle mesh plus 1e-2 I, float32, max_coarse=1000.  One warm call,
then ``--runs`` timed calls (CUDA-synchronised wall seconds, host CSR to
windowed included), each with its per-stage totals and its levels, printed
as one JSON line after the card's name and power limit.

    python scripts/time_torch_unstructured_setup.py [--repo DIR] [--runs 3]

``--repo`` is the checkout whose ``pyamg_tpu_torch`` is timed (default:
the one holding this script), so two commits can be compared on one card
in one session: run parent, change, change, parent.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--nx", type=int, default=800)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import scipy.sparse as sp
    import torch

    from pyamg_tpu_torch import (device_unstructured_sa_setup, gradgradform,
                                 regular_triangle_mesh)

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    A = sp.csr_matrix(gradgradform(*regular_triangle_mesh(args.nx, args.nx)))
    A = (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()
    kw = dict(device="cuda", max_coarse=1000)
    device_unstructured_sa_setup(A, **kw)           # warm: kernels, handles
    runs = []
    for _ in range(args.runs):
        prof = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dus = device_unstructured_sa_setup(A, profile=prof, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages = {}
        for key, sec in prof.items():
            stage = key.split(".", 1)[1]
            stages[stage] = stages.get(stage, 0.0) + sec
        runs.append(dict(seconds=wall, stages=stages,
                         levels=[lv.n for lv in dus.hierarchy.levels]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps(dict(repo=os.path.abspath(args.repo), n=A.shape[0],
                          runs=runs)))


if __name__ == "__main__":
    main()
