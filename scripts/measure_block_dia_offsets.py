"""Time how ``block_dia_from_scipy`` finds an operator's block diagonals:
the count over the offsets' range that it uses (``_distinct``) against
``np.unique(return_inverse=True)``, alone on the host and inside config
4's 1024^2 block device setup (its second call, so nothing compiles).

    python scripts/measure_block_dia_offsets.py [--grid 1024]

Runs on the first CUDA device; the setups go in the order count, sort,
sort, count, and each prints beside the card's name and power limit.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pyamg_tpu_torch import device_sa_setup_block, linear_elasticity  # noqa
from pyamg_tpu_torch.sparse import block_dia as bd  # noqa: E402


def by_sort(offs, nb):
    return np.unique(offs, return_inverse=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    g = args.grid
    A, B = linear_elasticity((g, g))
    nb = A.shape[0] // 2
    offs = A.indices - np.repeat(np.arange(nb), np.diff(A.indptr))
    count, sort = bd._distinct, by_sort
    for a, b in zip(count(offs, nb), sort(offs, nb)):
        assert np.array_equal(a, b)
    for name, fn in (("count", count), ("sort", sort)) * 2:
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(offs, nb)
            ts.append(time.perf_counter() - t0)
        print(f"host offsets by {name} ({offs.size} blocks): "
              f"{min(ts):.4f} s (min of 3)")

    kw = dict(grid=(g, g - 1), B=B, max_coarse=400, dtype=torch.float32,
              mixed_precision=True)
    device_sa_setup_block(A, **kw)                      # compile, warm
    torch.cuda.synchronize()
    for name, fn in (("count", count), ("sort", sort), ("sort", sort),
                     ("count", count)):
        bd._distinct = fn
        t0 = time.perf_counter()
        device_sa_setup_block(A, **kw)
        torch.cuda.synchronize()
        print(f"setup {g}^2 with offsets by {name}: "
              f"{time.perf_counter() - t0:.4f} s ({card})")
    bd._distinct = count


if __name__ == "__main__":
    main()
