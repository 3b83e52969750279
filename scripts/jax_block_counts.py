"""Iteration counts and level structure of the JAX package's block and
adaptive device setups, on the CPU, at the sizes ``chip_smoke.py``'s
config 4 phase uses, to set beside the port's on the card.

    JAX_PLATFORMS=cpu python scripts/jax_block_counts.py

Imports the JAX package only.  Cases:

- config 4 (bench.py:540-559, :729-736): ``linear_elasticity((128,
  128))``, grid (128, 127), the three rigid-body modes, max_coarse=400,
  float32 with the float64 A64; b = default_rng(3).random(n); mixed CG to
  1e-8 (maxiter 100) and native float32 CG to 1e-5; each level's
  (n, bs, ndiags) and the dense coarsest n;
- adaptive SA (``device_adaptive_sa_setup``, stages=2) on 2-D Poisson
  512^2, float32, max_coarse=400; b = default_rng(0).random(n); native
  float32 CG to 1e-5 (maxiter 100).
"""

import os
import sys
import time
import warnings

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pyamg_tpu.engine import (device_adaptive_sa_setup,  # noqa: E402
                              device_sa_setup_block)
from pyamg_tpu.gallery import linear_elasticity, poisson  # noqa: E402


def levels(solver):
    return ([(i["n"], i["bs"], i["ndiags"])
             for i in solver.setup_info["levels"]],
            solver.hierarchy.levels[-1].n)


def count(solver, b, **kw):
    res = []
    x = solver.solve(b, residuals=res, **kw)
    return len(res) - 1, res[-1] / np.linalg.norm(b), x


def main():
    warnings.simplefilter("ignore")
    A, B = linear_elasticity((128, 128))
    b = np.random.default_rng(3).random(A.shape[0])
    t0 = time.perf_counter()
    dsb = device_sa_setup_block(A, grid=(128, 127), B=B, max_coarse=400,
                                dtype=jnp.float32, mixed_precision=True)
    print(f"config 4 128^2 (n={A.shape[0]}): setup {time.perf_counter() - t0:.1f} s"
          f" (JAX compile included); levels {levels(dsb)}")
    it, rel, x = count(dsb, b, tol=1e-8, maxiter=100, accel="cg",
                       precision="mixed")
    true = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    print(f"  mixed CG to 1e-8: {it} iterations, history relres {rel:.4e}, "
          f"true relres {true:.4e}")
    it, rel, _ = count(dsb, b, tol=1e-5, maxiter=100, accel="cg")
    print(f"  native float32 CG to 1e-5: {it} iterations, history relres "
          f"{rel:.4e}")

    A2 = poisson((512, 512), format="csr")
    b2 = np.random.default_rng(0).random(A2.shape[0])
    t0 = time.perf_counter()
    dad = device_adaptive_sa_setup(A2, grid=(512, 512), stages=2,
                                   max_coarse=400, dtype=jnp.float32)
    print(f"adaptive SA stages=2, Poisson 512^2: setup "
          f"{time.perf_counter() - t0:.1f} s (JAX compile included); "
          f"m={dad.setup_info['m']}; levels {levels(dad)}")
    it, rel, _ = count(dad, b2, tol=1e-5, maxiter=100, accel="cg")
    print(f"  native float32 CG to 1e-5: {it} iterations, history relres "
          f"{rel:.4e}")


if __name__ == "__main__":
    main()
