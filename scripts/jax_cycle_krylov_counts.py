"""Iteration counts of the JAX package's W, F and AMLI cycles and device
Krylov methods on the CPU, at the sizes the port's tests and
``chip_smoke.py`` use, to set beside the port's counts.

    JAX_PLATFORMS=cpu python scripts/jax_cycle_krylov_counts.py

Imports the JAX package only.  Each case prints the iterations the solve
took and its last history entry relative to its first:

- the 32^2 SA hierarchy of tests/test_torch_krylov.py (Jacobi before and
  after, max_coarse=16, float64): every accel through the V-cycle to 1e-8,
  maxiter 30, GMRES and FGMRES restarted every 7 steps (stationary cycles
  to 1e-6);
- the 128^2 SA hierarchy of tests/test_torch_cycles.py (max_coarse=10,
  float64): CG with each cycle to 1e-10, maxiter 40;
- the 256^2 device-built float64 hierarchy of ``chip_smoke.py``'s accel
  phase (max_coarse=400, b = default_rng(5).random(n)): every accel
  (V-cycle) and CG with the W, F and AMLI cycles to 1e-8, maxiter 40,
  restart 30.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pyamg_tpu  # noqa: E402
from pyamg_tpu.engine import (DeviceMultilevelSolver, compile_hierarchy,  # noqa: E402
                              device_sa_setup)
from pyamg_tpu.gallery import poisson  # noqa: E402

JACOBI = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
              postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
ACCELS = ("cg", "bicgstab", "gmres", "fgmres", "cgnr", "cgne", "cr",
          "minimal_residual", "steepest_descent")


def run(label, solver, b, **kw):
    res = []
    t0 = time.perf_counter()
    solver.solve(b, residuals=res, **kw)
    print(f"{label}: {len(res) - 1} iterations, last {res[-1] / res[0]:.3e} "
          f"of the first ({time.perf_counter() - t0:.1f} s with its "
          "compile)", flush=True)


def main():
    print(f"jax {jax.__version__} on {jax.default_backend()}")
    A = poisson((32, 32), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=16, **JACOBI)
    dml = DeviceMultilevelSolver(compile_hierarchy(ml, dtype=jnp.float64))
    b = np.random.default_rng(0).random(A.shape[0])
    for accel in (None,) + ACCELS:
        run(f"32^2 host-built, V-cycle, accel={accel}", dml, b,
            tol=1e-8 if accel else 1e-6, maxiter=30, accel=accel,
            restart=7)

    A = poisson((128, 128), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=10, **JACOBI)
    dml = DeviceMultilevelSolver(compile_hierarchy(ml, dtype=jnp.float64))
    b = np.random.default_rng(1).random(A.shape[0])
    for cycle in ("V", "W", "F", "AMLI"):
        run(f"128^2 host-built, {cycle}-cycle CG", dml, b, tol=1e-10,
            maxiter=40, cycle=cycle, accel="cg")

    A = poisson((256, 256), format="csr")
    dsa = device_sa_setup(A, grid=(256, 256), dtype=jnp.float64,
                          max_coarse=400)
    b = np.random.default_rng(5).random(A.shape[0])
    cases = ([("V", a) for a in ACCELS]
             + [(c, "cg") for c in ("W", "F", "AMLI")])
    for cycle, accel in cases:
        run(f"256^2 device-built, {cycle}-cycle, accel={accel}", dsa, b,
            tol=1e-8, maxiter=40, cycle=cycle, accel=accel, restart=30)


if __name__ == "__main__":
    main()
