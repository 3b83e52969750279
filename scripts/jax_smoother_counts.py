"""Iteration counts of the JAX package's solves with the smoothers other
than Jacobi, on the CPU, at the sizes the port's tests and
``chip_smoke.py`` use, to set beside the port's counts.

    JAX_PLATFORMS=cpu python scripts/jax_smoother_counts.py [--64]

Imports the JAX package only.  Each case prints the iterations the solve
took and its last history entry relative to its first:

- config 2 at 24^3 (tests/test_torch_smoothers.py): SA with symmetric
  Gauss-Seidel, float64, cut at 1024 rows; the stationary W-cycle, W-cycle
  CG and V-cycle CG to 1e-8, maxiter 30, b = default_rng(1).random(n);
- the device-built setups of that file with Chebyshev (degree 3) and
  Richardson smoothers: 2-D Poisson 48^2 (max_coarse=100, b = ones) and
  the P1 mesh 20^2 + 1e-2 I (max_coarse=30, b =
  default_rng(0).standard_normal(n)), float64 CG to 1e-8, maxiter 60;
- the 256^2 float64 host-built hierarchies of ``chip_smoke.py``'s
  smoother phase (Richardson, SOR, Cimmino NE and NR, Schwarz, a
  polynomial on level 0 with Chebyshev below, Chebyshev): V-cycle CG to
  1e-8, maxiter 40, b = default_rng(5).random(n);
- with ``--64``, config 2 itself at 64^3 (float32 hierarchy, float64
  A64): the mixed stationary W-cycle to 1e-8, maxiter 30.
"""

import os
import sys
import time
import warnings

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pyamg_tpu  # noqa: E402
from pyamg_tpu.engine import (DeviceMultilevelSolver, compile_hierarchy,  # noqa: E402
                              device_sa_setup, device_unstructured_sa_setup)
from pyamg_tpu.gallery import (gradgradform, poisson,  # noqa: E402
                               regular_triangle_mesh)
from pyamg_tpu.relaxation.chebyshev import \
    chebyshev_polynomial_coefficients  # noqa: E402

GS_SYM = ("gauss_seidel", {"sweep": "symmetric"})
CHEB = ("chebyshev", {"degree": 3})


def report(label, res, t0):
    print(f"{label}: {len(res) - 1} iterations, last {res[-1] / res[0]:.3e} "
          f"of the first ({time.perf_counter() - t0:.1f} s)", flush=True)


def config2(grid, dtype, cases, mixed=False):
    A = poisson(grid, format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, presmoother=GS_SYM,
                                               postsmoother=GS_SYM)
    dml = DeviceMultilevelSolver(compile_hierarchy(
        ml, dtype=dtype, coarse_cutoff=1024, mixed_precision=mixed))
    b = np.random.default_rng(1).random(A.shape[0])
    for label, kw in cases:
        t0 = time.perf_counter()
        res = []
        dml.solve(b, residuals=res, **kw)
        report(f"config 2 {grid} {label}", res, t0)


def device_setups():
    grid = (48, 48)
    A = poisson(grid, format="csr")
    V, E = regular_triangle_mesh(20, 20)
    M = sp.csr_matrix(gradgradform(V, E))
    M = (M + 1e-2 * sp.eye(M.shape[0], format="csr")).tocsr()
    for name, spec in (("chebyshev", CHEB),
                       ("richardson", ("richardson", {"omega": 1.0}))):
        t0 = time.perf_counter()
        d = device_sa_setup(A, grid=grid, dtype=jnp.float64, max_coarse=100,
                            presmoother=spec, postsmoother=spec)
        res = []
        d.solve(np.ones(A.shape[0]), tol=1e-8, maxiter=60, accel="cg",
                residuals=res)
        report(f"device_sa_setup 48^2 {name}", res, t0)
        t0 = time.perf_counter()
        d = device_unstructured_sa_setup(M, dtype=jnp.float64, max_coarse=30,
                                         presmoother=spec, postsmoother=spec)
        res = []
        b = np.random.default_rng(0).standard_normal(M.shape[0])
        d.solve(jnp.asarray(b), tol=1e-8, maxiter=60, accel="cg",
                residuals=res)
        report(f"device_unstructured_sa_setup P1 20^2 {name}", res, t0)


def smoother_kinds():
    A = poisson((256, 256), format="csr")
    b = np.random.default_rng(5).random(A.shape[0])
    rho = 8.0
    specs = {
        "richardson": ("richardson", {"omega": 1.0}),
        "sor": ("sor", {"omega": 1.0, "sweep": "symmetric"}),
        "jacobi_ne": ("jacobi_ne", {"omega": 0.5}),
        "gauss_seidel_nr": ("gauss_seidel_nr", {"sweep": "symmetric"}),
        "schwarz": ("schwarz", {}),
        "polynomial": [("polynomial", {"coefficients": list(
            chebyshev_polynomial_coefficients(rho / 30, 1.1 * rho, 3))}),
            CHEB],
        "chebyshev": CHEB}
    for name, spec in specs.items():
        t0 = time.perf_counter()
        ml = pyamg_tpu.smoothed_aggregation_solver(A, presmoother=spec,
                                                   postsmoother=spec)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dml = DeviceMultilevelSolver(compile_hierarchy(
                ml, dtype=jnp.float64))
        res = []
        dml.solve(b, tol=1e-8, maxiter=40, accel="cg", residuals=res)
        report(f"256^2 float64 {name}", res, t0)


def main():
    config2((24, 24, 24), jnp.float64, (
        ("stationary W-cycle", dict(tol=1e-8, maxiter=30, cycle="W",
                                    accel=None)),
        ("W-cycle CG", dict(tol=1e-8, maxiter=30, cycle="W", accel="cg")),
        ("V-cycle CG", dict(tol=1e-8, maxiter=30, accel="cg"))))
    device_setups()
    smoother_kinds()
    if "--64" in sys.argv:
        config2((64, 64, 64), jnp.float32, (
            ("mixed stationary W-cycle", dict(
                tol=1e-8, maxiter=30, cycle="W", accel=None,
                precision="mixed")),), mixed=True)


if __name__ == "__main__":
    main()
