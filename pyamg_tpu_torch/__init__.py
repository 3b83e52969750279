"""pyamg_tpu_torch: the PyTorch/CUDA port of pyamg_tpu's device engine.

It holds its own copy of the JAX package's host smoothed-aggregation
setup for the options config 1 runs (``aggregation``, ``strength``,
``relaxation``, ``util``, ``gallery``, ``multilevel`` and a native C++
subset in ``amg_core``, NumPy/SciPy), and the device half: padded DIA /
dense / windowed operators as tensors, the smoothers, the V-cycle and CG
(one right-hand side, or a K-lane batch on either hierarchy), the
device-built smoothed-aggregation setup of grid-stencil operators (its
lane-aligned layout sends a batched float32 CG down the interleaved
route), and hand-written CUDA kernels for Hopper (``csrc/``) where the
JAX package had TPU kernels.  It imports ``torch`` and nothing of ``jax`` or
``pyamg_tpu``.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.

    from pyamg_tpu_torch import (as_device_solver, poisson,
                                 smoothed_aggregation_solver)

    A = poisson((2048, 2048), format="csr")
    ml = smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4 / 3}),
        postsmoother=("jacobi", {"omega": 4 / 3}))
    dml = as_device_solver(ml, mixed_precision=True, coarse_cutoff=1024)
    x = dml.solve(b, tol=1e-8, accel="cg", precision="mixed")
    X = dml.solve(B, tol=1e-8, accel="cg", precision="mixed")  # B (n, K)

or, with the hierarchy built on the card, and K right-hand sides at once:

    from pyamg_tpu_torch import device_sa_setup

    dsa = device_sa_setup(A, grid=(2048, 2048), max_coarse=400,
                          mixed_precision=True)
    x = dsa.solve(b, tol=1e-8, accel="cg", precision="mixed")
    X = dsa.solve(B, tol=1e-5, accel="cg")     # B (n, K) -> X (n, K)
    dla = device_sa_setup(A, grid=(2048, 2048), lane_align=True)
    X = dla.solve(B, tol=1e-5, accel="cg")     # the interleaved route

The kernels build with ``nvcc`` at their first launch on a CUDA tensor
(``_build.py``).  On CPU tensors every kernel entry point runs its plain
PyTorch twin instead, which is what the CPU tests exercise.
"""

from . import backend
from ._build import launches, reset_launches
from .aggregation import smoothed_aggregation_solver
from .convert import hierarchy_from_jax, structured_solver_from_jax
from .engine import (DeviceHierarchy, DeviceMultilevelSolver,
                     StructuredDeviceSolver, as_device_solver,
                     compile_hierarchy, detect_grid, device_sa_setup)
from .gallery import poisson
from .multilevel import MultilevelSolver
from .sparse import dia_from_stencil

__all__ = ["DeviceHierarchy", "DeviceMultilevelSolver", "MultilevelSolver",
           "StructuredDeviceSolver", "as_device_solver", "backend",
           "compile_hierarchy", "detect_grid", "device_sa_setup",
           "dia_from_stencil", "hierarchy_from_jax", "launches", "poisson",
           "reset_launches", "smoothed_aggregation_solver",
           "structured_solver_from_jax"]
