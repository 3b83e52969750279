"""pyamg_tpu_torch: the PyTorch/CUDA port of pyamg_tpu's device engine.

The host setup (``pyamg_tpu.aggregation`` and the other NumPy/SciPy
modules) is shared with the JAX package.  This package holds the device
half: padded DIA / dense / windowed operators as tensors, the smoothers,
the V-cycle and CG, and hand-written CUDA kernels for Hopper (``csrc/``)
where the JAX package had TPU kernels.  It imports ``torch`` and never
``jax``.

    import pyamg_tpu
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu_torch import as_device_solver

    A = poisson((2048, 2048), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4 / 3}),
        postsmoother=("jacobi", {"omega": 4 / 3}))
    dml = as_device_solver(ml, device="cuda", mixed_precision=True,
                           coarse_cutoff=1024)
    x = dml.solve(b, tol=1e-8, accel="cg", precision="mixed")

The kernels build with ``nvcc`` at their first launch on a CUDA tensor
(``_build.py``).  On CPU tensors every kernel entry point runs its plain
PyTorch twin instead, which is what the CPU tests exercise.
"""

from . import backend
from ._build import launches, reset_launches
from .convert import hierarchy_from_jax
from .engine import (DeviceHierarchy, DeviceMultilevelSolver,
                     as_device_solver, compile_hierarchy)

__all__ = ["DeviceHierarchy", "DeviceMultilevelSolver", "as_device_solver",
           "backend", "compile_hierarchy", "hierarchy_from_jax", "launches",
           "reset_launches"]
