"""pyamg_tpu_torch: the PyTorch/CUDA port of pyamg_tpu's device engine.

It holds its own copy of the JAX package's host smoothed-aggregation
setup for the options config 1 runs (``aggregation``, ``strength``,
``relaxation``, ``util``, ``gallery``, ``multilevel`` and a native C++
subset in ``amg_core``, NumPy/SciPy), and the device half: padded DIA /
dense / windowed operators as tensors, the smoothers, the V-cycle and CG
(one right-hand side, or a K-lane batch on either hierarchy), the
device-built smoothed-aggregation setup of grid-stencil operators (its
lane-aligned layout sends a batched float32 CG down the interleaved
route) and of unstructured ones, and hand-written CUDA kernels for
Hopper (``csrc/``) where the JAX package had TPU kernels.  It imports ``torch`` and nothing of ``jax`` or
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

or, for an operator that is not a grid stencil (a FEM mesh, a graph
Laplacian), the unstructured device setup (``device_sa_setup`` routes
such an operator there):

    from pyamg_tpu_torch import (device_unstructured_sa_setup,
                                 gradgradform, regular_triangle_mesh)

    A = gradgradform(*regular_triangle_mesh(800, 800))
    dus = device_unstructured_sa_setup(A, max_coarse=1000)
    x = dus.solve(b, tol=1e-6, accel="cg")

Row-sharded solves over ``torch.distributed`` (one rank per GPU, NCCL;
gloo on the CPU), the DIA levels through the overlapped halo SpMV:

    from pyamg_tpu_torch import (DeviceMultilevelSolver,
                                 initialize_distributed, make_solver_mesh,
                                 shard_hierarchy)

    initialize_distributed()                  # torchrun's env, or a world of 1
    mesh = make_solver_mesh()
    x = DeviceMultilevelSolver(shard_hierarchy(dml.hierarchy, mesh)).solve(
        b, tol=1e-8, accel="cg")

The kernels build with ``nvcc`` at their first launch on a CUDA tensor
(``_build.py``).  On CPU tensors every kernel entry point runs its plain
PyTorch twin instead, which is what the CPU tests exercise.
"""

from . import backend
from ._build import launches, reset_launches
from .aggregation import smoothed_aggregation_solver
from .convert import (hierarchy_from_jax, structured_solver_from_jax,
                      unstructured_solver_from_jax)
from .engine import (ComposedWindowed, DeviceHierarchy,
                     DeviceMultilevelSolver, ReorderedSolver,
                     StructuredDeviceSolver, as_device_solver,
                     compile_hierarchy, detect_grid, device_sa_setup,
                     device_unstructured_sa_setup)
from .gallery import gradgradform, poisson, regular_triangle_mesh
from .multilevel import MultilevelSolver
from .parallel import (halo_width, initialize_distributed, make_halo_dia_spmv,
                       make_solver_mesh, shard_hierarchy, shard_vector)
from .sparse import dia_from_stencil

__all__ = ["ComposedWindowed", "DeviceHierarchy", "DeviceMultilevelSolver",
           "MultilevelSolver", "ReorderedSolver", "StructuredDeviceSolver",
           "as_device_solver", "backend", "compile_hierarchy", "detect_grid",
           "device_sa_setup", "device_unstructured_sa_setup",
           "dia_from_stencil", "gradgradform", "halo_width",
           "hierarchy_from_jax", "initialize_distributed", "launches",
           "make_halo_dia_spmv", "make_solver_mesh", "poisson",
           "regular_triangle_mesh", "reset_launches", "shard_hierarchy",
           "shard_vector", "smoothed_aggregation_solver",
           "structured_solver_from_jax", "unstructured_solver_from_jax"]
