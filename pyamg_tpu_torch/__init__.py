"""pyamg_tpu_torch: the PyTorch/CUDA port of pyamg_tpu's device engine.

It holds its own copy of the JAX package's host setups for the options
configs 1, 3 and 4 run: smoothed aggregation, rootnode and Ruge-Stuben
(``aggregation``, ``classical``, ``strength``, ``relaxation``, ``util``,
``gallery``, ``multilevel`` and a native C++ subset in ``amg_core``,
NumPy/SciPy), and the device half: padded DIA /
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

or the host-built columns of configs 3 (Ruge-Stüben) and 4 (rootnode, 2x2
blocks, the rigid-body modes):

    from pyamg_tpu_torch import (compile_hierarchy, DeviceMultilevelSolver,
                                 diffusion_stencil_2d, linear_elasticity,
                                 rootnode_solver, ruge_stuben_solver,
                                 stencil_grid)

    A3 = stencil_grid(diffusion_stencil_2d(epsilon=1e-3, type="FD"),
                      (512, 512)).tocsr()
    h3 = compile_hierarchy(ruge_stuben_solver(A3), mixed_precision=True,
                           coarse_cutoff=1024)
    x = DeviceMultilevelSolver(h3).solve(b, tol=1e-8, accel="gmres",
                                         precision="mixed")
    A4, B4 = linear_elasticity((128, 128))
    ml4 = rootnode_solver(A4, B=B4, strength="symmetric")

or, with the hierarchy built on the card, and K right-hand sides at once:

    from pyamg_tpu_torch import device_sa_setup

    dsa = device_sa_setup(A, grid=(2048, 2048), max_coarse=400,
                          mixed_precision=True)
    x = dsa.solve(b, tol=1e-8, accel="cg", precision="mixed")
    X = dsa.solve(B, tol=1e-5, accel="cg")     # B (n, K) -> X (n, K)
    dla = device_sa_setup(A, grid=(2048, 2048), lane_align=True)
    X = dla.solve(B, tol=1e-5, accel="cg")     # the interleaved route

or the classical family's device-built hierarchies of a grid stencil,
Ruge-Stüben (symmetric or not) and AIR (upwind advection):

    from pyamg_tpu_torch import (advection_2d, device_air_setup,
                                 device_rs_setup, recirc_flow)

    A5 = recirc_flow((1024, 1024), epsilon=1e-2)
    drs = device_rs_setup(A5, grid=(1024, 1024), mixed_precision=True)
    x = drs.solve(b, tol=1e-8, maxiter=150, accel="fgmres",
                  precision="mixed")
    Aa, ba = advection_2d((256, 256))
    dair = device_air_setup(Aa, grid=(256, 256))
    x = dair.solve(ba, tol=1e-8, maxiter=5)   # stationary AIR cycles

or, for an operator that is not a grid stencil (a FEM mesh, a graph
Laplacian), the unstructured device setup (``device_sa_setup`` routes
such an operator there):

    from pyamg_tpu_torch import (device_unstructured_sa_setup,
                                 gradgradform, regular_triangle_mesh)

    A = gradgradform(*regular_triangle_mesh(800, 800))
    dus = device_unstructured_sa_setup(A, max_coarse=1000)
    x = dus.solve(b, tol=1e-6, accel="cg")

or, for a BSR operator or several near-nullspace candidates (config 4:
2-D linear elasticity, 2x2 blocks, the three rigid-body modes), the
block device setup, and adaptive SA, which grows its candidates through
it:

    from pyamg_tpu_torch import (device_adaptive_sa_setup,
                                 device_sa_setup_block, linear_elasticity)

    A4, B4 = linear_elasticity((1024, 1024))
    dbk = device_sa_setup_block(A4, grid=(1024, 1023), B=B4,
                                mixed_precision=True)
    x = dbk.solve(b4, tol=1e-8, accel="cg", precision="mixed")
    dad = device_adaptive_sa_setup(A, grid=(2048, 2048), stages=2)

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
from .aggregation import rootnode_solver, smoothed_aggregation_solver
from .classical import ruge_stuben_solver
from .convert import (block_solver_from_jax, hierarchy_from_jax,
                      structured_solver_from_jax,
                      unstructured_solver_from_jax)
from .engine import (BlockStructuredDeviceSolver, ComposedWindowed,
                     DeviceHierarchy, DeviceMultilevelSolver,
                     NeumannAIRRestriction, ReorderedSolver,
                     StructuredDeviceSolver, as_device_solver,
                     compile_hierarchy, detect_grid,
                     device_adaptive_sa_setup, device_air_setup,
                     device_rs_setup, device_sa_setup, device_sa_setup_block,
                     device_unstructured_air_setup,
                     device_unstructured_rs_setup,
                     device_unstructured_sa_setup)
from .gallery import (advection_2d, diffusion_stencil_2d, gradgradform,
                      linear_elasticity, poisson, recirc_flow,
                      regular_triangle_mesh, stencil_grid)
from .multilevel import MultilevelSolver
from .parallel import (halo_width, initialize_distributed, make_halo_dia_spmv,
                       make_solver_mesh, shard_hierarchy, shard_vector)
from .sparse import BlockDIAMatrix, block_dia_from_scipy, dia_from_stencil

__all__ = ["BlockDIAMatrix", "BlockStructuredDeviceSolver",
           "ComposedWindowed", "DeviceHierarchy", "DeviceMultilevelSolver",
           "MultilevelSolver", "NeumannAIRRestriction", "ReorderedSolver",
           "StructuredDeviceSolver",
           "advection_2d", "as_device_solver", "backend",
           "block_dia_from_scipy", "block_solver_from_jax",
           "compile_hierarchy", "detect_grid", "device_adaptive_sa_setup",
           "device_air_setup", "device_rs_setup", "device_sa_setup",
           "device_sa_setup_block", "device_unstructured_air_setup",
           "device_unstructured_rs_setup", "device_unstructured_sa_setup",
           "diffusion_stencil_2d", "dia_from_stencil", "gradgradform",
           "halo_width", "hierarchy_from_jax", "initialize_distributed",
           "launches", "linear_elasticity",
           "make_halo_dia_spmv", "make_solver_mesh", "poisson",
           "recirc_flow", "regular_triangle_mesh", "reset_launches",
           "rootnode_solver", "ruge_stuben_solver",
           "shard_hierarchy", "shard_vector", "smoothed_aggregation_solver",
           "stencil_grid",
           "structured_solver_from_jax", "unstructured_solver_from_jax"]
