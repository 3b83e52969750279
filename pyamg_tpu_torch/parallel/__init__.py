"""Distributed execution over ranks (counterpart of ``pyamg_tpu/parallel``).

The reference shards every level's operators over a 1-D JAX mesh and lets
GSPMD add the collectives.  Here the design is SPMD, PyTorch's idiom for
it: one process per rank (one rank per GPU, started by ``torchrun`` or
the caller), NCCL for CUDA tensors and gloo for CPU ones, every rank
holding its own row block of each level and local shards of the vectors.
The sharded operators carry their own communication: the DIA levels apply
through K16 (ring halo exchange overlapped with the interior rows), the
gathers and sums are collectives, and the Krylov dots all_reduce.

    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)

    initialize_distributed()        # RANK / WORLD_SIZE / MASTER_ADDR, or 1
    mesh = make_solver_mesh()
    dml = DeviceMultilevelSolver(shard_hierarchy(hierarchy, mesh))
    x = dml.solve(b, tol=1e-8, accel="cg")   # numpy b: the full x

Importing this package initialises nothing.
"""

from .dist_spmv import halo_width, make_halo_dia_spmv
from .multihost import initialize_distributed
from .partition import (
    make_solver_mesh,
    shard_hierarchy,
    shard_vector,
)

__all__ = [
    "halo_width",
    "make_halo_dia_spmv",
    "initialize_distributed",
    "make_solver_mesh",
    "shard_hierarchy",
    "shard_vector",
]
