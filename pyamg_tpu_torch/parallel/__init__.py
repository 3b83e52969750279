"""Distributed execution over ranks (counterpart of ``pyamg_tpu/parallel``).

The reference shards every level's operators over a 1-D JAX mesh and lets
GSPMD add the collectives.  Here the design is SPMD, PyTorch's idiom for
it: one process per rank (one rank per GPU, started by ``torchrun`` or
the caller), NCCL for CUDA tensors and gloo for CPU ones, every rank
holding its own row block of each level and local shards of the vectors.
The sharded operators carry their own communication: the DIA levels apply
through K16 (ring halo exchange overlapped with the interior rows), the
block-DIA levels through B1's halo mode (the halo in whole nodes), the
transfers factor by factor, the gathers and sums are collectives, and
the Krylov dots all_reduce.  Every hierarchy the port builds shards:
host-built, unstructured, and device-built (structured SA, classical RS
and AIR, the block setup); a device-built solver keeps its grid encoding
around the sharded hierarchy.

    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)

    initialize_distributed()        # RANK / WORLD_SIZE / MASTER_ADDR, or 1
    mesh = make_solver_mesh()
    dml = DeviceMultilevelSolver(shard_hierarchy(hierarchy, mesh))
    x = dml.solve(b, tol=1e-8, accel="cg")   # numpy b: the full x
    ds = device_sa_setup(A, grid)             # device-built:
    x = StructuredDeviceSolver(shard_hierarchy(ds.hierarchy, mesh), ds.grid,
                               ds.grid_p, ds.setup_info).solve(b, tol=1e-8)

A sharded hierarchy also solves an (n, K) stack of right-hand sides (K16
and B1's halo mode on every lane at once), CGNR / CGNE (A^T of each
sharded level) and with the Cimmino and windowed Schwarz smoothers.  The
structured SA, classical RS and block setups partition their own work
over the ranks (``device_sa_setup(A, grid, mesh=mesh)``,
:mod:`.partitioned_setup`; ``device_rs_setup(A, grid, mesh=mesh)``,
:mod:`.partitioned_classical`; ``device_sa_setup_block(A, grid, B,
mesh=mesh)``, :mod:`.partitioned_block`: each rank builds only its rows
of every large level); the AIR and unstructured setups run whole and are
then sharded, and NCCL on several GPUs is not measured yet (ROADMAP.md
Queue 1 item 14).  Mixed precision on a sharded
hierarchy raises: it carries no float64 copy, as the reference's.

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
