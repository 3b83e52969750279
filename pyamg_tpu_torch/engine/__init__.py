"""Device solve engine (counterpart of ``pyamg_tpu/engine``)."""

from ..sparse.dia import dia_from_stencil
from .block_setup import (BlockStructuredDeviceSolver,
                          BlockStructuredProlongator,
                          BlockStructuredRestrictor, device_sa_setup_block)
from .batched_cycle import (interleaved_batched_cg, interleaved_zero_vcycle,
                            supports_interleaved)
from .classical_setup import (EmbeddedProlongator, EmbeddedRestrictor,
                              device_air_setup, device_rs_setup)
from .device_setup import (StructuredDeviceSolver, detect_grid,
                           device_adaptive_sa_setup, device_sa_setup,
                           dia_transpose)
from .hierarchy import DeviceHierarchy, DeviceLevel, compile_hierarchy
from .krylov import (device_bicgstab, device_cg, device_cgne, device_cgnr,
                     device_cr, device_fgmres, device_gmres,
                     device_minimal_residual, device_steepest_descent)
from .relaxation import (DeviceSmoother, apply_smoother,
                         apply_smoother_zero)
from .setup import (device_bellman_ford, device_jp_coloring, device_luby_mis,
                    device_pmis_splitting, device_strength_mask,
                    neighbor_reduce_max, neighbor_reduce_min_plus)
from .solver import DeviceMultilevelSolver, as_device_solver
from .unstructured_classical import (NeumannAIRRestriction,
                                     device_unstructured_air_setup,
                                     device_unstructured_rs_setup)
from .unstructured_setup import (ComposedWindowed, ReorderedSolver,
                                 device_unstructured_sa_setup)

__all__ = ["BlockStructuredDeviceSolver", "BlockStructuredProlongator",
           "BlockStructuredRestrictor", "ComposedWindowed",
           "DeviceHierarchy", "DeviceLevel",
           "DeviceMultilevelSolver", "DeviceSmoother", "EmbeddedProlongator",
           "EmbeddedRestrictor", "NeumannAIRRestriction", "ReorderedSolver",
           "StructuredDeviceSolver", "apply_smoother", "apply_smoother_zero",
           "as_device_solver", "compile_hierarchy",
           "detect_grid", "device_adaptive_sa_setup", "device_air_setup",
           "device_bellman_ford",
           "device_bicgstab", "device_cg", "device_cgne",
           "device_cgnr", "device_cr", "device_fgmres", "device_gmres",
           "device_jp_coloring", "device_luby_mis",
           "device_minimal_residual", "device_pmis_splitting",
           "device_rs_setup", "device_sa_setup", "device_sa_setup_block",
           "device_steepest_descent", "device_strength_mask",
           "device_unstructured_air_setup", "device_unstructured_rs_setup",
           "device_unstructured_sa_setup", "dia_from_stencil",
           "dia_transpose", "interleaved_batched_cg",
           "interleaved_zero_vcycle", "neighbor_reduce_max",
           "neighbor_reduce_min_plus", "supports_interleaved"]
