"""Device solve engine (counterpart of ``pyamg_tpu/engine``)."""

from ..sparse.dia import dia_from_stencil
from .device_setup import (StructuredDeviceSolver, detect_grid,
                           device_sa_setup, dia_transpose)
from .hierarchy import DeviceHierarchy, DeviceLevel, compile_hierarchy
from .krylov import device_cg
from .relaxation import DeviceSmoother
from .solver import DeviceMultilevelSolver, as_device_solver

__all__ = ["DeviceHierarchy", "DeviceLevel", "DeviceMultilevelSolver",
           "DeviceSmoother", "StructuredDeviceSolver", "as_device_solver",
           "compile_hierarchy", "detect_grid", "device_cg", "device_sa_setup",
           "dia_from_stencil", "dia_transpose"]
