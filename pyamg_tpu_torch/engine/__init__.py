"""Device solve engine (counterpart of ``pyamg_tpu/engine``)."""

from .device_setup import dia_transpose
from .hierarchy import DeviceHierarchy, DeviceLevel, compile_hierarchy
from .krylov import device_cg
from .relaxation import DeviceSmoother
from .solver import DeviceMultilevelSolver, as_device_solver

__all__ = ["DeviceHierarchy", "DeviceLevel", "DeviceMultilevelSolver",
           "DeviceSmoother", "as_device_solver", "compile_hierarchy",
           "device_cg", "dia_transpose"]
