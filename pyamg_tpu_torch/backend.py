"""Device resolution and the numerics switches of the PyTorch port.

Importing this module turns reduced-precision float32 products off for
the whole process: the coarse pseudo-inverse and every ``DenseOperator``
product sit inside each V-cycle, and a TF32 product (about three decimal
digits) would degrade the preconditioner the way the TPU's default
``Precision`` did before the JAX package pinned ``HIGHEST``
(``pyamg_tpu/engine/hierarchy.py::DeviceHierarchy.coarse_solve``,
``pyamg_tpu/sparse/dia.py::DenseOperator.matvec``).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "require_cuda", "set_full_precision"]


def set_full_precision():
    """Keep every float32 matrix product and convolution in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


set_full_precision()


def require_cuda() -> torch.device:
    """The CUDA device; raises when PyTorch sees no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("pyamg_tpu_torch: no CUDA device is available "
                           "(torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """``device`` (a string or torch.device) as a torch.device.

    A CUDA device must exist: asking for one without a GPU raises instead
    of running somewhere else."""
    if device is None:
        raise ValueError("pass device= explicitly ('cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
