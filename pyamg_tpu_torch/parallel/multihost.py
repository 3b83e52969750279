"""Process-group bring-up (counterpart of
``pyamg_tpu/parallel/multihost.py``).

JAX starts one controller per host (``jax.distributed.initialize``) and
sees every device of the slice in one program.  PyTorch's idiom is SPMD:
one process per rank, one rank per GPU, each process driving its own card
and talking to the others through ``torch.distributed`` (NCCL for CUDA
tensors, gloo for CPU ones).  This module wraps that bootstrap so solver
code stays identical from a world of one to many ranks.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..backend import resolve_device

__all__ = ["initialize_distributed", "rank_device"]

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def rank_device(device=None, rank=None):
    """The device a rank drives: ``device`` as given, else its CUDA card
    (``LOCAL_RANK``, or the rank modulo the card count, as ``torchrun``
    places one rank per GPU).  Raises where torch sees no GPU unless the
    caller asks for the CPU."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)                  # raises without a card
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else int(
            os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK",
                               rank % torch.cuda.device_count()))
    return resolve_device(f"cuda:{local}")


def initialize_distributed(init_method=None, world_size=None, rank=None,
                           device=None):
    """Initialise ``torch.distributed`` (idempotent); returns ``(rank,
    world_size, device_count)``, ``device_count`` being the world's
    devices, one per rank.

    The rendezvous is ``init_method`` (``"file://..."``,
    ``"tcp://host:port"``) with ``world_size`` and ``rank``, else the
    usual environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets it).  With neither, a single
    process gets a world of one on an in-memory store, as the JAX function
    falls back to one process.  The backend is NCCL when the rank's
    device is CUDA (``device=None`` means its card) and gloo for
    ``device="cpu"``.  A failed rendezvous raises."""
    if not dist.is_initialized():
        env = all(k in os.environ for k in _ENV)
        dev = rank_device(device, rank if rank is not None else (
            int(os.environ["RANK"]) if env else 0))
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if init_method is not None or env:
            kwargs = {}
            if world_size is not None:
                kwargs["world_size"] = int(world_size)
            if rank is not None:
                kwargs["rank"] = int(rank)
            dist.init_process_group(backend, init_method=init_method or
                                    "env://", **kwargs)
        else:
            if world_size not in (None, 1) or rank not in (None, 0):
                raise ValueError("a world of more than one rank needs an "
                                 "init_method or the RANK / WORLD_SIZE / "
                                 "MASTER_ADDR environment")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    world = dist.get_world_size()
    return dist.get_rank(), world, world
