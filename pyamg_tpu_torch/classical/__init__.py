"""Ruge-Stuben host setup of the port (copies from
``pyamg_tpu/classical``)."""

from .classical import ruge_stuben_solver

__all__ = ["ruge_stuben_solver"]
