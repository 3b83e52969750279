"""Smoothed-aggregation and rootnode host setups of the port (copies
from ``pyamg_tpu/aggregation``)."""

from .aggregation import smoothed_aggregation_solver
from .rootnode import rootnode_solver

__all__ = ["smoothed_aggregation_solver", "rootnode_solver"]
