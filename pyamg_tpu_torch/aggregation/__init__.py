"""Smoothed-aggregation host setup of the port (copies from
``pyamg_tpu/aggregation``)."""

from .aggregation import smoothed_aggregation_solver

__all__ = ["smoothed_aggregation_solver"]
