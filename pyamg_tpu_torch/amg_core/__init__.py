"""Native (C++) setup-phase routines of the port's host setups: a copy of
the routines of ``pyamg_tpu/amg_core`` that its SA, rootnode and
Ruge-Stuben setups call, built with ``g++`` at first use
(``_loader.py``)."""

from ._loader import native

__all__ = ["native"]
