"""Native (C++) setup-phase routines of the port's host SA setup: a copy of
the five routines of ``pyamg_tpu/amg_core`` that config 1's setup calls,
built with ``g++`` at first use (``_loader.py``)."""

from ._loader import native

__all__ = ["native"]
