"""The host hierarchy container of the port's host setups (the level half of
``pyamg_tpu/multilevel.py::MultilevelSolver``).  It holds the levels'
scipy operators and smoother specs for the device compile
(``engine/hierarchy.py::compile_hierarchy``); it has no host solve."""

from __future__ import annotations

__all__ = ["MultilevelSolver"]


class MultilevelSolver:
    """A multigrid hierarchy: the list of levels."""

    class Level:
        """One grid level: ``A``; ``P`` and ``R`` on all but the coarsest;
        ``B`` (the candidates), ``R_is_PT``, the smoother specs and, as
        the setup records them, ``splitting`` (Ruge-Stuben; the compile's
        C/F smoothers read it) and ``Cnodes`` / ``Cpts`` / ``Fpts``
        (rootnode)."""

        def __init__(self):
            self.A = None
            self.P = None
            self.R = None

    def __init__(self, levels):
        self.levels = levels
