"""Device compute: batched small linear solves and the masked
Newton/homotopy subsystem solver of the scan engine."""

from .linsolve import solve_dense
from .newton import make_subsystem_solver

__all__ = ["solve_dense", "make_subsystem_solver"]
