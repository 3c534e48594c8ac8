"""Armon in JAX: a 2D compressible-hydrodynamics engine.

A JAX/XLA rebuild of the capabilities of Keluaa/Armon.jl (see SURVEY.md for
the structural map): a dimensionally-split Lagrange-projection finite-volume
solver for compressible non-viscous fluids.

Public API (parity with `src/Armon.jl:15-16`):
    ArmonParameters, armon, SolverStats, data_type, memory_required,
    device_to_host, host_to_device
"""

from .params import ArmonParameters, data_type, memory_required
from .core.solver import armon, SolverStats, device_to_host, host_to_device, gather_state
from .core.state import State, MAIN_VARS, SAVED_VARS, COMM_VARS
from .core.config import SolverConfig
from .utils.errors import SolverException
from .utils.enums import Axis, Side
from .models.cases import (
    TestCase, Sod, SodY, SodCirc, Bizarrium, Sedov, DebugIndexes, test_from_name,
)

__version__ = "0.1.0"

__all__ = [
    "ArmonParameters", "armon", "SolverStats", "data_type", "memory_required",
    "device_to_host", "host_to_device", "gather_state",
    "State", "MAIN_VARS", "SAVED_VARS", "COMM_VARS", "SolverConfig",
    "SolverException", "Axis", "Side",
    "TestCase", "Sod", "SodY", "SodCirc", "Bizarrium", "Sedov",
    "DebugIndexes", "test_from_name",
]
