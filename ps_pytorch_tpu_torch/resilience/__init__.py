"""Resilience of the port: the non-finite gradient guard (``guard``),
fault injection (``faults``), I/O retry with backoff (``retry``), the
elastic geometry manifest and the adaptive aggregation controller
(``elastic``), and the adaptive precision controller (``precision``)."""

from .elastic import (
    AdaptiveMaskController,
    MeshGeometry,
    geometry_of,
    load_geometry,
    needs_reshape,
    reshape_raw_state,
    save_geometry,
)
from .faults import FaultPlan, resolve_fault_plan
from .guard import GuardState, init_guard_state, tree_all_finite, update_guard_state
from .precision import PrecisionController, effective_wire_bytes
from .retry import retry_io

__all__ = [
    "AdaptiveMaskController",
    "FaultPlan",
    "GuardState",
    "MeshGeometry",
    "PrecisionController",
    "effective_wire_bytes",
    "geometry_of",
    "init_guard_state",
    "load_geometry",
    "needs_reshape",
    "reshape_raw_state",
    "resolve_fault_plan",
    "retry_io",
    "save_geometry",
    "tree_all_finite",
    "update_guard_state",
]
