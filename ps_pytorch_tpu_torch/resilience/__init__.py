"""Resilience of the port: the non-finite gradient guard (``guard``),
fault injection (``faults``), I/O retry with backoff (``retry``), the
elastic geometry manifest and the adaptive aggregation controller
(``elastic``), and the adaptive precision controller (``precision``)."""

from .guard import GuardState, init_guard_state, tree_all_finite, update_guard_state

__all__ = ["GuardState", "init_guard_state", "tree_all_finite", "update_guard_state"]
