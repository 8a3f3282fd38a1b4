"""Deterministic fault injection, gradient half (the port's subset of
resilience/faults.py).

A ``FaultPlan`` names the host steps (1-based, as the JAX step numbers
them) whose gradients are replaced by NaN or +Inf on every worker: the
chaos drill that proves the non-finite guard end to end. The plan's
other keys (slow steps, checkpoint faults, SIGTERM, the serving side)
are not ported yet and raise (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

FAULTS_ENV = "PS_TPU_FAULTS"
_PORTED = ("nan_grads", "inf_grads")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    nan_grads: Tuple[int, ...] = ()
    inf_grads: Tuple[int, ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """A JSON object, or ``@path`` to a file holding one."""
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                spec = f.read()
        raw = json.loads(spec)
        if not isinstance(raw, dict):
            raise ValueError("fault plan must be a JSON object")
        rest = sorted(set(raw) - set(_PORTED))
        if rest:
            raise NotImplementedError(
                f"fault plan keys {rest} are not ported yet (only {list(_PORTED)}; "
                f"see ROADMAP.md queue 1 item 15)"
            )
        return cls(**{k: tuple(int(s) for s in raw[k]) for k in raw})

    def poison(self, host_step: int) -> Optional[float]:
        """The value every gradient element takes at ``host_step``, or
        None when the plan leaves that step alone."""
        if host_step in self.inf_grads:  # applied after NaN in JAX: it wins
            return float("inf")
        if host_step in self.nan_grads:
            return float("nan")
        return None


def resolve_fault_plan(spec: Optional[str]) -> Optional[FaultPlan]:
    """Explicit spec first (the CLI flag), else the env var, else None."""
    spec = spec or os.environ.get(FAULTS_ENV) or None
    return FaultPlan.parse(spec) if spec else None
