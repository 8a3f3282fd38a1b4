"""Device-side non-finite gradient guard (the port of resilience/guard.py).

The train step reduces every worker's gradients to one all-finite flag
(the stacked backend's pmin is an ``all`` over the worker dimension) and
selects the whole state update against it with ``torch.where``: a bad
step applies the identity instead of the optimizer. The flag never
leaves the device; the counters ride the metrics the host already reads
once per log window.

Dynamic loss scaling: the loss is multiplied by ``scale`` before
backprop and the gradients divided by it after; the scale halves on
every skipped step and doubles after ``growth_interval`` consecutive
good steps.
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.buckets import tree_leaves

MIN_LOSS_SCALE = 1.0
MAX_LOSS_SCALE = float(2 ** 24)


@dataclasses.dataclass
class GuardState:
    """Guard counters (device scalars): ``skipped`` steps so far,
    ``consec`` the current skip streak, ``good`` the current streak of
    finite steps, ``scale`` the live loss scale (1.0 without dynamic
    scaling), ``dyn`` 1 iff dynamic scaling produced this state."""

    skipped: torch.Tensor
    consec: torch.Tensor
    good: torch.Tensor
    scale: torch.Tensor
    dyn: torch.Tensor


def init_guard_state(loss_scale: float = 1.0, dynamic: bool = False,
                     device=None) -> GuardState:
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return GuardState(skipped=i32(0), consec=i32(0), good=i32(0),
                      scale=torch.tensor(loss_scale, dtype=torch.float32, device=device),
                      dyn=i32(int(dynamic)))


def reconcile_guard_state(stored: dict, fresh: dict) -> dict:
    """Merge a checkpointed guard-state dict into the current config's
    fresh one (both state dicts; guard.py:73 of the JAX package). Stored
    counters win, but a dynamic-OFF checkpoint (dyn 0) resumed with
    dynamic scaling on starts from the fresh loss scale; the dyn flag
    always reflects the current config."""
    sd, td = stored.get("dyn"), fresh.get("dyn")
    if sd is not None and td is not None:
        if int(td) == 1 and int(sd) == 0:
            stored["scale"] = fresh.get("scale")
        stored["dyn"] = td
    return stored


def tree_all_finite(tree) -> torch.Tensor:
    """Device bool scalar: every element of every leaf is finite."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(leaf).all() for leaf in leaves]).all()


def update_guard_state(g: GuardState, finite: torch.Tensor,
                       dynamic_loss_scale: bool, growth_interval: int) -> GuardState:
    """One step of the counters and the loss scale (grow on success,
    back off on overflow)."""
    bad = (~finite).to(torch.int32)
    zero = torch.zeros_like(g.good)
    good1 = torch.where(finite, g.good + 1, zero)
    scale = g.scale
    if dynamic_loss_scale:
        do_grow = finite & (good1 >= growth_interval)
        grown = torch.where(do_grow, torch.clamp_max(g.scale * 2.0, MAX_LOSS_SCALE),
                            g.scale)
        scale = torch.where(finite, grown, torch.clamp_min(g.scale * 0.5, MIN_LOSS_SCALE))
        good1 = torch.where(do_grow, zero, good1)
    return GuardState(skipped=g.skipped + bad,
                      consec=torch.where(finite, zero, g.consec + 1),
                      good=good1, scale=scale, dyn=g.dyn)
