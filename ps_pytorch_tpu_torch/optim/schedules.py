"""Learning-rate schedules of the LM trainer (cli/train_lm.py:158-174),
as plain functions of the optimizer's step count (the port of the optax
schedules it builds: ``constant_schedule``, ``linear_schedule``,
``join_schedules``, ``warmup_cosine_decay_schedule``).

A schedule maps the count (an int, or the ``SGDState`` device int32
tensor, which ``SGD`` hands it) to the rate; tensor in, f32 tensor out on
the same device, with optax's formulas in f32.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[object], object]


def _f32(x, like=None) -> torch.Tensor:
    device = None if like is None else like.device
    return torch.as_tensor(x, device=device).to(torch.float32)


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``transition_steps``, then
    end; a non-positive ``transition_steps`` holds ``init_value``."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        c = torch.clamp(_f32(count), 0, transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: ``schedules[i + 1]`` from ``boundaries[i]``
    on, fed the steps since that boundary."""

    def schedule(count):
        c = _f32(count)
        out = _f32(schedules[0](c), c)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(c < boundary, out, _f32(sched(c - boundary), c))
        return out

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = torch.clamp(_f32(count), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warm-up to the peak,
    then cosine decay to ``end_value`` by ``decay_steps`` (warm-up
    included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps],
    )
