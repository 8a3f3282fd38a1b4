"""What the per-layer metrics' readers share. A reader is
``portbench/metrics/<metric>.py`` with ``read(facts) -> float or None``;
``facts`` holds the cell, the window, the spans of the window's steps,
the capture's ``DeviceTrace`` (over ``trace.steps`` steps), the
allocator's peak over the window, the driver's ``work`` counts and the
card's name. A reader that finds nothing to read returns None and the
metric is left out of the result.
"""

from __future__ import annotations

from typing import Optional, Sequence

from . import costs


def matcher(include: Sequence[str], exclude: Sequence[str] = ()):
    return lambda name: (any(k in name for k in include)
                         and not any(k in name for k in exclude))


def device_ms_per_step(trace, include: Sequence[str], exclude: Sequence[str] = ()
                       ) -> Optional[float]:
    match = matcher(include, exclude)
    if trace.count(match) == 0:
        return None
    return trace.sum_us(match) / 1e3 / trace.steps


def span_ms(spans, name: str) -> Optional[float]:
    d = [s["dur"] for s in spans if s["name"] == name]
    return 1e3 * sum(d) / len(d) if d else None


def kernels_per_step(trace) -> float:
    return len(trace.kernels) / trace.steps


def idle_share(trace) -> float:
    return 100.0 * (1.0 - trace.busy_us() / trace.span_us())


def peak(facts) -> Optional[dict]:
    return costs.peaks(facts["device_kind"])


def roofline(trace, include: Sequence[str], bound_per_launch_s: float,
             launches_from: Sequence[str] = None) -> Optional[float]:
    """100 x (launches x the least time a launch could take) over the
    device time of the kernels ``include`` matches; ``launches_from``
    names the kernel whose count is the number of launches (default:
    ``include``)."""
    match = matcher(include)
    n = trace.count(matcher(launches_from or include))
    t_us = trace.sum_us(match)
    if n == 0 or t_us <= 0:
        return None
    return 100.0 * n * bound_per_launch_s / (t_us / 1e6)
