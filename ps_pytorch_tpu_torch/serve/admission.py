"""SLO-aware admission control with load shedding (the port's own copy
of the JAX package's serve/admission.py: pure host, the same decisions
and the same ``admission_adapt`` records).

The serving engine's front door under overload: when arrivals outrun
the decode capacity, the queue — not the decode step — eats the p99.
Shedding at submit time converts a traffic spike into bounded TTFT for
the admitted and an explicit, evented refusal for the rest. The
projected queue wait for a NEW arrival is

    projected_wait_s = queue_depth / drain_rate

where ``drain_rate`` is the admissions-per-second measured over the
last closed window — how fast the queue's head actually moved, which
already folds in slot count, decode speed, injected stalls, and
rollover drains. Policy:

- ENTER shedding the moment a submit's projected wait exceeds the SLO
  budget;
- while shedding, refuse arrivals subject to a bounded shed rate: at
  most ``shed_max_frac`` of a window's submits are shed, so a trickle
  always gets through and the drain-rate estimate keeps refreshing;
- EXIT shedding only after ``recover_windows`` consecutive window
  closes with projected wait under ``recover_frac`` x budget
  (hysteresis).

The controller never observes device state and the engine applies its
decisions only at submit time, so it can degrade goodput but never
corrupt a decode.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

# projected waits are capped finite so the evidence fields stay valid
# JSON (a zero drain rate would otherwise project infinity)
_WAIT_CAP_S = 1e9


class AdmissionController:
    """Windowed submit-time load shedding against an SLO budget.

    The engine feeds it three signals, all on the scheduler clock:
    ``observe_tick(now, queue_depth)`` once per tick (rolls the window),
    ``record_admit(now)`` per admission (the drain-rate numerator), and
    ``offered(now, queue_depth)`` per submit — which returns
    ``(shed, projected_wait_s)``, the decision plus its evidence."""

    def __init__(
        self,
        slo_budget_s: float,
        window_s: float = 0.25,
        shed_max_frac: float = 0.9,
        recover_frac: float = 0.5,
        recover_windows: int = 2,
        event_sink: Optional[Callable[[dict], None]] = None,
    ):
        if slo_budget_s <= 0:
            raise ValueError(f"slo_budget_s must be > 0, got {slo_budget_s}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if not 0.0 < shed_max_frac <= 1.0:
            raise ValueError(
                f"shed_max_frac must be in (0, 1], got {shed_max_frac}"
            )
        if not 0.0 < recover_frac < 1.0:
            raise ValueError(
                f"recover_frac must be in (0, 1), got {recover_frac}"
            )
        if recover_windows < 1:
            raise ValueError(
                f"recover_windows must be >= 1, got {recover_windows}"
            )
        self.slo_budget_s = float(slo_budget_s)
        self.window_s = float(window_s)
        self.shed_max_frac = float(shed_max_frac)
        self.recover_frac = float(recover_frac)
        self.recover_windows = int(recover_windows)
        self.shedding = False
        self.shed_total = 0
        self.admitted_total = 0
        self.windows_closed = 0
        self.adaptations = 0          # shedding state flips
        self._sink = event_sink
        self._drain_rate: Optional[float] = None  # req/s, last closed window
        self._win_start: Optional[float] = None
        self._win_admits = 0
        self._win_submits = 0
        self._win_sheds = 0
        self._clean = 0               # consecutive recovered windows
        self._depth = 0               # queue depth at the last signal

    # ------------------------------------------------------------- signals
    def observe_tick(self, now_s: float, queue_depth: int) -> None:
        """Per-tick heartbeat: tracks queue depth and closes windows on
        schedule even when no submits arrive (recovery needs closes)."""
        self._roll(now_s, queue_depth)

    def record_admit(self, now_s: float) -> None:
        """One request left the queue for a slot — the drain-rate
        numerator."""
        self._win_admits += 1
        self.admitted_total += 1

    def offered(self, now_s: float, queue_depth: int) -> Tuple[bool, float]:
        """Submit-time decision for one arrival: (shed?, projected wait).
        The projected wait is the evidence either way — the engine puts
        it in the ``request_shed`` event."""
        self._roll(now_s, queue_depth)
        self._win_submits += 1
        projected = self.projected_wait_s(queue_depth)
        if not self.shedding and projected > self.slo_budget_s:
            self.shedding = True
            self._clean = 0
            self.adaptations += 1
            self._emit("shedding", projected)
        if (
            self.shedding
            and self._win_sheds + 1 <= self.shed_max_frac * self._win_submits
        ):
            self._win_sheds += 1
            self.shed_total += 1
            return True, projected
        return False, projected

    # ------------------------------------------------------------ modeling
    def projected_wait_s(self, queue_depth: int) -> float:
        """Expected queue wait for an arrival landing behind
        ``queue_depth`` requests, at the last closed window's drain rate.
        0.0 while no evidence exists (never shed before the first window
        of admissions) and for an empty queue (next free slot admits)."""
        if queue_depth <= 0 or self._drain_rate is None:
            return 0.0
        if self._drain_rate <= 0.0:
            return _WAIT_CAP_S
        return min(queue_depth / self._drain_rate, _WAIT_CAP_S)

    # ------------------------------------------------------------- windows
    def _roll(self, now_s: float, queue_depth: int) -> None:
        self._depth = int(queue_depth)
        if self._win_start is None:
            self._win_start = now_s
            return
        if now_s < self._win_start:
            # the clock was rebased under us (run_open_loop re-zeros the
            # engine clock at drive start): restart the window on the
            # new timeline instead of never closing again
            self._win_start = now_s
            self._win_admits = 0
            self._win_submits = 0
            self._win_sheds = 0
            return
        if now_s - self._win_start >= self.window_s:
            self._close(now_s)

    def _close(self, now_s: float) -> None:
        elapsed = max(now_s - self._win_start, 1e-9)
        if self._win_admits and elapsed <= 2.0 * self.window_s:
            # only a window that actually admitted updates the estimate
            # (an idle window carries no drain evidence, and a shedding
            # window's bounded leak-through keeps admits flowing), and
            # only a window that closed ON TIME: an engine that idled
            # through a traffic lull closes its open window at the next
            # signal with lull-inflated elapsed time, and dividing the
            # pre-lull admits by it would collapse the rate estimate and
            # shed the first healthy burst after the lull
            self._drain_rate = self._win_admits / elapsed
        self.windows_closed += 1
        if self.shedding:
            projected = self.projected_wait_s(self._depth)
            if projected <= self.recover_frac * self.slo_budget_s:
                self._clean += 1
                if self._clean >= self.recover_windows:
                    self.shedding = False
                    self._clean = 0
                    self.adaptations += 1
                    self._emit("admitting", projected)
            else:
                self._clean = 0
        self._win_start = now_s
        self._win_admits = 0
        self._win_submits = 0
        self._win_sheds = 0

    def _emit(self, state: str, projected: float) -> None:
        if self._sink is not None:
            self._sink({
                "kind": "admission_adapt",
                "state": state,
                "projected_wait_s": round(projected, 6),
                "queue_depth": self._depth,
                "window_submits": self._win_submits,
                "window_sheds": self._win_sheds,
                "windows": self.windows_closed,
                "slo_budget_s": self.slo_budget_s,
            })
