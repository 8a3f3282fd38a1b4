"""The measured window on the card's own clock.

``start()`` waits for the card, resets the allocator's peak and records a
CUDA event; ``stepped()`` records one after each dispatched step. No
event is read until ``finish()``, so the clock adds no host wait to the
loop. The window runs from the start event to the end of the last step
that completed within ``seconds`` of it: a rate is all the steps that
completed over all the time they took, and a step time is the gap
between the ends of two consecutive steps, the card's idle time between
them included.

Off the card (the CPU tests) the same calls read the host clock: those
numbers are never printed under a device metric's name, since a run
without a card stops before a window (``run.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class Window:
    """What the window measured: the steps completed within it, its
    length (ms, start to the last of those steps' ends) and each of those
    steps' time (ms)."""

    completed: int
    dispatched: int
    window_ms: float
    step_ms: List[float]

    @property
    def window_s(self) -> float:
        return self.window_ms / 1e3

    def step_ms_p90(self) -> float:
        return float(np.percentile(self.step_ms, 90))


class StepClock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self._marks: list = []
        self._start = None
        self.t0 = None

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._start = self._mark()
        self.t0 = time.perf_counter()

    def stepped(self) -> None:
        self._marks.append(self._mark())

    @property
    def dispatched(self) -> int:
        return len(self._marks)

    def finish(self, seconds: float) -> Window:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            ends = [self._start.elapsed_time(ev) for ev in self._marks]
        else:
            ends = [(t - self._start) * 1e3 for t in self._marks]
        done = [e for e in ends if e <= seconds * 1e3]
        if not done:
            raise RuntimeError(f"no step completed within the {seconds} s window "
                               f"({len(ends)} dispatched)")
        steps = np.diff([0.0] + done).tolist()
        return Window(completed=len(done), dispatched=len(ends), window_ms=done[-1],
                      step_ms=steps)
