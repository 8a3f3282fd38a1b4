"""Bounded ``torch.profiler`` capture windows for the training loops (the
port of obs/profiler.py).

``--profile-dir`` captures a profiler trace of the step window ``[start,
start + n)``: host events, plus the card's kernels when the run is on
the card. The trace is a Chrome trace (``chrome://tracing``, Perfetto)
written under the directory when the window stops; the host spans of
obs/trace.py appear in it by name when the loop's tracer runs with
``annotate=True`` (``record_function`` scopes).

The one deliberate host wait lives here: stopping a capture waits for
the window's device work to retire, or the trace ends mid-step. It runs
once a capture, never a step.

The profiler places the card's events on the host's clock with an error
that differs from capture to capture: on an H100, one capture in seven put
kernels up to 5.8 ms before the calls that launched them
(``tools/profiler_sessions``), and the events it places before the
capture's start are dropped, all of a short capture's at worst. So every
capture on the card here (``ProfileWindow``, ``padded_profile``) begins
and ends with ``CAPTURE_PAD_S`` of host time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from ..utils import get_logger

logger = get_logger()

# host time at both ends of a capture on the card: over three times the
# largest misplacement of device events measured (5.8 ms)
CAPTURE_PAD_S = 0.02


@contextlib.contextmanager
def padded_profile():
    """``torch.profiler.profile`` of the host and the card over the block,
    with ``CAPTURE_PAD_S`` of host time after the start and, once the card
    has retired the block's work, before the stop, so no device event of
    the block lands outside the capture."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(CAPTURE_PAD_S)
        yield prof
        torch.cuda.synchronize()  # psl: sync-ok (once a capture, as ProfileWindow's stop)
        time.sleep(CAPTURE_PAD_S)


class ProfileWindow:
    """Start / stop ``torch.profiler`` around steps ``[start, start+n)``.

    Drive it with ``before_step(step)`` immediately before dispatching
    ``step``, and ``close()`` (idempotent) from a ``finally`` block, so a
    run that ends or raises inside the window still writes its trace.
    Stopping a capture on the card makes one ``torch.cuda.synchronize()``,
    so the trace holds the window's device work; on the CPU that work is
    done when dispatched. ``device`` picks the activities: CPU, and CUDA
    when the run is on the card.

    After a capture, ``trace_path`` names the file and ``host_s`` holds
    the capture's one-time host seconds: starting the profiler, the wait
    at its end, the pads at both ends on the card, stopping it and
    writing the trace."""

    def __init__(self, profile_dir: Optional[str], start_step: int,
                 num_steps: int = 10, device=None):
        # validate only when profiling is asked for: the trainer builds
        # this unconditionally, and a stray --profile-steps 0 without
        # --profile-dir must not abort the run it does not affect
        if profile_dir is not None and num_steps < 1:
            raise ValueError(f"profile window needs >= 1 step, got {num_steps}")
        self.dir = profile_dir
        self.start = int(start_step)
        self.stop = int(start_step) + int(num_steps)
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.active = False
        self.trace_path: Optional[str] = None
        self.host_s = 0.0
        self._prof = None

    def before_step(self, step: int) -> None:
        if self.dir is None:
            return
        if not self.active and self.start <= step < self.stop:
            t0 = time.perf_counter()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            if self.cuda:
                time.sleep(CAPTURE_PAD_S)
            self.active = True
            self.host_s += time.perf_counter() - t0
            logger.info("profiler capture started: steps [%d, %d) -> %s",
                        self.start, self.stop, self.dir)
        elif self.active and step >= self.stop:
            self._finish()

    def close(self) -> None:
        """Stop an open capture (the run ended or raised inside the window)."""
        if self.active:
            self._finish()

    def _finish(self) -> None:
        t0 = time.perf_counter()
        # once a CAPTURE, not a step: the trace must hold the window's
        # retired device work
        if self.cuda:
            torch.cuda.synchronize()  # psl: sync-ok
            time.sleep(CAPTURE_PAD_S)
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.dir, f"steps_{self.start}_{self.stop}_pid{os.getpid()}.pt.trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self.active = False
        self.host_s += time.perf_counter() - t0
        logger.info("profiler trace written to %s (%.3f s of host time)",
                    self.trace_path, self.host_s)
