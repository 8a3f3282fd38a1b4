"""The traced run's ``torch.profiler`` capture and its reduction.

A capture waits for the card, starts the profiler (CUDA activity only:
recording every host operator as well slows a launch-heavy host enough
to idle the card, so the idle share would read the profiler), pads 20 ms
of host time, runs the captured steps, waits for
the card and pads 20 ms again before it stops: the profiler places some
device events up to 5.8 ms away from their launches on an H100 and drops
those outside the capture (``ps_pytorch_tpu_torch/obs/profiler.py``, the
idea copied here). The Chrome trace is written under ``TMPDIR``, parsed
and deleted.

``DeviceTrace`` holds the device events (kernels, copies, fills), the
host's kernel launches and its CUDA runtime calls. A capture without a
single device event raises: an empty trace is no reading of zero.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import torch

PAD_S = 0.02
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")

Interval = Tuple[str, float, float]  # name, start us, duration us


@dataclasses.dataclass
class DeviceTrace:
    """One capture over ``steps`` steps. Times in microseconds on the
    profiler's clock."""

    device: List[Interval]
    launches: int
    runtime: List[Interval]
    steps: int

    @property
    def kernels(self) -> List[Interval]:
        return [e for e in self.device if e[0] != "memcpy" and e[0] != "memset"]

    def span_us(self) -> float:
        first = min(s for _, s, _ in self.device)
        last = max(s + d for _, s, d in self.device)
        return last - first

    def busy_us(self) -> float:
        """The union of the device events' intervals."""
        total, end = 0.0, None
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            e = s + d
            if end is None or s >= end:
                total += d
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def sum_us(self, match: Callable[[str], bool]) -> float:
        return sum(d for n, _, d in self.device if match(n))

    def count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def top_ops(self, k: int = 10) -> List[list]:
        """The device operations that took most time: [name, seconds]."""
        by: dict = {}
        for n, _, d in self.device:
            by[n] = by.get(n, 0.0) + d
        return [[n, t / 1e6] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The longest gaps between device events, each named by what the
        host was doing at the gap's middle: the CUDA runtime call open
        there, else "host" (Python between CUDA calls): [name, seconds]."""
        gaps, end = [], None
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = s + d if end is None else max(end, s + d)
        gaps.sort(reverse=True)
        out = []
        for length, at in gaps[:k]:
            mid = at + length / 2
            open_ = [(s, n) for n, s, d in self.runtime if s <= mid <= s + d]
            out.append([max(open_)[1] if open_ else "host", length / 1e6])
        return out


def reduce_chrome_trace(events: list, steps: int) -> DeviceTrace:
    device, runtime, launches = [], [], 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            label = name if cat == "kernel" else cat.replace("gpu_", "")
            device.append((label, float(ev["ts"]), float(ev.get("dur", 0.0))))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launches += name in LAUNCH_NAMES
            runtime.append((name, float(ev["ts"]), float(ev.get("dur", 0.0))))
    if not device:
        raise RuntimeError("the capture holds no device event")
    return DeviceTrace(device=device, launches=launches, runtime=runtime, steps=steps)


class Capture:
    """``start()`` / ``stop(steps)`` around the captured steps."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self.trace: Optional[DeviceTrace] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CUDA if self.device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        time.sleep(PAD_S)

    def stop(self, steps: int) -> DeviceTrace:
        self._sync()
        time.sleep(PAD_S)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.trace = reduce_chrome_trace(events, steps)
        return self.trace
