"""Deterministic fault injection (the port's subset of
resilience/faults.py).

A ``FaultPlan`` names host steps (1-based, as the JAX step numbers them):

  nan_grads / inf_grads  every worker's gradients replaced by NaN or +Inf
                         -> the non-finite guard skips the step
  ckpt_write_fail        the checkpoint write of that step raises EIO on
                         every attempt -> CheckpointWriteError
  ckpt_corrupt           the checkpoint file of that step is truncated to
                         half its size once written -> the CRC check
                         fails, --resume quarantines it and falls back
  slow_steps (slow_s)    a host stall of slow_s seconds (default 1.5)
                         inside the step phase -> the straggler watchdog
                         and its storm escalation
  sigterm                one step number: the process SIGTERMs itself at
                         that step boundary -> the graceful stop, a final
                         checkpoint, a clean --resume

Serve-side faults, keyed by serve-loop TICK (numbered from 1 after the
engine's warmup) or checkpoint step; the trainer ignores them:

  slow_decode            a host stall of slow_decode_s seconds (default
  (slow_decode_s)        0.05) inside the serve tick -> the queue grows,
                         driving the admission controller into shedding
  rollover_corrupt       the checkpoint file is truncated to half its size
                         the moment the engine STAGES it for rollover ->
                         the swap-time re-read aborts onto the old weights
  spike                  [rate_mult, start_s, dur_s]: a traffic burst for
                         the generator (serve/traffic.py) -> overload
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import signal
import time
from typing import Optional, Tuple

FAULTS_ENV = "PS_TPU_FAULTS"
_STEP_LISTS = ("nan_grads", "inf_grads", "slow_steps", "ckpt_write_fail", "ckpt_corrupt",
               "slow_decode", "rollover_corrupt")
_KNOWN_KEYS = set(_STEP_LISTS) | {"slow_s", "sigterm", "slow_decode_s", "spike"}


def _truncate_half(path: str) -> None:
    """Shear a file to half its size in place (faults.py:65)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size // 2, 1))


@dataclasses.dataclass
class FaultPlan:
    nan_grads: Tuple[int, ...] = ()
    inf_grads: Tuple[int, ...] = ()
    slow_steps: Tuple[int, ...] = ()
    slow_s: float = 1.5
    ckpt_write_fail: Tuple[int, ...] = ()
    ckpt_corrupt: Tuple[int, ...] = ()
    sigterm: Optional[int] = None
    # serve side: ticks / checkpoint steps / traffic modulation
    slow_decode: Tuple[int, ...] = ()
    slow_decode_s: float = 0.05
    rollover_corrupt: Tuple[int, ...] = ()
    spike: Optional[Tuple[float, float, float]] = None

    def __post_init__(self):
        self._sigterm_fired = False

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """A JSON object, or ``@path`` to a file holding one."""
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                spec = f.read()
        raw = json.loads(spec)
        if not isinstance(raw, dict):
            raise ValueError("fault plan must be a JSON object")
        unknown = sorted(set(raw) - _KNOWN_KEYS)
        if unknown:
            raise ValueError(f"unknown fault plan key(s) {unknown}; known: "
                             f"{sorted(_KNOWN_KEYS)}")
        kw = {}
        for k in _STEP_LISTS:
            v = raw.get(k) or []
            # bool is an int subclass: [true] would silently hit step 1
            if not isinstance(v, list) or any(
                    isinstance(s, bool) or not isinstance(s, int) for s in v):
                raise ValueError(f"fault plan {k!r} must be a list of integer steps")
            kw[k] = tuple(sorted(v))
        sig = raw.get("sigterm")
        if sig is not None and (isinstance(sig, bool) or not isinstance(sig, int)):
            raise ValueError(f"fault plan 'sigterm' must be a single step number "
                             f"(the process can only die once), got {sig!r}")
        slow_s = float(raw.get("slow_s", cls.slow_s))
        if slow_s < 0:
            raise ValueError(f"fault plan 'slow_s' must be >= 0, got {slow_s}")
        slow_decode_s = float(raw.get("slow_decode_s", cls.slow_decode_s))
        if slow_decode_s < 0:
            raise ValueError(f"fault plan 'slow_decode_s' must be >= 0, got {slow_decode_s}")
        spike = raw.get("spike")
        if spike is not None:
            if not isinstance(spike, (list, tuple)) or len(spike) != 3 or any(
                    isinstance(x, bool) or not isinstance(x, (int, float)) for x in spike):
                raise ValueError(f"fault plan 'spike' must be [rate_mult, start_s, dur_s] "
                                 f"(three numbers), got {spike!r}")
            mult, start_s, dur_s = (float(x) for x in spike)
            if mult <= 0 or start_s < 0 or dur_s <= 0:
                raise ValueError(f"fault plan 'spike' needs rate_mult > 0, start_s >= 0, "
                                 f"dur_s > 0, got {spike!r}")
            spike = (mult, start_s, dur_s)
        return cls(slow_s=slow_s, sigterm=sig, slow_decode_s=slow_decode_s, spike=spike, **kw)

    def poison(self, host_step: int) -> Optional[float]:
        """The value every gradient element takes at ``host_step``, or
        None when the plan leaves that step alone."""
        if host_step in self.inf_grads:  # applied after NaN in JAX: it wins
            return float("inf")
        if host_step in self.nan_grads:
            return float("nan")
        return None

    def maybe_sleep(self, step: int) -> None:
        """Stall the host inside the step phase (straggler injection)."""
        if step in self.slow_steps:
            time.sleep(self.slow_s)

    def maybe_sigterm(self, step: int) -> None:
        """Deliver SIGTERM to this process once, at the planned step."""
        if self.sigterm == step and not self._sigterm_fired:
            self._sigterm_fired = True
            os.kill(os.getpid(), signal.SIGTERM)

    def maybe_fail_ckpt_write(self, step: int) -> None:
        """Raise EIO from inside the checkpoint writer, on every retry
        attempt of the step, so the failure surfaces."""
        if step in self.ckpt_write_fail:
            raise OSError(errno.EIO, f"injected checkpoint write failure (step {step})")

    def maybe_corrupt_ckpt(self, path: str, step: int) -> None:
        """Truncate the just-written checkpoint to half its size."""
        if step in self.ckpt_corrupt:
            _truncate_half(path)

    def maybe_slow_decode(self, tick: int, sleep=time.sleep) -> None:
        """Stall the host inside a serve tick; ``sleep`` is injectable so
        a virtual-clock test advances its clock instead of sleeping."""
        if tick in self.slow_decode:
            sleep(self.slow_decode_s)

    def maybe_corrupt_staged(self, path: str, step: int) -> None:
        """Truncate a checkpoint the serving engine just STAGED for
        rollover, as ``maybe_corrupt_ckpt`` truncates a written one."""
        if step in self.rollover_corrupt:
            _truncate_half(path)


def resolve_fault_plan(spec: Optional[str]) -> Optional[FaultPlan]:
    """Explicit spec first (the CLI flag), else the env var, else None."""
    spec = spec or os.environ.get(FAULTS_ENV) or None
    return FaultPlan.parse(spec) if spec else None
