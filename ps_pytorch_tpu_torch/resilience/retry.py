"""Bounded exponential-backoff retry for checkpoint I/O (the port of
resilience/retry.py).

Checkpoints cross a shared filesystem, where transient EIO/ESTALE lives.
The delay before attempt k+1 is uniform in ``[base*2^k, base*2^k * (1 +
jitter)]``: never shorter than the deterministic schedule, never more
than ``jitter`` longer, so hosts and evaluators polling one directory do
not retry in lockstep. The noise source is injectable (``rng``, e.g. a
seeded ``random.Random`` for a reproducible schedule); the default one is
seeded from OS entropy. The last failure propagates unchanged, so callers
keep the real errno.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

logger = logging.getLogger("ps_pytorch_tpu_torch")

_DEFAULT_RNG = random.Random()

# up to +25% per delay: enough to spread a retry herd over the backoff
# window, small enough to keep the budget within ~1.25x the schedule
DEFAULT_JITTER = 0.25


def retry_io(
    fn: Callable[[], T],
    desc: str,
    attempts: int = 3,
    base_delay_s: float = 0.05,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    jitter: float = DEFAULT_JITTER,
    rng: Optional[random.Random] = None,
) -> T:
    """Call ``fn()`` up to ``attempts`` times, sleeping ``base*2^k * (1 +
    jitter*u)`` with ``u ~ U[0,1)`` between tries (``jitter=0``: the
    deterministic schedule). Only ``retry_on`` exceptions are retried
    (default OSError: corruption is not transient)."""
    if jitter < 0:
        raise ValueError(f"jitter must be >= 0, got {jitter}")
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            delay = base_delay_s * (2 ** attempt)
            if jitter:
                delay *= 1.0 + jitter * (rng or _DEFAULT_RNG).random()
            logger.warning("transient I/O failure (%s), attempt %d/%d, retrying in "
                           "%.2fs: %s", desc, attempt + 1, attempts, delay, e)
            time.sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
