"""What a driver's window hands back, and the seed the program's own
draws take."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Measured:
    """``window`` (``clock.Window``), ``t_window`` (host clock at the
    window's start), the steps ``attempted`` in it and those that
    ``failed`` (a non-finite loss), the allocator's peak over it, the
    spans of its steps, the capture (``--trace 1``), the driver's
    ``work`` counts for the readers and its end-to-end values."""

    window: object
    t_window: float
    attempted: int
    failed: int
    peak_window_bytes: int
    spans: List[dict]
    trace: object
    work: dict
    end_to_end: dict


def program_seed(seed: int) -> int:
    """The seed handed to the program's ``--seed`` (its own draws): the
    benchmark's seed may pass 32 bits, and the PS loader seeds numpy
    with ``seed + 1009 w``, which must stay under 2^32."""
    return int(seed) % (2 ** 31)
