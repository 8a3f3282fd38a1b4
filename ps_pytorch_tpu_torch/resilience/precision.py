"""Adaptive per-bucket precision: the host half (the port of
resilience/precision.py).

The step (``PSConfig.precision_adapt``) takes a device int32 tag per
wire bucket (skip / 4-bit / int8 / hi) and quantizes each bucket onto
the lattice its tag names (``ops.quantize.quantize_lattice``). This
controller picks the tags, in the mold of
``elastic.AdaptiveMaskController``: windowed telemetry in, one
deterministic policy, consensus over processes at the window close, a
schema-validated ``precision_adapt`` record on every change.

Telemetry: the step's ``bucket_sqnorm`` row, the mean over workers of
each bucket's squared gradient norm. Per-bucket signal density (the
window's mean sqnorm over the bucket's size) ranks the buckets.

Policy:

- relative to the window's densest bucket: at most 1e-8 of its density
  is SKIP (error feedback keeps the whole gradient), at most 1e-3 the
  4-bit lattice, at least 0.25 the HI lattice, else int8;
- a budget (``--wire-budget-bytes``) caps the step's effective wire
  bytes: over it, the lowest-density bucket above 4-bit drops one notch,
  again and again; the budget never forces a SKIP;
- debounce: a proposal is adopted only when two windows in a row
  propose the same tag vector;
- consensus: the elementwise min over processes of the adopted tags
  (the coarsest wins, so it can only lower the effective bytes);
- a window whose telemetry holds a non-finite value adapts nothing.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence

import numpy as np

from ..ops.quantize import (
    PREC_4BIT,
    PREC_HI,
    PREC_INT8,
    PREC_SKIP,
    PRECISION_TAG_NAMES,
    precision_bytes_per_element,
)

logger = logging.getLogger("ps_pytorch_tpu_torch")

# relative-density ladder (fractions of the window's max density)
SKIP_FRACTION = 1e-8
FOURBIT_FRACTION = 1e-3
HI_FRACTION = 0.25


def effective_wire_bytes(tags: Sequence[int], sizes: Sequence[int], hi_peak: int) -> int:
    """The gradient wire's effective bytes a step under ``tags``: skip 0,
    4-bit size/2, int8 size, hi the least integer width holding
    ``hi_peak``; the total rounded up. Scale rows are the same for every
    tag and are left out."""
    per_el = precision_bytes_per_element(hi_peak)
    total = 0.0
    for t, s in zip(tags, sizes):
        total += per_el[int(t)] * int(s)
    return int(np.ceil(total))


class PrecisionController:
    """Feed one ``record(step_no, bucket_sqnorm)`` a step; it returns the
    int32 tag vector the NEXT step uses (it changes only at a window
    boundary). ``consensus`` maps a proposed tag vector to the
    elementwise min over processes."""

    def __init__(self, cfg, sizes: Sequence[int], window: int,
                 budget_bytes: Optional[int] = None,
                 event_sink: Optional[Callable[[dict], None]] = None,
                 consensus: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        from ..parallel.ps import precision_hi_peak

        if not cfg.precision_adapt:
            raise ValueError("PrecisionController needs cfg.precision_adapt=True")
        if window < 1:
            raise ValueError(f"adapt window must be >= 1, got {window}")
        self.sizes = np.asarray(sizes, np.int64)
        if self.sizes.ndim != 1 or self.sizes.size < 1 or (self.sizes <= 0).any():
            raise ValueError(f"bad bucket sizes {sizes!r}: need >= 1 positive entries "
                             f"(state_plan(cfg, total).sizes)")
        self.hi_peak = precision_hi_peak(cfg)
        if budget_bytes is not None and budget_bytes < 1:
            raise ValueError(f"bad wire budget {budget_bytes} (need >= 1)")
        self.budget_bytes = int(budget_bytes) if budget_bytes is not None else None
        self.static_int8_bytes = effective_wire_bytes(
            [PREC_INT8] * self.sizes.size, self.sizes, self.hi_peak)
        self.window = int(window)
        # the first window runs the int8 lattice everywhere
        self.tags = np.full(self.sizes.size, PREC_INT8, np.int32)
        self.adaptations = 0
        self._sink = event_sink
        self._consensus = consensus
        self._steps = 0
        self._sq_sum = np.zeros(self.sizes.size, np.float64)
        self._finite = True
        self._win_start: Optional[int] = None
        self._pending: Optional[np.ndarray] = None

    def _ladder(self, density: np.ndarray) -> np.ndarray:
        """The relative-threshold proposal from per-element densities."""
        dmax = float(density.max())
        if dmax <= 0.0:
            # an all-zero window: nothing to rank, keep the tags
            return self.tags.copy()
        rel = density / dmax
        tags = np.full(density.size, PREC_INT8, np.int32)
        tags[rel >= HI_FRACTION] = PREC_HI
        tags[rel <= FOURBIT_FRACTION] = PREC_4BIT
        tags[rel <= SKIP_FRACTION] = PREC_SKIP
        return tags

    def _enforce_budget(self, tags: np.ndarray, density: np.ndarray) -> np.ndarray:
        """Lower the lowest-density bucket above 4-bit one notch at a time
        until the effective bytes fit the budget (or none is left)."""
        if self.budget_bytes is None:
            return tags
        tags = tags.copy()
        order = np.argsort(density, kind="stable")  # the least signal first
        while self.effective_bytes(tags) > self.budget_bytes:
            for b in order:
                if tags[b] > PREC_4BIT:
                    tags[b] -= 1
                    break
            else:
                logger.warning("precision_adapt: wire budget %d B unreachable — floor is "
                               "%d B with every bucket at 4-bit", self.budget_bytes,
                               self.effective_bytes(tags))
                break
        return tags

    def effective_bytes(self, tags: Optional[np.ndarray] = None) -> int:
        return effective_wire_bytes(self.tags if tags is None else tags, self.sizes,
                                    self.hi_peak)

    def record(self, step_no: int, bucket_sqnorm) -> np.ndarray:
        """One step's ``[n_buckets]`` squared-norm row; returns the tags
        the next step uses."""
        sq = np.asarray(bucket_sqnorm, np.float64).reshape(-1)
        if sq.size != self.sizes.size:
            raise ValueError(f"bucket_sqnorm has {sq.size} entries, plan has "
                             f"{self.sizes.size} buckets")
        if self._win_start is None:
            self._win_start = step_no
        self._steps += 1
        if not np.isfinite(sq).all():
            self._finite = False
        else:
            self._sq_sum += sq
        if self._steps >= self.window:
            self._close_window(step_no)
        return self.tags

    def _close_window(self, step_no: int) -> None:
        win_start, steps = self._win_start, self._steps
        finite, sq_sum = self._finite, self._sq_sum
        self._steps = 0
        self._sq_sum = np.zeros(self.sizes.size, np.float64)
        self._finite = True
        self._win_start = None
        if not finite:
            self._pending = None  # a poisoned window adapts nothing
            return
        density = (sq_sum / steps) / self.sizes
        proposal = self._enforce_budget(self._ladder(density), density)
        # debounce: adopt only what two windows in a row agree on
        if self._pending is None or not np.array_equal(self._pending, proposal):
            self._pending = proposal
            return
        adopted = proposal
        if self._consensus is not None:
            adopted = np.minimum(np.asarray(self._consensus(adopted), np.int32),
                                 adopted).astype(np.int32)
        changed = int((adopted != self.tags).sum())
        if not changed:
            return
        self.tags = adopted.astype(np.int32)
        self.adaptations += 1
        counts = {f"n_{name}": int((self.tags == t).sum())
                  for t, name in enumerate(PRECISION_TAG_NAMES)}
        eff = self.effective_bytes()
        logger.info("precision_adapt: %d/%d buckets retagged after window %d-%d (skip=%d "
                    "4bit=%d int8=%d hi=%d, effective %d B vs static int8 %d B)",
                    changed, self.tags.size, win_start, step_no, counts["n_skip"],
                    counts["n_4bit"], counts["n_int8"], counts["n_hi"], eff,
                    self.static_int8_bytes)
        if self._sink is not None:
            self._sink({"kind": "precision_adapt", "step": step_no,
                        "window_start": win_start, "changed": changed,
                        "effective_bytes": eff,
                        "budget_bytes": self.budget_bytes if self.budget_bytes is not None
                        else 0, **counts})
