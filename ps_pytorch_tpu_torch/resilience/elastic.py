"""The elastic manifest (the manifest half of resilience/elastic.py) and
the adaptive partial-aggregation controller (``AdaptiveMaskController``).

The trainer drops an ``elastic.json`` beside its checkpoints: the mesh
geometry that wrote each step (``steps[str(step)]``) and, at the top
level, the directory's latest writer. The fields and the file are the
JAX package's, so either package's ``--resume`` of the other's directory
reads the same record. A resume whose manifest says the checkpoint was
written on another geometry needs the resume-reshape, which is not
ported yet (ROADMAP.md queue 1 item 15): the trainer refuses it rather
than restoring silently.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Callable, Optional

logger = logging.getLogger("ps_pytorch_tpu_torch")

GEOMETRY_FILE = "elastic.json"
GEOMETRY_VERSION = 1


@dataclasses.dataclass(frozen=True)
class MeshGeometry:
    """What about a run's mesh and placement decides the shapes of its
    checkpointed state (elastic.py:91). ``state_layout`` rides along for
    the record: checkpoints are tree-shaped in both layouts."""

    num_workers: int
    opt_placement: str = "replicated"
    bucket_bytes: Optional[int] = None
    quant_block_size: int = 0
    compress: Optional[str] = None
    error_feedback: bool = False
    bn_mode: str = "pmean"
    state_layout: str = "flat"
    dcn_hosts: int = 1

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = GEOMETRY_VERSION
        return d

    @classmethod
    def from_json(cls, d: dict) -> "MeshGeometry":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def geometry_of(cfg) -> MeshGeometry:
    """The manifest entry of a live PSConfig."""
    return MeshGeometry(
        num_workers=cfg.num_workers,
        opt_placement=cfg.opt_placement,
        bucket_bytes=cfg.bucket_bytes,
        quant_block_size=cfg.quant_block_size,
        compress=None if cfg.compress in (None, "none") else cfg.compress,
        error_feedback=cfg.error_feedback,
        bn_mode=cfg.bn_mode,
        state_layout=cfg.state_layout,
        dcn_hosts=cfg.dcn_hosts,
    )


def save_geometry(model_dir: str, geom: MeshGeometry, step: Optional[int] = None) -> str:
    """Atomically write or merge the manifest: the top level is the
    latest writer, ``steps[str(step)]`` the writer of that checkpoint. A
    torn manifest is rewritten, never fatal."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, GEOMETRY_FILE)
    data = geom.to_json()
    steps = {}
    if os.path.exists(path):
        try:
            with open(path, "r", encoding="utf-8") as f:
                steps = json.load(f).get("steps", {}) or {}
        except (OSError, ValueError):
            steps = {}
    if step is not None:
        steps[str(step)] = geom.to_json()
    if steps:
        data["steps"] = steps
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_geometry(model_dir: str, step: Optional[int] = None) -> Optional[MeshGeometry]:
    """The geometry that wrote checkpoint ``step`` (None: the latest
    writer), or None when it cannot be known: no manifest, no entry for
    the step, or an unreadable manifest."""
    path = os.path.join(model_dir, GEOMETRY_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if step is not None:
            entry = (data.get("steps") or {}).get(str(step))
            return None if entry is None else MeshGeometry.from_json(entry)
        return MeshGeometry.from_json(data)
    except (OSError, ValueError, TypeError) as e:
        logger.warning("elastic manifest %s is unreadable (%s); treating the dir "
                       "as manifest-less", path, e)
        return None


def _quant_block(geom: MeshGeometry) -> int:
    if geom.compress in ("int8", "int8_2round") and geom.quant_block_size:
        return geom.quant_block_size
    return 1


def needs_reshape(src: MeshGeometry, dst: MeshGeometry) -> bool:
    """Would a checkpoint written under ``src`` mis-load into a
    ``dst``-geometry state: wrong shapes, or (ZeRO-1) the same shapes
    with another worker-to-region mapping (elastic.py:205)."""
    if src.opt_placement != dst.opt_placement:
        return True
    n_changed = src.num_workers != dst.num_workers
    if src.opt_placement == "sharded":
        if n_changed:
            return True
        if (src.bucket_bytes or 0) != (dst.bucket_bytes or 0):
            return True
        if _quant_block(src) != _quant_block(dst):
            return True
    if n_changed and (src.error_feedback or dst.error_feedback):
        return True
    src_local = src.bn_mode == "local"
    dst_local = dst.bn_mode == "local"
    return src_local != dst_local or (n_changed and src_local)


# ----------------------------------------------------- adaptive aggregation

class AdaptiveMaskController:
    """The host half of adaptive partial aggregation (elastic.py:522): the
    straggler watchdog's per-step walltimes pick the next window's
    aggregation count inside ``[num_aggregate_min, num_aggregate_max]``.

    - a window with slow steps (walltime above ``threshold_s``, the
      watchdog's own) shrinks the count by their number, floored at min;
    - a clean window grows it by one, ceilinged at max.

    Every change emits one ``mask_adapt`` record through ``event_sink``;
    the step clamps the count again on the device. Over processes,
    ``consensus`` (the trainer's: the min over processes, an int32
    collective) is applied at each window close, whose step every process
    reaches together (the windows are step-counted); ``slow_steps`` stays
    the local observation."""

    def __init__(self, cfg, threshold_s: Optional[float], window: int,
                 event_sink: Optional[Callable[[dict], None]] = None,
                 consensus: Optional[Callable[[int], int]] = None):
        if not cfg.adaptive_aggregate:
            raise ValueError("AdaptiveMaskController needs num_aggregate_min/max set")
        if window < 1:
            raise ValueError(f"adapt window must be >= 1, got {window}")
        if threshold_s is None or threshold_s <= 0:
            raise ValueError(
                "adaptive aggregation needs the straggler watchdog's threshold (arm it "
                "with --mode/--kill-threshold): the controller consumes its per-step "
                "walltimes")
        self.lo = cfg.num_aggregate_min
        self.hi = cfg.num_aggregate_max
        self.count = int(cfg.initial_aggregate)
        self.threshold_s = float(threshold_s)
        self.window = int(window)
        self.adaptations = 0
        self._sink = event_sink
        self._consensus = consensus
        self._steps = 0
        self._slow = 0
        self._win_start: Optional[int] = None

    def record(self, step_no: int, seconds: float) -> int:
        """One step's walltime; returns the count the NEXT step uses (it
        changes only at window boundaries)."""
        if self._win_start is None:
            self._win_start = step_no
        self._steps += 1
        if seconds > self.threshold_s:
            self._slow += 1
        if self._steps >= self.window:
            self._close_window(step_no)
        return self.count

    def _close_window(self, step_no: int) -> None:
        old = self.count
        new = max(self.lo, old - self._slow) if self._slow else min(self.hi, old + 1)
        if self._consensus is not None:
            new = min(max(int(self._consensus(new)), self.lo), self.hi)
        if new != old:
            self.adaptations += 1
            logger.info("mask_adapt: aggregation count %d -> %d after window %d-%d "
                        "(%d/%d slow steps)", old, new, self._win_start, step_no,
                        self._slow, self._steps)
            if self._sink is not None:
                self._sink({"kind": "mask_adapt", "step": step_no,
                            "window_start": self._win_start, "from": old, "to": new,
                            "slow_steps": self._slow, "window_steps": self._steps})
        self.count = new
        self._steps = 0
        self._slow = 0
        self._win_start = None
