"""The event schema for the port's JSONL streams (a host-only copy of the
JAX package's obs/schema.py, with the kinds the port emits: the serving
loop's, with its ``rollover_abort`` and the admission controller's
``admission_adapt``, and the training loop's, with the adaptive
controllers' ``mask_adapt`` and ``precision_adapt``).

``validate_event`` rejects unknown kinds and missing fields and coerces
the declared int fields. A stream begins with one ``run_header`` record
carrying the run id, the schema version and a paired wall/monotonic
clock base.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Dict, Optional, Tuple

SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class EventSpec:
    """One registered event kind: required fields plus the fields that
    are integers by contract."""

    required: Tuple[str, ...]
    int_fields: Tuple[str, ...] = ()
    doc: str = ""


EVENT_KINDS: Dict[str, EventSpec] = {
    "run_header": EventSpec(
        required=("run_id", "schema_version", "component", "t_mono"),
        int_fields=("schema_version", "pid"),
        doc="stream identity + clock base; first record of every stream",
    ),
    "train": EventSpec(
        required=("step", "loss", "time_cost"),
        int_fields=("step", "epoch", "skipped_steps", "skip_streak"),
        doc="one per log window: window-averaged step walltime + metrics",
    ),
    "eval": EventSpec(
        required=("step", "loss"),
        int_fields=("step",),
        doc="full-test-split validation pass",
    ),
    "train_lm": EventSpec(
        required=("step", "loss", "time_cost"),
        int_fields=("step",),
        doc="LM trainer log window (cli/train_lm.py)",
    ),
    "grad_skip": EventSpec(
        required=("step", "skipped_steps", "skip_streak"),
        int_fields=("step", "skipped_steps", "skip_streak"),
        doc="non-finite guard skipped >=1 step since the last window",
    ),
    "straggler": EventSpec(
        required=("step", "time_cost", "threshold"),
        int_fields=("step",),
        doc="one slow step (watchdog armed, below storm escalation)",
    ),
    "straggler_storm": EventSpec(
        required=("step", "start_step", "consecutive", "threshold"),
        int_fields=("step", "start_step", "consecutive"),
        doc="N consecutive slow steps escalated into one condition",
    ),
    "straggler_storm_end": EventSpec(
        required=("step", "start_step", "consecutive"),
        int_fields=("step", "start_step", "consecutive"),
        doc="storm closed; carries the true span length",
    ),
    "resume_reshape": EventSpec(
        required=("step", "from", "to"),
        int_fields=("step",),
        doc="elastic resume re-carved the checkpoint onto a new geometry",
    ),
    "mask_adapt": EventSpec(
        required=("step", "from", "to", "window_start", "slow_steps",
                  "window_steps"),
        int_fields=("step", "from", "to", "window_start", "slow_steps",
                    "window_steps"),
        doc="adaptive partial-aggregation count change at a window close",
    ),
    "precision_adapt": EventSpec(
        required=("step", "window_start", "changed", "n_skip", "n_4bit",
                  "n_int8", "n_hi", "effective_bytes", "budget_bytes"),
        int_fields=("step", "window_start", "changed", "n_skip", "n_4bit",
                    "n_int8", "n_hi", "effective_bytes", "budget_bytes"),
        doc="adaptive per-bucket precision retag at a window close: the "
            "tag histogram plus the effective wire bytes it prices "
            "(budget_bytes 0 = no --wire-budget-bytes cap)",
    ),
    "ckpt_quarantined": EventSpec(
        required=("step", "path"),
        int_fields=("step",),
        doc="corrupt checkpoint renamed *.corrupt during resume fallback",
    ),
    "ckpt_write_failed": EventSpec(
        required=("step", "path", "error"),
        int_fields=("step",),
        doc="checkpoint write failed (reported at failure time)",
    ),
    "autotune": EventSpec(
        required=("run", "model", "network", "grid", "n_candidates", "n_pruned", "gate"),
        int_fields=("n_points", "n_candidates", "n_pruned"),
        doc="one ranked knob-search evidence record (tune/search.py); carries its own "
            "nested run_header under 'run'",
    ),
    "span": EventSpec(
        required=("name", "t", "dur"),
        int_fields=("depth", "step", "tick", "slot", "rid",
                    "new_tokens", "weights_step", "from_step", "to_step"),
        doc="one traced host-side phase: t/dur are seconds on the "
            "stream header's monotonic clock",
    ),
    # serving request lifecycle: every submitted request terminates in
    # EXACTLY one of request_done | request_shed | deadline_expired
    "request_done": EventSpec(
        required=("rid", "new_tokens", "weights_step"),
        int_fields=("rid", "new_tokens", "weights_step"),
        doc="one request completed (its new-token budget reached); "
            "met_deadline rides along when the request carried one",
    ),
    "request_shed": EventSpec(
        required=("rid", "projected_wait_s", "queue_depth", "slo_budget_s"),
        int_fields=("rid", "queue_depth"),
        doc="admission controller refused the arrival at submit time: "
            "projected queue wait exceeded the SLO budget",
    ),
    "deadline_expired": EventSpec(
        required=("rid", "where", "deadline_s"),
        int_fields=("rid", "tokens_done"),
        doc="request deadline passed before completion; 'where' is "
            "submit | queue | decode",
    ),
    "rollover_abort": EventSpec(
        required=("from_step", "staged_step", "reason"),
        int_fields=("from_step", "staged_step"),
        doc="a staged rollover was abandoned (corrupt/unreadable staged "
            "checkpoint at swap time, or the drain watchdog expired); "
            "service continues on from_step",
    ),
    "admission_adapt": EventSpec(
        required=("state", "projected_wait_s", "queue_depth",
                  "window_submits", "window_sheds"),
        int_fields=("queue_depth", "window_submits", "window_sheds",
                    "windows"),
        doc="admission controller state change (admitting <-> shedding) "
            "with the window evidence that drove it",
    ),
}


def new_run_id() -> str:
    """Random 12-hex run id — shared across one run's streams."""
    return uuid.uuid4().hex[:12]


def validate_event(record: dict) -> dict:
    """Validate (and normalize, in place) one JSONL record against the
    registry. Raises ValueError on a missing/unknown ``kind`` or a
    missing required field; coerces the kind's declared int fields."""
    kind = record.get("kind")
    if kind is None:
        raise ValueError(f"event record has no 'kind': {record!r}")
    spec = EVENT_KINDS.get(kind)
    if spec is None:
        raise ValueError(
            f"unknown event kind {kind!r} — register it in "
            f"obs/schema.EVENT_KINDS (known: {sorted(EVENT_KINDS)})"
        )
    missing = [f for f in spec.required if f not in record]
    if missing:
        raise ValueError(
            f"event kind {kind!r} is missing required field(s) "
            f"{missing}: {record!r}"
        )
    for f in spec.int_fields:
        v = record.get(f)
        if v is not None and not isinstance(v, bool):
            record[f] = int(v)
    return record


def run_header(component: str, run_id: Optional[str] = None,
               geometry: Optional[dict] = None, pid: int = 0) -> dict:
    """The stream-opening run_header record (t_wall and t_mono are one
    paired sample; ``pid`` the writing process's rank, one process per
    stream); ``geometry`` says enough to read the stream without the
    command line that made it."""
    rec = {
        "kind": "run_header",
        "run_id": run_id or new_run_id(),
        "schema_version": SCHEMA_VERSION,
        "component": component,
        "t_wall": round(time.time(), 6),
        "t_mono": round(time.perf_counter(), 6),
        "pid": int(pid),
    }
    if geometry is not None:
        rec["geometry"] = geometry
    return rec
