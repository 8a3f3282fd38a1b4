"""Merge per-process span-trace streams into one timeline and summarize
them (the port of tools/trace_report.py; imports no JAX).

The port's tracer (``obs/trace.py``, ``--trace DIR`` of ``cli.train``
and ``cli.serve``) writes one JSONL stream per process and component: a
``run_header`` record (run id, schema version, wall and monotonic clock
base), then ``span`` records whose ``t`` / ``dur`` are seconds on that
header's monotonic clock. This tool:

- merges any number of streams (train and serve, several processes) into
  one Chrome trace (``--out``, loads in Perfetto). A span's absolute
  time is ``header.t_wall + span.t``: the monotonic offsets keep
  durations exact, the per-process wall base places the streams on one
  timeline, and each stream keeps its own ``pid`` lane;
- overlays metrics-JSONL events (``--metrics``: grad_skip, straggler
  storms, mask_adapt, resume_reshape, checkpoint quarantine or failure)
  as instant markers at their ``t_wall``;
- prints a summary: per-phase count, p50 / p99 / total seconds, each
  component's share of loop walltime by top-level phase, and a nesting
  check (a child span must lie inside its parent; a violation is a
  tracer bug);
- ``--require-phases a,b,c`` exits 1 unless every named phase is present
  and no span was dropped (the smoke gate).

Two more readers ride as subcommands:

  python -m ps_pytorch_tpu_torch.tools.trace_report overlap <trace|tape> [...]
      -> tools/overlap_report.py (the wire's overlap with compute, from a
         ``--profile-dir`` trace or the recorded step's tape)
  python -m ps_pytorch_tpu_torch.tools.trace_report window [outdir]
      -> tools/window_report.py (bench records and overlap reports)

Usage:
  python -m ps_pytorch_tpu_torch.tools.trace_report runs/trace/ \\
      --metrics runs/metrics.jsonl --out runs/trace_merged.json \\
      --summary-out runs/trace_summary.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from ps_pytorch_tpu_torch.obs.trace import chrome_trace_events, summarize_spans

# metrics-JSONL kinds drawn as instant markers on the merged timeline
OVERLAY_KINDS = (
    "grad_skip", "straggler", "straggler_storm", "straggler_storm_end",
    "mask_adapt", "resume_reshape", "ckpt_quarantined", "ckpt_write_failed",
)

# span times round to 1 us in the files, so a child ending at its parent's
# end can overhang by a rounding quantum
_NEST_EPS_S = 5e-6


def load_stream(path: str) -> List[Tuple[dict, List[dict]]]:
    """One trace file -> a list of (run_header, spans) segments. A rerun
    into the same ``--trace`` directory (a ``--resume``) appends a fresh
    header mid-file, and each segment's offsets are on its own header's
    clock."""
    segments: List[Tuple[dict, List[dict]]] = []
    header: Optional[dict] = None
    spans: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if kind == "run_header":
                if header is not None:
                    segments.append((header, spans))
                header, spans = rec, []
            elif kind == "span":
                if header is None:
                    raise SystemExit(f"{path}: span record before any run_header — "
                                     f"not an obs trace stream")
                spans.append(rec)
    if header is not None:
        segments.append((header, spans))
    return segments


def discover(inputs: List[str]) -> List[str]:
    """Directories -> their ``trace_*.jsonl`` files; files pass through."""
    out: List[str] = []
    for item in inputs:
        if os.path.isdir(item):
            out.extend(sorted(glob.glob(os.path.join(item, "trace_*.jsonl"))))
        else:
            out.append(item)
    return out


def check_nesting(spans: List[dict]) -> int:
    """Nesting violations within one stream: spans sorted by start must
    close inside the span open above them. Async spans (request
    lifecycles, rollover drains) overlap the stack by design and are left
    out."""
    # at equal starts the longer span is the parent: it enters first
    ordered = sorted(((float(s["t"]), float(s["t"]) + float(s["dur"]))
                      for s in spans if not s.get("async")),
                     key=lambda se: (se[0], -se[1]))
    stack: List[float] = []
    bad = 0
    for start, end in ordered:
        while stack and stack[-1] <= start + _NEST_EPS_S:
            stack.pop()
        if stack and end > stack[-1] + _NEST_EPS_S:
            bad += 1
        stack.append(end)
    return bad


def merge(trace_files: List[str], metrics_files: List[str]) -> Tuple[dict, dict]:
    """-> (the Chrome trace dict, the summary dict)."""
    streams = []
    for path in trace_files:
        segments = load_stream(path)
        if not segments:
            # a stream without a header cannot be placed on the timeline
            raise SystemExit(f"{path}: no run_header record — not an obs trace stream")
        for header, spans in segments:
            streams.append((path, header, spans))
    overlays = []
    for path in metrics_files or []:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("kind") in OVERLAY_KINDS and "t_wall" in rec:
                    overlays.append(rec)
    if not streams and not overlays:
        raise SystemExit("no trace streams and no overlay events found")

    t0_wall = min([h["t_wall"] for _, h, _ in streams] + [o["t_wall"] for o in overlays])
    events: List[dict] = []
    used_pids = set()
    for path, header, spans in streams:
        # a lane per stream, even where two headers claim one pid
        pid = int(header.get("pid", 0))
        while pid in used_pids:
            pid += 100
        used_pids.add(pid)
        events.extend(chrome_trace_events(header, spans, pid=pid, t0_wall=t0_wall))
    for o in overlays:
        events.append({"name": o["kind"], "cat": "event", "ph": "i", "s": "g",
                       "ts": round((o["t_wall"] - t0_wall) * 1e6, 3), "pid": 0, "tid": 0,
                       "args": {k: v for k, v in o.items() if k != "t_wall"}})

    phases = summarize_spans([s for _, _, spans in streams for s in spans])
    # each component's share of loop walltime by top-level phase, over all
    # its streams (a nested span would count twice, an async one overlaps
    # the loop)
    totals: Dict[str, Dict[str, float]] = {}
    for _, header, spans in streams:
        by = totals.setdefault(header.get("component", "?"), {})
        for s in spans:
            if s.get("depth", 0) == 0 and not s.get("async"):
                by[s["name"]] = by.get(s["name"], 0.0) + float(s["dur"])
    fractions = {comp: {k: round(v / sum(by.values()), 4) for k, v in sorted(by.items())}
                 for comp, by in totals.items() if sum(by.values()) > 0}
    nest_bad = sum(check_nesting(spans) for _, _, spans in streams)
    summary = {
        "streams": [{"path": path, "component": h.get("component"),
                     "run_id": h.get("run_id"), "pid": h.get("pid", 0),
                     "schema_version": h.get("schema_version"), "n_spans": len(spans)}
                    for path, h, spans in streams],
        "n_overlay_events": len(overlays),
        "phases": phases,
        "fraction_of_loop_walltime": fractions,
        "nesting_violations": nest_bad,
        "nesting_ok": nest_bad == 0,
    }
    return {"traceEvents": events, "displayTimeUnit": "ms"}, summary


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "overlap":
        from ps_pytorch_tpu_torch.tools import overlap_report

        return overlap_report.main(argv[1:])
    if argv and argv[0] == "window":
        from ps_pytorch_tpu_torch.tools import window_report

        return window_report.main(argv[1] if len(argv) > 1 else "runs/tpu_r04")

    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.tools.trace_report",
                                description="merge obs span-trace streams; see module docstring")
    p.add_argument("inputs", nargs="+", help="trace dirs (trace_*.jsonl inside) and/or files")
    p.add_argument("--metrics", action="append", default=[],
                   help="metrics JSONL to overlay as instant markers (repeatable)")
    p.add_argument("--out", default=None,
                   help="write the merged Chrome trace JSON here (Perfetto, chrome://tracing)")
    p.add_argument("--summary-out", default=None, help="write the summary JSON here")
    p.add_argument("--require-phases", default=None,
                   help="comma-separated phase names that must appear; missing ones exit 1")
    args = p.parse_args(argv)

    files = discover(args.inputs)
    if not files and not args.metrics:
        print(f"no trace_*.jsonl under {args.inputs}", file=sys.stderr)
        return 1
    trace, summary = merge(files, args.metrics)
    print(json.dumps(summary, indent=2))
    if args.out:
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(trace, f)
        print(f"# merged trace: {args.out} ({len(trace['traceEvents'])} events)",
              file=sys.stderr)
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            json.dump(summary, f, indent=2)
    if args.require_phases:
        need = {s for s in args.require_phases.split(",") if s}
        missing = sorted(need - set(summary["phases"]))
        if missing:
            print(f"missing required phases: {missing}", file=sys.stderr)
            return 1
        if "spans_dropped" in summary["phases"]:
            # the tracer's ring evicted spans: the timeline is incomplete,
            # and a gate that demands whole phases must not pass it
            print("required phases present but the stream carries a spans_dropped "
                  "marker — the span ring overflowed and the timeline is incomplete "
                  "(raise the tracer ring size or flush more often)", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
