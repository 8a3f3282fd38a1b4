"""Summarize a directory of bench records and overlap reports into one
table (the port of tools/window_report.py).

One markdown row per ``bench_*.json`` record (value, vs_baseline, MFU,
chain, date), then one-line summaries of the validator sweep and of the
overlap reports (``overlap_trace.json``, ``overlap_topology.json``). A
pure reader: it never changes the files.

    python -m ps_pytorch_tpu_torch.tools.window_report OUTDIR

or ``python -m ps_pytorch_tpu_torch.tools.trace_report window OUTDIR``.
"""

from __future__ import annotations

import glob
import json
import os
import sys


def _load(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        return {"error": f"{type(e).__name__}: {e}"}


def main(outdir: str) -> int:
    bench = sorted(glob.glob(os.path.join(outdir, "bench_*.json")))
    if bench:
        print("| Record | Metric | Value | Unit | vs baseline | MFU | chain | recorded |")
        print("|---|---|---|---|---|---|---|---|")
        for p in bench:
            r = _load(p)
            # a record carrying "error" is an ERROR row, never a row of value 0
            if "error" in r:
                print(f"| {os.path.basename(p)} | ERROR ({r.get('metric', 'unreadable')}): "
                      f"{str(r['error'])[:160]} | | | | | | |")
                continue
            row = "| {stem} | {metric} | {value:,} | {unit} | {vs} | {mfu} | {chain} | {ts} |"
            print(row.format(
                stem=os.path.basename(p)[len("bench_"):-len(".json")],
                metric=r.get("metric", "?"), value=r.get("value") or 0,
                unit=r.get("unit", "?"), vs=r.get("vs_baseline", "—"),
                mfu=r.get("mfu", "—"), chain=r.get("chain", 1), ts=r.get("timestamp", "?")))
    else:
        print(f"(no bench_*.json under {outdir})")

    for name in ("tpu_validate_quick.json", "tpu_validate.json"):
        p = os.path.join(outdir, name)
        if os.path.exists(p):
            r = _load(p)
            flash = r.get("flash", [])
            ok = sum(1 for x in flash if x.get("parity_mode") not in (None, "untested"))
            print(f"\n{name}: {len(flash)} flash rows ({ok} with compiled "
                  f"parity), {len(r.get('ring_flash', []))} ring rows, "
                  f"{len(r.get('quantizers', []))} quantizer rows on "
                  f"{r.get('device_kind', '?')}")

    for name in ("overlap_trace.json", "overlap_topology.json"):
        p = os.path.join(outdir, name)
        if not os.path.exists(p):
            continue
        r = _load(p)
        if "error" in r:
            print(f"\n{name}: ERROR — {str(r['error'])[:200]}")
        elif r.get("mode") == "trace":
            print(f"\n{name}: overlap_fraction={r.get('overlap_fraction')} "
                  f"({r.get('collective_ms')} ms collectives, "
                  f"{r.get('overlapped_ms')} ms overlapped, "
                  f"{r.get('n_skipped_events')} infra events excluded)")
        else:
            print(f"\n{name}: {r.get('n_async_overlapped', 0)}/{r.get('n_async', 0)} "
                  f"async collectives overlapped by compute "
                  f"({r.get('n_sync', 0)} sync) on {r.get('topology', '?')}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "runs/tpu_r04"))
