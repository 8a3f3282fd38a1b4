"""Low-overhead host-side span tracer for the serve tick and the training
loop (a host-only copy of the JAX package's obs/trace.py).

A span reads ``time.perf_counter()`` twice and appends a dict to a
bounded ring; nothing here touches the device, so tracing adds no
synchronisation. ``NULL_TRACER`` is the shared no-op (tracer off).
Spans flush to a JSONL file (one ``run_header``, then one ``span`` per
record) only where the caller already waits.

With ``annotate=True`` each span also enters a
``torch.profiler.record_function`` scope of the same name, so the host
phases show up on a ``torch.profiler`` timeline (a no-op when no profiler
is recording).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, List, Optional

from .schema import new_run_id, run_header, validate_event


class _NullSpan:
    """Reusable no-op context manager (the tracer-off fast path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracer-off: every operation is inert."""

    enabled = False
    run_id = None

    def span(self, name, cat="phase", **attrs):
        return _NULL_SPAN

    def add(self, name, t0, dur, cat="phase", **attrs):
        return None

    def instant(self, name, cat="instant", **attrs):
        return None

    def now(self) -> float:
        return 0.0

    def drain(self) -> List[dict]:
        return []

    def flush(self) -> int:
        return 0


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_attrs", "_t0", "_depth", "_ann")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self._tracer, self._name, self._cat = tracer, name, cat
        self._attrs = attrs
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        self._depth = len(tr._stack)
        tr._stack.append(self._name)
        if tr._ann_cls is not None:
            self._ann = tr._ann_cls(self._name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        tr = self._tracer
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr._stack.pop()
        tr._append(self._name, self._t0 - tr._base, end - self._t0, self._cat,
                   self._depth, self._attrs)
        return False


class Tracer:
    """One component's span stream. ``path=None`` keeps spans in memory
    (``drain()`` them); with a path, ``flush()`` appends them as JSONL
    after writing the run_header once."""

    enabled = True

    def __init__(self, component: str, path: Optional[str] = None,
                 ring: int = 65536, annotate: bool = False,
                 run_id: Optional[str] = None, geometry: Optional[dict] = None,
                 pid: int = 0):
        self.component = component
        self.path = path
        self.run_id = run_id or new_run_id()
        self.header = run_header(component, run_id=self.run_id, geometry=geometry, pid=pid)
        self._base = self.header["t_mono"]
        self._buf: collections.deque = collections.deque(maxlen=max(ring, 1))
        self._stack: List[str] = []
        self.dropped = 0
        self._dropped_reported = 0
        self._header_written = False
        self._ann_cls = None
        if annotate:
            from torch.profiler import record_function

            self._ann_cls = record_function

    def span(self, name: str, cat: str = "phase", **attrs):
        return _Span(self, name, cat, attrs)

    def now(self) -> float:
        return time.perf_counter() - self._base

    def add(self, name: str, t0: float, dur: float, cat: str = "phase",
            **attrs) -> None:
        """Record an already-measured interval (``t0`` from ``now()``),
        marked ``async``: it overlaps the span stack without nesting."""
        attrs = dict(attrs)
        attrs["async"] = True
        self._append(name, t0, dur, cat, len(self._stack), attrs)

    def instant(self, name: str, cat: str = "instant", **attrs) -> None:
        """A zero-length marker at ``now()`` (e.g. a rollover abort)."""
        self._append(name, self.now(), 0.0, cat, len(self._stack), attrs)

    def _append(self, name, t, dur, cat, depth, attrs) -> None:
        if len(self._buf) == self._buf.maxlen:
            self.dropped += 1
        rec = {"kind": "span", "name": name, "cat": cat, "t": round(t, 6),
               "dur": round(max(dur, 0.0), 6), "depth": depth}
        if attrs:
            rec.update(attrs)
        self._buf.append(rec)

    def drain(self) -> List[dict]:
        out = list(self._buf)
        self._buf.clear()
        return out

    def flush(self) -> int:
        """Append drained spans (validated) to the trace file; a pathless
        tracer keeps them for ``drain()``. Returns spans written."""
        if self.path is None:
            return 0
        spans = self.drain()
        if self.dropped > self._dropped_reported:
            spans.append({
                "kind": "span", "name": "spans_dropped", "cat": "meta",
                "t": round(self.now(), 6), "dur": 0.0, "depth": 0,
                "async": True, "dropped_total": self.dropped,
            })
            self._dropped_reported = self.dropped
        if not self._header_written and not spans:
            return 0
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            if not self._header_written:
                f.write(json.dumps(validate_event(dict(self.header))) + "\n")
                self._header_written = True
            for rec in spans:
                f.write(json.dumps(validate_event(rec)) + "\n")
        return len(spans)


def summarize_spans(spans: List[dict]) -> Dict[str, dict]:
    """Per-phase duration stats from span records: count, total, p50/p99
    seconds."""
    by_name: Dict[str, List[float]] = {}
    for s in spans:
        if s.get("kind") == "span":
            by_name.setdefault(s["name"], []).append(float(s["dur"]))
    out: Dict[str, dict] = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        out[name] = {
            "count": len(durs),
            "total_s": round(sum(durs), 6),
            "p50_s": round(_pct_sorted(durs, 50.0), 6),
            "p99_s": round(_pct_sorted(durs, 99.0), 6),
        }
    return out


def _pct_sorted(xs: List[float], q: float) -> float:
    """Linear-interpolated percentile of a SORTED list."""
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac
