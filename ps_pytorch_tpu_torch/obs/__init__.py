"""Observability of the port: the event schema and the host-side span
tracer (host-only copies of the JAX package's obs/)."""

from .schema import EVENT_KINDS, SCHEMA_VERSION, new_run_id, run_header, validate_event
from .trace import NULL_TRACER, NullTracer, Tracer, summarize_spans

__all__ = [
    "EVENT_KINDS",
    "NULL_TRACER",
    "NullTracer",
    "SCHEMA_VERSION",
    "Tracer",
    "new_run_id",
    "run_header",
    "summarize_spans",
    "validate_event",
]
