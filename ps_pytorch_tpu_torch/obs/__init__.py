"""Observability of the port: the event schema, the host-side span
tracer (host-only copies of the JAX package's obs/) and the bounded
``torch.profiler`` capture window of ``--profile-dir``."""

from .profiler import ProfileWindow
from .schema import EVENT_KINDS, SCHEMA_VERSION, new_run_id, run_header, validate_event
from .trace import NULL_TRACER, NullTracer, Tracer, summarize_spans

__all__ = [
    "EVENT_KINDS",
    "NULL_TRACER",
    "NullTracer",
    "ProfileWindow",
    "SCHEMA_VERSION",
    "Tracer",
    "new_run_id",
    "run_header",
    "summarize_spans",
    "validate_event",
]
