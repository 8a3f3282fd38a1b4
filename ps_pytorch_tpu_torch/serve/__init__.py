"""Serving subsystem of the port: continuous-batching decode on one card.

- ``engine``: the slot-pool decode engine (batched prefill, one decode
  step per tick, FlatVector weights, hot checkpoint rollover);
- ``admission``: SLO-aware admission control (submit-time load shedding);
- ``scheduler``: host-side admit/evict/expire slot bookkeeping with
  per-request deadlines;
- ``kv``: the pooled KV cache (compute-dtype or int8 block-scale);
- ``traffic``: seeded open-loop traffic (Poisson or square-wave burst)
  + the latency/goodput summary.

Library entry point: ``ServingEngine(cfg, params, ServeConfig(...))`` or
``ServingEngine.from_checkpoint(model_dir, ServeConfig(...))``,
``warmup()``, then ``run_open_loop`` or ``decode_requests``; the CLI is
``cli/serve.py``.
"""

from .admission import AdmissionController
from .engine import ServeConfig, ServingEngine, make_decode_step, make_prefill_step
from .kv import init_kv_pool
from .scheduler import Completion, Expired, Request, SlotScheduler
from .traffic import TrafficConfig, make_requests, run_open_loop, summarize

__all__ = [
    "AdmissionController",
    "Completion",
    "Expired",
    "Request",
    "ServeConfig",
    "ServingEngine",
    "SlotScheduler",
    "TrafficConfig",
    "init_kv_pool",
    "make_decode_step",
    "make_prefill_step",
    "make_requests",
    "run_open_loop",
    "summarize",
]
