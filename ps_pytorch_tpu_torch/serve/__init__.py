"""Serving subsystem of the port: continuous-batching decode on one card.

- ``engine``: the slot-pool decode engine (batched prefill, one decode
  step per tick, FlatVector weights);
- ``scheduler``: host-side admit/evict/expire slot bookkeeping with
  per-request deadlines;
- ``kv``: the pooled KV cache (compute-dtype or int8 block-scale);
- ``traffic``: seeded open-loop traffic (Poisson or square-wave burst)
  + the latency/goodput summary.

Library entry point: ``ServingEngine(cfg, params, ServeConfig(...))``,
``warmup()``, then ``run_open_loop`` or ``decode_requests``.
"""

from .engine import ServeConfig, ServingEngine, make_decode_step, make_prefill_step
from .kv import init_kv_pool
from .scheduler import Completion, Expired, Request, SlotScheduler
from .traffic import TrafficConfig, make_requests, run_open_loop, summarize

__all__ = [
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
