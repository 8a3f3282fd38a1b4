"""Self-tuning (the port of tune/): pick the wire / schedule / layout knobs
from evidence.

- ``costmodel``: the trace-only cost model. For any candidate
  ``PSConfig``, the recorded step's wire bytes and collective counts
  (``check/walker.py``), update-path op count (``check/opcount.py``)
  and schedule freedom (``parallel/overlap.py``) combine with a hardware
  profile, measured on the card or given, into a modeled step time.
- ``search``: the knob-grid search. Candidates are checked by the
  PSC101-114 rules BEFORE they are costed (broken configs are pruned with
  the finding attached), the survivors ranked by modeled cost, and the
  top-K optionally measured by short probes on the card.
- ``tools/autotune.py`` (``python -m ps_pytorch_tpu_torch.tools.autotune``):
  the operator CLI; writes a ranked, schema-valid autotune record and a
  flag line ``cli.train --config-json`` applies.
"""

from .costmodel import (
    CandidateCost,
    HardwareProfile,
    comm_seconds_from_rows,
    load_hardware_profile,
    measure_card_profile,
    model_cost,
    modeled_step_seconds,
)
from .search import Knobs, build_grid, run_search

__all__ = ["CandidateCost", "HardwareProfile", "Knobs", "build_grid", "comm_seconds_from_rows",
           "load_hardware_profile", "measure_card_profile", "model_cost",
           "modeled_step_seconds", "run_search"]
