"""pscheck on the port: communication-contract checking of the parallel
schemes over a recorded step.

JAX's pscheck traces each scheme's step abstractly and walks the jaxpr.
The port RECORDS the step instead (``walker.py``): it runs once on real
tensors at the registry's small sizes while a tape takes down every aten
op, every worker-axis call (``axes.py``) and every kernel-entry call
(the ``ops/`` wrappers of the hand-written kernels), and the same rules
run over the tape: every axis carries its collective (PSC101), gradient
reductions feed the optimizer (PSC102), compressed wires stay int8
(PSC103), per-collective wire bytes round-trip against the port's
committed ``check/comm_contract.json`` (PSC104), the restated donation
contract holds (PSC105), bucketed wires stay fused (PSC106), the serving
hot path stays collective-free with an honest KV dtype (PSC107),
adaptive configs keep their grad-reduce declaration and byte envelope
(PSC108), pipelined configs move their serial twin's bytes with a real
per-bucket dispatch (PSC109), and adaptive configs name a real
host-consensus point (PSC110, ``lint/diverge.consensus_inventory``).

psnumerics (``numerics.py``, PSC111-114) runs a precision-flow analysis
over the same tape whenever a spec declares a ``NumericsPolicy``: every
dequantize's scale descends from its quantize's max-abs reduction
(PSC111), error feedback closes every primary site (PSC112), integer
sums fit their accumulator by the recorded axis sizes (PSC113), and no
silent downcast sits on the update path (PSC114).

Entry point: ``python -m ps_pytorch_tpu_torch.check`` (``--device cpu``
on a machine with no card). The module imports no kernel and builds
nothing: the ``ops/`` wrappers take their decorator from
``ops/_tape.py``, which imports nothing of this package.
"""

from .contracts import (
    AdaptivePolicy,
    Built,
    ContractSpec,
    Deviation,
    DonationSpec,
    FusionSpec,
    GradReduce,
    NarrowingAllowance,
    NumericsPolicy,
    OverlapPolicy,
    PrecisionPolicy,
    ServePolicy,
    WireAllowance,
    WirePolicy,
    get_contracts,
)
from .core import (
    CheckFinding,
    TraceResult,
    load_contract,
    run_checks,
    to_contract_json,
    trace_registry,
    trace_spec,
    write_contract,
)
from .numerics import NumericsReport, analyze_numerics
from .opcount import device_kernel_count, update_path_op_count, update_path_ops_from
from .rules import RULE_IDS
from .walker import Collective, Tape, collect_collectives, record_step, recording, summarize

__all__ = [
    "AdaptivePolicy", "Built", "CheckFinding", "Collective", "ContractSpec", "Deviation",
    "DonationSpec", "FusionSpec", "GradReduce", "NarrowingAllowance", "NumericsPolicy",
    "NumericsReport", "analyze_numerics",
    "OverlapPolicy", "PrecisionPolicy", "RULE_IDS", "ServePolicy", "Tape", "TraceResult",
    "WireAllowance", "WirePolicy", "collect_collectives", "device_kernel_count",
    "get_contracts", "load_contract", "record_step", "recording", "run_checks", "summarize",
    "to_contract_json", "trace_registry", "trace_spec", "update_path_op_count",
    "update_path_ops_from", "write_contract",
]
