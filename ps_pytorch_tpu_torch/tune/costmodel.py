"""Trace-only cost model: a modeled step time for any candidate config
(the port of tune/costmodel.py).

The inputs are the measurements the contract checker already takes over
the candidate's recorded step (``check/walker.py`` collective
accounting, ``check/opcount.py`` update-path ops, ``parallel/overlap.py``
schedule freedom), priced by a hardware profile (link bandwidths, the
cost of one collective, of one update-path op, and a compute floor):

    modeled_step_s = compute_s
                   + update_path_ops * op_cost_s
                   + comm_s * (1 - overlap_headroom)

``comm_s`` is the alpha-beta collective time (per accounting row: the
algorithm factor x bytes / link bandwidth + count x launch cost) and
``overlap_headroom`` the tape's mean independent fraction around its
reduce-kind collectives. A measured probe can substitute its
span-derived dispatch fraction for the headroom
(``modeled_step_seconds`` is the one formula both paths share).

The formulas are JAX's. The profile is not: the JAX package's defaults
are a TPU v5e's (its ICI and DCN links, launch and op costs, and the
TPU's single-chip step times), and none of them is a figure of the card.
The port's profile is either

- measured on the card (``measure_card_profile``): the card's name and
  power limit from ``nvidia-smi``, ``compute_s`` from one worker's
  forward and backward step, the links from a stacked collective (on
  one card a worker axis is a reduction over stacked rows in device
  memory: its bandwidth the slope of its time over two sizes, its cost
  at one element), ``op_cost_s`` from one small elementwise launch; or
- given explicitly (``HardwareProfile(...)``, ``load_hardware_profile``
  from a JSON file): a CPU trace-only search takes one, and its record
  says where it came from (``source``).

This is a RANKING model, not a simulator: a tape counts eager aten ops
where a jaxpr counts equations, so ``update_path_ops`` and the headroom
are the port's own numbers, and the rankings are what the tests hold
against JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np

# collective algorithm factors over a group of size g (ring schedules):
# all-reduce moves 2(g-1)/g of the payload per link, one-shot
# gather/scatter/all_to_all (g-1)/g, permute 1
_ALL_REDUCE_KINDS = ("psum", "pmax", "pmin", "pmean")
_ONE_SHOT_KINDS = ("psum_scatter", "all_gather", "all_to_all")


def _kind_factor(kind: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind in _ALL_REDUCE_KINDS:
        return 2.0 * (g - 1) / g
    if kind in _ONE_SHOT_KINDS:
        return (g - 1) / g
    return 1.0  # ppermute and anything exotic: one payload per link


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """The hardware a candidate is priced for; every figure is given or
    measured, none defaults.

    ``collective_launch_s`` is the fixed cost of ONE collective (the term
    that separates a 62-collective per-leaf wire from an 11-bucket fused
    one moving the same bytes); ``op_cost_s`` prices one update-path op
    of the tape; ``compute_s`` is the per-worker forward + backward floor
    communication hides behind. ``power_limit`` is the card's
    (``nvidia-smi``), where the profile was measured on one."""

    name: str
    ici_gbs: float                  # one-way per-link GB/s of the worker axis
    dcn_gbs: float                  # per-host GB/s of the hierarchical grid's dcn axis
    collective_launch_s: float
    op_cost_s: float
    compute_s: float = 0.0
    source: str = "given"
    power_limit: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def load_hardware_profile(path: str, ici_gbs: Optional[float] = None,
                          dcn_gbs: Optional[float] = None) -> HardwareProfile:
    """A profile from a JSON file: a ``HardwareProfile.to_json()`` object
    or an autotune record (its ``hardware_profile``). Explicit
    ``ici_gbs`` / ``dcn_gbs`` win over the file's."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("kind") == "autotune":
        data = data["hardware_profile"]
    fields = {f.name for f in dataclasses.fields(HardwareProfile)}
    prof = HardwareProfile(**{k: v for k, v in data.items() if k in fields})
    over = {k: v for k, v in (("ici_gbs", ici_gbs), ("dcn_gbs", dcn_gbs)) if v is not None}
    if over:
        prof = dataclasses.replace(prof, source=f"{prof.source}; {sorted(over)} given", **over)
    return prof


def card_identity() -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=30).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in out.split(",", 1))
    return {"name": name, "power_limit": power}


def _time_s(fn, reps: int) -> float:
    """Median seconds of ``fn()`` on the card, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    return float(np.median(times))


def _link_gbs(axis, rows: int, device, big: int = 1 << 22) -> tuple:
    """(GB/s, launch seconds) of a stacked psum over ``axis``: the launch
    is its time at one element a row; the bandwidth the slope between
    rows of ``big`` and ``2 big`` elements (the fixed costs cancel), at
    the all-reduce factor, so ``comm_seconds_from_rows`` gives back the
    measured time."""
    import torch

    small = torch.ones((rows, 1), device=device)
    one = torch.ones((rows, big), device=device)
    two = torch.ones((rows, 2 * big), device=device)
    launch = _time_s(lambda: axis.psum(small), 50)
    slope = _time_s(lambda: axis.psum(two), 20) - _time_s(lambda: axis.psum(one), 20)
    gbs = _kind_factor("psum", rows) * big * 4 / max(slope, 1e-9) / 1e9
    return gbs, launch


def measure_card_profile(network: str, num_workers: int = 8, batch_per_worker: int = 8,
                         device="cuda") -> HardwareProfile:
    """The card's own profile (module docstring): measured now, on
    ``device``, for ``network`` at ``batch_per_worker`` images a worker."""
    import torch

    from .. import resolve_device
    from ..parallel.mesh import WorkerAxis, make_hybrid_mesh

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure_card_profile measures a card: pass device='cuda' (a CPU "
                         "search takes an explicit HardwareProfile)")
    ident = card_identity()
    ici_gbs, launch = _link_gbs(WorkerAxis(num_workers), num_workers, dev)
    grid = make_hybrid_mesh(2, num_workers // 2)
    dcn_gbs, _ = _link_gbs(grid.dcn, 2, dev)
    a = torch.ones((1024,), device=dev)
    b = torch.ones((1024,), device=dev)
    n_ops = 200

    def ops():
        for _ in range(n_ops):
            torch.add(a, b, out=a)

    op_cost = _time_s(ops, 5) / n_ops
    compute = _single_worker_step_s(network, batch_per_worker, dev)
    return HardwareProfile(
        name=ident["name"], ici_gbs=round(ici_gbs, 3), dcn_gbs=round(dcn_gbs, 3),
        collective_launch_s=launch, op_cost_s=op_cost, compute_s=compute,
        source=(f"measured on the card: {num_workers}-row and 2-row stacked psums, the slope "
                f"from 2^22 to 2^23 f32 a row (links), one element (launch), {n_ops} "
                f"1024-element adds (op), one worker's {network} step at batch "
                f"{batch_per_worker} (compute)"),
        power_limit=ident["power_limit"])


def _single_worker_step_s(network: str, batch: int, dev) -> float:
    """Seconds of one worker's uncompressed PS step (forward, backward,
    update) at ``batch`` images: the compute floor."""
    import torch

    from ..data import IMAGE_SHAPES, make_preprocessor
    from ..models import build_model
    from ..optim import build_optimizer
    from ..parallel.ps import PSConfig, draw_step, init_ps_state, make_ps_train_step
    from .search import MODELS

    dataset = next(p["dataset"] for p in MODELS.values() if p["network"] == network)
    cfg = PSConfig(num_workers=1)
    model = build_model(network)
    tx = build_optimizer("sgd", 0.01, momentum=0.9)
    pre = make_preprocessor(dataset, train=True)
    state = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(0), device=dev)
    step = make_ps_train_step(model, tx, cfg, preprocess=pre, device=dev)
    h, w, c = IMAGE_SHAPES[dataset]
    g = torch.Generator().manual_seed(0)
    batch_t = {"image": torch.randint(0, 256, (batch, h, w, c), dtype=torch.uint8,
                                      generator=g).to(dev),
               "label": torch.randint(0, 10, (batch,), generator=g).to(dev)}
    draws = draw_step(cfg, 0, 0, batch, preprocess=pre, model=model, device=dev)
    box = [state]

    def run():
        box[0], _ = step(box[0], batch_t, draws)

    return _time_s(run, 5)


def comm_seconds_from_rows(rows: Sequence[dict], axis_sizes: Dict[str, int],
                           profile: HardwareProfile) -> float:
    """Alpha-beta collective time for accounting rows shaped like the
    pscheck artifact's (``{kind, axes, dtype, count, bytes}``, bytes
    TOTAL across the row's count). Rows riding the dcn axis are priced
    on its link; the others on the worker axis's."""
    total = 0.0
    for row in rows:
        g = 1
        for ax in row.get("axes", ()):
            g *= int(axis_sizes.get(ax, 1))
        gbs = profile.dcn_gbs if "dcn" in row.get("axes", ()) else profile.ici_gbs
        total += _kind_factor(row["kind"], g) * row["bytes"] / (gbs * 1e9)
        total += int(row["count"]) * profile.collective_launch_s
    return total


def precision_mix_fraction(tags: Sequence[int], sizes: Sequence[int], hi_peak: int) -> float:
    """Effective-over-static wire fraction for an adaptive-precision tag
    vector: the bytes a byte-honest transport ships under ``tags``
    (``resilience.precision.effective_wire_bytes``) over the static int8
    baseline of one byte an element (> 1.0 is legal: HI tags on a wide
    payload cost more than int8)."""
    from ..resilience.precision import effective_wire_bytes

    sizes = np.asarray(sizes, np.int64)
    static = float(sizes.sum())
    if static <= 0:
        return 1.0
    return effective_wire_bytes(tags, sizes, hi_peak) / static


def expected_mixed_comm_seconds(rows: Sequence[dict], axis_sizes: Dict[str, int],
                                profile: HardwareProfile, fraction: float) -> float:
    """Alpha-beta comm time for an adaptive-precision candidate whose
    quantized payload ships ``fraction`` of its recorded bytes: integer
    rows scale, float rows (scales, peaks, telemetry) and every launch
    cost do not. An EXPECTED time: the recorded step's bytes never change
    with the tags (PSC108)."""
    if fraction < 0.0:
        raise ValueError(f"fraction must be >= 0, got {fraction}")
    scaled = []
    for row in rows:
        if str(row.get("dtype", "")).startswith(("int", "uint")):
            row = dict(row, bytes=row["bytes"] * fraction)
        scaled.append(row)
    return comm_seconds_from_rows(scaled, axis_sizes, profile)


def modeled_step_seconds(comm_s: float, overlap_headroom: Optional[float],
                         update_path_ops: int, profile: HardwareProfile) -> float:
    """THE step-time formula (module docstring), shared by the trace-only
    path (tape headroom) and the probe-calibrated path (measured dispatch
    fraction)."""
    exposed = comm_s * (1.0 - (overlap_headroom or 0.0))
    return profile.compute_s + update_path_ops * profile.op_cost_s + exposed


@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """One candidate's modeled cost and every input that produced it, so
    a record's costs can be re-derived through the live formula."""

    comm_rows: List[dict]           # full per-(kind, axes, dtype) accounting
    wire_bytes: int                 # gradient-path reduce bytes (PSC102 set)
    n_collectives: int              # every collective call of the step
    n_grad_reduces: int             # reduce-kind calls feeding the params
    update_path_ops: int            # tape nodes downstream of the reduce
    overlap_headroom: Optional[float]   # mean independent fraction
    mean_dispatch_prefix: Optional[float]
    comm_s: float
    exposed_comm_s: float
    compute_s: float
    update_s: float
    modeled_step_s: float

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("comm_s", "exposed_comm_s", "compute_s", "update_s", "modeled_step_s"):
            d[k] = round(d[k], 9)
        return d


def model_cost(result, profile: HardwareProfile, axis_sizes: Dict[str, int]) -> CandidateCost:
    """Cost one recorded candidate (a ``check.core.TraceResult`` carrying
    its tape: ``trace_spec(spec, keep_tape=True)``)."""
    from ..check.opcount import update_path_ops_from
    from ..check.walker import REDUCE_KINDS
    from ..parallel.overlap import overlap_headroom_from

    if result.tape is None:
        raise ValueError("model_cost needs the candidate's recorded tape: trace with "
                         "trace_spec(spec, keep_tape=True)")
    comm_s = comm_seconds_from_rows(result.summary, axis_sizes, profile)
    grad = [c for c in result.collectives if c.feeds_params and c.kind in REDUCE_KINDS]
    headrep = overlap_headroom_from(result.tape)
    headroom = headrep.get("overlap_headroom")
    ops = update_path_ops_from(result.tape)
    return CandidateCost(
        comm_rows=list(result.summary),
        wire_bytes=sum(c.bytes for c in grad),
        n_collectives=sum(int(r["count"]) for r in result.summary),
        n_grad_reduces=len(grad),
        update_path_ops=ops,
        overlap_headroom=headroom,
        mean_dispatch_prefix=headrep.get("mean_dispatch_prefix"),
        comm_s=comm_s,
        exposed_comm_s=comm_s * (1.0 - (headroom or 0.0)),
        compute_s=profile.compute_s,
        update_s=ops * profile.op_cost_s,
        modeled_step_s=modeled_step_seconds(comm_s, headroom, ops, profile),
    )


__all__ = ["CandidateCost", "HardwareProfile", "card_identity", "comm_seconds_from_rows",
           "expected_mixed_comm_seconds", "load_hardware_profile", "measure_card_profile",
           "model_cost", "modeled_step_seconds", "precision_mix_fraction"]
