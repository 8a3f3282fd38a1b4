"""Contract-guarded knob search (the port of tune/search.py): enumerate
candidate configs, prune the broken ones with the PSC101-114 rules, rank
the survivors by modeled cost, optionally measure the top-K with short
probes on the card.

The pipeline per candidate:

1. the knob point's ``PSConfig``: a combination the engine refuses (a
   pipelined per-leaf wire, a homomorphic uncompressed one) is PRUNED at
   the ``config`` stage with the engine's message;
2. a ``ContractSpec`` through the SAME constructor the committed registry
   uses (``check/contracts._ps_spec``), so the candidate's declared
   invariants derive from its knobs as a registry entry's would;
3. the REAL train step recorded once (``check.core.trace_spec``, at the
   registry's small sizes, on the search's device) and the contract
   rules run on it, PSC111-114 included: a violation prunes the point at
   the ``contract`` stage with the findings attached;
4. the survivors costed with the trace-only model (``costmodel.py``)
   and ranked ascending by modeled step time;
5. optionally, short measured probes on the top-K: real steps of the
   port's PS step with 8 stacked workers at the preset's probe batch on
   the card (K2, K1 and K3 run inside as the knobs say; their
   ``.launches`` deltas are in the probe), an in-memory tracer splitting
   dispatch from the host sync (``torch.cuda.synchronize``). The
   span-derived fraction feeds back into the same step-time formula,
   and every probe stamps its backend so mixed-backend comparisons are
   refused, never averaged.

Unlike JAX's search, a candidate whose recording raises anything but
the engine's config refusal is not pruned: the search fails, so a kernel
that does not build or launch on the card can never hide as a pruned
point.

The record (``kind: "autotune"``, schema-validated, run_header included)
carries, for the best candidate, a flag line ``cli.train --config-json``
applies directly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import DeviceLike, resolve_device
from .costmodel import HardwareProfile, measure_card_profile, model_cost, modeled_step_seconds

# knob-space presets per tuned model (JAX's): ``buckets`` the bucket
# ladder (None = per-leaf, 0 = one fused buffer, N = ~N-byte buckets)
MODELS: Dict[str, Dict[str, Any]] = {
    "lenet": {"network": "LeNet", "dataset": "MNIST", "buckets": (None, 0, 64 << 10),
              "probe_batch": 64},
    "resnet18": {"network": "ResNet18", "dataset": "Cifar10", "buckets": (None, 0, 4 << 20),
                 "probe_batch": 64},
}

# the regression gate's margin (JAX's): the tuned config's modeled step
# time must beat the CLI default's by this factor. LeNet has none: at a
# ~1.7 MB payload the default per-leaf f32 wire models near-optimal.
GATE_MIN_SPEEDUP = {"resnet18": 1.03}


@dataclasses.dataclass(frozen=True)
class Knobs:
    """One point of the knob space (the searchable subset of PSConfig)."""

    compress: Optional[str] = None      # None | "int8" | "int8_2round"
    bucket_bytes: Optional[int] = None  # None = per-leaf, 0 = fused, N
    overlap: str = "serial"             # "serial" | "pipelined"
    opt_placement: str = "replicated"   # "replicated" | "sharded"
    quant_block_size: int = 0
    state_layout: str = "flat"
    wire_domain: str = "dequant"        # "dequant" | "homomorphic"

    def bucket_tag(self) -> str:
        bb = self.bucket_bytes
        if not bb:
            return ""
        return f"{bb >> 10}k" if bb % 1024 == 0 else str(bb)

    def flags(self, network: str, dataset: str) -> Dict[str, Any]:
        """The cli.train flags reproducing this point (the --config-json
        round-trip surface)."""
        return {
            "--network": network,
            "--dataset": dataset,
            "--compress-grad": {None: "none", "int8": "compress",
                                "int8_2round": "2round"}[self.compress],
            "--bucket-bytes": -1 if self.bucket_bytes is None else self.bucket_bytes,
            "--overlap": "on" if self.overlap == "pipelined" else "off",
            "--opt-placement": self.opt_placement,
            "--quant-block-size": self.quant_block_size,
            "--state-layout": self.state_layout,
            "--wire-domain": self.wire_domain,
        }

    def config(self, num_workers: int):
        """The point's PSConfig (raises the engine's ValueError for a
        combination it refuses)."""
        from ..parallel.ps import PSConfig

        return PSConfig(num_workers=num_workers, compress=self.compress,
                        bucket_bytes=self.bucket_bytes, overlap=self.overlap,
                        opt_placement=self.opt_placement,
                        quant_block_size=self.quant_block_size,
                        state_layout=self.state_layout, wire_domain=self.wire_domain)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def flag_line(flags: Dict[str, Any]) -> str:
    return " ".join(f"{k} {v}" for k, v in flags.items())


DEFAULT_KNOBS = Knobs()  # == cli.train defaults: per-leaf f32 serial


def build_grid(model: str, grid: str = "default") -> List[Knobs]:
    """The knob grid for one model (JAX's presets): ``default`` the full
    compress x bucket x overlap x placement product plus the showcase
    points (a block-32 fused two-round wire PSC103 prunes, a tree-state
    twin, the homomorphic twins); ``smoke`` a trimmed replicated grid;
    ``tiny`` one of everything."""
    preset = MODELS[model]
    per_leaf, fused, bucketed = preset["buckets"]
    out: List[Knobs] = []
    if grid == "default":
        for compress in (None, "int8", "int8_2round"):
            for bb in preset["buckets"]:
                for overlap in ("serial", "pipelined"):
                    for placement in ("replicated", "sharded"):
                        if placement == "sharded" and bb is None:
                            continue
                        out.append(Knobs(compress=compress, bucket_bytes=bb, overlap=overlap,
                                         opt_placement=placement))
        out.append(Knobs(compress="int8_2round", bucket_bytes=fused, quant_block_size=32))
        out.append(Knobs(compress="int8", bucket_bytes=bucketed, state_layout="tree"))
        out.append(Knobs(compress="int8", bucket_bytes=bucketed, wire_domain="homomorphic"))
        out.append(Knobs(compress="int8", bucket_bytes=bucketed, overlap="pipelined",
                         wire_domain="homomorphic"))
        out.append(Knobs(compress="int8_2round", bucket_bytes=fused, wire_domain="homomorphic"))
        return out
    if grid == "smoke":
        for compress in (None, "int8"):
            for bb in preset["buckets"]:
                for overlap in ("serial", "pipelined"):
                    out.append(Knobs(compress=compress, bucket_bytes=bb, overlap=overlap))
        out.append(Knobs(compress="int8_2round", bucket_bytes=fused, quant_block_size=32))
        out.append(Knobs(compress="int8_2round", bucket_bytes=bucketed))
        out.append(Knobs(compress="int8", bucket_bytes=fused, wire_domain="homomorphic"))
        return out
    if grid == "tiny":
        return [
            Knobs(),
            Knobs(compress=None, bucket_bytes=fused),
            Knobs(compress="int8", bucket_bytes=fused),
            Knobs(compress="int8", bucket_bytes=bucketed),
            Knobs(compress="int8", bucket_bytes=bucketed, overlap="pipelined"),
            Knobs(compress="int8", bucket_bytes=bucketed, wire_domain="homomorphic"),
            Knobs(compress="int8", overlap="pipelined"),                 # config-invalid
            Knobs(compress=None, wire_domain="homomorphic"),             # config-invalid
            Knobs(compress="int8_2round", bucket_bytes=fused, quant_block_size=32),  # PSC103
        ]
    raise ValueError(f"unknown grid {grid!r} (default, smoke, tiny)")


def spec_for(knobs: Knobs, network: str):
    """The candidate's ContractSpec, built by the registry's own spec
    constructor."""
    from ..check.contracts import _ps_spec

    return _ps_spec(knobs.compress, knobs.opt_placement, bucket_bytes=knobs.bucket_bytes,
                    network=network, state_layout=knobs.state_layout, overlap=knobs.overlap,
                    bucket_tag=knobs.bucket_tag(), quant_block_size=knobs.quant_block_size,
                    wire_domain=knobs.wire_domain)


def backend_info(device: DeviceLike = None) -> Dict[str, Optional[str]]:
    """The backend every probe (and the record) stamps: ``platform``
    "gpu" and the card's name on the card, "cpu" on the CPU."""
    import torch

    dev = resolve_device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "device_kind": "cpu"}


def require_same_backend(records: Sequence[Dict[str, Any]]) -> None:
    """Refuse to compare measurements taken on different backends."""
    seen = {(r.get("platform"), r.get("device_kind")) for r in records if r is not None}
    if len(seen) > 1:
        raise SystemExit(f"refusing to compare measurements across backends: "
                         f"{sorted(seen, key=str)} — re-run the probes on one backend")


def kernel_launches() -> Dict[str, int]:
    """The ``.launches`` counters of the quantize kernels' wrappers,
    summed by kernel id (K1: every K1 entry; K2: every K2 entry)."""
    from ..ops import quantize as q

    k1 = (q.quantize_rows, q.quantize_rows_many, q.quantize_kv_write,
          q.quantize_rows_scaled_many, q.rows_scaled_absmax, q.quantize_rows_scaled_given)
    k2 = (q.quantize_tensors, q.tensors_absmax, q.quantize_tensors_given)
    return {"K1": sum(f.launches for f in k1), "K2": sum(f.launches for f in k2),
            "K3": q.accumulate_rescale_int8.launches}


def measure_probe(knobs: Knobs, network: str, dataset: str, steps: int = 4, batch: int = 64,
                  num_workers: int = 8, device: DeviceLike = None) -> Dict[str, Any]:
    """One short measured probe: ``steps`` real steps of the port's PS
    step (``num_workers`` stacked workers, ``batch`` images in all) after
    two warm-up steps, each split into a dispatch span and a sync span
    (``torch.cuda.synchronize`` on the card). Returns the measured step
    time, the span-derived dispatch fraction, the kernels' launches over
    the timed steps and the backend stamp."""
    import torch

    from ..data import IMAGE_SHAPES, make_preprocessor, make_synthetic
    from ..models import build_model
    from ..obs.trace import Tracer, summarize_spans
    from ..optim import build_optimizer
    from ..parallel.ps import draw_step, init_ps_state, make_ps_train_step
    from ..utils import host_sync

    dev = resolve_device(device)
    cfg = knobs.config(num_workers)
    tx = build_optimizer("sgd", 0.01, momentum=0.9)
    model = build_model(network)
    ds = make_synthetic(dataset, train_size=batch, test_size=8, seed=0)
    pre = make_preprocessor(dataset, train=True)
    state = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(0), device=dev)
    step = make_ps_train_step(model, tx, cfg, preprocess=pre, device=dev)
    data = {"image": torch.from_numpy(ds.train_images).to(dev),
            "label": torch.from_numpy(ds.train_labels.astype("int64")).to(dev)}
    assert tuple(data["image"].shape[1:]) == tuple(IMAGE_SHAPES[dataset])
    draws = draw_step(cfg, 0, 0, batch // num_workers, preprocess=pre, model=model, device=dev)
    for _ in range(2):  # warm-up, then an idle device before the timed window
        state, metrics = step(state, data, draws)
    host_sync(state.params, metrics)
    tracer = Tracer("autotune_probe", path=None)
    before = kernel_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        with tracer.span("dispatch"):
            state, metrics = step(state, data, draws)
        with tracer.span("sync"):
            host_sync(state.params, metrics)
    elapsed = time.perf_counter() - t0
    after = kernel_launches()
    spans = summarize_spans(tracer.drain())
    d = spans.get("dispatch", {}).get("total_s", 0.0)
    y = spans.get("sync", {}).get("total_s", 0.0)
    return {
        "measured_step_s": round(elapsed / steps, 6),
        "overlap_fraction_spans": round(d / (d + y), 4) if (d + y) > 0 else None,
        "steps": steps,
        "batch": batch,
        "launches": {k: after[k] - before[k] for k in after},
        **backend_info(dev),
    }


def _prune_entry(knobs: Knobs, name: Optional[str], stage: str, reason: str,
                 rules: Sequence[str] = ()) -> dict:
    return {"name": name, "knobs": knobs.to_json(), "stage": stage,
            "rules": sorted(set(rules)), "reason": reason}


def run_search(model: str, grid: str = "default", profile: Optional[HardwareProfile] = None,
               probe_top: int = 0, probe_steps: int = 4, progress=None,
               device: DeviceLike = None, probe_names: Sequence[str] = ()) -> dict:
    """The full search: enumerate -> prune (config, then PSC101-114) ->
    cost -> rank [-> probe the top-K, and the candidates ``probe_names``
    names] on ``device`` (the card unless the caller passes
    ``device="cpu"``). ``profile`` None measures the card's
    (``measure_card_profile``); a CPU search must pass one. Returns the
    evidence record (schema-validated); the caller writes it."""
    from ..check.contracts import MESH_DEVICES
    from ..check.core import trace_spec
    from ..check.rules import check_result, psc109_schedule
    from ..obs.schema import run_header, validate_event
    from ..utils.compile_cache import enable_persistent_compile_cache

    say = progress or (lambda *_: None)
    dev = resolve_device(device)
    preset = MODELS[model]
    network, dataset = preset["network"], preset["dataset"]
    # candidates record on the registry's mesh of 8 stacked workers: the
    # model prices THAT geometry (probes stamp their backend separately)
    axis_sizes = {"workers": MESH_DEVICES}
    if profile is None:
        if dev.type != "cuda":
            raise ValueError("a CPU search takes an explicit HardwareProfile (no figure of "
                             "any hardware is a default)")
        profile = measure_card_profile(network, MESH_DEVICES,
                                       preset["probe_batch"] // MESH_DEVICES, dev)
    enable_persistent_compile_cache(dev)  # every kernel built before the first candidate

    t_start = time.perf_counter()
    points = build_grid(model, grid)
    pruned: List[dict] = []
    traced: List[Tuple[Knobs, Any]] = []
    for kn in points:
        try:
            kn.config(MESH_DEVICES)
        except ValueError as e:  # the engine refuses the combination
            pruned.append(_prune_entry(kn, None, "config", str(e)))
            say(f"prune [config] {kn.to_json()}: {e}")
            continue
        traced.append((kn, trace_spec(spec_for(kn, network), keep_tape=True, device=dev)))

    # the rules as search constraints: per-result ones and the
    # cross-result PSC109 (serial twins are in the grid); PSC104 is the
    # registry gate's, candidates are not pinned
    findings_by_name: Dict[str, List] = {}
    for _, r in traced:
        for f in check_result(r):
            findings_by_name.setdefault(f.config, []).append(f)
    for f in psc109_schedule([r for _, r in traced]):
        findings_by_name.setdefault(f.config, []).append(f)

    survivors: List[Tuple[Knobs, Any]] = []
    for kn, r in traced:
        hits = findings_by_name.get(r.spec.name, [])
        if hits:
            pruned.append(_prune_entry(kn, r.spec.name, "contract",
                                       "; ".join(f.message for f in hits),
                                       rules=[f.rule for f in hits]))
            say(f"prune [contract] {r.spec.name}: {sorted({f.rule for f in hits})}")
        else:
            survivors.append((kn, r))

    candidates: List[dict] = []
    for kn, r in survivors:
        candidates.append({"name": r.spec.name, "knobs": kn.to_json(),
                           "flags": kn.flags(network, dataset),
                           "cost": model_cost(r, profile, axis_sizes).to_json()})
        r.tape = None  # the costed tape is not kept past its candidate
    candidates.sort(key=lambda c: c["cost"]["modeled_step_s"])
    for rank, c in enumerate(candidates):
        c["rank"] = rank
    say(f"{len(candidates)} candidate(s) ranked, {len(pruned)} pruned")

    unknown = sorted(set(probe_names) - {c["name"] for c in candidates})
    if unknown:
        raise ValueError(f"no ranked candidate named {unknown} to probe")
    chosen = candidates[:probe_top] + [c for c in candidates[probe_top:]
                                       if c["name"] in set(probe_names)]
    if chosen:
        probes = []
        for c in chosen:
            say(f"probe {c['name']} ({probe_steps} steps)")
            probe = measure_probe(Knobs(**c["knobs"]), network, dataset, steps=probe_steps,
                                  batch=preset["probe_batch"], num_workers=MESH_DEVICES,
                                  device=dev)
            c["probe"] = probe
            c["cost"]["modeled_step_probe_s"] = round(modeled_step_seconds(
                c["cost"]["comm_s"], probe["overlap_fraction_spans"],
                c["cost"]["update_path_ops"], profile), 9)
            probes.append(probe)
        require_same_backend(probes)

    default_name = spec_for(DEFAULT_KNOBS, network).name
    default = next((c for c in candidates if c["name"] == default_name), None)
    best = candidates[0] if candidates else None
    gate: Dict[str, Any] = {"min_modeled_speedup": GATE_MIN_SPEEDUP.get(model),
                            "modeled_speedup": None}
    if best and default:
        gate["modeled_speedup"] = round(default["cost"]["modeled_step_s"]
                                        / max(best["cost"]["modeled_step_s"], 1e-12), 4)
    backend = backend_info(dev)
    header = validate_event(run_header("autotune", geometry={
        "workload": "autotune", "model": model, "devices": MESH_DEVICES,
        "device_kind": backend["device_kind"]}))
    return validate_event({
        "kind": "autotune",
        "run": header,
        "model": model,
        "network": network,
        "grid": grid,
        "backend": backend,
        "trace_only": not chosen,
        "hardware_profile": profile.to_json(),
        "n_points": len(points),
        "n_candidates": len(candidates),
        "n_pruned": len(pruned),
        "elapsed_s": round(time.perf_counter() - t_start, 3),
        "gate": gate,
        "default": default,
        "best": dict(best, flag_line=flag_line(best["flags"])) if best else None,
        "candidates": candidates,
        "pruned": pruned,
    })
