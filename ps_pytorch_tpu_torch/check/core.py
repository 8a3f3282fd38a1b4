"""pscheck engine: record contract specs, run rules, round-trip the
committed accounting artifact (the port of check/core.py).

Tracing RUNS the step once (``walker.recording``) on the spec's own
small inputs, on the device the caller names: the CPU runs the plain
versions of the kernels, the card the kernels. Everything downstream
of the tape is pure data.

The donation check of the JAX package (donated buffers surviving
lowering as aliases) has no torch counterpart: torch donates nothing.
It is restated as what donation buys a long run:

- the step's returned state matches its input state leaf for leaf, in
  tree structure, shape and dtype (a mismatch is the JAX check's "XLA
  cannot alias mismatched buffers");
- once the caller drops the input state, no input-state storage stays
  alive unless the returned state reuses it (weakrefs, with the garbage
  collector off: a reference cycle or a cache keeping last step's
  tensors is the F3 class of leak).

A serving step's contract is the KV pool written in place: the same
storages before and after, in the declared dtype (PSC107 reads it).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import weakref
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import DeviceLike, resolve_device
from .contracts import ContractSpec
from .walker import Collective, Tape, collect_collectives, recording, summarize

CONTRACT_VERSION = 1
# the port's own committed artifact, beside this module: the card's
# machine reads it without the JAX package and without runs/
DEFAULT_CONTRACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "comm_contract.json")


@dataclasses.dataclass(frozen=True)
class CheckFinding:
    rule: str
    config: str
    message: str

    def to_json(self) -> dict:
        return {"rule": self.rule, "config": self.config, "message": self.message}


@dataclasses.dataclass
class TraceResult:
    """One contract spec's measured truth."""

    spec: ContractSpec
    collectives: List[Collective]
    summary: List[dict]               # PSC104 accounting rows
    donation_mismatches: List[str]    # restated PSC105: structure / shape /
                                      # dtype mismatches and leaked storages
    kv_leaves: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
                                      # (path, dtype) of the KV pool arg
                                      # (PSC107 storage-dtype policy)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
                                      # kernel nodes on the tape by
                                      # "<id>:<entry>" (e.g. "K2:quantize_tensors")
    tape: Optional[Tape] = None       # the recorded step, kept only when
                                      # trace_spec(keep_tape=True): the cost
                                      # model derives update-path ops and
                                      # overlap headroom from the SAME record
                                      # the rules ran on
    numerics: Any = None              # NumericsReport (check/numerics.py)
                                      # from the same tape, whenever
                                      # spec.numerics is set (PSC111-114)


def leaves_with_paths(obj, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a tree of dicts, lists, tuples and dataclasses
    (paths as ``jax.tree_util.keystr`` spells dict keys: ``['k_q']``);
    a non-tensor leaf (an int, None) is kept as itself."""
    if isinstance(obj, dict):
        out = []
        for k in sorted(obj):
            out.extend(leaves_with_paths(obj[k], f"{path}['{k}']"))
        return out
    if isinstance(obj, (list, tuple)):
        out = []
        for i, x in enumerate(obj):
            out.extend(leaves_with_paths(x, f"{path}[{i}]"))
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = []
        for f in dataclasses.fields(obj):
            out.extend(leaves_with_paths(getattr(obj, f.name), f"{path}.{f.name}"))
        return out
    return [(path, obj)]


def _spec_of(leaf) -> Any:
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
    return ("leaf", type(leaf).__name__)


def _structure_mismatches(argnum: int, pos: int, before, after) -> List[str]:
    """The restated donation contract's first half: the returned state
    matches the consumed one leaf for leaf."""
    ins, outs = leaves_with_paths(before), leaves_with_paths(after)
    if [p for p, _ in ins] != [p for p, _ in outs]:
        return [f"arg {argnum}: consumed state's tree structure != output {pos}'s "
                f"(the step cannot hand its state back for the next call)"]
    out = []
    for (path, a), (_, b) in zip(ins, outs):
        sa, sb = _spec_of(a), _spec_of(b)
        if sa != sb and (sa[0] == "tensor" or sb[0] == "tensor"):
            out.append(f"arg {argnum} leaf {path}: consumed {sa[2] if sa[0] == 'tensor' else sa}"
                       f"{list(sa[1]) if sa[0] == 'tensor' else ''} but output {pos} returns "
                       f"{sb[2] if sb[0] == 'tensor' else sb}"
                       f"{list(sb[1]) if sb[0] == 'tensor' else ''} — the state changes "
                       f"shape or dtype from step to step")
    return out


def _storages(tree) -> set:
    return {t.untyped_storage().data_ptr() for _, t in leaves_with_paths(tree)
            if isinstance(t, torch.Tensor) and t.untyped_storage().nbytes()}


def _donation(spec: ContractSpec, args, out):
    """The restated PSC105 over one recorded call: ``(mismatches, weak
    references to the consumed state's tensors the returned state does
    not reuse)``."""
    don = spec.donation
    if don is None:
        return [], []
    outs = out if isinstance(out, tuple) else (out,)
    mismatches: List[str] = []
    for argnum, pos in zip(don.argnums, don.out_positions):
        mismatches += _structure_mismatches(argnum, pos, args[argnum], outs[pos])
    kept = _storages([outs[pos] for pos in don.out_positions])
    if spec.serve is not None and not _storages(args[spec.serve.kv_argnum]) <= kept:
        mismatches.append(f"arg {spec.serve.kv_argnum}: the KV pool is not written in place "
                          f"(the returned pool holds other storages)")
    refs = []
    for argnum in don.argnums:
        for path, t in leaves_with_paths(args[argnum]):
            if (isinstance(t, torch.Tensor) and t.untyped_storage().nbytes()
                    and t.untyped_storage().data_ptr() not in kept):
                refs.append((argnum, path, weakref.ref(t)))
    return mismatches, refs


def trace_spec(spec: ContractSpec, keep_tape: bool = False,
               device: DeviceLike = None) -> TraceResult:
    """Record one contract's real step on ``device`` (the card unless the
    caller passes ``device="cpu"``) and measure its collectives.
    ``keep_tape=True`` keeps the tape on the result."""
    built = spec.build(resolve_device(device))
    step, args, kwargs = built.step, list(built.args), dict(built.kwargs)
    built.args = None
    kv_leaves: List[Tuple[str, str]] = []
    if spec.serve is not None:
        kv_leaves = [(p, str(t.dtype).replace("torch.", ""))
                     for p, t in leaves_with_paths(args[spec.serve.kv_argnum])
                     if isinstance(t, torch.Tensor)]
    gc_was = gc.isenabled()
    gc.disable()  # a leak must show with reference counting alone
    try:
        with recording(built.devices) as tape:
            tape.mark_inputs((args, kwargs))
            out = step(*args, **kwargs)
        params_nodes = tape.producers(built.select_params(out))
        param_vids = tape.value_ids(built.select_params(out))
        out_vids = tape.value_ids(out)
        mismatches, refs = _donation(spec, args, out)
        del args
        leaked = [(a, p) for a, p, r in refs if r() is not None]
    finally:
        if gc_was:
            gc.enable()
    for argnum, path in leaked:
        mismatches.append(f"arg {argnum} leaf {path}: the consumed state's storage stays "
                          f"alive after the caller drops it (a reference cycle or a cache "
                          f"holds last step's tensors)")
    colls = collect_collectives(tape, params_nodes)
    numerics = None
    if spec.numerics is not None:
        from .numerics import analyze_numerics

        numerics = analyze_numerics(tape, param_vids, out_vids)
    return TraceResult(spec=spec, collectives=colls, summary=summarize(colls),
                       donation_mismatches=mismatches, kv_leaves=kv_leaves,
                       kernels=dict(Counter(f"{n.kernel}:{n.name}" for n in tape.nodes
                                            if n.op == "kernel")),
                       tape=tape if keep_tape else None, numerics=numerics)


def trace_registry(specs: Sequence[ContractSpec], only: Optional[Sequence[str]] = None,
                   device: DeviceLike = None) -> List[TraceResult]:
    chosen = [s for s in specs if only is None or s.name in only]
    device = resolve_device(device)
    return [trace_spec(s, device=device) for s in chosen]


# ---------------------------------------------------------------- artifact

def to_contract_json(results: Sequence[TraceResult]) -> dict:
    from .contracts import MESH_DEVICES

    return {
        "version": CONTRACT_VERSION,
        "tool": "pscheck",
        "mesh_devices": MESH_DEVICES,
        "configs": {
            r.spec.name: {
                "axes": list(r.spec.axes),
                "collectives": r.summary,
                "n_collectives": sum(row["count"] for row in r.summary),
                "total_bytes": sum(row["bytes"] for row in r.summary),
            }
            for r in sorted(results, key=lambda r: r.spec.name)
        },
    }


def load_contract(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("tool") != "pscheck":
        raise ValueError(f"{path} is not a pscheck contract artifact")
    return data


def write_contract(path: str, results: Sequence[TraceResult]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_contract_json(results), f, indent=2, sort_keys=True)
        f.write("\n")


def run_checks(results: Sequence[TraceResult], contract: Optional[dict],
               check_stale: bool = True) -> List[CheckFinding]:
    """Run every rule over recorded results; ``contract`` is the
    committed artifact (None skips PSC104, as --write-contract does)."""
    from .rules import check_result, psc104_roundtrip, psc109_schedule, psc110_consensus

    findings: List[CheckFinding] = []
    for r in results:
        findings.extend(check_result(r))
    findings.extend(psc109_schedule(results))
    findings.extend(psc110_consensus(results))
    if contract is not None:
        findings.extend(psc104_roundtrip(results, contract, check_stale=check_stale))
    findings.sort(key=lambda f: (f.config, f.rule, f.message))
    return findings


def render_text(findings: Sequence[CheckFinding], n_configs: int) -> str:
    out: List[str] = [f"{f.config}: {f.rule} {f.message}" for f in findings]
    rules = sorted({f.rule for f in findings})
    out.append(f"pscheck: {len(findings)} finding(s)"
               + (f" ({', '.join(rules)})" if rules else "")
               + f" across {n_configs} traced config(s)")
    return "\n".join(out)
