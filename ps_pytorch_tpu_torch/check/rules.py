"""pscheck rules PSC101-PSC110 over a recorded step (the port of
check/rules.py; the table of what each rule guards is JAX's):

| rule   | guards against                                                  |
|--------|-----------------------------------------------------------------|
| PSC101 | a declared mesh axis no collective consumes, or a collective    |
|        | riding an axis the scheme never declared                        |
| PSC102 | a gradient reduction that no longer feeds the optimizer (the    |
|        | tape's dataflow: a metrics pmean over the axis does not count)  |
| PSC103 | wire-dtype regressions on compressed paths                      |
| PSC104 | silent wire-byte drift against the committed artifact           |
|        | (``check/comm_contract.json``, the port's own)                  |
| PSC105 | the restated donation contract (core.py): the returned state    |
|        | matches the consumed one leaf for leaf, and no consumed storage |
|        | outlives the caller's reference                                 |
| PSC106 | silent de-fusion on a bucketed wire                             |
| PSC107 | serving hot-path regressions: any collective in the decode      |
|        | step, or a KV pool leaf off its declared storage dtype          |
| PSC108 | adaptive-mask / adaptive-precision configs without grad_reduce, |
|        | or moving more reduce bytes than their envelope                 |
| PSC109 | a pipelined config that moves other bytes than its serial twin  |
|        | or re-fused into fewer reduces than its buckets                 |
| PSC110 | an adaptive config naming no host-consensus point, or one that  |
|        | is not in the port's consensus inventory (lint/diverge.py)      |
| PSC111 | fresh or mismatched scale rows: every dequantize's scale must   |
|        | descend from the max-abs reduction behind its quantize's scale  |
|        | (check/numerics.py provenance roots)                            |
| PSC112 | broken error-feedback closure: every primary site on the        |
|        | gradient path needs a grad - dequant(quant) residual feeding    |
|        | the carry, and not the updated params too                       |
| PSC113 | integer-accumulation overflow proven from the recorded bounds   |
|        | (clamp peak x the recording axes' summand counts), a lattice    |
|        | reduce off the declared accumulator, a saturating requantize    |
| PSC114 | a silent precision-narrowing convert downstream of the gradient |
|        | reduce on the update path                                       |

PSC111-114 read the ``NumericsReport`` that ``core.trace_spec`` derives
from the same tape whenever the spec declares a ``NumericsPolicy``. A
tape is straight-line (no loop carry), so JAX's "cannot prove ... across
a scan/while carry" findings have no counterpart.

The messages are JAX's, reworded where a jaxpr term has no meaning for a
recorded step ("equation" is a call, "lowering" the recorded run).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .core import CheckFinding, TraceResult
from .walker import REDUCE_KINDS

RULE_IDS = ("PSC101", "PSC102", "PSC103", "PSC104", "PSC105", "PSC106",
            "PSC107", "PSC108", "PSC109", "PSC110", "PSC111", "PSC112",
            "PSC113", "PSC114")


def psc101_axes(r: TraceResult) -> List[CheckFinding]:
    declared = set(r.spec.axes)
    used = set()
    for c in r.collectives:
        used.update(c.axes)
    out = []
    for ax in sorted(declared - used):
        out.append(CheckFinding(
            "PSC101", r.spec.name,
            f"declared mesh axis '{ax}' is consumed by no collective "
            f"(dead parallel axis — dropped reduction?)"))
    for ax in sorted(used - declared):
        out.append(CheckFinding(
            "PSC101", r.spec.name,
            f"collective rides undeclared axis '{ax}' (declared: {sorted(declared)})"))
    return out


def psc102_grad_reduce(r: TraceResult) -> List[CheckFinding]:
    out = []
    for req in r.spec.grad_reduce:
        hit = any(c.feeds_params and req.axis in c.axes and c.kind in req.kinds
                  for c in r.collectives)
        if not hit:
            near = any(req.axis in c.axes and c.kind in req.kinds for c in r.collectives)
            hint = (" (a matching reduce exists but feeds only non-param outputs, "
                    "e.g. metrics)" if near else "")
            out.append(CheckFinding(
                "PSC102", r.spec.name,
                f"no {'/'.join(req.kinds)} over axis '{req.axis}' feeds the updated params "
                f"— replicated gradient leaves are not reduced before the optimizer{hint}"))
    return out


def psc103_wire(r: TraceResult) -> List[CheckFinding]:
    wire = r.spec.wire
    if wire is None:
        return []
    out = []
    for c in r.collectives:
        if not set(c.axes) & set(wire.axes) or c.dtype == wire.payload_dtype:
            continue
        allowed = False
        for a in wire.allow:
            if a.kind != c.kind or a.dtype != c.dtype:
                continue
            if a.axes is not None and not set(c.axes) <= set(a.axes):
                continue
            if a.max_bytes is not None and c.bytes > a.max_bytes:
                continue
            allowed = True
            break
        if not allowed:
            out.append(CheckFinding(
                "PSC103", r.spec.name,
                f"{c.kind} over {list(c.axes)} carries {c.dtype} ({c.bytes} B) on a "
                f"declared {wire.payload_dtype} wire — compression regression (no "
                f"allowance covers it)"))
    return out


def psc105_donation(r: TraceResult) -> List[CheckFinding]:
    if r.spec.donation is None:
        return []
    return [CheckFinding("PSC105", r.spec.name, msg) for msg in r.donation_mismatches]


def _grad_reduce_bytes(r: TraceResult) -> int:
    return sum(c.bytes for c in r.collectives if c.feeds_params and c.kind in REDUCE_KINDS)


def _grad_reduce_count(r: TraceResult) -> int:
    return sum(1 for c in r.collectives if c.feeds_params and c.kind in REDUCE_KINDS)


def psc106_fusion(r: TraceResult) -> List[CheckFinding]:
    """The reduce-kind collectives on the gradient path against the
    declared bucket budget."""
    fu = r.spec.fusion
    if fu is None:
        return []
    got = _grad_reduce_count(r)
    if got <= fu.max_collectives:
        return []
    granularity = ("one fused buffer" if not fu.bucket_bytes
                   else f"{fu.n_buckets} bucket(s) of ~{fu.bucket_bytes} B")
    return [CheckFinding(
        "PSC106", r.spec.name,
        f"{got} gradient-path reduce collectives, but the declared bucket plan "
        f"({granularity} over {fu.payload_bytes} B payload, per_bucket={fu.per_bucket}, "
        f"slack={fu.slack}) allows at most {fu.max_collectives} — the wire has silently "
        f"de-fused (per-leaf collectives crept back in?)")]


def psc107_serve(r: TraceResult) -> List[CheckFinding]:
    """The serving hot path: zero collectives + KV storage dtype policy."""
    sp = r.spec.serve
    if sp is None:
        return []
    out = [CheckFinding(
        "PSC107", r.spec.name,
        f"{c.kind} over {list(c.axes)} [{c.dtype}, {c.bytes} B] on the serving hot path — "
        f"the decode step is slot-parallel and must make zero collectives")
        for c in r.collectives]
    for path, dtype in r.kv_leaves:
        if sp.quantized:
            if path.endswith("_q']"):
                want = "int8"
            elif path.endswith("_s']"):
                want = "float32"
            else:
                out.append(CheckFinding(
                    "PSC107", r.spec.name,
                    f"KV pool leaf {path} [{dtype}] on a declared int8 pool is neither "
                    f"payload (*_q) nor scale row (*_s) — unquantized storage crept in"))
                continue
        else:
            want = sp.kv_dtype
        if dtype != want:
            out.append(CheckFinding(
                "PSC107", r.spec.name,
                f"KV pool leaf {path} carries {dtype}, declared storage dtype is {want} — "
                f"serving cache dtype regression"))
    return out


def psc108_adaptive(r: TraceResult) -> List[CheckFinding]:
    ap = r.spec.adaptive
    if ap is None:
        return []
    out = []
    if not r.spec.grad_reduce:
        out.append(CheckFinding(
            "PSC108", r.spec.name,
            "adaptive aggregation declared but no grad_reduce requirement — without it "
            "PSC102 cannot pin the masked reduce's dataflow to the updated params"))
    got = _grad_reduce_bytes(r)
    if got > ap.envelope_bytes:
        out.append(CheckFinding(
            "PSC108", r.spec.name,
            f"gradient-path reduce collectives move {got} B, but the adaptive envelope "
            f"(counts {ap.min_aggregate}-{ap.max_aggregate}) declares at most "
            f"{ap.envelope_bytes} B — the mask count must reshape values, not add wire "
            f"bytes"))
    return out


def psc108_precision(r: TraceResult) -> List[CheckFinding]:
    pp = r.spec.precision
    if pp is None:
        return []
    out = []
    if not r.spec.grad_reduce:
        out.append(CheckFinding(
            "PSC108", r.spec.name,
            "adaptive precision declared but no grad_reduce requirement — without it "
            "PSC102 cannot pin the tagged reduce's dataflow to the updated params"))
    got = _grad_reduce_bytes(r)
    if got > pp.envelope_bytes:
        out.append(CheckFinding(
            "PSC108", r.spec.name,
            f"gradient-path reduce collectives move {got} B, but the precision envelope "
            f"({pp.n_buckets} bucket tags) declares at most {pp.envelope_bytes} B — "
            f"precision tags must reshape values on the lattice, not add wire bytes"))
    return out


def psc109_schedule(results: Sequence[TraceResult]) -> List[CheckFinding]:
    """Schedule invariance for pipelined configs (across results):
    byte equality with the serial twin when it was recorded in the same
    batch, and at least one reduce a bucket feeding the params."""
    out: List[CheckFinding] = []
    by_name = {r.spec.name: r for r in results}
    for r in results:
        ov = r.spec.overlap
        if ov is None or ov.mode != "pipelined":
            continue
        fu = r.spec.fusion
        if fu is None:
            out.append(CheckFinding(
                "PSC109", r.spec.name,
                "pipelined overlap declared without a FusionSpec — the per-bucket dispatch "
                "requirement needs the bucket plan to know how many reduce chains to demand"))
        else:
            want = fu.per_bucket * fu.n_buckets
            got = _grad_reduce_count(r)
            if got < want:
                out.append(CheckFinding(
                    "PSC109", r.spec.name,
                    f"only {got} gradient-path reduce collectives for a pipelined plan of "
                    f"{fu.n_buckets} bucket(s) (x{fu.per_bucket} per bucket = {want} "
                    f"expected) — the wire has re-fused into a barrier; the schedule is "
                    f"serial no matter what the config declares"))
        twin = by_name.get(ov.serial_twin) if ov.serial_twin else None
        if twin is None:
            continue
        mine, theirs = _grad_reduce_bytes(r), _grad_reduce_bytes(twin)
        if mine != theirs:
            out.append(CheckFinding(
                "PSC109", r.spec.name,
                f"gradient-path reduce collectives move {mine} B but the serial twin "
                f"'{twin.spec.name}' moves {theirs} B — pipelining must reorder the "
                f"schedule, never change the bytes"))
    return out


def psc110_consensus(results: Sequence[TraceResult]) -> List[CheckFinding]:
    """Adaptive configs must name a REAL host-consensus point: a function
    of the port whose return passes through one of the process axis's
    agreement primitives (``lint/diverge.consensus_inventory``)."""
    from ..lint.diverge import consensus_inventory

    out: List[CheckFinding] = []
    inventory = None
    knobs = (
        ("adaptive", "traced aggregation count", "trainer.Trainer._count_consensus"),
        ("precision", "traced per-bucket precision tag vector",
         "trainer.Trainer._tags_consensus"),
    )
    for r in results:
        for attr, what, example in knobs:
            pol = getattr(r.spec, attr, None)
            if pol is None:
                continue
            if not pol.consensus:
                out.append(CheckFinding(
                    "PSC110", r.spec.name,
                    f"{type(pol).__name__} declares a {what} but no host-consensus point — "
                    f"each process would adapt on its own telemetry and feed the step torn "
                    f"values; name the function that agrees them (e.g. '{example}')"))
                continue
            if inventory is None:
                inventory = consensus_inventory()
            if pol.consensus not in inventory:
                known = ", ".join(sorted(inventory)) or "none found"
                out.append(CheckFinding(
                    "PSC110", r.spec.name,
                    f"declared host-consensus point '{pol.consensus}' is not in the "
                    f"package's consensus inventory (functions whose return passes through "
                    f"broadcast_object/min_over_hosts/any_host; known: {known}) — renamed, "
                    f"or no longer consensus-shaped"))
    return out


def _numerics(r: TraceResult):
    """The (policy, report) pair the PSC111-114 rules read, or (None,
    None) when the spec declares no NumericsPolicy (old fixtures)."""
    pol = getattr(r.spec, "numerics", None)
    rep = r.numerics
    if pol is None or rep is None:
        return None, None
    return pol, rep


def psc111_scale_provenance(r: TraceResult) -> List[CheckFinding]:
    """Every dequantize's scale must descend from the SAME max-abs
    reduction that produced its quantize's scale (shared provenance
    root), across every hop of the 2round / hier wires."""
    pol, rep = _numerics(r)
    if rep is None:
        return []
    out = []
    by_sid = {s.sid: s for s in rep.sites}
    for d in rep.dequants:
        for sid in sorted(d.payload_sites):
            s = by_sid.get(sid)
            if s is None or s.roots & d.scale_roots:
                continue
            origin = ("a static constant" if d.scale_literal
                      else "a different dataflow origin" if d.scale_roots
                      else "no max-abs reduction at all")
            out.append(CheckFinding(
                "PSC111", r.spec.name,
                f"dequantize of the {s.dtype} payload at offset "
                f"{s.start_offset} takes its scale from {origin}: the "
                f"scale does not descend from the max-abs reduction behind the "
                f"quantize's scale — the lattice decodes against the "
                f"wrong dynamic range",
            ))
    if pol.quantized:
        for s in rep.sites:
            if s.primary and s.feeds_params and not s.roots:
                out.append(CheckFinding(
                    "PSC111", r.spec.name,
                    f"quantization site at offset {s.start_offset} "
                    f"({s.dtype}, {s.size} elem) on the gradient path "
                    f"has no max-abs reduction in its scale chain — its "
                    f"clamp bound was minted from a constant, not from "
                    f"the data's dynamic range",
                ))
    return out


def psc112_error_feedback(r: TraceResult) -> List[CheckFinding]:
    """With error_feedback declared, every primary quantization site on
    the gradient path needs a grad - dequant(quant) residual that feeds
    the next step's carry — and only the carry (feeding the params too
    double-counts the correction)."""
    pol, rep = _numerics(r)
    if rep is None or not pol.error_feedback:
        return []
    primary = [s for s in rep.sites if s.primary and s.feeds_params]
    if not primary:
        return [CheckFinding(
            "PSC112", r.spec.name,
            "error_feedback declared but the trace has no primary "
            "quantization site on the gradient path — there is no "
            "quantization error for a residual to close over",
        )]
    out = []
    live = [e for e in rep.residuals if e.feeds_carry]
    for s in primary:
        cov = [e for e in live if s.sid in e.covered_sites]
        if not cov:
            out.append(CheckFinding(
                "PSC112", r.spec.name,
                f"quantization site at offset {s.start_offset} "
                f"({s.dtype}, {s.size} elem) has no residual consumer "
                f"grad - dequant(quant) feeding the next step's carry — "
                f"the quantization error is dropped and EF-SGD silently "
                f"degrades to biased quantized SGD",
            ))
    for e in rep.residuals:
        if e.covered_sites and e.feeds_carry and e.feeds_params:
            out.append(CheckFinding(
                "PSC112", r.spec.name,
                f"the error-feedback residual covering site(s) "
                f"{sorted(e.covered_sites)} feeds BOTH the carried "
                f"residual and the updated params — the correction is "
                f"applied this step AND replayed next step "
                f"(double-counted)",
            ))
    return out


def psc113_capacity(r: TraceResult) -> List[CheckFinding]:
    """Integer-accumulation capacity proven from the trace: worst-case
    |sum| = clamp peak x the traced summand count (collective axis
    sizes, reduce dims) must fit the payload dtype — plus the declared-
    accumulator dtype pin (the widened-payload regression) and the
    homomorphic_rescale saturation check."""
    pol, rep = _numerics(r)
    if rep is None:
        return []
    out = []
    for a in rep.accums:
        where = f"{a.kind} over {list(a.axes)}" if a.axes else a.kind
        if (a.peak_out is not None and a.capacity is not None
                and a.peak_out > a.capacity):
            summands = (
                f" ({a.multiplier} summands x |payload| <= {a.peak_in:g})"
                if a.multiplier is not None and a.peak_in is not None
                else ""
            )
            cap_kind = ("exact-mantissa capacity"
                        if a.kind == "mantissa" or not a.dtype.startswith(
                            "int")
                        else "dtype capacity")
            out.append(CheckFinding(
                "PSC113", r.spec.name,
                f"{where} in {a.dtype} reaches worst-case |sum| = "
                f"{a.peak_out:g}{summands}, over the {cap_kind} "
                f"{a.capacity} — the traced accumulation overflows",
            ))
        elif a.lattice and a.peak_out is None:
            reason = ("unknown axis size"
                      if a.multiplier is None and a.kind in ("psum", "psum_scatter")
                      else "the payload bound is unknown")
            out.append(CheckFinding(
                "PSC113", r.spec.name,
                f"cannot prove {where} in {a.dtype} fits: lattice "
                f"payload with no provable |sum| bound ({reason}) — "
                f"quantized accumulation must be proven from the trace, "
                f"not assumed",
            ))
        elif (pol.quantized and a.kind in ("psum", "psum_scatter")
              and a.dtype in ("int8", "int16") and a.feeds_params
              and a.peak_out is None):
            out.append(CheckFinding(
                "PSC113", r.spec.name,
                f"cannot prove {where} fits {a.dtype}: the wire payload "
                f"carries no provable clamp bound into the reduce — an "
                f"unclamped cast is on the quantized wire",
            ))
        if (pol.accum_dtype is not None and a.lattice
                and a.kind in ("psum", "psum_scatter")
                and a.dtype.startswith("int")
                and a.dtype != pol.accum_dtype):
            out.append(CheckFinding(
                "PSC113", r.spec.name,
                f"lattice {where} carries {a.dtype} on a declared "
                f"{pol.accum_dtype} accumulator — the widened payload "
                f"crept back onto the wire (the widened-payload regression)",
            ))
    for s in rep.sites:
        if s.primary or not s.feeds_params:
            # primary quantizes divide by their own max-abs: in-range by
            # construction; only lattice REQUANTS (homomorphic_rescale)
            # carry a divisor that can saturate the clamp
            continue
        if s.pre_peak is None:
            out.append(CheckFinding(
                "PSC113", r.spec.name,
                f"cannot prove the lattice requantize at offset "
                f"{s.start_offset} ({s.dtype}) stays in range: the "
                f"pre-clamp |value| bound is unknown, so the "
                f"homomorphic_rescale divisor cannot be proven to "
                f"prevent saturation",
            ))
        elif s.peak is not None and s.pre_peak > s.peak + 1e-6:
            out.append(CheckFinding(
                "PSC113", r.spec.name,
                f"lattice requantize at offset {s.start_offset} "
                f"saturates: |value| reaches {s.pre_peak:g} before the "
                f"+-{s.peak:g} clamp — the homomorphic_rescale divisor "
                f"is too small and the wire clips",
            ))
    return out


def psc114_downcast(r: TraceResult) -> List[CheckFinding]:
    """No silent downcast on the update path: a precision-narrowing
    convert downstream of the gradient reduce that feeds the updated
    params must be a detected quantization site (those never land in
    ``narrows``) or a declared NarrowingAllowance."""
    pol, rep = _numerics(r)
    if rep is None:
        return []
    allowed = {(a.src, a.dst) for a in pol.allow_narrowing}
    out = []
    for n in rep.narrows:
        if not n.downstream_of_reduce or not n.feeds_params:
            continue
        if (n.src, n.dst) in allowed:
            continue
        out.append(CheckFinding(
            "PSC114", r.spec.name,
            f"convert {n.src}->{n.dst} downstream of the gradient "
            f"reduce feeds the updated params but is neither a "
            f"quantization site (no provable clamp bound) nor a "
            f"declared NarrowingAllowance — precision drops silently "
            f"on the update path",
        ))
    return out


def check_result(r: TraceResult) -> List[CheckFinding]:
    """The per-result rules: PSC101-103, PSC105-108 and PSC111-114."""
    return (psc101_axes(r) + psc102_grad_reduce(r) + psc103_wire(r) + psc105_donation(r)
            + psc106_fusion(r) + psc107_serve(r) + psc108_adaptive(r) + psc108_precision(r)
            + psc111_scale_provenance(r) + psc112_error_feedback(r) + psc113_capacity(r)
            + psc114_downcast(r))


def _row_key(row: dict) -> tuple:
    return (row["kind"], tuple(row["axes"]), row["dtype"])


def psc104_roundtrip(results: Sequence[TraceResult], contract: dict,
                     check_stale: bool = True) -> List[CheckFinding]:
    """Diff the measured accounting against the committed artifact."""
    out: List[CheckFinding] = []
    configs: Dict[str, dict] = contract.get("configs", {})
    for r in results:
        pinned = configs.get(r.spec.name)
        if pinned is None:
            out.append(CheckFinding("PSC104", r.spec.name,
                                    "config missing from the contract artifact — refresh "
                                    "with --write-contract"))
            continue
        want = {_row_key(row): row for row in pinned.get("collectives", [])}
        got = {_row_key(row): row for row in r.summary}
        for key in sorted(set(want) | set(got)):
            kind, axes, dtype = key
            label = f"{kind} over {list(axes)} [{dtype}]"
            if key not in want:
                out.append(CheckFinding(
                    "PSC104", r.spec.name,
                    f"unpinned collective appeared: {label} (count={got[key]['count']}, "
                    f"bytes={got[key]['bytes']})"))
            elif key not in got:
                out.append(CheckFinding(
                    "PSC104", r.spec.name,
                    f"pinned collective vanished: {label} (was count={want[key]['count']}, "
                    f"bytes={want[key]['bytes']})"))
            elif (want[key]["count"] != got[key]["count"]
                  or want[key]["bytes"] != got[key]["bytes"]):
                out.append(CheckFinding(
                    "PSC104", r.spec.name,
                    f"wire accounting drift for {label}: pinned count={want[key]['count']} "
                    f"bytes={want[key]['bytes']}, measured count={got[key]['count']} "
                    f"bytes={got[key]['bytes']}"))
    if check_stale:
        traced = {r.spec.name for r in results}
        for name in sorted(set(configs) - traced):
            out.append(CheckFinding("PSC104", name,
                                    "stale contract entry: config no longer in the registry "
                                    "— refresh with --write-contract"))
    return out
