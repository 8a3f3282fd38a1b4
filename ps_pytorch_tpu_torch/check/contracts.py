"""pscheck contract registry: each scheme's step function and its declared
communication invariants (the port of check/contracts.py).

A ContractSpec bundles a builder that constructs the REAL step (the same
factory the trainer and the CLIs call, over a recording worker axis,
``check/axes.py``) with the invariants the scheme claims, as data the
rules (rules.py) verify against the recorded step:

- ``axes``: every declared mesh axis must be consumed by a collective,
  and no collective may ride any other axis (PSC101);
- ``grad_reduce``: for each axis across which gradient leaves are
  replicated, the reducing collective kinds that must feed the updated
  params (PSC102);
- ``wire``: the payload dtype a compressed wire must carry, with its
  declared exceptions (PSC103);
- ``donation``: the restated donation contract (PSC105, ``core.py``);
- ``fusion`` / ``serve`` / ``adaptive`` / ``precision`` / ``overlap``:
  PSC106-110, as in the JAX registry.

The policy dataclasses are JAX's, unchanged, as data; ``numerics`` (a
``NumericsPolicy``) is what PSC111-114 hold the step's precision-flow
report to (``numerics.py``).

The differences from JAX's registry:

- builders take the device and RUN: the port records a step on real
  tensors at the registry's own small sizes (batch 1 a worker, LeNet at
  28x28x1, ResNet18 at its published widths on 32x32x3, the LM schemes
  at ``_lm_cfg()``), its inputs made from the spec's numpy ``seed`` and
  its draws injected (``StepDraws``), so a trace is reproducible;
- ``deviations`` name, row by row, where the port's accounting may
  differ from JAX's ``runs/comm_contract.json`` and why (a batched
  equation the port makes as several calls, a reduction the port does
  not make at all). The artifact the rules hold the port to is its own,
  ``check/comm_contract.json``; the deviations are what its tests hold
  against JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

MESH_DEVICES = 8  # the mesh every PS contract records on (stacked)


@dataclasses.dataclass(frozen=True)
class GradReduce:
    """PSC102: a reduce over `axis` with one of `kinds` must feed params."""

    axis: str
    kinds: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class WireAllowance:
    """A declared non-payload-dtype collective on a compressed wire."""

    kind: str
    dtype: str
    reason: str
    max_bytes: Optional[int] = None   # None = unlimited (document why!)
    axes: Optional[Tuple[str, ...]] = None  # None = any axes


@dataclasses.dataclass(frozen=True)
class WirePolicy:
    """PSC103: collectives riding `axes` must carry `payload_dtype`
    unless a WireAllowance explicitly covers them."""

    axes: Tuple[str, ...]
    payload_dtype: str = "int8"
    allow: Tuple[WireAllowance, ...] = ()


@dataclasses.dataclass(frozen=True)
class DonationSpec:
    """PSC105: arg `argnums[i]` is the state the step consumes and
    output position `out_positions[i]` the state it returns (torch has
    no buffer donation: core.py restates the contract)."""

    argnums: Tuple[int, ...]
    out_positions: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """PSC106: gradient-path collective budget for a fused/bucketed wire:
    at most ``per_bucket * n_buckets + slack`` reduce-kind collectives
    feeding the updated params, n_buckets from the engine's own
    ``plan_buckets`` (``payload_bytes`` the f32 gradient bytes,
    ``bucket_bytes`` PSConfig.bucket_bytes, ``align`` the wire's bucket
    alignment; ``per_bucket`` 2 for the hierarchical wire's ICI + DCN
    all_to_all pair)."""

    payload_bytes: int
    bucket_bytes: Optional[int] = 0
    align: int = 1
    per_bucket: int = 1
    slack: int = 0

    @property
    def n_buckets(self) -> int:
        from ..parallel.buckets import plan_buckets

        return plan_buckets(self.payload_bytes // 4, self.bucket_bytes or 0,
                            align=self.align).n_buckets

    @property
    def max_collectives(self) -> int:
        return self.per_bucket * self.n_buckets + self.slack


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy:
    """PSC108 / PSC110: a traced aggregation count keeps its grad_reduce
    declaration and its gradient-path reduce bytes inside
    ``envelope_bytes``; ``consensus`` names the host-consensus point (a
    package-relative dotted path in the consensus inventory,
    ``lint/diverge.py``)."""

    min_aggregate: int
    max_aggregate: int
    envelope_bytes: int
    consensus: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """PSC108 / PSC110: a per-bucket precision tag vector of
    ``n_buckets`` keeps the reduce bytes inside ``envelope_bytes`` and
    names its consensus point, as AdaptivePolicy does."""

    n_buckets: int
    envelope_bytes: int
    consensus: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class OverlapPolicy:
    """PSC109: the pipelined bucket wire moves its serial twin's bytes
    (``serial_twin``, the registry name of the ``overlap="serial"``
    config) and dispatches at least one reduce a bucket."""

    mode: str = "pipelined"
    serial_twin: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """PSC107: the serving decode step makes no collective, and its KV
    pool (arg ``kv_argnum``) holds int8 payload (``*_q``) and f32 scale
    rows (``*_s``) when ``quantized``, else ``kv_dtype`` K/V."""

    kv_argnum: int = 1
    quantized: bool = False
    kv_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class NarrowingAllowance:
    """PSC114: one tolerated narrowing convert (src -> dst dtype)."""

    src: str
    dst: str
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """PSC111-114: whether the wire is quantized (every primary site on
    the gradient path needs a max-abs scale root), whether error feedback
    must close it, the declared lattice accumulator dtype, and the
    narrowing converts the update path may make."""

    quantized: bool = False
    error_feedback: bool = False
    accum_dtype: Optional[str] = None
    allow_narrowing: Tuple[NarrowingAllowance, ...] = ()


@dataclasses.dataclass(frozen=True)
class Deviation:
    """Where a config's accounting row ``(kind, axes, dtype)`` may differ
    from JAX's ``runs/comm_contract.json``: in its ``count`` only (the
    bytes agree), or in its ``bytes`` (and count; a row one side lacks
    is a bytes deviation). ``name`` is the deviation's entry in ROADMAP.md
    queue 3."""

    name: str
    kind: str
    axes: Tuple[str, ...]
    dtype: str
    aspect: str  # "count" | "bytes"
    reason: str

    @property
    def key(self) -> Tuple[str, Tuple[str, ...], str]:
        return (self.kind, tuple(self.axes), self.dtype)


@dataclasses.dataclass
class Built:
    """What a spec's builder returns: the real step, its arguments (real
    tensors on the device), a selector for the updated-params subtree of
    its output, the mesh's device count and the step's keywords."""

    step: Callable
    args: Tuple[Any, ...]
    select_params: Callable[[Any], Any]
    devices: int = MESH_DEVICES
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ContractSpec:
    name: str
    build: Callable[[Any], Built]  # build(device) -> Built
    axes: Tuple[str, ...]
    grad_reduce: Tuple[GradReduce, ...] = ()
    wire: Optional[WirePolicy] = None
    donation: Optional[DonationSpec] = None
    fusion: Optional[FusionSpec] = None
    serve: Optional[ServePolicy] = None
    adaptive: Optional[AdaptivePolicy] = None
    overlap: Optional[OverlapPolicy] = None
    numerics: Optional[NumericsPolicy] = None
    precision: Optional[PrecisionPolicy] = None
    seed: int = 0
    deviations: Tuple[Deviation, ...] = ()


# metrics / loss pmean: a handful of f32 scalars, every scheme emits it
_METRICS_PSUM = WireAllowance(kind="psum", dtype="float32", max_bytes=64,
                              reason="metrics/loss pmean (scalars)")
# shared-scale agreement for round-1 quantization (ops/quantize pmax)
_SCALE_PMAX = WireAllowance(kind="pmax", dtype="float32", max_bytes=4096,
                            reason="per-tensor/per-block scale agreement (pmax)")
# round-2 scale rows ride an f32 all_gather next to the int8 payload
_SCALE_GATHER = WireAllowance(kind="all_gather", dtype="float32", max_bytes=4096,
                              reason="round-2 quantization scale rows")
# the non-finite gradient guard's consensus flag: one int32 pmin
_FINITE_PMIN = WireAllowance(kind="pmin", dtype="int32", max_bytes=8,
                             reason="non-finite gradient guard flag (skip-step consensus)")

# input HW shape per contract network (CIFAR-10 shapes for ResNet)
_NETWORK_HW = {"LeNet": (28, 28, 1), "ResNet18": (32, 32, 3)}

_PAYLOAD_CACHE: dict = {}


def payload_bytes(network: str) -> int:
    """f32 gradient payload bytes of a contract network (the PSC106
    budget's numerator), from the model's own param shapes."""
    if network not in _PAYLOAD_CACHE:
        _PAYLOAD_CACHE[network] = _model_bytes(network)
    return _PAYLOAD_CACHE[network]


def bn_state_bytes(network: str) -> int:
    """f32 bytes of the model's BatchNorm running stats: the payload the
    default ``bn_mode="pmean"`` averages across workers each step. 0 for
    BN-free networks (LeNet)."""
    key = (network, "bn")
    if key not in _PAYLOAD_CACHE:
        _PAYLOAD_CACHE[key] = _model_bytes(network, state=True)
    return _PAYLOAD_CACHE[key]


def _model_bytes(network: str, state: bool = False) -> int:
    import torch

    from ..models import build_model
    from ..parallel.buckets import tree_leaves

    model = build_model(network, num_classes=10)
    with torch.device("meta"):  # the shapes, nothing drawn
        params, stats = model.init(torch.Generator())
    tree = stats if state else params
    return 4 * sum(int(leaf.numel()) for leaf in tree_leaves(tree or {}))


# the deviations every PS config shares: the port's metrics are three
# pmean calls (loss, prec1, prec5) where JAX psums the metrics tree in one
# equation, and its BatchNorm stats one pmean a leaf
_METRICS_COUNT = "batched_metrics_psum"


def _ps_deviations(axes, dcn_hosts: int, homomorphic: bool, error_feedback: bool,
                   precision_adapt: bool, grad_pieces: bool) -> Tuple[Deviation, ...]:
    """``grad_pieces``: the uncompressed serial wire psums the gradient in
    more than one piece (a leaf or a bucket each)."""
    from ..parallel.mesh import DCN_AXIS, WORKER_AXIS

    devs = [Deviation(_METRICS_COUNT, "psum", axes, "float32", "count",
                      "the port pmeans loss, prec1, prec5 (and each BatchNorm stats leaf, "
                      "and the precision telemetry) one call each; JAX psums each tree in "
                      "one equation: the same bytes")]
    if grad_pieces:
        devs.append(Deviation(
            "per_piece_grad_psum", "psum", axes, "float32", "count",
            "the uncompressed wire psums each gradient piece (a leaf, or a bucket) in a call "
            "of its own; JAX psums the piece list in one equation: the same bytes"))
    if dcn_hosts > 1 and not homomorphic:  # the homomorphic grid shares one scale
        per = "one shared-scale quantize a group of the grid (a host's ICI rows, an ICI " \
              "index's DCN rows), where JAX's pmax is one equation on every device"
        devs.append(Deviation("grouped_shared_scale", "pmax", (WORKER_AXIS,), "float32",
                              "count", per))
        devs.append(Deviation("grouped_shared_scale", "pmax", (DCN_AXIS,), "float32",
                              "count", per))
    if error_feedback and precision_adapt:
        devs.append(Deviation(
            "ef_mirror_quantizes_once", "pmax", axes, "float32", "bytes",
            "JAX's error-feedback mirror (local_quantized_contribution) quantizes every "
            "bucket a second time, with a second pmax; the port returns the contribution "
            "from the wire's own quantization (return_contribution): half the pmax rows"))
    return tuple(devs)


def _n_buckets(network: str, cfg) -> int:
    from ..parallel.buckets import plan_buckets
    from ..parallel.ps import wire_align

    return plan_buckets(payload_bytes(network) // 4, cfg.bucket_bytes or 0,
                        align=wire_align(cfg)).n_buckets


def _cnn_ps_built(cfg, network: str, seed: int, device, batch_per_worker: int = 1) -> Built:
    import numpy as np
    import torch

    from ..models import build_model, init_model
    from ..optim import sgd
    from ..parallel.mesh import WorkerAxis, make_hybrid_mesh
    from ..parallel.ps import StepDraws, init_ps_state, make_ps_train_step, state_plan
    from .axes import recording_axis

    hw = _NETWORK_HW[network]
    model = build_model(network, num_classes=10)
    tx = sgd(0.1)
    if cfg.dcn_hosts > 1:
        mesh = recording_axis(make_hybrid_mesh(cfg.dcn_hosts,
                                               cfg.num_workers // cfg.dcn_hosts))
    else:
        mesh = recording_axis(WorkerAxis(cfg.num_workers))
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    params, stats = init_model(model, gen, device=device)
    state = init_ps_state(model, tx, cfg, params=params, batch_stats=stats, device=device)
    step = make_ps_train_step(model, tx, cfg, mesh=mesh, device=device)
    n = cfg.num_workers * batch_per_worker
    batch = {
        "image": torch.from_numpy(rng.integers(0, 256, (n,) + hw, dtype=np.uint8)).to(device),
        "label": torch.from_numpy(rng.integers(0, 10, (n,), dtype=np.int64)).to(device),
    }
    perm = None
    if cfg.adaptive_aggregate:
        perm = torch.from_numpy(rng.permutation(cfg.num_workers).astype(np.int64))
    kwargs = {}
    if cfg.adaptive_aggregate:
        kwargs["agg_count"] = torch.tensor(cfg.num_aggregate_max, dtype=torch.int32,
                                           device=device)
    if cfg.precision_adapt:
        n_buckets = state_plan(cfg, payload_bytes(network) // 4).n_buckets
        kwargs["prec_tags"] = torch.full((n_buckets,), 2, dtype=torch.int32, device=device)
    return Built(step=step, args=(state, batch, StepDraws(perm=perm)),
                 select_params=lambda out: out[0].params, devices=cfg.num_workers,
                 kwargs=kwargs)


def _ps_spec(
    compress,
    placement,
    dcn_hosts: int = 1,
    bucket_bytes: Optional[int] = None,
    network: str = "LeNet",
    state_layout: str = "flat",
    adaptive: bool = False,
    overlap: str = "serial",
    bucket_tag: str = "",
    quant_block_size: int = 0,
    wire_domain: str = "dequant",
    error_feedback: bool = False,
    precision_adapt: bool = False,
    batch_per_worker: int = 1,
    seed: int = 0,
) -> ContractSpec:
    from ..parallel.mesh import DCN_AXIS, WORKER_AXIS

    name = "ps_{}_{}".format(compress or "none", placement)
    if dcn_hosts > 1:
        name = "ps_hier_{}_{}".format(compress, placement)
    if network != "LeNet":
        name = name.replace("ps_", f"ps_{network.lower()}_", 1)
    if bucket_bytes is not None:
        name += "_bucketed" + bucket_tag
    if quant_block_size:
        name += f"_qb{quant_block_size}"
    homomorphic = wire_domain == "homomorphic"
    if homomorphic:
        name += "_homomorphic"
    if error_feedback:
        name += "_ef"
    if precision_adapt:
        name += "_precadapt"
    if adaptive:
        name += "_adaptive"
    if overlap == "pipelined":
        serial_twin = name
        name += "_pipelined"
    if state_layout != "flat":
        name += "_treestate"
    axes: Tuple[str, ...] = (DCN_AXIS, WORKER_AXIS) if dcn_hosts > 1 else (WORKER_AXIS,)

    def make_cfg():
        from ..parallel.ps import PSConfig

        return PSConfig(
            num_workers=MESH_DEVICES, compress=compress, opt_placement=placement,
            dcn_hosts=dcn_hosts, bucket_bytes=bucket_bytes, state_layout=state_layout,
            overlap=overlap, quant_block_size=quant_block_size, wire_domain=wire_domain,
            error_feedback=error_feedback, precision_adapt=precision_adapt,
            num_aggregate_min=2 if adaptive else None,
            num_aggregate_max=MESH_DEVICES if adaptive else None,
        )

    def build(device) -> Built:
        return _cnn_ps_built(make_cfg(), network, seed, device, batch_per_worker)

    if compress == "int8_2round":
        reduce_kinds: Tuple[str, ...] = ("all_to_all",)
    elif placement == "sharded":
        reduce_kinds = ("psum_scatter",)
    else:
        reduce_kinds = ("psum",)
    grad_reduce = tuple(GradReduce(a, reduce_kinds) for a in axes)

    bn_allow = WireAllowance(
        kind="psum", dtype="float32", max_bytes=bn_state_bytes(network),
        reason="BatchNorm cross-replica stats pmean (bn_mode=pmean; model state, "
               "not gradients)") if bn_state_bytes(network) else None
    zero1_gather = WireAllowance(
        kind="all_gather", dtype="float32", max_bytes=None,
        reason="ZeRO-1 f32 update all_gather (the weight bcast analogue; sharded placement)")
    wire = None
    if compress == "int8_2round":
        if homomorphic:
            allow = [_METRICS_PSUM, _SCALE_PMAX, _FINITE_PMIN]
        else:
            allow = [_METRICS_PSUM, _SCALE_PMAX, _SCALE_GATHER, _FINITE_PMIN]
        if bn_allow:
            allow.append(bn_allow)
        if placement == "sharded":
            allow.append(zero1_gather)
        if dcn_hosts > 1 and not homomorphic:
            allow.append(WireAllowance(
                kind="all_gather", dtype="float32", max_bytes=None, axes=(WORKER_AXIS,),
                reason="hierarchical reassembly all_gather rides ICI only"))
        wire = WirePolicy(axes=axes, payload_dtype="int8", allow=tuple(allow))
    elif compress == "int8" and homomorphic:
        from ..ops.quantize import accum_dtype

        allow = [_METRICS_PSUM, _SCALE_PMAX, _FINITE_PMIN]
        if bn_allow:
            allow.append(bn_allow)
        if placement == "sharded":
            allow.append(zero1_gather)
        wire = WirePolicy(axes=axes,
                          payload_dtype=str(accum_dtype(MESH_DEVICES)).replace("torch.", ""),
                          allow=tuple(allow))

    fusion = None
    if bucket_bytes is not None or placement == "sharded":
        from ..parallel.ps import wire_align

        fusion = FusionSpec(payload_bytes=payload_bytes(network),
                            bucket_bytes=bucket_bytes or 0, align=wire_align(make_cfg()),
                            per_bucket=2 if dcn_hosts > 1 else 1)

    adaptive_policy = None
    if adaptive:
        from ..parallel.buckets import plan_buckets
        from ..parallel.ps import wire_align

        cfg = make_cfg()
        plan = plan_buckets(payload_bytes(network) // 4, cfg.bucket_bytes or 0,
                            align=wire_align(cfg))
        adaptive_policy = AdaptivePolicy(
            min_aggregate=cfg.num_aggregate_min, max_aggregate=cfg.num_aggregate_max,
            envelope_bytes=plan.padded_total * 4,
            consensus="trainer.Trainer._count_consensus")

    overlap_policy = None
    if overlap == "pipelined":
        overlap_policy = OverlapPolicy(mode="pipelined", serial_twin=serial_twin)

    precision_policy = None
    if precision_adapt:
        import torch

        from ..ops.quantize import accum_dtype
        from ..parallel.ps import state_plan

        splan = state_plan(make_cfg(), payload_bytes(network) // 4)
        if compress == "int8_2round":
            per_elem = 1
        elif homomorphic:
            per_elem = torch.empty((), dtype=accum_dtype(MESH_DEVICES)).element_size()
        else:
            per_elem = 4
        precision_policy = PrecisionPolicy(
            n_buckets=splan.n_buckets, envelope_bytes=splan.padded_total * per_elem,
            consensus="trainer.Trainer._tags_consensus")
        if wire is not None:
            wire = dataclasses.replace(wire, allow=wire.allow + (WireAllowance(
                kind="psum", dtype="float32", max_bytes=4 * splan.n_buckets,
                reason="per-bucket gradient-norm telemetry pmean (adaptive precision "
                       "controller)"),))

    if compress == "int8" and homomorphic:
        from ..ops.quantize import accum_dtype

        num = NumericsPolicy(quantized=True,
                             accum_dtype=str(accum_dtype(MESH_DEVICES)).replace("torch.", ""),
                             error_feedback=error_feedback)
    elif compress in ("int8", "int8_2round"):
        num = NumericsPolicy(quantized=True, accum_dtype="int32",
                             error_feedback=error_feedback)
    else:
        num = NumericsPolicy(quantized=False)

    grad_pieces = (compress is None and placement == "replicated" and overlap != "pipelined"
                   and (bucket_bytes is None or _n_buckets(network, make_cfg()) > 1))
    return ContractSpec(
        name=name, build=build, axes=axes, grad_reduce=grad_reduce, wire=wire,
        donation=DonationSpec(argnums=(0,), out_positions=(0,)), fusion=fusion,
        adaptive=adaptive_policy, overlap=overlap_policy, numerics=num,
        precision=precision_policy, seed=seed,
        deviations=_ps_deviations(axes, dcn_hosts, homomorphic, error_feedback,
                                  precision_adapt, grad_pieces),
    )


def _lm_cfg():
    from ..models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=32, dim=16, depth=2, heads=4, max_seq_len=16)


def _tokens(shape, seed: int, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, _lm_cfg().vocab_size, shape).astype(np.int64)).to(
        device)


# the LM schemes' gradient rule: the port runs ONE backward over the
# summed loss (ROADMAP.md queue 3, "One backward"), so the gradient of a
# replicated leaf arrives summed through autograd's own accumulation, and
# the reductions JAX writes as psums of the replicated leaves' gradients
# (and the transposes of its forward collectives in the backward) are no
# collective here; and the port unrolls the GPipe tick loop, one call a
# tick, where JAX's scan body holds one equation
_LM_DEVIATIONS = {
    "one_backward": "the port runs one backward over the summed loss: the replicated "
                    "leaves' gradients sum inside autograd, so JAX's gradient psums and the "
                    "backward transposes of its forward collectives have no counterpart call",
    "unrolled_ticks": "the port runs the GPipe schedule as M + S - 1 unrolled ticks, one call "
                      "a tick, where JAX's scan body holds one equation; and, as one_backward, "
                      "no backward transpose",
}


def _lm_deviations(rows) -> Tuple[Deviation, ...]:
    return tuple(Deviation(name, kind, tuple(axes), dtype, "bytes", _LM_DEVIATIONS[name])
                 for name, kind, axes, dtype in rows)


def _dp_tp_spec() -> ContractSpec:
    from ..parallel.mesh import WORKER_AXIS
    from ..parallel.tp import TP_AXIS

    def build(device) -> Built:
        import torch

        from ..optim import sgd
        from ..parallel.dp_tp import (
            DPTPMesh,
            init_dp_tp_state,
            make_dp_tp_train_step,
            shard_tokens_dp,
        )
        from .axes import RecordingWorkerAxis

        cfg = _lm_cfg()
        tx = sgd(0.1)
        mesh = DPTPMesh(dp=RecordingWorkerAxis(4, names=(WORKER_AXIS,), span=4),
                        tp=RecordingWorkerAxis(2, names=(TP_AXIS,)))
        params, opt = init_dp_tp_state(cfg, tx, torch.Generator().manual_seed(0), mesh,
                                       device=device)
        toks = shard_tokens_dp(_tokens((8, 16), 0, device), mesh)
        return Built(step=make_dp_tp_train_step(cfg, tx, mesh), args=(params, opt, toks),
                     select_params=lambda out: out[0], devices=8)

    return ContractSpec(
        name="dp_tp", build=build, axes=(WORKER_AXIS, TP_AXIS),
        donation=DonationSpec(argnums=(0, 1), out_positions=(0, 1)),
        numerics=NumericsPolicy(),
        deviations=_lm_deviations([("one_backward", "psum", (TP_AXIS,), "float32"),
                                   ("one_backward", "psum", (WORKER_AXIS,), "float32"),
                                   ("one_backward", "psum", (WORKER_AXIS, TP_AXIS), "float32")]),
    )


def _pp_spec() -> ContractSpec:
    from ..parallel.pp import PP_AXIS

    def build(device) -> Built:
        import torch

        from ..optim import sgd
        from ..parallel.pp import init_pp_state, make_pp_train_step
        from .axes import RecordingWorkerAxis

        cfg = _lm_cfg()
        tx = sgd(0.1)
        mesh = RecordingWorkerAxis(2, names=(PP_AXIS,))
        params, opt = init_pp_state(cfg, tx, torch.Generator().manual_seed(0), mesh,
                                    device=device)
        return Built(step=make_pp_train_step(cfg, tx, mesh, num_microbatches=2),
                     args=(params, opt, _tokens((4, 16), 0, device)),
                     select_params=lambda out: out[0], devices=2)

    return ContractSpec(
        name="pp", build=build, axes=(PP_AXIS,),
        donation=DonationSpec(argnums=(0, 1), out_positions=(0, 1)),
        numerics=NumericsPolicy(),
        deviations=_lm_deviations([("one_backward", "psum", (PP_AXIS,), "float32"),
                                   ("unrolled_ticks", "ppermute", (PP_AXIS,), "float32")]),
    )


def _moe_spec() -> ContractSpec:
    from ..parallel.moe import EP_AXIS

    def build(device) -> Built:
        import torch

        from ..optim import sgd
        from ..parallel.moe import MoEConfig, init_moe_state, make_moe_train_step, \
            shard_moe_batch
        from .axes import RecordingWorkerAxis

        cfg = _lm_cfg()
        moe = MoEConfig(num_experts=MESH_DEVICES)
        tx = sgd(0.1)
        mesh = RecordingWorkerAxis(MESH_DEVICES, names=(EP_AXIS,))
        params, opt = init_moe_state(cfg, moe, tx, torch.Generator().manual_seed(0), mesh,
                                     device=device)
        toks = shard_moe_batch(_tokens((8, 16), 0, device), mesh)
        return Built(step=make_moe_train_step(cfg, moe, tx, mesh), args=(params, opt, toks),
                     select_params=lambda out: out[0], devices=MESH_DEVICES)

    return ContractSpec(
        name="moe", build=build, axes=(EP_AXIS,),
        donation=DonationSpec(argnums=(0, 1), out_positions=(0, 1)),
        numerics=NumericsPolicy(),
        deviations=_lm_deviations([("one_backward", "psum", (EP_AXIS,), "float32"),
                                   ("one_backward", "all_to_all", (EP_AXIS,), "float32")]),
    )


def _dp_tp_pp_spec() -> ContractSpec:
    from ..parallel.mesh import WORKER_AXIS as DP_AXIS
    from ..parallel.pp import PP_AXIS
    from ..parallel.tp import TP_AXIS

    def build(device) -> Built:
        import torch

        from ..optim import sgd
        from ..parallel.dp_tp_pp import (
            Mesh3D,
            init_3d_state,
            make_3d_train_step,
            shard_tokens_3d,
        )
        from .axes import RecordingWorkerAxis

        cfg = _lm_cfg()
        tx = sgd(0.1)
        mesh = Mesh3D(dp=RecordingWorkerAxis(2, names=(DP_AXIS,), span=2),
                      pp=RecordingWorkerAxis(2, names=(PP_AXIS,), span=4),
                      tp=RecordingWorkerAxis(2, names=(TP_AXIS,)))
        params, opt = init_3d_state(cfg, tx, torch.Generator().manual_seed(0), mesh,
                                    device=device)
        toks = shard_tokens_3d(_tokens((4, 16), 0, device), mesh)
        return Built(step=make_3d_train_step(cfg, tx, mesh, num_microbatches=2),
                     args=(params, opt, toks), select_params=lambda out: out[0], devices=8)

    return ContractSpec(
        name="dp_tp_pp", build=build, axes=(DP_AXIS, PP_AXIS, TP_AXIS),
        donation=DonationSpec(argnums=(0, 1), out_positions=(0, 1)),
        numerics=NumericsPolicy(),
        deviations=_lm_deviations([
            ("unrolled_ticks", "ppermute", (PP_AXIS,), "float32"),
            ("unrolled_ticks", "psum", (TP_AXIS,), "float32"),
            ("one_backward", "psum", (PP_AXIS,), "float32"),
            ("one_backward", "psum", (DP_AXIS,), "float32"),
            ("one_backward", "psum", (DP_AXIS, TP_AXIS), "float32"),
            ("one_backward", "psum", (DP_AXIS, PP_AXIS, TP_AXIS), "float32")]),
    )


def _serve_spec(int8_kv: bool) -> ContractSpec:
    """The serving hot path's contract: the decode step the engine runs
    (``serve/engine.make_decode_step``) over a FlatVector of weights and
    the slot pool. Zero collectives, the pool written in place, its
    declared storage dtype (PSC105 restated + PSC107)."""

    def build(device) -> Built:
        import torch

        from ..models.transformer import init_transformer
        from ..parallel.buckets import plan_buckets, to_flat_vector, tree_layout
        from ..serve.engine import ServeConfig, make_decode_step
        from ..serve.kv import init_kv_pool

        cfg = _lm_cfg()
        serve = ServeConfig(slots=MESH_DEVICES, max_len=16, max_prompt_len=8,
                            kv_int8=int8_kv)
        tree = init_transformer(cfg, torch.Generator().manual_seed(0), device=device)
        params = to_flat_vector(tree, plan_buckets(tree_layout(tree).total, 0, align=1))
        pool = init_kv_pool(cfg, serve.slots, serve.max_len, int8=serve.kv_int8,
                            device=device)
        s = serve.slots
        tok = _tokens((s,), 1, device).to(torch.int32)
        pos = torch.arange(s, dtype=torch.int32, device=device)
        active = torch.ones((s,), dtype=torch.bool, device=device)
        return Built(step=make_decode_step(cfg, serve), args=(params, pool, tok, pos, active),
                     select_params=lambda out: out[0], devices=1)

    return ContractSpec(
        name="serve_decode" + ("_int8kv" if int8_kv else ""),
        build=build,
        axes=(),
        donation=DonationSpec(argnums=(1,), out_positions=(0,)),
        serve=ServePolicy(kv_argnum=1, quantized=int8_kv),
        numerics=NumericsPolicy(quantized=int8_kv),
    )


# the flagship bucketed config's bucket size (4 MiB): ResNet18's ~44.7 MB
# f32 gradient payload -> 11 buckets instead of 62 per-leaf collectives
RESNET_BUCKET_BYTES = 4 << 20


def layout_parity_pairs() -> Tuple[Tuple[ContractSpec, ContractSpec], ...]:
    """(flat_spec, tree_spec) twins for the state-layout parity gate: the
    wire accounting of each pair must be identical (state layout is
    compute-side); one twin per wire family."""
    combos = (
        dict(compress=None, placement="replicated"),
        dict(compress="int8", placement="replicated", bucket_bytes=0),
        dict(compress="int8", placement="sharded"),
    )
    return tuple((_ps_spec(state_layout="flat", **kw), _ps_spec(state_layout="tree", **kw))
                 for kw in combos)


def canonical_spec() -> ContractSpec:
    """The paper's canonical step at full size: ResNet18, 8 workers x 128
    images, the int8 wire in 4 MiB buckets (its rows equal the
    registry's ``ps_resnet18_int8_replicated_bucketed``: the batch does
    not change the wire)."""
    spec = _ps_spec("int8", "replicated", network="ResNet18",
                    bucket_bytes=RESNET_BUCKET_BYTES, batch_per_worker=128)
    spec.name += "_b128"
    return spec


def get_contracts() -> Tuple[ContractSpec, ...]:
    """The committed registry: JAX's 37 configurations, by JAX's names."""
    specs = [_ps_spec(c, p) for c in (None, "int8", "int8_2round")
             for p in ("replicated", "sharded")]
    specs.append(_ps_spec("int8_2round", "replicated", dcn_hosts=2))
    specs.extend(_ps_spec(c, "replicated", bucket_bytes=0)
                 for c in (None, "int8", "int8_2round"))
    specs.append(_ps_spec("int8_2round", "replicated", dcn_hosts=2, bucket_bytes=0))
    specs.append(_ps_spec("int8", "replicated", network="ResNet18"))
    specs.append(_ps_spec("int8", "replicated", network="ResNet18",
                          bucket_bytes=RESNET_BUCKET_BYTES))
    specs.append(_ps_spec(None, "replicated", bucket_bytes=0, adaptive=True))
    specs.append(_ps_spec("int8", "sharded", adaptive=True))
    for ov in ("serial", "pipelined"):
        specs.append(_ps_spec(None, "replicated", bucket_bytes=64 << 10, bucket_tag="64k",
                              overlap=ov))
        specs.append(_ps_spec("int8", "replicated", bucket_bytes=64 << 10, bucket_tag="64k",
                              overlap=ov))
    specs.append(_ps_spec("int8", "replicated", network="ResNet18",
                          bucket_bytes=RESNET_BUCKET_BYTES, overlap="pipelined"))
    specs.append(_ps_spec("int8", "sharded", overlap="pipelined"))
    specs.append(_ps_spec("int8", "replicated", wire_domain="homomorphic"))
    specs.append(_ps_spec("int8", "sharded", wire_domain="homomorphic"))
    specs.append(_ps_spec("int8_2round", "replicated", bucket_bytes=0,
                          wire_domain="homomorphic"))
    specs.append(_ps_spec("int8_2round", "sharded", wire_domain="homomorphic"))
    specs.append(_ps_spec("int8_2round", "replicated", dcn_hosts=2, bucket_bytes=0,
                          wire_domain="homomorphic"))
    specs.append(_ps_spec("int8", "replicated", network="ResNet18",
                          bucket_bytes=RESNET_BUCKET_BYTES, wire_domain="homomorphic"))
    for ov in ("serial", "pipelined"):
        specs.append(_ps_spec("int8", "replicated", bucket_bytes=64 << 10, bucket_tag="64k",
                              overlap=ov, wire_domain="homomorphic"))
    specs.append(_ps_spec("int8", "replicated", bucket_bytes=64 << 10, bucket_tag="64k",
                          precision_adapt=True))
    specs.append(_ps_spec("int8_2round", "replicated", bucket_bytes=64 << 10,
                          bucket_tag="64k", wire_domain="homomorphic", error_feedback=True,
                          precision_adapt=True))
    specs.extend([_dp_tp_spec(), _pp_spec(), _moe_spec(), _dp_tp_pp_spec()])
    specs.extend([_serve_spec(False), _serve_spec(True)])
    return tuple(specs)
