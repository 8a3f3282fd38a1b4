"""The parameter-server data-parallel step on the stacked worker backend
(the port of parallel/ps.py: replicated and ZeRO-1 sharded placements,
flat or tree state, serial schedule).

One call of the train step is one global step of the reference protocol
(master step N plus every worker's iteration N):

  reference protocol                 this step
  ---------------------------------  -------------------------------------
  master bcasts weights              ONE param copy on the card, every
                                     worker reads it
  worker forward/backward            a loop over the N virtual workers,
                                     each on its own batch shard, its own
                                     augmentation draws and its own BN
                                     batch statistics; its gradient lands
                                     in worker-stacked [N, *leaf] buffers
  worker per-layer Isend             the gradient wire (collectives.py):
  master partial aggregate           mask -> per-leaf or bucketed pieces
                                     -> int8 quantize (K2 / K1's
                                     shared-scale entry) -> exact integer
                                     sum (int32, or int16 on the
                                     homomorphic wire) or the two-round
                                     int8 all_to_all / all_gather (K3 on
                                     the homomorphic wire) -> / K
  master SGD step                    one fused update of the flat state;
                                     under ZeRO-1 each worker updates its
                                     1/N shard of every bucket and the
                                     updates are all_gathered
  BN stats                           bn_mode pmean (averaged) or local
                                     (per worker, stacked); synced BN
                                     (a model built with bn_axis_name)
                                     runs every worker's forward in one
                                     layer-synchronous pass over
                                     per-worker copies of the params;
                                     under bn_mode local its running
                                     stats stay [N, ...], each row
                                     updated from its own old row and
                                     the shared batch statistics

The non-finite guard checks every worker's gradients before the mask
(ps.py:1227-1242): a NaN in a worker the mask drops still skips the
step. The decision stays on the card: the state update is selected
against the flag with ``torch.where``, with no host read.

The step's random draws (the random_k permutation, each worker's crop
offsets and flips, its Dropout keep-masks and its stochastic-rounding
draws) come from a ``torch.Generator`` seeded from the run seed and the
step number, or are injected (``StepDraws``) so the parity tests can
feed the draws JAX made (``jax.random`` cannot be reproduced in torch).

The adaptive controllers' values ride the step as device int32 tensors
(ps.py:1093-1110): ``agg_count`` (the aggregation count, with
``num_aggregate_min/max`` set) and ``prec_tags`` (one precision tag a
bucket, with ``precision_adapt``), each clamped on the device to its
declared range, so a changing value costs no host sync and no other
code path. ``precision_adapt`` also adds ``bucket_sqnorm`` to the
metrics: the mean over workers of each bucket's squared gradient norm,
``[n_buckets]`` f32, which the trainer's precision controller reads.

Synced BN: JAX runs the workers on devices under ``shard_map(...,
check_vma=False)``, where BatchNorm pmeans its statistics and the
transpose of that pmean carries every worker's loss back to every
worker's copy of the params: worker j's gradient is ``d(sum_i L_i) /
d theta_j``. The port gets the same by one forward of all the workers'
rows over worker-stacked copies of the leaves (``models/common.py``) and
one backward of the summed losses.

The pipelined schedule (``overlap="pipelined"``, ``--overlap on``;
ps.py:644-730, :939-1025 of the JAX package) reduces the bucketed wire
one bucket at a time, each bucket assembled from its own leaves. The
stacked backend has every worker's gradient of a leaf once the LAST
worker's backward (or, with synced BN, the one backward) has produced
it: a hook on that backward's leaves hands each gradient to the bucket
stream (``_BucketStream``), which launches a bucket's wire as soon as
the last of its leaves exists, on a side stream on the card, and the
step's own stream waits on the bucket's event before its update (one
optimizer update a bucket). The values and bytes are the serial
step's; the kernels launch once a bucket instead of once a step.

The hierarchical wire (``dcn_hosts > 1``, JAX's tuple axis) runs on the
hybrid grid, ``mesh.HybridWorkerAxis`` on one process or
``mesh.ProcessHybridAxis`` with whole hosts in each process:
``int8_2round`` takes the DCN x ICI two-round wire
(``collectives.quantized_allreduce_2round_hier``), every other wire
reduces over the grid as over the flat axis.

Over processes, synced BN combines every process's per-worker
statistics (``models.common.synced_stats_axis``, which the step sets
around its forward): each process runs its own workers' rows over its
``[N_loc, ...]`` copies of the leaves, and the backward of the shared
statistics carries the other processes' losses in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..models import apply_model, draw_dropout, init_model
from ..models.common import synced_stats_axis
from ..ops.metrics import accuracy, cross_entropy_loss
from ..ops.quantize import (
    _INT8_PEAK,
    accum_dtype,
    dequantize_int8,
    precision_peaks,
    quantize_int8,
    quantize_lattice,
)
from ..optim.sgd import apply_updates
from ..resilience.guard import init_guard_state, tree_all_finite, update_guard_state
from .buckets import (
    BucketPlan,
    FlatVector,
    assemble_bucket,
    bucket_leaf_segments,
    concat_buckets,
    flat_to_tree,
    leaves_from_buckets,
    pad_flat,
    plan_buckets,
    readiness_bucket_order,
    to_flat_vector,
    tree_flatten,
    tree_layout,
    tree_map,
    tree_to_flat,
    tree_unflatten,
    tree_view,
)
from .collectives import (
    UniformDraws,
    _divide,
    _hom_scale,
    _uniform,
    aggregate_gradients,
    aggregation_mask,
    bucket_wire,
    random_permutation,
    reciprocal,
)
from .mesh import (
    DCN_AXIS,
    GRIDS,
    WORKER_AXIS,
    ProcessWorkerAxis,
    WorkerAxis,
    make_hybrid_mesh,
)


def hier_sizes(cfg: "PSConfig", mesh) -> Optional[Tuple[int, int]]:
    """``(hosts, per_host)`` of a hierarchical config's grid (ps.py:1079),
    stacked or over processes, None on the flat axis; the grid must be
    the config's."""
    if not cfg.hierarchical:
        if isinstance(mesh, GRIDS):
            raise ValueError("a hybrid grid needs a hierarchical config (dcn_hosts > 1 "
                             "or the tuple axis_name)")
        return None
    if not isinstance(mesh, GRIDS):
        raise ValueError(f"a hierarchical config (dcn_hosts {cfg.dcn_hosts}, axis "
                         f"{cfg.axis_name!r}) needs the hybrid grid (mesh.make_hybrid_mesh, "
                         f"or mesh.ProcessHybridAxis over processes)")
    if cfg.dcn_hosts > 1 and mesh.hosts != cfg.dcn_hosts:
        raise ValueError(f"the grid has {mesh.hosts} hosts, dcn_hosts says {cfg.dcn_hosts}")
    return mesh.hosts, mesh.per_host


@dataclasses.dataclass(frozen=True)
class PSConfig:
    """The JAX PSConfig's knobs and validation (ps.py:85). The knobs of
    paths the port does not run yet are kept, so a config carries across
    unchanged, and refused when set."""

    num_workers: int
    axis_name: Union[str, Tuple[str, ...]] = WORKER_AXIS
    num_aggregate: Optional[int] = None
    mask_mode: str = "random_k"
    num_aggregate_min: Optional[int] = None
    num_aggregate_max: Optional[int] = None
    compress: Optional[str] = None
    quant_block_size: int = 0
    quant_rounding: str = "nearest"
    wire_domain: str = "dequant"
    precision_adapt: bool = False
    bucket_bytes: Optional[int] = None
    state_layout: str = "flat"
    overlap: str = "serial"
    error_feedback: bool = False
    opt_placement: str = "replicated"
    bn_mode: str = "pmean"
    grad_accum_steps: int = 1
    dcn_hosts: int = 1
    nonfinite_guard: bool = True
    dynamic_loss_scale: bool = False
    loss_scale_init: float = 2.0 ** 15
    loss_scale_growth_interval: int = 2000

    def __post_init__(self):
        # the JAX package's own validation, same messages
        if self.num_workers < 1:
            raise ValueError(f"bad num_workers {self.num_workers}")
        if self.dcn_hosts > 1:
            if self.num_workers % self.dcn_hosts:
                raise ValueError(f"num_workers {self.num_workers} not divisible by "
                                 f"dcn_hosts {self.dcn_hosts}")
            if isinstance(self.axis_name, str):
                # frozen dataclass: the axis becomes JAX's tuple
                object.__setattr__(self, "axis_name", (DCN_AXIS, self.axis_name))
        if self.grad_accum_steps < 1:
            raise ValueError(f"bad grad_accum_steps {self.grad_accum_steps}")
        if self.opt_placement not in ("replicated", "sharded"):
            raise ValueError(f"bad opt_placement {self.opt_placement!r}")
        if self.bn_mode not in ("local", "pmean", "synced"):
            raise ValueError(f"bad bn_mode {self.bn_mode!r}")
        if self.compress not in (None, "none", "int8", "int8_2round"):
            raise ValueError(f"bad compress {self.compress!r}")
        if self.quant_rounding not in ("nearest", "stochastic"):
            raise ValueError(f"bad quant_rounding {self.quant_rounding!r}")
        if self.state_layout not in ("tree", "flat"):
            raise ValueError(f"bad state_layout {self.state_layout!r}")
        if self.overlap not in ("serial", "pipelined"):
            raise ValueError(f"bad overlap {self.overlap!r} (serial | pipelined)")
        if (self.overlap == "pipelined" and self.bucket_bytes is None
                and self.opt_placement != "sharded"):
            raise ValueError(
                "overlap='pipelined' needs a bucketed wire: set bucket_bytes "
                "(0 = one fused buffer, N = ~N-byte buckets) — the replicated "
                "per-leaf wire has no buckets to stream")
        if self.bucket_bytes is not None and self.bucket_bytes < 0:
            raise ValueError(
                f"bad bucket_bytes {self.bucket_bytes} (None = per-leaf, "
                f"0 = one fused buffer, N>0 = ~N-byte buckets)")
        if self.wire_domain not in ("dequant", "homomorphic"):
            raise ValueError(f"bad wire_domain {self.wire_domain!r} (dequant | homomorphic)")
        if self.wire_domain == "homomorphic":
            if self.compress in (None, "none"):
                raise ValueError(
                    "wire_domain='homomorphic' needs a compress mode "
                    "(--compress-grad compress|2round): an uncompressed f32 psum "
                    "has nothing to homomorphically sum")
            if self.quant_rounding == "stochastic":
                raise ValueError(
                    "wire_domain='homomorphic' needs quant_rounding='nearest': "
                    "shared scales put every worker on ONE lattice")
            # the exact-accumulation bound: raises past int32's capacity
            accum_dtype(self.num_workers)
        if self.error_feedback and self.compress in (None, "none"):
            raise ValueError("error_feedback needs a compress mode")
        if self.precision_adapt:
            if self.compress in (None, "none"):
                raise ValueError("precision_adapt needs a compress mode: an "
                                 "uncompressed f32 wire has no lattice to retune")
            if self.bucket_bytes is None:
                raise ValueError("precision_adapt needs a bucketed wire: set "
                                 "bucket_bytes (the tags are a per-BUCKET property)")
            if self.quant_rounding != "nearest":
                raise ValueError("precision_adapt needs quant_rounding='nearest'")
        if self.dynamic_loss_scale:
            if self.compress in (None, "none"):
                raise ValueError("dynamic_loss_scale needs a compress mode")
            if not self.nonfinite_guard:
                raise ValueError(
                    "dynamic_loss_scale needs nonfinite_guard (the skip step is "
                    "the overflow back-off trigger)")
        if self.loss_scale_growth_interval < 1:
            raise ValueError(
                f"bad loss_scale_growth_interval {self.loss_scale_growth_interval}")
        if (self.num_aggregate_min is None) != (self.num_aggregate_max is None):
            raise ValueError(
                "adaptive aggregation needs BOTH num_aggregate_min and "
                "num_aggregate_max (set neither for the static mask)")
        if self.num_aggregate_min is not None:
            if not (1 <= self.num_aggregate_min <= self.num_aggregate_max <= self.num_workers):
                raise ValueError(
                    f"bad adaptive bounds [{self.num_aggregate_min}, "
                    f"{self.num_aggregate_max}]: need 1 <= min <= max <= "
                    f"num_workers ({self.num_workers})")
            if self.num_aggregate is not None and not (
                    self.num_aggregate_min <= self.num_aggregate <= self.num_aggregate_max):
                raise ValueError(
                    f"num_aggregate {self.num_aggregate} (the initial adaptive count) is "
                    f"outside the declared bounds [{self.num_aggregate_min}, "
                    f"{self.num_aggregate_max}]")
        if self.loss_scale_init <= 0.0:
            raise ValueError(f"bad loss_scale_init {self.loss_scale_init} (must be > 0)")
        if self.mask_mode not in ("random_k", "first_k"):
            raise ValueError(f"unknown aggregation mode {self.mask_mode!r}")
        if (self.compress == "int8_2round" and self.opt_placement == "sharded"
                and self.hierarchical):
            raise ValueError(
                "int8_2round x sharded x dcn_hosts>1 is unsupported: the "
                "sharded wire is one reduce_scatter over the whole mesh, so "
                "there is no hierarchical structure for the 2-round scheme to "
                "exploit — use compress='int8' there")

    @property
    def hierarchical(self) -> bool:
        """The DCN x ICI grid: ``dcn_hosts > 1`` or a tuple axis."""
        return self.dcn_hosts > 1 or not isinstance(self.axis_name, str)

    @property
    def effective_aggregate(self) -> int:
        if self.num_aggregate is None or self.num_aggregate >= self.num_workers:
            return self.num_workers
        return self.num_aggregate

    @property
    def adaptive_aggregate(self) -> bool:
        """True when the train step takes a device ``agg_count`` instead
        of ``num_aggregate``."""
        return self.num_aggregate_min is not None

    @property
    def initial_aggregate(self) -> int:
        """The adaptive controller's first count: ``num_aggregate`` when
        given (inside the bounds), else the max bound."""
        if not self.adaptive_aggregate:
            return self.effective_aggregate
        if self.num_aggregate is not None:
            return self.num_aggregate
        return self.num_aggregate_max


def wire_align(cfg: PSConfig) -> int:
    """Bucket-boundary alignment (f32 elements) of this config's wire
    (ps.py:442): the int8 quantization block for the quantized schemes
    (1 for per-tensor scales or no compression), times num_workers on
    the ZeRO-1 scatter so each worker's slice of each bucket owns whole
    scale rows."""
    block = (cfg.quant_block_size
             if cfg.compress in ("int8", "int8_2round") and cfg.quant_block_size else 1)
    return cfg.num_workers * block if cfg.opt_placement == "sharded" else block


def _sharded_plan(cfg: PSConfig, total: int) -> BucketPlan:
    """Bucket geometry of the ZeRO-1 flat wire (ps.py:459): every bucket
    and the padded total a multiple of ``wire_align`` (num_workers *
    block); ``bucket_bytes`` None and 0 are the same fused plan."""
    return plan_buckets(total, cfg.bucket_bytes or 0, align=wire_align(cfg))


def _zero1_shard_size(total: int, cfg: PSConfig) -> int:
    """Per-worker flat shard length under ZeRO-1 (ps.py:472): each
    worker's 1/N of every bucket of the padded flat gradient."""
    return _sharded_plan(cfg, total).padded_total // cfg.num_workers


def state_plan(cfg: PSConfig, total: int) -> BucketPlan:
    """The flat-state geometry (ps.py:478): the BucketPlan the config's
    gradient wire uses, so the reduced flat gradient drops straight into
    the vector update. Sharded: the ZeRO-1 scatter plan, so params
    already live in shard geometry."""
    if cfg.opt_placement == "sharded":
        return _sharded_plan(cfg, total)
    return plan_buckets(total, cfg.bucket_bytes or 0, align=wire_align(cfg))


@dataclasses.dataclass
class PSTrainState:
    """``step`` is a host int (the number of steps taken); the rest lives
    on the card. ``params`` is a FlatVector (state_layout="flat") or the
    tree; ``batch_stats`` is worker-stacked under bn_mode="local";
    ``opt_state``'s moments are worker-stacked ``[N, shard]`` under the
    ZeRO-1 placement (its step count is one scalar: every worker's is the
    same); ``comm_state`` holds the error-feedback residuals,
    worker-stacked per param leaf, or under ZeRO-1 one flat ``[N,
    shard*N]`` row per worker (or None)."""

    step: int
    params: Any
    opt_state: Any  # optim.SGDState or optim.AdamState
    batch_stats: Any
    comm_state: Any = None
    guard_state: Any = None


def precision_hi_peak(cfg: PSConfig) -> int:
    """The peak a PREC_HI bucket quantizes to on this config's wire
    (ps.py:491): the widest lattice its narrowest integer hop carries.
    The two-round wire's all_to_all is int8 (127); the homomorphic int8
    wire's accumulator holds ``dtype max // num_workers``; the dequant
    int8 wire's int32 sum ``(2^31 - 1) // num_workers``; both capped at
    32767 (an int16 payload at most)."""
    n = cfg.num_workers
    if cfg.compress == "int8_2round":
        return _INT8_PEAK
    if cfg.wire_domain == "homomorphic":
        return min(int(torch.iinfo(accum_dtype(n)).max) // n, 32767)
    return min((2 ** 31 - 1) // n, 32767)


def init_ps_state(model, tx, cfg: PSConfig, generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None, params=None,
                  batch_stats=None, mesh=None) -> PSTrainState:
    """The initial state: params from ``generator`` (or the given
    ``params``/``batch_stats`` trees, e.g. converted JAX weights), laid
    out as the config asks, on ``device`` (default ``cuda``). On a
    process-spanning ``mesh`` the per-worker state (ZeRO-1 moments, EF
    residuals, local BN stats) holds this process's workers only; every
    process draws the same params from the same generator."""
    dev = resolve_device(device)
    if params is None:
        params, batch_stats = init_model(model, generator, device=dev)
    params = tree_map(lambda p: p.to(dev, torch.float32), params)
    batch_stats = tree_map(lambda s: s.to(dev), batch_stats or {})
    total = tree_layout(params).total
    n = cfg.num_workers if mesh is None else mesh.local_size
    master = (to_flat_vector(params, state_plan(cfg, total))
              if cfg.state_layout == "flat" else params)
    if cfg.opt_placement == "sharded":
        # identical zero-init on every worker, worker-stacked [N, shard]
        opt_state = tx.init(torch.zeros((n, _zero1_shard_size(total, cfg)),
                                        dtype=torch.float32, device=dev))
    else:
        opt_state = tx.init(master.flat if cfg.state_layout == "flat" else params)
    if cfg.bn_mode == "local" and batch_stats:
        batch_stats = tree_map(lambda s: s.expand((n,) + tuple(s.shape)).clone(),
                               batch_stats)
    comm_state = None
    if cfg.error_feedback and cfg.opt_placement == "sharded":
        # the sharded wire transforms the FLAT padded gradient, so its
        # residual lives there: one [shard * N] row per worker
        comm_state = torch.zeros((n, _zero1_shard_size(total, cfg) * cfg.num_workers),
                                 dtype=torch.float32, device=dev)
    elif cfg.error_feedback:
        comm_state = tree_map(
            lambda p: torch.zeros((n,) + tuple(p.shape), dtype=torch.float32, device=dev),
            params)
    guard_state = None
    if cfg.nonfinite_guard:
        guard_state = init_guard_state(
            cfg.loss_scale_init if cfg.dynamic_loss_scale else 1.0,
            dynamic=cfg.dynamic_loss_scale, device=dev)
    return PSTrainState(step=0, params=master, opt_state=opt_state,
                        batch_stats=batch_stats, comm_state=comm_state,
                        guard_state=guard_state)


@dataclasses.dataclass
class StepDraws:
    """One step's random draws: the random_k permutation of the workers
    (``[N]`` int, or None when no mask is drawn), each worker's
    augmentation draws (a list of N ``CropFlipDraws``, or None when the
    preprocessor does not augment), each worker's Dropout keep-masks
    (a list of N lists, one ``[B, features]`` bool mask per Dropout
    layer, or None when the model has no Dropout) and the gradient
    wire's stochastic-rounding draw source (``collectives.UniformDraws``,
    or None under nearest rounding)."""

    perm: Optional[torch.Tensor] = None
    aug: Optional[List[Any]] = None
    dropout: Optional[List[List[torch.Tensor]]] = None
    rounding: Optional[UniformDraws] = None


def device_uniform_draws(num_workers: int, generator: torch.Generator) -> UniformDraws:
    """A draw source on ``generator``'s device: each call draws every
    worker's U[0, 1) f32 for one piece in the order the wire asks for
    them (a function of the generator's seed and the wire's schedule;
    the piece id and the round only name the call, as JAX's key folds
    do)."""
    def draws(piece_id: int, round_: int, shape) -> torch.Tensor:
        return torch.rand((num_workers,) + tuple(shape), generator=generator,
                          device=generator.device, dtype=torch.float32)

    return draws


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws: a function of the run seed
    and the step number only (the role of ``fold_in(key, step_idx)``)."""
    return torch.Generator().manual_seed((seed * 1_000_003 + step) % (2 ** 63))


def draw_step(cfg: PSConfig, seed: int, step: int, batch_per_worker: int,
              preprocess=None, model=None, device: DeviceLike = "cpu") -> StepDraws:
    """The step's draws from ``step_generator``: the permutation, then
    each worker's augmentation, then the seed of each worker's Dropout
    masks, then the seed of the stochastic-rounding draws. The masks and
    the rounding draws are drawn on ``device`` (the step's), so the step
    copies nothing from the host: a CPU and a card run of one seed draw
    different values."""
    g = step_generator(seed, step)
    perm = None
    masked = cfg.adaptive_aggregate or cfg.effective_aggregate != cfg.num_workers
    if masked and cfg.mask_mode == "random_k":
        perm = random_permutation(cfg.num_workers, g)
    aug = None
    if preprocess is not None and getattr(preprocess, "augment", False):
        aug = [preprocess.draw(g, batch_per_worker) for _ in range(cfg.num_workers)]
    drop = None
    if getattr(model, "draw_dropout", None) is not None:
        gd = torch.Generator(device=device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=g)))
        drop = [draw_dropout(model, batch_per_worker, gd) for _ in range(cfg.num_workers)]
    rounding = None
    if cfg.quant_rounding == "stochastic" and cfg.compress in ("int8", "int8_2round"):
        gq = torch.Generator(device=device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=g)))
        rounding = device_uniform_draws(cfg.num_workers, gq)
    return StepDraws(perm=perm, aug=aug, dropout=drop, rounding=rounding)


def _select(finite: torch.Tensor, new, old):
    """The guard's rollback: ``new`` where the step was finite, else
    ``old``, leaf by leaf (both trees, or both None)."""
    if new is None:
        return None
    return tree_map(lambda a, b: torch.where(finite, a, b), new, old)


def _worker_region(flat: torch.Tensor, plan: BucketPlan, n: int, axis) -> torch.Tensor:
    """Every worker's region of a bucketed flat buffer (ps.py:631),
    worker-stacked ``[N, shard]``: row w is its 1/n slice of every
    bucket, concatenated in bucket order; this process's rows of it
    (``axis.local``: all of them when stacked)."""
    return concat_buckets([axis.local(flat[start:start + size].reshape(n, size // n))
                           for start, size in zip(plan.starts, plan.sizes)])


def _shard_reduce_bucket(bucket: torch.Tensor, size: int, axis: WorkerAxis, n: int,
                         k, cfg: PSConfig, want_contrib: bool, uniform=None, peak=None,
                         hi_peak: int = _INT8_PEAK):
    """One bucket of the ZeRO-1 wire (ps.py:732): (quantize) ->
    psum_scatter / int8 all_to_all -> every worker's dequantized 1/n
    shard divided by the aggregation count. ``bucket`` is worker-stacked
    ``[N, size]``; returns ``(g_shard [N, size/n], contribution [N,
    size] or None)``.

    - int8: quantize, exact psum_scatter in int32 (int16 on the
      homomorphic wire: the same integers);
    - int8_2round: quantize, int8 all_to_all, exact int32 region sums.
      Round 1 is the whole wire here (each worker keeps its region), so
      there is no round 2 and no K3.

    ``k`` is the static count (a Python int) or the adaptive one (a 0-d
    f32 device tensor, a quotient: ``collectives._divide``);
    ``uniform`` this bucket's stochastic draws; ``peak`` its lattice peak
    (adaptive precision: ``quantize_lattice``, int32 payload, as JAX).
    The dequantize copies XLA's spelling per wire domain: ``(sb * scale)
    * (1/K)`` on the dequant wire, ``sb * (scale / K)`` on the
    homomorphic one, where XLA folds ``/ K`` into the per-tensor scale's
    own constant (``absmax * fold``) but not into a block-row slice."""
    s = size // n
    bsz = cfg.quant_block_size
    if cfg.compress not in ("int8", "int8_2round"):
        return _divide(axis.psum_scatter(bucket), k), None
    homomorphic = cfg.wire_domain == "homomorphic"
    if peak is not None:
        q, scale = quantize_lattice(bucket, peak, axis_name=axis, block_size=bsz,
                                    hi_peak=hi_peak, out_dtype=torch.int32)
        absmax = None
    else:
        q, scale, absmax = quantize_int8(bucket, axis_name=axis, block_size=bsz,
                                         rounding=cfg.quant_rounding, uniform=uniform,
                                         return_absmax=True)
    contrib = None
    if want_contrib:
        # what the wire carries after the int8 round trip: a masked-out
        # worker sent 0, so its whole gradient stays in the residual
        contrib = dequantize_int8(q.to(torch.int32), scale, block_size=bsz, shape=(size,))
    if cfg.compress == "int8":
        acc_dt = accum_dtype(n) if homomorphic else torch.int32
        sb = axis.psum_scatter(q.reshape(-1, size).to(acc_dt))  # [N, s]
    else:
        recv = axis.all_to_all(q.reshape(-1, n, s).to(torch.int8))  # [n(region), N, s]
        sb = recv.to(torch.int32).sum(1, dtype=torch.int32)
    if bsz:
        nb_loc = s // bsz
        my_scales = axis.local(scale.reshape(n, nb_loc, 1))
        rows = sb.reshape(-1, nb_loc, bsz).float()
        if homomorphic:
            return (rows * _divide(my_scales, k)).reshape(-1, s), contrib
        return _divide((rows * my_scales).reshape(-1, s), k), contrib
    if homomorphic:
        return dequantize_int8(sb, _hom_scale(scale, absmax, k, peak is not None)), contrib
    return _divide(dequantize_int8(sb, scale), k), contrib


def _sharded_ps_update(params, opt_state, grads, tx, cfg: PSConfig, axis: WorkerAxis,
                       sel: Optional[torch.Tensor] = None, err: Optional[torch.Tensor] = None,
                       k=None, draws: Optional[UniformDraws] = None, bucket_peaks=None):
    """ZeRO-1 "sharded PS" (ps.py:814), serial: (EF add-back) -> mask ->
    (quantize) -> reduce_scatter per bucket -> every worker's update of
    its own shard -> all_gather of the parameter delta.

    ``grads`` is the tree of worker-stacked gradients; each worker's
    leaves flatten into its own row of the padded flat ``[N, L]``
    gradient, carved by ``_sharded_plan``. ``params`` is the replicated
    tree or a FlatVector already in the shard geometry; ``opt_state``'s
    moments are ``[N, shard]``; ``err`` is the ``[N, L]`` EF residual.
    ``sel`` is the ``[N]`` aggregation mask or None; ``k`` the count
    (default the static one; a 0-d f32 device tensor when adaptive);
    ``draws`` the stochastic draw source (a bucket's key id is its start
    offset); ``bucket_peaks`` the adaptive lattice peaks, one a bucket.
    Returns ``(new_params, new_opt, new_err)``, ``new_params`` of
    ``params``' kind."""
    n = cfg.num_workers
    k = cfg.effective_aggregate if k is None else k
    layout = tree_layout(grads, stacked=True)
    plan = _sharded_plan(cfg, layout.total)
    hi = precision_hi_peak(cfg) if bucket_peaks is not None else _INT8_PEAK
    flat_g = pad_flat(tree_to_flat(grads, stacked=True), plan)
    if err is not None:
        flat_g = flat_g + err
    sent = flat_g * sel[:, None] if sel is not None else flat_g
    bsz = cfg.quant_block_size
    g_shards, contribs = [], []
    for bi, (start, size) in enumerate(zip(plan.starts, plan.sizes)):
        uniform = None
        if cfg.compress in ("int8", "int8_2round"):
            uniform = _uniform(draws, axis, start, 0, (size // bsz, bsz) if bsz else (size,),
                               sent.device)
        g_b, contrib = _shard_reduce_bucket(
            sent[:, start:start + size], size, axis, n, k, cfg, want_contrib=err is not None,
            uniform=uniform, peak=None if bucket_peaks is None else bucket_peaks[bi], hi_peak=hi)
        g_shards.append(g_b)
        if contrib is not None:
            contribs.append(contrib)
    g_shard = concat_buckets(g_shards)
    new_err = flat_g - concat_buckets(contribs) if err is not None else None
    is_flat = isinstance(params, FlatVector)
    flat_p = params.flat if is_flat else pad_flat(tree_to_flat(params), plan)
    p_shard = _worker_region(flat_p, plan, n, axis)
    upd_shard, new_opt = tx.update(g_shard, opt_state, p_shard)
    # reassemble: each bucket's shard segment gathers back tiled, in
    # bucket order, inverting _worker_region
    full, off = [], 0
    for size in plan.sizes:
        full.append(axis.all_gather(upd_shard[:, off:off + size // n]))
        off += size // n
    if is_flat:
        new_params = dataclasses.replace(params, flat=flat_p + concat_buckets(full))
    else:
        upd = flat_to_tree(layout, concat_buckets(full)[:layout.total])
        new_params = apply_updates(params, upd)
    return new_params, new_opt, new_err


# ------------------------------------------------ the pipelined schedule

def _bucket_opt_views(opt, seg_len: int):
    """``(fields, is_seg)``: the optimizer state's fields and which are
    per-element vectors of ``seg_len`` on their last dimension (the
    moments, sliced a bucket at a time) rather than scalars such as the
    step count (ps.py:671)."""
    fields = {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)}
    is_seg = {k: isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[-1] == seg_len
              for k, v in fields.items()}
    return fields, is_seg


def _stitch_opt(opt, per_bucket, is_seg, first: int):
    """The whole optimizer state from per-bucket updates (ps.py:684): the
    moments concatenate in canonical bucket order, the scalars (every
    bucket computed the same ``count + 1``) come from the first
    dispatched bucket."""
    return dataclasses.replace(opt, **{
        k: (concat_buckets([pb[k] for pb in per_bucket]) if seg else per_bucket[first][k])
        for k, seg in is_seg.items()})


def _opt_slice(opt, fields, is_seg, a: int, b: int):
    return dataclasses.replace(opt, **{k: (v[..., a:b] if is_seg[k] else v)
                                       for k, v in fields.items()})


def _pipelined_flat_update(tx, agg_buckets, opt_state, master: torch.Tensor, plan: BucketPlan,
                           order, wait=None):
    """The replicated flat-state update, one ``tx.update`` a bucket
    (ps.py:700), in ``order``: bucket b's params and moments depend only
    on bucket b's aggregate, and the update chain is elementwise, so the
    result is the whole-vector update's, bit for bit. ``wait(b)`` (on the
    card) makes the step's stream wait for bucket b's wire. Returns
    ``(new_master, new_opt)``."""
    fields, is_seg = _bucket_opt_views(opt_state, plan.padded_total)
    new_p, new_opt = [None] * plan.n_buckets, [None] * plan.n_buckets
    for b in order:
        start, size = plan.starts[b], plan.sizes[b]
        if wait is not None:
            wait(b)
        with torch.profiler.record_function(f"bucket_update_o{start}"):
            p_b = master[start:start + size]
            u_b, opt_b = tx.update(agg_buckets[b], _opt_slice(opt_state, fields, is_seg, start,
                                                              start + size), p_b)
            new_p[b] = apply_updates(p_b, u_b)
            new_opt[b] = {f.name: getattr(opt_b, f.name) for f in dataclasses.fields(opt_b)}
    return concat_buckets(new_p), _stitch_opt(opt_state, new_opt, is_seg, order[0])


def _sharded_bucket_reduce(g_b, b: int, plan: BucketPlan, cfg: PSConfig, axis, k, sel, err,
                           draws: Optional[UniformDraws], bucket_peaks, hi: int):
    """One bucket of the ZeRO-1 pipelined wire (ps.py:978-991): the
    bucket's worker-stacked gradient ``g_b`` (assembled from its own
    leaves), plus its EF residual slice, masked, through the serial
    schedule's own ``_shard_reduce_bucket``. Returns ``(g_shard [N,
    size/n], the bucket's new EF residual or None)``."""
    start, size = plan.starts[b], plan.sizes[b]
    if err is not None:
        g_b = g_b + err[:, start:start + size]
    sent = g_b * sel[:, None] if sel is not None else g_b
    bsz = cfg.quant_block_size
    uniform = None
    if cfg.compress in ("int8", "int8_2round"):
        uniform = _uniform(draws, axis, start, 0, (size // bsz, bsz) if bsz else (size,),
                           sent.device)
    g_shard, contrib = _shard_reduce_bucket(
        sent, size, axis, cfg.num_workers, k, cfg, want_contrib=err is not None,
        uniform=uniform, peak=None if bucket_peaks is None else bucket_peaks[b], hi_peak=hi)
    return g_shard, (g_b - contrib if err is not None else None)


def _sharded_ps_update_pipelined(params, opt_state, reduced, tx, cfg: PSConfig, axis,
                                 plan: BucketPlan, layout, order, wait=None):
    """The ZeRO-1 update a bucket at a time (ps.py:939-1025), in
    ``order``: each bucket's reduced shard (``reduced[b] = (g_shard,
    new_err)``, from ``_sharded_bucket_reduce``) updates its own segment
    of every worker's shard, and the update gathers back into the bucket.
    The values are the serial ``_sharded_ps_update``'s. Returns
    ``(new_params, new_opt, new_err)``."""
    n = cfg.num_workers
    is_flat = isinstance(params, FlatVector)
    segs = None if is_flat else bucket_leaf_segments(layout, plan)
    p_leaves = None if is_flat else tree_flatten(params)[0]
    shard_len = plan.padded_total // n
    fields, is_seg = _bucket_opt_views(opt_state, shard_len)
    shard_off = np.cumsum((0,) + tuple(sz // n for sz in plan.sizes)).tolist()
    nb = plan.n_buckets
    new_p, new_opt, upd_full = [None] * nb, [None] * nb, [None] * nb
    for b in order:
        start, size = plan.starts[b], plan.sizes[b]
        s = size // n
        if wait is not None:
            wait(b)
        with torch.profiler.record_function(f"bucket_update_o{start}"):
            bucket_p = (params.flat[start:start + size] if is_flat
                        else assemble_bucket(p_leaves, segs[b]))
            p_b = axis.local(bucket_p.reshape(n, s))
            u_b, opt_b = tx.update(reduced[b][0], _opt_slice(opt_state, fields, is_seg,
                                                              shard_off[b], shard_off[b] + s),
                                   p_b)
            gathered = axis.all_gather(u_b)
            if is_flat:
                new_p[b] = bucket_p + gathered
            else:
                upd_full[b] = gathered
            new_opt[b] = {f.name: getattr(opt_b, f.name) for f in dataclasses.fields(opt_b)}
    new_opt_state = _stitch_opt(opt_state, new_opt, is_seg, order[0])
    if is_flat:
        new_params = dataclasses.replace(params, flat=concat_buckets(new_p))
    else:
        new_params = apply_updates(params, leaves_from_buckets(layout, plan, upd_full))
    errs = [r[1] for r in reduced]
    new_err = concat_buckets(errs) if errs and errs[0] is not None else None
    return new_params, new_opt_state, new_err


class _BucketStream:
    """One step's pipelined wire: the hooks of the backward hand in each
    leaf's worker-stacked gradient (``leaf_ready``), and a bucket whose
    leaves are all in is dispatched at once (``dispatch(b, piece)``, the
    piece assembled from its own leaves). On the card a dispatch runs on
    ``side`` (a CUDA stream) after the producing stream's work, its
    results handed back to the step's stream (``record_stream``) and an
    event recorded, on which ``wait(b)`` makes the step's stream wait.
    Buckets the hooks did not complete (no early dispatch, or pure
    padding) go out in ``finish``, in readiness order."""

    def __init__(self, layout, plan: BucketPlan, dispatch, side=None, early: bool = True):
        self.layout, self.plan = layout, plan
        self._dispatch, self.side, self.early = dispatch, side, early
        self.segs = bucket_leaf_segments(layout, plan)
        self.leaf_buckets = [[] for _ in layout.shapes]
        self.pending = []
        for b, frags in enumerate(self.segs):
            leaves = {idx for idx, _, _ in frags if idx is not None}
            self.pending.append(len(leaves))
            for idx in leaves:
                self.leaf_buckets[idx].append(b)
        self.stacked = [None] * len(layout.shapes)
        self.results = [None] * plan.n_buckets
        self.events = [None] * plan.n_buckets
        self.order: List[int] = []

    def leaf_ready(self, i: int, g: torch.Tensor) -> None:
        # contiguous once: a bucket's slice of a strided leaf (a
        # gradient through a permuted view) would copy the whole leaf
        # for each of its buckets
        self.stacked[i] = g.contiguous()
        for b in self.leaf_buckets[i]:
            self.pending[b] -= 1
            if self.early and self.pending[b] == 0:
                self._run(b)

    def _run(self, b: int) -> None:
        self.order.append(b)
        if self.side is None:
            self.results[b] = self._dispatch(b, assemble_bucket(self.stacked, self.segs[b],
                                                                stacked=True))
            return
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            out = self._dispatch(b, assemble_bucket(self.stacked, self.segs[b], stacked=True))
            self.events[b] = torch.cuda.Event()
            self.events[b].record(self.side)
        for t in out:
            if isinstance(t, torch.Tensor):
                t.record_stream(main)
        self.results[b] = out

    def finish(self) -> List[torch.Tensor]:
        """Dispatch what is left (readiness order); the stacked leaves."""
        for b in readiness_bucket_order(self.plan):
            if self.results[b] is None and b not in self.order:
                self._run(b)
        return self.stacked

    def wait(self, b: int) -> None:
        if self.events[b] is not None:
            torch.cuda.current_stream().wait_event(self.events[b])


def make_ps_train_step(model, tx, cfg: PSConfig, mesh: Optional[WorkerAxis] = None,
                       preprocess: Optional[Callable] = None, faults=None,
                       seed: int = 0, device: DeviceLike = None):
    """Build the train step: ``step(state, batch, draws=None,
    agg_count=None, prec_tags=None) -> (state, metrics)``.

    ``batch`` is ``{"image": uint8 [N*B, H, W, C], "label": int [N*B]}``
    (device tensors from ``data.prefetch_to_device``, or numpy, which the
    step copies in); worker w takes rows ``[w*B, (w+1)*B)``. ``draws``
    (StepDraws) overrides the step's own draws. ``agg_count`` (with
    ``cfg.adaptive_aggregate``) and ``prec_tags`` (``[n_buckets]``, with
    ``cfg.precision_adapt``) are JAX's extra step arguments, in its order:
    device int32 tensors, clamped on the device to ``[num_aggregate_min,
    num_aggregate_max]`` and ``[0, 3]``. ``metrics`` holds device
    scalars (mean over workers of loss, prec1, prec5, plus the guard's
    ``skipped_steps`` / ``skip_streak``, and ``bucket_sqnorm`` with
    ``precision_adapt``): reading them is the caller's host sync.
    ``faults`` (resilience.faults.FaultPlan) poisons every gradient at
    its planned steps."""
    dev = resolve_device(device)
    axis = mesh
    if axis is None:
        axis = (make_hybrid_mesh(cfg.dcn_hosts, cfg.num_workers // cfg.dcn_hosts)
                if cfg.dcn_hosts > 1 else WorkerAxis(cfg.num_workers))
    if axis.size != cfg.num_workers:
        raise ValueError(f"mesh holds {axis.size} workers, cfg says {cfg.num_workers}")
    hier_sizes(cfg, axis)
    pipelined = cfg.overlap == "pipelined"
    # the pipelined wire's side stream (the card), made at the first step;
    # over processes the buckets go out after the backward, on the step's stream
    early = not isinstance(axis, ProcessWorkerAxis)
    side_box: List[Any] = []
    n, a = cfg.num_workers, cfg.grad_accum_steps
    # this process's workers: ids [lo, lo + nl) (all of them when stacked)
    nl, lo = axis.local_size, axis.first
    is_flat = cfg.state_layout == "flat"

    hi_peak = precision_hi_peak(cfg)
    # the tag -> peak table, on the device once (ps.py:1106-1110)
    peak_table = (torch.from_numpy(precision_peaks(hi_peak)).to(dev)
                  if cfg.precision_adapt else None)

    synced = getattr(model, "bn_axis_name", None) is not None

    def micro(masks, i):
        """Microbatch ``i``'s rows of each Dropout mask (or None)."""
        return None if masks is None else [m.chunk(a)[i] for m in masks]

    def finishing_hooks(leaves, scale, prev, on_grad):
        """Hooks on the last microbatch's leaves handing ``on_grad(i, g)``
        each leaf's finished gradient as the backward produces it: the
        arithmetic below (unscale, then the microbatch mean) on one leaf."""
        def hook(j, t):
            if scale is not None:
                t = t / scale
            if a > 1:
                t = (prev[j] + t) * reciprocal(a)
            on_grad(j, t)

        for j, leaf in enumerate(leaves):
            leaf.register_hook(lambda t, j=j: hook(j, t))

    def worker_grads(params_t, bs_in, x, y, scale, masks, on_grad=None):
        """One worker's forward/backward on its shard (``a``
        microbatches, BN stats carried through them); ``on_grad`` (the
        pipelined wire) receives each finished leaf gradient from the
        last microbatch's backward, and the gradients returned are then
        None: the hooks finished them."""
        if x.shape[0] % a:
            raise ValueError(f"per-worker batch {x.shape[0]} not divisible by "
                             f"grad_accum_steps={a}")
        leaves, skel = tree_flatten(params_t)
        xs, ys = x.chunk(a), y.chunk(a)
        gsum, lsum, p1sum, p5sum, bs_c = None, 0.0, 0.0, 0.0, bs_in
        for i, (xi, yi) in enumerate(zip(xs, ys)):
            leaves_g = [leaf.detach().requires_grad_(True) for leaf in leaves]
            hooked = on_grad is not None and i == a - 1
            if hooked:
                finishing_hooks(leaves_g, scale, gsum, on_grad)
            with torch.enable_grad():
                logits, bs_c = apply_model(model, tree_unflatten(skel, leaves_g),
                                           bs_c, xi, train=True, dropout=micro(masks, i))
                loss = cross_entropy_loss(logits, yi)
                if scale is not None:
                    loss = loss * scale
                g = torch.autograd.grad(loss, leaves_g)
            loss = loss.detach()
            if scale is not None:
                # unscale at once: EF, quantization and the finite check
                # see true-magnitude gradients (true division: the scale
                # is a device value in JAX too)
                loss = loss / scale
                if not hooked:
                    g = [t / scale for t in g]
            p1, p5 = accuracy(logits.detach(), yi, (1, 5))
            if not hooked:
                gsum = list(g) if gsum is None else [s + t for s, t in zip(gsum, g)]
            lsum, p1sum, p5sum = lsum + loss, p1sum + p1, p5sum + p5
        if a > 1:
            r = reciprocal(a)  # `/ a` inside jit
            lsum, p1sum, p5sum = lsum * r, p1sum * r, p5sum * r
            if on_grad is None:
                gsum = [t * r for t in gsum]
        return None if on_grad is not None else gsum, bs_c, lsum, p1sum, p5sum

    def synced_grads(params_t, bs_in, xs, ys, scale, masks, on_grad=None):
        """Synced BN: each microbatch runs this process's workers' rows in
        one layer-synchronous forward over worker-stacked copies of the
        leaves, the statistics combined over ``axis`` (every process's
        workers), and one backward of the summed losses gives each copy
        its gradient (``[N_loc, *leaf]`` per leaf), the other processes'
        losses brought in by the statistics' backward. Returns those
        (None with ``on_grad``: its hooks finished them), the new BN
        stats and each local worker's loss, prec1, prec5."""
        if xs[0].shape[0] % a:
            raise ValueError(f"per-worker batch {xs[0].shape[0]} not divisible by "
                             f"grad_accum_steps={a}")
        leaves, skel = tree_flatten(params_t)
        gsum, bs_c = None, bs_in
        lsum, p1sum, p5sum = [0.0] * nl, [0.0] * nl, [0.0] * nl
        for i in range(a):
            xi = torch.cat([x.chunk(a)[i] for x in xs])
            yis = [y.chunk(a)[i] for y in ys]
            mi = None if masks is None else [torch.cat(ms) for ms in
                                             zip(*(micro(m, i) for m in masks))]
            stacked = [leaf.detach().unsqueeze(0).repeat(nl, *([1] * leaf.dim()))
                       .requires_grad_(True) for leaf in leaves]
            hooked = on_grad is not None and i == a - 1
            if hooked:
                finishing_hooks(stacked, scale, gsum, on_grad)
            with torch.enable_grad(), synced_stats_axis(axis):
                logits, bs_c = apply_model(model, tree_unflatten(skel, stacked), bs_c, xi,
                                           train=True, dropout=mi)
                per = logits.chunk(nl)
                losses = torch.stack([cross_entropy_loss(lw, yw) for lw, yw in zip(per, yis)])
                if scale is not None:
                    losses = losses * scale
                g = torch.autograd.grad(losses.sum(), stacked)
            losses = losses.detach()
            if scale is not None:
                losses = losses / scale
                if not hooked:
                    g = [t / scale for t in g]
            if not hooked:
                gsum = list(g) if gsum is None else [s + t for s, t in zip(gsum, g)]
            for w in range(nl):
                p1, p5 = accuracy(per[w].detach(), yis[w], (1, 5))
                lsum[w], p1sum[w], p5sum[w] = lsum[w] + losses[w], p1sum[w] + p1, p5sum[w] + p5
        if a > 1:
            r = reciprocal(a)  # `/ a` inside jit
            lsum, p1sum, p5sum = ([v * r for v in vs] for vs in (lsum, p1sum, p5sum))
            if on_grad is None:
                gsum = [t * r for t in gsum]
        return None if on_grad is not None else gsum, bs_c, lsum, p1sum, p5sum

    def extras(agg_count, prec_tags):
        """The controllers' values clamped on the device: ``(agg_count
        int32 or None, bucket_peaks f32 [n_buckets] or None)``."""
        if cfg.adaptive_aggregate != (agg_count is not None):
            raise ValueError("agg_count is the adaptive step's argument (num_aggregate_min/max "
                             "set), and only its")
        if cfg.precision_adapt != (prec_tags is not None):
            raise ValueError("prec_tags is the precision_adapt step's argument, and only its")
        if agg_count is not None:
            agg_count = torch.clamp(torch.as_tensor(agg_count, device=dev).to(torch.int32),
                                    cfg.num_aggregate_min, cfg.num_aggregate_max)
        peaks = None
        if prec_tags is not None:
            tags = torch.clamp(torch.as_tensor(prec_tags, device=dev).to(torch.int64), 0, 3)
            peaks = peak_table[tags]
        return agg_count, peaks

    def sqnorms(grads) -> torch.Tensor:
        """Each bucket's squared norm of the raw gradients (before EF and
        the mask), the mean over workers: ``[n_buckets]`` f32
        (ps.py:1205-1217)."""
        splan = state_plan(cfg, tree_layout(grads, stacked=True).total)
        flat = pad_flat(tree_to_flat(grads, stacked=True), splan)
        return axis.pmean(torch.stack([flat[:, s0:s0 + sz].square().sum(1)
                                       for s0, sz in zip(splan.starts, splan.sizes)], dim=1))

    def _bucket_stream(state, params_t, draws, agg_count, bucket_peaks, sel, k):
        """This step's ``_BucketStream``, with the dispatch of its wire:
        the ZeRO-1 bucket reduce, or the replicated ``bucket_wire``."""
        layout = tree_layout(params_t)
        if not side_box and dev.type == "cuda" and early:
            side_box.append(torch.cuda.Stream(device=dev))
        side = side_box[0] if side_box and early else None
        if cfg.opt_placement == "sharded":
            plan = _sharded_plan(cfg, layout.total)
            hi = precision_hi_peak(cfg) if bucket_peaks is not None else _INT8_PEAK
            err = state.comm_state if cfg.error_feedback else None

            def dispatch(b, piece):
                return _sharded_bucket_reduce(piece, b, plan, cfg, axis,
                                              cfg.effective_aggregate if k is None else k, sel,
                                              err, draws.rounding, bucket_peaks, hi)
        else:
            plan = state_plan(cfg, layout.total)
            reduce = bucket_wire(
                axis, n, plan.starts,
                num_aggregate=agg_count if agg_count is not None else cfg.num_aggregate,
                perm=draws.perm, mask_mode=cfg.mask_mode, compress=cfg.compress,
                quant_block_size=cfg.quant_block_size, quant_rounding=cfg.quant_rounding,
                quant_draws=draws.rounding, wire_domain=cfg.wire_domain,
                bucket_peaks=bucket_peaks,
                lattice_hi_peak=hi_peak if cfg.precision_adapt else _INT8_PEAK,
                return_contribution=cfg.error_feedback, device=dev)
            err_leaves = tree_flatten(state.comm_state)[0] if cfg.error_feedback else None

            def dispatch(b, piece):
                if err_leaves is not None:
                    # EF-SGD: last step's residual added before the wire
                    piece = piece + assemble_bucket(err_leaves, stream.segs[b], stacked=True)
                return reduce(plan.starts[b], piece)

        stream = _BucketStream(layout, plan, dispatch, side=side, early=early)
        return stream

    def _pipelined_update(state, pipe, grads, master):
        """The optimizer a bucket at a time over the pipelined wire's
        results: ``(new_master, new_opt, new_comm)``."""
        plan, layout, order = pipe.plan, pipe.layout, pipe.order
        if cfg.opt_placement == "sharded":
            new_params, new_opt, new_err = _sharded_ps_update_pipelined(
                state.params, state.opt_state, pipe.results, tx, cfg, axis, plan, layout,
                order, pipe.wait)
            return (new_params.flat if is_flat else new_params, new_opt,
                    new_err if cfg.error_feedback else state.comm_state)
        outs = [r[0] for r in pipe.results]
        new_comm = state.comm_state
        if cfg.error_feedback:
            for b in order:
                pipe.wait(b)
            contribution = leaves_from_buckets(layout, plan, [r[1] for r in pipe.results])
            new_comm = tree_map(torch.sub, tree_map(torch.add, grads, state.comm_state),
                                contribution)
        if is_flat:
            new_master, new_opt = _pipelined_flat_update(tx, outs, state.opt_state, master,
                                                         plan, order, pipe.wait)
            return new_master, new_opt, new_comm
        for b in order:
            pipe.wait(b)
        updates, new_opt = tx.update(leaves_from_buckets(layout, plan, outs), state.opt_state,
                                     master)
        return apply_updates(master, updates), new_opt, new_comm

    def step(state: PSTrainState, batch, draws: Optional[StepDraws] = None,
             agg_count=None, prec_tags=None):
        agg_count, bucket_peaks = extras(agg_count, prec_tags)
        images = torch.as_tensor(batch["image"]).to(dev)
        labels = torch.as_tensor(batch["label"]).to(dev).long()
        if images.shape[0] % nl:
            raise ValueError(f"batch {images.shape[0]} not divisible by "
                             f"{nl} workers")
        b = images.shape[0] // nl
        if draws is None:
            draws = draw_step(cfg, seed, state.step, b, preprocess, model, dev)
        # every process draws all N workers' draws; it keeps its own
        aug = None if draws.aug is None else draws.aug[lo:lo + nl]
        masks = None if draws.dropout is None else draws.dropout[lo:lo + nl]
        params_t = tree_view(state.params)
        bs = state.batch_stats
        scale = (state.guard_state.scale
                 if cfg.nonfinite_guard and cfg.dynamic_loss_scale else None)

        xs, ys = [], []
        for w in range(nl):
            x = images[w * b:(w + 1) * b]
            if preprocess is not None:
                x = preprocess(x, aug[w] if aug is not None else None)
            xs.append(x.float())
            ys.append(labels[w * b:(w + 1) * b])
        skel = tree_flatten(params_t)[1]
        poison = faults.poison(state.step + 1) if faults is not None else None
        sel, k = None, None
        if cfg.opt_placement == "sharded" and (agg_count is not None
                                               or cfg.effective_aggregate != n):
            sel = aggregation_mask(
                axis, n, agg_count if agg_count is not None else cfg.num_aggregate,
                draws.perm, cfg.mask_mode, device=dev)
        if agg_count is not None:
            k = agg_count.to(torch.float32)
        pipe = (_bucket_stream(state, params_t, draws, agg_count, bucket_peaks, sel, k)
                if pipelined else None)

        def pipe_leaf(i, g):
            """A finished leaf gradient, worker-stacked, into the stream."""
            if poison is not None:
                g = torch.full_like(g, poison)
            pipe.leaf_ready(i, g)

        if synced:
            # under bn_mode local the stats go in stacked [N, ...] and come
            # out so: each row's running update reads its own old row
            # (ps.py:1134) and the batch statistics every worker shares
            leaf_grads, nbs, losses, p1s, p5s = synced_grads(
                params_t, bs, xs, ys, scale, masks, on_grad=None if pipe is None else pipe_leaf)
            new_bs_w = [nbs] * nl
        else:
            per_worker, new_bs_w, losses, p1s, p5s = [], [], [], [], []
            for w in range(nl):
                bs_w = tree_map(lambda s: s[w], bs) if cfg.bn_mode == "local" else bs
                on_grad = None
                if pipe is not None and w == nl - 1:
                    def on_grad(i, t):
                        pipe_leaf(i, torch.stack([gw[i] for gw in per_worker] + [t]))
                g, nbs, loss, p1, p5 = worker_grads(params_t, bs_w, xs[w], ys[w], scale,
                                                    None if masks is None else masks[w],
                                                    on_grad=on_grad)
                per_worker.append(g)
                new_bs_w.append(nbs)
                losses.append(loss)
                p1s.append(p1)
                p5s.append(p5)
            if pipe is None:
                # the wire sees [N, *leaf] per leaf, as shard_map's psum sees
                # the per-device gradients
                leaf_grads = [torch.stack([gw[i] for gw in per_worker])
                              for i in range(len(per_worker[0]))]
        if pipe is not None:
            leaf_grads = pipe.finish()
        grads = tree_unflatten(skel, leaf_grads)
        if poison is not None and pipe is None:
            grads = tree_map(lambda t: torch.full_like(t, poison), grads)

        bucket_sqnorm = sqnorms(grads) if cfg.precision_adapt else None
        # every process's verdict: a NaN in any worker skips the step everywhere
        finite = axis.all_true(tree_all_finite(grads)) if cfg.nonfinite_guard else None
        new_comm = state.comm_state
        master = state.params.flat if is_flat else state.params
        if pipe is not None:
            new_master, new_opt, new_comm = _pipelined_update(state, pipe, grads, master)
        elif cfg.opt_placement == "sharded":
            new_params, new_opt, new_err = _sharded_ps_update(
                state.params, state.opt_state, grads, tx, cfg, axis, sel=sel,
                err=state.comm_state if cfg.error_feedback else None, k=k,
                draws=draws.rounding, bucket_peaks=bucket_peaks)
            new_master = new_params.flat if is_flat else new_params
            if cfg.error_feedback:
                new_comm = new_err
        else:
            if cfg.error_feedback:
                grads = tree_map(torch.add, grads, state.comm_state)
            out = aggregate_gradients(
                grads, axis, n,
                num_aggregate=agg_count if agg_count is not None else cfg.num_aggregate,
                perm=draws.perm, mask_mode=cfg.mask_mode, compress=cfg.compress,
                quant_block_size=cfg.quant_block_size,
                quant_rounding=cfg.quant_rounding,
                quant_draws=draws.rounding,
                return_contribution=cfg.error_feedback, bucket_bytes=cfg.bucket_bytes,
                flat_output=is_flat, wire_domain=cfg.wire_domain,
                bucket_peaks=bucket_peaks,
                lattice_hi_peak=hi_peak if cfg.precision_adapt else _INT8_PEAK,
            )
            if cfg.error_feedback:
                agg, contribution = out
                new_comm = tree_map(torch.sub, grads, contribution)
            else:
                agg = out
            updates, new_opt = tx.update(agg, state.opt_state, master)
            new_master = apply_updates(master, updates)

        if cfg.bn_mode == "local" and synced:
            out_bs = new_bs_w[0] if new_bs_w[0] else bs  # already [N, ...]
        elif cfg.bn_mode == "local":
            out_bs = (tree_map(lambda *xs: torch.stack(xs), *new_bs_w)
                      if new_bs_w[0] else bs)
        else:
            out_bs = (tree_map(lambda *xs: axis.pmean(torch.stack(xs)), *new_bs_w)
                      if new_bs_w[0] else bs)
        metrics = {"loss": axis.pmean(torch.stack(losses)),
                   "prec1": axis.pmean(torch.stack(p1s)),
                   "prec5": axis.pmean(torch.stack(p5s))}
        if bucket_sqnorm is not None:
            # a vector row among the scalars: the trainer pops it first
            metrics["bucket_sqnorm"] = bucket_sqnorm
        new_guard = state.guard_state
        if cfg.nonfinite_guard:
            # skip-step: a non-finite step is the identity update for
            # params, optimizer state, BN stats and EF residuals; only the
            # guard counters advance
            new_master = _select(finite, new_master, master)
            new_opt = dataclasses.replace(new_opt, **{
                f.name: _select(finite, getattr(new_opt, f.name),
                                getattr(state.opt_state, f.name))
                for f in dataclasses.fields(new_opt)})
            out_bs = _select(finite, out_bs, bs) if out_bs else out_bs
            new_comm = _select(finite, new_comm, state.comm_state)
            new_guard = update_guard_state(state.guard_state, finite,
                                           cfg.dynamic_loss_scale,
                                           cfg.loss_scale_growth_interval)
            metrics["skipped_steps"] = new_guard.skipped.float()
            metrics["skip_streak"] = new_guard.consec.float()
            if cfg.dynamic_loss_scale:
                metrics["loss_scale"] = new_guard.scale
        params = (dataclasses.replace(state.params, flat=new_master) if is_flat
                  else new_master)
        return PSTrainState(step=state.step + 1, params=params, opt_state=new_opt,
                            batch_stats=out_bs, comm_state=new_comm,
                            guard_state=new_guard), metrics

    return step


def make_ps_eval_step(model, cfg: PSConfig, mesh: Optional[WorkerAxis] = None,
                      preprocess: Optional[Callable] = None, device: DeviceLike = None):
    """Evaluation step: ``(state, batch) -> metrics`` (means over the
    workers' shards of loss, prec1, prec5; device scalars)."""
    dev = resolve_device(device)
    axis = mesh if mesh is not None else WorkerAxis(cfg.num_workers)
    n = axis.local_size

    @torch.no_grad()
    def step(state: PSTrainState, batch):
        images = torch.as_tensor(batch["image"]).to(dev)
        labels = torch.as_tensor(batch["label"]).to(dev).long()
        b = images.shape[0] // n
        params_t = tree_view(state.params)
        out = {"loss": [], "prec1": [], "prec5": []}
        for w in range(n):
            x = images[w * b:(w + 1) * b]
            x = preprocess(x) if preprocess is not None else x.float()
            bs = (tree_map(lambda s: s[w], state.batch_stats)
                  if cfg.bn_mode == "local" else state.batch_stats)
            logits, _ = apply_model(model, params_t, bs, x, train=False)
            y = labels[w * b:(w + 1) * b]
            p1, p5 = accuracy(logits, y, (1, 5))
            out["loss"].append(cross_entropy_loss(logits, y))
            out["prec1"].append(p1)
            out["prec5"].append(p5)
        return {k: axis.pmean(torch.stack(v)) for k, v in out.items()}

    return step
