"""The parameter-server data-parallel step on the stacked worker backend
(the port of parallel/ps.py: replicated placement, flat or tree state,
serial schedule).

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
  worker per-layer Isend             the per-leaf wire (collectives.py):
  master partial aggregate           mask -> int8 quantize (kernel K2 /
                                     K1's shared-scale entry) -> int32
                                     sum over workers -> dequantize / K
  master SGD step                    one fused update of the flat state
  BN stats                           bn_mode pmean (averaged) or local
                                     (per worker, stacked)

The non-finite guard checks every worker's gradients before the mask
(ps.py:1227-1242): a NaN in a worker the mask drops still skips the
step. The decision stays on the card: the state update is selected
against the flag with ``torch.where``, with no host read.

The step's random draws (the random_k permutation, each worker's crop
offsets and flips) come from a ``torch.Generator`` seeded from the run
seed and the step number, or are injected (``StepDraws``) so the parity
tests can feed the draws JAX made (``jax.random`` cannot be reproduced in
torch).

Not ported yet, and refused with a pointer to ROADMAP.md: the ZeRO-1
sharded placement, the pipelined schedule, bucketed wires, synced BN,
the two-round / hierarchical / homomorphic wires, stochastic rounding,
adaptive aggregation and adaptive precision.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from .. import DeviceLike, resolve_device
from ..models import apply_model, init_model
from ..ops.metrics import accuracy, cross_entropy_loss
from ..optim.sgd import SGDState, apply_updates
from ..resilience.guard import init_guard_state, tree_all_finite, update_guard_state
from .buckets import (
    BucketPlan,
    plan_buckets,
    to_flat_vector,
    tree_flatten,
    tree_layout,
    tree_map,
    tree_unflatten,
    tree_view,
)
from .collectives import aggregate_gradients, random_permutation, reciprocal
from .mesh import WORKER_AXIS, WorkerAxis

_ROADMAP = "is not ported yet (see ROADMAP.md queue 1)"


@dataclasses.dataclass(frozen=True)
class PSConfig:
    """The JAX PSConfig's knobs and validation (ps.py:85). The knobs of
    paths this slice does not port are kept, so a config carries across
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
        if self.bucket_bytes is not None and self.bucket_bytes < 0:
            raise ValueError(
                f"bad bucket_bytes {self.bucket_bytes} (None = per-leaf, "
                f"0 = one fused buffer, N>0 = ~N-byte buckets)")
        if self.wire_domain not in ("dequant", "homomorphic"):
            raise ValueError(f"bad wire_domain {self.wire_domain!r} (dequant | homomorphic)")
        if self.error_feedback and self.compress in (None, "none"):
            raise ValueError("error_feedback needs a compress mode")
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
        if self.loss_scale_init <= 0.0:
            raise ValueError(f"bad loss_scale_init {self.loss_scale_init} (must be > 0)")
        if self.mask_mode not in ("random_k", "first_k"):
            raise ValueError(f"unknown aggregation mode {self.mask_mode!r}")
        # what this slice does not port
        refused = [
            (self.dcn_hosts > 1 or not isinstance(self.axis_name, str),
             "hierarchical data parallelism (dcn_hosts > 1, a tuple axis_name)"),
            (self.opt_placement == "sharded", "the ZeRO-1 sharded placement"),
            (self.overlap == "pipelined", "the pipelined schedule (--overlap on)"),
            (self.bn_mode == "synced", "synced (cross-replica) BatchNorm"),
            (self.bucket_bytes is not None, "bucketed wires (--bucket-bytes >= 0)"),
            (self.compress == "int8_2round", "the two-round int8 wire (2round)"),
            (self.wire_domain != "dequant", "the homomorphic wire"),
            (self.quant_rounding != "nearest", "stochastic rounding"),
            (self.num_aggregate_min is not None, "adaptive partial aggregation"),
            (self.precision_adapt, "adaptive per-bucket precision"),
        ]
        for hit, what in refused:
            if hit:
                raise NotImplementedError(f"{what} {_ROADMAP}")

    @property
    def effective_aggregate(self) -> int:
        if self.num_aggregate is None or self.num_aggregate >= self.num_workers:
            return self.num_workers
        return self.num_aggregate


def wire_align(cfg: PSConfig) -> int:
    """Bucket-boundary alignment (f32 elements) of this config's wire
    (ps.py:442): the int8 quantization block for the quantized schemes,
    1 for per-tensor scales or no compression."""
    if cfg.compress in ("int8", "int8_2round") and cfg.quant_block_size:
        return cfg.quant_block_size
    return 1


def state_plan(cfg: PSConfig, total: int) -> BucketPlan:
    """The flat-state geometry (ps.py:478): the BucketPlan the config's
    gradient wire uses, so the reduced flat gradient drops straight into
    the vector update."""
    return plan_buckets(total, cfg.bucket_bytes or 0, align=wire_align(cfg))


@dataclasses.dataclass
class PSTrainState:
    """``step`` is a host int (the number of steps taken); the rest lives
    on the card. ``params`` is a FlatVector (state_layout="flat") or the
    tree; ``batch_stats`` is worker-stacked under bn_mode="local";
    ``comm_state`` holds the error-feedback residuals, worker-stacked per
    param leaf (or None)."""

    step: int
    params: Any
    opt_state: SGDState
    batch_stats: Any
    comm_state: Any = None
    guard_state: Any = None


def init_ps_state(model, tx, cfg: PSConfig, generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None, params=None,
                  batch_stats=None) -> PSTrainState:
    """The initial state: params from ``generator`` (or the given
    ``params``/``batch_stats`` trees, e.g. converted JAX weights), laid
    out as the config asks, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    if params is None:
        params, batch_stats = init_model(model, generator, device=dev)
    params = tree_map(lambda p: p.to(dev, torch.float32), params)
    batch_stats = tree_map(lambda s: s.to(dev), batch_stats or {})
    if cfg.state_layout == "flat":
        master = to_flat_vector(params, state_plan(cfg, tree_layout(params).total))
        opt_state = tx.init(master.flat)
    else:
        master = params
        opt_state = tx.init(params)
    n = cfg.num_workers
    if cfg.bn_mode == "local" and batch_stats:
        batch_stats = tree_map(lambda s: s.expand((n,) + tuple(s.shape)).clone(),
                               batch_stats)
    comm_state = None
    if cfg.error_feedback:
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
    (``[N]`` int, or None when no mask is drawn) and each worker's
    augmentation draws (a list of N ``CropFlipDraws``, or None when the
    preprocessor does not augment)."""

    perm: Optional[torch.Tensor] = None
    aug: Optional[List[Any]] = None


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws: a function of the run seed
    and the step number only (the role of ``fold_in(key, step_idx)``)."""
    return torch.Generator().manual_seed((seed * 1_000_003 + step) % (2 ** 63))


def draw_step(cfg: PSConfig, seed: int, step: int, batch_per_worker: int,
              preprocess=None) -> StepDraws:
    g = step_generator(seed, step)
    perm = None
    if cfg.effective_aggregate != cfg.num_workers and cfg.mask_mode == "random_k":
        perm = random_permutation(cfg.num_workers, g)
    aug = None
    if preprocess is not None and getattr(preprocess, "augment", False):
        aug = [preprocess.draw(g, batch_per_worker) for _ in range(cfg.num_workers)]
    return StepDraws(perm=perm, aug=aug)


def _select(finite: torch.Tensor, new, old):
    """The guard's rollback: ``new`` where the step was finite, else
    ``old``, leaf by leaf (both trees, or both None)."""
    if new is None:
        return None
    return tree_map(lambda a, b: torch.where(finite, a, b), new, old)


def make_ps_train_step(model, tx, cfg: PSConfig, mesh: Optional[WorkerAxis] = None,
                       preprocess: Optional[Callable] = None, faults=None,
                       seed: int = 0, device: DeviceLike = None):
    """Build the train step: ``step(state, batch, draws=None) -> (state,
    metrics)``.

    ``batch`` is ``{"image": uint8 [N*B, H, W, C], "label": int [N*B]}``
    (numpy or torch); worker w takes rows ``[w*B, (w+1)*B)``. ``draws``
    (StepDraws) overrides the step's own draws. ``metrics`` holds device
    scalars (mean over workers of loss, prec1, prec5, plus the guard's
    ``skipped_steps`` / ``skip_streak``): reading them is the caller's
    host sync. ``faults`` (resilience.faults.FaultPlan) poisons every
    gradient at its planned steps."""
    dev = resolve_device(device)
    axis = mesh if mesh is not None else WorkerAxis(cfg.num_workers)
    if axis.size != cfg.num_workers:
        raise ValueError(f"mesh holds {axis.size} workers, cfg says {cfg.num_workers}")
    n, a = cfg.num_workers, cfg.grad_accum_steps
    is_flat = cfg.state_layout == "flat"

    def worker_grads(params_t, bs_in, x, y, scale):
        """One worker's forward/backward on its shard (``a``
        microbatches, BN stats carried through them)."""
        if x.shape[0] % a:
            raise ValueError(f"per-worker batch {x.shape[0]} not divisible by "
                             f"grad_accum_steps={a}")
        leaves, skel = tree_flatten(params_t)
        xs, ys = x.chunk(a), y.chunk(a)
        gsum, lsum, p1sum, p5sum, bs_c = None, 0.0, 0.0, 0.0, bs_in
        for xi, yi in zip(xs, ys):
            leaves_g = [leaf.detach().requires_grad_(True) for leaf in leaves]
            with torch.enable_grad():
                logits, bs_c = apply_model(model, tree_unflatten(skel, leaves_g),
                                           bs_c, xi, train=True)
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
                g = [t / scale for t in g]
            p1, p5 = accuracy(logits.detach(), yi, (1, 5))
            gsum = list(g) if gsum is None else [s + t for s, t in zip(gsum, g)]
            lsum, p1sum, p5sum = lsum + loss, p1sum + p1, p5sum + p5
        if a > 1:
            r = reciprocal(a)  # `/ a` inside jit
            gsum = [t * r for t in gsum]
            lsum, p1sum, p5sum = lsum * r, p1sum * r, p5sum * r
        return gsum, bs_c, lsum, p1sum, p5sum

    def step(state: PSTrainState, batch, draws: Optional[StepDraws] = None):
        images = torch.as_tensor(batch["image"]).to(dev)
        labels = torch.as_tensor(batch["label"]).to(dev).long()
        if images.shape[0] % n:
            raise ValueError(f"global batch {images.shape[0]} not divisible by "
                             f"{n} workers")
        b = images.shape[0] // n
        if draws is None:
            draws = draw_step(cfg, seed, state.step, b, preprocess)
        params_t = tree_view(state.params)
        bs = state.batch_stats
        scale = (state.guard_state.scale
                 if cfg.nonfinite_guard and cfg.dynamic_loss_scale else None)

        per_worker, new_bs_w, losses, p1s, p5s = [], [], [], [], []
        for w in range(n):
            x = images[w * b:(w + 1) * b]
            if preprocess is not None:
                x = preprocess(x, draws.aug[w] if draws.aug is not None else None)
            bs_w = tree_map(lambda s: s[w], bs) if cfg.bn_mode == "local" else bs
            g, nbs, loss, p1, p5 = worker_grads(params_t, bs_w, x.float(),
                                                labels[w * b:(w + 1) * b], scale)
            per_worker.append(g)
            new_bs_w.append(nbs)
            losses.append(loss)
            p1s.append(p1)
            p5s.append(p5)
        # the wire sees [N, *leaf] per leaf, as shard_map's psum sees the
        # per-device gradients
        skel = tree_flatten(params_t)[1]
        grads = tree_unflatten(skel, [torch.stack([gw[i] for gw in per_worker])
                                      for i in range(len(per_worker[0]))])
        if faults is not None:
            val = faults.poison(state.step + 1)
            if val is not None:
                grads = tree_map(lambda t: torch.full_like(t, val), grads)

        finite = tree_all_finite(grads) if cfg.nonfinite_guard else None
        new_comm = state.comm_state
        if cfg.error_feedback:
            grads = tree_map(torch.add, grads, state.comm_state)
        out = aggregate_gradients(
            grads, axis, n, num_aggregate=cfg.num_aggregate, perm=draws.perm,
            mask_mode=cfg.mask_mode, compress=cfg.compress,
            quant_block_size=cfg.quant_block_size, quant_rounding=cfg.quant_rounding,
            return_contribution=cfg.error_feedback, bucket_bytes=cfg.bucket_bytes,
            flat_output=is_flat,
        )
        if cfg.error_feedback:
            agg, contribution = out
            new_comm = tree_map(torch.sub, grads, contribution)
        else:
            agg = out
        master = state.params.flat if is_flat else state.params
        updates, new_opt = tx.update(agg, state.opt_state, master)
        new_master = apply_updates(master, updates)

        if cfg.bn_mode == "local":
            out_bs = (tree_map(lambda *xs: torch.stack(xs), *new_bs_w)
                      if new_bs_w[0] else bs)
        else:
            out_bs = (tree_map(lambda *xs: axis.pmean(torch.stack(xs)), *new_bs_w)
                      if new_bs_w[0] else bs)
        metrics = {"loss": axis.pmean(torch.stack(losses)),
                   "prec1": axis.pmean(torch.stack(p1s)),
                   "prec5": axis.pmean(torch.stack(p5s))}
        new_guard = state.guard_state
        if cfg.nonfinite_guard:
            # skip-step: a non-finite step is the identity update for
            # params, optimizer state, BN stats and EF residuals; only the
            # guard counters advance
            new_master = _select(finite, new_master, master)
            new_opt = SGDState(
                count=torch.where(finite, new_opt.count, state.opt_state.count),
                momentum_buffer=_select(finite, new_opt.momentum_buffer,
                                        state.opt_state.momentum_buffer))
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
    n = cfg.num_workers

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
