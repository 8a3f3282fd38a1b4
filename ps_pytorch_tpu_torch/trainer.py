"""The training loop: the host side around the PS train step (the port of
trainer.py).

One host loop drives the N virtual workers of the stacked backend: each
worker keeps its own epoch-shuffled iterator over its shard (the
reference's per-worker DataLoaders), the global batch stacks the
workers' batches, and one call of the train step is one global step.
Over processes (``torch.distributed`` initialised, the axis a
``ProcessWorkerAxis``) each process runs this loop for its own workers'
ids (``mesh.batch_sharding``) with the same step schedule; the run id is
rank 0's, the stop flag is agreed every step (a SIGTERM on one process
stops all at the same step), rank 0 picks the step a ``--resume``
restores, and a checkpoint gathers the per-worker state to rank 0, the
single writer (checkpoint.py). The
loop reads the metrics only once per log window (the per-step host sync
the JAX trainer also avoids), logs the reference-format line, and runs
the host half of the non-finite guard there.

The batches: each epoch the workers' host batches go through
``data.prefetch_to_device`` (two in flight, pinned staging, a copy
stream), so the step receives them on the card; validation and the
evaluator ride the same prefetch.

The event stream: every record goes through ``append_metrics_line`` into
the metrics JSONL (``--metrics-file``), validated against
``obs/schema.py``: a ``run_header``, one ``train`` record a log window,
``eval``, ``grad_skip``, the watchdog's ``straggler`` /
``straggler_storm`` / ``straggler_storm_end``, the controllers'
``mask_adapt`` / ``precision_adapt``, ``ckpt_quarantined`` and
``ckpt_write_failed``. ``--trace DIR`` writes the loop's host spans
(``fetch`` with the prefetch's ``h2d`` inside it, ``dispatch``, ``sync``,
``guard``, ``ckpt_save``) to ``DIR/trace_train_p{rank}.jsonl`` under the
same run id; with tracing off the tracer is ``NULL_TRACER`` and adds no
host sync.

The adaptive controllers (trainer.py:211-310 of the JAX package): with
``num_aggregate_min/max`` an ``elastic.AdaptiveMaskController`` picks
each window's aggregation count from the watchdog's step walltimes;
with ``precision_adapt`` a ``precision.PrecisionController`` picks each
window's bucket tags from the step's ``bucket_sqnorm`` row (read every
step: that controller's own host sync). Both values reach the step as
device int32 tensors, rebuilt only when they change. Over processes the
min over processes of each (``_count_consensus``, ``_tags_consensus``)
is taken at every window close. The straggler watchdog
(``straggler_threshold_s``) waits for each step on the host only when
armed. ``request_stop`` (SIGTERM / SIGINT through
``install_signal_handlers``) finishes the step, writes a checkpoint and
returns; ``--resume`` continues the step count.

Checkpoints (checkpoint.py): ``model_step_N`` every ``eval_freq`` steps
and once at the end, written by one background thread from a host copy
taken at the step boundary, with an ``elastic.json`` geometry manifest;
``--resume`` restores the newest valid one, quarantining a damaged file
and falling back to the next older. The files are the JAX trainer's,
byte for byte, so either package resumes the other's directory.

A checkpoint written on another geometry (worker count, placement,
ZeRO-1 carving, BN locality) is reshaped on resume
(``elastic.reshape_raw_state``) and logged as a ``resume_reshape``
record. ``compress_checkpoints`` writes the ``PSCK`` form (the native
codec, ops/codec.py); ``--resume`` reads either form.

The profiler window (obs/profiler.py): with ``profile_dir`` the loop
captures a ``torch.profiler`` trace of steps ``[profile_start,
profile_start + profile_steps)`` (``profile_start`` None: the run's first
step + 1, after cuDNN's algorithm search), ends a capture the run leaves
open from its ``finally``, and logs when the window misses the run's
steps. ``Trainer.profile_window`` keeps the last run's window.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import signal
import time
from typing import List, Optional

import numpy as np
import torch

from . import DeviceLike, resolve_device
from . import checkpoint as ckpt
from .data import (
    BatchIterator,
    Dataset,
    make_preprocessor,
    prefetch_to_device,
    prepare_data,
    shard_for_worker,
)
from .models import COMPUTE_DTYPES, build_model, param_count
from .obs import NULL_TRACER, ProfileWindow, Tracer, new_run_id, run_header, validate_event
from .optim import build_optimizer
from .parallel.buckets import FlatVector, tree_map
from .parallel.mesh import (
    ProcessWorkerAxis,
    batch_sharding,
    make_worker_axis,
)
from .parallel.ps import (
    PSConfig,
    PSTrainState,
    init_ps_state,
    make_ps_eval_step,
    make_ps_train_step,
    state_plan,
)
from .resilience import elastic
from .resilience.precision import PrecisionController
from .resilience.faults import resolve_fault_plan
from .utils import format_eval_line, format_iter_line, get_logger

logger = get_logger()


def append_metrics_line(path: Optional[str], record: dict) -> None:
    """The metrics JSONL's one write choke point (trainer.py:67 of the JAX
    package): each record is validated against ``obs/schema.py``
    (unknown kinds and missing fields raise, counters become ints) and
    stamped with a ``t_wall`` second, so the stream merges onto the span
    trace's timeline (``python -m ps_pytorch_tpu_torch.tools.trace_report``)."""
    if not path:
        return
    record = validate_event(record)
    record.setdefault("t_wall", round(time.time(), 6))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _moments(opt) -> dict:
    """The optimizer state's moment fields (every field but ``count``):
    SGD's ``momentum_buffer``, Adam's ``exp_avg`` / ``exp_avg_sq`` /
    ``max_exp_avg_sq``."""
    return {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt) if f.name != "count"}


def average_metrics(step_fn, batches) -> dict:
    """Uniform average of per-batch metric dicts (trainer.py:103; the
    batches are equal-sized: BatchIterator drops partial tails). Shared by
    Trainer.validate and the out-of-band Evaluator."""
    sums, count = {}, 0
    for batch in batches:
        for k, v in step_fn(batch).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
    return {k: v / max(count, 1) for k, v in sums.items()}


@dataclasses.dataclass
class TrainConfig:
    """The JAX TrainConfig's host-loop knobs (same names and defaults)."""

    network: str = "LeNet"
    dataset: str = "MNIST"
    batch_size: int = 128  # per-worker batch, reference --batch-size
    test_batch_size: int = 500
    epochs: int = 100
    max_steps: int = 10000
    lr: float = 0.01
    momentum: float = 0.5
    weight_decay: float = 0.0
    optimizer: str = "sgd"
    seed: int = 1
    log_interval: int = 10
    eval_freq: int = 50
    train_dir: str = "output/models/"
    save_checkpoints: bool = True
    compress_checkpoints: bool = False
    resume: bool = False
    data_root: Optional[str] = None
    allow_synthetic: bool = True
    shard_mode: str = "reshuffle"
    dtype: str = "float32"
    remat: bool = False
    metrics_file: Optional[str] = None
    trace_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_start: Optional[int] = None
    profile_steps: int = 10
    straggler_threshold_s: Optional[float] = None
    straggler_storm_n: int = 3
    max_consecutive_skips: int = 8
    adapt_window: int = 20
    wire_budget_bytes: Optional[int] = None
    fault_plan: Optional[str] = None


class Trainer:
    """Drives PS data-parallel training of one model on N virtual
    workers of one device (default ``cuda``), over the processes of the
    ``torch.distributed`` group once one is initialised
    (``make_worker_axis``)."""

    def __init__(self, tcfg: TrainConfig, pcfg: PSConfig,
                 dataset: Optional[Dataset] = None, device: DeviceLike = None):
        if tcfg.straggler_storm_n < 1:
            # 0 would swallow both the per-step straggler events and the
            # storm event (trainer.py:192 of the JAX package)
            raise ValueError(
                f"straggler_storm_n must be >= 1, got {tcfg.straggler_storm_n} (1 = "
                f"escalate immediately; use a large value to effectively disable storms)")
        self.tcfg, self.pcfg = tcfg, pcfg
        self.device = resolve_device(device)
        self._stop_requested = False
        self._prev_handlers: dict = {}
        # the watchdog's counters and the open storm's length
        self.straggler_steps = 0
        self.straggler_storms = 0
        self._straggler_streak = 0
        self.faults = resolve_fault_plan(tcfg.fault_plan)
        if self.faults is not None:
            logger.warning("fault injection ACTIVE: %s", self.faults)
        self.dataset = dataset or prepare_data(tcfg.dataset, root=tcfg.data_root,
                                               allow_synthetic=tcfg.allow_synthetic)
        # the flat axis, or the (hosts x per_host) grid of the hierarchical
        # wire (trainer.py:242), on one process or over the group's
        self.mesh = make_worker_axis(pcfg.num_workers, pcfg.dcn_hosts)
        self.multi = isinstance(self.mesh, ProcessWorkerAxis)
        self.rank = self.mesh.rank if self.multi else 0
        # bf16 compute over f32 params, optimizer state and loss when asked
        self.model = build_model(
            tcfg.network, num_classes=self.dataset.num_classes,
            dtype=COMPUTE_DTYPES[tcfg.dtype],
            bn_axis_name=pcfg.axis_name if pcfg.bn_mode == "synced" else None,
            remat=tcfg.remat)
        self.tx = build_optimizer(tcfg.optimizer, tcfg.lr, momentum=tcfg.momentum,
                                  weight_decay=tcfg.weight_decay)
        self.state = init_ps_state(self.model, self.tx, pcfg,
                                   torch.Generator().manual_seed(tcfg.seed),
                                   device=self.device, mesh=self.mesh)
        self._train_step = make_ps_train_step(
            self.model, self.tx, pcfg, self.mesh,
            preprocess=make_preprocessor(tcfg.dataset, train=True),
            faults=self.faults, seed=tcfg.seed + 1, device=self.device)
        self._eval_step = make_ps_eval_step(
            self.model, pcfg, self.mesh,
            preprocess=make_preprocessor(tcfg.dataset, train=False), device=self.device)
        self._skipped_seen = 0
        # the sink holds the path, not the trainer: no reference cycle keeps
        # a finished trainer's device state alive until a garbage collection
        self._event = functools.partial(append_metrics_line, tcfg.metrics_file)
        self._ckpt = ckpt.AsyncCheckpointer(event_sink=self._event, faults=self.faults)
        # one run id ties the metrics streams and the span traces of every
        # process together (JAX _shared_run_id: rank 0's, broadcast)
        self.run_id = (self.mesh.broadcast_object(new_run_id()) if self.multi
                       else new_run_id())
        self.tracer = NULL_TRACER
        self.profile_window: Optional[ProfileWindow] = None  # set by train()
        if tcfg.trace_dir:
            self.tracer = Tracer(
                "train", path=os.path.join(tcfg.trace_dir, f"trace_train_p{self.rank}.jsonl"),
                run_id=self.run_id, annotate=True, geometry=self._geometry(), pid=self.rank)
        # one record per log window: step, loss, time_cost (seconds per
        # step over the window, measured after the window's metrics read)
        self.history: List[dict] = []
        layout = getattr(self.state.params, "layout", None)
        n_params = layout.total if layout is not None else param_count(self.state.params)
        # the adaptive controllers, the host halves of the step's agg_count
        # and prec_tags; the precision tags are sized from the BucketPlan
        # the wire carves, so tag b names wire bucket b
        self._adaptive = None
        if pcfg.adaptive_aggregate:
            self._adaptive = elastic.AdaptiveMaskController(
                pcfg, tcfg.straggler_threshold_s, tcfg.adapt_window, event_sink=self._event,
                consensus=self._count_consensus if self.multi else None)
        self._precision = None
        if pcfg.precision_adapt:
            self._precision = PrecisionController(
                pcfg, state_plan(pcfg, n_params).sizes, tcfg.adapt_window,
                budget_bytes=tcfg.wire_budget_bytes, event_sink=self._event,
                consensus=self._tags_consensus if self.multi else None)
        self._extras: dict = {}
        logger.info("model %s (%d params), dataset %s%s, %d workers on %s",
                    tcfg.network, n_params, self.dataset.name,
                    " [synthetic]" if self.dataset.synthetic else "",
                    pcfg.num_workers, self.device)

    def _count_consensus(self, proposed: int) -> int:
        """The next window's aggregation count every process adopts: the
        min over processes of the proposals (trainer.py:617), an int32
        collective each process reaches at the same step-counted window
        close."""
        return int(self.mesh.min_over_hosts(np.asarray([proposed], np.int32))[0])

    def _tags_consensus(self, proposed: np.ndarray) -> np.ndarray:
        """The next window's precision tags every process adopts: the
        elementwise min over processes (trainer.py:632): the coarsest
        lattice any process wants."""
        return self.mesh.min_over_hosts(np.asarray(proposed, np.int32))

    def _step_extras(self) -> dict:
        """The controllers' current values as the step's device int32
        arguments (JAX's order: ``agg_count``, then ``prec_tags``), copied
        to the device only when a value changed."""
        for name, ctl, value in (
                ("agg_count", self._adaptive, lambda c: np.asarray(c.count, np.int32)),
                ("prec_tags", self._precision, lambda c: np.asarray(c.tags, np.int32))):
            if ctl is None:
                continue
            host = value(ctl)
            held = self._extras.get(name)
            if held is None or not np.array_equal(held[0], host):
                self._extras[name] = (host.copy(), torch.from_numpy(host.copy()).to(self.device))
        return {name: dev for name, (_, dev) in self._extras.items()}

    def _geometry(self) -> dict:
        """The run header's geometry block (trainer.py:364)."""
        return {"num_workers": self.pcfg.num_workers, "network": self.tcfg.network,
                "dataset": self.tcfg.dataset, "opt_placement": self.pcfg.opt_placement,
                "state_layout": self.pcfg.state_layout,
                "processes": self.mesh.world if self.multi else 1}

    # ------------------------------------------------------------- checkpoints
    def checkpoint_state(self) -> PSTrainState:
        """The live state as a checkpoint holds it: the JAX PSTrainState
        leaf for leaf. ``step`` is a 0-d int32 array; under the flat
        layout the replicated momenta carry the params' geometry (a
        FlatVector, tree-shaped on disk) where the port keeps the bare
        vector; under ZeRO-1 the optimizer's ``count`` has one entry per
        worker, where the port keeps one scalar."""
        st = dataclasses.replace(self.state, step=np.asarray(self.state.step, np.int32))
        if self.multi:
            # every worker's rows, gathered on every process (a collective)
            st = self._per_worker(st, self.mesh.gather_rows)
        opt = st.opt_state
        if isinstance(st.params, FlatVector) and self.pcfg.opt_placement != "sharded":
            opt = dataclasses.replace(opt, **{
                name: dataclasses.replace(st.params, flat=m)
                for name, m in _moments(opt).items() if isinstance(m, torch.Tensor)})
        if self.pcfg.opt_placement == "sharded":
            opt = dataclasses.replace(
                opt, count=np.full((self.pcfg.num_workers,), int(opt.count), np.int32))
        st.opt_state = opt
        return st

    def _live_state(self, view: PSTrainState, step: int) -> PSTrainState:
        """The inverse of ``checkpoint_state`` on a restored view."""
        opt = view.opt_state
        if not isinstance(opt.count, torch.Tensor):
            # ZeRO-1: JAX keeps one count per worker, the port one scalar
            counts = np.asarray(opt.count).reshape(-1).tolist()
            if len(set(counts)) != 1:
                raise ValueError(f"checkpoint step {step}: the workers' optimizer counts "
                                 f"differ ({counts})")
            opt = dataclasses.replace(opt, count=torch.tensor(
                counts[0], dtype=torch.int32, device=self.device))
        opt = dataclasses.replace(opt, **{name: m.flat for name, m in _moments(opt).items()
                                          if isinstance(m, FlatVector)})
        view = dataclasses.replace(view, step=int(np.asarray(view.step)), opt_state=opt)
        return (self._per_worker(view, lambda t: self.mesh.local(t).clone()) if self.multi
                else view)

    def _per_worker(self, st: PSTrainState, fn) -> PSTrainState:
        """``fn`` over the state's per-worker parts, whose rows are this
        process's workers in the live state and every worker's in a
        checkpoint: the EF residuals, local BN stats and ZeRO-1 moments."""
        rows = lambda tree: None if tree is None else tree_map(fn, tree)
        opt = st.opt_state
        if self.pcfg.opt_placement == "sharded":
            opt = dataclasses.replace(opt, **{k: rows(v) for k, v in _moments(opt).items()})
        bs = rows(st.batch_stats) if self.pcfg.bn_mode == "local" else st.batch_stats
        return dataclasses.replace(st, comm_state=rows(st.comm_state), batch_stats=bs,
                                   opt_state=opt)

    def _save(self, step_no: int) -> None:
        """Record this run's geometry for the step (trainer.py:646), then
        copy the state to the host and hand it to the writer thread. Over
        processes every process gathers, rank 0 alone writes, at once,
        and no process returns before the file is durable
        (``AsyncCheckpointer.save_collective``)."""
        if not self.multi:
            elastic.save_geometry(self.tcfg.train_dir, elastic.geometry_of(self.pcfg),
                                  step=step_no)
            self._ckpt.save(self.checkpoint_state(), self.tcfg.train_dir, step_no,
                            self.tcfg.compress_checkpoints)
            return
        state = self.checkpoint_state()
        if self.rank == 0:
            elastic.save_geometry(self.tcfg.train_dir, elastic.geometry_of(self.pcfg),
                                  step=step_no)
        self._ckpt.save_collective(state, self.tcfg.train_dir, step_no, self.mesh,
                                   self.tcfg.compress_checkpoints)

    def _quarantine(self, step: int, err: BaseException) -> None:
        logger.warning("resume: checkpoint step %d is corrupt (%s); quarantining "
                       "and falling back", step, err)
        path = ckpt.quarantine_checkpoint(self.tcfg.train_dir, step)
        self._event({"kind": "ckpt_quarantined", "step": step, "path": path,
                     "error": str(err)})

    def _try_resume_multihost(self) -> Optional[int]:
        """Agreed resume (trainer.py:512-540): rank 0 picks the newest
        step whose file passes the integrity check (it alone quarantines,
        so no two processes rename one file), the choice is broadcast, and
        every process restores that step. A process whose read of it then
        fails raises: a crashed run beats diverged replicas."""
        chosen = -1
        if self.rank == 0:
            for step in reversed(ckpt.available_steps(self.tcfg.train_dir)):
                try:
                    ckpt.verify_checkpoint(self.tcfg.train_dir, step)
                    chosen = step
                    break
                except ckpt.CheckpointCorruptError as e:
                    self._quarantine(step, e)
                except OSError as e:
                    logger.warning("resume: checkpoint step %d unreadable (%s); trying older "
                                   "(file left in place)", step, e)
        chosen = int(self.mesh.broadcast_object(chosen))
        if chosen < 0:
            return None
        self.state = self._restore_step(chosen)
        self._sync_guard_baseline()
        logger.info("resumed from %s (agreed by the processes)",
                    ckpt.checkpoint_path(self.tcfg.train_dir, chosen))
        return chosen

    def try_resume(self) -> Optional[int]:
        """Restore the newest VALID checkpoint of train_dir, if any
        (trainer.py:377). A damaged file is quarantined (renamed
        ``*.corrupt``) and the next older one tried; an unreadable one is
        skipped and left in place. Structure mismatches (e.g. EF residuals
        for a run with EF off) raise: they are configuration errors."""
        if self.multi:
            return self._try_resume_multihost()
        for step in reversed(ckpt.available_steps(self.tcfg.train_dir)):
            try:
                restored = self._restore_step(step)
            except ckpt.CheckpointCorruptError as e:
                self._quarantine(step, e)
                continue
            except OSError as e:
                logger.warning("resume: checkpoint step %d unreadable (%s); trying older "
                               "(file left in place)", step, e)
                continue
            self.state = restored
            self._sync_guard_baseline()
            logger.info("resumed from %s", ckpt.checkpoint_path(self.tcfg.train_dir, step))
            return step
        return None

    def _restore_step(self, step: int):
        """Checkpoint ``step`` into the live state's structure, through the
        elastic reshape when the manifest says another geometry wrote the
        file (trainer.py:430). Over processes every process reshapes the
        same bytes (rank 0 verified them) into the gathered checkpoint
        form, then keeps its own workers' rows."""
        raw = ckpt.load_checkpoint_raw(self.tcfg.train_dir, step)
        src = elastic.load_geometry(self.tcfg.train_dir, step=step)
        dst = elastic.geometry_of(self.pcfg)
        target = self.checkpoint_state()
        if src is not None and elastic.needs_reshape(src, dst):
            logger.warning("resume-reshape: checkpoint step %d was written on %d workers "
                           "(%s placement); reshaping onto %d workers (%s placement)",
                           step, src.num_workers, src.opt_placement, dst.num_workers,
                           dst.opt_placement)
            raw = elastic.reshape_raw_state(raw, src, self.pcfg, target)
            self._event({"kind": "resume_reshape", "step": step, "from": src.to_json(),
                         "to": dst.to_json()})
            return self._live_state(ckpt.restore_from_raw(target, raw, step), step)
        try:
            restored = self._live_state(ckpt.restore_from_raw(target, raw, step), step)
        except ValueError as e:
            if src is None:
                raise ValueError(
                    f"cannot restore checkpoint step {step}: {e}. No elastic.json "
                    f"manifest entry in {self.tcfg.train_dir!r}: if the mesh geometry "
                    f"changed since this checkpoint was written, resume on the original "
                    f"geometry") from e
            raise
        if src is None and self.pcfg.opt_placement == "sharded":
            logger.warning("resumed checkpoint step %d without an elastic manifest entry: "
                           "cannot verify its ZeRO-1 carving matches --bucket-bytes / "
                           "--quant-block-size", step)
        return restored

    def _sync_guard_baseline(self) -> None:
        """A restored guard carries the lifetime skip count: start the
        host's reported watermark there, so old skips are not reported
        again (trainer.py:489)."""
        if self.state.guard_state is not None:
            self._skipped_seen = int(self.state.guard_state.skipped)

    def _guard_check(self, m: dict, step_no: int, abort: bool = True) -> None:
        """Host half of the non-finite guard, on metrics already read:
        one ``grad_skip`` record for new skips, abort past
        ``max_consecutive_skips``."""
        if "skipped_steps" not in m:
            return
        skipped, streak = int(m["skipped_steps"]), int(m["skip_streak"])
        if skipped > self._skipped_seen:
            logger.warning("non-finite gradients: %d step(s) skipped so far "
                           "(current streak %d) — params were NOT updated on those",
                           skipped, streak)
            rec = {"kind": "grad_skip", "step": step_no, "skipped_steps": skipped,
                   "skip_streak": streak}
            if "loss_scale" in m:
                rec["loss_scale"] = float(m["loss_scale"])
            self._event(rec)
            self._skipped_seen = skipped
        k = self.tcfg.max_consecutive_skips
        if abort and k > 0 and streak >= k:
            raise RuntimeError(
                f"aborting at step {step_no}: {streak} consecutive steps had "
                f"non-finite gradients (threshold {k}); params are stuck at step "
                f"{step_no - streak}")

    # ------------------------------------------------------------ graceful stop
    def request_stop(self) -> None:
        """Ask the loop to stop after the current step (and write a final
        checkpoint). Safe from signal handlers and threads."""
        self._stop_requested = True

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested

    def _stop_consensus(self) -> bool:
        """The stop flag every process agrees on, once a step
        (trainer.py:667-690): one process, its own flag; over processes
        the OR of every process's (a collective each reaches at the same
        step), promoted into the local flag so every process takes the
        preemption exit."""
        if self.multi and self.mesh.any_host(self._stop_requested):
            self._stop_requested = True
        return self._stop_requested

    def install_signal_handlers(self) -> None:
        """SIGTERM / SIGINT -> graceful stop: finish the step, checkpoint,
        return, so a preempted run resumes exactly with ``--resume``
        (trainer.py:692). Call from the main thread; a second signal takes
        the default action."""
        def handler(signum, frame):
            logger.warning("signal %d: stopping after current step (next one kills)",
                           signum)
            self.request_stop()
            signal.signal(signum, signal.SIG_DFL)

        self._prev_handlers = {sig: signal.signal(sig, handler)
                               for sig in (signal.SIGTERM, signal.SIGINT)}

    def restore_signal_handlers(self) -> None:
        """Put back the handlers ``install_signal_handlers`` replaced (one
        installed from C cannot be put back: the default takes its place)."""
        for signum, prev in self._prev_handlers.items():
            signal.signal(signum, signal.SIG_DFL if prev is None else prev)
        self._prev_handlers = {}

    # ------------------------------------------------------- straggler watchdog
    def _watchdog(self, step_no: int, step_s: float, first_step: int) -> None:
        """One armed step's verdict (trainer.py:907-971): a slow step is a
        ``straggler`` record until ``straggler_storm_n`` in a row, which
        become one ``straggler_storm``; a fast step closes an open storm.
        The run's first step (cuDNN's algorithm search) is exempt."""
        t = self.tcfg
        if step_s > t.straggler_threshold_s and step_no != first_step:
            self.straggler_steps += 1
            self._straggler_streak += 1
            if self._straggler_streak < t.straggler_storm_n:
                logger.warning("straggler step: Step: %d took %.4fs (threshold %.4fs)",
                               step_no, step_s, t.straggler_threshold_s)
                self._event({"kind": "straggler", "step": step_no,
                             "time_cost": round(step_s, 6),
                             "threshold": t.straggler_threshold_s})
            elif self._straggler_streak == t.straggler_storm_n:
                self.straggler_storms += 1
                logger.warning("straggler storm: %d consecutive slow steps (through step "
                               "%d, threshold %.4fs) — suppressing per-step warnings until "
                               "it clears", self._straggler_streak, step_no,
                               t.straggler_threshold_s)
                self._event({"kind": "straggler_storm", "step": step_no,
                             "start_step": step_no - t.straggler_storm_n + 1,
                             "consecutive": self._straggler_streak,
                             "threshold": t.straggler_threshold_s})
        else:
            self._maybe_end_storm(step_no - 1)
            self._straggler_streak = 0

    def _maybe_end_storm(self, last_slow_step: int) -> None:
        """Close an open storm with one record carrying its true length
        (trainer.py:590)."""
        streak = self._straggler_streak
        if streak < self.tcfg.straggler_storm_n:
            return
        logger.warning("straggler storm cleared: %d consecutive slow steps (steps %d-%d)",
                       streak, last_slow_step - streak + 1, last_slow_step)
        self._event({"kind": "straggler_storm_end", "step": last_slow_step,
                     "start_step": last_slow_step - streak + 1, "consecutive": streak})

    def _wait_for_device(self) -> None:
        """The watchdog's per-step barrier: the card finishes the step
        (nothing is read back)."""
        if self.device.type == "cuda":
            # armed only with the watchdog, which times each step's walltime
            torch.cuda.synchronize(self.device)  # psl: sync-ok

    def train(self) -> dict:
        """Run up to epochs/max_steps, or until a stop is requested;
        returns the last window's metrics (plus the watchdog's counts when
        it saw a slow step). With ``resume`` the newest valid checkpoint
        is restored first; the data iterators then start again at epoch
        1, as the JAX trainer's do (each step's draws depend only on the
        seed and the step)."""
        t, n = self.tcfg, self.pcfg.num_workers
        # the stream's first record, before a resume can emit events
        self._event(run_header("train", run_id=self.run_id, geometry=self._geometry(),
                               pid=self.rank))
        if t.resume:
            self.try_resume()
        iters = []
        for w in batch_sharding(self.mesh):  # this process's workers
            imgs, labels, seed = shard_for_worker(
                self.dataset.train_images, self.dataset.train_labels, w, n,
                mode=t.shard_mode, seed=t.seed)
            iters.append(BatchIterator(imgs, labels, t.batch_size, seed=seed))
        total, steps_per_epoch = iters[0].num_samples, len(iters[0])
        metrics: dict = {}
        step_no = self.state.step
        first_step = step_no + 1
        armed = t.straggler_threshold_s is not None
        tr = self.tracer
        window_t0, window_steps, unsynced = time.perf_counter(), 0, 0
        done = False
        last_saved = None
        # the profiler window: profile_steps steps after the first (the
        # JAX trainer's auto start, trainer.py:783-801 there)
        pw = self.profile_window = ProfileWindow(
            t.profile_dir,
            start_step=t.profile_start if t.profile_start is not None else first_step + 1,
            num_steps=t.profile_steps, device=self.device)
        if t.profile_dir and (pw.start > t.max_steps or pw.stop <= first_step):
            # the window starts past max_steps, or (an explicit start on a
            # resumed run) ended before the resume point
            logger.info("profile-dir set but the capture window [%d, %d) misses this "
                        "run's steps [%d, %d] — no trace will be written",
                        pw.start, pw.stop, first_step, t.max_steps)
        try:
            for epoch in range(1, t.epochs + 1):
                if done:
                    break
                epoch_iters = [it.epoch() for it in iters]

                def host_batches(eis=epoch_iters):
                    for _ in range(steps_per_epoch):
                        parts = [next(ei) for ei in eis]
                        yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

                # two batches in flight to the card; each fetch gathers the
                # next one on the host and dispatches its copy (an h2d span
                # inside the fetch span)
                prefetched = prefetch_to_device(host_batches(), size=2, device=self.device,
                                                tracer=tr)
                for batch_idx in range(steps_per_epoch):
                    if step_no >= t.max_steps:
                        # checked BEFORE stepping: a resume of a finished
                        # run does nothing
                        done = True
                        break
                    pw.before_step(step_no + 1)
                    t0 = time.perf_counter()
                    with tr.span("fetch", step=step_no + 1):
                        batch = next(prefetched)
                    t1 = time.perf_counter()
                    with tr.span("dispatch", step=step_no + 1):
                        self.state, metrics = self._train_step(self.state, batch,
                                                               **self._step_extras())
                    if self.faults is not None:
                        # an injected stall inside the timed step, so the
                        # watchdog sees a real slow step
                        self.faults.maybe_sleep(step_no + 1)
                    if armed:
                        # the watchdog times the step's walltime: a host
                        # wait each step, only when it is armed
                        with tr.span("sync", step=step_no + 1):
                            self._wait_for_device()
                    t2 = time.perf_counter()
                    step_no += 1
                    if self.faults is not None:
                        # injected preemption at the step boundary: the
                        # installed handler raises the stop flag
                        self.faults.maybe_sigterm(step_no)
                    window_steps += 1
                    if self._adaptive is not None and step_no != first_step:
                        # the watchdog's walltime (its barrier is armed:
                        # the controller needs a threshold); the first
                        # step (cuDNN's search) is exempt
                        self._adaptive.record(step_no, t2 - t0)
                    if self._precision is not None:
                        # popped before any window read sees it: the
                        # controller's per-step read of a few floats, armed
                        # only with precision_adapt (the controller needs
                        # each step's bucket norms)
                        self._precision.record(
                            step_no,
                            metrics.pop("bucket_sqnorm").cpu().numpy())  # psl: sync-ok
                    unsynced += 1
                    if armed:
                        self._watchdog(step_no, t2 - t0, first_step)
                    if t.log_interval > 0 and (step_no % t.log_interval == 0 or step_no == 1):
                        # the once-per-window read: it waits for every step
                        # in flight, so the window's walltime is honest
                        with tr.span("sync", step=step_no):
                            metrics = {k: float(v) for k, v in metrics.items()}  # psl: sync-ok
                        unsynced = 0
                        step_time = (time.perf_counter() - window_t0) / max(window_steps, 1)
                        self.history.append({"step": step_no, "loss": metrics["loss"],
                                             "time_cost": step_time})
                        window_t0, window_steps = time.perf_counter(), 0
                        logger.info(format_iter_line(
                            rank="workers", step=step_no, epoch=epoch,
                            seen=batch_idx * t.batch_size * n, total=total * n,
                            loss=metrics["loss"], time_cost=step_time,
                            fetch=t1 - t0, forward=t2 - t1))
                        self._event({"kind": "train", "step": step_no, "epoch": epoch,
                                     "time_cost": round(step_time, 6), **metrics})
                        # after the window's train record, so an aborting
                        # window is still in the stream
                        with tr.span("guard", step=step_no):
                            self._guard_check(metrics, step_no)
                        # span I/O where the host already waited
                        tr.flush()
                    if unsynced >= 32:
                        # backpressure: bound the host's run-ahead and keep
                        # the guard's abort live when no window reads the
                        # metrics
                        with tr.span("sync", step=step_no):
                            metrics = {k: float(v) for k, v in metrics.items()}  # psl: sync-ok
                        with tr.span("guard", step=step_no):
                            self._guard_check(metrics, step_no)
                        unsynced = 0
                    # eval_freq 0: no periodic saves (the final one still
                    # writes; save_checkpoints=False suppresses every write)
                    if t.save_checkpoints and t.eval_freq > 0 and step_no % t.eval_freq == 0:
                        # the span covers the host half; the write is async
                        with tr.span("ckpt_save", step=step_no):
                            self._save(step_no)
                        last_saved = step_no
                    if step_no >= t.max_steps:
                        done = True
                        break
                    if self._stop_consensus():
                        logger.warning("graceful stop at step %d (resume with --resume)",
                                       step_no)
                        done = True
                        break
            if t.save_checkpoints and metrics and last_saved != step_no:
                with tr.span("ckpt_save", step=step_no):
                    self._save(step_no)
        finally:
            try:
                # a submitted checkpoint is durable (or its failure raised)
                # before the caller sees the outcome, even on error, and
                # before the profiler's close, whose synchronize re-raises
                # a device fault and whose trace write may fail
                self._ckpt.wait()
                tr.flush()
            finally:
                # a run that ends (or raises) inside the window writes its trace
                pw.close()
        out = {k: float(v) for k, v in metrics.items()}
        if out:
            # a skip in a trailing partial window still lands its event
            self._guard_check(out, step_no, abort=False)
            # a storm still open at the end gets its closing record too
            self._maybe_end_storm(step_no)
        if self.straggler_steps:
            out["straggler_steps"] = float(self.straggler_steps)
            out["straggler_storms"] = float(self.straggler_storms)
        if self._adaptive is not None:
            out["agg_count"] = float(self._adaptive.count)
            out["mask_adaptations"] = float(self._adaptive.adaptations)
        if self._precision is not None:
            out["precision_adaptations"] = float(self._precision.adaptations)
            out["effective_wire_bytes"] = float(self._precision.effective_bytes())
        return out

    def validate(self) -> dict:
        """One pass over the test split (parity: nn_ops.py:90-106), its
        batches through the training loop's prefetch."""
        n = self.pcfg.num_workers
        per = max(self.tcfg.test_batch_size // n, 1)
        it = BatchIterator(self.dataset.test_images, self.dataset.test_labels, per * n,
                           shuffle=False)
        ids = batch_sharding(self.mesh)  # this process's workers' rows of each batch
        rows = slice(ids[0] * per, (ids[-1] + 1) * per)
        mine = ({k: v[rows] for k, v in batch.items()} for batch in it)
        out = average_metrics(lambda batch: self._eval_step(self.state, batch),
                              prefetch_to_device(mine, size=2, device=self.device))
        if out:
            logger.info(format_eval_line(self.state.step, out["loss"], out["prec1"],
                                         out["prec5"]))
            self._event({"kind": "eval", "step": self.state.step, **out})
        return out
