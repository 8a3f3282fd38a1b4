"""The training loop: the host side around the PS train step (the port's
subset of trainer.py).

One host loop drives the N virtual workers of the stacked backend: each
worker keeps its own epoch-shuffled iterator over its shard (the
reference's per-worker DataLoaders), the global batch stacks the
workers' batches, and one call of the train step is one global step. The
loop reads the metrics only once per log window (the per-step host sync
the JAX trainer also avoids), logs the reference-format line, and runs
the host half of the non-finite guard there.

Checkpoints (checkpoint.py): ``model_step_N`` every ``eval_freq`` steps
and once at the end, written by one background thread from a host copy
taken at the step boundary, with an ``elastic.json`` geometry manifest;
``--resume`` restores the newest valid one, quarantining a damaged file
and falling back to the next older. The files are the JAX trainer's,
byte for byte, so either package resumes the other's directory.

Not ported yet, and refused when asked for (ROADMAP.md): compressed
checkpoints, a resume onto another mesh geometry, the metrics JSONL,
span tracing, the profiler window, the straggler watchdog and the
adaptive controllers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from . import DeviceLike, resolve_device
from . import checkpoint as ckpt
from .data import BatchIterator, Dataset, make_preprocessor, prepare_data, shard_for_worker
from .models import build_model, param_count
from .optim import build_optimizer
from .parallel.buckets import FlatVector
from .parallel.mesh import make_mesh
from .parallel.ps import (
    PSConfig,
    PSTrainState,
    init_ps_state,
    make_ps_eval_step,
    make_ps_train_step,
)
from .resilience import elastic
from .resilience.faults import resolve_fault_plan
from .utils import format_eval_line, format_iter_line, get_logger

logger = get_logger()

_ROADMAP = "is not ported yet (ROADMAP.md queue 1)"


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

    def refuse_unported(self) -> None:
        refused = [
            (self.compress_checkpoints,
             "compressed checkpoints (--compress-checkpoints, the PSCK codec; item 22)"),
            (self.metrics_file is not None, "the metrics JSONL (--metrics-file)"),
            (self.trace_dir is not None, "span tracing (--trace)"),
            (self.profile_dir is not None, "the profiler window (--profile-dir)"),
            (self.straggler_threshold_s is not None,
             "the straggler watchdog (--mode / --kill-threshold)"),
            (self.dtype != "float32", "bf16 compute (--dtype bfloat16)"),
            (self.remat, "remat (--remat)"),
        ]
        for hit, what in refused:
            if hit:
                raise NotImplementedError(f"{what} {_ROADMAP}")


class Trainer:
    """Drives PS data-parallel training of one model on N virtual
    workers of one device (default ``cuda``)."""

    def __init__(self, tcfg: TrainConfig, pcfg: PSConfig,
                 dataset: Optional[Dataset] = None, device: DeviceLike = None):
        tcfg.refuse_unported()
        self.tcfg, self.pcfg = tcfg, pcfg
        self.device = resolve_device(device)
        self.faults = resolve_fault_plan(tcfg.fault_plan)
        if self.faults is not None:
            logger.warning("fault injection ACTIVE: %s", self.faults)
        self.dataset = dataset or prepare_data(tcfg.dataset, root=tcfg.data_root,
                                               allow_synthetic=tcfg.allow_synthetic)
        self.mesh = make_mesh(pcfg.num_workers)
        self.model = build_model(tcfg.network, num_classes=self.dataset.num_classes)
        self.tx = build_optimizer(tcfg.optimizer, tcfg.lr, momentum=tcfg.momentum,
                                  weight_decay=tcfg.weight_decay)
        self.state = init_ps_state(self.model, self.tx, pcfg,
                                   torch.Generator().manual_seed(tcfg.seed),
                                   device=self.device)
        self._train_step = make_ps_train_step(
            self.model, self.tx, pcfg, self.mesh,
            preprocess=make_preprocessor(tcfg.dataset, train=True),
            faults=self.faults, seed=tcfg.seed + 1, device=self.device)
        self._eval_step = make_ps_eval_step(
            self.model, pcfg, self.mesh,
            preprocess=make_preprocessor(tcfg.dataset, train=False), device=self.device)
        self._skipped_seen = 0
        self._ckpt = ckpt.AsyncCheckpointer(faults=self.faults)
        # one record per log window: step, loss, time_cost (seconds per
        # step over the window, measured after the window's metrics read)
        self.history: List[dict] = []
        layout = getattr(self.state.params, "layout", None)
        n_params = layout.total if layout is not None else param_count(self.state.params)
        logger.info("model %s (%d params), dataset %s%s, %d workers on %s",
                    tcfg.network, n_params, self.dataset.name,
                    " [synthetic]" if self.dataset.synthetic else "",
                    pcfg.num_workers, self.device)

    # ------------------------------------------------------------- checkpoints
    def checkpoint_state(self) -> PSTrainState:
        """The live state as a checkpoint holds it: the JAX PSTrainState
        leaf for leaf. ``step`` is a 0-d int32 array; under the flat
        layout the replicated momenta carry the params' geometry (a
        FlatVector, tree-shaped on disk) where the port keeps the bare
        vector; under ZeRO-1 the optimizer's ``count`` has one entry per
        worker, where the port keeps one scalar."""
        st = dataclasses.replace(self.state, step=np.asarray(self.state.step, np.int32))
        opt = st.opt_state
        if isinstance(st.params, FlatVector) and isinstance(opt.momentum_buffer, torch.Tensor) \
                and self.pcfg.opt_placement != "sharded":
            opt = dataclasses.replace(
                opt, momentum_buffer=dataclasses.replace(st.params, flat=opt.momentum_buffer))
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
        if isinstance(opt.momentum_buffer, FlatVector):
            opt = dataclasses.replace(opt, momentum_buffer=opt.momentum_buffer.flat)
        return dataclasses.replace(view, step=int(np.asarray(view.step)), opt_state=opt)

    def _save(self, step_no: int) -> None:
        """Record this run's geometry for the step (trainer.py:646), then
        copy the state to the host and hand it to the writer thread."""
        elastic.save_geometry(self.tcfg.train_dir, elastic.geometry_of(self.pcfg),
                              step=step_no)
        self._ckpt.save(self.checkpoint_state(), self.tcfg.train_dir, step_no)

    def try_resume(self) -> Optional[int]:
        """Restore the newest VALID checkpoint of train_dir, if any
        (trainer.py:377). A damaged file is quarantined (renamed
        ``*.corrupt``) and the next older one tried; an unreadable one is
        skipped and left in place. Structure mismatches (e.g. EF residuals
        for a run with EF off) raise: they are configuration errors."""
        for step in reversed(ckpt.available_steps(self.tcfg.train_dir)):
            try:
                restored = self._restore_step(step)
            except ckpt.CheckpointCorruptError as e:
                logger.warning("resume: checkpoint step %d is corrupt (%s); quarantining "
                               "and falling back", step, e)
                ckpt.quarantine_checkpoint(self.tcfg.train_dir, step)
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
        """Checkpoint ``step`` into the live state's structure. A file the
        manifest says another geometry wrote needs the resume-reshape,
        which is refused (ROADMAP.md queue 1 item 15)."""
        raw = ckpt.load_checkpoint_raw(self.tcfg.train_dir, step)
        src = elastic.load_geometry(self.tcfg.train_dir, step=step)
        dst = elastic.geometry_of(self.pcfg)
        if src is not None and elastic.needs_reshape(src, dst):
            raise NotImplementedError(
                f"checkpoint step {step} was written on {src.num_workers} workers "
                f"({src.opt_placement} placement, bucket_bytes {src.bucket_bytes}, bn_mode "
                f"{src.bn_mode}); resuming it on {dst.num_workers} workers "
                f"({dst.opt_placement}, {dst.bucket_bytes}, {dst.bn_mode}) needs the "
                f"resume-reshape (ROADMAP.md queue 1 item 15), which is not ported yet")
        try:
            restored = self._live_state(
                ckpt.restore_from_raw(self.checkpoint_state(), raw, step), step)
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
        log new skips, abort past ``max_consecutive_skips``."""
        if "skipped_steps" not in m:
            return
        skipped, streak = int(m["skipped_steps"]), int(m["skip_streak"])
        if skipped > self._skipped_seen:
            logger.warning("non-finite gradients: %d step(s) skipped so far "
                           "(current streak %d) — params were NOT updated on those",
                           skipped, streak)
            self._skipped_seen = skipped
        k = self.tcfg.max_consecutive_skips
        if abort and k > 0 and streak >= k:
            raise RuntimeError(
                f"aborting at step {step_no}: {streak} consecutive steps had "
                f"non-finite gradients (threshold {k}); params are stuck at step "
                f"{step_no - streak}")

    def train(self) -> dict:
        """Run up to epochs/max_steps; returns the last window's metrics.
        With ``resume`` the newest valid checkpoint is restored first; the
        data iterators then start again at epoch 1, as the JAX trainer's
        do (each step's draws depend only on the seed and the step)."""
        t, n = self.tcfg, self.pcfg.num_workers
        if t.resume:
            self.try_resume()
        iters = []
        for w in range(n):
            imgs, labels, seed = shard_for_worker(
                self.dataset.train_images, self.dataset.train_labels, w, n,
                mode=t.shard_mode, seed=t.seed)
            iters.append(BatchIterator(imgs, labels, t.batch_size, seed=seed))
        total, steps_per_epoch = iters[0].num_samples, len(iters[0])
        metrics: dict = {}
        step_no = self.state.step
        window_t0, window_steps, unsynced = time.perf_counter(), 0, 0
        done = False
        last_saved = None
        try:
            for epoch in range(1, t.epochs + 1):
                if done:
                    break
                epoch_iters = [it.epoch() for it in iters]
                for batch_idx in range(steps_per_epoch):
                    if step_no >= t.max_steps:
                        # checked BEFORE stepping: a resume of a finished
                        # run does nothing
                        done = True
                        break
                    t0 = time.perf_counter()
                    parts = [next(ei) for ei in epoch_iters]
                    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
                    t1 = time.perf_counter()
                    self.state, metrics = self._train_step(self.state, batch)
                    t2 = time.perf_counter()
                    step_no += 1
                    window_steps += 1
                    unsynced += 1
                    if t.log_interval > 0 and (step_no % t.log_interval == 0 or step_no == 1):
                        # the once-per-window read: it waits for every step
                        # in flight, so the window's walltime is honest
                        metrics = {k: float(v) for k, v in metrics.items()}
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
                        self._guard_check(metrics, step_no)
                    if unsynced >= 32:
                        # backpressure: bound the host's run-ahead and keep
                        # the guard's abort live when no window reads the
                        # metrics
                        metrics = {k: float(v) for k, v in metrics.items()}
                        self._guard_check(metrics, step_no)
                        unsynced = 0
                    # eval_freq 0: no periodic saves (the final one still
                    # writes; save_checkpoints=False suppresses every write)
                    if t.save_checkpoints and t.eval_freq > 0 and step_no % t.eval_freq == 0:
                        self._save(step_no)
                        last_saved = step_no
                    if step_no >= t.max_steps:
                        done = True
                        break
            if t.save_checkpoints and metrics and last_saved != step_no:
                self._save(step_no)
        finally:
            # a submitted checkpoint is durable (or its failure raised)
            # before the caller sees the outcome, even on error
            self._ckpt.wait()
        out = {k: float(v) for k, v in metrics.items()}
        if out:
            self._guard_check(out, step_no, abort=False)
        return out

    def validate(self) -> dict:
        """One pass over the test split (parity: nn_ops.py:90-106)."""
        n = self.pcfg.num_workers
        bs = max(self.tcfg.test_batch_size // n, 1) * n
        it = BatchIterator(self.dataset.test_images, self.dataset.test_labels, bs,
                           shuffle=False)
        out = average_metrics(lambda batch: self._eval_step(self.state, batch), it)
        if out:
            logger.info(format_eval_line(self.state.step, out["loss"], out["prec1"],
                                         out["prec5"]))
        return out
