"""The training loop: the host side around the PS train step (the port's
subset of trainer.py).

One host loop drives the N virtual workers of the stacked backend: each
worker keeps its own epoch-shuffled iterator over its shard (the
reference's per-worker DataLoaders), the global batch stacks the
workers' batches, and one call of the train step is one global step. The
loop reads the metrics only once per log window (the per-step host sync
the JAX trainer also avoids), logs the reference-format line, and runs
the host half of the non-finite guard there.

Not ported yet, and refused when asked for (ROADMAP.md): checkpoint
save/resume (the trainer writes no checkpoint and says so once), the
metrics JSONL, span tracing, the profiler window, the straggler
watchdog and the adaptive controllers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .data import BatchIterator, Dataset, make_preprocessor, prepare_data, shard_for_worker
from .models import build_model, param_count
from .optim import build_optimizer
from .parallel.mesh import make_mesh
from .parallel.ps import PSConfig, init_ps_state, make_ps_eval_step, make_ps_train_step
from .resilience.faults import resolve_fault_plan
from .utils import format_eval_line, format_iter_line, get_logger

logger = get_logger()

_ROADMAP = "is not ported yet (ROADMAP.md queue 1)"


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
            (self.resume, "resuming from a checkpoint (--resume)"),
            (self.compress_checkpoints, "compressed checkpoints"),
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
        # one record per log window: step, loss, time_cost (seconds per
        # step over the window, measured after the window's metrics read)
        self.history: List[dict] = []
        layout = getattr(self.state.params, "layout", None)
        n_params = layout.total if layout is not None else param_count(self.state.params)
        logger.info("model %s (%d params), dataset %s%s, %d workers on %s",
                    tcfg.network, n_params, self.dataset.name,
                    " [synthetic]" if self.dataset.synthetic else "",
                    pcfg.num_workers, self.device)
        if tcfg.save_checkpoints:
            logger.info("checkpoints are not ported yet: this run writes none "
                        "(ROADMAP.md queue 1 item 9)")

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
        """Run up to epochs/max_steps; returns the last window's metrics."""
        t, n = self.tcfg, self.pcfg.num_workers
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
        for epoch in range(1, t.epochs + 1):
            if done:
                break
            epoch_iters = [it.epoch() for it in iters]
            for batch_idx in range(steps_per_epoch):
                if step_no >= t.max_steps:
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
                    # backpressure: bound the host's run-ahead and keep the
                    # guard's abort live when no window reads the metrics
                    metrics = {k: float(v) for k, v in metrics.items()}
                    self._guard_check(metrics, step_no)
                    unsynced = 0
                if step_no >= t.max_steps:
                    done = True
                    break
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
        sums, count = {}, 0
        for batch in it:
            for k, v in self._eval_step(self.state, batch).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        out = {k: v / max(count, 1) for k, v in sums.items()}
        if out:
            logger.info(format_eval_line(self.state.step, out["loss"], out["prec1"],
                                         out["prec5"]))
        return out
