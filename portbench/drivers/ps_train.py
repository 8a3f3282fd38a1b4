"""Driver of the parameter-server training cells: the port's ``Trainer``,
built from ``cli.train``'s own flags, driven through ``Trainer.train()``.

Set-up builds one ``Trainer`` from the configuration's and the traffic
mix's flags, hands it a CIFAR-shaped dataset and weights made on the
card from the seed, and runs the first ``checked_steps`` steps through
one ``train()`` call: the window's own call and feed. Those steps are
the ones the reference follows: their losses, the first gradient as the
optimizer got it (from its state after one step), the BatchNorm running
statistics after it and the parameters after the last are kept. The same ``Trainer`` then runs the window: one
``train()`` call ended by ``request_stop()`` once the window's time is
up (the final checkpoint it then writes falls outside the window). A
wrapper around the step callable the ``Trainer`` holds records a CUDA
event after each dispatched step.

A traffic mix's ``host_threads`` sets the process's CPU threads before
any of that.

A traced run gives the ``Trainer`` an in-memory ``Tracer`` (its own
``fetch`` / ``dispatch`` / ``sync`` / ``ckpt_save`` spans) and, once the
window's time is up, captures ``trace_steps`` more steps with the
profiler before it stops the run.
"""

from __future__ import annotations

import dataclasses
import gc
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch

from portbench.harness import compare, weights
from portbench.harness.capture import Capture
from portbench.harness.clock import StepClock
from portbench.harness.result import Measured, program_seed
from portbench.harness.spec import PORTBENCH, load_module, reference_module

from ps_pytorch_tpu_torch.cli import train as cli_train
from ps_pytorch_tpu_torch.cli._flags import ps_config_from, train_config_from
from ps_pytorch_tpu_torch.data import Dataset
from ps_pytorch_tpu_torch.obs import Tracer
from ps_pytorch_tpu_torch.parallel.buckets import FlatVector, tree_view
from ps_pytorch_tpu_torch.parallel.ps import init_ps_state
from ps_pytorch_tpu_torch.trainer import Trainer

REFERENCE = f"{PORTBENCH}/drivers/ps_reference.py"


class _Hook:
    """Stands in for the step callable the Trainer holds: ``before()``
    and ``after(old, new, metrics)`` around each call."""

    def __init__(self, step: Callable):
        self.step = step
        self.before: Optional[Callable] = None
        self.after: Optional[Callable] = None

    def __call__(self, state, batch, **kw):
        if self.before is not None:
            self.before()
        new, metrics = self.step(state, batch, **kw)
        if self.after is not None:
            self.after(state, new, metrics)
        return new, metrics


def make_dataset(config: dict, seed: int, device: torch.device) -> Dataset:
    """``images`` CIFAR-shaped uint8 NHWC images, each its class's
    template plus noise (sd 32), drawn on the card in three calls."""
    data = config["dataset"]
    h, w, c = config["image_shape"]
    n, k = data["images"], config["num_classes"]
    g = weights.generator(seed, weights.DATA_STREAM, device)
    templates = torch.randint(0, 256, (k, h, w, c), generator=g, device=device).float()
    labels = torch.randint(0, k, (n,), generator=g, device=device)
    noise = torch.randn((n, h, w, c), generator=g, device=device)
    images = (templates[labels] + 32.0 * noise).clamp_(0, 255).to(torch.uint8)
    del noise
    x, y = images.cpu().numpy(), labels.to(torch.int32).cpu().numpy()
    return Dataset(data["name"], x, y, x[:16].copy(), y[:16].copy(), synthetic=True)


def _leaves(tree) -> dict:
    return {k: v.detach().clone() for k, v in weights.flatten(tree_view(tree)).items()}


class Driver:
    def __init__(self, cell, seed: int, device: str = "cuda", wrap_step: Callable = None):
        self.cell, self.seed = cell, int(seed)
        self.dev = torch.device(device)
        self.wrap_step = wrap_step
        self.config, self.traffic = cell.config, cell.traffic
        self.ref_model = reference_module(cell)
        self._ref_f32 = None

    # ------------------------------------------------------------ set-up
    def _flags(self, train_dir: str) -> list:
        return (list(self.config["port_flags"]) + list(self.traffic["flags"])
                + ["--seed", str(program_seed(self.seed)), "--train-dir", train_dir,
                   "--device", self.dev.type])

    def initial(self):
        """The weights and statistics the run starts from, made anew from
        the seed (the same values every time)."""
        return (weights.make_leaves(self.ref_model.leaf_specs(self.config), self.seed, self.dev),
                weights.make_leaves(self.ref_model.stat_specs(self.config), self.seed, self.dev))

    def setup(self) -> None:
        if "host_threads" in self.traffic:
            # the host's own parallel copies (the fetch's pinned staging)
            # on this many threads: fewer threads to contend for the cores
            torch.set_num_threads(int(self.traffic["host_threads"]))
        self.train_dir = tempfile.mkdtemp(prefix="portbench_ckpt_")
        args = cli_train.build_parser().parse_args(self._flags(self.train_dir))
        tcfg = train_config_from(args)
        self.pcfg = ps_config_from(args, args.num_workers)
        self.dataset = make_dataset(self.config, self.seed, self.dev)
        tr = Trainer(tcfg, self.pcfg, dataset=self.dataset, device=self.dev)
        params, stats = self.initial()
        tr.state = init_ps_state(tr.model, tr.tx, self.pcfg, device=self.dev,
                                 params=weights.nest(params), batch_stats=weights.nest(stats),
                                 mesh=tr.mesh)
        del params, stats
        self.hook = _Hook(tr._train_step if self.wrap_step is None
                          else self.wrap_step(tr._train_step))
        tr._train_step = self.hook
        self.trainer = tr

        checked = int(self.traffic["checked_steps"])
        losses, snaps = [], {}

        def after(old, new, metrics):
            losses.append(metrics["loss"].detach().clone())
            if len(losses) == 1:
                snaps["grad"] = self._first_grad(old, new)
                snaps["stats"] = _leaves(new.batch_stats)
            if len(losses) == checked:
                snaps["params"] = _leaves(new.params)
                snaps["skipped"] = metrics.get("skipped_steps")

        self.hook.after = after
        tcfg.max_steps = checked
        tr.train()
        self.hook.after = None
        self.checked = {"losses": [float(x) for x in losses], "grad": snaps["grad"],
                        "params": snaps["params"], "stats": snaps["stats"]}
        self.skipped_before = (float(snaps["skipped"]) if snaps["skipped"] is not None else 0.0)

    def _first_grad(self, old, new) -> dict:
        """The gradient the optimizer got in the first step, from its
        state after it: SGD's first momentum buffer is the gradient (no
        dampening at the first step), Adam's first moment is (1 - b1)
        times it; weight decay added inside is taken out again."""
        tx, opt = self.trainer.tx, new.opt_state
        if hasattr(opt, "momentum_buffer"):
            moment, scale = opt.momentum_buffer, 1.0
        else:
            moment, scale = opt.exp_avg, 1.0 / (1.0 - tx.b1)
        if isinstance(old.params, FlatVector):
            moment = dataclasses.replace(old.params, flat=moment)
        g = _leaves(moment)
        before = _leaves(old.params)
        return {k: v.double() * scale - tx.weight_decay * before[k].double() for k, v in g.items()}

    # ------------------------------------------------------------ window
    def measure(self, seconds: float, trace: bool) -> Measured:
        tr, hook = self.trainer, self.hook
        clock = StepClock(self.dev)
        cap = Capture(self.dev) if trace else None
        k_trace = int(self.traffic["trace_steps"])
        if trace:
            tr.tracer = Tracer("train", path=None)
        st = {"closed": False, "captured": 0, "last_step": None, "metrics": None,
              "peak": 0, "deadline": None}

        def before():
            if st["deadline"] is None:
                clock.start()
                st["deadline"] = clock.t0 + seconds

        def after(old, new, metrics):
            if st["closed"]:
                st["captured"] += 1
                if st["captured"] == k_trace:
                    cap.stop(k_trace)
                    tr.request_stop()
                return
            clock.stepped()
            st["metrics"] = metrics
            if time.perf_counter() >= st["deadline"]:
                st["closed"], st["last_step"] = True, new.step
                if self.dev.type == "cuda":
                    st["peak"] = torch.cuda.max_memory_allocated(self.dev)
                if cap is not None:
                    cap.start()
                else:
                    tr.request_stop()

        hook.before, hook.after = before, after
        tr.tcfg.max_steps = 10 ** 9
        tr.tcfg.epochs = 10 ** 6
        tr.train()
        hook.before = hook.after = None
        window = clock.finish(seconds)
        skipped = st["metrics"].get("skipped_steps")
        failed = int(round(float(skipped) - self.skipped_before)) if skipped is not None else 0
        # the last window step's span also holds the capture's start
        spans = ([s for s in tr.tracer.drain() if s.get("step", 0) < st["last_step"]]
                 if trace else [])
        images = self.pcfg.num_workers * tr.tcfg.batch_size
        work = {"images_per_step": images, "workers": self.pcfg.num_workers,
                "params": int(self.config["params"]), "leaves": int(self.config["param_leaves"]),
                "tf32_convs": bool(torch.backends.cudnn.allow_tf32),
                "steps_per_s": window.completed / window.window_s}
        e2e = {"train_images_per_s": window.completed * images / window.window_s,
               "step_ms_p90": window.step_ms_p90()}
        return Measured(window=window, t_window=clock.t0, attempted=clock.dispatched,
                        failed=failed, peak_window_bytes=st["peak"], spans=spans,
                        trace=cap.trace if cap is not None else None, work=work,
                        end_to_end=e2e)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.trainer._ckpt.wait()
        self.trainer = self.hook = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.train_dir, ignore_errors=True)

    # ------------------------------------------------------------ correct
    def _proto(self) -> dict:
        t = self.pcfg
        args = cli_train.build_parser().parse_args(self._flags("unused"))
        return {"workers": t.num_workers, "batch": args.batch_size,
                "aggregate": t.effective_aggregate, "seed": program_seed(self.seed),
                "draw_seed": program_seed(self.seed) + 1, "shuffle_stride": 1009,
                "lr": args.lr, "momentum": args.momentum, "weight_decay": args.weight_decay}

    def reference(self, precision: str = "f32", fault: Optional[str] = None) -> dict:
        """The reference's summary over the checked steps."""
        ref = load_module(REFERENCE, "portbench_ps_reference")
        params, stats = self.initial()
        inputs = {"params": params, "stats": stats, "images": self.dataset.train_images,
                  "labels": self.dataset.train_labels}
        with compare.f32_products():
            out = ref.follow(self.ref_model, self.config, inputs, self._proto(),
                             int(self.traffic["checked_steps"]), precision, fault)
        return compare.summary(out["grad"], params, out["params"], out["losses"], stats,
                               out["stats"])

    def program(self) -> dict:
        params, stats = self.initial()
        c = self.checked
        return compare.summary(c["grad"], params, c["params"], c["losses"], stats, c["stats"])

    def check(self) -> dict:
        if self._ref_f32 is None:
            self._ref_f32 = self.reference()
        return compare.readings(self.program(), self._ref_f32)

    def check_against(self, precision: str = "f32", fault: Optional[str] = None) -> dict:
        """A reference variant in the program's place (the control, a
        planted fault), held against the plain reference."""
        if self._ref_f32 is None:
            self._ref_f32 = self.reference()
        return compare.readings(self.reference(precision, fault), self._ref_f32)
