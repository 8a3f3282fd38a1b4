"""Driver of the LM training cells: the step ``cli.train_lm.build_scheme``
returns for the traffic mix's ``--parallelism``, driven as the CLI's loop
drives it.

Set-up parses the configuration's and the traffic mix's flags with
``cli.train_lm``'s own parser, builds the model config and optimizer as
its ``main`` does (``max_seq_len`` is the configuration's context, the
sequence length the traffic's), takes the step from ``build_scheme``,
and replaces the weights it drew with weights made on the card from the
seed. The token batches are Markov walks made on the card from the seed
(``pool_steps`` batches, each step the next, all rows distinct within
the pool). Every step keeps the CLI's host discipline: a host read of
the params before and after each ``--log-interval``-th step and the
first, the loss read there (``cli/train_lm.py``).

The first ``checked_steps`` steps are the ones the reference follows:
their losses, the first gradient as the optimizer got it (from its state
after one step) and the parameters after the last are kept on the host.
The window follows on the same objects; a traced run then captures
``trace_steps`` more steps with the profiler.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, List, Optional

import torch

from portbench.harness import compare, weights
from portbench.harness.capture import Capture
from portbench.harness.clock import StepClock
from portbench.harness.result import Measured, program_seed
from portbench.harness.spec import PORTBENCH, load_module, reference_module

from ps_pytorch_tpu_torch.cli import train_lm as cli_lm
from ps_pytorch_tpu_torch.models.transformer import TransformerConfig
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.utils import host_sync

REFERENCE = f"{PORTBENCH}/drivers/lm_reference.py"


def make_tokens(vocab: int, n_seq: int, seq_len: int, seed: int, device: torch.device,
                branching: int = 4) -> torch.Tensor:
    """int32 ``[n_seq, seq_len]`` walks of a fixed sparse Markov chain
    (each token goes to one of ``branching`` fixed successors, as
    ``cli.train_lm``'s corpus does), drawn on the card."""
    g = weights.generator(seed, weights.DATA_STREAM, device)
    succ = torch.randint(0, vocab, (vocab, branching), generator=g, device=device)
    picks = torch.randint(0, branching, (n_seq, seq_len), generator=g, device=device)
    toks = torch.empty((n_seq, seq_len), dtype=torch.int64, device=device)
    toks[:, 0] = torch.randint(0, vocab, (n_seq,), generator=g, device=device)
    for t in range(1, seq_len):
        toks[:, t] = succ[toks[:, t - 1], picks[:, t]]
    return toks.to(torch.int32)


class Driver:
    def __init__(self, cell, seed: int, device: str = "cuda", wrap_step: Callable = None):
        self.cell, self.seed = cell, int(seed)
        self.dev = torch.device(device)
        self.wrap_step = wrap_step
        self.config, self.traffic = cell.config, cell.traffic
        self.ref_model = reference_module(cell)
        self.args = cli_lm.build_parser().parse_args(
            list(self.config["port_flags"]) + list(self.traffic["flags"])
            + ["--seed", str(program_seed(seed)), "--device", self.dev.type])
        self._ref_f32 = None
        self.spans: List[tuple] = []

    def initial(self) -> dict:
        return weights.make_leaves(self.ref_model.leaf_specs(self.config), self.seed, self.dev)

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        a = self.args
        cli_lm.check_flags(a)
        self.cfg = TransformerConfig(
            vocab_size=a.vocab_size, dim=a.dim, depth=a.depth, heads=a.heads,
            max_seq_len=int(self.config["n_ctx"]), remat=a.remat,
            bidirectional_ring=a.bidirectional_ring, sp_attention=a.sp_attention,
            attention_impl=a.attention_impl,
            compute_dtype=torch.bfloat16 if a.dtype == "bfloat16" else None)
        self.tx = build_optimizer(
            a.optimizer, cli_lm.lr_schedule(a.lr_schedule, a.lr, a.warmup_steps, a.max_steps),
            momentum=a.momentum, weight_decay=a.weight_decay)
        _, _, run, _, _ = cli_lm.build_scheme(a, self.cfg, self.tx, self.dev)
        self.run = run if self.wrap_step is None else self.wrap_step(run)
        gc.collect()
        self.params = weights.nest(self.initial())
        self.opt = self.tx.init(self.params)
        pool = int(self.traffic["pool_steps"])
        self.tokens = make_tokens(a.vocab_size, pool * a.batch_size, a.seq_len, self.seed,
                                  self.dev)
        self.step_no = 0

        checked = int(self.traffic["checked_steps"])
        losses, grad = [], None
        for _ in range(checked):
            losses.append(self._step())
            if grad is None:
                grad = self._first_grad()
        self.checked = {"losses": [float(x) for x in losses], "grad": grad,
                        "params": {k: v.detach().float().cpu()
                                   for k, v in weights.flatten(self.params).items()}}

    def _batch(self, i: int) -> torch.Tensor:
        b = self.args.batch_size
        lo = ((i - 1) % int(self.traffic["pool_steps"])) * b
        return self.tokens[lo:lo + b]

    def _step(self):
        """One step as ``cli.train_lm``'s loop takes it."""
        self.step_no += 1
        i = self.step_no
        log_now = i % self.args.log_interval == 0 or i == 1
        if log_now:
            host_sync(self.params)
        tok = self._batch(i)
        t0 = time.perf_counter()
        self.params, self.opt, loss, _ = self.run(self.params, self.opt, tok)
        self.spans.append((i, time.perf_counter() - t0))
        if log_now:
            float(loss)
            host_sync(self.params)
        return loss

    def _first_grad(self) -> dict:
        """The first gradient from the optimizer's state after one step:
        Adam's first moment is (1 - b1) times it, SGD's momentum buffer
        the gradient itself; weight decay added inside is taken out."""
        opt, tx = self.opt, self.tx
        if hasattr(opt, "exp_avg"):
            moment, scale = opt.exp_avg, 1.0 / (1.0 - tx.b1)
        else:
            moment, scale = opt.momentum_buffer, 1.0
        before = self.initial()
        return {k: (v.double() * scale - tx.weight_decay * before[k].double()).float().cpu()
                for k, v in weights.flatten(moment).items()}

    # ------------------------------------------------------------ window
    def measure(self, seconds: float, trace: bool) -> Measured:
        clock = StepClock(self.dev)
        self.spans = []
        losses = []
        clock.start()
        deadline = clock.t0 + seconds
        first = self.step_no + 1
        while True:
            losses.append(self._step())
            clock.stepped()
            if time.perf_counter() >= deadline:
                break
        last = self.step_no
        peak = torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0
        cap = None
        if trace:
            k = int(self.traffic["trace_steps"])
            cap = Capture(self.dev)
            cap.start()
            for _ in range(k):
                self._step()
            cap.stop(k)
        window = clock.finish(seconds)
        failed = int((~torch.isfinite(torch.stack([x.float() for x in losses]))).sum())
        a = self.args
        tokens = a.batch_size * a.seq_len
        spans = [{"name": "dispatch", "step": i, "dur": d} for i, d in self.spans
                 if first <= i <= last]
        work = {"tokens_per_step": tokens, "batch": a.batch_size, "seq": a.seq_len,
                "heads": a.heads, "head_dim": a.dim // a.heads, "dim": a.dim, "depth": a.depth,
                "vocab": a.vocab_size, "mlp_ratio": self.cfg.mlp_ratio, "dtype": a.dtype,
                "steps_per_s": window.completed / window.window_s}
        e2e = {"train_tokens_per_s": window.completed * tokens / window.window_s,
               "step_ms_p90": window.step_ms_p90()}
        return Measured(window=window, t_window=clock.t0, attempted=clock.dispatched,
                        failed=failed, peak_window_bytes=peak, spans=spans,
                        trace=cap.trace if cap is not None else None, work=work,
                        end_to_end=e2e)

    def release(self) -> None:
        self.params = self.opt = self.run = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ correct
    def reference(self, precision: str = "f32", fault: Optional[str] = None) -> dict:
        ref = load_module(REFERENCE, "portbench_lm_reference")
        a, tx = self.args, self.tx
        params = self.initial()
        batches = [self._batch(i) for i in range(1, int(self.traffic["checked_steps"]) + 1)]
        adam = {"lr": a.lr, "b1": tx.b1, "b2": tx.b2, "eps": tx.eps,
                "weight_decay": tx.weight_decay}
        with compare.f32_products():
            out = ref.follow(self.ref_model, self.config, params, batches, adam,
                             precision, fault)
        return compare.summary(out["grad"], params, out["params"], out["losses"])

    def program(self) -> dict:
        params = self.initial()
        c = self.checked
        return compare.summary({k: v.to(self.dev) for k, v in c["grad"].items()}, params,
                               {k: v.to(self.dev) for k, v in c["params"].items()}, c["losses"])

    def check(self) -> dict:
        if self._ref_f32 is None:
            self._ref_f32 = self.reference()
        return compare.readings(self.program(), self._ref_f32)

    def check_against(self, precision: str = "f32", fault: Optional[str] = None) -> dict:
        if self._ref_f32 is None:
            self._ref_f32 = self.reference()
        return compare.readings(self.reference(precision, fault), self._ref_f32)

