"""Learning-rate sweep (the port of cli/tune.py): a grid of learning rates,
each a short training run in this process, scored as the reference's
tiny_tuning_parser scores its logs: every run's iteration log lines are
captured and parsed (``utils.parse_iter_line``) and a candidate's score
is the mean loss over its final ``--score-window`` logged steps.

  python -m ps_pytorch_tpu_torch.cli.tune --network LeNet --dataset MNIST \\
      --num-workers 8 --batch-size 64 --max-steps 20 --lr-grid 0.1 0.01

``--workload lm`` sweeps ``cli.train_lm`` instead (``--lm-*`` sizes;
``--lm-attention-impl flash`` puts its attention on the K4-K6 kernels).
The flags are JAX's plus ``--device`` (the card unless ``--device
cpu``). Prints a ranking and returns ``{lr: score}``.
"""

from __future__ import annotations

import argparse
import logging
import math

from ..data import prepare_data
from ..trainer import Trainer
from ..utils import get_logger, parse_iter_line
from ._flags import add_ps_flags, add_train_flags, ps_config_from, train_config_from

logger = get_logger()

DEFAULT_GRID = (0.1, 0.05, 0.02, 0.01, 0.005, 0.002, 0.001)  # tune.sh's 7 learning rates


class _LineCapture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def score_lines(lines, window: int) -> float:
    """Mean loss over the last ``window`` parsed iteration lines. A run
    that ever logged a non-finite loss scores inf: a diverged learning
    rate must not win on its pre-divergence prefix."""
    losses = [d["loss"] for d in map(parse_iter_line, lines) if d]
    if not losses or any(not math.isfinite(x) for x in losses):
        return float("inf")
    return sum(losses[-window:]) / len(losses[-window:])


def _sweep(run_one, lr_grid, window) -> dict:
    """The grid loop: capture each run's iteration lines, score them,
    log the ranking."""
    results = {}
    for lr in lr_grid:
        capture = _LineCapture()
        logger.addHandler(capture)
        try:
            run_one(lr)
        finally:
            logger.removeHandler(capture)
        results[lr] = score_lines(capture.lines, window)
        logger.info("lr %g -> mean loss %.4f", lr, results[lr])
    ranking = sorted(results.items(), key=lambda kv: kv[1])
    logger.info("best lr: %g (mean loss %.4f)", *ranking[0])
    return results


def tune_lm(args) -> dict:
    """The sweep over ``cli.train_lm`` (any ``--lm-parallelism``): each
    grid point a fresh short run, the shared training flags forwarded."""
    from .train_lm import main as lm_main

    def run_one(lr):
        lm_main([
            "--device", args.device,
            "--parallelism", args.lm_parallelism,
            "--seq-len", str(args.lm_seq_len),
            "--dim", str(args.lm_dim),
            "--depth", str(args.lm_depth),
            "--heads", str(args.lm_heads),
            "--vocab-size", str(args.lm_vocab_size),
            "--attention-impl", args.lm_attention_impl,
            "--max-steps", str(args.max_steps),
            "--batch-size", str(args.batch_size),
            "--log-interval", "1",
            "--lr", str(lr),
            "--seed", str(args.seed),
            "--optimizer", args.optimizer,
            "--momentum", str(args.momentum),
            "--weight-decay", str(args.weight_decay),
            "--dtype", args.dtype,
        ])

    return _sweep(run_one, args.lr_grid, args.score_window)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("ps_pytorch_tpu_torch.cli.tune")
    add_train_flags(parser)
    add_ps_flags(parser)
    parser.add_argument("--lr-grid", type=float, nargs="+", default=list(DEFAULT_GRID))
    parser.add_argument("--score-window", type=int, default=10,
                        help="average the loss over the final N logged steps")
    parser.add_argument("--workload", default="ps", choices=["ps", "lm"],
                        help="ps: the CNN PS trainer; lm: the cli.train_lm sweep")
    parser.add_argument("--lm-parallelism", default="dp_sp")
    parser.add_argument("--lm-seq-len", type=int, default=128)
    parser.add_argument("--lm-dim", type=int, default=128)
    parser.add_argument("--lm-depth", type=int, default=2)
    parser.add_argument("--lm-heads", type=int, default=4)
    parser.add_argument("--lm-vocab-size", type=int, default=64)
    parser.add_argument("--lm-attention-impl", default="naive", choices=["naive", "flash"],
                        help="the LM runs' within-device attention (flash = K4-K6)")
    args = parser.parse_args(argv)

    # the kernel library, built before the first run (a no-op on the CPU)
    from ..utils.compile_cache import enable_persistent_compile_cache

    enable_persistent_compile_cache(args.device)

    if args.workload == "lm":
        return tune_lm(args)

    num_workers = args.num_workers or 1
    base = train_config_from(args)
    dataset = prepare_data(base.dataset, root=base.data_root,
                           allow_synthetic=base.allow_synthetic)  # loaded once for every run

    def run_one(lr):
        tcfg = train_config_from(args)
        tcfg.lr = lr
        tcfg.log_interval = 1  # score every step
        tcfg.save_checkpoints = False
        tcfg.resume = False  # every candidate starts from scratch
        Trainer(tcfg, ps_config_from(args, num_workers), dataset=dataset,
                device=args.device).train()

    return _sweep(run_one, args.lr_grid, args.score_window)


if __name__ == "__main__":
    main()
