"""PS training entry of the port (the counterpart of ps_pytorch_tpu.cli.train).

Canonical invocation (the reference's run_pytorch.sh semantics), on the
card, with 8 virtual workers stacked on it:

  python -m ps_pytorch_tpu_torch.cli.train --network ResNet18 \\
      --dataset Cifar10 --num-workers 8 --batch-size 128 --lr 0.1 \\
      --momentum 0.9 --num-aggregate 5 --compress-grad compress

``--device cpu`` runs the plain versions on the CPU (the tests do).
Without ``--device cpu`` and without a card it raises.

Over processes (the reference's MPI job): the same command once per
process with ``--coordinator-address HOST:PORT --num-processes P
--process-id i``; each process holds ``--num-workers / P`` of the
workers. NCCL on the card (one process per card), gloo with ``--device
cpu``.

Checkpoints: ``model_step_N`` in ``--train-dir`` every ``--eval-freq``
steps and after the last (``--no-checkpoints``: none), in the JAX
package's bytes; ``--resume`` continues from the newest valid one.
SIGTERM / SIGINT stop the run gracefully after the current step, with a
checkpoint written and validation skipped.

The event stream: ``--metrics-file F`` (one JSON record a line),
``--trace DIR`` (host spans, which ``python -m
ps_pytorch_tpu_torch.tools.trace_report DIR`` merges),
``--mode straggler --kill-threshold S`` (the straggler watchdog) with
``--straggler-storm-n K``, ``--profile-dir DIR`` (a ``torch.profiler``
capture of steps ``[--profile-start, + --profile-steps)``, Chrome trace
under DIR; obs/profiler.py).

``--config-json FILE`` applies a tuned knob set, as README's autotune
command does with the committed record:

  python -m ps_pytorch_tpu_torch.cli.train --network ResNet18 \\
      --dataset Cifar10 --num-workers 8 --batch-size 128 \\
      --config-json runs/autotune_resnet18.json
"""

from __future__ import annotations

import argparse
import sys

from ..parallel.mesh import initialize_multihost
from ..trainer import Trainer
from ..utils import get_logger
from ._flags import (
    add_ps_flags,
    add_train_flags,
    expand_config_json,
    ps_config_from,
    train_config_from,
)

logger = get_logger()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("ps_pytorch_tpu_torch.cli.train")
    add_train_flags(parser)
    add_ps_flags(parser)
    parser.add_argument(
        "--config-json", metavar="FILE",
        help="apply a tuned knob set from an autotune evidence record (the best "
             "candidate's flags) or a bare {flag: value} JSON object. Unknown keys "
             "and flags that also appear explicitly on the command line are "
             "rejected (cli/_flags.expand_config_json)")
    return parser


def main(argv=None) -> dict:
    parser = build_parser()
    # the file's flags become argv tokens BEFORE parsing, so its values
    # ride the parser's own types and choices
    argv = expand_config_json(parser, list(sys.argv[1:] if argv is None else argv))
    args = parser.parse_args(argv)
    joined = initialize_multihost(args.coordinator_address, args.num_processes,
                                  args.process_id, device=args.device)
    try:
        return _run(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args) -> dict:
    tcfg = train_config_from(args)
    pcfg = ps_config_from(args, args.num_workers or 1)
    trainer = Trainer(tcfg, pcfg, device=args.device)
    # SIGTERM / SIGINT -> checkpoint and a clean return; rerun with --resume
    trainer.install_signal_handlers()
    try:
        metrics = trainer.train()
    finally:
        # past the loop nothing reads the stop flag: Ctrl-C during
        # validation (or in an embedding program) acts as before
        trainer.restore_signal_handlers()
    logger.info("training done: %s", metrics)
    val = None
    if trainer.stop_requested:
        # preemption: the checkpoint is written; exit inside the grace
        # window instead of starting a validation pass
        logger.warning("stopped by signal: skipping validation")
    else:
        val = trainer.validate()
    return {"train": metrics, "val": val, "history": trainer.history, "trainer": trainer}


if __name__ == "__main__":
    main()
