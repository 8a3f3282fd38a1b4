"""Single-device baseline entry (the port of
ps_pytorch_tpu.cli.single_machine; parity: the reference's
single_machine.py, the "measure scalability against this" oracle).

The math of ``cli.train`` at one worker; a separate entry point so the
scalability-baseline workflow carries over name for name. Runs on
``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse

from ..parallel.ps import PSConfig
from ..trainer import Trainer
from ..utils import get_logger
from ._flags import add_train_flags, train_config_from

logger = get_logger()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("ps_pytorch_tpu_torch.cli.single_machine")
    add_train_flags(parser)
    args = parser.parse_args(argv)
    tcfg = train_config_from(args)
    trainer = Trainer(tcfg, PSConfig(num_workers=1), device=args.device)
    metrics = trainer.train()
    logger.info("training done: %s", metrics)
    val = trainer.validate()
    return {"train": metrics, "val": val}


if __name__ == "__main__":
    main()
