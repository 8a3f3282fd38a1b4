"""Package logger (the serving slice's share of the JAX package's
utils/logging.py; the per-iteration training line format arrives with the
training slice)."""

from __future__ import annotations

import logging


def get_logger(name: str = "ps_pytorch_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("INFO: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
