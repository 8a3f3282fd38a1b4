"""Logging of the port (utils/logging.py): the package logger and the
reference-format per-iteration and evaluation lines.

The reference emits one line per worker iteration
(distributed_worker.py:169-173) and its analysis layer regex-parses that
shape (tiny_tuning_parser.py:14-27), so the format is kept: the JAX
package's ``parse_iter_line`` and ``analysis/`` read port runs unchanged.
As in the JAX trainer, "Forward" is the whole train step's host time and
Backward / Comm Cost are 0.0: the step is one fused dispatch, with no
separable backward wall time.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Optional

_FMT = (
    "Worker: {rank}, Step: {step}, Epoch: {epoch} [{seen}/{total} ({pct:.0f}%)], "
    "Loss: {loss:.4f}, Time Cost: {time_cost:.4f}, FetchWeight: {fetch:.4f}, "
    "Forward: {forward:.4f}, Backward: {backward:.4f}, Comm Cost: {comm:.4f}"
)

ITER_LOG_RE = re.compile(
    r"Worker: (?P<rank>\S+), Step: (?P<step>\d+), Epoch: (?P<epoch>\d+) "
    r"\[(?P<seen>\d+)/(?P<total>\d+) \((?P<pct>[\d.]+)%\)\], "
    r"Loss: (?P<loss>[\d.eE+-]+|-?nan|-?inf), Time Cost: (?P<time_cost>[\d.eE+-]+), "
    r"FetchWeight: (?P<fetch>[\d.eE+-]+), Forward: (?P<forward>[\d.eE+-]+), "
    r"Backward: (?P<backward>[\d.eE+-]+), Comm Cost: (?P<comm>[\d.eE+-]+)"
)


def get_logger(name: str = "ps_pytorch_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("INFO: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def format_iter_line(rank, step: int, epoch: int, seen: int, total: int,
                     loss: float, time_cost: float, fetch: float = 0.0,
                     forward: float = 0.0, backward: float = 0.0,
                     comm: float = 0.0) -> str:
    pct = 100.0 * seen / total if total else 0.0
    return _FMT.format(rank=rank, step=step, epoch=epoch, seen=seen, total=total,
                       pct=pct, loss=loss, time_cost=time_cost, fetch=fetch,
                       forward=forward, backward=backward, comm=comm)


def parse_iter_line(line: str) -> Optional[Dict[str, float]]:
    """One iteration line -> dict of floats (None if it does not match)."""
    m = ITER_LOG_RE.search(line)
    if not m:
        return None
    out: Dict[str, float] = {}
    for k, v in m.groupdict().items():
        try:
            out[k] = float(v)
        except ValueError:
            out[k] = v  # rank may be non-numeric
    return out


def format_eval_line(step: int, loss: float, prec1: float, prec5: float) -> str:
    """Evaluator report (parity: distributed_evaluator.py:90-106)."""
    return (f"Validation Step: {step}, Loss: {loss:.4f}, "
            f"Prec@1: {prec1:.2f}, Prec@5: {prec5:.2f}")
