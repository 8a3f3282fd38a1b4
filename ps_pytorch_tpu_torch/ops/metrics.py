"""Loss and metric ops (the port of ops/metrics.py).

Parity targets: the reference's CrossEntropyLoss (mean reduction) and
Prec@1 / Prec@5 in percent (nn_ops.py:14-27).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, mean over the batch."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             topk: Sequence[int] = (1,)) -> Tuple[torch.Tensor, ...]:
    """Prec@k for each k, in percent, as device scalars."""
    pred = torch.topk(logits, max(topk), dim=-1).indices
    correct = pred == labels.long()[:, None]
    return tuple(100.0 * correct[:, :k].any(dim=-1).float().mean() for k in topk)
