"""Loss and metric ops (the port of ops/metrics.py).

Parity targets: the reference's CrossEntropyLoss (mean reduction) and
Prec@1 / Prec@5 in percent (nn_ops.py:14-27); the LM's mean next-token
NLL.
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


def next_token_positions_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each position's next-token NLL, ``[..., T - 1]``: logits ``[..., T,
    V]`` (position t predicts token t + 1), int tokens ``[..., T]``."""
    logp = F.log_softmax(logits[..., :-1, :].float(), dim=-1)
    return -logp.gather(-1, tokens[..., 1:].long()[..., None])[..., 0]


def shard_next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each shard's mean next-token NLL: logits ``[n, ..., T, V]``, tokens
    ``[n, ..., T]`` -> ``[n]`` (``next_token_nll`` on each device of a JAX
    mesh)."""
    return next_token_positions_nll(logits, tokens).flatten(1).mean(1)


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood for an LM batch: the loss
    of the tensor- and pipeline-parallel steps and of the LM evaluator
    (leading batch-like dims fold in, so ``[M, B, T]`` microbatches
    work unchanged)."""
    return next_token_positions_nll(logits, tokens).mean()
