"""Plain reference of the LM training step (torch only; nothing of the
program): the model's loss and gradient over one batch of sequences,
then an Adam step (Kingma and Ba; bias-corrected, epsilon outside the
root), f32 state.

``fault="half"`` plants a fault a run can have: the loss over half the
batch's sequences.
"""

from __future__ import annotations

from typing import List, Optional

import torch


def follow(model, config: dict, params: dict, batches: List[torch.Tensor], adam: dict,
           precision: str = "f32", fault: Optional[str] = None) -> dict:
    p = {k: v.detach().clone().float() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    lr, b1, b2, eps, wd = adam["lr"], adam["b1"], adam["b2"], adam["eps"], adam["weight_decay"]
    losses, first = [], None
    for step, tokens in enumerate(batches, start=1):
        if fault == "half":
            tokens = tokens[: tokens.shape[0] // 2]
        loss, g = model.loss_and_grads(config, p, tokens, precision)
        losses.append(loss)
        if first is None:
            first = {k: t.clone() for k, t in g.items()}
        size = lr * (1 - b2 ** step) ** 0.5 / (1 - b1 ** step)
        for k in p:
            gk = g[k] + wd * p[k]
            m[k] = b1 * m[k] + (1 - b1) * gk
            v2[k] = b2 * v2[k] + (1 - b2) * gk * gk
            p[k] = p[k] - size * m[k] / (v2[k].sqrt() + eps)
        del g
    return {"losses": losses, "grad": first, "params": p}
