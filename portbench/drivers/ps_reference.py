"""Plain reference of the parameter-server step (torch and numpy only;
nothing of the program).

One step of the reference protocol with N workers on one copy of the
weights: each worker takes its next batch of its own epoch order,
augments it (4-pixel reflect pad, crop, horizontal flip) and normalizes
it, runs the model's forward and backward with BatchNorm over its own
rows; the master keeps ``aggregate`` of the N gradients, drawn at random
each step, sends every leaf through the int8 wire (one scale a leaf over
the kept workers: ``absmax / 127``, round half to even, clip to +-127),
sums the integers, scales them back and divides by ``aggregate``, then
takes an SGD step with momentum. The running statistics are the mean of
the workers'.

The rules that pick rows and draws are frozen copies of the port's, so
both sides see the same rows and the same crops: worker w's epoch order
is a ``numpy.random.RandomState(seed + 1009 w)`` shuffle; step s's draws
come from a CPU ``torch.Generator`` seeded ``(draw_seed * 1000003 + s)
mod 2^63``: the worker permutation, then each worker's crop offsets and
flips.

``fault`` plants one of the faults a run can have, for the control
readings: ``"half"`` (each worker's loss over half its rows),
``"no_exchange"`` (the update from one worker's gradient, none
exchanged).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def epoch_order(n_images: int, seed: int) -> np.ndarray:
    idx = np.arange(n_images)
    np.random.RandomState(seed).shuffle(idx)
    return idx


def step_draws(draw_seed: int, step: int, workers: int, batch: int, pad: int):
    g = torch.Generator().manual_seed((draw_seed * 1_000_003 + step) % (2 ** 63))
    perm = torch.randperm(workers, generator=g)
    crops = []
    for _ in range(workers):
        offsets = torch.randint(0, 2 * pad + 1, (batch, 2), generator=g)
        flips = torch.rand((batch,), generator=g) < 0.5
        crops.append((offsets, flips))
    return perm, crops


def augment(images: torch.Tensor, offsets: torch.Tensor, flips: torch.Tensor, pad: int,
            mode: str, mean, std) -> torch.Tensor:
    """uint8 NHWC -> padded, cropped, flipped, normalized f32 NHWC."""
    n, h, w, _ = images.shape
    dev = images.device
    x = F.pad(images.permute(0, 3, 1, 2).float(), (pad, pad, pad, pad), mode=mode)
    x = x.permute(0, 2, 3, 1)  # padded NHWC
    offsets, flips = offsets.to(dev), flips.to(dev)
    rows = offsets[:, 0, None] + torch.arange(h, device=dev)  # [n, h]
    cols = offsets[:, 1, None] + torch.arange(w, device=dev)  # [n, w]
    cols = torch.where(flips[:, None], cols.flip(1), cols)
    out = x[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (out / 255.0 - m) / s


def int8_wire(stacked: torch.Tensor) -> torch.Tensor:
    """The integer sum of a leaf's worker-stacked gradient on one shared
    scale, scaled back (not yet divided by the count)."""
    absmax = stacked.abs().max()
    if float(absmax) == 0.0:
        return torch.zeros_like(stacked[0])
    q = torch.clamp(torch.round(stacked * (127.0 / absmax)), -127, 127)
    return q.sum(dim=0) * (absmax / 127.0)


def follow(model, config: dict, inputs: dict, proto: dict, steps: int,
           precision: str = "f32", fault: Optional[str] = None) -> dict:
    """``steps`` reference steps from ``inputs["params"]`` /
    ``inputs["stats"]`` (dicts of path -> tensor on the device) over
    ``inputs["images"]`` / ``inputs["labels"]`` (numpy). Returns the mean
    loss over the workers of each step, the aggregated gradient of the
    first step (what the optimizer got), the parameters after the last
    and the running statistics after the first."""
    data = config["dataset"]
    aug = data["augment"]
    n, b, k = proto["workers"], proto["batch"], proto["aggregate"]
    dev = next(iter(inputs["params"].values())).device
    params = {p: t.detach().clone().float() for p, t in inputs["params"].items()}
    stats = {p: t.detach().clone().float() for p, t in inputs["stats"].items()}
    orders = [epoch_order(len(inputs["images"]), proto["seed"] + proto["shuffle_stride"] * w)
              for w in range(n)]
    buf: Dict[str, torch.Tensor] = {}
    losses, first_grad, first_stats = [], None, None
    rows = b // 2 if fault == "half" else b
    for s in range(steps):
        perm, crops = step_draws(proto["draw_seed"], s, n, b, aug["pad"])
        kept = [int(w) for w in perm[:k]]
        grads, step_losses, new_stats = [], [], []
        for w in range(n):
            idx = orders[w][s * b:s * b + rows]
            imgs = torch.from_numpy(np.ascontiguousarray(inputs["images"][idx])).to(dev)
            labels = torch.from_numpy(np.asarray(inputs["labels"][idx], np.int64)).to(dev)
            offsets, flips = crops[w]
            x = augment(imgs, offsets[:rows], flips[:rows], aug["pad"], aug["pad_mode"],
                        data["norm_mean"], data["norm_std"])
            leaves = {p: t.detach().requires_grad_(True) for p, t in params.items()}
            with torch.enable_grad():
                logits, st = model.forward(config, leaves, stats, x, precision)
                loss = F.cross_entropy(logits.float(), labels)
                g = torch.autograd.grad(loss, list(leaves.values()))
            grads.append(dict(zip(leaves, g)))
            step_losses.append(float(loss.detach()))
            new_stats.append(st)
        senders = [kept[0]] if fault == "no_exchange" else kept
        agg = {}
        for p in params:
            stacked = torch.stack([grads[w][p] for w in senders])
            agg[p] = int8_wire(stacked) / float(len(senders))
        if first_grad is None:
            first_grad = {p: t.clone() for p, t in agg.items()}
        lr, mom, wd = proto["lr"], proto["momentum"], proto["weight_decay"]
        for p in params:
            d = agg[p] + wd * params[p]
            buf[p] = d if s == 0 else mom * buf[p] + d
            params[p] = params[p] - lr * buf[p]
        stats = {p: torch.stack([st[p] for st in new_stats]).mean(dim=0) for p in stats}
        if first_stats is None:
            first_stats = stats
        losses.append(sum(step_losses) / n)
    return {"losses": losses, "grad": first_grad, "params": params, "stats": first_stats}
