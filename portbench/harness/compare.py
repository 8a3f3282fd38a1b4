"""The numbers that decide ``correct`` in a training cell.

The program's first steps (the window's own call and feed, before the
window) are held against the plain reference's over the same steps:

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the checked
  steps; ``loss1_gap`` the same of the first step alone (the forward
  pass on the starting weights: steady from seed to seed, before any
  rounding of the gradient wire or the optimizer can amplify a
  difference);
- ``grad_gap``: the first step's gradient as the optimizer got it
  (worked out from the optimizer's state after one step), by the worst
  leaf: ``|norm(leaf) - norm(ref leaf)| / max(norm(ref leaf), the median
  ref leaf's norm)``;
- ``update_gap``: the same for the parameters' change over the checked
  steps, on the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a gradient that is nought to rounding moves a
  leaf under Adam by round-off alone);
- ``stats_gap`` (a model with BatchNorm): the same for the change of the
  running statistics over the first step. They come from the forward
  pass alone and pass through no quantizer, so their gap scales with the
  precision of the forward's products, where the int8 wire turns any
  difference in a gradient into whole rounding steps of small leaves.

Each is a gap between norms, not the norm of a difference. Norms are
taken in float64.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Leaves = Dict[str, torch.Tensor]

NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "update_gap", "stats_gap")
MOVED_SHARE = 1e-3


def norms(leaves: Leaves) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def loss_gap(losses: Sequence[float], ref: Sequence[float]) -> float:
    if len(losses) != len(ref):
        raise ValueError(f"{len(losses)} losses against {len(ref)} reference losses")
    return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap of norms and that leaf's name."""
    if set(prog) != set(ref):
        raise ValueError(f"leaf names differ: {sorted(set(prog) ^ set(ref))}")
    names = list(keep) if keep is not None else list(ref)
    floor = _median([ref[k] for k in names])
    worst = max(names, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], floor))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], floor), worst


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient norm is at least
    ``MOVED_SHARE`` of the median leaf's."""
    med = _median(list(ref_grad.values()))
    return [k for k, v in ref_grad.items() if v >= MOVED_SHARE * med]


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (floats), ``grad`` (leaf
    norms of the first gradient) and ``update`` (leaf norms of the
    change over the checked steps)."""
    keep = moved_leaves(ref["grad"])
    out = {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "loss1_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"])[0],
        "update_gap": leaf_gap(prog["update"], ref["update"], keep)[0],
    }
    if "stats" in ref:
        out["stats_gap"] = leaf_gap(prog["stats"], ref["stats"])[0]
    return out


def _change(before: Leaves, after: Leaves) -> Dict[str, float]:
    return norms({k: after[k].double() - before[k].double() for k in after})


def summary(leaves_grad: Leaves, leaves_before: Leaves, leaves_after: Leaves,
            losses: Sequence[float], stats_before: Optional[Leaves] = None,
            stats_after: Optional[Leaves] = None) -> dict:
    """The compared quantities of one side, as ``readings`` takes them."""
    out = {"losses": [float(x) for x in losses], "grad": norms(leaves_grad),
           "update": _change(leaves_before, leaves_after)}
    if stats_after is not None:
        out["stats"] = _change(stats_before, stats_after)
    return out


def compared(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, float]:
    """The numbers the cell compares: those its limits name (every
    number, when it has none yet)."""
    return {k: v for k, v in numbers.items() if k in limits} if limits else dict(numbers)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number at or under its limit; no limit, a limit
    naming a number that was not read, or a number that is not finite
    fails."""
    if not limits or set(limits) - set(numbers):
        return False
    return all(numbers[k] == numbers[k] and numbers[k] <= lim for k, lim in limits.items())


@contextlib.contextmanager
def f32_products():
    """The reference's f32 matrix products and convolutions without TF32;
    the flags are put back after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd
