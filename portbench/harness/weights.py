"""Weights and data made from the seed on the device, in a few large
calls.

A configuration's reference lists its leaves as ``(path, shape, init)``,
``path`` a ``/``-joined name in the port's tree (``blocks/3/wqkv``),
``init`` ``("normal", std)``, ``("ones",)`` or ``("zeros",)``. One
``torch.Generator`` on the device draws one normal vector for every
normal leaf, which is cut and scaled leaf by leaf: the same seed gives
the same weights on every run, and again after the window, so the
reference is handed the very values the program started from.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], tuple]

# the weights draw from the seed itself, the data from these offsets of it
WEIGHT_STREAM, DATA_STREAM = 0, 1


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 4 + stream) % (2 ** 63))


def make_leaves(specs: Sequence[Spec], seed: int, device: torch.device,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    g = generator(seed, WEIGHT_STREAM, device)
    n_normal = sum(_numel(shape) for _, shape, init in specs if init[0] == "normal")
    draw = torch.randn((n_normal,), generator=g, device=device, dtype=dtype)
    out, at = {}, 0
    for path, shape, init in specs:
        if init[0] == "normal":
            n = _numel(shape)
            out[path] = draw[at:at + n].view(shape) * float(init[1])
            at += n
        elif init[0] == "ones":
            out[path] = torch.ones(shape, device=device, dtype=dtype)
        elif init[0] == "zeros":
            out[path] = torch.zeros(shape, device=device, dtype=dtype)
        else:
            raise ValueError(f"unknown init {init!r} of {path}")
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def nest(leaves: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b/0/c": t}`` -> ``{"a": {"b": [{"c": t}]}}``: a path part of
    digits indexes a list."""
    root: dict = {}
    for path, t in leaves.items():
        parts = path.split("/")
        node = root
        for i, part in enumerate(parts[:-1]):
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[k]) for k in sorted(node, key=int)]
    return {k: _lists(v) for k, v in node.items()}


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of ``nest``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def paths(specs: Sequence[Spec]) -> List[str]:
    return [p for p, _, _ in specs]
