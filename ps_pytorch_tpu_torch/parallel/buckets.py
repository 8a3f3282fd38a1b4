"""Flat weight geometry and the per-leaf gradient wire (the port's subset
of parallel/buckets.py).

The trainer keeps master params and optimizer moments as ONE padded flat
f32 vector (``state_layout="flat"``), and the serving engine keeps its
weights the same way, so a checkpoint rollover is one buffer swap. This
module carries that geometry:

- ``TreeLayout`` / ``tree_layout``: per-leaf shapes, dtypes and element
  offsets of a params tree. Leaf order is ``jax.tree_util``'s — dict keys
  sorted, list order kept (buckets.py:73-88) — so the flat vector is
  element-identical to the JAX engine's (engine.py:254-259);
- ``plan_buckets``: the padded partition (the engine uses one bucket);
- ``FlatVector``: one flat f32 tensor plus ``tree()``, a tree of VIEWS
  into it (no copies for f32 leaves);
- ``tree_to_flat`` / ``pad_flat`` / ``to_flat_vector``: the pack;
- ``piece_stream``: what a collective ships. The per-leaf wire
  (``bucket_bytes=None``, the default ``--bucket-bytes -1``) is ported:
  one piece per leaf, rebuilt into the tree or, with ``flat_output``,
  into the padded flat vector the fused update consumes;
- ``_np_tree_to_flat``: the host-side pack.

The bucketed wires (``bucket_bytes >= 0``: split/assemble and the
pipelined order) raise ``NotImplementedError`` until their slice
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch


class _Leaf:
    """Placeholder for one leaf in a tree skeleton."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, skeleton) in ``jax.tree_util`` order: dict keys sorted,
    list/tuple order kept."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        leaves.append(node)
        return _Leaf(len(leaves) - 1)

    return leaves, walk(tree)


def tree_unflatten(skeleton, leaves: List[Any]):
    if isinstance(skeleton, dict):
        return {k: tree_unflatten(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(tree_unflatten(x, leaves) for x in skeleton)
    return leaves[skeleton.index]


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn, *trees):
    """``fn`` over the leaves of equally-shaped trees (a bare tensor is a
    one-leaf tree)."""
    flats = [tree_flatten(t) for t in trees]
    leaves = [fn(*xs) for xs in zip(*(f[0] for f in flats))]
    return tree_unflatten(flats[0][1], leaves)


def _align_up(n: int, align: int) -> int:
    return -(-n // align) * align


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """Static geometry of a tree flattened into one f32 vector."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]   # element offset of each leaf in the flat vec
    total: int                 # total elements (unpadded)


def tree_layout(tree) -> TreeLayout:
    """Geometry of a tree of tensors."""
    leaves, skeleton = tree_flatten(tree)
    shapes, dtypes, offsets = [], [], []
    off = 0
    for leaf in leaves:
        shape = tuple(int(d) for d in leaf.shape)
        shapes.append(shape)
        dtypes.append(leaf.dtype)
        offsets.append(off)
        off += int(np.prod(shape, dtype=np.int64))
    return TreeLayout(
        treedef=skeleton, shapes=tuple(shapes), dtypes=tuple(dtypes),
        offsets=tuple(offsets), total=off,
    )


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """A partition of the alignment-padded flat buffer into buckets."""

    total: int
    padded_total: int
    align: int
    starts: Tuple[int, ...]
    sizes: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.starts)


def plan_buckets(total: int, bucket_bytes: int, align: int = 1) -> BucketPlan:
    """Carve ``total`` f32 elements into buckets of ~``bucket_bytes``
    (0 = one fused bucket); boundaries are multiples of ``align``."""
    if bucket_bytes < 0:
        raise ValueError(f"bucket_bytes must be >= 0, got {bucket_bytes}")
    align = max(int(align), 1)
    padded_total = max(_align_up(total, align), align)
    if bucket_bytes == 0:
        bucket_elems = padded_total
    else:
        bucket_elems = max((bucket_bytes // 4) // align * align, align)
    starts, sizes = [], []
    off = 0
    while off < padded_total:
        size = min(bucket_elems, padded_total - off)
        starts.append(off)
        sizes.append(size)
        off += size
    return BucketPlan(total=total, padded_total=padded_total, align=align,
                      starts=tuple(starts), sizes=tuple(sizes))


def tree_to_flat(tree) -> torch.Tensor:
    """Concatenate every leaf (tree_leaves order) into one f32 vector."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([leaf.float().reshape(-1) for leaf in leaves])


def pad_flat(flat: torch.Tensor, plan: BucketPlan) -> torch.Tensor:
    return torch.nn.functional.pad(flat, (0, plan.padded_total - plan.total))


def flat_to_tree(layout: TreeLayout, flat: torch.Tensor):
    """Per-leaf views of ``flat`` (the pad tail is dropped); a leaf whose
    dtype is not f32 is cast, which copies it."""
    leaves = []
    for shape, dtype, off in zip(layout.shapes, layout.dtypes, layout.offsets):
        n = int(np.prod(shape, dtype=np.int64))
        leaf = flat[off:off + n].view(shape)
        leaves.append(leaf if dtype == flat.dtype else leaf.to(dtype))
    return tree_unflatten(layout.treedef, leaves)


@dataclasses.dataclass(frozen=True)
class FlatVector:
    """One param-shaped quantity stored flat: the padded f32 vector
    (``plan.padded_total`` elements) plus its static geometry."""

    flat: torch.Tensor
    layout: TreeLayout
    plan: BucketPlan

    def tree(self):
        """The tree view: views into ``flat``, no copies."""
        return flat_to_tree(self.layout, self.flat)


def to_flat_vector(tree, plan: BucketPlan) -> FlatVector:
    """Pack a tree of tensors into a FlatVector with ``plan``'s padding."""
    return FlatVector(flat=pad_flat(tree_to_flat(tree), plan),
                      layout=tree_layout(tree), plan=plan)


def tree_view(params):
    """Tree view of a params-like object (FlatVector or tree)."""
    if isinstance(params, FlatVector):
        return params.tree()
    return params


def _np_tree_to_flat(layout: TreeLayout, plan: BucketPlan, tree) -> np.ndarray:
    """Host-side pack of a tree of tensors into the padded f32 flat
    vector."""
    flat = np.zeros((plan.padded_total,), np.float32)
    for leaf, off in zip(tree_leaves(tree), layout.offsets):
        arr = leaf.detach().to("cpu", torch.float32).numpy().reshape(-1)
        flat[off:off + arr.size] = arr
    return flat


def piece_stream(tree, bucket_bytes, align: int = 1, flat_output: bool = False):
    """The comm engine's one entry point: what a collective scheme ships
    (buckets.py:412). Returns ``(pieces, key_ids, rebuild)``:

    - ``pieces``: the tree's leaves verbatim (``bucket_bytes is None``,
      the per-leaf wire). A leaf may be worker-stacked ``[N, *shape]``;
    - ``key_ids``: the enumeration index per leaf (the PRNG fold value
      of stochastic rounding, kept for the contract);
    - ``rebuild``: maps the per-piece results (same shapes, without the
      worker dimension) back to the tree, or with ``flat_output=True`` to
      ONE padded flat f32 vector in the ``align`` geometry
      (``plan_buckets(total, 0, align)``). The pieces are the same either
      way; only the rebuild differs."""
    if bucket_bytes is not None:
        raise NotImplementedError(
            "bucketed gradient wires (bucket_bytes >= 0) are not ported yet "
            "(ROADMAP.md queue 1, Slice B): use the per-leaf wire "
            "(--bucket-bytes -1)"
        )
    leaves, skeleton = tree_flatten(tree)
    key_ids = tuple(range(len(leaves)))
    if not flat_output:
        return leaves, key_ids, lambda outs: tree_unflatten(skeleton, list(outs))

    def rebuild(outs):
        flat = (torch.cat([o.float().reshape(-1) for o in outs]) if outs
                else torch.zeros((0,), dtype=torch.float32))
        return pad_flat(flat, plan_buckets(flat.numel(), 0, align=align))

    return leaves, key_ids, rebuild
