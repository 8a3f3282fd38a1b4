"""Flat weight geometry and the gradient wire's piece stream (the port of
parallel/buckets.py, serial schedule).

The trainer keeps master params and optimizer moments as ONE padded flat
f32 vector (``state_layout="flat"``), and the serving engine keeps its
weights the same way, so a checkpoint rollover is one buffer swap. This
module carries that geometry:

- ``TreeLayout`` / ``tree_layout``: per-leaf shapes, dtypes and element
  offsets of a params tree. Leaf order is ``jax.tree_util``'s — dict keys
  sorted, list order kept (buckets.py:73-88) — so the flat vector is
  element-identical to the JAX engine's (engine.py:254-259);
- ``plan_buckets``: the padded partition into ~``bucket_bytes`` buckets
  whose boundaries are multiples of ``align``;
- ``FlatVector``: one flat f32 tensor plus ``tree()``, a tree of VIEWS
  into it (no copies for f32 leaves);
- ``tree_to_flat`` / ``pad_flat`` / ``to_flat_vector``: the pack
  (``stacked=True`` flattens each worker's row of a worker-stacked tree);
- ``split_buckets`` / ``concat_buckets``: cut a padded flat buffer into
  its buckets and join them again;
- ``piece_stream``: what a collective ships. The per-leaf wire
  (``bucket_bytes=None``, the default ``--bucket-bytes -1``) ships the
  leaves; the bucketed wires (``0`` = one fused buffer, ``N`` = ~N-byte
  buckets) ship the buckets of each worker's flattened, padded tree;
- ``bucket_leaf_segments`` / ``assemble_bucket`` / ``leaves_from_buckets``
  / ``readiness_bucket_order``: the pipelined wire's per-bucket dataflow
  (``--overlap on``): a bucket built from its own leaves alone, the tree
  rebuilt leaf by leaf from the buckets its bytes live in, and the order
  buckets become ready in a backward;
- ``_np_tree_to_flat`` / ``_np_flat_to_tree``: the host-side pack and
  unpack; with them, ``FlatVector``'s checkpoint handlers, which store it
  as its tree (buckets.py:364-404).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..utils.serialization import from_state_dict, register_serialization_state


class _Leaf:
    """Placeholder for one leaf in a tree skeleton."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _skeleton(node, leaves: List[Any]):
    """``node``'s skeleton, its leaves appended to ``leaves``. A module
    function, not a recursive closure: a closure that names itself is a
    reference cycle, which would keep every leaf (a step's gradients on
    the card) alive until the garbage collector runs."""
    if isinstance(node, dict):
        return {k: _skeleton(node[k], leaves) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_skeleton(x, leaves) for x in node)
    leaves.append(node)
    return _Leaf(len(leaves) - 1)


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, skeleton) in ``jax.tree_util`` order: dict keys sorted,
    list/tuple order kept."""
    leaves: List[Any] = []
    return leaves, _skeleton(tree, leaves)


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


def tree_layout(tree, stacked: bool = False) -> TreeLayout:
    """Geometry of a tree of tensors (``stacked``: of one worker's row of
    a tree of worker-stacked ``[N, *shape]`` leaves)."""
    leaves, skeleton = tree_flatten(tree)
    shapes, dtypes, offsets = [], [], []
    off = 0
    for leaf in leaves:
        shape = tuple(int(d) for d in leaf.shape[1 if stacked else 0:])
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


def tree_to_flat(tree, stacked: bool = False) -> torch.Tensor:
    """Concatenate every leaf (tree_leaves order) into one f32 vector.
    ``stacked``: every leaf is worker-stacked ``[N, *shape]`` and each
    worker's leaves are flattened into its own row, ``[N, total]``."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    if not stacked:
        return torch.cat([leaf.float().reshape(-1) for leaf in leaves])
    n = leaves[0].shape[0]
    # explicit row lengths: reshape(n, -1) is ambiguous for an empty leaf
    return torch.cat([leaf.float().reshape(n, int(np.prod(leaf.shape[1:], dtype=np.int64)))
                      for leaf in leaves], dim=1)


def pad_flat(flat: torch.Tensor, plan: BucketPlan) -> torch.Tensor:
    """Zero-pad the last dimension from ``plan.total`` to
    ``plan.padded_total`` (a worker-stacked ``[N, total]`` pads per row)."""
    return torch.nn.functional.pad(flat, (0, plan.padded_total - plan.total))


def flat_to_tree(layout: TreeLayout, flat: torch.Tensor):
    """Per-leaf views of ``flat`` (the pad tail is dropped); a leaf whose
    dtype is not f32 is cast, which copies it. Leading dimensions of
    ``flat`` (a worker-stacked ``[N, padded]``) lead every leaf."""
    lead = tuple(flat.shape[:-1])
    leaves = []
    for shape, dtype, off in zip(layout.shapes, layout.dtypes, layout.offsets):
        n = int(np.prod(shape, dtype=np.int64))
        leaf = flat[..., off:off + n].reshape(lead + tuple(shape))
        leaves.append(leaf if dtype == flat.dtype else leaf.to(dtype))
    return tree_unflatten(layout.treedef, leaves)


def split_buckets(flat_padded: torch.Tensor, plan: BucketPlan) -> List[torch.Tensor]:
    """Slices of the padded flat buffer's last dimension, one per bucket
    (views; a worker-stacked ``[N, padded]`` buffer gives ``[N, size]``
    pieces)."""
    return [flat_padded[..., s:s + n] for s, n in zip(plan.starts, plan.sizes)]


def concat_buckets(buckets) -> torch.Tensor:
    return torch.cat(list(buckets), dim=-1)


def bucket_leaf_segments(layout: TreeLayout, plan: BucketPlan):
    """The leaf fragments of each bucket (buckets.py:179): one tuple per
    bucket of ``(leaf_index, leaf_offset, length)`` in flat order, with
    ``leaf_index`` None for the zero padding tail."""
    leaf_spans = []
    for i, (shape, off) in enumerate(zip(layout.shapes, layout.offsets)):
        n = int(np.prod(shape, dtype=np.int64))
        if n:
            leaf_spans.append((off, off + n, i))
    out, li = [], 0
    for start, size in zip(plan.starts, plan.sizes):
        end, cur, frags = start + size, start, []
        while li < len(leaf_spans) and leaf_spans[li][1] <= cur:
            li += 1
        j = li
        while j < len(leaf_spans) and leaf_spans[j][0] < end:
            l0, l1, idx = leaf_spans[j]
            s, e = max(cur, l0), min(end, l1)
            if s < e:
                frags.append((idx, s - l0, e - s))
                cur = e
            j += 1
        if cur < end:
            frags.append((None, 0, end - cur))
        out.append(tuple(frags))
    return tuple(out)


def assemble_bucket(leaves, segments, stacked: bool = False) -> torch.Tensor:
    """One contiguous f32 bucket from its own leaf fragments
    (buckets.py:221): the values of the slice of the padded concat, from
    this bucket's leaves alone. ``stacked``: the leaves are worker-stacked
    ``[N, *shape]`` and the bucket is ``[N, size]``."""
    # a leaf of this bucket (the others may not exist yet) gives the
    # worker dimension and the device
    ref = next((leaves[idx] for idx, _, _ in segments if idx is not None),
               leaves[0] if leaves else None)
    lead = (int(ref.shape[0]),) if stacked and ref is not None else ()
    parts = []
    for idx, off, n in segments:
        if idx is None:
            dev = ref.device if ref is not None else None
            parts.append(torch.zeros(lead + (n,), dtype=torch.float32, device=dev))
            continue
        leaf = leaves[idx].float().reshape(lead + (-1,))
        parts.append(leaf if off == 0 and n == leaf.shape[-1] else leaf[..., off:off + n])
    if not parts:
        return torch.zeros(lead + (0,), dtype=torch.float32)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def leaves_from_buckets(layout: TreeLayout, plan: BucketPlan, outs):
    """The tree from per-bucket results in canonical order (buckets.py:241),
    each leaf from the buckets its bytes live in. Leading dimensions of
    the results (a worker-stacked ``[N, size]``) lead every leaf."""
    lead = tuple(outs[0].shape[:-1]) if outs else ()
    leaves = []
    for shape, dtype, off in zip(layout.shapes, layout.dtypes, layout.offsets):
        n = int(np.prod(shape, dtype=np.int64))
        parts = []
        for b, (bs, sz) in enumerate(zip(plan.starts, plan.sizes)):
            s, e = max(off, bs), min(off + n, bs + sz)
            if s < e:
                piece = outs[b]
                parts.append(piece if (s, e) == (bs, bs + sz) else piece[..., s - bs:e - bs])
        if not parts:
            flat = torch.zeros(lead + (0,), dtype=torch.float32)
        else:
            flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        leaf = flat.reshape(lead + tuple(shape))
        leaves.append(leaf if dtype == leaf.dtype else leaf.to(dtype))
    return tree_unflatten(layout.treedef, leaves)


def readiness_bucket_order(plan: BucketPlan, layout: Optional[TreeLayout] = None,
                           leaf_rank=None) -> Tuple[int, ...]:
    """The pipelined wire's bucket order (buckets.py:277): the bucket whose
    last-ready leaf is produced earliest goes first. ``leaf_rank[i]`` is
    leaf i's production rank in the backward (``parallel.overlap.
    grad_leaf_readiness`` measures it); without one, reverse bucket
    enumeration (the last-built layers' gradients come first)."""
    if layout is None or leaf_rank is None:
        return tuple(reversed(range(plan.n_buckets)))
    n_leaves = len(layout.shapes)
    ready = []
    for b, frags in enumerate(bucket_leaf_segments(layout, plan)):
        ranks = [leaf_rank[idx] for idx, _, _ in frags if idx is not None and idx < n_leaves]
        ready.append((max(ranks) if ranks else -1, b))
    return tuple(b for _, b in sorted(ready))


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


def _np_flat_to_tree(layout: TreeLayout, flat):
    """Host-side ``flat_to_tree``: CPU tensor leaves (copies, in the
    layout's dtypes) of a numpy flat vector; the pad tail is dropped."""
    flat = torch.from_numpy(np.array(flat, np.float32))
    leaves = []
    for shape, dtype, off in zip(layout.shapes, layout.dtypes, layout.offsets):
        n = int(np.prod(shape, dtype=np.int64))
        leaves.append(flat[off:off + n].reshape(shape).to(dtype))
    return tree_unflatten(layout.treedef, leaves)


def _np_tree_to_flat(layout: TreeLayout, plan: BucketPlan, tree) -> np.ndarray:
    """Host-side pack of a tree of tensors into the padded f32 flat
    vector."""
    flat = np.zeros((plan.padded_total,), np.float32)
    for leaf, off in zip(tree_leaves(tree), layout.offsets):
        arr = leaf.detach().to("cpu", torch.float32).numpy().reshape(-1)
        flat[off:off + arr.size] = arr
    return flat


def _flat_state_tree(fv: FlatVector):
    """A FlatVector's checkpoint form, its tree on the host: one copy of
    the flat buffer, then numpy views cut from it in the layout's leaf
    order (bf16 leaves stay CPU tensors, numpy has no bf16)."""
    leaves = tree_leaves(flat_to_tree(fv.layout, fv.flat.detach().to("cpu", copy=True)))
    leaves = [leaf if leaf.dtype == torch.bfloat16 else leaf.numpy() for leaf in leaves]
    return tree_unflatten(fv.layout.treedef, leaves)


def _flat_from_state(target: FlatVector, state, path: str) -> FlatVector:
    """Restore a checkpoint's tree into ``target``'s flat geometry."""
    template = flat_to_tree(target.layout, target.flat.detach().to("cpu"))
    tree = from_state_dict(template, state, path)
    flat = _np_tree_to_flat(target.layout, target.plan, tree)
    return dataclasses.replace(
        target, flat=torch.from_numpy(flat).to(target.flat.device, target.flat.dtype))


register_serialization_state(FlatVector, _flat_state_tree, _flat_from_state)


def piece_stream(tree, bucket_bytes, align: int = 1, flat_output: bool = False,
                 pipelined: bool = False, bucket_output: bool = False):
    """The comm engine's one entry point: what a collective scheme ships
    (buckets.py:412). Returns ``(pieces, key_ids, rebuild)``:

    - ``pieces``: the tree's leaves verbatim (``bucket_bytes is None``,
      the per-leaf wire), or the contiguous f32 buckets of the flattened
      tree (``0`` = one fused bucket, ``N`` = ~N-byte buckets aligned to
      ``align`` elements, ``plan_buckets``). The bucketed wires take
      worker-stacked ``[N, *shape]`` leaves (the collectives'
      convention): each worker's leaves are flattened in tree order into
      its own row, padded to the plan, and cut, so a bucket piece is
      ``[N, size]`` and row w is exactly the bucket JAX ships from worker
      w's device;
    - ``key_ids``: the enumeration index per leaf, or the bucket's START
      OFFSET in the flat buffer per bucket (the PRNG fold value of
      stochastic rounding, kept for the contract);
    - ``rebuild``: maps the per-piece results back to the tree, or with
      ``flat_output=True`` to ONE padded flat f32 vector in the ``align``
      geometry, or with ``bucket_output=True`` (bucketed wires only) to
      the list of per-bucket results. Results come without the worker
      dimension (the replicated aggregate); worker-stacked results (an
      error-feedback contribution) rebuild worker-stacked. The pieces are
      the same for every rebuild.

    ``pipelined=True`` (bucketed wires) keeps the plan, the bytes of
    every bucket and its key id, and changes the dataflow: each bucket is
    assembled from its own leaves (``assemble_bucket``), the pieces come
    in ``readiness_bucket_order``, and the tree is rebuilt leaf by leaf
    (``leaves_from_buckets``); ``rebuild`` takes the results in the
    pieces' order. Its values are the serial stream's, bit for bit."""
    if bucket_output and bucket_bytes is None:
        raise ValueError("bucket_output needs a bucketed wire "
                         "(bucket_bytes is None = per-leaf)")
    leaves, skeleton = tree_flatten(tree)
    if bucket_bytes is None:
        key_ids = tuple(range(len(leaves)))
        if not flat_output:
            return leaves, key_ids, lambda outs: tree_unflatten(skeleton, list(outs))

        def rebuild(outs):
            flat = (torch.cat([o.float().reshape(-1) for o in outs]) if outs
                    else torch.zeros((0,), dtype=torch.float32))
            return pad_flat(flat, plan_buckets(flat.numel(), 0, align=align))

        return leaves, key_ids, rebuild
    layout = tree_layout(tree, stacked=True)
    plan = plan_buckets(layout.total, bucket_bytes, align=align)
    if pipelined:
        order = readiness_bucket_order(plan)
        segs = bucket_leaf_segments(layout, plan)
        pieces = [assemble_bucket(leaves, segs[b], stacked=True) for b in order]

        def rebuild(outs):
            canon = [None] * plan.n_buckets
            for b, o in zip(order, outs):
                canon[b] = o
            if bucket_output:
                return canon
            if flat_output:
                return concat_buckets(canon)
            return leaves_from_buckets(layout, plan, canon)

        return pieces, tuple(plan.starts[b] for b in order), rebuild
    pieces = split_buckets(pad_flat(tree_to_flat(tree, stacked=True), plan), plan)
    if bucket_output:
        rebuild = list
    elif flat_output:
        rebuild = concat_buckets
    else:
        def rebuild(outs):
            return flat_to_tree(layout, concat_buckets(outs))
    return pieces, plan.starts, rebuild
