"""Elastic membership (the port of resilience/elastic.py): the geometry
manifest, the resume-reshape and the adaptive partial-aggregation
controller (``AdaptiveMaskController``).

The trainer drops an ``elastic.json`` beside its checkpoints: the mesh
geometry that wrote each step (``steps[str(step)]``) and, at the top
level, the directory's latest writer. The fields and the file are the
JAX package's, so either package's ``--resume`` of the other's directory
reads the same record.

A checkpoint the manifest says another geometry wrote is reshaped on the
host (``reshape_raw_state``, elastic.py:437) before it is restored. The
interchange form is the replicated TREE, which checkpoints already store
for params:

- params pass through: they are tree-shaped in the file;
- optimizer moments under ZeRO-1 are the workers' ``[N, shard]`` regions
  of one padded flat vector (``ps._worker_region``); inverting that
  carving and re-carving under the target's ``BucketPlan`` is a
  rearrangement of the same f32 bits, so the moments are bit for bit the
  same across N -> M and across replicated <-> sharded;
- error-feedback residuals are summed over the workers and split evenly
  over the new ones (exact for a power-of-two M), and only when worker
  identity is lost (N or the placement changes, or the ZeRO-1 padded
  length);
- local BatchNorm statistics are averaged and broadcast, only when the
  BN mode's locality or (local) N changes;
- the step and the guard counters pass through.

The arithmetic is numpy's, as in the JAX package, so both packages'
reshapes of one file agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger("ps_pytorch_tpu_torch")

GEOMETRY_FILE = "elastic.json"
GEOMETRY_VERSION = 1


@dataclasses.dataclass(frozen=True)
class MeshGeometry:
    """What about a run's mesh and placement decides the shapes of its
    checkpointed state (elastic.py:91). ``state_layout`` rides along for
    the record: checkpoints are tree-shaped in both layouts."""

    num_workers: int
    opt_placement: str = "replicated"
    bucket_bytes: Optional[int] = None
    quant_block_size: int = 0
    compress: Optional[str] = None
    error_feedback: bool = False
    bn_mode: str = "pmean"
    state_layout: str = "flat"
    dcn_hosts: int = 1

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = GEOMETRY_VERSION
        return d

    @classmethod
    def from_json(cls, d: dict) -> "MeshGeometry":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def geometry_of(cfg) -> MeshGeometry:
    """The manifest entry of a live PSConfig."""
    return MeshGeometry(
        num_workers=cfg.num_workers,
        opt_placement=cfg.opt_placement,
        bucket_bytes=cfg.bucket_bytes,
        quant_block_size=cfg.quant_block_size,
        compress=None if cfg.compress in (None, "none") else cfg.compress,
        error_feedback=cfg.error_feedback,
        bn_mode=cfg.bn_mode,
        state_layout=cfg.state_layout,
        dcn_hosts=cfg.dcn_hosts,
    )


def save_geometry(model_dir: str, geom: MeshGeometry, step: Optional[int] = None) -> str:
    """Atomically write or merge the manifest: the top level is the
    latest writer, ``steps[str(step)]`` the writer of that checkpoint. A
    torn manifest is rewritten, never fatal."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, GEOMETRY_FILE)
    data = geom.to_json()
    steps = {}
    if os.path.exists(path):
        try:
            with open(path, "r", encoding="utf-8") as f:
                steps = json.load(f).get("steps", {}) or {}
        except (OSError, ValueError):
            steps = {}
    if step is not None:
        steps[str(step)] = geom.to_json()
    if steps:
        data["steps"] = steps
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_geometry(model_dir: str, step: Optional[int] = None) -> Optional[MeshGeometry]:
    """The geometry that wrote checkpoint ``step`` (None: the latest
    writer), or None when it cannot be known: no manifest, no entry for
    the step, or an unreadable manifest."""
    path = os.path.join(model_dir, GEOMETRY_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if step is not None:
            entry = (data.get("steps") or {}).get(str(step))
            return None if entry is None else MeshGeometry.from_json(entry)
        return MeshGeometry.from_json(data)
    except (OSError, ValueError, TypeError) as e:
        logger.warning("elastic manifest %s is unreadable (%s); treating the dir "
                       "as manifest-less", path, e)
        return None


def _quant_block(geom: MeshGeometry) -> int:
    if geom.compress in ("int8", "int8_2round") and geom.quant_block_size:
        return geom.quant_block_size
    return 1


def needs_reshape(src: MeshGeometry, dst: MeshGeometry) -> bool:
    """Would a checkpoint written under ``src`` mis-load into a
    ``dst``-geometry state: wrong shapes, or (ZeRO-1) the same shapes
    with another worker-to-region mapping (elastic.py:205)."""
    if src.opt_placement != dst.opt_placement:
        return True
    n_changed = src.num_workers != dst.num_workers
    if src.opt_placement == "sharded":
        if n_changed:
            return True
        if (src.bucket_bytes or 0) != (dst.bucket_bytes or 0):
            return True
        if _quant_block(src) != _quant_block(dst):
            return True
    if n_changed and (src.error_feedback or dst.error_feedback):
        return True
    src_local = src.bn_mode == "local"
    dst_local = dst.bn_mode == "local"
    return src_local != dst_local or (n_changed and src_local)


# ------------------------------------------------------------ geometry math

def _ps_config(geom: MeshGeometry):
    """A PSConfig of this geometry, so the bucket plans come from the
    step's own ``_sharded_plan`` / ``wire_align``: the reshape cannot
    drift from the carving the live run used. Imported here: parallel.ps
    imports resilience.guard, whose package imports this module."""
    from ..parallel.ps import PSConfig

    return PSConfig(num_workers=geom.num_workers, opt_placement=geom.opt_placement,
                    bucket_bytes=geom.bucket_bytes, quant_block_size=geom.quant_block_size,
                    compress=geom.compress, error_feedback=geom.error_feedback,
                    bn_mode=geom.bn_mode, state_layout=geom.state_layout)


def _sharded_plan(geom: MeshGeometry, total: int):
    from ..parallel.ps import _sharded_plan as plan

    return plan(_ps_config(geom), total)


def _regions_to_flat(stacked, plan, n: int) -> np.ndarray:
    """The inverse of ``ps._worker_region``: the stacked per-worker rows
    (row w: its 1/n slice of every bucket, in bucket order) back into the
    one padded flat vector. A rearrangement of the same bits."""
    stacked = np.asarray(stacked)
    flat = np.zeros((plan.padded_total,), stacked.dtype)
    off = 0
    for start, size in zip(plan.starts, plan.sizes):
        s = size // n
        for w in range(n):
            flat[start + w * s:start + (w + 1) * s] = stacked[w, off:off + s]
        off += s
    return flat


def _flat_to_regions(flat, plan, n: int) -> np.ndarray:
    """``ps._worker_region`` of every worker at once, on the host."""
    flat = np.asarray(flat)
    out = np.empty((n, plan.padded_total // n), flat.dtype)
    off = 0
    for start, size in zip(plan.starts, plan.sizes):
        s = size // n
        for w in range(n):
            out[w, off:off + s] = flat[start + w * s:start + (w + 1) * s]
        off += s
    return out


def _tree_template(layout, length: int):
    from ..parallel.buckets import _np_flat_to_tree

    return _np_flat_to_tree(layout, np.zeros((length,), np.float32))


def _dict_to_flat(state_dict, layout, plan) -> np.ndarray:
    """A tree-shaped state dict (the interchange form) -> one padded flat
    vector in ``plan``'s geometry."""
    from ..parallel.buckets import _np_tree_to_flat
    from ..utils.serialization import from_state_dict

    tree = from_state_dict(_tree_template(layout, plan.padded_total), state_dict)
    return _np_tree_to_flat(layout, plan, tree)


def _flat_to_dict(flat, layout):
    """A padded (or exactly ``total``) flat vector -> a tree-shaped state
    dict."""
    from ..parallel.buckets import _np_flat_to_tree
    from ..utils.serialization import to_state_dict

    return to_state_dict(_np_flat_to_tree(layout, flat))


# ------------------------------------------------------- opt_state reshape

def _opt_to_canonical(node, src_plan, n: int, layout):
    """A stored ZeRO-1 opt_state dict: every stacked ``[n, shard]``
    moment becomes a tree-shaped dict (the region inversion), every
    ``[n]`` scalar (the step count, the same on every worker) its row 0."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _opt_to_canonical(v, src_plan, n, layout) for k, v in node.items()}
    arr = np.asarray(node)
    if arr.ndim == 2 and arr.shape == (n, src_plan.padded_total // n):
        return _flat_to_dict(_regions_to_flat(arr, src_plan, n), layout)
    if arr.ndim == 1 and arr.shape[0] == n:
        return arr[0]
    return node


def _opt_from_canonical(canon, tgt_node, dst_plan, m: int, layout):
    """Walk the target's (fresh ZeRO-1) opt_state dict beside the
    canonical form: tree-shaped moments are flattened and carved into the
    target's stacked regions, scalars broadcast to ``[m]``."""
    if tgt_node is None:
        return None
    if isinstance(tgt_node, dict):
        if not isinstance(canon, dict) or set(tgt_node) - set(canon):
            raise ValueError(
                "elastic reshape: checkpointed optimizer state does not match the "
                "target optimizer's structure — resume with the same --optimizer the "
                "checkpoint was written with")
        return {k: _opt_from_canonical(canon[k], tgt_node[k], dst_plan, m, layout)
                for k in tgt_node}
    tarr = np.asarray(tgt_node)
    if tarr.ndim == 2 and tarr.shape == (m, dst_plan.padded_total // m):
        return _flat_to_regions(_dict_to_flat(canon, layout, dst_plan), dst_plan, m)
    if tarr.ndim == 1 and tarr.shape[0] == m:
        return np.broadcast_to(np.asarray(canon), (m,)).copy()
    return canon


# ------------------------------------------------------ EF residual reshape

def _ef_to_canonical(raw_comm, src: MeshGeometry, layout):
    """Per-worker residuals -> ONE tree-shaped total (the sum over the
    workers: what EF owes the next updates)."""
    if src.opt_placement == "sharded":
        return _flat_to_dict(np.asarray(raw_comm, np.float32).sum(axis=0), layout)

    def leaf_sum(node):
        if isinstance(node, dict):
            return {k: leaf_sum(v) for k, v in node.items()}
        return np.asarray(node, np.float32).sum(axis=0)

    return leaf_sum(raw_comm)


def _ef_from_canonical(canon, dst: MeshGeometry, layout):
    """The total residual -> per-worker rows of total / M (the sum is
    kept; the per-worker split is not)."""
    m = dst.num_workers
    if dst.opt_placement == "sharded":
        flat = _dict_to_flat(canon, layout, _sharded_plan(dst, layout.total)) / np.float32(m)
        return np.tile(flat[None, :], (m, 1))

    def leaf_rows(node):
        if isinstance(node, dict):
            return {k: leaf_rows(v) for k, v in node.items()}
        leaf = np.asarray(node, np.float32) / np.float32(m)
        return np.broadcast_to(leaf, (m,) + leaf.shape).copy()

    return leaf_rows(canon)


# ---------------------------------------------------------- bn-stats reshape

def _bn_to_canonical(raw_bs, local: bool):
    if not local:
        return raw_bs

    def leaf_mean(node):
        if isinstance(node, dict):
            return {k: leaf_mean(v) for k, v in node.items()}
        return np.asarray(node).mean(axis=0)

    return leaf_mean(raw_bs)


def _bn_from_canonical(canon, local: bool, m: int):
    if not local:
        return canon

    def leaf_stack(node):
        if isinstance(node, dict):
            return {k: leaf_stack(v) for k, v in node.items()}
        arr = np.asarray(node)
        return np.broadcast_to(arr, (m,) + arr.shape).copy()

    return leaf_stack(canon)


# --------------------------------------------------------------- entry point

def reshape_raw_state(raw: dict, src: MeshGeometry, dst_cfg, target) -> dict:
    """A raw checkpoint dict (``checkpoint.load_checkpoint_raw``) written
    under ``src`` -> one that ``checkpoint.restore_from_raw(target, ...)``
    loads for a run configured as ``dst_cfg`` (a PSConfig). ``target`` is
    the new geometry's state in its checkpoint form
    (``Trainer.checkpoint_state()``: the JAX PSTrainState leaf for leaf).

    params, step and guard_state pass through; opt_state moments are
    rearranged bit for bit; EF residuals and local BN stats are
    redistributed only where worker identity is lost (see the module
    text)."""
    from ..parallel.buckets import FlatVector, tree_layout
    from ..utils.serialization import to_state_dict

    dst = geometry_of(dst_cfg)
    layout = (target.params.layout if isinstance(target.params, FlatVector)
              else tree_layout(target.params))
    out = dict(raw)

    opt_raw = raw.get("opt_state")
    if opt_raw is not None:
        canon = opt_raw
        if src.opt_placement == "sharded":
            canon = _opt_to_canonical(opt_raw, _sharded_plan(src, layout.total),
                                      src.num_workers, layout)
        if dst.opt_placement == "sharded":
            canon = _opt_from_canonical(canon, to_state_dict(target.opt_state),
                                        _sharded_plan(dst, layout.total), dst.num_workers,
                                        layout)
        out["opt_state"] = canon

    # a present-vs-disabled mismatch is left to restore_from_raw's error
    comm = raw.get("comm_state")
    if comm is not None and target.comm_state is not None:
        identity_kept = (
            src.num_workers == dst.num_workers
            and src.opt_placement == dst.opt_placement
            and (src.opt_placement != "sharded"
                 or _sharded_plan(src, layout.total).padded_total
                 == _sharded_plan(dst, layout.total).padded_total))
        if not identity_kept:
            out["comm_state"] = _ef_from_canonical(_ef_to_canonical(comm, src, layout), dst,
                                                   layout)

    bs = raw.get("batch_stats")
    if bs is not None:
        src_local, dst_local = src.bn_mode == "local", dst.bn_mode == "local"
        if not (src_local == dst_local and (not src_local
                                            or src.num_workers == dst.num_workers)):
            out["batch_stats"] = _bn_from_canonical(_bn_to_canonical(bs, src_local),
                                                    dst_local, dst.num_workers)
    return out


# ----------------------------------------------------- adaptive aggregation

class AdaptiveMaskController:
    """The host half of adaptive partial aggregation (elastic.py:522): the
    straggler watchdog's per-step walltimes pick the next window's
    aggregation count inside ``[num_aggregate_min, num_aggregate_max]``.

    - a window with slow steps (walltime above ``threshold_s``, the
      watchdog's own) shrinks the count by their number, floored at min;
    - a clean window grows it by one, ceilinged at max.

    Every change emits one ``mask_adapt`` record through ``event_sink``;
    the step clamps the count again on the device. Over processes,
    ``consensus`` (the trainer's: the min over processes, an int32
    collective) is applied at each window close, whose step every process
    reaches together (the windows are step-counted); ``slow_steps`` stays
    the local observation."""

    def __init__(self, cfg, threshold_s: Optional[float], window: int,
                 event_sink: Optional[Callable[[dict], None]] = None,
                 consensus: Optional[Callable[[int], int]] = None):
        if not cfg.adaptive_aggregate:
            raise ValueError("AdaptiveMaskController needs num_aggregate_min/max set")
        if window < 1:
            raise ValueError(f"adapt window must be >= 1, got {window}")
        if threshold_s is None or threshold_s <= 0:
            raise ValueError(
                "adaptive aggregation needs the straggler watchdog's threshold (arm it "
                "with --mode/--kill-threshold): the controller consumes its per-step "
                "walltimes")
        self.lo = cfg.num_aggregate_min
        self.hi = cfg.num_aggregate_max
        self.count = int(cfg.initial_aggregate)
        self.threshold_s = float(threshold_s)
        self.window = int(window)
        self.adaptations = 0
        self._sink = event_sink
        self._consensus = consensus
        self._steps = 0
        self._slow = 0
        self._win_start: Optional[int] = None

    def record(self, step_no: int, seconds: float) -> int:
        """One step's walltime; returns the count the NEXT step uses (it
        changes only at window boundaries)."""
        if self._win_start is None:
            self._win_start = step_no
        self._steps += 1
        if seconds > self.threshold_s:
            self._slow += 1
        if self._steps >= self.window:
            self._close_window(step_no)
        return self.count

    def _close_window(self, step_no: int) -> None:
        old = self.count
        new = max(self.lo, old - self._slow) if self._slow else min(self.hi, old + 1)
        if self._consensus is not None:
            new = min(max(int(self._consensus(new)), self.lo), self.hi)
        if new != old:
            self.adaptations += 1
            logger.info("mask_adapt: aggregation count %d -> %d after window %d-%d "
                        "(%d/%d slow steps)", old, new, self._win_start, step_no,
                        self._slow, self._steps)
            if self._sink is not None:
                self._sink({"kind": "mask_adapt", "step": step_no,
                            "window_start": self._win_start, "from": old, "to": new,
                            "slow_steps": self._slow, "window_steps": self._steps})
        self.count = new
        self._steps = 0
        self._slow = 0
        self._win_start = None
