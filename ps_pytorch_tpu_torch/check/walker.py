"""The recorded step and its collective walk: the measurement half of
pscheck (the port of check/walker.py).

The JAX package traces a step abstractly (``jax.make_jaxpr``) and walks
the equations of the program. Eager PyTorch has no program to walk, so
the port RECORDS one: ``recording()`` runs a step once on real tensors
while a ``TorchDispatchMode`` and two hooks write a ``Tape``, one node
for each of

- an aten op (the dispatch mode; backward ops included, in whichever
  thread autograd runs them);
- a worker-axis call (``check/axes.py``: the recording subclasses of
  ``WorkerAxis``, ``HybridWorkerAxis`` and ``ProcessWorkerAxis``), the
  counterpart of a jaxpr collective primitive;
- a kernel-entry call (``kernel_entry`` of ``ops/_tape.py``, the
  decorator on every wrapper of a hand-written kernel in ``ops/``; the
  hooks live there so that a wrapper imports nothing of the checker),
  which declares the worker-axis
  reduction its kernel performs inside when the caller asked for shared
  scales (``shared_over``: on the stacked backend K2's and K1's absmax
  over a worker-stacked piece IS the pmax).

The ops made inside an axis call or a kernel node are folded into that
node, so one step gives the same collective nodes on the CPU, where the
plain versions run, and on the card, where the kernels run.

A node holds ints, names, shapes and dtypes, never a tensor: the tape
keys each live tensor in a weak identity map (``WeakIdKeyDictionary``),
so an entry dies with its tensor and a reused address never makes a
false edge. Views and in-place ops stay conservative: an output that
shares its input's storage joins that input's storage group, and every
node that writes into a group (an in-place op, an ``out=`` op, a kernel
writing a pool in place) becomes a parent of every later read of the
group. Edges may be added, never lost, as JAX's walker is conservative
inside loops.

Per-device bytes: a stacked tensor holds one row a worker, so a
collective's per-device payload is its operand's bytes over the mesh's
device count (``Tape.devices``); a call over one group of a grid (one
host's ICI rows) then counts its share, and the groups of one grid-wide
collective sum to JAX's per-device figure.

``collect_collectives`` runs JAX's reverse liveness pass from the
updated parameters over the tape's producer edges; ``summarize`` gives
the accounting rows (PSC104) per (kind, axes, dtype).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import torch

from ..ops import _tape
# the hooks live beside the kernels (ops/_tape.py), which import
# nothing of the checker; ``active`` and ``collective_call`` are used
# from here by the recording axes
from ..ops._tape import Payload, _dtype_name, _tensors, active, collective_call  # noqa: F401

# axis method -> the canonical kind of the JAX primitive it ports
# (walker.py:26-36 there: pmean is a psum, the tiled all_to_all an
# all_to_all; ProcessWorkerAxis's absmax_max is the shared scale's pmax,
# all_true the guard's int32 pmin, gather_rows an all_gather)
COLLECTIVE_KINDS: Dict[str, str] = {
    "psum": "psum",
    "pmean": "psum",
    "pmax": "pmax",
    "pmin": "pmin",
    "psum_scatter": "psum_scatter",
    "all_to_all": "all_to_all",
    "all_to_all_tiled": "all_to_all",
    "ppermute": "ppermute",
    "all_gather": "all_gather",
    "absmax_max": "pmax",
    "all_true": "pmin",
    "gather_rows": "all_gather",
}

# reduce-style kinds that consume (sum over) an axis: the family PSC102
# accepts as "the gradient reduction"
REDUCE_KINDS = ("psum", "psum_scatter", "all_to_all")

@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective of the recorded step."""

    kind: str                 # canonical kind (COLLECTIVE_KINDS values)
    axes: Tuple[str, ...]     # mesh axis names it rides
    dtype: str                # payload dtype
    shapes: Tuple[Tuple[int, ...], ...]  # per-worker operand shapes
    bytes: int                # per-device payload bytes
    feeds_params: bool        # reverse-reachable from the updated params

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "axes": list(self.axes),
            "dtype": self.dtype,
            "shapes": [list(s) for s in self.shapes],
            "bytes": self.bytes,
            "feeds_params": self.feeds_params,
        }


@dataclasses.dataclass
class Node:
    """One recorded operation: ``op`` is "aten", "collective" or
    "kernel"; ``name`` the aten overload, the axis method or the kernel
    entry; ``parents`` the nodes whose outputs it read (or whose writes
    into a storage it read); ``kernel`` the kernel's id (K1..K6) on a
    kernel node; ``payloads`` the collectives the node performs (an axis
    call's one, or the reductions a kernel declares).

    What the precision-flow pass (``check/numerics.py``) reads: ``args``,
    the call's arguments by name, a tensor as its ``Ref`` (value id), a
    Python scalar, dtype or int list as itself; ``outs``, the value ids
    of its outputs (written arguments included); ``info``, what the call
    declares beyond its arguments (an axis call's summand count
    ``mult`` and per-axis ``sizes``; a kernel node's ``shared`` axis
    names and ``rows`` grouping)."""

    index: int
    op: str
    name: str
    parents: Tuple[int, ...]
    kernel: Optional[str] = None
    payloads: Tuple[Payload, ...] = ()
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    outs: Tuple[int, ...] = ()
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Ref:
    """A tensor argument of a node: the value id of the tensor it read."""

    vid: int


@dataclasses.dataclass(frozen=True)
class Value:
    """One tensor value of the tape: the node that produced it (-1: from
    outside the step), its dtype and shape, its storage group, and its
    origin: "out" (a node's output), "input" (a step argument: unknown,
    as a jaxpr's invars), or "const" (a tensor the step closes over,
    a jaxpr constvar: ``const`` holds its (min, max) when it has at most
    ``CONST_MAX_ELEMS`` finite numbers, read from the program, not from
    the data)."""

    node: int
    dtype: str
    shape: Tuple[int, ...]
    group: int
    origin: str = "out"
    const: Optional[Tuple[float, float]] = None


# the largest closed-over tensor whose values are read as a constant
# (check/numerics.py:336 there: a jaxpr const up to 4096 elements)
CONST_MAX_ELEMS = 4096


def _arg(x, tape):
    """A node argument as the tape keeps it: a tensor as its ``Ref``, a
    (nested) list of them as a tuple, a Python scalar / dtype / string
    as itself; anything else (devices, layouts, generators) is dropped
    (None)."""
    if isinstance(x, torch.Tensor):
        return Ref(tape._entry(x)[2])
    if isinstance(x, (list, tuple)):
        return tuple(_arg(v, tape) for v in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype)):
        return x
    return None


def _const_of(t: torch.Tensor) -> Optional[Tuple[float, float]]:
    """(min, max) of a small closed-over numeric tensor, or None."""
    if t.numel() == 0 or t.numel() > CONST_MAX_ELEMS or t.is_complex() or t.device.type == "meta":
        return None
    a = t.detach().to("cpu", torch.float64)
    if not bool(torch.isfinite(a).all()):
        return None
    return float(a.min()), float(a.max())


def _storage_ptr(t: torch.Tensor) -> int:
    try:
        s = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return 0
    return s.data_ptr() if s.nbytes() else 0


@functools.lru_cache(maxsize=None)
def _schema_info(func) -> Tuple[Tuple[int, ...], Tuple[str, ...], bool]:
    """(positions and names of written arguments, whether any return
    aliases an argument) of an aten overload."""
    pos, names = [], []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            pos.append(i)
            names.append(a.name)
    aliases = any(r.alias_info is not None for r in func._schema.returns)
    return tuple(pos), tuple(names), aliases


class Tape:
    """The recorded step: ``nodes`` in execution order (the counterpart
    of the ClosedJaxpr's equations) and ``values``, every tensor value
    they read or wrote, by value id. ``devices`` is the mesh's device
    count, the divisor of a stacked operand's bytes; ``axis_sizes`` the
    sizes the recording axes reported (the counterpart of the sizes JAX
    discovers on a ``shard_map``)."""

    def __init__(self, devices: int = 1):
        from torch.utils.weak import WeakIdKeyDictionary

        if devices < 1:
            raise ValueError(f"a tape needs >= 1 device, got {devices}")
        self.devices = int(devices)
        self.nodes: List[Node] = []
        self.values: List[Value] = []
        self.axis_sizes: Dict[str, int] = {}
        self._lock = threading.RLock()
        # tensor (weakly, by identity) -> (producer node or -1, storage
        # group, value id)
        self._vals = WeakIdKeyDictionary()
        self._writers: Dict[int, List[int]] = {}
        self._groups = 0
        self._inputs = None  # ids of the step's argument tensors, once marked
        self.written: Set[int] = set()  # value ids a node wrote in place

    # ------------------------------------------------------------ values
    def _new_group(self) -> int:
        self._groups += 1
        return self._groups

    def _new_value(self, t: torch.Tensor, node: int, group: int, origin: str = "out",
                   const=None) -> int:
        self.values.append(Value(node, _dtype_name(t.dtype), tuple(int(d) for d in t.shape),
                                 group, origin, const))
        return len(self.values) - 1

    def mark_inputs(self, tree) -> None:
        """Declare the step's arguments (any nesting): their tensors are
        unknown inputs; any other tensor the step reads without producing
        it is a constant it closes over."""
        with self._lock:
            ts = _tensors(tree, [])
            self._inputs = {id(t) for t in ts}
            for t in ts:
                self._entry(t)

    def _entry(self, t: torch.Tensor) -> Tuple[int, int, int]:
        e = self._vals.get(t)
        if e is None:
            group = self._new_group()
            if self._inputs is None or id(t) in self._inputs:
                vid = self._new_value(t, -1, group, "input")
            else:
                depth = getattr(_tape._LOCAL, "depth", 0)
                _tape._LOCAL.depth = depth + 1  # reading the constant records nothing
                try:
                    const = _const_of(t)
                finally:
                    _tape._LOCAL.depth = depth
                vid = self._new_value(t, -1, group, "const", const)
            e = (-1, group, vid)
            self._vals[t] = e
        return e

    def _deps(self, ts: Iterable[torch.Tensor]) -> Set[int]:
        deps: Set[int] = set()
        for t in ts:
            prod, group, _ = self._entry(t)
            if prod >= 0:
                deps.add(prod)
            deps.update(self._writers.get(group, ()))
        return deps

    def producers(self, tensors) -> Set[int]:
        """The nodes that produced (or last wrote into the storage of)
        each tensor of ``tensors`` (any nesting; they must be alive)."""
        with self._lock:
            return self._deps(_tensors(tensors, []))

    def value_ids(self, tensors) -> List[int]:
        """The value id of each tensor of ``tensors`` (any nesting; they
        must be alive), in ``_tensors`` order."""
        with self._lock:
            return [self._entry(t)[2] for t in _tensors(tensors, [])]

    def _add(self, op: str, name: str, parents: Set[int], kernel=None,
             payloads=(), args=None, info=None) -> int:
        idx = len(self.nodes)
        self.nodes.append(Node(idx, op, name, tuple(sorted(parents)), kernel,
                               tuple(payloads), args or {}, (), info or {}))
        return idx

    def _outputs(self, idx: int, ins: Sequence[torch.Tensor], outs: Sequence[torch.Tensor],
                 written: Sequence[torch.Tensor], alias_first: bool) -> None:
        """Register node ``idx``'s outputs: a written tensor keeps its
        group and gains a writer; an output sharing an input's storage
        joins that input's group (a view), any other output starts one.
        Each output (and written tensor) becomes a new value of the
        node, in ``outs`` then ``written`` order."""
        wid = {id(t) for t in written}
        vids: List[int] = []
        ptrs = None
        for t in outs:
            if id(t) in wid:
                continue
            group = None
            if alias_first and ins:
                group = self._entry(ins[0])[1]
            elif ins:
                if ptrs is None:
                    ptrs = {}
                    for i in ins:
                        p = _storage_ptr(i)
                        if p:
                            ptrs.setdefault(p, self._entry(i)[1])
                group = ptrs.get(_storage_ptr(t))
            group = group if group is not None else self._new_group()
            vid = self._new_value(t, idx, group)
            self._vals[t] = (idx, group, vid)
            vids.append(vid)
        for t in written:
            _, group, _ = self._entry(t)
            vid = self._new_value(t, idx, group)
            self._vals[t] = (idx, group, vid)
            self._writers.setdefault(group, []).append(idx)
            self.written.add(vid)
            vids.append(vid)
        self.nodes[idx].outs = tuple(vids)

    # ---------------------------------------------------------- recorders
    def record_aten(self, func, args, kwargs, out) -> None:
        pos, names, aliases = _schema_info(func)
        ins = _tensors(args, [])
        _tensors(kwargs, ins)
        written = [args[i] for i in pos if i < len(args) and isinstance(args[i], torch.Tensor)]
        written += [kwargs[n] for n in names if isinstance(kwargs.get(n), torch.Tensor)]
        outs = _tensors(out, [])
        with self._lock:
            named = {}
            for i, a in enumerate(func._schema.arguments):
                if i < len(args):
                    named[a.name] = _arg(args[i], self)
                elif a.name in kwargs:
                    named[a.name] = _arg(kwargs[a.name], self)
            idx = self._add("aten", str(func), self._deps(ins), args=named)
            self._outputs(idx, ins, outs, written, aliases and not written)

    def record_call(self, op: str, name: str, parents: Set[int], ins, outs, written=(),
                    kernel=None, payloads=(), args=None, info=None) -> int:
        with self._lock:
            named = {k: _arg(v, self) for k, v in (args or {}).items()}
            idx = self._add(op, name, parents, kernel, payloads, named, info)
            for ax, size in (info or {}).get("sizes", {}).items():
                self.axis_sizes.setdefault(ax, int(size))
            self._outputs(idx, ins, outs, list(written), False)
        return idx


class _Recorder:
    """The dispatch mode that writes every aten op outside a folded call
    onto the active tape."""

    def __init__(self, tape: Tape):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if not getattr(_tape._LOCAL, "depth", 0):
                    outer.tape.record_aten(func, args, kwargs, out)
                return out

        self.tape = tape
        self.mode = _Mode()


@contextlib.contextmanager
def recording(devices: int = 1):
    """Record every op run inside the block onto a new ``Tape`` (one at a
    time). ``devices`` is the mesh's device count."""
    if _tape.active() is not None:
        raise RuntimeError("a tape is already recording")
    # the dispatch mode's first use imports torch._dynamo, whose import
    # keeps the importing stack's frames (torch.fx.wrap): import it here,
    # outside the recorded step's frames, so none of its tensors is held
    import torch._dynamo  # noqa: F401

    tape = Tape(devices)
    rec = _Recorder(tape)
    _tape.set_active(tape)
    try:
        with rec.mode:
            yield tape
    finally:
        _tape.set_active(None)


def record_step(fn: Callable, *args, devices: int = 1, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under ``recording`` -> ``(tape,
    out)``."""
    with recording(devices) as tape:
        out = fn(*args, **kwargs)
    return tape, out


# ---------------------------------------------------------------- walk

def ancestors(tape: Tape, roots: Iterable[int]) -> Set[int]:
    """Every node reverse-reachable from ``roots`` (the roots included)."""
    seen = set(roots)
    stack = list(seen)
    nodes = tape.nodes
    while stack:
        for p in nodes[stack.pop()].parents:
            if p not in seen:
                seen.add(p)
                stack.append(p)
    return seen


def collect_collectives(tape: Tape, param_nodes: Optional[Iterable[int]] = None
                        ) -> List[Collective]:
    """Every collective of the tape, in execution order. ``param_nodes``
    are the nodes that produced the updated parameters
    (``Tape.producers`` of them); collectives that reach them get
    feeds_params=True. With None every collective is (conservatively)
    marked as feeding params."""
    live = None if param_nodes is None else ancestors(tape, param_nodes)
    out: List[Collective] = []
    for node in tape.nodes:
        for p in node.payloads:
            out.append(Collective(p.kind, p.axes, p.dtype, p.shapes, p.bytes,
                                  live is None or node.index in live))
    return out


def summarize(collectives: Sequence[Collective]) -> List[dict]:
    """Aggregate per (kind, axes, dtype): the stable accounting rows the
    committed contract artifact pins (PSC104)."""
    acc: Dict[Tuple[str, Tuple[str, ...], str], dict] = {}
    for c in collectives:
        key = (c.kind, c.axes, c.dtype)
        row = acc.setdefault(key, {"kind": c.kind, "axes": list(c.axes), "dtype": c.dtype,
                                   "count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += c.bytes
    return [acc[k] for k in sorted(acc)]
