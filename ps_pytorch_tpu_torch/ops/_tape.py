"""The kernels' recording hooks: the state a recorded step
(``check/walker.py``) reads from the kernel wrappers of ``ops/``, kept
apart from the checker so that importing a wrapper loads nothing of it.

``kernel_entry`` decorates the wrapper of each hand-written kernel. With
a tape recording (``_TAPE``, set by ``check.walker.recording``), one call
is one kernel node; with none, the wrapper is one module-level check.
``shared_over`` marks the pieces a kernel quantizes with scales shared
over a worker axis, so that its node declares the pmax it computes
inside. ``collective_call`` is the same hook for a worker-axis method
(``check/axes.py``).

The tape is duck-typed here (``_lock``, ``_deps``, ``record_call``,
``devices``): this module imports nothing of the package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# the active tape, or None: with no tape a kernel entry makes this one
# check (module level, so autograd's device threads see it too)
_TAPE = None
# per thread: the fold depth (ops inside an axis call or a kernel node
# are folded into it) and the axis a kernel's shared scales reduce over
_LOCAL = threading.local()


def active():
    """The tape recording now, or None."""
    return _TAPE


def set_active(tape) -> None:
    global _TAPE
    _TAPE = tape


@dataclasses.dataclass(frozen=True)
class Payload:
    """A collective carried by a tape node, before liveness: (kind, axes,
    dtype, shapes, bytes)."""

    kind: str
    axes: Tuple[str, ...]
    dtype: str
    shapes: Tuple[Tuple[int, ...], ...]
    bytes: int


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tensors(obj, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every tensor in a (nested) list / tuple / dict / dataclass."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


def axis_names(axis) -> Tuple[str, ...]:
    """The mesh axis names a worker axis rides: a recording axis's own,
    the hybrid grid's tuple axis, else the flat worker axis."""
    names = getattr(axis, "names", None)
    if names is None:
        from ..parallel.mesh import WORKER_AXIS

        return (WORKER_AXIS,)
    return tuple(names)


def _fold(call: Callable, args, kwargs):
    depth = getattr(_LOCAL, "depth", 0)
    _LOCAL.depth = depth + 1
    try:
        return call(*args, **kwargs)
    finally:
        _LOCAL.depth = depth


def collective_call(kind: str, axes: Tuple[str, ...], call: Callable, args, kwargs,
                    operands: Sequence[torch.Tensor], nbytes: Callable[[torch.Tensor], int],
                    name: str, mult: Optional[int] = None,
                    sizes: Optional[Dict[str, int]] = None):
    """Run ``call(*args, **kwargs)`` as one collective node of the
    active tape (or plainly without one): one payload per operand dtype
    (JAX's walker splits a mixed-dtype payload the same way), each
    ``nbytes(operand)`` per device. ``mult`` is the axis's summand count
    (a psum's multiplier) and ``sizes`` the size of each mesh axis it
    rides, where the axis knows them."""
    tape = _TAPE
    if tape is None or getattr(_LOCAL, "depth", 0):
        return call(*args, **kwargs)
    ins = _tensors(args, [])
    _tensors(kwargs, ins)
    with tape._lock:
        parents = tape._deps(ins)
    out = _fold(call, args, kwargs)
    tape.record_call("collective", name, parents, ins, _tensors(out, []),
                     payloads=payloads_by_dtype(kind, axes, operands, nbytes),
                     args={"x": operands[0] if len(operands) == 1 else list(operands)},
                     info={"axes": tuple(axes), "mult": mult, "sizes": dict(sizes or {})})
    return out


def payloads_by_dtype(kind: str, axes: Tuple[str, ...], operands: Sequence[torch.Tensor],
                      nbytes: Callable[[torch.Tensor], int]) -> List[Payload]:
    """One ``Payload`` per operand dtype, its shapes and summed bytes."""
    groups: Dict[str, list] = {}
    for t in operands:
        g = groups.setdefault(_dtype_name(t.dtype), [[], 0])
        g[0].append(tuple(int(d) for d in t.shape[1:]) if t.dim() else ())
        g[1] += int(nbytes(t))
    return [Payload(kind, tuple(axes), dtype, tuple(shapes), b)
            for dtype, (shapes, b) in sorted(groups.items())]


class _Local:
    __slots__ = ("attr", "value", "prev")

    def __init__(self, attr: str, value):
        self.attr, self.value = attr, value

    def __enter__(self):
        self.prev = getattr(_LOCAL, self.attr, None)
        setattr(_LOCAL, self.attr, self.value)

    def __exit__(self, *exc):
        setattr(_LOCAL, self.attr, self.prev)


_NULL = contextlib.nullcontext()


def shared_over(axis):
    """Inside this block a kernel node's pieces are worker-stacked over
    ``axis`` and their scales shared by its workers: the node declares
    the pmax its kernel computes inside (one f32 payload a piece). A
    null context when no tape records, or with no axis (local scales)."""
    if _TAPE is None or axis is None:
        return _NULL
    return _Local("shared", axis)


def worker_rows(n: int):
    """Inside this block a kernel node's pieces come in runs of ``n``:
    each run is one worker-stacked value cut into ``n`` groups of rows
    (a worker each, or the workers of one host), each group quantized
    with its own scale (the two-round wire's round 2, the hierarchical
    wire's grouped rounds, on the stacked backend). The node declares
    one quantization site a run, as JAX's per-device program has one. A
    null context when no tape records."""
    if _TAPE is None or n <= 1:
        return _NULL
    return _Local("rows", int(n))


def _shared_pmax(tape, pieces, out) -> List[Payload]:
    """The pmax payloads a shared-scale kernel node declares: per piece
    its scale's bytes, over the piece's share of the mesh's devices."""
    axis = getattr(_LOCAL, "shared", None)
    if axis is None:
        return []
    names = axis_names(axis)
    payloads = []
    for x, res in zip(pieces, out):
        scale = res[1]
        rows = int(x.shape[0]) if x.dim() else 1
        payloads.append(Payload("pmax", names, _dtype_name(scale.dtype),
                                (tuple(int(d) for d in scale.shape),),
                                scale.numel() * scale.element_size() * rows // tape.devices))
    return payloads


def kernel_entry(kernel: str, shared: bool = False, writes: Tuple[int, ...] = (),
                 numerics: Optional[str] = None):
    """Decorate the wrapper of a hand-written kernel (``kernel`` its id,
    K1..K6): with a tape recording, one call is one kernel node with the
    call's tensors as inputs and its results (and the arguments at
    positions ``writes``, written in place) as outputs; everything the
    call runs inside folds into the node. ``shared``: the entry takes a
    list of pieces whose scales may be shared over a worker axis
    (``shared_over``), and then declares that pmax. ``numerics`` names
    the precision-flow events the node declares, once for both devices
    (``check/numerics.py`` ``KERNEL_EVENTS``: a quantize's int8 site at
    peak 127 and its absmax root, K3's int32 accumulation and lattice
    requantize). With no tape the wrapper is one module-level check."""

    def wrap(fn):
        name = fn.__name__
        params = tuple(inspect.signature(fn).parameters)

        @functools.wraps(fn)
        def entry(*args, **kwargs):
            tape = _TAPE
            if tape is None or getattr(_LOCAL, "depth", 0):
                return fn(*args, **kwargs)
            ins = _tensors(args, [])
            _tensors(kwargs, ins)
            written = [args[i] for i in writes if i < len(args)]
            with tape._lock:
                parents = tape._deps(ins)
            out = _fold(fn, args, kwargs)
            payloads = _shared_pmax(tape, list(args[0]), out) if shared else []
            axis = getattr(_LOCAL, "shared", None) if shared else None
            named = dict(zip(params, args))
            named.update(kwargs)
            info = {"numerics": numerics,
                    "shared": axis_names(axis) if axis is not None else None,
                    "rows": getattr(_LOCAL, "rows", None)}
            tape.record_call("kernel", name, parents, ins, _tensors(out, []), written,
                             kernel=kernel, payloads=payloads, args=named, info=info)
            return out

        return entry

    return wrap
