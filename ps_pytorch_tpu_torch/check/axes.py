"""Recording worker axes: the tape's collective nodes.

Each class subclasses one worker axis of ``parallel/mesh.py`` (the step
builders test ``isinstance(axis, ProcessWorkerAxis)`` and the hybrid
grid's type, so a wrapper would change the path they take), names the
mesh axes it rides (``names``: JAX's axis names, e.g. ``("workers",)``,
``("model",)``, the grid's ``("dcn", "workers")``) and runs every
collective method through ``walker.collective_call``: with a tape
recording, one call is one collective node, the real method's ops
folded into it; with none, the real method alone.

Per-device bytes are the operand's bytes over the devices it holds a
row for (``span``, by default the tape's device count: a stacked tensor
holds one row a worker); ``all_true``'s flag crosses
as one int32 a device (``ProcessWorkerAxis.all_true``); a process
axis's operands hold this process's rows, one a local worker.

``HybridWorkerAxis``'s ``dcn`` / ``ici`` sub-axes record under their own
names (``DCN_AXIS``, ``WORKER_AXIS``), as JAX's hierarchical wire names
the two axes of its tuple.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..parallel.mesh import (
    DCN_AXIS,
    WORKER_AXIS,
    GRIDS,
    HybridWorkerAxis,
    ProcessHybridAxis,
    ProcessWorkerAxis,
    WorkerAxis,
)
from . import walker

# the methods that are collectives (walker.COLLECTIVE_KINDS), per class
_STACKED = ("psum", "pmax", "pmin", "pmean", "psum_scatter", "all_to_all",
            "all_to_all_tiled", "ppermute", "all_gather", "all_true")
_PROCESS = tuple(m for m in _STACKED if m != "all_to_all_tiled") + ("absmax_max",
                                                                  "gather_rows")


def _stacked_bytes(axis):
    def nbytes(t: torch.Tensor) -> int:
        tape = walker.active()
        span = axis.span or (tape.devices if tape is not None else 1)
        return t.numel() * t.element_size() // span

    return nbytes


# the int32 operand ``all_true``'s flag crosses as: a meta tensor, made
# once, so describing it records no op
_FLAG = torch.empty((), dtype=torch.int32, device="meta")


def _process_bytes(axis):
    def nbytes(t: torch.Tensor) -> int:
        rows = axis.local_size if t.dim() and t.shape[0] == axis.local_size else 1
        return t.numel() * t.element_size() // rows

    return nbytes


def _sizes(axis) -> dict:
    """The size of each mesh axis a recording axis rides, where it knows
    them: a one-name axis its own size, the hybrid grid (stacked or over
    processes) its hosts and per-host workers (JAX's tuple axis ``(dcn,
    workers)``)."""
    if isinstance(axis, GRIDS):
        return {DCN_AXIS: axis.hosts, WORKER_AXIS: axis.per_host}
    if len(axis.names) == 1:
        return {axis.names[0]: axis.size}
    return {}


def _recorded(method: str, base):
    real = getattr(base, method)
    kind = walker.COLLECTIVE_KINDS[method]

    def call(self, x, *args, **kwargs):
        if walker.active() is None:
            return real(self, x, *args, **kwargs)
        if method == "all_true":
            op, nbytes = _FLAG, (lambda _: 4 * max(x.numel(), 1))
        else:
            op = x
            nbytes = (_process_bytes(self) if isinstance(self, ProcessWorkerAxis)
                      else _stacked_bytes(self))
        return walker.collective_call(kind, self.names, real, (self, x) + args, kwargs, [op],
                                      nbytes, f"{'.'.join(self.names)}.{method}",
                                      mult=self.size, sizes=_sizes(self))

    call.__name__ = method
    call.__doc__ = real.__doc__
    return call


def _install(cls, base, methods):
    for m in methods:
        setattr(cls, m, _recorded(m, base))
    return cls


@dataclasses.dataclass(frozen=True)
class RecordingWorkerAxis(WorkerAxis):
    """A ``WorkerAxis`` whose collectives are tape nodes over ``names``.
    ``span`` is the number of the mesh's devices its operands hold a row
    for (default: all of them, ``Tape.devices``): an LM step's dp axis
    reduces one value a dp row, which every tp shard of the row holds."""

    names: Tuple[str, ...] = (WORKER_AXIS,)
    span: Optional[int] = None


_install(RecordingWorkerAxis, WorkerAxis, _STACKED)


@dataclasses.dataclass(frozen=True)
class RecordingHybridAxis(HybridWorkerAxis):
    """The hybrid grid, recording: the grid's own collectives ride the
    tuple axis ``(DCN_AXIS, WORKER_AXIS)``; ``dcn`` / ``ici`` are
    recording axes of their own names."""

    names: Tuple[str, ...] = (DCN_AXIS, WORKER_AXIS)
    span: Optional[int] = None

    @property
    def dcn(self) -> WorkerAxis:
        return RecordingWorkerAxis(self.hosts, names=(DCN_AXIS,))

    @property
    def ici(self) -> WorkerAxis:
        return RecordingWorkerAxis(self.per_host, names=(WORKER_AXIS,))


_install(RecordingHybridAxis, HybridWorkerAxis, _STACKED)


class RecordingProcessAxis(ProcessWorkerAxis):
    """A ``ProcessWorkerAxis`` whose collectives (and the shared scale's
    ``absmax_max``, the rows' ``gather_rows``) are tape nodes."""

    def __init__(self, size: int, group=None, names: Tuple[str, ...] = (WORKER_AXIS,)):
        super().__init__(size, group)
        self.names = tuple(names)


_install(RecordingProcessAxis, ProcessWorkerAxis, _PROCESS)


class RecordingProcessHybridAxis(ProcessHybridAxis):
    """The hybrid grid over processes, recording: the grid's collectives
    ride the tuple axis; ``dcn`` is a recording process axis and ``ici``
    a recording stacked one, of their own names."""

    def __init__(self, size: int, hosts: int, group=None):
        super().__init__(size, hosts, group)
        self._dcn = RecordingProcessAxis(hosts, group, names=(DCN_AXIS,))
        self._dcn._copy_s = self._copy_s

    @property
    def ici(self) -> WorkerAxis:
        return RecordingWorkerAxis(self.per_host, names=(WORKER_AXIS,))


_install(RecordingProcessHybridAxis, ProcessWorkerAxis, _PROCESS)


def recording_axis(axis, names: Tuple[str, ...] = (WORKER_AXIS,)):
    """The recording twin of ``axis`` (a ``WorkerAxis``, the hybrid grid
    or a ``ProcessWorkerAxis``), riding ``names`` (the grid keeps its
    tuple axis)."""
    if isinstance(axis, ProcessHybridAxis):
        return RecordingProcessHybridAxis(axis.size, axis.hosts, axis.group)
    if isinstance(axis, ProcessWorkerAxis):
        return RecordingProcessAxis(axis.size, axis.group, names)
    if isinstance(axis, HybridWorkerAxis):
        return RecordingHybridAxis(axis.size, hosts=axis.hosts, per_host=axis.per_host)
    if isinstance(axis, WorkerAxis):
        return RecordingWorkerAxis(axis.size, names=tuple(names))
    raise TypeError(f"not a worker axis: {axis!r}")
