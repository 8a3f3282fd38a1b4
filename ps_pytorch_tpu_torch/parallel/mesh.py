"""The stacked worker backend (the role of parallel/mesh.py's ``make_mesh``
and of the axis primitives inside ``shard_map``).

The JAX package runs one program per device of a mesh axis ``workers``
and reduces across it with ``lax.psum`` / ``pmax`` / ``pmin`` /
``pmean``. NCCL refuses two ranks on one GPU, so on the one H100 the
port holds N virtual workers on one device instead: every per-worker
quantity carries a leading worker dimension ``[N, ...]`` and a reduction
over that dimension is the collective. A reduced value comes back
without the worker dimension: one copy, which every worker reads, as the
replicated result of a JAX collective is.

``ppermute`` moves rows between workers (the sequence ring's K/V
rotation); ``Mesh2D`` is the (dp x sp) grid of the LM training step;
``HybridWorkerAxis`` (``make_hybrid_mesh``) the (hosts x per_host) grid
of the hierarchical DCN x ICI gradient wire.

This is the analogue of the reference's 8-device virtual CPU mesh.

``ProcessWorkerAxis`` is the same axis spread over the processes of a
``torch.distributed`` group (the reference's MPI job: SURVEY.md section
1). Each process holds ``local_size = N / world`` stacked workers, and a
collective is the local reduction over them, one ``torch.distributed``
call over the group, then the result for the local rows. Where the order
of a float sum matters, the worker rows are gathered and reduced with
the stacked backend's own op, so a run over processes gives the stacked
run's bits. ``initialize_multihost`` joins the group (NCCL for a card,
gloo for the CPU).

``ProcessHybridAxis`` is the hybrid grid over processes (JAX's
multi-process ``make_hybrid_mesh``, one host a process granule): each
process holds ``hosts / world`` whole hosts, its tuple-axis collectives
are ``ProcessWorkerAxis``'s, its DCN axis crosses the processes and its
ICI axis stays inside one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

WORKER_AXIS = "workers"
DCN_AXIS = "dcn"


@dataclasses.dataclass(frozen=True)
class WorkerAxis:
    """N virtual workers stacked on the leading dimension of every
    per-worker tensor."""

    size: int

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"a worker axis needs >= 1 worker, got {self.size}")

    # this process's workers are ids [first, first + local_size): all
    first = 0

    @property
    def local_size(self) -> int:
        """Workers stacked in this process: all of them."""
        return self.size

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a per-worker ``[N, ...]`` tensor that
        every process computes alike: all of them."""
        return x

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool every process agrees on (one process: the flag)."""
        return flag

    def _check(self, x: torch.Tensor) -> None:
        if x.dim() == 0 or x.shape[0] != self.size:
            raise ValueError(
                f"expected a worker-stacked tensor [{self.size}, ...], got "
                f"{tuple(x.shape)}"
            )

    def axis_index(self, device=None) -> torch.Tensor:
        """Each worker's index, ``[N]`` int64 (``lax.axis_index``)."""
        return torch.arange(self.size, device=device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over workers. Integer payloads stay in their own width
        (an int32 psum sums in int32, as XLA's does)."""
        self._check(x)
        if not x.dtype.is_floating_point:
            return x.sum(0, dtype=x.dtype)
        return x.sum(0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.amax(0)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.amin(0)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.mean(0)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum_scatter(x, axis, tiled=True)``: worker-stacked
        ``[N, L, *rest]`` with ``L`` a multiple of N -> ``[N, L/N, *rest]``,
        row w the sum over workers of their w-th slice. Integer payloads
        sum in their own width, as ``psum`` does."""
        self._check(x)
        n = self.size
        if x.dim() < 2 or x.shape[1] % n:
            raise ValueError(f"psum_scatter needs [{n}, L, ...] with L % {n} == 0, "
                             f"got {tuple(x.shape)}")
        parts = x.reshape((n, n, x.shape[1] // n) + tuple(x.shape[2:]))
        return parts.sum(0, dtype=x.dtype)

    def split_batch(self, tokens: torch.Tensor, over: str) -> torch.Tensor:
        """``[B, ...]`` -> ``[N, B / N, ...]``: the batch cut over the
        workers, each row one worker's (``over`` names them in the
        error)."""
        b = tokens.shape[0]
        if b % self.size:
            raise ValueError(f"batch {b} does not split over {over}")
        return tokens.reshape((self.size, b // self.size) + tuple(tokens.shape[1:]))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
        tiled=True)`` on per-worker ``[n, s]`` payloads: worker-stacked
        ``[N, n, s]`` (n == N, row j of worker w is w's slice of region j)
        -> ``[n(region), N(sender), s]``, where entry ``[w, j]`` is what
        worker j sent to worker w. A transposed view: no bytes move on
        one device."""
        self._check(x)
        if x.dim() < 2 or x.shape[1] != self.size:
            raise ValueError(f"all_to_all needs [{self.size}, {self.size}, ...], "
                             f"got {tuple(x.shape)}")
        return x.transpose(0, 1)

    def all_to_all_tiled(self, x: torch.Tensor, split_axis: int,
                         concat_axis: int) -> torch.Tensor:
        """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
        on worker-stacked ``x [N, *s]`` (the axes index ``s``): every
        worker cuts its ``split_axis`` into N chunks and sends chunk w to
        worker w, which concatenates what it receives, in sender order,
        along ``concat_axis``. The MoE dispatch (split 0, concat 1) takes
        ``[N, E, C, D]`` to ``[N, E / N, N C, D]``: worker w's slot ``i C +
        c`` of its local expert e is sender i's slot c of expert ``w E / N
        + e``; its inverse (split 1, concat 0) puts every slot back. A
        permuted copy on one device."""
        self._check(x)
        n = self.size
        if split_axis == concat_axis or not (0 <= split_axis < x.dim() - 1
                                             and 0 <= concat_axis < x.dim() - 1):
            raise ValueError(f"all_to_all_tiled: bad axes {split_axis}, {concat_axis} "
                             f"for a [{n}, ...] tensor of {x.dim()} dims")
        if x.shape[1 + split_axis] % n:
            raise ValueError(f"all_to_all_tiled: dim {x.shape[1 + split_axis]} does not "
                             f"split over {n} workers")
        # [src, ..., dst, chunk, ...] -> [dst, src, ..., chunk, ...]
        y = x.unflatten(1 + split_axis, (n, -1)).movedim(1 + split_axis, 0)
        # the senders go right before the concat axis, then fold into it
        return y.movedim(1, 1 + concat_axis).flatten(1 + concat_axis, 2 + concat_axis)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """``lax.ppermute(x, axis, perm)``: worker-stacked ``x``; each
        ``(src, dst)`` pair sends worker src's row to worker dst, and a
        worker no pair sends to receives zeros. A rotation (every worker
        receives, from ``(dst + c) % N``) is ``torch.roll`` by ``-c``: the
        ring's ``[(j, (j - 1) % N)]`` is a roll by -1, and the rotation by
        0 (a one-worker ring) returns ``x`` itself."""
        self._check(x)
        n = self.size
        src = [-1] * n
        for s, d in perm:
            if not (0 <= s < n and 0 <= d < n) or src[d] >= 0:
                raise ValueError(f"ppermute: bad permutation {perm} for {n} workers")
            src[d] = s
        shifts = {(s - d) % n for d, s in enumerate(src) if s >= 0}
        if len(shifts) == 1 and min(src) >= 0:
            shift = shifts.pop()
            return torch.roll(x, -shift, dims=0) if shift else x
        out = torch.zeros_like(x)
        for d, s in enumerate(src):
            if s >= 0:
                out[d] = x[s]
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather(x, axis, tiled=True)``: worker-stacked ``[N, m,
        *rest]`` -> the replicated concatenation ``[N*m, *rest]`` of the
        workers' blocks in worker order."""
        self._check(x)
        if x.dim() < 2:
            raise ValueError(f"tiled all_gather needs [N, m, ...], got {tuple(x.shape)}")
        return x.reshape((-1,) + tuple(x.shape[2:]))


def make_mesh(num_workers: int) -> WorkerAxis:
    """The worker axis of ``num_workers`` virtual workers (``make_mesh``
    builds a device mesh; here every worker shares the one device)."""
    return WorkerAxis(num_workers)


def place_on_mesh(tree, mesh: WorkerAxis, specs):
    """Every leaf of ``tree`` on the stacked layout of ``mesh`` as ``specs``
    says (mesh.py:98): ``specs`` matches ``tree`` (a dict / list / tuple
    tree), and at a leaf is None (the leaf as it is: replicated, or a
    layout whose shards are views of it, as pp's stages) or the dim the
    shards cut (an int): the leaf becomes ``[n, ...]``, shard i holding
    the i-th of n equal slices of that dim (``shard_params_tp``'s layout,
    and the expert leaves of ``shard_params_moe`` at dim 0). A None
    ``specs`` subtree leaves its subtree as it is, as does a None leaf of
    ``tree``. The single placement behind ``shard_params_tp`` and
    ``checkpoint.restore_sharded``."""
    if specs is None or tree is None:
        return tree
    if isinstance(specs, int) and not isinstance(specs, bool):
        n = mesh.size
        if tree.shape[specs] % n:
            raise ValueError(f"dim {specs} of a {tuple(tree.shape)} leaf does not split "
                             f"into {n} shards")
        return torch.stack(tree.chunk(n, dim=specs)).contiguous()
    if isinstance(tree, dict):
        return {k: place_on_mesh(v, mesh, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_on_mesh(v, mesh, s) for v, s in zip(tree, specs, strict=True))
    raise TypeError(f"place_on_mesh: a {type(tree).__name__} leaf with spec {specs!r}")


@dataclasses.dataclass(frozen=True)
class HybridWorkerAxis(WorkerAxis):
    """A (hosts x per_host) grid of virtual workers on one device, the
    stacked counterpart of ``make_hybrid_mesh``'s device mesh (mesh.py:44):
    the DCN axis outer, the ICI axis inner, so worker (h, c) is number
    ``h * per_host + c``, as JAX's reshape of the flat device list numbers
    it (``worker_ids``).

    Per-worker tensors keep the flat axis's stacking ``[N, ...]``, which
    is ``[hosts, per_host, ...]`` with the DCN dimension leading (a
    reshape): unlike ``Mesh2D``, whose inner axis leads because every
    attention call rotates along it, every collective of the PS step but
    the hierarchical wire's reduces over the whole grid, and the grid's
    tuple axis (``names``, JAX's ``(DCN_AXIS, WORKER_AXIS)``) reduces as
    the flat axis does, bit for bit: the inherited ``WorkerAxis``
    primitives are the tuple-axis ones. ``dcn`` / ``ici`` are the two
    axes as worker axes of their own sizes: over ``[hosts, per_host,
    ...]`` (DCN) or its transpose (ICI)."""

    hosts: int = 1
    per_host: int = 1

    names = (DCN_AXIS, WORKER_AXIS)

    def __post_init__(self):
        super().__post_init__()
        if self.hosts < 1 or self.per_host < 1 or self.hosts * self.per_host != self.size:
            raise ValueError(f"a {self.hosts} x {self.per_host} grid does not hold "
                             f"{self.size} workers")

    @property
    def dcn(self) -> WorkerAxis:
        return WorkerAxis(self.hosts)

    @property
    def ici(self) -> WorkerAxis:
        return WorkerAxis(self.per_host)

    def worker_ids(self) -> torch.Tensor:
        """``[hosts, per_host]`` worker numbers, the DCN axis outer."""
        return torch.arange(self.size).reshape(self.hosts, self.per_host)


def make_hybrid_mesh(num_hosts: int, per_host: int) -> HybridWorkerAxis:
    """The (hosts x per_host) grid of ``num_hosts * per_host`` virtual
    workers on one device (``make_hybrid_mesh`` of the JAX package lays
    hosts x chips out over devices)."""
    return HybridWorkerAxis(num_hosts * per_host, hosts=num_hosts, per_host=per_host)


# int16 has no torch.distributed type on gloo or NCCL: it crosses as int32
_WIDEN = {torch.int16: torch.int32}


class ProcessWorkerAxis:
    """N workers over the ``world`` processes of a ``torch.distributed``
    group, ``local_size = N / world`` stacked in each: worker ids
    ``[first, first + local_size)`` live in this process. Per-worker
    tensors are stacked ``[local_size, ...]``; a reduced value comes back
    whole on every process, as on ``WorkerAxis``.

    The rules each collective keeps, so that a run over processes gives
    the stacked backend's bits:

    - integer sums (``psum``, ``psum_scatter`` of int8 payloads) sum the
      local rows, then ``all_reduce(SUM)`` them: exact in any order.
      int16 (the homomorphic wire's accumulator) crosses as int32 and is
      narrowed back, the same integers at twice the bytes on the hop;
    - float sums, means, maxima and minima gather every worker's rows
      (``all_gather``) and reduce ``[N, ...]`` with the stacked op, so the
      order of the additions is the stacked backend's;
    - ``absmax_max`` (the gradient wire's shared scale) is a MAX over the
      int32 bit patterns of non-negative floats, which order like the
      floats with a positive NaN above +inf, so a NaN survives the hop
      as it survives the kernels' own max (``csrc/common.cuh``);
    - ``all_to_all`` and ``all_gather`` move int8 and f32 rows as they are.

    ``group`` may be any process group. Over gloo a CUDA tensor is copied
    through host memory for every call (gloo's CUDA support does not
    cover ``all_gather`` / ``all_to_all``); ``host_copy_s`` sums the time
    those copies take, synchronised."""

    def __init__(self, size: int, group: Any = None):
        import torch.distributed as dist

        self.size, self.group = size, group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if size < 1 or size % self.world:
            raise ValueError(f"{size} workers do not split over {self.world} processes")
        self.first = self.rank * (size // self.world)
        self._staged = dist.get_backend(group) == "gloo"
        # the staged copies' seconds, one cell a grid shares with its DCN axis
        self._copy_s = [0.0]

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(size={self.size}, world={self.world}, "
                f"rank={self.rank})")

    @property
    def host_copy_s(self) -> float:
        return self._copy_s[0]

    @property
    def local_size(self) -> int:
        return self.size // self.world

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.first:self.first + self.local_size]

    def _check(self, x: torch.Tensor) -> None:
        if x.dim() == 0 or x.shape[0] != self.local_size:
            raise ValueError(f"expected this process's worker-stacked tensor "
                             f"[{self.local_size}, ...], got {tuple(x.shape)}")

    # ------------------------------------------------------------ the hops
    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the group's backend takes it: widened where it has no
        type, on the host where gloo meets a CUDA tensor."""
        x = x.to(_WIDEN.get(x.dtype, x.dtype)).contiguous()
        if self._staged and x.is_cuda:
            t0 = time.perf_counter()
            x = x.cpu()
            self._copy_s[0] += time.perf_counter() - t0
        return x

    def _back(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if y.device != like.device:
            t0 = time.perf_counter()
            y = y.to(like.device)
            torch.cuda.synchronize(like.device)
            self._copy_s[0] += time.perf_counter() - t0
        return y.to(like.dtype)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        y = self._out(x)
        y = y.clone() if y.data_ptr() == x.data_ptr() else y
        dist.all_reduce(y, op=op, group=self.group)
        return self._back(y, x)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's rows, ``[N, ...]`` on every process."""
        import torch.distributed as dist

        self._check(x)
        y = self._out(x)
        parts = [torch.empty_like(y) for _ in range(self.world)]
        dist.all_gather(parts, y, group=self.group)
        return self._back(torch.cat(parts), x)

    # --------------------------------------------------- the WorkerAxis API
    def axis_index(self, device=None) -> torch.Tensor:
        return torch.arange(self.first, self.first + self.local_size, device=device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        self._check(x)
        if not x.dtype.is_floating_point:
            return self._all_reduce(x.sum(0, dtype=x.dtype), dist.ReduceOp.SUM)
        return self.gather_rows(x).sum(0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather_rows(x).amax(0)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather_rows(x).amin(0)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather_rows(x).mean(0)

    def absmax_max(self, absmax: torch.Tensor) -> torch.Tensor:
        """The cross-process max of a local absmax (any shape, f32,
        non-negative or NaN), NaN kept: a MAX over the int32 bits."""
        import torch.distributed as dist

        bits = absmax.abs().contiguous().view(torch.int32)
        return self._all_reduce(bits, dist.ReduceOp.MAX).view(torch.float32)

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self._all_reduce(flag.to(torch.int32), dist.ReduceOp.MIN).bool()

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        self._check(x)
        n = self.size
        if x.dim() < 2 or x.shape[1] % n:
            raise ValueError(f"psum_scatter needs [{self.local_size}, L, ...] with L % {n} == 0, "
                             f"got {tuple(x.shape)}")
        tail = (n, x.shape[1] // n) + tuple(x.shape[2:])
        if not x.dtype.is_floating_point:
            total = self._all_reduce(x.sum(0, dtype=x.dtype), dist.ReduceOp.SUM)
            return self.local(total.reshape(tail))
        full = self.gather_rows(x)
        return self.local(full.reshape((n,) + tail).sum(0, dtype=x.dtype))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Local ``[n_loc, N, s...]`` (row j of local worker i: its slice
        of region j) -> ``[n_loc(region), N(sender), s...]``, as
        ``WorkerAxis.all_to_all`` returns this process's regions."""
        import torch.distributed as dist

        self._check(x)
        nl, p = self.local_size, self.world
        if x.dim() < 2 or x.shape[1] != self.size:
            raise ValueError(f"all_to_all needs [{nl}, {self.size}, ...], got {tuple(x.shape)}")
        rest = tuple(x.shape[2:])
        # to process q: every local sender's slices of q's regions
        send = self._out(x.reshape((nl, p, nl) + rest).transpose(0, 1))
        recv = torch.empty_like(send)  # [p(from), nl(its senders), nl(my regions), ...]
        dist.all_to_all_single(recv, send, group=self.group)
        recv = self._back(recv, x)
        return recv.permute((2, 0, 1) + tuple(range(3, recv.dim()))).reshape(
            (nl, self.size) + rest)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() < 2:
            raise ValueError(f"tiled all_gather needs [n_loc, m, ...], got {tuple(x.shape)}")
        return self.gather_rows(x).reshape((-1,) + tuple(x.shape[2:]))

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        return self.local(WorkerAxis(self.size).ppermute(self.gather_rows(x), perm))

    # ------------------------------------------------- host-side agreement
    def broadcast_object(self, obj):
        """Rank 0's Python object on every process."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0)
                                   if self.group is not None else 0, group=self.group)
        return box[0]

    def any_host(self, flag: bool) -> bool:
        """OR of a host flag over the processes."""
        import torch.distributed as dist

        box = [None] * self.world
        dist.all_gather_object(box, bool(flag), group=self.group)
        return any(box)

    def min_over_hosts(self, values):
        """The elementwise min over the processes of an int32 host vector
        (the adaptive controllers' consensus): every process's vector
        gathered, then the min, in integers."""
        import torch.distributed as dist

        mine = np.asarray(values, np.int32)
        box = [None] * self.world
        dist.all_gather_object(box, mine.tolist(), group=self.group)
        return np.min(np.asarray(box, np.int32), axis=0).astype(np.int32)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)


class ProcessHybridAxis(ProcessWorkerAxis):
    """The (hosts x per_host) grid of ``HybridWorkerAxis`` over the
    ``world`` processes of a group, hosts mapped to processes as JAX's
    multi-process ``make_hybrid_mesh`` maps them (mesh.py:72-96, one
    process a granule): each process holds ``hosts / world`` whole hosts,
    so worker (h, c) is still number ``h * per_host + c`` and this
    process's workers are the contiguous ids ``[first, first +
    local_size)`` of ``ProcessWorkerAxis``, stacked ``[hosts / world,
    per_host, ...]``.

    The grid's own collectives (the tuple axis) are the flat process
    axis's, so every wire but the hierarchical one reduces over it as
    over ``ProcessWorkerAxis(N)``, bit for bit. ``dcn`` is a
    process-spanning axis of ``hosts`` workers (``hosts / world`` local,
    the ICI index riding along in each row), whose ``absmax_max`` gives
    the split quantize routes their scales across processes; ``ici`` is
    the stacked ``WorkerAxis(per_host)`` inside one host. A DCN axis over
    a one-rank group (every host in one process) is a valid layout."""

    names = (DCN_AXIS, WORKER_AXIS)

    def __init__(self, size: int, hosts: int, group: Any = None):
        super().__init__(size, group)
        if hosts < 1 or size % hosts:
            raise ValueError(f"{size} workers do not split over {hosts} hosts")
        if hosts % self.world:
            raise ValueError(
                f"{hosts} hosts do not split over {self.world} processes: each process "
                f"holds whole hosts (hosts % processes == 0, the balanced-per-host rule of "
                f"make_hybrid_mesh)")
        self.hosts, self.per_host = hosts, size // hosts
        self._dcn = ProcessWorkerAxis(hosts, group)
        self._dcn._copy_s = self._copy_s

    def __repr__(self) -> str:
        return (f"ProcessHybridAxis(size={self.size}, hosts={self.hosts}, world={self.world}, "
                f"rank={self.rank})")

    @property
    def dcn(self) -> ProcessWorkerAxis:
        return self._dcn

    @property
    def ici(self) -> WorkerAxis:
        return WorkerAxis(self.per_host)

    def worker_ids(self) -> torch.Tensor:
        """``[hosts, per_host]`` worker numbers, the DCN axis outer."""
        return torch.arange(self.size).reshape(self.hosts, self.per_host)


# the two forms of the (hosts x per_host) grid: stacked, and over processes
GRIDS = (HybridWorkerAxis, ProcessHybridAxis)


def batch_sharding(axis) -> range:
    """The global worker ids whose batches this process feeds (the role
    of ``batch_sharding``'s split of the global batch over the worker
    axis): all of them on ``WorkerAxis``."""
    return range(axis.first, axis.first + axis.local_size)


def make_worker_axis(num_workers: int, dcn_hosts: int = 1):
    """The trainer's worker axis: ``ProcessWorkerAxis`` over the default
    group once ``torch.distributed`` is initialised (at any world size),
    else the stacked ``WorkerAxis``; with ``dcn_hosts > 1`` the
    (hosts x per_host) grid of either kind (JAX's trainer.py:242-249)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if dcn_hosts > 1:
            return ProcessHybridAxis(num_workers, dcn_hosts)
        return ProcessWorkerAxis(num_workers)
    if dcn_hosts > 1:
        return make_hybrid_mesh(dcn_hosts, num_workers // dcn_hosts)
    return WorkerAxis(num_workers)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda") -> bool:
    """Join a multi-process training job (JAX ``initialize_multihost``,
    mesh.py:139-201; the reference's mpirun spawn and rendezvous): a
    no-op without a coordinator (returns False). ``init_process_group``
    at ``tcp://<coordinator_address>`` with the given world size and
    rank; NCCL when ``device`` is a card (each process on card ``rank %
    cards``), gloo on the CPU. NCCL takes one process per card: more
    processes than this host has cards raise, naming the rule, and
    nothing switches to gloo behind the caller's back. Every process
    calls this with the same arguments but its own ``process_id``."""
    if coordinator_address is None:
        return False
    import torch.distributed as dist

    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs --num-processes and --process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if num_processes > cards:
            raise RuntimeError(
                f"{num_processes} processes over NCCL on a host with {cards} card(s): NCCL "
                f"takes one process per card (two ranks on one GPU are refused as a "
                f"duplicate GPU); run at most {cards} process(es) per host, or --device cpu "
                f"for gloo")
        torch.cuda.set_device(process_id % cards)
    address = coordinator_address
    if not address.startswith("tcp://"):
        address = "tcp://" + address
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (dp x sp) grid of virtual workers, the stacked counterpart of
    ``dp_sp.make_mesh_2d``'s device mesh: dp outer, sp inner, so worker
    (i, j) is number ``i * sp + j`` (``worker_ids``).

    Per-worker tensors of the grid are stacked ``[sp, dp, ...]``: the sp
    axis leads, because every attention call rotates K/V along it and
    every ``WorkerAxis`` primitive acts on the leading dimension; the
    stacked batch ``[sp, dp * b]`` then splits into sequence shards by a
    view. A reduction over dp is one over dimension 1."""

    dp: WorkerAxis
    sp: WorkerAxis

    def worker_ids(self) -> torch.Tensor:
        """``[dp, sp]`` worker numbers, dp outer (the device grid's order)."""
        return torch.arange(self.dp.size * self.sp.size).reshape(self.dp.size,
                                                                 self.sp.size)
