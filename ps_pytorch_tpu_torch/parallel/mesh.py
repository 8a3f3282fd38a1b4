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
rotation); ``Mesh2D`` is the (dp x sp) grid of the LM training step.

This is the analogue of the reference's 8-device virtual CPU mesh. The
``torch.distributed`` backend (gloo / NCCL, one rank per card) is a
later slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch

WORKER_AXIS = "workers"


@dataclasses.dataclass(frozen=True)
class WorkerAxis:
    """N virtual workers stacked on the leading dimension of every
    per-worker tensor."""

    size: int

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"a worker axis needs >= 1 worker, got {self.size}")

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
