"""Step-tagged single-writer checkpoints with resume (the port of
checkpoint.py), in the JAX package's on-disk format and names.

One writer, atomically: ``model_step_N`` is written as ``model_step_N.tmp``
and renamed over, so a polling reader never sees a torn file. The bytes
are flax's msgpack of the state dict (``utils/serialization.py``: the
same bytes the JAX package writes for the same values) followed by an
8-byte integrity trailer, ``b'PSC1'`` + the little-endian CRC32 of every
byte before it. A trailer-less file (written before the trailer existed)
loads; its damage shows as a decode failure. Checkpoints are tree-shaped
whatever the live state's layout (``parallel/buckets.py`` registers a
``FlatVector``'s conversion to and from its tree with the serializer), so
the JAX package and the port resume each other's files.

Over processes (``AsyncCheckpointer.save_collective``, JAX
checkpoint.py:108-169 and :244): the caller gathers every worker's rows
to every process, rank 0 alone writes, at once, its outcome is broadcast
and a barrier follows, so no process returns before the file is durable
and a failed write raises on every process.

Compressed checkpoints (``compress=True``, ``--compress-checkpoints``):
the msgpack is wrapped in the native codec (ops/codec.py, itemsize 4)
behind a ``b'PSCK'`` magic, and the trailer covers the compressed bytes,
inside the same atomic write. Loading detects either form; a stream the
codec rejects is a ``CheckpointCorruptError``. The bytes are the JAX
package's for the same state.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

from .resilience.guard import reconcile_guard_state
from .resilience.retry import retry_io
from .utils.serialization import from_state_dict, packb, to_state_dict, unpackb

logger = logging.getLogger("ps_pytorch_tpu_torch")

CKPT_RE = re.compile(r"^model_step_(\d+)$")
COMPRESSED_MAGIC = b"PSCK"
# integrity trailer: magic + little-endian crc32 of all preceding bytes
TRAILER_MAGIC = b"PSC1"
TRAILER_LEN = len(TRAILER_MAGIC) + 4
QUARANTINE_SUFFIX = ".corrupt"
# top-level state fields that are observability, not math: absent from a
# checkpoint they restore as the target's fresh value, present but
# disabled in the target they are dropped; each maps to its module's
# merge hook (stored_dict, fresh_dict) -> merged
RESETTABLE_FIELDS = {"guard_state": reconcile_guard_state}


class CheckpointError(Exception):
    """Base for checkpoint integrity and I/O failures."""


class CheckpointCorruptError(CheckpointError):
    """The bytes on disk are damaged (CRC mismatch, truncation, a msgpack
    that does not decode): retrying will not help; quarantine and fall
    back."""


class CheckpointWriteError(CheckpointError):
    """A (possibly background) checkpoint write failed; carries the step
    and path."""

    def __init__(self, step: int, path: str, cause: BaseException):
        super().__init__(f"checkpoint write failed for step {step} at {path}: {cause}")
        self.step = step
        self.path = path


def checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"model_step_{step}")


def save_checkpoint(state, model_dir: str, step: int, compress: bool = False) -> str:
    """Write ``state`` (anything ``to_state_dict`` takes, or a state dict
    of host arrays) for ``step``, synchronously; ``compress`` writes the
    ``PSCK`` form."""
    return _write_host_state(to_state_dict(state), model_dir, step, compress)


def _write_host_state(state: dict, model_dir: str, step: int, compress: bool = False,
                      faults=None) -> str:
    """The host half of a save, on a state dict already on the host: the
    msgpack (wrapped in the codec when ``compress``), the trailer over
    the final bytes, and the atomic tmp + replace write, with transient
    OSErrors retried. An injected write fault fails every attempt, so it
    surfaces."""
    os.makedirs(model_dir, exist_ok=True)
    path = checkpoint_path(model_dir, step)
    data = packb(state)
    if compress:
        from .ops import codec

        # itemsize 4: f32 leaves dominate the payload, so a 4-byte
        # shuffle feeds the LZ stage well
        data = COMPRESSED_MAGIC + codec.compress_bytes(data, itemsize=4)
    trailer = TRAILER_MAGIC + struct.pack("<I", zlib.crc32(data))

    def write():
        if faults is not None:
            faults.maybe_fail_ckpt_write(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.write(trailer)
        os.replace(tmp, path)

    retry_io(write, desc=f"checkpoint write step {step}")
    if faults is not None:
        faults.maybe_corrupt_ckpt(path, step)
    return path


class AsyncCheckpointer:
    """Overlap serialization and disk I/O with training.

    The device-to-host copy (``to_state_dict``) runs on the caller's
    thread, at a consistent step boundary; the msgpack and the atomic
    write run on one background thread, at most one write in flight
    (``save`` waits for the previous one). ``wait()`` drains it. A write
    that fails is logged, and reported through ``event_sink`` as a
    ``ckpt_write_failed`` record, on the writer thread when it fails, then
    raised from the next ``save()`` / ``wait()`` as a
    ``CheckpointWriteError`` carrying the step and path."""

    def __init__(self, event_sink=None, faults=None):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending = None
        self._event_sink = event_sink
        self._faults = faults

    def save(self, state, model_dir: str, step: int, compress: bool = False) -> None:
        host_state = to_state_dict(state)
        self.wait()
        self._pending = self._pool.submit(self._write_logged, host_state, model_dir, step,
                                          compress)

    def save_collective(self, state, model_dir: str, step: int, axis,
                        compress: bool = False) -> None:
        """The save of a run over processes (``axis`` a
        ``ProcessWorkerAxis``; ``state`` already holds every worker's
        rows): every process calls it at the same step. Rank 0 writes
        synchronously, then every process learns its outcome (a
        broadcast) and meets the others at a barrier, so the file is
        durable before any returns, and a failed write raises a
        ``CheckpointWriteError`` on every process, not on rank 0 alone
        (raising before the barrier would strand the others in it)."""
        err = None
        if axis.rank == 0:
            try:
                self.save(state, model_dir, step, compress)
                self.wait()
            except BaseException as e:  # held across the broadcast, raised below
                err = e
        ok = axis.broadcast_object(err is None)
        axis.barrier()
        if err is not None:
            raise err
        if not ok:
            raise CheckpointWriteError(step, checkpoint_path(model_dir, step),
                                       RuntimeError("checkpoint write failed on process 0"))

    def _write_logged(self, host_state: dict, model_dir: str, step: int,
                      compress: bool = False) -> str:
        path = checkpoint_path(model_dir, step)
        try:
            return _write_host_state(host_state, model_dir, step, compress,
                                     faults=self._faults)
        except Exception as e:
            logger.error("checkpoint write failed (step %d, %s): %s", step, path, e)
            if self._event_sink is not None:
                try:
                    self._event_sink({"kind": "ckpt_write_failed", "step": step,
                                      "path": path, "error": str(e)})
                except Exception:
                    logger.exception("ckpt_write_failed event sink raised")
            raise CheckpointWriteError(step, path, e) from e

    def wait(self) -> None:
        if self._pending is not None:
            try:
                self._pending.result()
            finally:
                self._pending = None


def _read_payload(model_dir: str, step: int, read_attempts: int = 3):
    """Read one checkpoint and verify and strip its trailer: (payload,
    had_trailer). A trailer-less file is accepted as it is."""
    path = checkpoint_path(model_dir, step)

    def read():
        with open(path, "rb") as f:
            return f.read()

    data = retry_io(read, desc=f"checkpoint read step {step}", attempts=read_attempts)
    if len(data) >= TRAILER_LEN and data[-TRAILER_LEN:-4] == TRAILER_MAGIC:
        payload, (crc,) = data[:-TRAILER_LEN], struct.unpack("<I", data[-4:])
        got = zlib.crc32(payload)
        if got != crc:
            raise CheckpointCorruptError(f"CRC mismatch in {path}: stored {crc:#010x}, "
                                         f"computed {got:#010x}: the file is damaged")
        return payload, True
    return data, False


def _decode_payload(data: bytes, path: str):
    """Trailer-stripped bytes -> the raw state dict (codec, then
    msgpack); bytes that do not decode are corruption. A codec library
    that cannot be built is not: its ``NativeBuildError`` propagates."""
    if data[:4] == COMPRESSED_MAGIC:
        from .data._native import NativeBuildError
        from .ops import codec

        try:
            data = codec.decompress_bytes(data[4:])
        except NativeBuildError:
            raise
        except Exception as e:
            raise CheckpointCorruptError(f"codec decompression failed for {path}: {e}") from e
    try:
        return unpackb(data)
    except ValueError as e:
        raise CheckpointCorruptError(f"cannot deserialize {path}: {e}") from e


def _restore_raw(model_dir: str, step: int, read_attempts: int = 3):
    data, _ = _read_payload(model_dir, step, read_attempts)
    return _decode_payload(data, checkpoint_path(model_dir, step))


def verify_checkpoint(model_dir: str, step: int, read_attempts: int = 3) -> None:
    """Raise CheckpointCorruptError (damaged) or OSError (unreadable) if
    checkpoint ``step`` cannot be restored. A trailer certifies every
    byte, so only a trailer-less file is decoded."""
    data, had_trailer = _read_payload(model_dir, step, read_attempts)
    if not had_trailer:
        _decode_payload(data, checkpoint_path(model_dir, step))


def quarantine_checkpoint(model_dir: str, step: int) -> str:
    """Rename a damaged checkpoint out of the ``model_step_N`` namespace;
    the bytes stay for forensics."""
    path = checkpoint_path(model_dir, step)
    target = path + QUARANTINE_SUFFIX
    os.replace(path, target)
    logger.warning("quarantined corrupt checkpoint %s -> %s", path, target)
    return target


def available_steps(model_dir: str):
    if not os.path.isdir(model_dir):
        return []
    steps = [int(m.group(1)) for m in map(CKPT_RE.match, os.listdir(model_dir)) if m]
    return sorted(steps)


def latest_step(model_dir: str) -> Optional[int]:
    steps = available_steps(model_dir)
    return steps[-1] if steps else None


def latest_valid_step(model_dir: str) -> Optional[int]:
    """Newest step whose file passes the integrity check, skipping (not
    touching) damaged ones: read-only, so an evaluator can race the
    trainer's writer."""
    for step in reversed(available_steps(model_dir)):
        try:
            verify_checkpoint(model_dir, step)
            return step
        except (CheckpointCorruptError, OSError) as e:
            logger.warning("checkpoint step %d is not loadable (%s); trying older", step, e)
    return None


def listify_raw(tree):
    """msgpack restores list nodes as dicts ``{'0': ...}``; undo that."""
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [listify_raw(tree[str(i)]) for i in range(len(tree))]
        return {k: listify_raw(v) for k, v in tree.items()}
    return tree


def load_latest_valid(model_dir: str, after_step: Optional[int] = None):
    """Newest checkpoint strictly newer than ``after_step`` as ``(step,
    raw)`` in one read each, damaged or unreadable files skipped; None
    when nothing newer loads."""
    for step in reversed(available_steps(model_dir)):
        if after_step is not None and step <= after_step:
            return None
        try:
            data, _ = _read_payload(model_dir, step, read_attempts=1)
            return step, _decode_payload(data, checkpoint_path(model_dir, step))
        except (CheckpointCorruptError, OSError) as e:
            logger.warning("checkpoint step %d is not loadable (%s); trying older", step, e)
    return None


def load_checkpoint_raw(model_dir: str, step: int, read_attempts: int = 3) -> dict:
    """Checkpoint ``step`` as its raw state dict, no target needed."""
    return _restore_raw(model_dir, step, read_attempts)


def load_checkpoint(target, model_dir: str, step: int):
    """Checkpoint ``step`` restored into the structure of ``target`` (an
    initialized state), by ``restore_from_raw``'s rules."""
    return restore_from_raw(target, _restore_raw(model_dir, step), step)


def restore_sharded(target, model_dir: str, step: int, mesh, specs):
    """Checkpoint ``step`` restored into ``target`` (a tree in the file's
    global layout, e.g. ``tp.to_tp_layout`` of fresh params, as JAX's
    target is the sharded state's global shapes), then every leaf placed
    on the stacked layout of ``mesh`` as ``specs`` says
    (``parallel.mesh.place_on_mesh``: None as it is, an int the dim the
    shards cut; ``tp.tp_param_specs``, ``moe.moe_param_specs``,
    ``pp.pp_param_specs``). Saves write the global layout, so a file
    written at any shard count restores onto any other whose shards
    divide its dims (checkpoint.py:521)."""
    from .parallel.mesh import place_on_mesh

    return place_on_mesh(load_checkpoint(target, model_dir, step), mesh, specs)


def restore_from_raw(target, raw, step: int):
    """A raw state dict into the structure of ``target``.

    A top-level field that the target has as None and the file lacks
    (a field added after the file was written) restores as None; one
    the file carries while the target has it None (e.g. EF residuals
    into a run with error feedback off) raises ValueError: dropping it
    would change the training math. RESETTABLE_FIELDS (the guard
    counters) restore in both directions: absent -> the target's fresh
    value; present but disabled -> dropped; both -> their module's
    merge."""
    if isinstance(raw, dict) and dataclasses.is_dataclass(target):
        for k, v in ((f.name, getattr(target, f.name)) for f in dataclasses.fields(target)):
            if k in RESETTABLE_FIELDS:
                if v is None:
                    raw[k] = None
                elif raw.get(k) is None:
                    raw[k] = to_state_dict(v)
                elif isinstance(raw[k], dict):
                    raw[k] = RESETTABLE_FIELDS[k](raw[k], to_state_dict(v))
                continue
            if k not in raw and v is None:
                raw[k] = None
            elif v is None and raw.get(k) is not None:
                raise ValueError(
                    f"checkpoint step {step} carries state for field {k!r} but the "
                    f"target state has it disabled (None). Enable the matching feature "
                    f"(e.g. --error-feedback for comm_state) to resume this checkpoint, "
                    f"or rebuild it without that state.")
    return from_state_dict(target, raw)


def _await_readable(model_dir: str, step: int, attempts: int, base_delay_s: float) -> bool:
    """True once checkpoint ``step`` verifies; retries OSError and
    corruption (a file still propagating) with backoff. False: gave up,
    the caller skips the step."""
    try:
        retry_io(lambda: verify_checkpoint(model_dir, step, read_attempts=1),
                 desc=f"checkpoint step {step} readability", attempts=attempts,
                 base_delay_s=base_delay_s, retry_on=(OSError, CheckpointCorruptError))
        return True
    except (OSError, CheckpointCorruptError) as e:
        logger.warning("checkpoint step %d never became readable (%s): skipping it", step, e)
        return False


def poll_checkpoints(model_dir: str, start_after: int = 0, interval_s: float = 10.0,
                     timeout_s: Optional[float] = None, validate_attempts: int = 5,
                     validate_delay_s: float = 0.2) -> Iterator[int]:
    """Yield new checkpoint steps in order as they appear (the
    evaluator's loop; the reference polls every 10 s). Stops when
    ``timeout_s`` passes with no new checkpoint (None: never). A step
    listed but not readable is retried with backoff, then skipped."""
    seen = start_after
    waited = 0.0
    while True:
        fresh = [s for s in available_steps(model_dir) if s > seen]
        if fresh:
            waited = 0.0
            for s in fresh:
                seen = s
                if not _await_readable(model_dir, s, validate_attempts, validate_delay_s):
                    continue
                yield s
            continue
        if timeout_s is not None and waited >= timeout_s:
            return
        time.sleep(interval_s)
        waited += interval_s
