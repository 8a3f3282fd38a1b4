"""Continuous-batching slot scheduler — pure host bookkeeping, no torch
(a near-verbatim copy of the JAX package's serve/scheduler.py).

The device side of the serving engine is a fixed pool of ``n_slots``
KV-cache slots stepped by ONE decode step; this module
decides which request occupies which slot at each tick:

- ``submit`` queues a request (FIFO; shape-validated against the pool
  geometry at submit time, so a too-long request fails loudly at the
  front door instead of corrupting a slot);
- ``admit`` pops queued requests into free slots (lowest slot id first —
  deterministic, so a replay of the same arrival order reproduces the
  same slot assignment bit-for-bit);
- ``record_token`` appends one generated token + its latency to the
  slot's in-flight state and reports whether the request just finished
  (its ``max_new_tokens`` reached);
- ``evict`` frees a finished slot and returns the ``Completion``;
- ``expire_queued`` / ``expire_slot`` terminate requests whose deadline
  passed — in the queue before admission, or mid-decode with partial
  tokens. An expired slot is freed exactly like an evicted one, so the
  next occupant's decode stays token-exact (the masked-write argument:
  every position the dead sequence scribbled is overwritten before it
  is first attended).

Slot lifecycle:  FREE -> (admit) -> ACTIVE -> (record_token x N,
last one finishing) -> FINISHED -> (evict) -> FREE, with a second exit
ACTIVE -> (expire_slot) -> FREE when the deadline passes mid-decode.
Eviction, expiry, and admission all happen between device steps, so a
slot freed at tick t is re-usable at tick t+1 — fixed shapes, the
masks do the rest (serve/engine.py).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One decode request: a prompt and a new-token budget."""

    rid: int
    prompt: np.ndarray           # int32 [prompt_len], prompt_len >= 1
    max_new_tokens: int
    # open-loop traffic: arrival time on the caller's clock (0.0 is a
    # legitimate instant). None = closed-loop request with no arrival —
    # TTFT is then measured from admission.
    arrival_s: Optional[float] = None
    # ABSOLUTE deadline on the same clock as arrival_s (the scheduler
    # clock). None = no deadline. A request whose deadline passes before
    # its budget is reached terminates as 'expired' — at submit, in the
    # queue, or mid-decode — never silently.
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Completion:
    """A finished request: generated tokens + per-token latencies."""

    rid: int
    prompt: np.ndarray
    tokens: List[int]
    # per-token wall-clock latency: tokens[0]'s entry is time-to-first-
    # token measured from arrival; later entries are inter-token gaps
    latencies_s: List[float]
    finished_s: float = 0.0
    # the checkpoint step whose weights generated this completion (the
    # drain-then-swap rollover rule means it is ONE step, never a mix)
    weights_step: Optional[int] = None
    # TTFT decomposition (ARCHITECTURE §7g): latencies_s[0] ==
    # queue_s + prefill_s by construction.
    #   queue_s   arrival -> admission (0.0 for closed-loop requests,
    #             whose TTFT base IS the admission instant)
    #   prefill_s admission -> first token emitted (covers the padded
    #             prefill AND the first decode step — the engine fuses
    #             them into one tick)
    #   decode_s  first token -> last token (the inter-token tail)
    queue_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # the request's absolute deadline, carried through so goodput (tokens
    # completed WITHIN deadline) is computable from completions alone
    deadline_s: Optional[float] = None

    @property
    def met_deadline(self) -> bool:
        return self.deadline_s is None or self.finished_s <= self.deadline_s


@dataclasses.dataclass
class Expired:
    """A request whose deadline passed before completion. ``where`` names
    the lifecycle stage that observed the expiry: ``submit`` (deadline
    already past on arrival), ``queue`` (expired waiting for a slot), or
    ``decode`` (evicted mid-decode; ``tokens`` holds the partial
    output — generated, but never a Completion)."""

    rid: int
    where: str
    deadline_s: float
    expired_s: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    # time-to-first-token, when the request got far enough to emit one
    # (where=decode only) — admitted-request TTFT statistics must count
    # these, or the worst admitted waits vanish from the percentiles
    ttft_s: Optional[float] = None


@dataclasses.dataclass
class _InFlight:
    request: Request
    slot: int
    tokens: List[int]
    latencies_s: List[float]
    last_token_s: float          # arrival at admission; then last emit
    admitted_s: float = 0.0      # admission instant (scheduler clock)
    first_token_s: Optional[float] = None


class SlotScheduler:
    """Admit/evict bookkeeping for a fixed pool of decode slots."""

    def __init__(self, n_slots: int, max_len: int, max_prompt_len: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if not 1 <= max_prompt_len <= max_len:
            raise ValueError(
                f"need 1 <= max_prompt_len ({max_prompt_len}) <= "
                f"max_len ({max_len})"
            )
        self.n_slots = n_slots
        self.max_len = max_len
        self.max_prompt_len = max_prompt_len
        self._free: List[int] = sorted(range(n_slots), reverse=True)
        self._queue: Deque[Request] = deque()
        self._inflight: Dict[int, _InFlight] = {}

    # ------------------------------------------------------------- intake
    def submit(self, request: Request) -> None:
        plen = int(request.prompt.shape[0])
        if plen < 1:
            raise ValueError(f"request {request.rid}: empty prompt")
        if plen > self.max_prompt_len:
            raise ValueError(
                f"request {request.rid}: prompt length {plen} exceeds "
                f"max_prompt_len {self.max_prompt_len}"
            )
        if request.max_new_tokens < 1:
            raise ValueError(
                f"request {request.rid}: max_new_tokens must be >= 1"
            )
        if plen + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {request.rid}: prompt {plen} + new "
                f"{request.max_new_tokens} exceeds slot length "
                f"{self.max_len}"
            )
        self._queue.append(request)

    # ------------------------------------------------------------- expiry
    def expire_queued(self, now_s: float) -> List[Request]:
        """Remove and return queued requests whose deadline has passed
        (deadline <= now: the deadline instant itself is too late to
        start). Survivors keep their FIFO order."""
        expired = [
            r for r in self._queue
            if r.deadline_s is not None and r.deadline_s <= now_s
        ]
        if expired:
            dead = {id(r) for r in expired}
            self._queue = deque(
                r for r in self._queue if id(r) not in dead
            )
        return expired

    def expire_slot(self, slot: int, now_s: float) -> Expired:
        """Evict an in-flight request mid-decode because its deadline
        passed; the slot is freed for reuse exactly like a normal evict
        (the next occupant's prefill+decode overwrite every position the
        dead sequence wrote before it is first attended — token-exact by
        the same masked-write argument)."""
        inf = self._inflight.pop(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)
        return Expired(
            rid=inf.request.rid,
            where="decode",
            deadline_s=float(inf.request.deadline_s),
            expired_s=now_s,
            tokens=list(inf.tokens),
            ttft_s=inf.latencies_s[0] if inf.latencies_s else None,
        )

    # ---------------------------------------------------------- admission
    def admit(self, now_s: float = 0.0) -> List[Tuple[int, Request]]:
        """Move queued requests into free slots (FIFO x lowest-slot-first);
        returns the (slot, request) pairs admitted this tick — the engine
        prefills exactly these."""
        admitted: List[Tuple[int, Request]] = []
        while self._queue and self._free:
            req = self._queue.popleft()
            slot = self._free.pop()
            # TTFT base: the request's ARRIVAL when it carries one on the
            # caller's clock (open-loop traffic — queueing delay counts,
            # and 0.0 is a legitimate arrival instant), else the
            # admission instant (closed-loop/default requests)
            self._inflight[slot] = _InFlight(
                request=req, slot=slot, tokens=[], latencies_s=[],
                last_token_s=(
                    req.arrival_s if req.arrival_s is not None else now_s
                ),
                admitted_s=now_s,
            )
            admitted.append((slot, req))
        return admitted

    # ------------------------------------------------------------- decode
    def record_token(self, slot: int, token: int, now_s: float) -> bool:
        """Append one generated token; True when the request just hit its
        new-token budget (caller evicts)."""
        inf = self._inflight[slot]
        if not inf.tokens:
            inf.first_token_s = now_s
        inf.tokens.append(int(token))
        inf.latencies_s.append(max(now_s - inf.last_token_s, 0.0))
        inf.last_token_s = now_s
        return len(inf.tokens) >= inf.request.max_new_tokens

    def evict(self, slot: int, now_s: float = 0.0,
              weights_step: Optional[int] = None) -> Completion:
        inf = self._inflight.pop(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)
        # TTFT decomposition on the scheduler's own clock: the same
        # instants the latencies were measured with, so the components
        # sum exactly (queue + prefill == latencies_s[0]). The TTFT base
        # is max(admission, arrival): an injected-clock fast-forward
        # (traffic.run_open_loop) can admit BEFORE the nominal arrival,
        # and prefill must then count from the arrival the first-token
        # latency counts from, or the components would sum past it.
        arrival = (
            inf.request.arrival_s
            if inf.request.arrival_s is not None
            else inf.admitted_s
        )
        first = (
            inf.first_token_s if inf.first_token_s is not None else now_s
        )
        base = max(inf.admitted_s, arrival)
        return Completion(
            rid=inf.request.rid,
            prompt=inf.request.prompt,
            tokens=inf.tokens,
            latencies_s=inf.latencies_s,
            finished_s=now_s,
            weights_step=weights_step,
            queue_s=max(inf.admitted_s - arrival, 0.0),
            prefill_s=max(first - base, 0.0),
            decode_s=max(inf.last_token_s - first, 0.0),
            deadline_s=inf.request.deadline_s,
        )

    # ----------------------------------------------------------- queries
    @property
    def active_slots(self) -> Sequence[int]:
        return sorted(self._inflight)

    def request_in(self, slot: int) -> Request:
        return self._inflight[slot].request

    def tokens_in(self, slot: int) -> List[int]:
        return self._inflight[slot].tokens

    @property
    def n_inflight(self) -> int:
        return len(self._inflight)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def idle(self) -> bool:
        return not self._inflight and not self._queue
