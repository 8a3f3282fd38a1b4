"""Continuous-batching serving engine with hot checkpoint rollover (the
port of serve/engine.py).

A fixed pool of KV-cache slots stepped by ONE decode step; requests are
admitted and evicted per tick by the host-side scheduler
(serve/scheduler.py):

- ``prefill``: one slot's prompt padded to ``max_prompt_len`` (the pad
  tail's K/V is causally downstream of the real prompt only and is
  overwritten by decode before it is ever attended) through the batched
  causal forward — flash kernel K4 under ``attention_impl="flash"`` —
  with each block's K/V written into the slot (kernel K1 for an int8
  pool);
- ``decode``: every slot advances one token — per-slot positions and
  length masks, writes at each slot's own position, greedy argmax.
  Finished and empty slots ride along masked.

Weights live on the device as ONE padded flat f32 vector in the
flat-state layout (parallel/buckets.FlatVector); the blocks read views
of it, re-derived by ``tree_view`` on every call (nothing caches one).
The pool is updated in place.

Rollover is drain-then-swap: when a newer valid checkpoint appears
(``poll_rollover``, through checkpoint.load_latest_valid), only its
step is staged; admission pauses, in-flight sequences finish on the
weights that started them, then ``_try_swap`` re-reads the file
(``read_attempts=1``) and copies the new flat vector into the device
buffer in one host-to-device copy. That happens only when nothing is in
flight: the last tick's token fetch has synchronised, and the copy is
ordered on the same stream as every decode. A completion therefore
carries exactly one ``weights_step``. A staged file that went bad
before the swap (``CheckpointCorruptError``, ``OSError``, ``ValueError``)
ABORTS it: one ``rollover_abort`` event, service continues on the old
flat buffer, which was never touched, nothing is quarantined, and the
next poll retries. ``drain_timeout_s`` bounds how long a drain may pause
admissions; a step it gives up on is never re-staged.

Request lifecycle: every submitted request terminates in exactly one of
completed | shed | expired, each with a structured event through
``event_sink``; ``outcomes`` is the bounded ledger and
``outcome_counts`` the totals. ``admission`` is an optional controller
(serve/admission.AdmissionController, or any object with ``offered``,
``observe_tick``, ``record_admit`` and ``slo_budget_s``); ``faults`` a
resilience.FaultPlan whose ``slow_decode`` stalls a tick through the
injectable ``sleep`` and whose ``rollover_corrupt`` damages a staged
file.

Slot sharding (``mesh``, a parallel/mesh WorkerAxis of n workers): the
slots must divide over n, and ``pool_bands()`` views the pool's
``[depth, slots, ...]`` buffers as ``[depth, n, slots / n, ...]`` bands,
one a worker. Declared deviation: on the one card the bands are views of
one buffer and the decode step runs once over all of them; the step is
slot-parallel with no collectives, so the tokens are the meshless
engine's, and no bytes cross a link.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..checkpoint import (
    CheckpointCorruptError,
    checkpoint_path,
    listify_raw,
    load_checkpoint_raw,
    load_latest_valid,
)
from ..models.convert import params_from_jax
from ..models.transformer import (
    TransformerConfig,
    _rms_norm,
    select_attention,
    transformer_block,
)
from ..obs import NULL_TRACER
from ..parallel.buckets import (
    FlatVector,
    _np_tree_to_flat,
    plan_buckets,
    tree_layout,
    tree_view,
)
from ..utils import get_logger
from .kv import attend_pool, init_kv_pool, write_slot, write_token
from .scheduler import Completion, Expired, Request, SlotScheduler

logger = get_logger()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Pool geometry + storage policy for one serving engine."""

    slots: int = 8
    max_len: int = 256           # cache positions per slot
    max_prompt_len: int = 64     # prefill width (pad target)
    kv_int8: bool = False        # int8 K/V payload + block scales


def make_prefill_step(cfg: TransformerConfig, serve: ServeConfig):
    """(params, pool, prompt [max_prompt_len], slot) -> pool."""

    @torch.no_grad()
    def prefill(params_any, pool, prompt, slot):
        params = tree_view(params_any)
        cd = cfg.effective_compute_dtype
        t = prompt.shape[0]
        pos = torch.arange(t, device=prompt.device)
        x = (params["embed"][prompt] + params["pos_embed"][pos]).to(cd)
        x = x[None]  # [1, T, D]
        base_attend = select_attention(cfg, None)
        for i, blk in enumerate(params["blocks"]):

            def attend(q, k, v, _i=i):
                write_slot(pool, _i, slot, k[0], v[0])
                return base_attend(q, k, v)

            x = transformer_block(cfg, x, blk, attend)
        return pool

    return prefill


def make_decode_step(cfg: TransformerConfig, serve: ServeConfig):
    """(params, pool, tok [S], pos [S], active [S])
    -> (pool, next [S], next_pos [S]).

    Inactive slots hold their token and position; their cache write lands
    where the slot's next occupant writes before it ever reads."""

    @torch.no_grad()
    def step(params_any, pool, tok, pos, active):
        params = tree_view(params_any)
        cd = cfg.effective_compute_dtype
        x = (params["embed"][tok] + params["pos_embed"][pos]).to(cd)
        x = x[:, None]  # [S, 1, D]
        scale = 1.0 / (cfg.head_dim ** 0.5)
        lengths = pos + 1
        for i, blk in enumerate(params["blocks"]):

            def attend(q, k, v, _i=i):
                write_token(pool, _i, pos, k[:, 0], v[:, 0])
                return attend_pool(pool, _i, q, lengths, scale)

            x = transformer_block(cfg, x, blk, attend)
        xf = _rms_norm(x[:, 0].to(cd), params["out_norm"].to(cd))
        logits = (xf @ params["embed"].T.to(cd)).float()
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(active, nxt, tok)
        return pool, nxt, pos + active.to(torch.int32)

    return step


class ServingEngine:
    """One model, one slot pool, one request loop. Greedy decode only:
    the same request set replays to the same tokens whatever the
    batching (pinned against per-sequence models/decode.generate)."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params: Dict,
        serve: ServeConfig,
        mesh=None,
        model_dir: Optional[str] = None,
        step: Optional[int] = None,
        clock=None,
        tracer=None,
        admission=None,
        faults=None,
        event_sink=None,
        drain_timeout_s: Optional[float] = None,
        sleep=None,
        device: DeviceLike = None,
    ):
        if not cfg.causal:
            raise ValueError("serving decode is autoregressive: cfg.causal")
        if serve.max_len > cfg.max_seq_len:
            raise ValueError(
                f"serve.max_len {serve.max_len} exceeds the model's "
                f"positional range {cfg.max_seq_len}"
            )
        if mesh is not None and serve.slots % mesh.size:
            raise ValueError(
                f"slots ({serve.slots}) must divide over the mesh "
                f"({mesh.size} devices) for slot sharding"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serve = serve
        self.mesh = mesh
        self.model_dir = model_dir
        # the checkpoint step being served (None: weights not from a file)
        self.step = step
        # the latency clock: read at admission and after each token
        # fetch; run_open_loop rebases it onto the arrival timeline
        self.clock = clock or time.perf_counter
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.admission = admission
        self.faults = faults
        self._event_sink = event_sink
        # drain watchdog: how long a staged rollover may pause admissions
        # (None = forever), on the latency clock
        self.drain_timeout_s = drain_timeout_s
        # the stall primitive of the fault hooks: virtual-clock tests
        # advance their clock here instead of sleeping
        self._sleep = sleep if sleep is not None else time.sleep
        self.scheduler = SlotScheduler(serve.slots, serve.max_len,
                                       serve.max_prompt_len)

        # weights: ONE padded flat f32 vector (single bucket)
        self._layout = tree_layout(params)
        self._plan = plan_buckets(self._layout.total, 0, align=1)
        flat = _np_tree_to_flat(self._layout, self._plan, params)
        self._params = FlatVector(
            flat=torch.from_numpy(flat).to(self.device),
            layout=self._layout, plan=self._plan,
        )
        self._pool = init_kv_pool(cfg, serve.slots, serve.max_len,
                                  int8=serve.kv_int8, device=self.device)
        self._prefill = make_prefill_step(cfg, serve)
        self._decode = make_decode_step(cfg, serve)

        s = serve.slots
        self._tok = np.zeros((s,), np.int32)
        self._pos = np.zeros((s,), np.int32)
        self._active = np.zeros((s,), bool)
        # device-side (tok, pos, active): rebuilt from the host arrays
        # only after an admission/eviction; otherwise the previous step's
        # outputs feed the next one with no host->device copy
        self._dev = None
        self._dirty = True
        # a staged rollover is the STEP only: the swap re-reads the file
        self._pending: Optional[int] = None
        self.rollovers: List[Dict[str, Any]] = []
        self.rollover_aborts: List[Dict[str, Any]] = []
        self._ledger_cap = 65536
        self.outcomes: Dict[int, str] = {}
        self.outcome_counts: Dict[str, int] = {
            "completed": 0, "shed": 0, "expired": 0,
        }
        self.shed: Deque[Dict[str, Any]] = deque(maxlen=self._ledger_cap)
        self.expired: Deque[Expired] = deque(maxlen=self._ledger_cap)
        # a step the drain watchdog gave up on: never re-staged
        self._abandoned_step: Optional[int] = None
        self._tick_no = 0
        # device work done, for the kernel launch accounting: prompts
        # prefilled (plen > 1) and decode steps run
        self.n_prefills = 0
        self.n_decode_steps = 0
        self._admit_tr_t: Dict[int, float] = {}
        # the open drain's start on the tracer clock (the rollover_drain
        # span) and on the latency clock (the watchdog's timebase)
        self._drain_tr_t0: Optional[float] = None
        self._drain_clk_t0: Optional[float] = None

    # ------------------------------------------------------- construction
    @classmethod
    def from_checkpoint(
        cls,
        model_dir: str,
        serve: ServeConfig,
        step: Optional[int] = None,
        mesh=None,
        compute_dtype=None,
        tracer=None,
        **engine_kw,
    ) -> "ServingEngine":
        """Load a cli/train_lm checkpoint (dense LMs) into a serving
        engine; ``step`` None takes the newest valid one. ``engine_kw``
        passes through to the constructor (admission, faults, event_sink,
        drain_timeout_s, clock, sleep, device)."""
        if step is None:
            found = load_latest_valid(model_dir)
            if found is None:
                raise FileNotFoundError(f"no valid checkpoints in {model_dir}")
            step, raw = found
        else:
            raw = load_checkpoint_raw(model_dir, step)
        cfg, params = checkpoint_model(raw, compute_dtype)
        return cls(cfg, params, serve, mesh=mesh, model_dir=model_dir,
                   step=step, tracer=tracer, **engine_kw)

    def pool_bands(self) -> Dict[str, torch.Tensor]:
        """The pool as ``[depth, n, slots / n, ...]`` slot bands, one a
        mesh worker (views; n = 1 without a mesh)."""
        n = self.mesh.size if self.mesh is not None else 1
        return {k: v.view(v.shape[0], n, v.shape[1] // n, *v.shape[2:])
                for k, v in self._pool.items()}

    # ---------------------------------------------------------- rollover
    def poll_rollover(self) -> Optional[int]:
        """Stage the newest valid checkpoint newer than the serving step
        (and than a staged or abandoned one); returns the staged step or
        None. Only the step is staged: the swap re-reads the file after
        the drain (see tick())."""
        if self.model_dir is None:
            return None
        after = max(x for x in (self._pending, self._abandoned_step, self.step)
                    if x is not None)
        found = load_latest_valid(self.model_dir, after_step=after)
        if found is None:
            return None
        new_step, raw = found
        _, params = checkpoint_model(raw, self.cfg.compute_dtype)
        if tree_layout(params).shapes != self._layout.shapes:
            raise ValueError(
                f"checkpoint step {new_step} has a different param "
                f"geometry than the serving model — rollover would "
                f"require a recompile, refusing"
            )
        if self._drain_tr_t0 is None:
            self._drain_tr_t0 = self.tracer.now()
        if self._drain_clk_t0 is None:
            self._drain_clk_t0 = self.clock()
        self._pending = new_step
        if self.faults is not None:
            # damage the staged file AFTER validation: the swap-time
            # re-read must catch it
            self.faults.maybe_corrupt_staged(
                checkpoint_path(self.model_dir, new_step), new_step)
        logger.info("rollover staged: step %s -> %d (draining %d in-flight)",
                    self.step, new_step, self.scheduler.n_inflight)
        return new_step

    def _close_drain_span(self, to_step: int, outcome: str) -> None:
        if self._drain_tr_t0 is not None:
            self.tracer.add(
                "rollover_drain", self._drain_tr_t0,
                self.tracer.now() - self._drain_tr_t0, cat="serve",
                from_step=self.step, to_step=to_step, outcome=outcome,
            )
            self._drain_tr_t0 = None
        self._drain_clk_t0 = None

    def _try_swap(self, now_s: float) -> None:
        """Drain complete: re-read the staged checkpoint and copy it into
        the flat buffer, or abort onto the old weights if the bytes on
        disk went bad since staging."""
        new_step = self._pending
        try:
            # an unreadable staged file is an abort verdict, not a retry
            # inside the request loop: the next poll is the retry
            raw = load_checkpoint_raw(self.model_dir, new_step, read_attempts=1)
            _, params = checkpoint_model(raw, self.cfg.compute_dtype)
            if tree_layout(params).shapes != self._layout.shapes:
                raise ValueError(
                    f"staged checkpoint step {new_step} changed param "
                    f"geometry between stage and swap"
                )
            flat = _np_tree_to_flat(self._layout, self._plan, params)
        except (CheckpointCorruptError, OSError, ValueError) as e:
            self._abort_rollover(now_s, reason="corrupt_staged", error=str(e))
            return
        self._pending = None
        self._close_drain_span(new_step, outcome="swap")
        with self.tracer.span("rollover_swap", cat="serve",
                              from_step=self.step, to_step=new_step):
            # one host-to-device copy into the same buffer, nothing in flight
            self._params.flat.copy_(torch.from_numpy(flat))
        self.rollovers.append(
            {"from_step": self.step, "to_step": new_step, "at_s": now_s})
        logger.info("rollover complete: now serving step %d", new_step)
        self.step = new_step

    def _abort_rollover(self, now_s: float, reason: str, error: str = "") -> None:
        staged = self._pending
        self._pending = None
        self._close_drain_span(staged, outcome="abort")
        if reason == "drain_timeout":
            # only a strictly newer checkpoint may stage again (a corrupt
            # abort retries: the next poll re-validates the directory)
            self._abandoned_step = staged
        rec = {
            "kind": "rollover_abort",
            "from_step": self.step,
            "staged_step": staged,
            "reason": reason,
            "error": error,
            "at_s": round(now_s, 6),
        }
        self.rollover_aborts.append(dict(rec))
        self._emit(rec)
        self.tracer.instant("rollover_abort", cat="serve", from_step=self.step,
                            staged_step=staged, reason=reason)
        logger.warning("rollover abort (%s): staying on step %s, staged step %s "
                       "dropped%s", reason, self.step, staged,
                       f" ({error})" if error else "")

    @property
    def draining(self) -> bool:
        return self._pending is not None

    # ------------------------------------------------------------ intake
    def _emit(self, record: Dict[str, Any]) -> None:
        if self._event_sink is not None:
            self._event_sink(record)

    def _record_outcome(self, rid: int, outcome: str) -> None:
        if rid >= 0:  # warmup probes (negative rids) are not traffic
            self.outcome_counts[outcome] += 1
        self.outcomes[rid] = outcome
        while len(self.outcomes) > self._ledger_cap:
            self.outcomes.pop(next(iter(self.outcomes)))

    def _record_expired(self, exp: Expired) -> None:
        self._record_outcome(exp.rid, "expired")
        self.expired.append(exp)
        self._emit({
            "kind": "deadline_expired",
            "rid": exp.rid,
            "where": exp.where,
            "deadline_s": round(exp.deadline_s, 6),
            "expired_s": round(exp.expired_s, 6),
            "tokens_done": len(exp.tokens),
        })

    def submit(self, request: Request) -> None:
        """Front door: a request whose deadline already passed (expired)
        or that the admission controller refuses (shed) terminates here,
        evented; everything else goes to the scheduler's FIFO."""
        now_s = self.clock()
        if request.deadline_s is not None and request.deadline_s <= now_s:
            self._record_expired(Expired(
                rid=request.rid, where="submit",
                deadline_s=float(request.deadline_s), expired_s=now_s,
            ))
            return
        if self.admission is not None:
            shed, projected = self.admission.offered(now_s, self.scheduler.n_queued)
            if shed:
                rec = {
                    "kind": "request_shed",
                    "rid": request.rid,
                    "projected_wait_s": round(projected, 6),
                    "queue_depth": self.scheduler.n_queued,
                    "slo_budget_s": self.admission.slo_budget_s,
                    "at_s": round(now_s, 6),
                }
                self._record_outcome(request.rid, "shed")
                self.shed.append(dict(rec))
                self._emit(rec)
                return
        self.scheduler.submit(request)

    # -------------------------------------------------------------- loop
    def _expire_deadlines(self, now_s: float) -> None:
        for req in self.scheduler.expire_queued(now_s):
            self._record_expired(Expired(
                rid=req.rid, where="queue",
                deadline_s=float(req.deadline_s), expired_s=now_s,
            ))
        for slot in list(self.scheduler.active_slots):
            req = self.scheduler.request_in(slot)
            if req.deadline_s is not None and req.deadline_s <= now_s:
                exp = self.scheduler.expire_slot(slot, now_s)
                self._active[slot] = False
                self._dirty = True
                t0 = self._admit_tr_t.pop(slot, None)
                if t0 is not None:
                    self.tracer.add(
                        "request", t0, self.tracer.now() - t0,
                        cat="request", slot=slot, rid=exp.rid,
                        outcome="expired", new_tokens=len(exp.tokens),
                    )
                self._record_expired(exp)

    def _device_triple(self):
        if self._dirty or self._dev is None:
            self._dev = (
                torch.from_numpy(self._tok).to(self.device),
                torch.from_numpy(self._pos).to(self.device),
                torch.from_numpy(self._active).to(self.device),
            )
            self._dirty = False
        return self._dev

    def tick(self) -> List[Completion]:
        """One scheduler round: expire deadlines, swap-if-drained (or
        abort), admit, one decode step, record/evict. Returns the
        completions that finished this tick."""
        self._tick_no += 1
        tr = self.tracer
        if self.faults is not None:
            # injected per-tick host stall, before the decode
            self.faults.maybe_slow_decode(self._tick_no, sleep=self._sleep)
        now_s = self.clock()
        self._expire_deadlines(now_s)
        if self._pending is not None:
            if self.scheduler.n_inflight == 0:
                self._try_swap(now_s)
            elif (self.drain_timeout_s is not None
                  and self._drain_clk_t0 is not None
                  and now_s - self._drain_clk_t0 > self.drain_timeout_s):
                # a drain may not pause admissions forever
                self._abort_rollover(now_s, reason="drain_timeout")
        if self.admission is not None:
            self.admission.observe_tick(now_s, self.scheduler.n_queued)
        if self._pending is None:
            for slot, req in self.scheduler.admit(now_s):
                self._admit_slot(slot, req)
                if self.admission is not None:
                    self.admission.record_admit(now_s)
        if self.scheduler.n_inflight == 0:
            return []

        with tr.span("decode_dispatch", cat="serve", tick=self._tick_no):
            tok_d, pos_d, act_d = self._device_triple()
            self._pool, nxt, new_pos = self._decode(
                self._params, self._pool, tok_d, pos_d, act_d
            )
            self._dev = (nxt, new_pos, act_d)
            self.n_decode_steps += 1
        # THE per-tick host sync: the scheduler cannot admit/evict
        # without this step's tokens — one [slots] fetch
        with tr.span("token_fetch", cat="serve", tick=self._tick_no):
            tokens = nxt.cpu().numpy()
        emit_s = self.clock()

        done: List[Completion] = []
        with tr.span("evict", cat="serve", tick=self._tick_no):
            for slot in list(self.scheduler.active_slots):
                token = int(tokens[slot])
                self._tok[slot] = token
                self._pos[slot] += 1
                if self.scheduler.record_token(slot, token, emit_s):
                    self._active[slot] = False
                    self._dirty = True
                    c = self.scheduler.evict(slot, emit_s, weights_step=self.step)
                    self._record_outcome(c.rid, "completed")
                    self._emit({
                        "kind": "request_done",
                        "rid": c.rid,
                        "new_tokens": len(c.tokens),
                        "weights_step": c.weights_step,
                        "met_deadline": c.met_deadline,
                        "ttft_s": round(c.latencies_s[0], 6)
                        if c.latencies_s else None,
                    })
                    t0 = self._admit_tr_t.pop(slot, None)
                    if t0 is not None:
                        tr.add(
                            "request", t0, tr.now() - t0, cat="request",
                            slot=slot, rid=c.rid, queue_s=round(c.queue_s, 6),
                            prefill_s=round(c.prefill_s, 6),
                            decode_s=round(c.decode_s, 6),
                            new_tokens=len(c.tokens),
                            weights_step=c.weights_step,
                        )
                    done.append(c)
        if tr.enabled and self._tick_no % 256 == 0:
            tr.flush()
        return done

    def _admit_slot(self, slot: int, req: Request) -> None:
        with self.tracer.span("admit_prefill", cat="serve", slot=slot, rid=req.rid):
            self._admit_tr_t[slot] = self.tracer.now()
            plen = int(req.prompt.shape[0])
            if plen > 1:
                padded = np.zeros((self.serve.max_prompt_len,), np.int64)
                padded[:plen] = req.prompt
                self._pool = self._prefill(
                    self._params, self._pool,
                    torch.from_numpy(padded).to(self.device), slot,
                )
                self.n_prefills += 1
            self._tok[slot] = int(req.prompt[plen - 1])
            self._pos[slot] = plen - 1
            self._active[slot] = True
            self._dirty = True

    # ------------------------------------------------------- conveniences
    def warmup(self) -> None:
        """One throwaway request through prefill + decode (builds and
        loads the kernels, warms the allocator) so served latency measures
        the engine. The dirtied slot is overwritten on first real use.
        Bypasses the front door (admission control and fault ticks must
        target served traffic): the warmup's rid -1 outcome is dropped
        and tick numbering restarts, so ``slow_decode`` plans are
        warmup-invariant."""
        plen = min(2, self.serve.max_prompt_len)
        self.scheduler.submit(Request(
            rid=-1, prompt=np.zeros((plen,), np.int32), max_new_tokens=1
        ))
        faults, sink, adm = self.faults, self._event_sink, self.admission
        self.faults = None
        self._event_sink = None
        self.admission = None
        try:
            while not self.scheduler.idle:
                self.tick()
        finally:
            self.faults = faults
            self._event_sink = sink
            self.admission = adm
        self.outcomes.pop(-1, None)
        self._tick_no = 0

    def decode_requests(self, requests: Sequence[Request],
                        poll_every: int = 0) -> List[Completion]:
        """Closed-loop drive: submit everything, tick to idle. With
        ``poll_every`` > 0, poll for a checkpoint rollover every that
        many ticks."""
        for r in requests:
            self.submit(r)
        out: List[Completion] = []
        ticks = 0
        while not self.scheduler.idle or self._pending is not None:
            out.extend(self.tick())
            ticks += 1
            if poll_every and ticks % poll_every == 0:
                self.poll_rollover()
        return sorted(out, key=lambda c: c.rid)


def checkpoint_model(raw: dict, compute_dtype) -> Tuple[TransformerConfig, Dict]:
    """Rebuild (TransformerConfig, params tree of CPU tensors) from a
    train_lm raw checkpoint dict. Dense models only, as the JAX engine:
    a MoE checkpoint raises ValueError. The config keeps the default
    ``attention_impl="naive"``, as JAX's does."""
    m = raw["model"]
    if m.get("kind", "dense") != "dense":
        raise ValueError(
            "the serving engine decodes dense LM checkpoints only "
            f"(checkpoint kind: {m.get('kind')!r})"
        )
    cfg = TransformerConfig(
        vocab_size=int(m["vocab_size"]),
        dim=int(m["dim"]),
        depth=int(m["depth"]),
        heads=int(m["heads"]),
        mlp_ratio=int(m["mlp_ratio"]),
        max_seq_len=int(m["max_seq_len"]),
        compute_dtype=compute_dtype,
    )
    return cfg, params_from_jax(listify_raw(raw["params"]), device="cpu")
