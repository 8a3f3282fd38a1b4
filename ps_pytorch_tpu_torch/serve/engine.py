"""Continuous-batching serving engine (the port of serve/engine.py).

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
of it. The pool is updated in place.

Request lifecycle: every submitted request terminates in exactly one of
completed | shed | expired, each with a structured event through
``event_sink``; ``outcomes`` is the bounded ledger and
``outcome_counts`` the totals. ``admission`` is an optional duck-typed
controller (``offered``, ``observe_tick``, ``record_admit``,
``slo_budget_s``), as serve/admission.AdmissionController provides.

Not in this slice (ROADMAP.md queue 1 item 20): checkpoint loading and hot rollover
(``from_checkpoint``, ``poll_rollover``), serve-side fault injection,
and slot sharding over a mesh — the constructor refuses ``model_dir`` and
``mesh``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
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
from .kv import attend_pool, init_kv_pool, write_slot, write_token
from .scheduler import Completion, Expired, Request, SlotScheduler


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
        clock=None,
        tracer=None,
        admission=None,
        event_sink=None,
        device: DeviceLike = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "slot sharding over a mesh is not ported yet (ROADMAP.md queue 1 "
                "item 20)")
        if model_dir is not None:
            raise NotImplementedError(
                "checkpoint loading and hot rollover are not ported yet "
                "(ROADMAP.md queue 1 item 20)")
        if not cfg.causal:
            raise ValueError("serving decode is autoregressive: cfg.causal")
        if serve.max_len > cfg.max_seq_len:
            raise ValueError(
                f"serve.max_len {serve.max_len} exceeds the model's "
                f"positional range {cfg.max_seq_len}"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serve = serve
        # the checkpoint step being served: None until checkpoints are ported
        self.step: Optional[int] = None
        # the latency clock: read at admission and after each token
        # fetch; run_open_loop rebases it onto the arrival timeline
        self.clock = clock or time.perf_counter
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.admission = admission
        self._event_sink = event_sink
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
        # no rollover in this slice; kept so summaries have one shape
        self.rollovers: List[Dict[str, Any]] = []
        self.rollover_aborts: List[Dict[str, Any]] = []
        self._ledger_cap = 65536
        self.outcomes: Dict[int, str] = {}
        self.outcome_counts: Dict[str, int] = {
            "completed": 0, "shed": 0, "expired": 0,
        }
        self.shed: Deque[Dict[str, Any]] = deque(maxlen=self._ledger_cap)
        self.expired: Deque[Expired] = deque(maxlen=self._ledger_cap)
        self._tick_no = 0
        # device work done, for the kernel launch accounting: prompts
        # prefilled (plen > 1) and decode steps run
        self.n_prefills = 0
        self.n_decode_steps = 0
        self._admit_tr_t: Dict[int, float] = {}

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
        """One scheduler round: expire deadlines, admit, one decode step,
        record/evict. Returns the completions that finished this tick."""
        self._tick_no += 1
        tr = self.tracer
        now_s = self.clock()
        self._expire_deadlines(now_s)
        if self.admission is not None:
            self.admission.observe_tick(now_s, self.scheduler.n_queued)
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
        Bypasses the front door: the warmup's rid -1 outcome is dropped
        and tick numbering restarts."""
        plen = min(2, self.serve.max_prompt_len)
        self.scheduler.submit(Request(
            rid=-1, prompt=np.zeros((plen,), np.int32), max_new_tokens=1
        ))
        sink, adm = self._event_sink, self.admission
        self._event_sink = None
        self.admission = None
        try:
            while not self.scheduler.idle:
                self.tick()
        finally:
            self._event_sink = sink
            self.admission = adm
        self.outcomes.pop(-1, None)
        self._tick_no = 0

    def decode_requests(self, requests: Sequence[Request]) -> List[Completion]:
        """Closed-loop drive: submit everything, tick to idle."""
        for r in requests:
            self.submit(r)
        out: List[Completion] = []
        while not self.scheduler.idle:
            out.extend(self.tick())
        return sorted(out, key=lambda c: c.rid)
