"""Open-loop synthetic traffic for the serving engine (the port of
serve/traffic.py: the same seeded draws, so schedules are identical).

Open-loop means arrivals are a fixed schedule (Poisson process at
``rate_rps``), independent of completions — the generator never waits
for the engine, so queueing delay shows up in the latency tail exactly
the way overload does in production. Everything is seeded: the same
TrafficConfig replays the same request set (arrival times, prompt
lengths, prompt tokens, new-token budgets) bit-for-bit, which is what
lets the bench leg and the smoke leg assert on the result.

``run_open_loop`` drives an engine against the schedule on a real or
virtual clock and reduces the completions to the serving headline:
tokens/sec plus p50/p99 per-token latency (the per-token series is
time-to-first-token for a request's first token, inter-token gap for
the rest — the tail therefore covers prefill, queueing, AND rollover
drains).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .engine import ServingEngine
from .scheduler import Completion, Request


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n_requests: int = 32
    rate_rps: float = 100.0      # Poisson arrival rate
    prompt_len_min: int = 4
    prompt_len_max: int = 16
    new_tokens_min: int = 8
    new_tokens_max: int = 32
    vocab_size: int = 256
    seed: int = 0
    # seeded bursty mode (overload drills): (rate_mult, start_s, dur_s)
    # square-wave rate modulation — arrivals inside [start, start+dur)
    # come at rate_rps * rate_mult, outside at rate_rps. None = plain
    # Poisson (bit-identical to the pre-spike generator: same rng draw
    # order).
    spike: Optional[tuple] = None
    # relative per-request deadline: each request's absolute deadline is
    # arrival_s + deadline_s on the open-loop clock. None = no deadlines.
    deadline_s: Optional[float] = None


def make_requests(
    tc: TrafficConfig,
    prompt_source: Optional[Callable[[np.random.RandomState, int], np.ndarray]] = None,
) -> List[Request]:
    """The deterministic request set for a TrafficConfig.

    ``prompt_source(rng, length) -> int32 [length]`` overrides prompt
    token generation (cli/serve feeds held-out Markov-chain walks so the
    served model sees its training distribution); the default is uniform
    random tokens."""
    if tc.n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if tc.rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    if not 1 <= tc.prompt_len_min <= tc.prompt_len_max:
        raise ValueError("need 1 <= prompt_len_min <= prompt_len_max")
    if not 1 <= tc.new_tokens_min <= tc.new_tokens_max:
        raise ValueError("need 1 <= new_tokens_min <= new_tokens_max")
    if tc.deadline_s is not None and tc.deadline_s <= 0:
        raise ValueError("deadline_s must be > 0 (None disables)")
    rng = np.random.RandomState(tc.seed)
    if tc.spike is None:
        # Poisson process: exponential inter-arrival gaps at rate_rps
        gaps = rng.exponential(1.0 / tc.rate_rps, size=tc.n_requests)
        arrivals = np.cumsum(gaps)
    else:
        mult, start_s, dur_s = (float(x) for x in tc.spike)
        if mult <= 0 or start_s < 0 or dur_s <= 0:
            raise ValueError(
                f"spike needs rate_mult > 0, start_s >= 0, dur_s > 0, "
                f"got {tc.spike!r}"
            )
        # square-wave rate modulation: each gap is drawn at the rate in
        # force when it begins — a seeded two-state renewal process, so
        # the overload drill replays the identical burst bit-for-bit
        t = 0.0
        arrivals = np.empty(tc.n_requests, np.float64)
        for i in range(tc.n_requests):
            rate = tc.rate_rps * (
                mult if start_s <= t < start_s + dur_s else 1.0
            )
            t += float(rng.exponential(1.0 / rate))
            arrivals[i] = t
    out: List[Request] = []
    for rid in range(tc.n_requests):
        plen = int(rng.randint(tc.prompt_len_min, tc.prompt_len_max + 1))
        if prompt_source is not None:
            prompt = np.asarray(prompt_source(rng, plen), np.int32)
        else:
            prompt = rng.randint(0, tc.vocab_size, size=plen).astype(np.int32)
        arrival = float(arrivals[rid])
        out.append(Request(
            rid=rid,
            prompt=prompt,
            max_new_tokens=int(
                rng.randint(tc.new_tokens_min, tc.new_tokens_max + 1)
            ),
            arrival_s=arrival,
            deadline_s=(
                arrival + tc.deadline_s if tc.deadline_s is not None
                else None
            ),
        ))
    return out


def run_open_loop(
    engine: ServingEngine,
    requests: Sequence[Request],
    poll_interval_s: float = 0.0,
    clock: Optional[Callable[[], float]] = None,
) -> Dict:
    """Serve a fixed arrival schedule to completion; returns the summary.

    ``poll_interval_s`` > 0 polls the engine's checkpoint directory for
    a hot rollover at that cadence (drain-then-swap — see engine).
    ``clock`` defaults to time.perf_counter, rebased so the schedule's
    t=0 is the call time; the engine idles (sleeps) until the next
    arrival when nothing is in flight."""
    # closed-loop requests (arrival_s=None) are welcome in an open-loop
    # drive: they simply arrive at the schedule's t=0
    requests = [
        r if r.arrival_s is not None else dataclasses.replace(r, arrival_s=0.0)
        for r in requests
    ]
    requests = sorted(requests, key=lambda r: r.arrival_s)
    base = (clock or time.perf_counter)()
    now = lambda: (clock or time.perf_counter)() - base
    # arrival times and the engine's latency clock must share a timeline
    # (TTFT counts from ARRIVAL — queueing delay is part of serving)
    engine.clock = now
    t0 = now()
    pending = list(requests)
    completions: List[Completion] = []
    last_poll = t0
    while pending or not engine.scheduler.idle or engine.draining:
        t = now()
        while pending and pending[0].arrival_s <= t:
            engine.submit(pending.pop(0))
        if poll_interval_s > 0 and t - last_poll >= poll_interval_s:
            last_poll = t
            engine.poll_rollover()
        if engine.scheduler.idle and not engine.draining and pending:
            if clock is None:
                # open-loop idle: nothing to decode until the next arrival
                time.sleep(min(pending[0].arrival_s - t, 0.01))
            else:
                # injected (virtual) clock: real sleep cannot advance it —
                # fast-forward by submitting the next arrival immediately
                # (arrival ORDER is preserved; gaps collapse)
                engine.submit(pending.pop(0))
            continue
        completions.extend(engine.tick())
    elapsed = now() - t0
    return summarize(completions, elapsed, engine)


def summarize(completions: Sequence[Completion], elapsed_s: float,
              engine: Optional[ServingEngine] = None) -> Dict:
    """Reduce completions to the serving headline record.

    Alongside raw tokens/sec: GOODPUT (tokens of completions that met
    their deadline — the number overload actually degrades; without
    deadlines every completed token is good by definition) and the
    lifecycle counts (shed/expired from the engine's ledger, so the
    record accounts for every submitted request, not just the winners).
    The TTFT percentiles are over ADMITTED requests that emitted a first
    token: completions AND mid-decode expiries (whose TTFT the scheduler
    preserves on the Expired record) — dropping the latter would hide
    exactly the worst admitted waits from the tail under overload. Shed
    and pre-admission expiries never produce a first token."""
    latencies = np.asarray(
        [lat for c in completions for lat in c.latencies_s], np.float64
    )
    ttft = np.asarray(
        [c.latencies_s[0] for c in completions if c.latencies_s]
        + (
            [e.ttft_s for e in engine.expired if e.ttft_s is not None]
            if engine is not None else []
        ),
        np.float64,
    )
    n_tokens = int(sum(len(c.tokens) for c in completions))
    good_tokens = int(sum(
        len(c.tokens) for c in completions if c.met_deadline
    ))
    out = {
        "requests_completed": len(completions),
        "new_tokens": n_tokens,
        "elapsed_s": round(float(elapsed_s), 6),
        "tokens_per_sec": round(n_tokens / elapsed_s, 2) if elapsed_s > 0 else None,
        "goodput_tokens": good_tokens,
        "goodput_tokens_per_sec": (
            round(good_tokens / elapsed_s, 2) if elapsed_s > 0 else None
        ),
        "p50_token_latency_s": _pct(latencies, 50),
        "p99_token_latency_s": _pct(latencies, 99),
        "p50_ttft_s": _pct(ttft, 50),
        "p99_ttft_s": _pct(ttft, 99),
    }
    # TTFT decomposition (scheduler.Completion): queue + prefill == TTFT
    # per request, so a fat TTFT tail is attributable — queueing delay
    # (admission pressure, rollover drains) vs prefill cost. decode_s is
    # the whole inter-token tail of one request, not a per-token gap.
    for comp in ("queue_s", "prefill_s", "decode_s"):
        xs = np.asarray([getattr(c, comp) for c in completions], np.float64)
        out[f"p50_{comp}"] = _pct(xs, 50)
        out[f"p99_{comp}"] = _pct(xs, 99)
    if engine is not None:
        out["weights_step"] = engine.step
        out["rollovers"] = list(engine.rollovers)
        out["rollover_aborts"] = list(engine.rollover_aborts)
        # the lifecycle counters (warmup's negative rids excluded): every
        # submitted request lands in exactly one bucket — the
        # zero-silent-drops audit the chaos smoke runs on this record.
        # Counters, not the bounded per-request ledger: totals must
        # survive a long-lived server's ledger eviction.
        counts = engine.outcome_counts
        out["requests_submitted"] = sum(counts.values())
        out["requests_shed"] = counts["shed"]
        out["requests_expired"] = counts["expired"]
    return out


def _pct(xs: np.ndarray, q: float) -> Optional[float]:
    if xs.size == 0:
        return None
    return round(float(np.percentile(xs, q)), 6)
