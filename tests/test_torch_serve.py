"""Port parity: ps_pytorch_tpu_torch.serve (KV pool, engine, scheduler,
traffic) against the JAX package's serve/, plus the port's own rules
(imports, device).

The pins:

- the KV pool's int8 payload and scales are bit-exact against JAX's
  (jitted, as its engine runs them) on identical K/V, and pooled attention agrees within 1e-5 in both formats;
- continuous-batching greedy decode is token-identical to the JAX engine
  on the same weights and to the port's own per-sequence ``generate``
  (f32 pool, naive and flash prefill; 5 requests on 3 slots);
- the int8-pool engine tracks the JAX int8-pool engine within JAX's own
  envelope (>= 0.9 token agreement, tests/test_serve.py);
- request schedules, summaries and scheduler decisions are identical.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models import transformer as jtr
from ps_pytorch_tpu.serve import (
    ServeConfig as JServeConfig,
    ServingEngine as JServingEngine,
    SlotScheduler as JSlotScheduler,
)
from ps_pytorch_tpu.serve import kv as jkv
from ps_pytorch_tpu.serve import traffic as jtraffic
from ps_pytorch_tpu.serve.scheduler import Request as JRequest
from ps_pytorch_tpu_torch import resolve_device
from ps_pytorch_tpu_torch.models import convert, decode as tdec
from ps_pytorch_tpu_torch.models import transformer as ttr
from ps_pytorch_tpu_torch.obs import validate_event
from ps_pytorch_tpu_torch.serve import (
    Request,
    ServeConfig,
    ServingEngine,
    SlotScheduler,
    TrafficConfig,
    init_kv_pool,
    make_requests,
    run_open_loop,
    summarize,
)
from ps_pytorch_tpu_torch.serve import kv as tkv
from ps_pytorch_tpu_torch.serve import traffic as ttraffic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab_size=29, dim=32, depth=2, heads=4, max_seq_len=64)
JCFG = jtr.TransformerConfig(**SHAPE)
TCFG = ttr.TransformerConfig(**SHAPE)
POOL = dict(slots=3, max_len=48, max_prompt_len=12)
SHAPES = [(5, 9), (1, 6), (12, 8), (7, 14), (3, 5)]


def _requests(shapes, cls=Request, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(0, SHAPE["vocab_size"], p).astype(np.int32),
                max_new_tokens=n)
            for i, (p, n) in enumerate(shapes)]


class VClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def weights():
    jparams = jtr.init_transformer(JCFG, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jparams, convert.params_from_jax(np_params, device="cpu")


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """The JAX engine's tokens for SHAPES: f32 pool and int8 pool."""
    jparams, _ = weights
    out = {}
    for int8 in (False, True):
        engine = JServingEngine(JCFG, jparams, JServeConfig(**POOL, kv_int8=int8))
        engine.warmup()
        out[int8] = [c.tokens for c in
                     engine.decode_requests(_requests(SHAPES, JRequest))]
    return out


# ---------------------------------------------------------------- KV pool

def _kv_inputs(seed=0):
    rng = np.random.RandomState(seed)
    L, H, hd = 16, JCFG.heads, JCFG.head_dim
    k = rng.randn(L, H, hd).astype(np.float32)
    v = rng.randn(L, H, hd).astype(np.float32)
    q = rng.randn(4, 1, H, hd).astype(np.float32)
    return k, v, q


@pytest.mark.parametrize("int8", [False, True])
def test_torch_kv_write_slot_and_attend_match_jax(int8):
    k, v, q = _kv_inputs()
    lengths = np.asarray([16, 9, 4, 1], np.int32)
    jpool = jkv.init_kv_pool(JCFG, 4, 16, int8=int8)
    tpool = tkv.init_kv_pool(TCFG, 4, 16, int8=int8, device="cpu")
    # the JAX engine writes the pool under jit, where the quantizer's scale
    # is absmax * f32(1/127) (tests/test_torch_quantize.py)
    write_slot = jax.jit(jkv.write_slot, static_argnums=1)
    for s in range(4):
        for i in range(JCFG.depth):
            jpool = write_slot(jpool, i, jnp.int32(s), jnp.asarray(k), jnp.asarray(v))
            tkv.write_slot(tpool, i, s, torch.from_numpy(k), torch.from_numpy(v))
    assert sorted(tpool) == sorted(jpool)
    for name in jpool:
        assert tpool[name].dtype == {
            np.dtype(np.int8): torch.int8, np.dtype(np.float32): torch.float32,
        }[np.asarray(jpool[name]).dtype]
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    want = np.asarray(jkv.attend_pool(jpool, 1, jnp.asarray(q), jnp.asarray(lengths),
                                      scale=JCFG.head_dim ** -0.5))
    got = tkv.attend_pool(tpool, 1, torch.from_numpy(q), torch.from_numpy(lengths),
                          scale=TCFG.head_dim ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_torch_kv_write_token_matches_jax(int8):
    k, v, _ = _kv_inputs(1)
    pos = np.asarray([3, 0, 15, 7], np.int32)
    jpool = jkv.init_kv_pool(JCFG, 4, 16, int8=int8)
    tpool = tkv.init_kv_pool(TCFG, 4, 16, int8=int8, device="cpu")
    kt, vt = k[:4], v[:4]  # [S, H, hd]: one token per slot
    jpool = jax.jit(jkv.write_token, static_argnums=1)(
        jpool, 1, jnp.asarray(pos), jnp.asarray(kt), jnp.asarray(vt))
    tkv.write_token(tpool, 1, torch.from_numpy(pos), torch.from_numpy(kt),
                    torch.from_numpy(vt))
    for name in jpool:
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))


# ----------------------------------------------------------------- engine

@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_torch_engine_tokens_identical_to_jax_engine_and_generate(weights, jax_tokens,
                                                                  impl):
    """THE serving pin: a mixed-length request set through the slot pool
    (queueing and slot reuse: 5 requests, 3 slots, after warmup) emits
    exactly the JAX engine's tokens and exactly the port's per-sequence
    ``generate`` tokens."""
    _, tparams = weights
    cfg = ttr.TransformerConfig(**SHAPE, attention_impl=impl)
    engine = ServingEngine(cfg, tparams, ServeConfig(**POOL), device="cpu")
    engine.warmup()
    reqs = _requests(SHAPES)
    outs = engine.decode_requests(reqs)
    assert [c.rid for c in outs] == [0, 1, 2, 3, 4]
    assert [c.tokens for c in outs] == jax_tokens[False]
    for c, r in zip(outs, reqs):
        want = tdec.generate(cfg, tparams, torch.from_numpy(r.prompt)[None],
                             r.max_new_tokens, max_len=POOL["max_len"], device="cpu")
        assert c.tokens == want[0, len(r.prompt):].tolist(), f"rid {c.rid}"
    assert engine.n_prefills == 1 + 4  # warmup + every prompt longer than 1


def test_torch_int8_engine_tracks_jax_int8_engine(weights, jax_tokens):
    _, tparams = weights
    engine = ServingEngine(TCFG, tparams, ServeConfig(**POOL, kv_int8=True),
                           device="cpu")
    engine.warmup()
    outs = engine.decode_requests(_requests(SHAPES))
    agree = total = 0
    for c, want in zip(outs, jax_tokens[True]):
        assert len(c.tokens) == len(want)
        agree += sum(int(a == b) for a, b in zip(c.tokens, want))
        total += len(want)
    assert agree / total >= 0.9, f"int8 engine agreement {agree}/{total}"


def test_torch_open_loop_virtual_clock_summary_matches_jax_keys(weights):
    jparams, tparams = weights
    tc = dict(n_requests=6, vocab_size=29, prompt_len_max=12, new_tokens_max=10)
    clock = VClock()
    engine = ServingEngine(TCFG, tparams, ServeConfig(**POOL), clock=clock,
                           device="cpu")
    engine.warmup()
    summary = run_open_loop(engine, make_requests(TrafficConfig(**tc)), clock=clock)
    jengine = JServingEngine(JCFG, jparams, JServeConfig(**POOL))
    jsummary = jtraffic.run_open_loop(
        jengine, jtraffic.make_requests(jtraffic.TrafficConfig(**tc)), clock=clock)
    assert sorted(summary) == sorted(jsummary)
    assert summary["requests_completed"] == 6 == summary["requests_submitted"]
    assert summary["new_tokens"] == jsummary["new_tokens"]


def test_torch_engine_lifecycle_events_and_admission_hook(weights):
    """Deadlines expire at the front door and in the queue; a duck-typed
    admission controller sheds; every outcome is one schema-valid event."""
    _, tparams = weights
    clock = VClock()
    events = []

    class ShedOdd:
        slo_budget_s = 0.5

        def offered(self, now_s, queue_depth):
            self.n = getattr(self, "n", 0) + 1
            return self.n % 2 == 0, 0.25

        def observe_tick(self, now_s, queue_depth):
            pass

        def record_admit(self, now_s):
            pass

    engine = ServingEngine(TCFG, tparams, ServeConfig(**POOL), clock=clock,
                           admission=ShedOdd(), event_sink=events.append,
                           device="cpu")
    engine.warmup()
    reqs = _requests([(4, 3)] * 6)
    reqs[0] = dataclasses.replace(reqs[0], deadline_s=0.0)  # dead on arrival
    for r in reqs:
        engine.submit(r)
    while not engine.scheduler.idle:
        engine.tick()
    for e in events:
        validate_event(e)
    kinds = sorted((e["rid"], e["kind"]) for e in events)
    assert kinds == [(0, "deadline_expired"), (1, "request_done"),
                     (2, "request_shed"), (3, "request_done"),
                     (4, "request_shed"), (5, "request_done")]
    assert engine.outcome_counts == {"completed": 3, "shed": 2, "expired": 1}


# ---------------------------------------------------- traffic + scheduler

@pytest.mark.parametrize("spike", [None, (5.0, 0.05, 0.1)])
def test_torch_make_requests_identical_to_jax(spike):
    kw = dict(n_requests=40, rate_rps=80.0, prompt_len_min=3, prompt_len_max=20,
              new_tokens_min=2, new_tokens_max=30, vocab_size=2048, seed=7,
              spike=spike, deadline_s=1.5)
    mine = make_requests(TrafficConfig(**kw))
    ref = jtraffic.make_requests(jtraffic.TrafficConfig(**kw))
    assert len(mine) == len(ref) == 40
    for a, b in zip(mine, ref):
        assert (a.rid, a.arrival_s, a.deadline_s, a.max_new_tokens) == (
            b.rid, b.arrival_s, b.deadline_s, b.max_new_tokens)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_torch_summarize_identical_to_jax():
    from ps_pytorch_tpu.serve.scheduler import Completion as JCompletion
    from ps_pytorch_tpu_torch.serve import Completion

    rng = np.random.RandomState(0)
    fields = [dict(rid=i, prompt=np.zeros(3, np.int32),
                   tokens=list(rng.randint(0, 9, 4)),
                   latencies_s=list(rng.rand(4)), finished_s=float(i),
                   queue_s=0.1 * i, prefill_s=0.2, decode_s=0.3,
                   deadline_s=(2.5 if i % 2 else None))
              for i in range(7)]
    mine = summarize([Completion(**f) for f in fields], 3.0)
    ref = jtraffic.summarize([JCompletion(**f) for f in fields], 3.0)
    assert mine == ref


def test_torch_scheduler_decisions_identical_to_jax():
    """The same script of submits, admits, tokens, evictions and expiries
    gives the same decisions from both schedulers."""
    def run(sched_cls, req_cls):
        s = sched_cls(n_slots=2, max_len=32, max_prompt_len=8)
        log = []
        for r in _requests([(4, 2), (3, 1), (5, 3), (2, 2)], req_cls):
            s.submit(dataclasses.replace(r, arrival_s=0.5 * r.rid,
                                         deadline_s={0: 2.4, 3: 1.2}.get(r.rid)))
        log.append([(slot, r.rid) for slot, r in s.admit(now_s=1.0)])
        log.append(s.record_token(0, 7, 1.5))
        log.append(s.record_token(1, 8, 1.6))
        c = s.evict(1, 1.6, weights_step=4)
        log.append((c.rid, c.tokens, c.latencies_s, c.queue_s, c.prefill_s))
        log.append([r.rid for r in s.expire_queued(1.7)])
        log.append([(slot, r.rid) for slot, r in s.admit(now_s=2.0)])
        e = s.expire_slot(0, 2.5)
        log.append((e.rid, e.where, e.tokens, e.ttft_s))
        log.append((s.n_inflight, s.n_queued, s.n_free, list(s.active_slots)))
        return log

    assert run(SlotScheduler, Request) == run(JSlotScheduler, JRequest)


# ------------------------------------------------------------ port rules

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ps_pytorch_tpu")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_torch_port_imports_nothing_of_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ps_pytorch_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_modules(f) if m.split(".")[0] in _FORBIDDEN]
    assert bad == []


def test_torch_entry_points_raise_without_a_card(monkeypatch, weights):
    _, tparams = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(TCFG, tparams, ServeConfig(**POOL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_pool(TCFG, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.generate(TCFG, tparams, torch.zeros((1, 3), dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.TransformerLM(TCFG, params=tparams)
    assert resolve_device("cpu") == torch.device("cpu")


def test_torch_engine_refuses_what_is_not_ported(weights):
    """What the JAX engine refuses: a MoE checkpoint (its checkpoint_model
    decodes dense LMs only) and a pool past the model's positions."""
    from ps_pytorch_tpu_torch.serve.engine import checkpoint_model

    _, tparams = weights
    raw = {"params": {}, "model": {"kind": "moe", "vocab_size": 8, "dim": 8, "depth": 1,
                                   "heads": 1, "mlp_ratio": 1, "max_seq_len": 8}}
    with pytest.raises(ValueError, match="dense"):
        checkpoint_model(raw, None)
    with pytest.raises(ValueError, match="positional range"):
        ServingEngine(TCFG, tparams, ServeConfig(slots=2, max_len=128), device="cpu")


def test_torch_tracer_spans_flush_and_summary(tmp_path):
    """The host-only tracer copy: spans (with profiler annotations on)
    flush as schema-valid JSONL behind one run_header, and summarize."""
    import json

    from ps_pytorch_tpu_torch.obs import NULL_TRACER, Tracer, summarize_spans

    path = tmp_path / "trace.jsonl"
    tr = Tracer("test_serve", path=str(path), annotate=True)
    for i in range(3):
        with tr.span("decode_dispatch", cat="serve", tick=i):
            with tr.span("inner"):
                pass
    tr.add("request", tr.now(), 0.5, cat="request", slot=0, rid=7)
    assert tr.flush() == 7
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["kind"] for r in lines] == ["run_header"] + ["span"] * 7
    for r in lines:
        validate_event(r)
    stats = summarize_spans(lines)
    assert stats["decode_dispatch"]["count"] == 3 and stats["inner"]["count"] == 3
    assert lines[2]["depth"] == 0 and lines[1]["depth"] == 1
    assert NULL_TRACER.flush() == 0 and NULL_TRACER.drain() == []


def test_torch_utils_host_sync_and_logger():
    from ps_pytorch_tpu_torch.utils import get_logger, host_sync

    assert host_sync({"a": torch.tensor([2.0, 5.0])}, [torch.tensor([3])]) == 5.0
    assert host_sync() == 0.0
    log = get_logger()
    assert log is get_logger() and len(log.handlers) == 1
