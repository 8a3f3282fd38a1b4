"""Port parity: the serving engine's checkpoint loading, hot rollover and
serve-side faults (ps_pytorch_tpu_torch.serve.engine) against the JAX
package's engine, on the CPU.

Checkpoints are written by the port's ``save_checkpoint`` (the JAX
package's bytes) into one directory per engine, and both engines read
them on a virtual clock (``clock=`` and ``sleep=``, so ``slow_decode``
stalls move virtual time). Each scenario of the JAX package's
tests/test_serve.py runs the same request set through both engines:

- rollover mid-decode, drain then swap;
- a corrupt newest checkpoint skipped by the poll;
- the ``rollover_corrupt`` fault aborting onto the old weights, then a
  newer checkpoint rolling over;
- the drain watchdog giving up on a staged step;
- the chaos drill: a 10x spike, ``slow_decode`` stalls, deadlines, the
  admission controller shedding and a ``rollover_corrupt`` abort.

The f32 tokens, each completion's ``weights_step``, ``rollovers``,
``rollover_aborts``, ``outcome_counts`` and the event records must equal
the JAX engine's. An abort's ``error`` text is the reader's own message
(the port's msgpack decoder words its errors differently), so it is held
to its prefix. Also: the MoE refusal, the slot-sharded engine's tokens
(the meshless engine's and JAX's 8-device mesh engine's) and the refusal
of slots that do not divide.
"""

import os
import types

import jax
import numpy as np
import pytest

from ps_pytorch_tpu import serve as jserve
from ps_pytorch_tpu.models import transformer as jtr
from ps_pytorch_tpu.parallel.mesh import make_mesh as jmake_mesh
from ps_pytorch_tpu.resilience.faults import FaultPlan as JFaultPlan
from ps_pytorch_tpu_torch import checkpoint as tckpt
from ps_pytorch_tpu_torch import serve as tserve
from ps_pytorch_tpu_torch.obs import validate_event
from ps_pytorch_tpu_torch.parallel.mesh import make_mesh
from ps_pytorch_tpu_torch.resilience.faults import FaultPlan
from tests.test_torch_one_thread import _one_thread  # noqa: F401

SHAPE = dict(vocab_size=29, dim=32, depth=2, heads=4, max_seq_len=64)
JCFG = jtr.TransformerConfig(**SHAPE)
POOL = dict(slots=3, max_len=48, max_prompt_len=12)


class VClock:
    """``()`` reads it, ``sleep`` advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


PKGS = {
    "jax": types.SimpleNamespace(
        serve=jserve, FaultPlan=JFaultPlan, kw={}),
    "torch": types.SimpleNamespace(
        serve=tserve, FaultPlan=FaultPlan, kw={"device": "cpu"}),
}


@pytest.fixture(scope="module")
def params():
    """Two weight sets (numpy trees) from JAX's init, seeds 0 and 1."""
    return [jax.tree.map(np.asarray, jtr.init_transformer(JCFG, jax.random.key(s)))
            for s in (0, 1)]


def _write(model_dir, step, tree, kind="dense"):
    tckpt.save_checkpoint({
        "params": tree, "step": step,
        "model": {"kind": kind, "vocab_size": JCFG.vocab_size, "dim": JCFG.dim,
                  "depth": JCFG.depth, "heads": JCFG.heads, "mlp_ratio": JCFG.mlp_ratio,
                  "max_seq_len": JCFG.max_seq_len},
        "data": {"seed": 1, "seq_len": 32},
    }, str(model_dir), step)


def _requests(pkg, shapes, seed=0, rid0=0):
    rng = np.random.RandomState(seed)
    return [pkg.serve.Request(rid=rid0 + i,
                              prompt=rng.randint(0, JCFG.vocab_size, p).astype(np.int32),
                              max_new_tokens=n)
            for i, (p, n) in enumerate(shapes)]


def _engine(pkg, d, step=1, serve=None, **kw):
    return pkg.serve.ServingEngine.from_checkpoint(
        str(d), serve or pkg.serve.ServeConfig(**POOL), step=step, **pkg.kw, **kw)


def _record(engine, done, events):
    return {
        "tokens": {rid: [int(t) for t in c.tokens] for rid, c in sorted(done.items())},
        "weights_step": {rid: c.weights_step for rid, c in sorted(done.items())},
        "step": engine.step,
        "rollovers": [dict(r) for r in engine.rollovers],
        "rollover_aborts": list(engine.rollover_aborts),
        "outcome_counts": dict(engine.outcome_counts),
        "outcomes": dict(engine.outcomes),
        "events": list(events),
    }


def _tick_to_idle(engine, done):
    while not engine.scheduler.idle or engine.draining:
        for c in engine.tick():
            done[c.rid] = c


def _mid_decode(pkg, d, params):
    _write(d, 1, params[0])
    vc, events = VClock(), []
    engine = _engine(pkg, d, clock=vc, event_sink=events.append)
    assert engine.step == 1
    engine.submit(_requests(pkg, [(5, 20)])[0])
    for _ in range(3):  # mid-decode: 3 of 20 tokens out
        engine.tick()
        vc.t += 0.01
    _write(d, 2, params[1])
    assert engine.poll_rollover() == 2 and engine.draining
    assert engine.poll_rollover() is None and engine.draining
    engine.submit(_requests(pkg, [(6, 7)], rid0=1)[0])
    done = {}
    while not engine.scheduler.idle or engine.draining:
        for c in engine.tick():
            done[c.rid] = c
        if engine.draining:  # admission paused while draining
            assert engine.scheduler.n_queued == 1
        vc.t += 0.01
    return _record(engine, done, events)


def _corrupt_newest(pkg, d, params):
    _write(d, 1, params[0])
    engine = _engine(pkg, d, step=None)
    assert engine.step == 1
    _write(d, 2, params[1])
    path = tckpt.checkpoint_path(str(d), 2)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF  # the CRC no longer matches
    open(path, "wb").write(bytes(blob))
    assert engine.poll_rollover() is None
    assert engine.step == 1 and not engine.draining
    done = {c.rid: c for c in engine.decode_requests(_requests(pkg, [(4, 6), (7, 5)]),
                                                      poll_every=2)}
    return _record(engine, done, [])


def _corrupt_staged(pkg, d, params):
    _write(d, 1, params[0])
    vc, events = VClock(), []
    engine = _engine(pkg, d, clock=vc, event_sink=events.append,
                     faults=pkg.FaultPlan.parse('{"rollover_corrupt": [2]}'))
    engine.submit(_requests(pkg, [(5, 12)])[0])
    for _ in range(3):
        engine.tick()
    _write(d, 2, params[1])
    assert engine.poll_rollover() == 2  # the fault truncates it once staged
    assert engine.draining and engine.scheduler.n_inflight == 1
    done = {}
    _tick_to_idle(engine, done)
    assert engine.step == 1 and engine.rollovers == []
    assert os.path.exists(tckpt.checkpoint_path(str(d), 2))  # not quarantined
    assert engine.poll_rollover() is None and not engine.draining
    for c in engine.decode_requests(_requests(pkg, [(6, 7)], seed=2, rid0=1)):
        done[c.rid] = c
    _write(d, 3, params[1])
    assert engine.poll_rollover() == 3
    for c in engine.decode_requests(_requests(pkg, [(6, 7)], seed=4, rid0=2)):
        done[c.rid] = c
    return _record(engine, done, events)


def _watchdog(pkg, d, params):
    _write(d, 1, params[0])
    vc, events = VClock(), []
    engine = _engine(pkg, d, clock=vc, event_sink=events.append, drain_timeout_s=0.05)
    engine.submit(_requests(pkg, [(4, 30)])[0])  # a long-running in-flight
    engine.tick()
    _write(d, 2, params[1])
    assert engine.poll_rollover() == 2
    engine.submit(_requests(pkg, [(4, 4)], seed=1, rid0=1)[0])  # behind the drain
    for _ in range(4):
        vc.t += 0.02
        engine.tick()
    assert not engine.draining  # the watchdog gave up
    assert engine.scheduler.n_queued == 0 and engine.scheduler.n_inflight == 2
    assert engine.poll_rollover() is None  # the abandoned step never again
    _write(d, 3, params[1])
    assert engine.poll_rollover() == 3
    done = {}
    _tick_to_idle(engine, done)
    return _record(engine, done, events)


def _chaos(pkg, d, params):
    _write(d, 1, params[0])
    events, vc = [], VClock()
    ctrl = pkg.serve.AdmissionController(slo_budget_s=0.3, window_s=0.1, shed_max_frac=0.9,
                                         event_sink=events.append)
    plan = pkg.FaultPlan.parse('{"slow_decode": [5, 6, 7, 8], "slow_decode_s": 0.02,'
                               ' "rollover_corrupt": [2]}')
    engine = _engine(pkg, d, serve=pkg.serve.ServeConfig(**dict(POOL, slots=2)), clock=vc,
                     sleep=vc.sleep, admission=ctrl, faults=plan, event_sink=events.append)
    engine.warmup()
    tc = pkg.serve.TrafficConfig(
        n_requests=36, rate_rps=30.0, prompt_len_min=2, prompt_len_max=8,
        new_tokens_min=4, new_tokens_max=6, vocab_size=JCFG.vocab_size, seed=1,
        spike=(10.0, 0.0, 2.0), deadline_s=0.2)
    pending = sorted(pkg.serve.make_requests(tc), key=lambda r: r.arrival_s)
    done, ticks = {}, 0
    while pending or not engine.scheduler.idle or engine.draining:
        while pending and pending[0].arrival_s <= vc.t:
            engine.submit(pending.pop(0))
        if ticks == 4:
            _write(d, 2, params[1])
            assert engine.poll_rollover() == 2
            assert engine.draining and engine.scheduler.n_inflight > 0
        for c in engine.tick():
            done[c.rid] = c
        vc.t += 0.01
        ticks += 1
        assert ticks < 20000
    counts = engine.outcome_counts
    assert counts["shed"] >= 1 and counts["expired"] >= 1 and counts["completed"] >= 1
    assert sum(counts.values()) == 36 and set(engine.outcomes) == set(range(36))
    terminal = {"request_done": "completed", "request_shed": "shed",
                "deadline_expired": "expired"}
    rids = sorted(e["rid"] for e in events if e["kind"] in terminal)
    assert rids == list(range(36))  # one terminal record a request
    rec = _record(engine, done, events)
    # the summary's aborts are rec["rollover_aborts"], compared on their own
    summary = pkg.serve.summarize(list(done.values()), vc.t, engine)
    rec["summary"] = {k: v for k, v in summary.items() if k != "rollover_aborts"}
    return rec


SCENARIOS = {"mid_decode": _mid_decode, "corrupt_newest": _corrupt_newest,
             "corrupt_staged": _corrupt_staged, "watchdog": _watchdog, "chaos": _chaos}


def _strip_errors(rec, d):
    """An abort's ``error`` text down to its prefix, the directory
    named as ``D`` (the reader's own message follows the colon)."""
    def cut(r):
        if "error" in r:
            r = dict(r, error=r["error"].replace(str(d), "D").split(":")[0])
        return r
    return dict(rec, rollover_aborts=[cut(a) for a in rec["rollover_aborts"]],
                events=[cut(e) for e in rec["events"]])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_torch_rollover_scenarios_equal_jax(name, params, tmp_path):
    got = SCENARIOS[name](PKGS["torch"], tmp_path / "torch", params)
    want = SCENARIOS[name](PKGS["jax"], tmp_path / "jax", params)
    for e in got["events"]:
        validate_event(dict(e))
    assert _strip_errors(got, tmp_path / "torch") == _strip_errors(want, tmp_path / "jax")
    for a in got["rollover_aborts"]:
        assert a["error"] if a["reason"] == "corrupt_staged" else a["error"] == ""
    if name == "mid_decode":
        # the in-flight request finished on the old weights, the queued one
        # on the new
        assert got["weights_step"] == {0: 1, 1: 2} and got["step"] == 2
        assert [(r["from_step"], r["to_step"]) for r in got["rollovers"]] == [(1, 2)]
    if name == "corrupt_staged":
        assert got["weights_step"] == {0: 1, 1: 1, 2: 3}
        assert [a["reason"] for a in got["rollover_aborts"]] == ["corrupt_staged"]
    if name == "watchdog":
        assert [a["reason"] for a in got["rollover_aborts"]] == ["drain_timeout"]
    if name == "chaos":
        assert got["step"] == 1 and got["rollovers"] == []
        assert set(got["weights_step"].values()) == {1}
        assert got["summary"] == want["summary"]


def test_torch_rollover_tokens_follow_the_weights_of_their_step(params, tmp_path):
    """The port engine's post-swap tokens are a fresh engine's on the new
    weights (and pre-swap ones the old weights'): a swap is a full copy."""
    d = tmp_path / "m"
    rec = _mid_decode(PKGS["torch"], d, params)
    for rid, step, shape in ((0, 1, (5, 20)), (1, 2, (6, 7))):
        fresh = _engine(PKGS["torch"], d, step=step)
        (c,) = fresh.decode_requests(_requests(PKGS["torch"], [shape], rid0=rid))
        assert [int(t) for t in c.tokens] == rec["tokens"][rid]


def test_torch_from_checkpoint_refuses_moe_as_jax(params, tmp_path):
    _write(tmp_path, 1, params[0], kind="moe")
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="dense"):
            _engine(pkg, tmp_path)


def test_torch_slot_sharded_engine_tokens_equal_meshless_and_jax_mesh(params, tmp_path):
    """Slots over an 8-worker axis: the pool is viewed as 8 bands of one
    slot; the tokens are the meshless engine's and JAX's 8-device mesh
    engine's."""
    _write(tmp_path, 1, params[0])
    shapes = [(5, 9), (1, 6), (12, 8), (7, 14), (3, 5), (9, 4), (2, 11), (6, 6), (4, 7)]
    serve = dict(POOL, slots=8)
    out = {}
    for key, pkg, mesh in (("mesh", PKGS["torch"], make_mesh(8)),
                           ("flat", PKGS["torch"], None),
                           ("jax_mesh", PKGS["jax"], jmake_mesh(num_workers=8))):
        engine = _engine(pkg, tmp_path, serve=pkg.serve.ServeConfig(**serve), mesh=mesh)
        out[key] = [[int(t) for t in c.tokens]
                    for c in engine.decode_requests(_requests(pkg, shapes))]
        if key == "mesh":
            bands = engine.pool_bands()
            assert bands["k"].shape == (JCFG.depth, 8, 1, POOL["max_len"], JCFG.heads,
                                        JCFG.head_dim)
            assert bands["k"].data_ptr() == engine._pool["k"].data_ptr()
    assert out["mesh"] == out["flat"] == out["jax_mesh"]


def test_torch_slots_that_do_not_divide_are_refused_as_jax(params, tmp_path):
    _write(tmp_path, 1, params[0])
    msgs = []
    for pkg, mesh in ((PKGS["torch"], make_mesh(2)), (PKGS["jax"], jmake_mesh(num_workers=2))):
        with pytest.raises(ValueError, match="divide over the mesh") as e:
            _engine(pkg, tmp_path, serve=pkg.serve.ServeConfig(**POOL), mesh=mesh)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_torch_swap_reads_fresh_views(params, tmp_path):
    """The swap copies into the same device buffer; ``tree_view``
    re-derives the blocks' views from it on every call, so nothing
    holds a view of the old weights."""
    from ps_pytorch_tpu_torch.parallel.buckets import tree_view

    _write(tmp_path, 1, params[0])
    engine = _engine(PKGS["torch"], tmp_path)
    flat = engine._params.flat
    _write(tmp_path, 2, params[1])
    assert engine.poll_rollover() == 2
    engine.tick()  # nothing in flight: the swap happens at once
    assert engine.step == 2 and engine._params.flat is flat
    np.testing.assert_array_equal(tree_view(engine._params)["embed"].numpy(),
                                  params[1]["embed"])
