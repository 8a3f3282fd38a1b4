"""Port parity: ps_pytorch_tpu_torch.parallel.moe (Mixture-of-Experts on a
stacked axis of expert shards) against the JAX package's parallel/moe.py
on the 8-device CPU mesh.

The same JAX-initialised weights (``init_moe_params`` through the port's
``params_from_jax``) and numpy inputs go through both:

- ``WorkerAxis.all_to_all_tiled`` is ``lax.all_to_all(tiled=True)`` bit for
  bit, both ways, under shard_map;
- ``_gate_and_dispatch``, top-1 and top-2, roomy and dropping (capacity
  factor 0.5, where the second choices queue behind every first
  choice): dispatch bit for bit, combine and aux within 2 ulps;
- ``moe_mlp_local``, local and over 4 stacked shards against JAX's
  shard_map, and the 4-shard forward, within 3e-5 (tests/test_moe.py:73);
- one moe SGD step at 4 shards, top-1 and top-2 at capacity factor 1.25
  (tokens drop), remat on and off: loss, aux and params within the JAX
  package's 3e-5;
- greedy MoE decode gives JAX's tokens; the errors JAX raises; one
  attention call a block; the CLI's ``moe`` branch.

Every gate call the port makes is replayed through JAX's jitted gate on
the same inputs: the expert choices must be equal (the dispatch bit for
bit), and the smallest top-1 / top-2 margin of the run is printed (a
flip would show as a mismatch beside its margin).
"""

import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu.models import decode as jdecode
from ps_pytorch_tpu.models.transformer import TransformerConfig as JConfig
from ps_pytorch_tpu.optim import sgd as j_sgd
from ps_pytorch_tpu.parallel import moe as jmoe
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models import decode
from ps_pytorch_tpu_torch.models.transformer import TransformerConfig as TConfig
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import moe
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_tp import LM, assert_trees

tfa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
SHAPE = dict(vocab_size=47, dim=32, depth=2, heads=4, max_seq_len=16)
N = 4
B, T = 8, 16
LR = 0.1
TOL = 3e-5  # tests/test_moe.py:73
GATE = moe._gate_and_dispatch  # the port's gate, unrecorded


def f32_ulps(got, want, n):
    """|got - want| within n ulps of want (elementwise, f32)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want))
    return bool((np.abs(got - want) <= n * ulp).all())


@functools.lru_cache(maxsize=None)
def _jax_gate(capacity, top_k):
    return jax.jit(functools.partial(jmoe._gate_and_dispatch, capacity=capacity,
                                     top_k=top_k))


def record_gates(monkeypatch):
    """Record the inputs of every gate call the port makes."""
    calls = []

    def rec(x2d, wg, capacity, top_k=1):
        calls.append((x2d.detach().float().cpu().numpy(),
                      wg.detach().float().cpu().numpy(), capacity, top_k))
        return GATE(x2d, wg, capacity, top_k)

    monkeypatch.setattr(moe, "_gate_and_dispatch", rec)
    return calls


def margins(x2d, wg, top_k):
    """The smallest gap between the chosen and the next probability (f64)
    over rows without an exact tie, top-1 / top-2 for the first choice
    and top-2 / top-3 for the second, and the count of exactly tied rows
    (equal logits, e.g. a pipeline's all-zero warm-up rows: both argmaxes
    take the first maximum there)."""
    logits = x2d.astype(np.float64) @ wg.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[..., ::-1]
    gaps = [p[..., 0] - p[..., 1]] + ([p[..., 1] - p[..., 2]] if top_k == 2 else [])
    return ([float(g[g > 0].min()) if (g > 0).any() else np.inf for g in gaps]
            + [np.inf] * (2 - len(gaps)), int(sum((g == 0).sum() for g in gaps)))


def check_choices(calls, what):
    """Each recorded gate call through JAX's jitted gate, shard by shard:
    the port's dispatch (its expert choices and slots) bit for bit JAX's;
    prints the run's smallest margins."""
    worst, ties = [np.inf, np.inf], 0
    for x2d, wg, capacity, top_k in calls:
        xs = x2d.reshape((-1,) + x2d.shape[-2:])
        ws = np.broadcast_to(wg, x2d.shape[:-2] + wg.shape[-2:]).reshape((-1,) + wg.shape[-2:])
        for x, w in zip(xs, ws):
            want = np.asarray(_jax_gate(capacity, top_k)(jnp.asarray(x), jnp.asarray(w))[0])
            got = GATE(torch.tensor(x), torch.tensor(w), capacity, top_k)[0].numpy()
            (m1, m2), tied = margins(x, w, top_k)
            worst = [min(worst[0], m1), min(worst[1], m2)]
            ties += tied
            assert np.array_equal(got, want), (
                f"{what}: expert choices differ (smallest top-1 margin {m1:.3g}, "
                f"top-2 {m2:.3g})")
    print(f"{what}: {len(calls)} gate calls, smallest top-1 margin {worst[0]:.4g}, "
          f"top-2 margin {worst[1]:.4g}, {ties} exact ties")
    assert calls


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jmoe.init_moe_params(
        JConfig(**SHAPE), jmoe.MoEConfig(num_experts=8), jax.random.key(1)))


def _tokens(seed=0, b=B):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], (b, T)).astype(np.int32)


def _blk(params_np, i=0):
    return convert.params_from_jax(params_np["blocks"][i], device="cpu")


# ----------------------------------------------------------- the all_to_all

@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0)])
def test_torch_all_to_all_tiled_matches_lax(split, concat):
    n = 4
    x = np.random.RandomState(0).randn(n * 8, 4, 3).astype(np.float32)  # [n E, C, D]
    mesh = jmoe.make_ep_mesh(n)

    def local(v):
        return jax.lax.all_to_all(v, jmoe.EP_AXIS, split_axis=split, concat_axis=concat,
                                  tiled=True)

    want = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P(jmoe.EP_AXIS),
                                 out_specs=P(jmoe.EP_AXIS), check_vma=False))(x)
    got = WorkerAxis(n).all_to_all_tiled(torch.from_numpy(x).reshape(n, 8, 4, 3),
                                          split, concat)
    assert np.array_equal(got.reshape((-1,) + tuple(got.shape[2:])).numpy(),
                          np.asarray(want))


# ------------------------------------------------------------- the gating

@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "drops"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_torch_moe_gate_and_dispatch_matches_jax(top_k, cf):
    """Dyadic inputs (a few bits each), so the gate product is exact in
    any summation order and the test sees the gating itself: softmax,
    both argmaxes (exact ties included: each takes the first maximum),
    the cumsum ranks and the capacity queue."""
    rng = np.random.RandomState(top_k)
    n_tok, d, e = 64, 16, 8
    x = (rng.randint(-8, 9, (n_tok, d)) / 8).astype(np.float32)
    wg = (rng.randint(-8, 9, (d, e)) / 32).astype(np.float32)
    capacity = int(np.ceil(n_tok * top_k * cf / e))
    disp_w, comb_w, aux_w = (np.asarray(a) for a in _jax_gate(capacity, top_k)(
        jnp.asarray(x), jnp.asarray(wg)))
    disp, comb, aux = (a.numpy() for a in moe._gate_and_dispatch(
        torch.from_numpy(x), torch.from_numpy(wg), capacity, top_k))
    (m1, m2), tied = margins(x, wg, top_k)
    print(f"top-{top_k} cf {cf}: smallest top-1 margin {m1:.4g}, top-2 {m2:.4g}, "
          f"{tied} exact ties")
    assert disp.shape == (n_tok, e, capacity)
    assert np.array_equal(disp, disp_w)
    assert f32_ulps(comb, comb_w, 2) and f32_ulps(aux, aux_w, 2)
    kept = disp.sum((1, 2))
    if cf < 1:  # tokens drop: a dropped token owns no slot at all
        assert (kept < top_k).any()
    if top_k == 2:  # a second choice never lands on its token's first expert
        assert disp.max() == 1.0


def test_torch_moe_choice_dispatch_drops_ranks_past_capacity():
    """A rank at or past C gives an all-zero row (JAX's one_hot), where
    ``F.one_hot`` would raise: every token routed to expert 0, capacity 2."""
    onehot = torch.zeros(5, 3)
    onehot[:, 0] = 1
    d = moe._choice_dispatch(onehot, 2, torch.zeros(3))
    want = np.asarray(jmoe._choice_dispatch(jnp.asarray(onehot.numpy()), 2, jnp.zeros(3)))
    assert np.array_equal(d.numpy(), want)
    assert d.sum((1, 2)).tolist() == [1, 1, 0, 0, 0]


# ---------------------------------------------------- the MLP and the forward

@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("where", ["local", "shards4"])
def test_torch_moe_mlp_local_matches_jax(jax_params, monkeypatch, where, top_k):
    mcfg = jmoe.MoEConfig(num_experts=8, capacity_factor=1.25, top_k=top_k)
    tcfg = moe.MoEConfig(num_experts=8, capacity_factor=1.25, top_k=top_k)
    blk = jax_params["blocks"][0]
    h = np.random.RandomState(3).randn(N * 2, T, SHAPE["dim"]).astype(np.float32)
    calls = record_gates(monkeypatch)
    if where == "local":
        want, aux_w = jax.jit(functools.partial(jmoe.moe_mlp_local, moe=mcfg,
                                                axis_name=None))(h, blk)
        got, aux = moe.moe_mlp_local(torch.from_numpy(h), _blk(jax_params), tcfg, None)
        got, aux_w = got.numpy(), np.asarray(aux_w)
    else:
        mesh = jmoe.make_ep_mesh(N)
        specs = {k: P(jmoe.EP_AXIS) if k in moe.EXPERT_LEAVES else P() for k in blk}

        def local(hh, bb):
            out, a = jmoe.moe_mlp_local(hh, bb, mcfg, jmoe.EP_AXIS)
            return out, a[None]

        want, aux_w = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(jmoe.EP_AXIS), specs),
                                            out_specs=(P(jmoe.EP_AXIS), P(jmoe.EP_AXIS)),
                                            check_vma=False))(h, blk)
        tb = moe.shard_params_moe(None, {"blocks": [_blk(jax_params)]},
                                  WorkerAxis(N))["blocks"][0]
        got, aux = moe.moe_mlp_local(torch.from_numpy(h).reshape(N, 2, T, SHAPE["dim"]), tb,
                                     tcfg, WorkerAxis(N))
        got, aux_w = got.reshape(h.shape).numpy(), np.asarray(aux_w)
    check_choices(calls, f"moe_mlp_local {where} top-{top_k}")
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux.numpy(), aux_w, rtol=1e-6)


def test_torch_moe_forward_matches_jax(jax_params, monkeypatch):
    """The 4-shard forward against JAX's shard_map: logits and each
    shard's aux."""
    cfg = JConfig(**SHAPE)
    mcfg = jmoe.MoEConfig(num_experts=8)
    mesh = jmoe.make_ep_mesh(N)

    def local(p, tok):
        logits, aux = jmoe.apply_moe_transformer(cfg, mcfg, p, tok, jmoe.EP_AXIS)
        return logits, aux[None]

    tok = _tokens(5)
    want, aux_w = jax.jit(jax.shard_map(local, mesh=mesh,
                                        in_specs=(jmoe.moe_param_specs(cfg), P(jmoe.EP_AXIS)),
                                        out_specs=(P(jmoe.EP_AXIS), P(jmoe.EP_AXIS)),
                                        check_vma=False))(jax_params, tok)
    calls = record_gates(monkeypatch)
    tcfg = TConfig(**SHAPE)
    params = moe.shard_params_moe(tcfg, convert.params_from_jax(jax_params, device="cpu"),
                                  WorkerAxis(N))
    got, aux = moe.apply_moe_transformer(tcfg, moe.MoEConfig(num_experts=8), params,
                                         moe.shard_moe_batch(torch.from_numpy(tok),
                                                             WorkerAxis(N)), WorkerAxis(N))
    check_choices(calls, "moe forward")
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(aux_w), rtol=1e-6)


# -------------------------------------------------------------------- a step

@pytest.fixture(scope="module")
def jax_steps(jax_params):
    cache = {}

    def get(top_k):
        if top_k not in cache:
            cfg = JConfig(**SHAPE)
            mcfg = jmoe.MoEConfig(num_experts=8, top_k=top_k)
            mesh = jmoe.make_ep_mesh(N)
            tx = j_sgd(LR)
            p = jmoe.shard_params_moe(cfg, jax_params, mesh)
            step = jmoe.make_moe_train_step(cfg, mcfg, tx, mesh, donate=False)
            p, _, task, aux = step(p, tx.init(p),
                                   jmoe.shard_moe_batch(jnp.asarray(_tokens(1)), mesh))
            cache[top_k] = (float(task), float(aux), jax.tree.map(np.asarray,
                                                                  jax.device_get(p)))
        return cache[top_k]

    return get


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_torch_moe_step_matches_jax(jax_params, jax_steps, monkeypatch, top_k, remat):
    want_task, want_aux, want = jax_steps(top_k)
    calls = record_gates(monkeypatch)
    cfg = TConfig(**SHAPE, remat=remat)
    mcfg = moe.MoEConfig(num_experts=8, top_k=top_k)
    mesh = moe.make_ep_mesh(N)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = moe.shard_params_moe(cfg, convert.params_from_jax(jax_params, device="cpu"), mesh)
    p, _, task, aux = moe.make_moe_train_step(cfg, mcfg, tx, mesh)(
        p, tx.init(p), moe.shard_moe_batch(torch.from_numpy(_tokens(1)), mesh))
    check_choices(calls, f"moe step top-{top_k}")
    assert abs(float(task) - want_task) < TOL, (float(task), want_task)
    assert abs(float(aux) - want_aux) < TOL, (float(aux), want_aux)
    assert_trees(convert.params_to_numpy(moe.unshard_params_moe(cfg, p)), want,
                 rtol=TOL, atol=TOL)


def test_torch_moe_refuses_what_jax_refuses(jax_params):
    with pytest.raises(ValueError, match="top_k must be 1 or 2, got 3") as want:
        jmoe.MoEConfig(top_k=3)
    with pytest.raises(ValueError, match="top_k must be 1 or 2, got 3") as got:
        moe.MoEConfig(top_k=3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="8 experts not divisible by 3") as want:
        jmoe.shard_params_moe(JConfig(**SHAPE), jax_params, jmoe.make_ep_mesh(3))
    with pytest.raises(ValueError, match="8 experts not divisible by 3") as got:
        moe.shard_params_moe(TConfig(**SHAPE), convert.params_from_jax(jax_params,
                                                                       device="cpu"),
                             moe.make_ep_mesh(3))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_torch_moe_attention_calls_per_step(jax_params, monkeypatch, remat):
    """K4 (flash_fwd) and K5 + K6 (flash_bwd) wrapper calls a step: one a
    block over every shard's rows."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_fwd, tfa.flash_bwd

    def count_fwd(q, *a, **kw):
        calls["fwd"] += 1
        assert q.shape[0] == B  # the 4 shards' 2 rows each fold into one call
        return fwd(q, *a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd", count_fwd)
    monkeypatch.setattr(tfa, "flash_bwd", count_bwd)
    cfg = TConfig(**SHAPE, attention_impl="flash", remat=remat)
    mesh = moe.make_ep_mesh(N)
    tx = build_optimizer("sgd", LR, momentum=0.0)
    p = moe.shard_params_moe(cfg, convert.params_from_jax(jax_params, device="cpu"), mesh)
    moe.make_moe_train_step(cfg, moe.MoEConfig(), tx, mesh)(
        p, tx.init(p), moe.shard_moe_batch(torch.from_numpy(_tokens()), mesh))
    assert calls == {"fwd": SHAPE["depth"] * (2 if remat else 1), "bwd": SHAPE["depth"]}


@pytest.mark.parametrize("top_k", [1, 2])
def test_torch_moe_greedy_decode_matches_jax(jax_params, monkeypatch, top_k):
    """``generate(..., moe=)``: greedy tokens equal JAX's from the same
    params (prefill of 5 prompt tokens, then 6 decode steps; roomy
    capacity, so nothing drops)."""
    prompt = _tokens(7, b=2)[:, :6]
    want = np.asarray(jdecode.generate(JConfig(**SHAPE), jax.tree.map(jnp.asarray, jax_params),
                                       jnp.asarray(prompt), 6,
                                       moe=jmoe.MoEConfig(num_experts=8, top_k=top_k)))
    calls = record_gates(monkeypatch)
    got = decode.generate(TConfig(**SHAPE), convert.params_from_jax(jax_params, device="cpu"),
                          torch.from_numpy(prompt), 6, device="cpu",
                          moe=moe.MoEConfig(num_experts=8, top_k=top_k))
    check_choices(calls, f"moe decode top-{top_k}")
    # roomy capacity: B tokens a decode step, none dropped
    assert {c for _, _, c, _ in calls} >= {2 * top_k}
    assert np.array_equal(got.numpy(), want)


def test_torch_cli_train_lm_moe_runs_with_aux_records(tmp_path):
    """``--parallelism moe``: finite, falling losses; each record carries
    ``aux_loss`` and is valid under both packages' schemas; the checkpoint
    is ``kind: moe`` in the plain MoE layout."""
    from ps_pytorch_tpu.obs.schema import validate_event as jvalidate
    from ps_pytorch_tpu_torch.checkpoint import listify_raw, load_checkpoint_raw
    from ps_pytorch_tpu_torch.obs.schema import validate_event

    path = tmp_path / "m.jsonl"
    out = train_lm.main(LM + ["--parallelism", "moe", "--num-shards", "4", "--top-k", "2",
                              "--metrics-file", str(path), "--train-dir", str(tmp_path),
                              "--remat"])
    assert out["layout"] == "moe 8 experts over 4 shards"
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(np.isfinite(h["aux_loss"]) for h in out["history"])
    recs = [json.loads(x) for x in open(path)]
    assert [r["kind"] for r in recs] == ["run_header"] + ["train_lm"] * 4
    for r in recs:
        validate_event(dict(r))
        jvalidate(dict(r))
    assert all("aux_loss" in r for r in recs[1:])
    raw = load_checkpoint_raw(str(tmp_path), 4)
    blk = listify_raw(raw["params"])["blocks"][0]
    assert raw["model"]["kind"] == "moe" and raw["model"]["top_k"] == 2
    assert np.asarray(blk["w_up_e"]).shape == (8, 32, 128) and "w_up" not in blk
    with pytest.raises(ValueError, match="divisible by expert shards=3"):
        train_lm.main(LM + ["--parallelism", "moe", "--num-shards", "3"])
    with pytest.raises(ValueError, match="6 experts not divisible by 4 expert shards"):
        train_lm.main(LM + ["--parallelism", "moe", "--num-shards", "4", "--num-experts", "6"])
