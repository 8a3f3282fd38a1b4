"""Port parity: ps_pytorch_tpu_torch.cli.train_lm (the LM training CLI on
the dp x sp step) and optim/schedules.py, against the JAX package.

- ``make_synthetic_tokens`` is numpy on both sides: equal array for array;
- the learning-rate schedules the CLI builds (constant, linear warm-up
  joined to a constant, warm-up cosine decay) equal optax's values step by
  step, within 1e-6 relative (f32 ``cos`` of two libraries);
- the CLI refuses the flag combinations JAX refuses, runs 3 steps on the
  CPU with ``--device cpu``, and without it raises on a machine with no
  card.
"""

import json

import numpy as np
import optax
import pytest
import torch

from ps_pytorch_tpu.cli.train_lm import make_synthetic_tokens as j_tokens
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.optim.schedules import (
    constant_schedule,
    join_schedules,
    linear_schedule,
    warmup_cosine_decay_schedule,
)

SMALL = ["--vocab-size", "48", "--dim", "32", "--depth", "2", "--heads", "2",
         "--seq-len", "32", "--batch-size", "4", "--max-steps", "3",
         "--log-interval", "1"]


@pytest.mark.parametrize("vocab,n,t,seed,seq_seed", [
    (256, 16, 64, 2, None), (2048, 8, 33, 7, None), (48, 5, 10, 0, 123),
])
def test_torch_synthetic_tokens_equal_jax(vocab, n, t, seed, seq_seed):
    got = train_lm.make_synthetic_tokens(vocab, n, t, seed=seed, sequence_seed=seq_seed)
    want = j_tokens(vocab, n, t, seed=seed, sequence_seed=seq_seed)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def _optax_lr(name, lr, warmup, max_steps):
    """What cli/train_lm.py:158-174 builds."""
    if name == "cosine":
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=warmup,
            decay_steps=max(max_steps, warmup + 1))
    if warmup > 0:
        return optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warmup), optax.constant_schedule(lr)],
            [warmup])
    return lambda count: lr


@pytest.mark.parametrize("name,warmup,max_steps", [
    ("constant", 0, 20), ("constant", 5, 20), ("cosine", 0, 20), ("cosine", 4, 20),
    ("cosine", 30, 20),
])
def test_torch_lr_schedules_equal_optax(name, warmup, max_steps):
    ours = train_lm.lr_schedule(name, 0.05, warmup, max_steps)
    theirs = _optax_lr(name, 0.05, warmup, max_steps)
    for count in range(max_steps + 3):
        want = float(np.asarray(theirs(np.int32(count))))
        got_int = float(ours(count)) if callable(ours) else ours
        got_dev = (float(ours(torch.tensor(count, dtype=torch.int32)))
                   if callable(ours) else ours)
        assert got_int == pytest.approx(want, rel=1e-6, abs=1e-12)
        assert got_dev == got_int


def test_torch_schedule_pieces_equal_optax():
    pieces = [
        (linear_schedule(0.1, 0.3, 7), optax.linear_schedule(0.1, 0.3, 7)),
        (linear_schedule(0.2, 0.0, 0), optax.linear_schedule(0.2, 0.0, 0)),
        (constant_schedule(0.4), optax.constant_schedule(0.4)),
        (join_schedules([constant_schedule(1.0), linear_schedule(1.0, 0.0, 4)], [3]),
         optax.join_schedules([optax.constant_schedule(1.0),
                               optax.linear_schedule(1.0, 0.0, 4)], [3])),
        (warmup_cosine_decay_schedule(0.01, 0.5, 3, 11, end_value=0.05),
         optax.warmup_cosine_decay_schedule(0.01, 0.5, 3, 11, end_value=0.05)),
    ]
    for ours, theirs in pieces:
        for count in range(14):
            want = float(np.asarray(theirs(np.int32(count))))
            assert float(ours(count)) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_torch_sgd_reads_a_schedule_at_the_step_count():
    """SGD calls the schedule with its count (0 on the first update), as
    the JAX sgd does; a warm-up from 0 leaves the first step's params."""
    tx = build_optimizer("sgd", train_lm.lr_schedule("constant", 0.1, 2, 10), momentum=0.0)
    p = {"w": torch.ones(3)}
    st = tx.init(p)
    rates = []
    for _ in range(4):
        upd, st = tx.update({"w": torch.ones(3)}, st, p)
        rates.append(-float(upd["w"][0]))
    assert rates == pytest.approx([0.0, 0.05, 0.1, 0.1], rel=1e-6)


@pytest.mark.parametrize("flags,exc,match", [
    # every --parallelism and --profile-dir run since their port
    # (tests/test_torch_{tp,dp_tp,pp,moe,ep_sp,pp_moe,profiler}.py)
    (["--shard-vocab"], ValueError, "tp/dp_tp"),
    (["--num-sp", "3"], ValueError, "divisible by num_sp"),
    (["--num-dp", "3"], ValueError, "divisible by num_dp"),
])
def test_torch_cli_train_lm_refuses(flags, exc, match):
    with pytest.raises(exc, match=match):
        train_lm.main(SMALL + ["--device", "cpu"] + flags)


def test_torch_cli_train_lm_writes_the_metrics_file(tmp_path):
    """Once refused: ``--metrics-file`` gets a run header, then one
    ``train_lm`` record a log window, each valid under both packages'
    schemas."""
    from ps_pytorch_tpu.obs.schema import validate_event as jvalidate
    from ps_pytorch_tpu_torch.obs.schema import validate_event

    path = tmp_path / "m.jsonl"
    out = train_lm.main(SMALL + ["--device", "cpu", "--metrics-file", str(path)])
    recs = [json.loads(x) for x in open(path)]
    assert [r["kind"] for r in recs] == ["run_header"] + ["train_lm"] * len(out["history"])
    assert [r["step"] for r in recs[1:]] == [h["step"] for h in out["history"]]
    for r in recs:
        validate_event(dict(r))
        jvalidate(dict(r))


@pytest.mark.parametrize("flags", [
    ["--num-dp", "2", "--num-sp", "4", "--attention-impl", "flash", "--remat"],
    ["--num-sp", "2", "--attention-impl", "flash", "--dtype", "bfloat16",
     "--lr-schedule", "cosine", "--warmup-steps", "1"],
    ["--num-dp", "2", "--num-sp", "2", "--sp-attention", "ulysses",
     "--attention-impl", "flash"],
    ["--num-sp", "4", "--bidirectional-ring", "--attention-impl", "flash"],
    [],  # --num-sp 0: all remaining devices, 1 on one card; naive attention
])
def test_torch_cli_train_lm_runs_on_cpu(flags):
    out = train_lm.main(SMALL + ["--device", "cpu"] + flags)
    assert set(out) == {"loss", "params", "layout", "profile", "steady_steps",
                        "steady_elapsed_s", "history"}
    assert out["layout"].startswith("dp ") and out["profile"].dir is None
    assert out["params"] == 48 * 32 + 32 * 32 + 32 + 2 * (2 * 32 + 32 * 96 + 32 * 32
                                                           + 2 * 32 * 128)
    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["loss"] == out["history"][-1]["loss"]
    assert out["steady_steps"] == 1


def test_torch_cli_train_lm_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(SMALL)
