"""Port parity: ps_pytorch_tpu_torch.cli.evaluate_lm (the LM evaluator)
against the JAX package's cli/evaluate_lm.py.

- on a dense checkpoint the JAX package writes, the port's
  ``evaluate_checkpoint`` gives JAX's held-out loss within 1e-5
  relative (and its perplexity), over the same eval split
  (``EVAL_SEQUENCE_SEED_OFFSET``);
- a checkpoint the port's ``cli.train_lm --device cpu`` writes under
  ``tp``, ``dp_tp`` and ``pp`` (the plain layout) loads in JAX's
  ``evaluate_checkpoint``, and both evaluators agree on it;
- ``main --once`` takes the newest valid step, the generated length is
  clamped to the model's positions;
- MoE checkpoints both ways: a JAX MoE checkpoint (top-1 and top-2) gives
  JAX's loss in the port's evaluator, the port's ``moe``, ``ep_sp`` and
  ``pp_moe`` checkpoints (the plain MoE layout) load in JAX's evaluator
  with the same loss, within 1e-5 relative; ``--generate`` samples a MoE
  checkpoint.
"""

import jax
import numpy as np
import pytest

from ps_pytorch_tpu.checkpoint import save_checkpoint as j_save
from ps_pytorch_tpu.cli import evaluate_lm as jeval
from ps_pytorch_tpu.models.transformer import TransformerConfig as JConfig
from ps_pytorch_tpu.models.transformer import init_transformer as j_init
from ps_pytorch_tpu_torch.cli import evaluate_lm, train_lm
from tests.test_torch_one_thread import _one_thread  # noqa: F401
from tests.test_torch_tp import LM

MODEL = dict(vocab_size=48, dim=32, depth=2, heads=4, mlp_ratio=4, max_seq_len=16)


def _jax_dir(path, kind="dense", steps=(3,)):
    """A directory of checkpoints the JAX package writes (cli/train_lm.py's
    dict), one per step, each with its own weights."""
    cfg = JConfig(**{k: v for k, v in MODEL.items()})
    for s in steps:
        j_save({
            "params": jax.device_get(j_init(cfg, jax.random.key(s))), "step": s,
            "model": {"kind": kind, **MODEL, "num_experts": 8, "capacity_factor": 1.25,
                      "top_k": 1},
            "data": {"seed": 5, "seq_len": 16},
        }, str(path), s)
    return str(path)


def test_torch_evaluate_lm_matches_jax_on_a_jax_checkpoint(tmp_path):
    d = _jax_dir(tmp_path)
    want = jeval.evaluate_checkpoint(d, 3, eval_size=24, batch_size=8)
    got = evaluate_lm.evaluate_checkpoint(d, 3, eval_size=24, batch_size=8, device="cpu")
    assert evaluate_lm.EVAL_SEQUENCE_SEED_OFFSET == jeval.EVAL_SEQUENCE_SEED_OFFSET
    assert got["step"] == 3
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(got["perplexity"] - want["perplexity"]) <= 2e-5 * want["perplexity"]


@pytest.mark.parametrize("flags", [
    ["--parallelism", "tp", "--num-shards", "4", "--shard-vocab"],
    ["--parallelism", "dp_tp", "--num-dp", "2", "--num-shards", "2"],
    ["--parallelism", "pp", "--num-shards", "2", "--num-microbatches", "2"],
], ids=["tp", "dp_tp", "pp"])
def test_torch_port_lm_checkpoint_loads_in_jax_evaluator(tmp_path, flags):
    train_lm.main(LM + ["--max-steps", "2", "--train-dir", str(tmp_path), *flags])
    want = jeval.evaluate_checkpoint(str(tmp_path), 2, eval_size=16, batch_size=8)
    got = evaluate_lm.evaluate_checkpoint(str(tmp_path), 2, eval_size=16, batch_size=8,
                                          device="cpu")
    assert np.isfinite(want["loss"])
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])


def test_torch_evaluate_lm_main_once_and_generation(tmp_path):
    d = _jax_dir(tmp_path, steps=(2, 4))
    res = evaluate_lm.main(["--device", "cpu", "--model-dir", d, "--once", "--eval-size",
                            "8", "--batch-size", "4", "--generate", "40"])
    assert list(res) == [4]
    samples = np.asarray(res[4]["samples"])
    # prompts of 8 tokens; 40 new clamped to max_seq_len 16 - 8
    assert samples.shape == (2, 16)
    assert ((samples >= 0) & (samples < MODEL["vocab_size"])).all()
    polled = evaluate_lm.main(["--device", "cpu", "--model-dir", d, "--eval-size", "8",
                               "--poll-interval", "0.01", "--timeout", "0"])
    assert list(polled) == [2, 4]
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        evaluate_lm.main(["--device", "cpu", "--model-dir", str(tmp_path / "none"), "--once"])


MOE_MODEL = {"num_experts": 8, "capacity_factor": 1.25}


def _jax_moe_dir(path, top_k, step=3):
    from ps_pytorch_tpu.parallel import moe as jmoe

    cfg = JConfig(**MODEL)
    params = jmoe.init_moe_params(cfg, jmoe.MoEConfig(top_k=top_k, **MOE_MODEL),
                                  jax.random.key(step))
    j_save({"params": jax.device_get(params), "step": step,
            "model": {"kind": "moe", **MODEL, **MOE_MODEL, "top_k": top_k},
            "data": {"seed": 5, "seq_len": 16}}, str(path), step)
    return str(path)


@pytest.mark.parametrize("top_k", [1, 2])
def test_torch_evaluate_lm_matches_jax_on_a_jax_moe_checkpoint(tmp_path, top_k):
    d = _jax_moe_dir(tmp_path, top_k)
    want = jeval.evaluate_checkpoint(d, 3, eval_size=24, batch_size=8)
    got = evaluate_lm.evaluate_checkpoint(d, 3, eval_size=24, batch_size=8, device="cpu")
    assert np.isfinite(want["loss"])
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])


@pytest.mark.parametrize("flags", [
    ["--parallelism", "moe", "--num-shards", "2", "--top-k", "2"],
    ["--parallelism", "ep_sp", "--num-shards", "2", "--num-sp", "2"],
    ["--parallelism", "pp_moe", "--num-shards", "2", "--num-ep", "2",
     "--num-microbatches", "2"],
], ids=["moe", "ep_sp", "pp_moe"])
def test_torch_port_moe_checkpoint_loads_in_jax_evaluator(tmp_path, flags):
    train_lm.main(LM + ["--max-steps", "2", "--train-dir", str(tmp_path), *flags])
    want = jeval.evaluate_checkpoint(str(tmp_path), 2, eval_size=16, batch_size=8)
    got = evaluate_lm.evaluate_checkpoint(str(tmp_path), 2, eval_size=16, batch_size=8,
                                          device="cpu")
    assert np.isfinite(want["loss"])
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])


def test_torch_evaluate_lm_generates_from_a_moe_checkpoint(tmp_path):
    d = _jax_moe_dir(tmp_path, 2, step=4)
    res = evaluate_lm.main(["--device", "cpu", "--model-dir", d, "--once", "--eval-size",
                            "8", "--batch-size", "4", "--generate", "6"])
    samples = np.asarray(res[4]["samples"])
    assert samples.shape == (2, 14) and np.isfinite(res[4]["perplexity"])
    assert ((samples >= 0) & (samples < MODEL["vocab_size"])).all()
