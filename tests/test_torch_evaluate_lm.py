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
  clamped to the model's positions, and a MoE checkpoint is refused,
  naming item 19.
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


def test_torch_evaluate_lm_refuses_moe_checkpoints(tmp_path):
    d = _jax_dir(tmp_path, kind="moe")
    with pytest.raises(NotImplementedError, match="item 19"):
        evaluate_lm.evaluate_checkpoint(d, 3, device="cpu")
