"""Port parity: checkpoints (ps_pytorch_tpu_torch.checkpoint and
utils/serialization) against the JAX package's on the CPU.

- Bytes: the port's writer gives exactly the bytes of JAX's
  ``_write_host_state`` (flax msgpack + the CRC trailer) for the same
  state: the PS state with error feedback and the non-finite guard, in
  both state layouts and both optimizer placements (ZeRO-1's ``count`` as
  JAX's ``[N]``), and an LM-style dict with int, float, string and list
  metadata and a bf16 leaf.
- JAX -> port: the JAX Trainer writes; the port's Trainer(resume=True)
  restores params, momenta, ``count``, EF residuals and guard counters bit
  for bit, then trains on with finite losses. Port -> JAX: the port writes
  at a later step; JAX's ``Trainer.try_resume`` restores it bit for bit.
- The LM CLI's ``--train-dir`` file against JAX's own save of the same
  params and metadata.

LeNet, 2 workers, batch 8, at most 4 steps. The integrity rules and the
evaluator are in tests/test_torch_checkpoint_resilience.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from ps_pytorch_tpu import checkpoint as jckpt
from ps_pytorch_tpu.data import make_synthetic as jmake_synthetic
from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.trainer import TrainConfig as JTrainConfig
from ps_pytorch_tpu.trainer import Trainer as JTrainer
from ps_pytorch_tpu_torch import checkpoint as tckpt
from ps_pytorch_tpu_torch.cli import train_lm
from ps_pytorch_tpu_torch.data import make_synthetic
from ps_pytorch_tpu_torch.parallel.ps import PSConfig
from ps_pytorch_tpu_torch.trainer import TrainConfig, Trainer
from ps_pytorch_tpu_torch.utils import serialization as tser
from ps_pytorch_tpu_torch.utils.serialization import to_state_dict

# LeNet, 2 workers, int8 wire with error feedback, guard on; step 2's
# gradients are NaN, so the guard has a skip to carry
WIRE = dict(num_workers=2, num_aggregate=None, compress="int8", error_feedback=True)
FAULTS = '{"nan_grads": [2]}'


def _cfg(train_dir, **kw):
    base = dict(network="LeNet", dataset="MNIST", batch_size=8, test_batch_size=32,
                epochs=4, max_steps=3, lr=0.05, momentum=0.9, eval_freq=3, log_interval=1,
                train_dir=str(train_dir), fault_plan=FAULTS)
    base.update(kw)
    return base


def _dataset():
    return make_synthetic("MNIST", train_size=64, test_size=32, seed=1)


def _file(d, step) -> bytes:
    with open(os.path.join(str(d), f"model_step_{step}"), "rb") as f:
        return f.read()


def _leaves(sd, prefix=""):
    """{path: leaf} of a raw state dict (numpy, torch or Python leaves)."""
    if isinstance(sd, dict):
        out = {}
        for k, v in sd.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: sd}


def _assert_same(a: dict, b: dict):
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb)
    for k in la:
        x, y = la[k], lb[k]
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("layout,placement", [("flat", "replicated"), ("tree", "replicated"),
                                              ("flat", "sharded"), ("tree", "sharded")])
def test_torch_checkpoint_jax_to_port_to_jax_bit_exact(tmp_path, layout, placement):
    """JAX writes step 3; the port resumes it bit for bit and writes it
    again in JAX's bytes; the port trains to step 4 and writes; JAX
    resumes that bit for bit and writes the same bytes."""
    d = tmp_path / "models"
    wire = dict(WIRE, state_layout=layout, opt_placement=placement)
    jt = JTrainer(JTrainConfig(**_cfg(d)), JPSConfig(**wire),
                  dataset=jmake_synthetic("MNIST", train_size=64, test_size=32, seed=1))
    jt.train()
    assert jckpt.available_steps(str(d)) == [3]
    jraw = jckpt.load_checkpoint_raw(str(d), 3)
    assert int(jraw["guard_state"]["skipped"]) == 1

    pt = Trainer(TrainConfig(**_cfg(d, resume=True)), PSConfig(**wire), dataset=_dataset(),
                 device="cpu")
    pt.train()  # a finished run: resumes, takes no step, writes nothing
    assert pt.state.step == 3 and tckpt.available_steps(str(d)) == [3]
    _assert_same(to_state_dict(pt.checkpoint_state()), jraw)
    tckpt.save_checkpoint(pt.checkpoint_state(), str(tmp_path / "port"), 3)
    assert _file(tmp_path / "port", 3) == _file(d, 3)

    pt.tcfg.max_steps = 4
    pt.train()
    losses = [h["loss"] for h in pt.history]
    assert pt.state.step == 4 and len(losses) == 1 and np.isfinite(losses).all()
    assert tckpt.available_steps(str(d)) == [3, 4]

    jt2 = JTrainer(JTrainConfig(**_cfg(d)), JPSConfig(**wire),
                   dataset=jmake_synthetic("MNIST", train_size=64, test_size=32, seed=1))
    assert jt2.try_resume() == 4
    jhost = jax.device_get(jt2.state)
    _assert_same(to_state_dict(pt.checkpoint_state()),
                 fser.to_state_dict(jhost))
    jckpt._write_host_state(jhost, str(tmp_path / "jax"), 4, compress=False)
    assert _file(tmp_path / "jax", 4) == _file(d, 4)


def test_torch_checkpoint_dict_bytes_match_jax(tmp_path):
    """An LM-style dict: int, float, string, bool, None and list metadata,
    an f32 tree with a list of blocks and a bf16 leaf."""
    rng = np.random.RandomState(3)
    w = rng.randn(5, 4).astype(np.float32)
    blocks = [rng.randn(3).astype(np.float32) for _ in range(2)]
    meta = {"kind": "dense", "dim": 32, "capacity_factor": 1.25, "sizes": [3, 70000, -2],
            "tag": "x" * 40, "flag": True, "none": None}
    jstate = {"step": 7, "params": {"w": jnp.asarray(w), "blocks": [jnp.asarray(b) for b in blocks],
                                    "emb": jnp.asarray(w).astype(jnp.bfloat16)},
              "model": meta, "count": np.int32(3)}
    tstate = {"model": meta, "count": np.int32(3), "step": 7,
              "params": {"emb": torch.from_numpy(w).to(torch.bfloat16),
                         "blocks": [torch.from_numpy(b) for b in blocks],
                         "w": torch.from_numpy(w)}}
    jckpt.save_checkpoint(jstate, str(tmp_path / "jax"), 7)
    tckpt.save_checkpoint(tstate, str(tmp_path / "port"), 7)
    assert _file(tmp_path / "port", 7) == _file(tmp_path / "jax", 7)
    raw = tckpt.listify_raw(tckpt.load_checkpoint_raw(str(tmp_path / "jax"), 7))
    assert raw["params"]["emb"].dtype == torch.bfloat16
    assert torch.equal(raw["params"]["emb"], tstate["params"]["emb"])
    assert raw["model"] == meta and raw["step"] == 7


def test_torch_cli_train_lm_train_dir_matches_jax_save(tmp_path):
    """``cli.train_lm --train-dir``: a file every --eval-freq steps and
    after the last, read by JAX's load_checkpoint_raw + listify_raw into
    the params and metadata JAX's own save of them gives, byte for byte."""
    d = tmp_path / "lm"
    train_lm.main(["--vocab-size", "48", "--dim", "32", "--depth", "2", "--heads", "2",
                   "--seq-len", "16", "--batch-size", "2", "--max-steps", "3",
                   "--train-size", "16", "--log-interval", "1", "--eval-freq", "2",
                   "--train-dir", str(d), "--device", "cpu"])
    assert jckpt.available_steps(str(d)) == [2, 3]
    raw = jckpt.listify_raw(jckpt.load_checkpoint_raw(str(d), 3))
    assert raw["step"] == 3 and raw["model"]["kind"] == "dense"
    assert raw["model"]["dim"] == 32 and raw["data"] == {"seed": 2, "seq_len": 16}
    assert len(raw["params"]["blocks"]) == 2
    jckpt.save_checkpoint({"params": jax.device_get(raw["params"]), "step": 3,
                           "model": raw["model"], "data": raw["data"]},
                          str(tmp_path / "jax"), 3)
    assert _file(tmp_path / "jax", 3) == _file(d, 3)


def test_torch_serialization_chunked_arrays_match_flax(monkeypatch):
    """flax writes an array above MAX_CHUNK_SIZE bytes as a
    ``__msgpack_chunked_array__`` dict of flat pieces (2**30 bytes in
    use; 64 here): the port writes the same bytes and joins them back."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(5)
    state = {"a": rng.randn(7, 9).astype(np.float32), "b": {"c": np.arange(5, dtype=np.int64)},
             "d": rng.randn(3).astype(np.float32)}
    data = fser.msgpack_serialize({k: state[k] for k in state}, in_place=True)
    assert b"__msgpack_chunked_array__" in data
    assert tser.packb({k: state[k] for k in state}) == data
    back = tser.unpackb(data)
    for k in ("a", "d"):
        assert back[k].shape == state[k].shape and back[k].tobytes() == state[k].tobytes()
    assert back["b"]["c"].tolist() == list(range(5))
