"""Port parity: the native codec binding (ps_pytorch_tpu_torch.ops.codec)
and the compressed checkpoint form (``PSCK``) against the JAX package's
ops/codec.py and checkpoint.py, on the CPU.

- ``compress_bytes`` is byte for byte JAX's at itemsizes 1, 2 and 4, on
  empty input, on a length that is no multiple of the itemsize and over
  several 1 MiB blocks; each side reads the other's ``N`` blobs, and the
  port reads JAX's ``Z`` (zlib) blob; the array framing and the four
  reference names agree;
- a ``PSCK`` checkpoint written by the port is JAX's file byte for byte
  and loads in JAX's ``load_checkpoint_raw`` bit for bit, and the other
  way round; ``cli.train --device cpu --compress-checkpoints`` resumes
  from its own ``PSCK`` files onto the live state bit for bit; a
  truncated or damaged ``PSCK`` file is a ``CheckpointCorruptError``;
- with no compiler, compressing raises ``NativeBuildError`` (no zlib
  fallback on write, the port's declared deviation); a ``Z`` blob still
  reads.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from ps_pytorch_tpu import checkpoint as jckpt
from ps_pytorch_tpu.ops import codec as jcodec
from ps_pytorch_tpu_torch import checkpoint as ckpt
from ps_pytorch_tpu_torch.cli import train as cli_train
from ps_pytorch_tpu_torch.data import _native, make_synthetic
from ps_pytorch_tpu_torch.ops import codec
from ps_pytorch_tpu_torch.parallel.ps import PSConfig
from ps_pytorch_tpu_torch.trainer import TrainConfig, Trainer
from tests.test_torch_one_thread import _one_thread  # noqa: F401


def _bytes(n, seed=0):
    """Compressible, non-trivial bytes: rounded f32 noise."""
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(n // 4 + 1) * 8) / 8
    return x.astype(np.float32).tobytes()[:n]


@pytest.mark.parametrize("n,itemsize", [
    (0, 1), (0, 4), (4096, 1), (4096, 2), (4096, 4), (4097, 4), (1003, 2),
    (3 * (1 << 20) + 13, 4), ((1 << 20) + 7, 1),
], ids=["empty_1", "empty_4", "i1", "i2", "i4", "ragged_4", "ragged_2",
        "blocks_4", "blocks_1"])
def test_torch_codec_bytes_equal_jax_and_cross_read(n, itemsize):
    data = _bytes(n, seed=n)
    got = codec.compress_bytes(data, itemsize=itemsize)
    want = jcodec.compress_bytes(data, itemsize=itemsize)
    assert got[:1] == b"N" and got == want
    assert codec.decompress_bytes(want) == data
    assert jcodec.decompress_bytes(got) == data
    # the blocks do not depend on the thread count
    assert codec.compress_bytes(data, itemsize=itemsize, n_threads=1) == got


def test_torch_codec_reads_jax_zlib_blob(monkeypatch):
    """JAX writes ``Z`` + zlib where it has no compiler; the port reads it."""
    data = _bytes(50000)
    monkeypatch.setattr(jcodec, "_load", lambda: None)
    blob = jcodec.compress_bytes(data, itemsize=4)
    assert blob[:1] == b"Z"
    assert codec.decompress_bytes(blob) == data


@pytest.mark.parametrize("arr", [
    np.arange(24, dtype=np.float32).reshape(2, 3, 4), np.int8(-3) * np.ones((7,), np.int8),
    np.array(2.5, np.float64), np.zeros((0, 5), np.int32),
], ids=["f32_3d", "int8", "scalar_f64", "empty_i32"])
def test_torch_codec_arrays_and_reference_names_match_jax(arr):
    blob = codec.compress_array(arr)
    assert blob == jcodec.compress_array(arr)
    for dec in (codec.decompress_array, jcodec.decompress_array):
        back = dec(blob)
        assert back.dtype == arr.dtype and back.shape == arr.shape
        np.testing.assert_array_equal(back, arr)
    assert codec.g_compress(arr) == codec.w_compress(arr) == blob
    np.testing.assert_array_equal(codec.g_decompress(blob), arr)
    np.testing.assert_array_equal(codec.w_decompress(jcodec.w_compress(arr)), arr)


def test_torch_codec_rejects_damage():
    blob = bytearray(codec.compress_bytes(_bytes(200000), itemsize=4))
    blob[len(blob) // 2] ^= 0x5A
    for dec in (codec.decompress_bytes, jcodec.decompress_bytes):
        with pytest.raises(ValueError):
            dec(bytes(blob))
    with pytest.raises(ValueError, match="not a psnative"):
        codec.decompress_bytes(b"Q123")


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"dense": {"kernel": rng.randn(64, 32).astype(np.float32),
                                 "bias": np.zeros((32,), np.float32)},
                       "blocks": [rng.randn(16).astype(np.float32) for _ in range(3)]},
            "count": np.int32(7), "step": 7}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _same_raw(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), p


def test_torch_psck_checkpoint_is_jax_file_and_loads_both_ways(tmp_path):
    state = _state()
    mine, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    ckpt.save_checkpoint(state, mine, 7, compress=True)
    jckpt.save_checkpoint(state, ref, 7, compress=True)
    got = open(ckpt.checkpoint_path(mine, 7), "rb").read()
    assert got[:4] == b"PSCK"
    assert got == open(jckpt.checkpoint_path(ref, 7), "rb").read()
    _same_raw(jckpt.load_checkpoint_raw(mine, 7), ckpt.load_checkpoint_raw(ref, 7))
    _same_raw(ckpt.load_checkpoint_raw(mine, 7), jckpt.load_checkpoint_raw(ref, 7))
    # the plain form of the same state is smaller to decode, not the same file
    ckpt.save_checkpoint(state, mine, 8)
    _same_raw(ckpt.load_checkpoint_raw(mine, 8), ckpt.load_checkpoint_raw(mine, 7))
    assert ckpt.latest_valid_step(mine) == 8 and ckpt.load_latest_valid(mine)[0] == 8


def test_torch_damaged_psck_is_corrupt(tmp_path):
    d = str(tmp_path / "m")
    ckpt.save_checkpoint(_state(1), d, 3, compress=True)
    path = ckpt.checkpoint_path(d, 3)
    body = open(path, "rb").read()[:-8]
    # a flipped payload byte under a recomputed trailer: the codec's
    # block checksum catches it
    bad = bytearray(body)
    bad[len(bad) // 2] ^= 0xFF
    ckpt.save_checkpoint(_state(1), d, 4, compress=True)
    with open(ckpt.checkpoint_path(d, 4), "wb") as f:
        f.write(bytes(bad) + b"PSC1" + struct.pack("<I", zlib.crc32(bytes(bad))))
    ckpt.verify_checkpoint(d, 4)  # the trailer certifies the damaged bytes
    with pytest.raises(ckpt.CheckpointCorruptError, match="codec"):
        ckpt.load_checkpoint_raw(d, 4)
    # truncated: the trailer goes with the tail, the decode fails
    with open(path, "r+b") as f:
        f.truncate(len(body) // 2)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_checkpoint(d, 3)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint_raw(d, 3)


def test_torch_cli_train_resumes_from_its_own_psck_files(tmp_path):
    d = str(tmp_path / "models")
    base = ["--device", "cpu", "--network", "LeNet", "--num-workers", "2", "--batch-size",
            "8", "--test-batch-size", "32", "--eval-freq", "2", "--train-dir", d,
            "--compress-checkpoints", "--log-interval", "1"]
    first = cli_train.main(base + ["--max-steps", "4"])
    for step in (2, 4):
        with open(ckpt.checkpoint_path(d, step), "rb") as f:
            assert f.read(4) == b"PSCK"
        ckpt.verify_checkpoint(d, step)
    live = first["trainer"]
    back = live._restore_step(4)
    for a, b in zip(_leaves(ckpt.to_state_dict(back)), _leaves(ckpt.to_state_dict(live.state))):
        assert a[0] == b[0] and a[1].tobytes() == b[1].tobytes(), a[0]
    res = cli_train.main(base + ["--max-steps", "6", "--resume"])
    assert [h["step"] for h in res["history"]] == [5, 6]
    with open(ckpt.checkpoint_path(d, 6), "rb") as f:
        assert f.read(4) == b"PSCK"
    # JAX's reader takes the port's PSCK files
    raw = jckpt.load_checkpoint_raw(d, 6)
    _same_raw(raw, ckpt.load_checkpoint_raw(d, 6))


def test_torch_async_checkpointer_compresses(tmp_path):
    ds = make_synthetic("MNIST", train_size=64, test_size=32, seed=1)
    t = Trainer(TrainConfig(network="LeNet", dataset="MNIST", batch_size=8, test_batch_size=32,
                            max_steps=1, eval_freq=1, train_dir=str(tmp_path / "m"),
                            compress_checkpoints=True),
                PSConfig(num_workers=2), dataset=ds, device="cpu")
    t.train()
    path = ckpt.checkpoint_path(str(tmp_path / "m"), 1)
    with open(path, "rb") as f:
        assert f.read(4) == b"PSCK"
    assert os.path.getsize(path) < len(ckpt.packb(ckpt.to_state_dict(t.checkpoint_state())))


def test_torch_codec_without_a_compiler_raises_on_write(monkeypatch):
    data = _bytes(4096)
    blob_n = codec.compress_bytes(data)
    monkeypatch.setattr(codec, "_lib", None)
    monkeypatch.setattr(_native, "CXX_FLAGS", _native.CXX_FLAGS + ["-DPS_TEST_NO_CXX"])
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    with pytest.raises(_native.NativeBuildError, match="compiler"):
        codec.compress_bytes(data)
    with pytest.raises(_native.NativeBuildError):
        codec.decompress_bytes(blob_n)
    assert codec.decompress_bytes(b"Z" + zlib.compress(data)) == data
