"""Port parity: the batch path (ps_pytorch_tpu_torch.data.loader and
data/_native.py): the native threaded gather, ``BatchIterator``'s
streams against the JAX package's for the same seed, and
``prefetch_to_device`` on the CPU (the same batches in order, one
``h2d`` span per dispatch, nested in the trainer's ``fetch`` span).

The pinned copy-stream route runs only on a card:
tests/test_torch_kernels_cuda.py holds it against the host batches.
"""

import json

import numpy as np
import pytest
import torch

from ps_pytorch_tpu.data.loader import BatchIterator as JBatchIterator
from ps_pytorch_tpu.data.loader import gather_rows as jgather_rows
from ps_pytorch_tpu_torch.data import (
    BatchIterator,
    gather_rows,
    make_synthetic,
    prefetch_to_device,
    shard_for_worker,
)
from ps_pytorch_tpu_torch.data import _native
from ps_pytorch_tpu_torch.obs import Tracer


@pytest.mark.parametrize("n_idx", [0, 1, 7, 300])
def test_torch_gather_rows_equals_numpy_and_jax(n_idx):
    d = make_synthetic("Cifar10", 500, 4, seed=1)
    idx = np.random.RandomState(n_idx).randint(0, 500, size=n_idx)
    for a in (d.train_images, d.train_labels):
        got = gather_rows(a, idx)
        assert got.dtype == a.dtype and got.shape == (n_idx,) + a.shape[1:]
        np.testing.assert_array_equal(got, a[idx])
        np.testing.assert_array_equal(got, jgather_rows(a, idx))


def test_torch_gather_rows_threads_above_4mb():
    """A gather of more than 4 MB takes the native threaded path (the
    default ``n_threads=0``): the same bytes as numpy."""
    a = np.random.RandomState(0).randint(0, 256, size=(2048, 3072), dtype=np.uint8)
    idx = np.random.RandomState(1).permutation(2048)
    idx = np.concatenate([idx, idx])
    assert idx.size * a.shape[1] > 4 << 20
    np.testing.assert_array_equal(gather_rows(a, idx), a[idx])


@pytest.mark.parametrize("bad", [[-1], [0, 10], [3, -7, 2]])
def test_torch_gather_rows_raises_on_out_of_range_indices(bad):
    """No numpy wrap for negative indices: IndexError, as JAX's."""
    a = np.arange(40, dtype=np.int32).reshape(10, 4)
    for fn in (gather_rows, jgather_rows):
        with pytest.raises(IndexError):
            fn(a, np.asarray(bad))


def test_torch_gather_rows_takes_numpy_only_where_jax_does():
    """A non-contiguous or an empty array is indexed by numpy; anything
    else goes through the native library, which is built under the
    package's _build/<hash>/ with portable flags."""
    a = np.arange(60, dtype=np.float32).reshape(10, 6)[:, ::2]
    assert not a.flags.c_contiguous
    np.testing.assert_array_equal(gather_rows(a, np.array([4, 1])), a[[4, 1]])
    empty = np.zeros((0, 3), np.uint8)
    assert gather_rows(empty, np.array([], np.int64)).shape == (0, 3)
    path = _native.build()
    assert path.endswith("libpsloader.so") and "_build" in path
    assert "-march=native" not in _native.CXX_FLAGS


def test_torch_native_build_errors_are_named(monkeypatch):
    """No compiler: ``NativeBuildError``, never a quiet numpy fallback;
    other flags hash to another library."""
    path = _native.library_path()
    monkeypatch.setattr(_native, "CXX_FLAGS", _native.CXX_FLAGS + ["-DPS_TEST_FLAG"])
    assert _native.library_path() != path
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(_native.NativeBuildError, match="compiler"):
        gather_rows(np.zeros((4, 2), np.uint8), np.array([1]))


@pytest.mark.parametrize("mode", ["reshuffle", "disjoint"])
def test_torch_batch_iterator_streams_match_jax(mode):
    """Two epochs of every worker's batches, for the same seed, equal
    JAX's (its RandomState shuffle, its gather)."""
    d = make_synthetic("MNIST", 100, 4, seed=2)
    for w in range(3):
        imgs, labels, seed = shard_for_worker(d.train_images, d.train_labels, w, 3, mode, 5)
        t, j = BatchIterator(imgs, labels, 8, seed=seed), JBatchIterator(imgs, labels, 8,
                                                                         seed=seed)
        assert len(t) == len(j)
        for _ in range(2):
            for bt, bj in zip(t.epoch(), j.epoch()):
                for k in ("image", "label"):
                    np.testing.assert_array_equal(bt[k], bj[k])


def test_torch_prefetch_on_cpu_yields_the_batches_in_order_with_h2d_spans():
    d = make_synthetic("MNIST", 40, 4, seed=3)
    batches = list(BatchIterator(d.train_images, d.train_labels, 8, seed=1).epoch())
    tr = Tracer("test")
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu", tracer=tr))
    assert len(got) == len(batches) == 5
    for g, b in zip(got, batches):
        for k in b:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert not g[k].is_pinned()
            np.testing.assert_array_equal(g[k].numpy(), b[k])
    spans = tr.drain()
    assert [s["name"] for s in spans] == ["h2d"] * 5


def test_torch_trainer_h2d_spans_nest_in_fetch(tmp_path):
    """The trainer's loop: each ``h2d`` dispatch lies inside a ``fetch``
    span, the first fetch dispatching two batches and each later one
    one."""
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig
    from ps_pytorch_tpu_torch.trainer import TrainConfig, Trainer

    d = make_synthetic("MNIST", 64, 8, seed=4)
    t = Trainer(TrainConfig(network="LeNet", dataset="MNIST", batch_size=4, max_steps=4,
                            log_interval=1, test_batch_size=8, save_checkpoints=False,
                            trace_dir=str(tmp_path)),
                PSConfig(num_workers=2, compress="int8"), dataset=d, device="cpu")
    t.train()
    spans = [json.loads(x) for x in open(tmp_path / "trace_train_p0.jsonl")][1:]
    fetch = [s for s in spans if s["name"] == "fetch"]
    h2d = [s for s in spans if s["name"] == "h2d"]
    assert len(fetch) == 4 and len(h2d) == 5
    for s in h2d:
        inside = [f for f in fetch if f["t"] <= s["t"] and s["t"] + s["dur"] <= f["t"] + f["dur"]
                  + 1e-6]
        assert len(inside) == 1 and s["depth"] == inside[0]["depth"] + 1
